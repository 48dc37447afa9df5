"""Device ms of the kernels launched inside the harness's flow range (the
estimator's ``calc_batch_device``, RAFT and the confidence head) per
frame pair the estimator computed (padded pairs included)."""

from portbench.harness.record import FLOW_SPAN


def read(rec):
    if rec.traced is None or not rec.traced.pairs:
        return None
    ks = rec.trace.kernels_in_spans(FLOW_SPAN)
    if not ks:
        return None
    return sum(e - s for _, s, e, _ in ks) / 1e6 / rec.traced.pairs
