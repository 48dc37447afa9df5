"""Device ms of the kernels launched inside the program's own flow range
(``sdaof.flow.estimate``, the body of the estimator's
``calc_batch_device``: RAFT and the confidence head) per frame pair the
estimator computed (padded pairs included)."""

from portbench.harness.stages import FLOW_ESTIMATE


def read(rec):
    if rec.trace is None or rec.traced is None or not rec.traced.pairs:
        return None
    ks = rec.trace.kernels_in_spans(FLOW_ESTIMATE)
    if not ks:
        return None
    return sum(e - s for _, s, e, _ in ks) / 1e6 / rec.traced.pairs
