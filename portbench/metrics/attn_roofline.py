"""The attention kernels' (#1, #2, #6, #10) share of their roofline, in
%: the sum of each traced launch's least time (``counts/kernels.py``, its
shape logged at the port's C entry point) over the sum of their device
times."""

from portbench.counts.kernels import family_share


def read(rec):
    if rec.trace is None:
        return None
    share = family_share(rec.calls, rec.trace.kernels(), "attn")
    return None if share is None else 100.0 * share
