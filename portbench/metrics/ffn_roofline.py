"""The fused feed-forward kernels' (#3, and #4's two device kernels)
share of their roofline, in %, read as ``attn_roofline`` is."""

from portbench.counts.kernels import family_share


def read(rec):
    if rec.trace is None:
        return None
    share = family_share(rec.calls, rec.trace.kernels(), "ffn")
    return None if share is None else 100.0 * share
