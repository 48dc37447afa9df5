"""Set-up seconds on the host clock: from the process's first line to the
window's start (imports, the kernels' build or load, the weights, the
flow pair, the traffic, the warm-up clip)."""


def read(rec):
    return rec.extra.get("setup_s")
