"""Device kernel launches in the traced window (copies and fills left
out) per frame of the traced clips: an exact count of the host's dispatch."""


def read(rec):
    if rec.traced is None or not rec.traced.frames:
        return None
    n = len(rec.trace.kernels())
    return n / rec.traced.frames if n else None
