"""``sdaof.wait.*`` ranges in the traced window per traced frame: how
many times a frame's path stops the host where it may block on the card
(an upload, a read-back) or on the PNG writer; an exact count."""

from portbench.harness.stages import WAIT, spans_in_window


def read(rec):
    if rec.trace is None or rec.traced is None or not rec.traced.frames:
        return None
    n = len(spans_in_window(rec.trace, WAIT))
    return n / rec.traced.frames if n else None
