"""Frames written (every ``converted_*.png``, key frames included) over
the window's host-clock seconds, from its start to the last clip's
completion."""


def read(rec):
    return rec.frames / rec.window_s if rec.window_s > 0 else None
