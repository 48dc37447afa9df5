"""The program's own ranges in a traced window, and the device's idle time
put down to the pipeline stage the host was in.

The port opens ``sdaof.*`` ranges (``utils/profiling.annotate``) while a
profiler runs: ``sdaof.pixel.<stage>`` around each stage of
``run_batched`` (``key``, ``flow``, ``denoise``, ``finalize``,
``close``), ``sdaof.wait.<what>`` wherever the host may block on the
card or the PNG writer, ``sdaof.flow.estimate`` around the flow
estimator. They are timed on the clock of the device's activities. A
program that opens none reads as nothing: the readers return None.
"""

from __future__ import annotations

import bisect

PIXEL = "sdaof.pixel."
WAIT = "sdaof.wait."
FLOW_ESTIMATE = "sdaof.flow.estimate"
# the idle split's parts: under a key frame's stage, under a batch's
# stages (flow, denoise, finalize, close), under no stage
PARTS = ("key", "batch", "unspanned")


def window_gaps(trace):
    """Every idle gap of the device in the window, short ones included,
    as ``Trace.idle_gaps`` finds them: [(start, end)] ns."""
    w = trace.window
    edges = [w.start] + [x for iv in trace.busy_intervals() for x in iv] \
        + [w.end]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def outer_stages(trace):
    """The outermost ``sdaof.pixel.*`` ranges in time order: [(start,
    end, stage)] (a stage nested in another, as the last batch's denoise
    and finalize are in ``close``, is left out)."""
    spans = sorted((s for s in trace.host if s.name.startswith(PIXEL)),
                   key=lambda s: (s.start, -s.end))
    out = []
    for s in spans:
        if out and s.end <= out[-1][1]:
            continue
        out.append((s.start, s.end, s.name[len(PIXEL):]))
    return out


def idle_split(trace):
    """{part: idle ns} over the window (``PARTS``): each gap goes whole to
    the outermost ``sdaof.pixel.*`` range open at its midpoint (``key``,
    else ``batch``), or to ``unspanned``. The parts sum to the window's
    idle time. None without a window or without a pixel range."""
    if trace is None or trace.window is None:
        return None
    stages = outer_stages(trace)
    if not stages:
        return None
    starts = [s for s, _, _ in stages]
    out = dict.fromkeys(PARTS, 0)
    for a, b in window_gaps(trace):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i < 0 or mid > stages[i][1]:
            part = "unspanned"
        else:
            part = "key" if stages[i][2] == "key" else "batch"
        out[part] += b - a
    return out


def idle_ms_per_frame(rec, part: str):
    """Idle ms a traced frame under ``part`` of the split, or None."""
    if rec.trace is None or rec.traced is None or not rec.traced.frames:
        return None
    split = idle_split(rec.trace)
    return None if split is None else split[part] / 1e6 / rec.traced.frames


def spans_in_window(trace, prefix: str):
    """The window's host ranges whose name starts with ``prefix``."""
    w = trace.window
    return [s for s in trace.host if s.name.startswith(prefix)
            and (w is None or (s.start >= w.start and s.end <= w.end))]
