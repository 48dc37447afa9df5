"""What one run recorded, and the readings taken from it.

A ``Record`` holds the run's counts and host-clock times (frames, pairs,
window seconds, the model FLOPs done) and, in a traced run, the
profiler's raw events over the window and the kernel launches the
harness logged at the port's single C entry point (``ops/_cuda.call``).
The trace is read from the profiler's raw kineto events: building its
per-op event tree (``key_averages``) costs seconds of host time per few
thousand launches.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Optional

WINDOW_SPAN = "portbench.window"
FLOW_SPAN = "portbench.flow"
CLIP_SPAN = "portbench.clip"


@dataclass
class Span:
    name: str
    start: int          # ns, the trace's clock
    end: int


@dataclass
class Trace:
    """Device activities (kernels, copies, fills) and host spans of a
    profiled window."""
    device: list = field(default_factory=list)     # (name, start, end, corr)
    host: list = field(default_factory=list)       # Span (ops and ranges)
    launches: dict = field(default_factory=dict)   # correlation -> start
    window: Optional[Span] = None
    _in_window: Optional[list] = None

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        t = cls()
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and dur > 0:
                    t.device.append((e.name(), start, start + dur,
                                     e.correlation_id()))
                continue
            span = Span(e.name(), start, start + dur)
            if e.name() == WINDOW_SPAN:
                t.window = span
            t.host.append(span)
            if e.correlation_id() and re.match(r"cu(da)?Launch", e.name()):
                t.launches[e.correlation_id()] = start
        return t

    def in_window(self):
        if self._in_window is None:
            w = self.window
            self._in_window = list(self.device) if w is None else [
                d for d in self.device if d[2] > w.start and d[1] < w.end]
        return self._in_window

    def busy_intervals(self):
        """The union of the device activities' intervals in the window,
        over every stream, clipped to it (a trace without a window range,
        made between two host syncs, is all window)."""
        w = self.window
        lo, hi = (w.start, w.end) if w is not None else (-1, 1 << 62)
        ivs = sorted((max(s, lo), min(e, hi))
                     for _, s, e, _ in self.in_window())
        out = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        """Seconds of the union of the window's device activities."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernels(self):
        """The window's kernels (copies and fills left out)."""
        return [d for d in self.in_window()
                if not d[0].startswith(("Memcpy", "Memset"))]

    def kernels_in_spans(self, name: str):
        """Kernels launched from inside a host range ``name``: their
        launch call (matched by correlation id) lies in one."""
        spans = sorted((s.start, s.end) for s in self.host if s.name == name)
        if not spans:
            return []
        starts = [s for s, _ in spans]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= spans[i][1]
        return [k for k in self.kernels()
                if k[3] in self.launches and inside(self.launches[k[3]])]

    def idle_gaps(self, top: int = 10, short_ns: int = 20_000):
        """The device's idle gaps in the window, summed by the innermost
        host operation running at each gap's midpoint (gaps under
        ``short_ns`` summed as one entry): [(name, s)]. One sweep over
        the host spans, which nest, with a stack of the open ones."""
        busy = self.busy_intervals()
        w = self.window
        edges = [w.start] + [x for iv in busy for x in iv] + [w.end]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = sorted((s for s in self.host if s.name != WINDOW_SPAN),
                      key=lambda s: (s.start, -s.end))
        by, stack, j = {}, [], 0
        short = f"(gaps under {short_ns // 1000} us)"
        for a, b in gaps:
            if b - a < short_ns:
                by[short] = by.get(short, 0.0) + (b - a) / 1e9
                continue
            mid = (a + b) // 2
            while j < len(host) and host[j].start <= mid:
                while stack and stack[-1].end < host[j].start:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            name = stack[-1].name if stack else "(no host operation)"
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def top_device_ops(self, top: int = 10):
        by = {}
        for name, s, e, _ in self.in_window():
            by[name[:160]] = by.get(name[:160], 0.0) + (e - s) / 1e9
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


@dataclass
class Traced:
    """A traced part of a window: what the per-layer readings divide by
    (``window_s`` on the host clock between two syncs; ``busy_s`` the
    device's busy seconds, in the CUDA-only part)."""
    frames: int = 0
    pairs: int = 0
    window_s: float = 0.0
    model_flops: float = 0.0
    busy_s: float = 0.0


@dataclass
class Record:
    """One run of a cell: counts and host-clock times; in a traced run
    the device's busy time over the window's first clips (CUDA-only
    profile) and the full trace of the next ones, with the launches
    logged meanwhile."""
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    calls: list = field(default_factory=list)   # (entry, args)
    trace: Optional[Trace] = None               # the fully profiled part
    traced: Optional[Traced] = None
    timed: Optional[Traced] = None              # the CUDA-only part
    top_ops: list = field(default_factory=list)  # its top device ops
    extra: dict = field(default_factory=dict)
