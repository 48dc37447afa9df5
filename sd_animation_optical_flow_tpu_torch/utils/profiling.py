"""Tracing / profiling.

Counterpart of ``sd_animation_optical_flow_tpu/utils/profiling.py``:
  * ``stage(name)`` — per-stage wall timers collected into a registry;
  * ``trace(log_dir)`` — a ``torch.profiler`` window over the CPU and,
    where there is one, the card, written to ``log_dir`` as a Chrome
    trace (open it in Perfetto or chrome://tracing);
  * ``annotate(name)`` — a named region (``torch.profiler.
    record_function``) that shows in the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class StageTimer:
    """Accumulates wall time + call counts per pipeline stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(self.totals[k], 4),
                    "calls": self.counts[k],
                    "mean_s": round(self.totals[k] / max(self.counts[k], 1),
                                    4)}
                for k in sorted(self.totals)}

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


GLOBAL_TIMER = StageTimer()
stage = GLOBAL_TIMER.stage


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` window over the CPU and the card (when CUDA is
    available); on exit the Chrome trace is written to
    ``log_dir/trace_<pid>_<ns>.json``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region for profiler timelines."""
    return torch.profiler.record_function(name)
