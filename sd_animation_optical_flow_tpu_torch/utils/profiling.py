"""Tracing.

Counterpart of ``sd_animation_optical_flow_tpu/utils/profiling.py``:
  * ``trace(log_dir)`` — a ``torch.profiler`` window over the CPU and,
    where there is one, the card, written to ``log_dir`` as a Chrome
    trace (open it in Perfetto or chrome://tracing);
  * ``annotate(name)`` — a named host range (``torch.profiler.
    record_function``) in the profiler's trace, on the clock of the
    card's activities. With no profile running it is a shared null
    context: one check, nothing allocated.

The pipelines open ``sdaof.*`` ranges at their stage boundaries and
wherever the host blocks on the card or the PNG writer (PERF.md §3 names
each and what reads it). They exist only while a profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
NULL_SPAN = contextlib.nullcontext()


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
    """A named range in the running profile's trace; ``NULL_SPAN`` when
    no profile runs."""
    if not _profiler_enabled():
        return NULL_SPAN
    return torch.profiler.record_function(name)
