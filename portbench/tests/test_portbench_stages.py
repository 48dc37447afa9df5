"""The readers of the program's own ranges (``harness/stages.py`` and the
metrics on it): the idle split on hand-made traces with known answers,
its parts summing to the window's idle time, nothing read from a program
that opens no range, and the wait count of a tiny traced run on the CPU."""

import random
import time

import pytest

from portbench.harness.manifest import metric_reader
from portbench.harness.record import (WINDOW_SPAN, Record, Span, Trace,
                                      Traced)
from portbench.harness.stages import idle_split
from portbench.tests.tiny import tiny_cell

MS = 1_000_000                 # ns
IDLE = ("key_idle_ms_per_frame.pixel", "batch_idle_ms_per_frame.pixel",
        "unspanned_idle_ms_per_frame.pixel")
NEW = IDLE + ("host_waits_per_frame.pixel",
              "flow_span_device_ms_per_pair.pixel")


def read(name, rec):
    return metric_reader(name).read(rec)


def _trace(device, host, window=(0, 1000)):
    ns = lambda t: int(t * MS)
    w = Span(WINDOW_SPAN, ns(window[0]), ns(window[1]))
    return Trace(device=[(n, ns(s), ns(e), c) for n, s, e, c in device],
                 host=[w] + [Span(n, ns(s), ns(e)) for n, s, e in host],
                 window=w)


def _known():
    """Busy 100-200, 300-400, 600-700, 900-950 (ms). Gaps, by midpoint:
    0-100 and 200-300 under the key stage (the second under its nested
    read-back wait), 400-600 under flow, 700-900 under close (outermost,
    over a nested finalize), 950-1000 under no stage: key 200, batch
    400, unspanned 50 ms."""
    device = [("k", 100, 200, 1), ("Memcpy DtoH", 300, 400, 2),
              ("k", 600, 700, 3), ("k", 650, 690, 4), ("k", 900, 950, 5)]
    host = [("sdaof.pixel.key", 20, 280),
            ("sdaof.wait.key_readback", 220, 279),
            ("sdaof.pixel.flow", 450, 550), ("aten::mm", 480, 520),
            ("sdaof.pixel.close", 750, 960),
            ("sdaof.pixel.finalize", 760, 850),
            ("sdaof.wait.batch_readback", 770, 849),
            ("sdaof.wait.png", 900, 955)]
    return _trace(device, host)


def test_idle_split_reads_its_known_values():
    rec = Record(trace=_known(), traced=Traced(frames=2, pairs=1))
    got = [read(n, rec) for n in IDLE]
    assert got == pytest.approx([100.0, 200.0, 25.0])


def test_idle_parts_sum_to_the_window_idle_time():
    """Random overlapping device activities and randomly nested stage
    ranges: the three parts add up to the window less the union of the
    busy intervals."""
    rng = random.Random(7)
    for _ in range(50):
        device = []
        for c in range(rng.randrange(0, 40)):
            s = rng.uniform(-50, 1000)
            device.append(("k", s, s + rng.uniform(0.001, 80), c))
        host, t = [], rng.uniform(0, 30)
        while t < 1000:
            e = t + rng.uniform(1, 120)
            name = rng.choice(["key", "flow", "denoise", "finalize", "close"])
            host.append((f"sdaof.pixel.{name}", t, e))
            if rng.random() < 0.5:
                host.append(("sdaof.pixel.finalize", t + (e - t) / 3,
                             t + (e - t) / 2))
            t = e + rng.uniform(0, 40)
        trace = _trace(device, host)
        frames = rng.randrange(1, 9)
        rec = Record(trace=trace, traced=Traced(frames=frames))
        idle_ns = 1000 * MS - sum(e - s for s, e in trace.busy_intervals())
        assert sum(read(n, rec) for n in IDLE) == pytest.approx(
            idle_ns / MS / frames, rel=1e-9, abs=1e-9)
        assert sum(idle_split(trace).values()) == idle_ns


def test_a_gap_under_a_key_frame_wait_counts_once_as_key():
    trace = _trace([("k", 0, 10, 1), ("k", 90, 100, 2)],
                   [("sdaof.pixel.key", 5, 95),
                    ("sdaof.wait.key_readback", 20, 80)], window=(0, 100))
    assert idle_split(trace) == {"key": 80 * MS, "batch": 0, "unspanned": 0}


def test_waits_and_the_flow_range_are_counted_in_the_window():
    """Three waits in the window (one outside is not counted) over 2
    frames; the kernel launched inside the flow range counts, the one
    launched outside does not."""
    trace = _known()
    trace.host += [Span("sdaof.wait.upload", 1100 * MS, 1101 * MS),
                   Span("sdaof.flow.estimate", 580 * MS, 640 * MS),
                   Span("cudaLaunchKernel", 590 * MS, 591 * MS),
                   Span("cudaLaunchKernel", 645 * MS, 646 * MS)]
    trace.launches = {3: 590 * MS, 4: 645 * MS}
    rec = Record(trace=trace, traced=Traced(frames=2, pairs=4))
    assert read("host_waits_per_frame.pixel", rec) == 1.5
    assert read("flow_span_device_ms_per_pair.pixel", rec) == \
        pytest.approx(100 / 4)


def test_a_program_without_ranges_reads_nothing():
    """The parent's program opens no ``sdaof`` range: every new metric is
    left out of the line, none raises."""
    trace = _trace([("k", 100, 200, 1)], [("aten::mm", 110, 190)])
    trace.launches = {1: 110 * MS}
    for rec in (Record(trace=trace, traced=Traced(frames=2, pairs=2)),
                Record()):
        assert [read(n, rec) for n in NEW] == [None] * len(NEW)


@pytest.fixture(scope="module")
def tiny_traced(tmp_path_factory):
    """A tiny window on the CPU whose second clip runs under the full
    profile: the first profiled part ends after one clip
    (``trace_seconds`` 0), and the window lasts about three clips."""
    import torch

    from portbench.drivers.pixel import Driver
    torch.set_num_threads(4)
    cell = tiny_cell()
    cell.spec["trace_seconds"] = 0
    tmp = tmp_path_factory.mktemp("stages")
    drv = Driver(cell, 4_000_000_321, "cpu", tmp)
    drv.setup()
    t = time.perf_counter()
    drv.run_clip(0, tmp / "probe", drv.pcfg)
    rec = drv.window(3 * (time.perf_counter() - t), trace=True)
    return cell, rec


def test_tiny_traced_run_counts_its_clips_waits(tiny_traced):
    """The tiny clip (5 frames, a key frame at 0, batches of 2): a key
    frame's upload and read-back, 3 uploads and a read-back for each of 2
    batches, the PNG writer's close: 11 waits a clip."""
    cell, rec = tiny_traced
    assert rec.trace is not None and rec.traced.frames
    n = cell.traffic["clip_frames"]
    assert rec.traced.frames % n == 0
    waits = read("host_waits_per_frame.pixel", rec)
    assert waits == pytest.approx(11 * (rec.traced.frames // n)
                                  / rec.traced.frames)
    split = idle_split(rec.trace)
    w = rec.trace.window
    busy = sum(e - s for s, e in rec.trace.busy_intervals())
    assert sum(split.values()) == w.end - w.start - busy
