"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. With
``--control`` the control (the plain reference in a lower precision) is
judged in the program's place, through the same result line: it has to
come out not correct. Set-up
(weights from the seed, the kernels built or loaded, a warm-up) is timed,
then the cell's window runs for ``--seconds``; with ``--trace 1`` under
the profiler, whose readings give the per-layer metrics, else the
end-to-end ones. After the window the program is freed and a seeded
sample of its outputs is judged against the plain reference
(``portbench/reference``). The last line of standard output is one JSON
object; the numbers judged and their limits end standard error and the
line's ``checks``. Exits non-zero, printing no result, without a card,
without the port, or when JAX was loaded.
"""

import time

T0 = time.time()

import argparse                                     # noqa: E402
import json                                         # noqa: E402
import os                                           # noqa: E402
import shutil                                       # noqa: E402
import subprocess                                   # noqa: E402
import sys                                          # noqa: E402
import tempfile                                     # noqa: E402
from pathlib import Path                            # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# compared by whole top-level module name: the port's name begins with the
# JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "sd_animation_optical_flow_tpu")


def forbidden_modules():
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _environment():
    """Caches inside the checkout at fixed paths; libraries kept off JAX
    and off the network."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for k in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[k] = "0"
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def metrics_of(entries, rec):
    from portbench.harness.manifest import metric_reader
    out = {}
    for m in entries:
        v = metric_reader(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell, rec, checks, trace, device):
    """The run's result object (``checks`` last)."""
    ok = rec.failed == 0 and all(v <= lim for _, v, lim in checks)
    res = {"correct": bool(ok), "attempted": rec.attempted,
           "failed": rec.failed,
           "metrics": metrics_of(cell.per_layer if trace
                                 else cell.end_to_end, rec),
           "device": device}
    if trace and rec.timed is not None and rec.timed.busy_s > 0:
        device["busy_s"] = rec.timed.busy_s
        device["window_s"] = rec.timed.window_s
        res["breakdown"] = {"device_ops": [list(x) for x in rec.top_ops]}
        if rec.trace is not None and rec.trace.window is not None:
            res["breakdown"]["idle_gaps"] = [list(x) for x in
                                             rec.trace.idle_gaps()]
    res["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return res


def measure(cell, seed, seconds, trace, work, t_start, control=False,
            fault=None):
    """One run of ``cell`` in this process, on the card: set-up (timed
    from ``t_start``), the window, the program freed, the check. With
    ``control`` the control's check alone; with ``fault`` (a name of
    ``harness/faults.py``) that fault planted in the program. Returns
    (driver, record, checks, device)."""
    import contextlib

    import torch
    from portbench.harness.record import Record
    drv = cell.driver().Driver(cell, seed, "cuda", work)
    if control:
        checks = drv.control()
        n = len(drv.flags)
        rec = Record(frames=n, attempted=n)
    else:
        planted = contextlib.nullcontext()
        if fault:
            from portbench.harness.faults import plant
            planted = plant(fault, cell.traffic["clip_frames"])
        with planted:
            drv.setup()
            torch.cuda.synchronize()
            setup_s = time.time() - t_start
            rec = drv.window(seconds, trace)
            torch.cuda.synchronize()
        rec.extra["setup_s"] = setup_s
    rec.extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": rec.extra["memory_peak_bytes"],
              "power_limit_w": power_limit()}
    if not control:
        drv.release()
        checks = drv.check()
    return drv, rec, checks, device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the control in the program's place")
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 2
    from portbench.harness.manifest import load_cell
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    try:
        import sd_animation_optical_flow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        _, rec, checks, device = measure(cell, args.seed, args.seconds,
                                         bool(args.trace), work, T0,
                                         control=args.control)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    t = time.time()
    res = result_line(cell, rec, checks, bool(args.trace), device)
    setup_s = rec.extra.get("setup_s", 0.0)
    print(f"portbench: setup_s {setup_s:.3f} window_s {rec.window_s:.3f} "
          f"frames {rec.frames} trace_read_s "
          f"{rec.extra.get('trace_read_s', 0.0):.1f} readings_s "
          f"{time.time() - t:.1f} total_s {time.time() - T0:.1f}",
          file=sys.stderr)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
