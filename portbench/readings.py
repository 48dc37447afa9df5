"""The readings a cell's correctness limits are set from, on the card,
in one process: for each seed one run of the window's path with a window
of one clip, judged as ``run.py`` judges it (``run.measure``), or with
``--control`` the control judged in the program's place, or with
``--fault <name>`` a fault of ``harness/faults.py`` planted in the
program.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 [--control | --fault <name>]

One JSON line a seed (``correct``, the checks, the share of each
non-key frame that the reference inpaints, and the smallest RMS between
two of the clip's reference frames: how far apart the frames that a swap
would exchange lie) and a summary line (each number's largest and
smallest reading). The benchmark's runs do not run this.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def frame_spread(frames: dict):
    from portbench.drivers.pixel import rms_levels
    imgs = [frames[k] for k in sorted(frames)]
    return min((rms_levels(a, b) for i, a in enumerate(imgs)
                for b in imgs[i + 1:]), default=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--control", action="store_true")
    mode.add_argument("--fault")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import _environment, measure
    _environment()
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from portbench.harness.manifest import load_cell
    cell = load_cell(args.workload)
    lo, hi = {}, {}
    for seed in args.seeds:
        work = Path(tempfile.mkdtemp(prefix="portbench-readings-"))
        try:
            t = time.time()
            torch.cuda.reset_peak_memory_stats()
            drv, rec, checks, _ = measure(cell, seed, 0.0, False, work, t,
                                          control=args.control,
                                          fault=args.fault)
            ok = rec.failed == 0 and all(v <= lim for _, v, lim in checks)
            row = {"seed": seed, "correct": ok, "failed": rec.failed,
                   "checks": {n: v for n, v, _ in checks},
                   "mask_share": [round(drv.ref.mask_share[k], 4)
                                  for k in sorted(drv.ref.mask_share)],
                   "frame_spread": frame_spread(drv.ref.images),
                   "frame_rms": [round(v, 4) for v in drv.per_frame["rms"]],
                   "frame_epe": [round(v, 5) for v in
                                 drv.per_frame["epe"].values()],
                   "seconds": time.time() - t}
            for n, v, _ in checks:
                hi[n] = max(hi.get(n, v), v)
                lo[n] = min(lo.get(n, v), v)
            del drv
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "mode": "control" if args.control
                      else args.fault or "program",
                      "max": hi, "min": lo}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
