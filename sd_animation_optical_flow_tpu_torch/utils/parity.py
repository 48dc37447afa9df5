"""Output parity against reference frame directories: warped-region PSNR.

Counterpart of ``sd_animation_optical_flow_tpu/utils/parity.py``. The
quality gate is a warped-region PSNR >= 40 dB against the reference's
``converted_%06d.png`` outputs (BASELINE.md). Given two output
directories (ours, the reference's) and the per-frame confidence maps
of ours, it measures per-frame and aggregate PSNR over the warped
(high-confidence) region; inpainted (low-confidence) pixels are
generative and outside the gate. Files are read with the port's PNG
reader: no cv2.

    python -m sd_animation_optical_flow_tpu_torch.utils.parity OURS REF
"""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .images import read_png_bgr


def psnr(a: np.ndarray, b: np.ndarray, mask: Optional[np.ndarray] = None,
         peak: float = 255.0) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if mask is not None:
        m = mask.astype(bool)
        if not m.any():
            return float("nan")
        diff2 = ((a - b) ** 2)[m]
    else:
        diff2 = (a - b) ** 2
    mse = diff2.mean()
    return float("inf") if mse == 0 else 10.0 * np.log10(peak ** 2 / mse)


@dataclass
class FramePair:
    index: int
    ours: str
    reference: str
    confidence: Optional[str] = None


def collect_pairs(ours_dir: str, ref_dir: str,
                  pattern: str = "converted_*.png") -> List[FramePair]:
    def index_of(path):
        m = re.search(r"(\d+)\.png$", os.path.basename(path))
        return int(m.group(1)) if m else -1

    ours = {index_of(p): p for p in
            glob.glob(os.path.join(ours_dir, pattern))}
    refs = {index_of(p): p for p in
            glob.glob(os.path.join(ref_dir, pattern))}
    pairs = []
    for idx in sorted(set(ours) & set(refs)):
        conf = os.path.join(ours_dir, f"pixel_confidence_{idx:06d}.png")
        pairs.append(FramePair(idx, ours[idx], refs[idx],
                               conf if os.path.exists(conf) else None))
    return pairs


def _read(path: str) -> Optional[np.ndarray]:
    """A PNG as BGR uint8, or None where it cannot be read (as cv2.imread
    returns None)."""
    try:
        return read_png_bgr(path)
    except (OSError, ValueError):
        return None


def _gray(bgr: np.ndarray) -> np.ndarray:
    """cv2.imread(..., IMREAD_GRAYSCALE)'s value of a decoded PNG: libpng's
    fixed-point RGB -> gray with OpenCV's coefficients 0.299 / 0.587
    (9797, 19234 and 3737 over 2^15). A gray file's 3 equal channels give
    its value back."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def compare_dirs(ours_dir: str, ref_dir: str, *,
                 conf_thres: int = 242) -> Dict:
    """Aggregate warped-region PSNR report. ``conf_thres`` on the 0-255
    confidence map (242 ~ 0.95) selects the warped region."""
    pairs = collect_pairs(ours_dir, ref_dir)
    per_frame = []
    for p in pairs:
        a = _read(p.ours)
        b = _read(p.reference)
        if a is None or b is None or a.shape != b.shape:
            per_frame.append({"index": p.index, "psnr": None,
                              "note": "unreadable or shape mismatch"})
            continue
        mask = None
        if p.confidence:
            conf = _read(p.confidence)
            if conf is not None:
                mask = np.repeat((_gray(conf) >= conf_thres)[:, :, None],
                                 3, 2)
        per_frame.append({"index": p.index,
                          "psnr": round(psnr(a, b, mask), 3),
                          "warped_frac": (round(float(mask.mean()), 4)
                                          if mask is not None else 1.0)})
    vals = [f["psnr"] for f in per_frame if f["psnr"] is not None]
    # identical frames score inf: that passes the gate (the best parity,
    # not a missing measurement); only the mean needs the finite subset
    finite = [v for v in vals if np.isfinite(v)]
    mean = (round(float(np.mean(finite)), 3) if finite
            else (float("inf") if vals else None))
    return {
        "frames": len(pairs),
        "mean_psnr": mean,
        "min_psnr": round(float(np.min(vals)), 3) if vals else None,
        "gate_40db": bool(vals and len(vals) == len(per_frame)
                          and np.min(vals) >= 40.0),
        "per_frame": per_frame,
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="warped-region PSNR parity vs reference outputs")
    ap.add_argument("ours")
    ap.add_argument("reference")
    ap.add_argument("--conf-thres", type=int, default=242)
    args = ap.parse_args(argv)
    print(json.dumps(compare_dirs(args.ours, args.reference,
                                  conf_thres=args.conf_thres), indent=2))


if __name__ == "__main__":
    main()
