"""Optical-flow visualization (Middlebury color wheel).

Counterpart of ``sd_animation_optical_flow_tpu/utils/flow_viz.py`` (parity
with RAFT's flow_viz): the standard 55-color wheel, bilinear hue
interpolation, radius-scaled saturation, out-of-wheel colors dimmed.
Host-side numpy.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """[55, 3] RGB color wheel (RY/YG/GC/CB/BM/MR segments)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False),   # R 255, G ramps up
        (YG, 1, 0, True),    # G 255, R ramps down
        (GC, 1, 2, False),   # G 255, B ramps up
        (CB, 2, 1, True),    # B 255, G ramps down
        (BM, 2, 0, False),   # B 255, R ramps up
        (MR, 0, 2, True),    # R 255, B ramps down
    ]
    for n, full_c, ramp_c, down in ramps:
        wheel[col:col + n, full_c] = 255
        ramp = np.floor(255 * np.arange(n) / n)
        wheel[col:col + n, ramp_c] = (255 - ramp) if down else ramp
        col += n
    return wheel


_WHEEL = make_colorwheel()


def flow_to_image(flow: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 visualization."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad = np.sqrt(u ** 2 + v ** 2)
    rad_max = max(rad.max(), 1e-5)
    u = u / rad_max
    v = v / rad_max

    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        ch = 2 - i if convert_to_bgr else i
        img[..., ch] = np.floor(255 * col)
    return img
