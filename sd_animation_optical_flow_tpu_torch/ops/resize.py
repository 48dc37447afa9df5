"""cv2-parity image resizing as two separable weight-matrix products.

Counterpart of ``sd_animation_optical_flow_tpu/ops/resize.py``
(``resize_matrix``, ``resize``): the per-axis weight matrices are built on
the host with numpy per (in, out, mode) and applied as an H-axis then a
W-axis product, f32 accumulation, rounded to the input dtype after each;
``resize_u8`` gives cv2's uint8 results.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _clip_gather_weights(idx, w, size):
    """Accumulate out-of-range taps onto the clamped edge pixel
    (cv2 BORDER_REPLICATE semantics used by cv2.resize)."""
    out, taps = idx.shape
    mat = np.zeros((out, size), np.float64)
    np.add.at(mat, (np.repeat(np.arange(out), taps),
                    np.clip(idx, 0, size - 1).ravel()), w.ravel())
    return mat


def _cubic_weight(t, a=-0.75):
    """cv2's bicubic kernel (A = -0.75) at tap distance t."""
    t = np.abs(t)
    return np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                    np.where(t < 2, ((a * t - 5 * a) * t + 8 * a) * t - 4 * a,
                             0))


def _lanczos_weight(t, taps=4):
    """The Lanczos-4 kernel at tap distance t (0 beyond 4 taps)."""
    t = np.asarray(t, np.float64)
    w = np.sinc(t) * np.sinc(t / taps)
    return np.where(np.abs(t) < taps, w, 0.0)


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """[out_size, in_size] row-stochastic resize weights for one axis
    (modes 'nearest', 'linear', 'cubic', 'lanczos4', 'area'); taps past
    an edge land on the edge pixel."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5

    if mode == "nearest":
        idx = np.clip(np.floor((dst + 0.5) * scale).astype(int), 0,
                      in_size - 1)
        mat = np.zeros((out_size, in_size))
        mat[np.arange(out_size), idx] = 1.0
    elif mode == "linear":
        i0 = np.floor(src).astype(int)
        f = src - i0
        mat = _clip_gather_weights(np.stack([i0, i0 + 1], 1),
                                   np.stack([1 - f, f], 1), in_size)
    elif mode in ("cubic", "lanczos4"):
        i0 = np.floor(src).astype(int)
        f = src - i0
        if mode == "cubic":
            offs = np.arange(-1, 3)
            w = _cubic_weight(f[:, None] - offs[None])
        else:
            offs = np.arange(-3, 5)
            w = _lanczos_weight(f[:, None] - offs[None])
            w = w / w.sum(1, keepdims=True)
        mat = _clip_gather_weights(i0[:, None] + offs[None], w, in_size)
    elif mode == "area":
        if out_size >= in_size:
            # cv2 INTER_AREA upscale falls back to bilinear-like sampling
            return resize_matrix(in_size, out_size, "linear")
        mat = np.zeros((out_size, in_size))
        for o in range(out_size):
            lo, hi = o * scale, (o + 1) * scale
            for i in range(int(np.floor(lo)), min(int(np.ceil(hi)), in_size)):
                overlap = min(hi, i + 1) - max(lo, i)
                if overlap > 0:
                    mat[o, i] = overlap
        mat /= mat.sum(1, keepdims=True)
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return mat.astype(np.float32)


def resize(x, out_hw, mode: str = "linear"):
    """x [..., H, W, C] -> [..., out_h, out_w, C]. Takes a float x: the
    weight matrices are cast to x's dtype, so an integer x comes out
    wrong (as in JAX); uint8 images go through :func:`resize_u8`."""
    out_h, out_w = out_hw
    h, w = x.shape[-3], x.shape[-2]
    mh = torch.from_numpy(resize_matrix(h, out_h, mode)).to(x.device, x.dtype)
    mw = torch.from_numpy(resize_matrix(w, out_w, mode)).to(x.device, x.dtype)
    y = torch.einsum("oh,...hwc->...owc", mh.float(), x.float()).to(x.dtype)
    return torch.einsum("pw,...owc->...opc", mw.float(),
                        y.float()).to(x.dtype)


def resize_u8(x_u8, out_hw, mode: str):
    """cv2.resize of a uint8 image [..., H, W, C]: the f32 resize rounded
    half up and clipped, back to uint8 (INTER_AREA's pixels exactly from
    1080x1920 .. 600x900 to 512x768; cubic within 1 of cv2's fixed
    point)."""
    out = resize(x_u8.float(), out_hw, mode)
    return torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
