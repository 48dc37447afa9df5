"""Correlation volumes and their windowed lookup for RAFT, on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/ops/correlation.py``. Two
interchangeable paths:

* the all-pairs volume (``all_pairs_correlation``: one f32 product
  [B, HW, D] x [B, D, HW] scaled 1/sqrt(D)), average-pooled into a
  pyramid (``build_pyramid``) and sampled every iteration in a bilinear
  (2r+1)^2 window per level (``lookup_pyramid``; ``CorrPyramid`` holds
  both);
* the on-the-fly windowed correlation (``alt_correlation_xla``, the
  reference's ``alt_cuda_corr`` contract): only the window around each
  pixel's coordinates is correlated, level by level of a pyramid of
  fmap2 (``fmap_pyramid``), with no (HW)^2 volume.

Both run as plain PyTorch (the JAX package has no Pallas kernel here).
The pyramid pools in the storage dtype in the JAX package's order, and
the window lookup gathers one integer (2r+2)^2 window per pixel and
applies one bilinear stencil to it in f32, as the JAX lookup does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..models.layers import avg_pool2d


def all_pairs_correlation(fmap1, fmap2):
    """fmap1 / fmap2 [B, H, W, D] -> corr [B, H, W, H, W] scaled 1/sqrt(D):
    the products in f32, cast to fmap1's dtype."""
    b, h, w, d = fmap1.shape
    f1 = fmap1.reshape(b, h * w, d).float()
    f2 = fmap2.reshape(b, h * w, d).float()
    corr = torch.matmul(f1, f2.transpose(1, 2)) / math.sqrt(d)
    return corr.reshape(b, h, w, h, w).to(fmap1.dtype)


def _pool2(vol):
    """2x2 average pool of [N, H, W] (an odd last row / column dropped),
    summed in the window's row-major order and rounded to vol's dtype
    after each add, then divided by 4: in bf16 storage this is the JAX
    package's pooling (XLA's reduce_window adds in the operand's dtype)
    to the bit."""
    v = vol[:, :vol.shape[1] // 2 * 2, :vol.shape[2] // 2 * 2]
    return (v[:, 0::2, 0::2] + v[:, 0::2, 1::2] + v[:, 1::2, 0::2]
            + v[:, 1::2, 1::2]) / 4.0


def build_pyramid(corr, num_levels: int = 4):
    """corr [B, H, W, H, W] -> list of [B*H*W, H_l, W_l] levels, each the
    2x2 average pool of the one before."""
    b, h, w = corr.shape[:3]
    pyramid = [corr.reshape(b * h * w, h, w)]
    for _ in range(num_levels - 1):
        pyramid.append(_pool2(pyramid[-1]))
    return pyramid


def _window_lookup(vol, cx, cy, radius: int):
    """Bilinear (2r+1)^2 window of ``vol`` [N, H, W] at base coordinates
    ``cx``, ``cy`` [N] (the window's top-left, centre - r): every tap
    shares the base's sub-pixel phase, so one integer (2r+2)^2 window is
    gathered and one 2x2 stencil is applied to it in f32. Taps outside
    the volume read 0. Returns [N, (2r+1)^2], dy-major, dx-minor."""
    n, h, w = vol.shape
    side = 2 * radius + 1
    win = side + 1
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = (cx - x0)[:, None, None]
    fy = (cy - y0)[:, None, None]
    steps = torch.arange(win, device=vol.device)
    yy = y0.long()[:, None] + steps                          # [N, win]
    xx = x0.long()[:, None] + steps
    valid = ((yy >= 0) & (yy < h))[:, :, None] \
        & ((xx >= 0) & (xx < w))[:, None, :]
    idx = yy.clamp(0, h - 1)[:, :, None] * w + xx.clamp(0, w - 1)[:, None, :]
    taps = vol.reshape(n, h * w).gather(1, idx.reshape(n, win * win))
    taps = taps.reshape(n, win, win).float()
    taps = torch.where(valid, taps, 0.0)
    out = ((1 - fy) * (1 - fx) * taps[:, :side, :side]
           + (1 - fy) * fx * taps[:, :side, 1:]
           + fy * (1 - fx) * taps[:, 1:, :side]
           + fy * fx * taps[:, 1:, 1:])
    return out.reshape(n, side * side)


def lookup_pyramid(pyramid: Sequence[torch.Tensor], coords,
                   radius: int = 4):
    """Sample a (2r+1)^2 window around ``coords`` at every pyramid level.

    coords [B, H, W, 2] (x, y) at level 0 -> [B, H, W, L*(2r+1)^2] f32,
    channels level-major, then dy, then dx. Each pixel's window is read
    from its own row of the volume, so the whole batch is one flat pass
    (the JAX package maps over images above a batch of 2 for XLA's
    gathers; the values are the same)."""
    b, h, w, _ = coords.shape
    flat = coords.reshape(b * h * w, 2).float()
    outs = []
    for lvl, vol in enumerate(pyramid):
        scale = 1.0 / (2 ** lvl)
        outs.append(_window_lookup(vol, flat[:, 0] * scale - radius,
                                   flat[:, 1] * scale - radius, radius))
    side = 2 * radius + 1
    return torch.cat(outs, dim=-1).reshape(b, h, w,
                                           len(pyramid) * side * side)


class CorrPyramid:
    """Precomputed all-pairs pyramid with per-iteration lookup."""

    def __init__(self, fmap1, fmap2, num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        self.pyramid = build_pyramid(all_pairs_correlation(fmap1, fmap2),
                                     num_levels)

    def __call__(self, coords):
        return lookup_pyramid(self.pyramid, coords, self.radius)


def alt_correlation_xla(fmap1, fmap2_pyramid, coords, radius: int = 4):
    """Windowed correlation computed on the fly (the ``alt_cuda_corr``
    contract): for each pixel p and level l, corr[p, dy, dx] =
    <fmap1[p], bilinear(fmap2_l, coords[p] / 2^l + (dx, dy))> / sqrt(D),
    zero outside the level. The JAX name is kept; here it is plain
    PyTorch gathers.

    fmap1 [B, H, W, D]; fmap2_pyramid: list of [B, H_l, W_l, D];
    coords [B, H, W, 2]. Returns [B, H, W, L*(2r+1)^2] f32."""
    b, h, w, d = fmap1.shape
    dev = fmap1.device
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    dx, dy = dx.reshape(-1), dy.reshape(-1)
    f1 = fmap1.reshape(b, h * w, d).float()
    flat = coords.reshape(b, h * w, 2).float()
    outs = []
    for lvl, f2 in enumerate(fmap2_pyramid):
        hl, wl = f2.shape[1:3]
        table = f2.reshape(b, hl * wl, d).float()
        scale = 1.0 / (2 ** lvl)
        cx = flat[..., 0:1] * scale + dx                 # [B, HW, side^2]
        cy = flat[..., 1:2] * scale + dy
        x0 = torch.floor(cx)
        y0 = torch.floor(cy)
        fx, fy = cx - x0, cy - y0
        x0i, y0i = x0.long(), y0.long()

        def tap(yy, xx):
            valid = (xx >= 0) & (xx < wl) & (yy >= 0) & (yy < hl)
            idx = yy.clamp(0, hl - 1) * wl + xx.clamp(0, wl - 1)
            g = table.gather(1, idx.reshape(b, -1, 1).expand(-1, -1, d))
            return torch.where(valid[..., None], g.reshape(idx.shape + (d,)),
                               0.0)

        feat = (tap(y0i, x0i) * ((1 - fy) * (1 - fx))[..., None]
                + tap(y0i, x0i + 1) * ((1 - fy) * fx)[..., None]
                + tap(y0i + 1, x0i) * (fy * (1 - fx))[..., None]
                + tap(y0i + 1, x0i + 1) * (fy * fx)[..., None])
        corr = torch.einsum("bnd,bnkd->bnk", f1, feat)
        outs.append(corr / math.sqrt(d))
    side = 2 * radius + 1
    return torch.cat(outs, dim=-1).reshape(
        b, h, w, len(fmap2_pyramid) * side * side)


def fmap_pyramid(fmap, num_levels: int = 4):
    """Feature pyramid for the on-the-fly path: fmap [B, H, W, D] and its
    successive 2x2 average pools."""
    pyr = [fmap]
    for _ in range(num_levels - 1):
        pyr.append(avg_pool2d(pyr[-1], 2))
    return pyr
