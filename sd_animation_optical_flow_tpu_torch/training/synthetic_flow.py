"""Synthetic optical-flow scenes with dense ground truth + occlusion.

Counterpart of ``sd_animation_optical_flow_tpu/training/synthetic_flow.py``
(numpy on the host there): a smoothly moving textured background plus an
independently moving textured rectangle, with exact dense flow, a
validity mask and the occlusion / disocclusion masks. ``flow`` maps
*source* (img1) pixels to their position in the *target* (img2); the
target is rendered by sampling the source texture at ``x + fwd(x)``, so
``flow`` is the fixed-point inverse of the rendering field.

Every random draw is made with the caller's ``np.random.Generator`` in
the JAX module's order and shapes (the coarse grids are tiny), so a seed
gives the JAX package's scene. The full-resolution arithmetic (the
bilinear upsamplings, the 25-step field inversion, the sampling, the
masks) runs in torch on ``device``, in the dtypes numpy promotes to
there: the interpolation weights, the displacement field and the target
background are float64 (a float32 grid minus an int64 index is float64
in numpy), the textures float32. At 512x768 the numpy renderer spends
seconds a scene in the inversion; on the card a batch's scenes render
together, about a thousand small launches a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64


def _linspace32(stop: int, num: int, device) -> torch.Tensor:
    # numpy computes linspace in float64 and casts
    return torch.from_numpy(np.linspace(0, stop, num, dtype=np.float32)) \
        .to(device)


def _bilinear_up(coarse: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., gh, gw, C] float32 -> [..., h, w, C] float64 bilinear
    upsample (align corners)."""
    gh, gw = coarse.shape[-3:-1]
    ys = _linspace32(gh - 1, h, coarse.device)
    xs = _linspace32(gw - 1, w, coarse.device)
    y0 = ys.to(torch.int64).clamp(0, gh - 2)
    x0 = xs.to(torch.int64).clamp(0, gw - 2)
    fy = (ys.to(F64) - y0.to(F64))[:, None, None]
    fx = (xs.to(F64) - x0.to(F64))[None, :, None]
    c = coarse.to(F64)
    r0, r1 = c.index_select(-3, y0), c.index_select(-3, y0 + 1)
    c00, c01 = r0.index_select(-2, x0), r0.index_select(-2, x0 + 1)
    c10, c11 = r1.index_select(-2, x0), r1.index_select(-2, x0 + 1)
    return (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
            + c10 * fy * (1 - fx) + c11 * fy * fx)


def smooth_field(rng: np.random.Generator, h: int, w: int, *, scale: int,
                 amplitude: float, device="cuda") -> torch.Tensor:
    """Low-frequency Gaussian random displacement field [h, w, 2]
    (float64)."""
    gh, gw = max(h // scale, 2), max(w // scale, 2)
    coarse = rng.standard_normal((gh, gw, 2)).astype(np.float32)
    return _bilinear_up(torch.from_numpy(coarse).to(device), h, w) * amplitude


def _gather2d(field: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor):
    """field [B, H, W, C] at integer coords iy / ix [B, h, w] -> [B, h, w,
    C] (one flat gather)."""
    b, hh, ww, ch = field.shape
    idx = (iy * ww + ix).reshape(b, -1, 1).expand(-1, -1, ch)
    return field.reshape(b, hh * ww, ch).gather(1, idx) \
        .reshape(*iy.shape, ch)


def _sample_bilinear(field: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """field [..., H, W, C] sampled at float64 coords [..., h, w] (border
    clamp; the leading dims are a batch, or none) -> float64 [..., h, w,
    C]."""
    h, w = field.shape[-3:-1]
    lead = field.shape[:-3]
    f = field.to(F64).reshape(-1, h, w, field.shape[-1])
    x = x.to(F64).clamp(0, w - 1.001).reshape(f.shape[0], *x.shape[-2:])
    y = y.to(F64).clamp(0, h - 1.001).reshape(f.shape[0], *y.shape[-2:])
    x0, y0 = x.to(torch.int64), y.to(torch.int64)
    fx = (x - x0.to(F64))[..., None]
    fy = (y - y0.to(F64))[..., None]
    out = (_gather2d(f, y0, x0) * (1 - fy) * (1 - fx)
           + _gather2d(f, y0, x0 + 1) * (1 - fy) * fx
           + _gather2d(f, y0 + 1, x0) * fy * (1 - fx)
           + _gather2d(f, y0 + 1, x0 + 1) * fy * fx)
    return out.reshape(*lead, *out.shape[1:])


def _grid(h: int, w: int, device):
    """(yy, xx) float32 [h, w] pixel coordinates."""
    return torch.meshgrid(torch.arange(h, dtype=F32, device=device),
                          torch.arange(w, dtype=F32, device=device),
                          indexing="ij")


def invert_field(fwd: torch.Tensor, iters: int = 25) -> torch.Tensor:
    """Fixed-point inverse of a smooth displacement field [..., h, w, 2]:
    bwd(x) = -fwd(x + bwd(x)); float32 out."""
    h, w = fwd.shape[-3:-1]
    yy, xx = _grid(h, w, fwd.device)
    bwd = -fwd.to(F64)
    for _ in range(iters):
        bwd = -_sample_bilinear(fwd, xx + bwd[..., 0], yy + bwd[..., 1])
    return bwd.to(F32)


OCTAVES = (4, 8, 16, 32)


def _texture(coarse: list, h: int, w: int) -> torch.Tensor:
    """Textures [N, h, w, 3] float32 0..255 from their coarse grids (one
    [N, gh, gw, 3] tensor an octave): each octave added in float64 and
    stored in float32, as numpy's in-place add does, then each texture
    shifted and scaled to 0..255."""
    img = torch.zeros((coarse[0].shape[0], h, w, 3), dtype=F32,
                      device=coarse[0].device)
    amp = 1.0
    for c in coarse:
        img = (img.to(F64) + amp * _bilinear_up(c, h, w)).to(F32)
        amp *= 0.7
    img = img - img.amin((1, 2, 3), keepdim=True)
    return img * (255.0 / img.amax((1, 2, 3), keepdim=True).clamp_min(1e-6))


def multiscale_texture(rng: np.random.Generator, h: int, w: int,
                       octaves=OCTAVES, device="cuda") -> torch.Tensor:
    """RGB texture [h, w, 3] float32 0..255 with structure at several
    scales (pure white noise aliases under bilinear warps; a flat texture
    is aperture-ambiguous everywhere)."""
    coarse = [torch.from_numpy(rng.standard_normal(
        (max(h // sc, 2), max(w // sc, 2), 3)).astype(np.float32))
        .to(device)[None] for sc in octaves]
    return _texture(coarse, h, w)[0]


class FlowScene(NamedTuple):
    img1: torch.Tensor      # [H, W, 3] float32 RGB 0..255 (source)
    img2: torch.Tensor      # [H, W, 3] (target)
    flow: torch.Tensor      # [H, W, 2] source->target, exact
    valid: torch.Tensor     # [H, W] float32, 1 = ground truth in frame
    occluded: torch.Tensor  # [H, W] bool: source pixels hidden in the
                            # target (covered by the mover or out of frame)
    disoccluded: torch.Tensor  # [H, W] bool: TARGET pixels hidden in the
                               # source (the grid the pipelines'
                               # confidence maps live on)


class _Draws(NamedTuple):
    """A scene's random draws, in the JAX ``render_scene``'s order."""
    bg_amp: float
    bg: list                # the background texture's coarse grids
    fg: list                # the mover's
    fwd: np.ndarray         # the displacement field's coarse grid
    ry: int
    rx: int
    cy: int
    cx: int
    fg_shift: tuple
    gain: float
    bias: float


def _draw(rng: np.random.Generator, h: int, w: int, bg_amp=None,
          fg_shift=None) -> _Draws:
    if bg_amp is None:
        bg_amp = float(rng.uniform(2.0, 10.0))
    scale = int(rng.choice([16, 24, 32]))
    tex = [[rng.standard_normal((max(h // sc, 2), max(w // sc, 2), 3))
            .astype(np.float32) for sc in OCTAVES] for _ in range(2)]
    fwd = rng.standard_normal((max(h // scale, 2), max(w // scale, 2), 2)) \
        .astype(np.float32)
    ry = int(rng.integers(h // 8, h // 4))
    rx = int(rng.integers(w // 8, w // 4))
    cy = int(rng.integers(ry, h - ry))
    cx = int(rng.integers(rx, w - rx))
    if fg_shift is None:
        m = max(h, w) / 8.0
        fg_shift = (float(rng.uniform(-m, m)), float(rng.uniform(-m, m)))
    gain = float(rng.uniform(0.94, 1.06))
    bias = float(rng.uniform(-6.0, 6.0))
    return _Draws(bg_amp, tex[0], tex[1], fwd, ry, rx, cy, cx, fg_shift,
                  gain, bias)


def _render(draws: list, h: int, w: int, device) -> tuple:
    """Scenes from their draws, stacked over a leading batch axis:
    (img1, img2, flow, valid, occluded, disoccluded). The arithmetic is
    batched across the scenes (the same elementwise operations as one
    scene at a time)."""
    b = len(draws)
    dev = torch.device(device)

    def up(arrays):
        return torch.from_numpy(np.stack(arrays)).to(dev)

    def per_scene(values, dtype):       # -> [B, 1, 1, 1 or 2]
        return torch.tensor(values, dtype=dtype, device=dev) \
            .reshape(b, 1, 1, -1)

    tex = _texture([up([d.bg[k] for d in draws] + [d.fg[k] for d in draws])
                    for k in range(len(OCTAVES))], h, w)
    bg_tex, fg_tex = tex[:b], tex[b:]

    # fwd: target coords -> source offsets (renders the target); the
    # ground-truth source -> target flow is its inverse. Scenes whose
    # coarse grids share a size are upsampled together.
    fwd = torch.empty((b, h, w, 2), dtype=F64, device=dev)
    by_size = {}
    for i, d in enumerate(draws):
        by_size.setdefault(d.fwd.shape, []).append(i)
    for idx in by_size.values():
        fwd[idx] = _bilinear_up(up([draws[i].fwd for i in idx]), h, w)
    fwd = fwd * per_scene([d.bg_amp for d in draws], F64)
    bwd = invert_field(fwd)

    yy, xx = _grid(h, w, dev)
    bg2 = _sample_bilinear(bg_tex, xx + fwd[..., 0], yy + fwd[..., 1])

    # foreground rectangle: source position + independent shift
    fg_src = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    fg_tgt = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    moved = []
    for i, d in enumerate(draws):
        sx, sy = d.fg_shift
        fg_src[i, d.cy - d.ry:d.cy + d.ry, d.cx - d.rx:d.cx + d.rx] = True
        ty0, ty1 = int(round(d.cy + sy)) - d.ry, int(round(d.cy + sy)) + d.ry
        tx0, tx1 = int(round(d.cx + sx)) - d.rx, int(round(d.cx + sx)) + d.rx
        fg_tgt[i, max(ty0, 0):max(ty1, 0), max(tx0, 0):max(tx1, 0)] = True
        moved.append((round(d.cx + sx) - d.cx, round(d.cy + sy) - d.cy))

    img1 = torch.where(fg_src[..., None], fg_tex, bg_tex)
    img2 = torch.where(fg_tgt[..., None], fg_tex.to(F64), bg2)
    flow = torch.where(fg_src[..., None], per_scene(moved, F32), bwd)

    # occlusion on the SOURCE grid: background pixels whose target
    # position lands under the moved rectangle, plus anything leaving
    # the frame (torch.round, like np.rint, rounds half to even)
    def lands_in(mask, px, py):
        ix = torch.round(px).to(torch.int64).clamp(0, w - 1)
        iy = torch.round(py).to(torch.int64).clamp(0, h - 1)
        return _gather2d(mask[..., None], iy, ix)[..., 0]

    tx = xx + flow[..., 0]
    ty = yy + flow[..., 1]
    oob = (tx < 0) | (tx > w - 1) | (ty < 0) | (ty > h - 1)
    occluded = (lands_in(fg_tgt, tx, ty) & ~fg_src) | oob

    # disocclusion on the TARGET grid: background pixels whose source
    # location (x + fwd) lands under the source-frame rectangle, or out
    # of frame
    spx = xx + fwd[..., 0]
    spy = yy + fwd[..., 1]
    oob_t = (spx < 0) | (spx > w - 1) | (spy < 0) | (spy > h - 1)
    disoccluded = (lands_in(fg_src, spx, spy) & ~fg_tgt) | oob_t

    valid = (~oob).to(F32)

    # mild photometric difference between frames (exposure drift)
    img2 = (img2 * per_scene([d.gain for d in draws], F64)
            + per_scene([d.bias for d in draws], F64)).clamp(0, 255)
    return img1, img2.to(F32), flow, valid, occluded, disoccluded


def render_scene(rng: np.random.Generator, h: int = 128, w: int = 192, *,
                 bg_amp: float | None = None, fg_shift: tuple | None = None,
                 device="cuda") -> FlowScene:
    """One source / target pair on ``device``: a smoothly moving textured
    background plus an independently moving textured rectangle (the full
    background texture exists behind the mover, so disocclusions render
    consistently)."""
    scene = _render([_draw(rng, h, w, bg_amp, fg_shift)], h, w, device)
    return FlowScene(*(t[0] for t in scene))


def synthetic_batch(rng: np.random.Generator, batch: int, h: int = 128,
                    w: int = 192, device="cuda"):
    """Stacked training batch: (img1, img2, flow, valid) plus the
    occlusion masks (evaluation only, not a loss input); the scenes are
    drawn from ``rng`` one after the other and rendered together."""
    return _render([_draw(rng, h, w) for _ in range(batch)], h, w, device)
