"""Backward warping (flow-based remap) with cv2 parity, on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/ops/warp.py``: ``remap``
(cv2.remap with ``INTER_CUBIC`` (A = -0.75), ``INTER_LINEAR`` or
``INTER_NEAREST`` and a zero ``BORDER_CONSTANT``), ``warp_frame``,
``warp_frame_latent`` (a pixel-resolution round trip), the fused warp +
confidence-threshold + dilated mask step of the pixel pipeline
(``warp_mask_fused``) and ``flow_travel_distance``. Each output pixel
sums its n x n window of taps, each tap gathered from the flattened
image; a tap outside the image reads 0.
"""

from __future__ import annotations

import torch

from .filters import dilate
from .resize import resize


def _cubic_weights(f, a: float = -0.75):
    """cv2's bicubic weights (A = -0.75) of taps -1..2 at phase f."""
    w0 = ((a * (f + 1) - 5 * a) * (f + 1) + 8 * a) * (f + 1) - 4 * a
    w1 = ((a + 2) * f - (a + 3)) * f * f + 1
    g = 1 - f
    w2 = ((a + 2) * g - (a + 3)) * g * g + 1
    w3 = 1.0 - w0 - w1 - w2
    return w0, w1, w2, w3


def remap(img, map_x, map_y, *, mode: str = "cubic"):
    """dst(y, x) = src(map_y[y, x], map_x[y, x]) with a zero border.

    img [H, W, C] or [H, W]; maps [h, w] float absolute source
    coordinates. A float image is sampled in its dtype; an integer image
    in f32, then rounded and clipped to [0, 255] in its dtype ('nearest'
    on a 2-D integer image returns f32, as the JAX remap does)."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    hh, ww, c = img.shape
    cdt = img.dtype if img.is_floating_point() else torch.float32
    flat = img.to(cdt).reshape(hh * ww, c)

    def tap(iy, ix):
        valid = ((ix >= 0) & (ix < ww) & (iy >= 0) & (iy < hh))[..., None]
        return torch.where(valid, flat[iy.clamp(0, hh - 1) * ww
                                       + ix.clamp(0, ww - 1)], 0.0)

    if mode == "nearest":
        out = tap(torch.round(map_y).long(), torch.round(map_x).long())
        return out[..., 0] if squeeze else out.to(img.dtype)
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = (map_x - x0).to(cdt)
    fy = (map_y - y0).to(cdt)
    ix, iy = x0.long(), y0.long()
    if mode == "cubic":
        wx, wy, off = _cubic_weights(fx), _cubic_weights(fy), -1
    elif mode == "linear":
        wx, wy, off = (1 - fx, fx), (1 - fy, fy), 0
    else:
        raise ValueError(mode)
    out = 0
    for j, wyj in enumerate(wy):
        row = 0
        for i, wxi in enumerate(wx):
            row = row + tap(iy + off + j, ix + off + i) * wxi[..., None]
        out = out + row * wyj[..., None]
    out = out[..., 0] if squeeze else out
    if not img.is_floating_point():
        out = torch.clamp(torch.round(out), 0, 255).to(img.dtype)
    return out


def _coord_grids(h, w, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys.expand(h, w), xs.expand(h, w)


def warp_frame(frame, flow, *, mode: str = "cubic"):
    """Backward-warp ``frame`` by ``flow`` [H, W, 2]: target pixel (x, y)
    reads source (x + fx, y + fy)."""
    gy, gx = _coord_grids(flow.shape[0], flow.shape[1], flow.device)
    return remap(frame, gx + flow[..., 0], gy + flow[..., 1], mode=mode)


def warp_frame_latent(latent, flow, *, mode: str = "cubic"):
    """Latent warp through pixel resolution: resize latent [h, w, C] to
    the flow's resolution (cubic), warp, resize back (cubic)."""
    lh, lw = latent.shape[0], latent.shape[1]
    up = resize(latent, tuple(flow.shape[:2]), "cubic")
    return resize(warp_frame(up, flow, mode=mode), (lh, lw), "cubic")


def warp_mask_fused(reference_ai_frame, flow, confidence,
                    dilate_kernel=None, *, conf_thres: float = 0.95):
    """Warp the AI key frame along ``flow`` and build the inpaint mask in
    one step: the warped frame (cubic) clipped to [0, 255], and mask01 =
    (confidence < conf_thres) as f32, dilated by ``dilate_kernel`` (a
    host boolean element, ``ops.filters.ellipse_kernel``) when given.
    ``flow`` [H, W, 2] / ``confidence`` [H, W], or with a leading frame
    axis (the reference frame is shared). Returns (warped, mask01);
    mask01 == 1 marks pixels to inpaint."""
    batched = flow.dim() == 4
    if batched:
        warped = torch.stack([warp_frame(reference_ai_frame, f)
                              for f in flow])
    else:
        warped = warp_frame(reference_ai_frame, flow)
    warped = torch.clamp(warped, 0.0, 255.0)
    mask = (confidence < conf_thres).float()
    if dilate_kernel is not None:
        mask = torch.stack([dilate(m, dilate_kernel) for m in mask]) \
            if batched else dilate(mask, dilate_kernel)
    return warped, mask


def flow_travel_distance(flow, confidence, *, conf_gate: float = 0.9):
    """|flow| with the pixels under ``conf_gate`` confidence zeroed."""
    v = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    return torch.where(confidence < conf_gate, 0.0, v)
