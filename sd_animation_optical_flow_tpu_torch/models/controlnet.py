"""ControlNet on torch tensors: the zero-conv encoder copy of the UNet, the
hint encoder, the hint builders and multi-net mixing.

Counterpart of ``sd_animation_optical_flow_tpu/models/controlnet.py``
(``controlnet_init``, ``controlnet_apply``, ``canny_hint``,
``inpaint_hint``, ``hed_hint``, ``ControlSpec``, ``control_residuals``,
``control_step_weights``, ``mix_controls``). The residuals are computed
once a frame, from the first step's noisy latent, and re-weighted per
step by each net's guidance window (the facades' contract).

The hint builders take a uint8 BGR array ([H, W, 3], numpy or a tensor)
and return a float tensor [batch, H, W, 3] in [0, 1] (the inpaint hint:
-1 in the hole) on ``device``. The Canny and Sobel-fallback filters run
on that device (``ops/filters.py``); no cv2 is needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..diffusion.schedule import rounded
from ..ops.filters import bgr_to_gray_u8, canny, sobel_soft_edge
from .layers import (Init, conv2d, conv2d_init, linear, linear_init, swish,
                     timestep_embedding)
from .unet import (UNetConfig, _resblock, _resblock_init,
                   _spatial_transformer, _spatial_transformer_init)

# the 8-layer stride-8 hint encoder: (in, out, stride) of its 3x3 convs
_HINT_DIMS = ((None, 16, 1), (16, 16, 1), (16, 32, 2), (32, 32, 1),
              (32, 96, 2), (96, 96, 1), (96, 256, 2))


def controlnet_init(init: Init, cfg: UNetConfig = UNetConfig(),
                    hint_channels: int = 3):
    """The UNet's encoder and middle block, a 1x1 zero conv after each of
    the 12 input blocks and the middle one, and the hint encoder with its
    zero-conv tail."""
    mc = cfg.model_channels
    ted = cfg.time_embed_dim
    p: dict = {"time_embed": [linear_init(init, mc, ted),
                              linear_init(init, ted, ted)]}
    input_blocks: list = [{"conv": conv2d_init(init, cfg.in_channels, mc,
                                               3)}]
    zero_convs = [conv2d_init(init, mc, mc, 1, zero=True)]
    ch = mc
    ds = 1
    for lvl, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _resblock_init(init, ch, mult * mc, ted)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk["transformer"] = _spatial_transformer_init(
                    init, ch, cfg.context_dim, cfg.transformer_depth)
            input_blocks.append(blk)
            zero_convs.append(conv2d_init(init, ch, ch, 1, zero=True))
        if lvl != len(cfg.channel_mult) - 1:
            input_blocks.append({"down": conv2d_init(init, ch, ch, 3)})
            zero_convs.append(conv2d_init(init, ch, ch, 1, zero=True))
            ds *= 2
    p["input_blocks"] = input_blocks
    p["zero_convs"] = zero_convs
    p["middle"] = {
        "res1": _resblock_init(init, ch, ch, ted),
        "transformer": _spatial_transformer_init(
            init, ch, cfg.context_dim, cfg.transformer_depth),
        "res2": _resblock_init(init, ch, ch, ted),
    }
    p["middle_out"] = conv2d_init(init, ch, ch, 1, zero=True)
    p["hint"] = [conv2d_init(init, i or hint_channels, o, 3)
                 for i, o, _ in _HINT_DIMS]
    p["hint_out"] = conv2d_init(init, 256, mc, 3, zero=True)
    return p


def controlnet_apply(params, cfg: UNetConfig, x, hint, timesteps, context):
    """x [B, h, w, C] latent, hint [B or 1, 8h, 8w, 3], timesteps [B],
    context [B, L, D] -> a 13-tuple of residuals (12 encoder, then the
    middle), each in x's dtype."""
    nh = cfg.num_heads
    t_emb = timestep_embedding(timesteps, cfg.model_channels, dtype=x.dtype)
    emb = linear(params["time_embed"][1],
                 swish(linear(params["time_embed"][0], t_emb)))

    h_hint = hint.to(x.dtype)
    for conv_p, (_, _, s) in zip(params["hint"], _HINT_DIMS):
        # padding 1 on both sides: the stride-2 convs' 'SAME' would pad
        # (0, 1) and shift the grid
        h_hint = swish(conv2d(conv_p, h_hint, stride=s, padding=1))
    guided_hint = conv2d(params["hint_out"], h_hint)

    outs = []
    h = x
    for i, (blk, zc) in enumerate(zip(params["input_blocks"],
                                      params["zero_convs"])):
        if "conv" in blk:
            h = conv2d(blk["conv"], h)
        elif "down" in blk:
            h = conv2d(blk["down"], h, stride=2, padding=1)
        else:
            h = _resblock(blk["res"], h, emb)
            if "transformer" in blk:
                h, _ = _spatial_transformer(blk["transformer"], h, context,
                                            nh)
        if i == 0:
            h = h + guided_hint
        outs.append(conv2d(zc, h))

    h = _resblock(params["middle"]["res1"], h, emb)
    h, _ = _spatial_transformer(params["middle"]["transformer"], h, context,
                                nh)
    h = _resblock(params["middle"]["res2"], h, emb)
    outs.append(conv2d(params["middle_out"], h))
    return tuple(outs)


# ---------------------------------------------------------------------------
# hint builders
# ---------------------------------------------------------------------------

def _u8(image, device):
    if not isinstance(image, torch.Tensor):
        image = np.ascontiguousarray(image)
    return torch.as_tensor(image, device=device)


def _hint(edges01, batch: int):
    """[H, W] in [0, 1] -> [batch, H, W, 3]."""
    return edges01[None, :, :, None].expand(batch, -1, -1, 3).contiguous()


def canny_hint(image_bgr_u8, low: int = 100, high: int = 200,
               batch: int = 2, device="cuda"):
    """Canny edge hint: cv2.Canny of the 3-channel BGR frame (each pixel's
    gradient from its strongest channel), replicated to 3 channels."""
    edges = canny(_u8(image_bgr_u8, device), low, high)
    return _hint(edges.float() / 255.0, batch)


def inpaint_hint(image_bgr_u8, mask_u8, batch: int = 1, device="cuda"):
    """Inpaint hint: the image in [0, 1] with -1 where the mask is above
    127."""
    img = _u8(image_bgr_u8, device).float()
    hole = (_u8(mask_u8, device) > 127)[..., None]
    img = torch.where(hole, torch.full_like(img, -255.0), img)
    return (img / 255.0)[None].expand(batch, -1, -1, -1).contiguous()


def hed_hint(image_bgr_u8, hed_fn=None, batch: int = 2, device="cuda"):
    """HED soft-edge hint. ``hed_fn``: a callable from the BGR frame to a
    [H, W] edge map in 0..255 (``models.hed.make_hed_fn``); without one,
    the Sobel-magnitude soft edge of the grey frame stands in (cv2's
    BGR2GRAY and Sobel, ``ops/filters.sobel_soft_edge``)."""
    if hed_fn is not None:
        edges = torch.as_tensor(hed_fn(image_bgr_u8), device=device)
    else:
        edges = sobel_soft_edge(bgr_to_gray_u8(_u8(image_bgr_u8, device)))
    return _hint(edges.float() / 255.0, batch)


# ---------------------------------------------------------------------------
# multi-ControlNet
# ---------------------------------------------------------------------------

@dataclass
class ControlSpec:
    """One control source: a net, its config, its hint [B, H, W, 3] and
    its weight over the guidance window [start, end] of the denoise
    progress."""
    params: dict
    cfg: UNetConfig
    hint: torch.Tensor
    weight: float = 1.0
    guidance_start: float = 0.0
    guidance_end: float = 1.0


def control_residuals(specs: Sequence[ControlSpec], x, t, context):
    """Each net's 13 residuals, evaluated once: a list over nets of
    13-tuples. A hint of another batch than x's is broadcast to it."""
    outs = []
    for s in specs:
        hint = torch.as_tensor(s.hint, device=x.device).to(x.dtype)
        if hint.shape[0] != x.shape[0]:
            hint = hint.expand((x.shape[0],) + tuple(hint.shape[1:]))
        outs.append(controlnet_apply(s.params, s.cfg, x, hint, t, context))
    return outs


def control_step_weights(specs: Sequence[ControlSpec], progress: np.ndarray
                         ) -> np.ndarray:
    """[t_enc, n_nets] f32 host weights: each net's weight where the
    step's progress p lies in its [start, end], else 0."""
    w = np.zeros((len(progress), len(specs)), np.float32)
    for j, s in enumerate(specs):
        inside = (progress >= s.guidance_start) & (progress <= s.guidance_end)
        w[:, j] = np.where(inside, s.weight, 0.0)
    return w


def mix_controls(residuals_per_net, weights_j):
    """The weighted sum over nets of one step's residuals: a list of
    13-tuples and the step's [n_nets] weights (host floats), each weight
    rounded to the residual's dtype first."""
    mixed = None
    for j, res in enumerate(residuals_per_net):
        scaled = tuple(r * rounded(weights_j[j], r.dtype).item()
                       for r in res)
        mixed = scaled if mixed is None else \
            tuple(a + b for a, b in zip(mixed, scaled))
    return mixed
