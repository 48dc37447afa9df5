"""HED soft-edge detector (the ControlNet annotator network) on torch
tensors.

Counterpart of ``sd_animation_optical_flow_tpu/models/hed.py``
(``hed_init``, ``hed_apply``, ``hed_edges``, ``make_hed_fn``,
``port_hed``): five VGG-style conv blocks (64 / 128 / 256 / 512 / 512
channels; 2, 2, 3, 3, 3 convs) with a 2x2 max-pool before every block
after the first, a learned per-channel input shift, and a 1x1
single-channel projection per block. The edge map is sigmoid(mean of the
five side logits, each resized bilinearly to the frame) x 255, clipped
and truncated to uint8 (the annotator's ``apply_hed`` contract). It runs
in f32.

Weights: the annotator's ``ControlNetHED.pth`` state dict (``norm``,
``block{i}.convs.{j}``, ``block{i}.projection``) through
:func:`port_hed`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import Init, conv2d, conv2d_init

_BLOCKS = ((3, 64, 2), (64, 128, 2), (128, 256, 3),
           (256, 512, 3), (512, 512, 3))


def hed_init(init: Init):
    p = {"norm": init.zeros((3,)), "blocks": []}
    for in_ch, out_ch, n_convs in _BLOCKS:
        blk = {"convs": [], "projection": conv2d_init(init, out_ch, 1, 1)}
        ch = in_ch
        for _ in range(n_convs):
            blk["convs"].append(conv2d_init(init, ch, out_ch, 3))
            ch = out_ch
        p["blocks"].append(blk)
    return p


def hed_apply(params, x):
    """x [B, H, W, 3] float (0..255 BGR as loaded) -> five side logits,
    the i-th [B, H / 2^i, W / 2^i, 1]."""
    h = x - params["norm"].to(x.dtype)
    sides = []
    for i, blk in enumerate(params["blocks"]):
        if i > 0:
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        for cp in blk["convs"]:
            h = torch.relu(conv2d(cp, h))
        sides.append(conv2d(blk["projection"], h))
    return sides


def hed_edges(params, image_bgr_u8):
    """[H, W, 3] uint8 BGR (numpy or a tensor) -> [H, W] uint8 edge map on
    the params' device."""
    dev = params["norm"].device
    if not isinstance(image_bgr_u8, torch.Tensor):
        image_bgr_u8 = np.ascontiguousarray(image_bgr_u8)
    x = torch.as_tensor(image_bgr_u8, device=dev).float()[None]
    H, W = x.shape[1:3]
    sides = hed_apply(params, x)
    logit = torch.stack([resize(s[0], (H, W), "linear")[..., 0]
                         for s in sides]).mean(0)
    edge = torch.sigmoid(logit) * 255.0
    return edge.clamp(0, 255).to(torch.uint8)


def make_hed_fn(params):
    """The ``hed_fn`` callable ``models.controlnet.hed_hint`` takes."""
    return lambda img: hed_edges(params, img)


def port_hed(sd: dict, device="cuda"):
    """A ``ControlNetHED.pth`` state dict (arrays or tensors) -> the
    params tree on ``device`` in f32. Torch layout: norm [1, 3, 1, 1];
    block{i}.convs.{j}.weight [O, I, 3, 3]; block{i}.projection.weight
    [1, O, 1, 1] (the port's conv layout already)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=device)

    def conv(name):
        out = {"w": f32(sd[f"{name}.weight"])}
        if sd.get(f"{name}.bias") is not None:
            out["b"] = f32(sd[f"{name}.bias"]).reshape(-1)
        return out

    p = {"norm": f32(sd["norm"]).reshape(-1), "blocks": []}
    for i, (_, _, n_convs) in enumerate(_BLOCKS, start=1):
        p["blocks"].append({
            "convs": [conv(f"block{i}.convs.{j}") for j in range(n_convs)],
            "projection": conv(f"block{i}.projection")})
    return p
