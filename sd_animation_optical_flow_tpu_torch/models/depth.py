"""DPT monocular depth estimation (the MiDaS stack) and the depth2img
conditioning.

Counterpart of ``sd_animation_optical_flow_tpu/models/depth.py``
(``DPTConfig``, ``dpt_init``, ``dpt_apply``, ``midas_normalize``,
``depth_to_concat``): a ViT-L/16 backbone of pre-LN blocks in NLC layout
with the patch embedding as one stride-16 convolution, four hooked token
maps read out with the CLS token ('project' readout), reassembled to
four scales with 1x1 convolutions and nearest / strided resampling,
fused coarse to fine with residual conv units, and a convolutional head
to relative inverse depth. NHWC activations, as in the JAX package.

The ViT attention is plain torch with f32 scores (the JAX package
computes it with an einsum and a softmax, outside any Pallas kernel).
The resizes are ``ops/resize.resize``'s (the JAX ``resize``'s weights).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops.resize import resize
from .layers import (Init, conv2d, conv2d_init, gelu, layer_norm, linear,
                     linear_init, nearest_upsample2x, norm_init)


@dataclass(frozen=True)
class DPTConfig:
    """Defaults: dpt_large, ViT-L/16 at 384 (hooks 5, 11, 17, 23;
    reassemble channels 256, 512, 1024, 1024; 256 features)."""
    patch: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    hooks: Sequence[int] = (5, 11, 17, 23)
    reassemble_ch: Sequence[int] = (256, 512, 1024, 1024)
    features: int = 256
    img_size: int = 384          # the position table's reference size
    # the dpt models' input normalization: mean = std = 0.5
    norm_mean: float = 0.5
    norm_std: float = 0.5


# ---------------------------------------------------------------------------
# ViT backbone
# ---------------------------------------------------------------------------

def _vit_block_init(init: Init, width):
    return {
        "ln1": norm_init(init, width),
        "q": linear_init(init, width, width),
        "k": linear_init(init, width, width),
        "v": linear_init(init, width, width),
        "attn_out": linear_init(init, width, width),
        "ln2": norm_init(init, width),
        "mlp_in": linear_init(init, width, width * 4),
        "mlp_out": linear_init(init, width * 4, width),
    }


def _vit_block(lp, x, heads):
    b, n, c = x.shape
    d = c // heads
    h = layer_norm(lp["ln1"], x)
    q = linear(lp["q"], h).reshape(b, n, heads, d)
    k = linear(lp["k"], h).reshape(b, n, heads, d)
    v = linear(lp["v"], h).reshape(b, n, heads, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * float(np.float32(1.0) / np.sqrt(np.float32(d)))
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, c)
    x = x + linear(lp["attn_out"], attn)
    h = layer_norm(lp["ln2"], x)
    return x + linear(lp["mlp_out"], gelu(linear(lp["mlp_in"], h)))


def _readout(rp, tokens, cls):
    """'project' readout: [token | CLS] -> width, GELU."""
    cls_b = cls[:, None, :].expand(tokens.shape)
    return gelu(linear(rp["proj"], torch.cat([tokens, cls_b], dim=-1)))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dpt_init(init: Init, cfg: DPTConfig = DPTConfig()):
    grid = cfg.img_size // cfg.patch
    f = cfg.features
    rc = cfg.reassemble_ch
    return {
        "patch_embed": conv2d_init(init, 3, cfg.width, cfg.patch),
        "cls_token": init.zeros((1, 1, cfg.width)),
        "pos_embed": init.normal((1, grid * grid + 1, cfg.width), 0.02),
        "blocks": [_vit_block_init(init, cfg.width)
                   for _ in range(cfg.layers)],
        "readouts": [{"proj": linear_init(init, 2 * cfg.width, cfg.width)}
                     for _ in range(4)],
        # per-hook 1x1 projection to the reassemble channels
        "reassemble": [conv2d_init(init, cfg.width, ch, 1) for ch in rc],
        # the x4 and x2 branches: nearest upsampling + a 3x3 conv; the
        # /2 branch: a stride-2 3x3 conv
        "resample_up4": conv2d_init(init, rc[0], rc[0], 3),
        "resample_up2": conv2d_init(init, rc[1], rc[1], 3),
        "resample_dn2": conv2d_init(init, rc[3], rc[3], 3),
        # a 3x3 conv per branch to the common feature width
        "scratch": [conv2d_init(init, ch, f, 3, bias=False) for ch in rc],
        # fusion blocks (coarse -> fine): two residual conv units and a
        # 1x1 out conv each
        "fusion": [{
            "rcu1": [conv2d_init(init, f, f, 3), conv2d_init(init, f, f, 3)],
            "rcu2": [conv2d_init(init, f, f, 3), conv2d_init(init, f, f, 3)],
            "out": conv2d_init(init, f, f, 1),
        } for _ in range(4)],
        "head": [conv2d_init(init, f, f // 2, 3),
                 conv2d_init(init, f // 2, 32, 3),
                 conv2d_init(init, 32, 1, 1)],
    }


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _interp_pos_embed(pos, gh, gw, grid):
    """The [1, grid*grid + 1, C] position table resized (linear) to a
    gh x gw grid, the CLS slot kept (non-square inputs)."""
    if gh == grid and gw == grid:
        return pos
    cls, body = pos[:, :1], pos[:, 1:]
    body = body.reshape(1, grid, grid, -1)
    body = resize(body, (gh, gw), mode="linear").reshape(1, gh * gw, -1)
    return torch.cat([cls, body], dim=1)


def _rcu(ps, x):
    h = conv2d(ps[0], torch.relu(x))
    h = conv2d(ps[1], torch.relu(h))
    return x + h


def dpt_apply(params, cfg: DPTConfig, img):
    """img [B, H, W, 3], H and W divisible by 16, already normalized
    ((x - mean) / std) -> inverse depth [B, H, W] (non-negative)."""
    b, H, W, _ = img.shape
    gh, gw = H // cfg.patch, W // cfg.patch
    x = conv2d(params["patch_embed"], img, stride=cfg.patch,
               padding="VALID")                         # [B, gh, gw, C]
    x = x.reshape(b, gh * gw, cfg.width)
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    grid = cfg.img_size // cfg.patch
    x = x + _interp_pos_embed(params["pos_embed"], gh, gw, grid).to(x.dtype)

    hooked = []
    hooks = set(cfg.hooks)
    for i, bp in enumerate(params["blocks"]):
        x = _vit_block(bp, x, cfg.heads)
        if i in hooks:
            hooked.append(x)

    # reassemble the four hooked token maps to four scales
    feats = []
    for i, hx in enumerate(hooked):
        t = _readout(params["readouts"][i], hx[:, 1:], hx[:, 0])
        t = t.reshape(b, gh, gw, cfg.width)
        t = conv2d(params["reassemble"][i], t)
        if i == 0:      # x4: 1/16 -> 1/4
            t = conv2d(params["resample_up4"],
                       nearest_upsample2x(nearest_upsample2x(t)))
        elif i == 1:    # x2: 1/16 -> 1/8
            t = conv2d(params["resample_up2"], nearest_upsample2x(t))
        elif i == 3:    # /2: 1/16 -> 1/32
            # 3x3 stride 2 with symmetric padding 1; 'SAME' would pad
            # (0, 1) and shift the grid
            t = conv2d(params["resample_dn2"], t, stride=2, padding=1)
        feats.append(conv2d(params["scratch"][i], t))

    # coarse-to-fine fusion
    path = None
    for i in reversed(range(4)):
        fp = params["fusion"][i]
        t = feats[i]
        if path is not None:
            t = t + _rcu(fp["rcu1"], path)
        t = _rcu(fp["rcu2"], t)
        t = nearest_upsample2x(t)
        path = conv2d(fp["out"], t)                     # 2x feats[i]

    # head: conv -> resize to the input size -> two convs
    h = conv2d(params["head"][0], path)
    if tuple(h.shape[1:3]) != (H, W):
        h = resize(h, (H, W), mode="linear")
    h = torch.relu(conv2d(params["head"][1], h))
    h = torch.relu(conv2d(params["head"][2], h))
    return h[..., 0]


# ---------------------------------------------------------------------------
# conditioning helpers
# ---------------------------------------------------------------------------

def midas_normalize(img01, cfg: DPTConfig = DPTConfig()):
    """An image in [0, 1] -> (x - mean) / std, the DPT's input."""
    return (img01 - cfg.norm_mean) / cfg.norm_std


def depth_to_concat(depth, latent_hw):
    """Depth map [B, H, W] -> c_concat [B, h, w, 1] in [-1, 1]: a bicubic
    resize to the latent's size, then a per-sample min-max normalization
    with a +1e-3 guard on the range."""
    d = resize(depth[..., None], tuple(latent_hw), mode="cubic")
    dmin = d.amin(dim=(1, 2, 3), keepdim=True)
    dmax = d.amax(dim=(1, 2, 3), keepdim=True)
    return 2.0 * (d - dmin) / (dmax - dmin + 0.001) - 1.0
