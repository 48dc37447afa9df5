"""SD first-stage VAE (AutoencoderKL) on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/models/vae.py``: ch=128,
ch_mult (1,2,4,4), 2 res-blocks per level, mid attention, double_z,
z_channels=4, the 0.18215 latent scale. NHWC at every public function
(convolutions run on the channels_last view, see models/layers.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..ops.attention import attention
from .layers import (Init, conv2d, conv2d_init, group_norm, norm_init,
                     swish, upsample2x_conv)

GN_EPS = 1e-6  # the VAE's GroupNorm eps


@dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Sequence[int] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    scale_factor: float = 0.18215

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _resblock_init(init: Init, in_ch, out_ch):
    p = {
        "norm1": norm_init(init, in_ch),
        "conv1": conv2d_init(init, in_ch, out_ch, 3),
        "norm2": norm_init(init, out_ch),
        "conv2": conv2d_init(init, out_ch, out_ch, 3),
    }
    if in_ch != out_ch:
        p["nin_shortcut"] = conv2d_init(init, in_ch, out_ch, 1)
    return p


def _resblock(p, x):
    h = swish(group_norm(p["norm1"], x, eps=GN_EPS))
    h = conv2d(p["conv1"], h)
    h = swish(group_norm(p["norm2"], h, eps=GN_EPS))
    h = conv2d(p["conv2"], h)
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def _attnblock_init(init: Init, ch):
    return {
        "norm": norm_init(init, ch),
        "q": conv2d_init(init, ch, ch, 1),
        "k": conv2d_init(init, ch, ch, 1),
        "v": conv2d_init(init, ch, ch, 1),
        "proj_out": conv2d_init(init, ch, ch, 1),
    }


def _attnblock(p, x):
    """Mid-block single-head attention over the 1/8-res token grid
    (6144 tokens, d = 512 at 512x768: the wide flash kernel's route)."""
    b, hh, ww, c = x.shape
    h = group_norm(p["norm"], x, eps=GN_EPS)
    q = conv2d(p["q"], h).reshape(b, hh * ww, 1, c)
    k = conv2d(p["k"], h).reshape(b, hh * ww, 1, c)
    v = conv2d(p["v"], h).reshape(b, hh * ww, 1, c)
    out = attention(q, k, v).reshape(b, hh, ww, c)
    return x + conv2d(p["proj_out"], out)


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def encoder_init(init: Init, cfg: VAEConfig):
    chs = [cfg.ch * m for m in cfg.ch_mult]
    p = {"conv_in": conv2d_init(init, cfg.in_channels, cfg.ch, 3)}
    in_ch = cfg.ch
    downs = []
    for lvl, out_ch in enumerate(chs):
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_resblock_init(init, in_ch, out_ch))
            in_ch = out_ch
        lvl_p = {"blocks": blocks}
        if lvl != len(chs) - 1:
            lvl_p["downsample"] = conv2d_init(init, in_ch, in_ch, 3)
        downs.append(lvl_p)
    p["down"] = downs
    p["mid"] = {
        "block_1": _resblock_init(init, in_ch, in_ch),
        "attn_1": _attnblock_init(init, in_ch),
        "block_2": _resblock_init(init, in_ch, in_ch),
    }
    z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    p["norm_out"] = norm_init(init, in_ch)
    p["conv_out"] = conv2d_init(init, in_ch, z_out, 3)
    return p


def encoder_apply(p, cfg: VAEConfig, x):
    h = conv2d(p["conv_in"], x)
    for lvl_p in p["down"]:
        for blk in lvl_p["blocks"]:
            h = _resblock(blk, h)
        if "downsample" in lvl_p:
            # stride-2 conv with asymmetric (0,1) padding
            h = conv2d(lvl_p["downsample"], h, stride=2,
                       padding=((0, 1), (0, 1)))
    h = _resblock(p["mid"]["block_1"], h)
    h = _attnblock(p["mid"]["attn_1"], h)
    h = _resblock(p["mid"]["block_2"], h)
    h = swish(group_norm(p["norm_out"], h, eps=GN_EPS))
    return conv2d(p["conv_out"], h)


def decoder_init(init: Init, cfg: VAEConfig):
    chs = [cfg.ch * m for m in cfg.ch_mult]
    block_in = chs[-1]
    p = {"conv_in": conv2d_init(init, cfg.z_channels, block_in, 3)}
    p["mid"] = {
        "block_1": _resblock_init(init, block_in, block_in),
        "attn_1": _attnblock_init(init, block_in),
        "block_2": _resblock_init(init, block_in, block_in),
    }
    ups = []
    for lvl in reversed(range(len(chs))):
        out_ch = chs[lvl]
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_resblock_init(init, block_in, out_ch))
            block_in = out_ch
        lvl_p = {"blocks": blocks}
        if lvl != 0:
            lvl_p["upsample"] = conv2d_init(init, block_in, block_in, 3)
        ups.append(lvl_p)   # stored top (coarsest) -> bottom
    p["up"] = ups
    p["norm_out"] = norm_init(init, block_in)
    p["conv_out"] = conv2d_init(init, block_in, cfg.out_ch, 3)
    return p


def decoder_apply(p, cfg: VAEConfig, z):
    h = conv2d(p["conv_in"], z)
    h = _resblock(p["mid"]["block_1"], h)
    h = _attnblock(p["mid"]["attn_1"], h)
    h = _resblock(p["mid"]["block_2"], h)
    for lvl_p in p["up"]:
        for blk in lvl_p["blocks"]:
            h = _resblock(blk, h)
        if "upsample" in lvl_p:
            h = upsample2x_conv(lvl_p["upsample"], h)
    h = swish(group_norm(p["norm_out"], h, eps=GN_EPS))
    return conv2d(p["conv_out"], h)


# ---------------------------------------------------------------------------
# AutoencoderKL facade
# ---------------------------------------------------------------------------

def vae_init(init: Init, cfg: VAEConfig = VAEConfig()):
    z2 = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    return {
        "encoder": encoder_init(init, cfg),
        "decoder": decoder_init(init, cfg),
        "quant_conv": conv2d_init(init, z2, 2 * cfg.embed_dim, 1),
        "post_quant_conv": conv2d_init(init, cfg.embed_dim, cfg.z_channels,
                                       1),
    }


def encode_moments(params, cfg: VAEConfig, x):
    """x [B,H,W,3] in [-1,1] -> (mean, logvar) each [B,H/8,W/8,4]."""
    moments = conv2d(params["quant_conv"],
                     encoder_apply(params["encoder"], cfg, x))
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def encode(params, cfg: VAEConfig, x, *, noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None, sample: bool = True):
    """First-stage encoding including the latent scale factor.

    With ``sample`` a posterior sample ``mean + std * noise`` is taken;
    ``noise`` is given as a tensor of the latent's shape, or drawn from
    ``generator`` (one of the two is required). ``sample=False`` returns
    the mean."""
    mean, logvar = encode_moments(params, cfg, x)
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError("sampling encode needs noise or a generator")
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=torch.float32)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
    else:
        z = mean
    return z * cfg.scale_factor


def decode(params, cfg: VAEConfig, z):
    """Latent [B,h,w,4] (scaled) -> image [B,H,W,3] in [-1,1]-ish."""
    z = z / cfg.scale_factor
    z = conv2d(params["post_quant_conv"], z)
    return decoder_apply(params["decoder"], cfg, z)
