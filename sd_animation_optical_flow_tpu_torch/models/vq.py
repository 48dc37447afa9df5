"""VQ first stage (VQModel / VQModelInterface).

Counterpart of ``sd_animation_optical_flow_tpu/models/vq.py``
(``VQConfig``, ``quantizer_init``, ``quantize``, ``embed_code``,
``vq_init``, ``vq_encode_prequant``, ``vq_encode``, ``vq_decode``,
``vq_decode_code``): the KL VAE's encoder and decoder with a single z
(``double_z=False``) around a vector quantizer against an ``n_embed x
embed_dim`` codebook (commitment weight ``beta``) with a straight-through
gradient.

The nearest-codebook search is the JAX package's: the expanded squared
distance ||z||^2 - 2 z.e + ||e||^2 with the cross term one f32 matmul
(never ``torch.cdist``, whose near-ties fall differently), run with TF32
off whatever the process sets.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from .layers import Init, conv2d, conv2d_init
from .vae import (VAEConfig, decoder_apply, decoder_init, encoder_apply,
                  encoder_init)


@dataclass(frozen=True)
class VQConfig:
    """The KL VAE's ddconfig with a single z."""
    backbone: VAEConfig = VAEConfig(double_z=False, scale_factor=1.0)
    n_embed: int = 16384
    embed_dim: int = 4
    beta: float = 0.25


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls in full precision (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# vector quantizer
# ---------------------------------------------------------------------------

def quantizer_init(init: Init, cfg: VQConfig):
    """The codebook, U(-1/n, 1/n)."""
    return {"embedding": init.uniform((cfg.n_embed, cfg.embed_dim),
                                      1.0 / cfg.n_embed)}


def quantize(qp, cfg: VQConfig, z):
    """z [B, H, W, embed_dim] -> (z_q in z's dtype, loss (f32 scalar),
    indices [B, H, W]). The loss is the codebook term plus ``beta`` times
    the commitment term; z_q = z + (z_q - z).detach() passes the
    gradient straight through to z."""
    emb = qp["embedding"].float()
    zf = z.float()
    flat = zf.reshape(-1, zf.shape[-1])                     # [N, D]
    with _full_f32_matmul():
        cross = flat @ emb.t()                              # [N, n_embed]
    d = ((flat * flat).sum(-1, keepdim=True) - 2.0 * cross
         + (emb * emb).sum(-1)[None, :])
    idx = torch.argmin(d, dim=-1)                           # [N]
    z_q = emb[idx].reshape(zf.shape)
    loss = (cfg.beta * torch.mean((z_q.detach() - zf) ** 2)
            + torch.mean((z_q - zf.detach()) ** 2))
    z_q = zf + (z_q - zf).detach()                          # straight-through
    return z_q.to(z.dtype), loss, idx.reshape(z.shape[:-1])


def embed_code(qp, code, dtype=torch.float32):
    """Codes [B, H, W] -> codebook vectors [B, H, W, embed_dim]."""
    return qp["embedding"][code.long()].to(dtype)


# ---------------------------------------------------------------------------
# VQModel facade
# ---------------------------------------------------------------------------

def vq_init(init: Init, cfg: VQConfig = VQConfig()):
    bb = cfg.backbone
    return {
        "encoder": encoder_init(init, bb),
        "decoder": decoder_init(init, bb),
        "quant_conv": conv2d_init(init, bb.z_channels, cfg.embed_dim, 1),
        "post_quant_conv": conv2d_init(init, cfg.embed_dim, bb.z_channels,
                                       1),
        "quantize": quantizer_init(init, cfg),
    }


def vq_encode_prequant(params, cfg: VQConfig, x):
    """Image -> the continuous latent ``h`` before quantization (the
    VQModelInterface encode)."""
    h = encoder_apply(params["encoder"], cfg.backbone, x)
    return conv2d(params["quant_conv"], h)


def vq_encode(params, cfg: VQConfig, x):
    """Image -> (quantized latent, loss, indices)."""
    return quantize(params["quantize"], cfg,
                    vq_encode_prequant(params, cfg, x))


def vq_decode(params, cfg: VQConfig, h, *, quantize_first: bool = True):
    """Latent -> image; ``quantize_first=False`` decodes ``h`` as it is
    (the VQModelInterface decode with force_not_quantize)."""
    if quantize_first:
        h, _, _ = quantize(params["quantize"], cfg, h)
    z = conv2d(params["post_quant_conv"], h)
    return decoder_apply(params["decoder"], cfg.backbone, z)


def vq_decode_code(params, cfg: VQConfig, code, dtype=torch.float32):
    """Index map [B, H, W] -> image."""
    quant = embed_code(params["quantize"], code, dtype)
    return vq_decode(params, cfg, quant, quantize_first=False)
