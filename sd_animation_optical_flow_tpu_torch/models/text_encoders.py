"""Alternative conditioning text encoders: OpenCLIP and T5.

Counterpart of ``sd_animation_optical_flow_tpu/models/text_encoders.py``
(``OpenCLIPTextConfig``, ``openclip_text_init``, ``openclip_text_apply``,
``T5Config``, ``t5_relative_buckets``, ``t5_encoder_init``,
``t5_encoder_apply``, ``clip_t5_encode``): the OpenCLIP ViT-H/14 text
tower (causal mask, erf GELU, the penultimate layer) and the T5 v1.1
encoder (unscaled queries, bias-free linears, f32 RMSNorm, the tanh
GELU's gated FF, one relative-position bias table shared by every
layer). Attention is plain torch with f32 scores, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .clip import _causal_attn
from .layers import (Init, gelu, gelu_tanh, layer_norm, linear, linear_init,
                     norm_init)


def _embed(table, token_ids, dtype):
    # out-of-range ids clamp to the table's ends, as a JAX gather does
    return table[token_ids.long().clamp(0, table.shape[0] - 1)].to(dtype)


# ---------------------------------------------------------------------------
# OpenCLIP text tower
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OpenCLIPTextConfig:
    """Defaults: the ViT-H/14 text tower, read at its penultimate layer."""
    vocab_size: int = 49408
    max_position: int = 77
    width: int = 1024
    layers: int = 24
    heads: int = 16
    penultimate: bool = True


def openclip_text_init(init: Init,
                       cfg: OpenCLIPTextConfig = OpenCLIPTextConfig()):
    w = cfg.width
    return {
        "token_embedding": init.normal((cfg.vocab_size, w), 0.02),
        "position_embedding": init.normal((cfg.max_position, w), 0.01),
        "ln_final": norm_init(init, w),
        "layers": [{
            "ln1": norm_init(init, w),
            "q": linear_init(init, w, w),
            "k": linear_init(init, w, w),
            "v": linear_init(init, w, w),
            "attn_out": linear_init(init, w, w),
            "ln2": norm_init(init, w),
            "mlp_in": linear_init(init, w, w * 4),
            "mlp_out": linear_init(init, w * 4, w),
        } for _ in range(cfg.layers)],
    }


def openclip_text_apply(params, cfg: OpenCLIPTextConfig, token_ids, *,
                        dtype=torch.float32):
    """token_ids [B, 77] -> hidden states [B, 77, width]. ``penultimate``
    stops one block early."""
    x = _embed(params["token_embedding"], token_ids, dtype)
    x = x + params["position_embedding"][None, : x.shape[1]].to(dtype)
    n_run = cfg.layers - (1 if cfg.penultimate else 0)
    for lp in params["layers"][:n_run]:
        x = x + _causal_attn(lp, layer_norm(lp["ln1"], x), cfg.heads)
        x = x + linear(lp["mlp_out"],
                       gelu(linear(lp["mlp_in"], layer_norm(lp["ln2"], x))))
    return layer_norm(params["ln_final"], x)


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class T5Config:
    """Defaults: google/t5-v1_1-large."""
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    heads: int = 16
    layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6


def _rms_norm(scale, x, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def t5_relative_buckets(n: int, num_buckets: int, max_distance: int):
    """Bidirectional T5 relative-position buckets [n, n] (int32), computed
    on the host in float64 numpy as the JAX package does: the float32
    formula of other T5 code can put a distance in another bucket."""
    pos = np.arange(n)
    rel = pos[None, :] - pos[:, None]                 # key - query
    nb = num_buckets // 2
    out = np.where(rel > 0, nb, 0)
    arel = np.abs(rel)
    max_exact = nb // 2
    is_small = arel < max_exact
    log_big = max_exact + (
        np.log(np.maximum(arel, 1) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    log_big = np.minimum(log_big, nb - 1)
    out = out + np.where(is_small, arel, log_big)
    return torch.from_numpy(out.astype(np.int32))


def t5_encoder_init(init: Init, cfg: T5Config = T5Config()):
    inner = cfg.heads * cfg.d_kv
    nb = lambda i, o: linear_init(init, i, o, bias=False)
    return {
        "token_embedding": init.normal((cfg.vocab_size, cfg.d_model)),
        "rel_bias": init.normal((cfg.rel_buckets, cfg.heads), 0.02),
        "final_norm": init.ones((cfg.d_model,)),
        "layers": [{
            "norm1": init.ones((cfg.d_model,)),
            "q": nb(cfg.d_model, inner),
            "k": nb(cfg.d_model, inner),
            "v": nb(cfg.d_model, inner),
            "o": nb(inner, cfg.d_model),
            "norm2": init.ones((cfg.d_model,)),
            "wi0": nb(cfg.d_model, cfg.d_ff),     # gate (GELU)
            "wi1": nb(cfg.d_model, cfg.d_ff),     # linear
            "wo": nb(cfg.d_ff, cfg.d_model),
        } for _ in range(cfg.layers)],
    }


def t5_encoder_apply(params, cfg: T5Config, token_ids, mask=None, *,
                     dtype=torch.float32):
    """token_ids [B, N] (and an optional [B, N] 1/0 key mask) -> [B, N,
    d_model]. Queries are not scaled by 1/sqrt(d) (the checkpoints fold
    it into the weights)."""
    b, n = token_ids.shape
    x = _embed(params["token_embedding"], token_ids, dtype)
    buckets = t5_relative_buckets(n, cfg.rel_buckets,
                                  cfg.rel_max_distance).to(x.device).long()
    pos_bias = params["rel_bias"].float()[buckets]     # [n, n, H]
    pos_bias = pos_bias.permute(2, 0, 1)[None]         # [1, H, n, n]
    if mask is not None:
        pos_bias = pos_bias + torch.where(
            torch.as_tensor(mask, device=x.device)[:, None, None, :] > 0,
            0.0, -1e9).float()

    for lp in params["layers"]:
        h = _rms_norm(lp["norm1"], x, cfg.eps)
        q = linear(lp["q"], h).reshape(b, n, cfg.heads, cfg.d_kv)
        k = linear(lp["k"], h).reshape(b, n, cfg.heads, cfg.d_kv)
        v = linear(lp["v"], h).reshape(b, n, cfg.heads, cfg.d_kv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        w = torch.softmax(scores + pos_bias, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, -1)
        x = x + linear(lp["o"], attn)
        h = _rms_norm(lp["norm2"], x, cfg.eps)
        gate = gelu_tanh(linear(lp["wi0"], h))
        x = x + linear(lp["wo"], gate * linear(lp["wi1"], h))
    return _rms_norm(params["final_norm"], x, cfg.eps)


# ---------------------------------------------------------------------------
# CLIP + T5
# ---------------------------------------------------------------------------

def clip_t5_encode(clip_fn, t5_fn):
    """An encoder that returns [clip_fn(...), t5_fn(...)], the two
    contexts as a list (the caller decides how to consume them)."""
    def encode(*args, **kwargs):
        return [clip_fn(*args, **kwargs), t5_fn(*args, **kwargs)]
    return encode
