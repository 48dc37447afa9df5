"""CLIP text encoder + chunked long-prompt encoding.

Counterpart of ``sd_animation_optical_flow_tpu/models/clip.py``: the CLIP
text tower (causal mask, quick-GELU, ``clip_skip``) and the 3x77-token
chunked forward that turns a long prompt into a [B, 231, width] context.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .layers import Init, layer_norm, linear, linear_init, norm_init

BOS_TOKEN = 49406
EOS_TOKEN = 49407
PAD_TOKEN = 49407   # CLIP's pad == eos for the SD-1.5 tokenizer
CHUNK_LEN = 77
NUM_CHUNKS = 3
CONTEXT_LEN = NUM_CHUNKS * CHUNK_LEN   # 231


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_position: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_text_init(init: Init, cfg: CLIPTextConfig = CLIPTextConfig()):
    p = {
        "token_embedding": init.normal((cfg.vocab_size, cfg.width), 0.02),
        "position_embedding": init.normal((cfg.max_position, cfg.width),
                                          0.01),
        "final_ln": norm_init(init, cfg.width),
        "layers": [],
    }
    for _ in range(cfg.layers):
        p["layers"].append({
            "ln1": norm_init(init, cfg.width),
            "q": linear_init(init, cfg.width, cfg.width),
            "k": linear_init(init, cfg.width, cfg.width),
            "v": linear_init(init, cfg.width, cfg.width),
            "attn_out": linear_init(init, cfg.width, cfg.width),
            "ln2": norm_init(init, cfg.width),
            "mlp_in": linear_init(init, cfg.width, cfg.width * 4),
            "mlp_out": linear_init(init, cfg.width * 4, cfg.width),
        })
    return p


def _causal_attn(lp, x, heads):
    b, n, c = x.shape
    d = c // heads
    q = linear(lp["q"], x).reshape(b, n, heads, d)
    k = linear(lp["k"], x).reshape(b, n, heads, d)
    v = linear(lp["v"], x).reshape(b, n, heads, d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * float(np.float32(1.0) / np.sqrt(np.float32(d)))
    mask = torch.triu(torch.full((n, n), -1e9, dtype=torch.float32,
                                 device=x.device), diagonal=1)
    w = torch.softmax(scores + mask, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, c)
    return linear(lp["attn_out"], out)


def clip_text_apply(params, cfg: CLIPTextConfig, token_ids,
                    *, clip_skip: int = 0, dtype=torch.float32):
    """token_ids [B, 77] int -> hidden states [B, 77, width]."""
    table = params["token_embedding"]
    # out-of-range ids clamp to the table's ends, as a JAX gather does
    # (the special tokens exceed a small test vocabulary)
    x = table[token_ids.clamp(0, table.shape[0] - 1)].to(dtype)
    x = x + params["position_embedding"][None, : x.shape[1]].to(dtype)
    hiddens = [x]
    for lp in params["layers"]:
        x = x + _causal_attn(lp, layer_norm(lp["ln1"], x), cfg.heads)
        x = x + linear(lp["mlp_out"],
                       _quick_gelu(linear(lp["mlp_in"],
                                          layer_norm(lp["ln2"], x))))
        hiddens.append(x)
    if clip_skip > 1:
        x = hiddens[-clip_skip]
    return layer_norm(params["final_ln"], x)


# ---------------------------------------------------------------------------
# chunked long-prompt encoding
# ---------------------------------------------------------------------------

def chunk_token_ids(raw_ids):
    """raw_ids: list[int] without special tokens -> [3, 77] int32 array:
    3 chunks of up to 75 tokens, each wrapped [BOS] + chunk + [EOS] and
    padded with PAD to 77 (overflow truncated)."""
    chunks = []
    for i in range(NUM_CHUNKS):
        part = list(raw_ids[75 * i: 75 * (i + 1)])
        part = [BOS_TOKEN] + part + [EOS_TOKEN]
        part = part[:CHUNK_LEN] + [PAD_TOKEN] * (CHUNK_LEN - len(part))
        chunks.append(part)
    return np.asarray(chunks, dtype=np.int32)


def encode_chunked(params, cfg: CLIPTextConfig, chunked_ids,
                   *, clip_skip: int = 0, dtype=torch.float32):
    """chunked_ids [B, 3, 77] -> context [B, 231, width]."""
    b = chunked_ids.shape[0]
    flat = chunked_ids.reshape(b * NUM_CHUNKS, CHUNK_LEN).long()
    y = clip_text_apply(params, cfg, flat, clip_skip=clip_skip, dtype=dtype)
    return y.reshape(b, NUM_CHUNKS * CHUNK_LEN, -1)
