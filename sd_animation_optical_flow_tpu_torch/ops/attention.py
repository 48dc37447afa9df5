"""Attention for the port: the plain version, two CUDA kernels, and the
router that picks between them.

Counterpart of ``sd_animation_optical_flow_tpu/ops/attention.py``. Shapes
keep the JAX package's layout: q [B, Nq, H, D], k/v [B, Nk, H, D] ->
out [B, Nq, H, D].

Kernels (``csrc/attention.cu``), each with its plain version beside it:

* :func:`flash_attention_tpv` replaces the TPU's ``_flash_kernel_tpv``
  (launched there by ``flash_attention_tpv`` / ``shortk_attention`` /
  ``flash_attention_diff``): UNet self-attention at >= 1536 tokens and the
  short-K prompt cross-attention.
* :func:`flash_attention` replaces the TPU's ``_flash_kernel`` (launched
  by ``flash_attention``): wide heads, the VAE mid-block attention
  (d = 512).

Both kernels compute the function of :func:`xla_attention` (softmax in
f32) with a tracked running max, so unlike the TPU's max-free form they
need no bound on the logits. On a CPU tensor each wrapper returns its
plain version, :func:`xla_attention`; on a CUDA tensor it launches its
kernel (bf16 only) or raises. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

_LOG2E = math.log2(math.e)


def xla_attention(q, k, v, *, bias=None):
    """Plain attention: f32 scores and softmax, weights rounded to q's
    dtype for the PV product (f32 accumulation); out dtype follows q.
    Named after the JAX function it mirrors (``xla_attention``)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _launch(q, k, v, *, wide: bool):
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA kernel takes bf16 q, k, v on one card, "
                            f"got {t.dtype} on {t.device}")
    if d % 8 or d > 512:
        raise ValueError(f"the CUDA kernel takes d a multiple of 8 up to "
                         f"512, got {d}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    _cuda.call("sdaof_attention", q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), b, h, nq, nk, d,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               (1.0 / math.sqrt(d)) * _LOG2E, int(wide))
    return out


def _aligned(t):
    # the kernels load 16-byte row chunks: a view whose base or strides
    # break that alignment gets a contiguous copy (the fused-QKV column
    # slices of the UNet keep it and go in without one)
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % 8 == 0 for s in t.stride()[:3]):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_tpv(q, k, v):
    """Online-softmax attention (kernel #1, ``attn_mma_kernel``: a warp
    per 16 query rows, both products on the tensor cores, K/V tiles
    through shared memory, the ragged last K tile masked). bf16 with d
    a multiple of 8 (d <= 128; wider heads take kernel #2's design). Any
    strides along B/N/H that keep 16-byte rows, so the q/k/v column
    slices of a fused QKV projection go in without a copy."""
    if q.device.type != "cuda":
        return xla_attention(q, k, v)
    out = _launch(q, k, v, wide=False)
    flash_attention_tpv.launches += 1
    return out


flash_attention_tpv.launches = 0


def flash_attention(q, k, v):
    """Online-softmax attention for wide heads (kernel #2,
    ``attn_mma_wide_kernel``: 8 warps share 32 query rows, the softmax
    statistics go through shared memory, each warp owns 1/8 of the
    output columns; bf16, d a multiple of 8 up to 512)."""
    if q.device.type != "cuda":
        return xla_attention(q, k, v)
    out = _launch(q, k, v, wide=True)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention(q, k, v, *, bias=None):
    """Route by shape, with the JAX router's gates (ops/attention.py
    ``attention``) minus its TPU test and environment knobs:

    * no bias, Nq >= 1536, Nk <= 512, d <= 128: short-K cross-attention
      -> :func:`flash_attention_tpv`;
    * no bias, Nq and Nk >= 1536: d <= 128 -> :func:`flash_attention_tpv`,
      d > 128 -> :func:`flash_attention`;
    * anything else -> :func:`xla_attention` (plain torch ops on either
      device, as JAX leaves those shapes to XLA).
    """
    nq, nk, d = q.shape[1], k.shape[1], q.shape[-1]
    if bias is None and nq >= 1536 and nk <= 512 and d <= 128:
        return flash_attention_tpv(q, k, v)
    if bias is None and nq >= 1536 and nk >= 1536:
        if d > 128:
            return flash_attention(q, k, v)
        return flash_attention_tpv(q, k, v)
    return xla_attention(q, k, v, bias=bias)
