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
* :func:`flash_attention_keymask` replaces the TPU's
  ``_flash_keymask_kernel_tpv`` (launched by ``flash_attention_keymask``
  via ``attention_injected``): the CFG K/V-injection attention, plain
  version :func:`attention_injected_plain`.
* :func:`flash_attention_mfr` replaces the TPU's ``_flash_mfr_kernel``
  (launched by ``flash_attention_mfr`` via ``strip_attention``): strip
  self-attention with the MFR band bias, plain version
  :func:`strip_attention_plain`.

Every kernel computes the function of its plain version (softmax in f32)
with a tracked running max, so unlike the TPU's max-free forms they need
no bound on the logits. On a CPU tensor each wrapper returns its plain
version; on a CUDA tensor it launches its kernel (bf16 only) or raises.
``<wrapper>.launches`` counts kernel launches.
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


def _launch(entry: str, q, k, v, *extra, max_d: int = 512):
    """Check q/k/v and launch the C entry point ``entry`` with the shared
    attention arguments, then ``extra``."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != k.shape:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA kernel takes bf16 q, k, v on one card, "
                            f"got {t.dtype} on {t.device}")
    if d % 8 or d > max_d:
        raise ValueError(f"the CUDA kernel takes d a multiple of 8 up to "
                         f"{max_d}, got {d}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    _cuda.call(entry, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), b, h, nq, nk, d,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               (1.0 / math.sqrt(d)) * _LOG2E, *extra)
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
    out = _launch("sdaof_attention", q, k, v, 0)
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
    out = _launch("sdaof_attention", q, k, v, 1)
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


# ---------------------------------------------------------------------------
# CFG K/V injection (kernel #6)
# ---------------------------------------------------------------------------

def attention_injected_plain(q, k, v, *, n_own: int, n_uncond: int):
    """Plain version of the K/V-injection attention: :func:`xla_attention`
    with a -1e9 bias on the keys >= ``n_own`` of the first ``n_uncond``
    batch rows (the JAX ``attention_injected`` off the flash path)."""
    b, nk = q.shape[0], k.shape[1]
    row = torch.where(torch.arange(nk, device=q.device) < n_own, 0.0, -1e9)
    bias = torch.zeros((b, nk), device=q.device)
    bias[:n_uncond] = row
    return xla_attention(q, k, v, bias=bias[:, None, None, :])


def flash_attention_keymask(q, k, v, *, n_own: int, n_uncond: int):
    """Attention of the CFG K/V-injection path (kernel #6,
    ``attn_mma_kernel<DP, MODE_KEYMASK>``): batch rows ``< n_uncond`` see
    keys ``< n_own`` only, the other rows see all keys. The uncond rows'
    key loop stops at ``n_own``. bf16 on the card, d a multiple of 8 up
    to 160 (SD-1.5's widest head); q [B, Nq, H, D], k/v [B, Nk, H, D]."""
    b = q.shape[0]
    if not 1 <= n_own or not 0 <= n_uncond <= b:
        raise ValueError(f"keymask needs n_own >= 1 and 0 <= n_uncond <= B, "
                         f"got n_own={n_own}, n_uncond={n_uncond}, B={b}")
    if q.device.type != "cuda":
        return attention_injected_plain(q, k, v, n_own=n_own,
                                        n_uncond=n_uncond)
    out = _launch("sdaof_attention_keymask", q, k, v, int(n_own),
                  int(n_uncond), max_d=160)
    flash_attention_keymask.launches += 1
    return out


flash_attention_keymask.launches = 0


def attention_injected(q, k, v, *, n_own: int, n_uncond: int):
    """Route the K/V-injection attention with the JAX gate minus its TPU
    test: Nq >= 1536 -> :func:`flash_attention_keymask`; smaller shapes
    -> the plain version, as JAX leaves them to XLA."""
    if q.shape[1] >= 1536:
        return flash_attention_keymask(q, k, v, n_own=n_own,
                                       n_uncond=n_uncond)
    return attention_injected_plain(q, k, v, n_own=n_own, n_uncond=n_uncond)


# ---------------------------------------------------------------------------
# MFR strip attention (kernel #10)
# ---------------------------------------------------------------------------

# the reference keys sigma by the latent tile height; its table
# {96: 1, 48: 0.8, 24: 0.6, 12: 0.4} is 0.4 + 0.2 * log2(h / 12)
MFR_RADIUS = 6
MFR_WEIGHT = 4.0


def mfr_sigma(h: int) -> float:
    return 0.4 + 0.2 * math.log2(max(h, 1) / 12.0)


def _strip_positions(h: int, w_tile: int, n_tiles: int, n_pad: int,
                     device=None):
    """Token coordinates of a width-concatenated strip flattened
    row-major: int32 [1, 3, n_pad] rows (y, x_local, tile)."""
    i = torch.arange(n_pad, dtype=torch.int32, device=device)
    ws = n_tiles * w_tile
    rem = i % ws
    return torch.stack([(i // ws) % h, rem % w_tile, rem // w_tile])[None]


def mfr_strip_bias(h: int, w_tile: int, n_tiles: int, *,
                   radius: int = MFR_RADIUS, weight: float = MFR_WEIGHT,
                   sigma: float | None = None, mode: str = "target",
                   dtype=torch.float32, device=None):
    """Materialized [N, N] MFR band bias, N = h * n_tiles * w_tile:
    ``weight * exp(-dist / sigma)`` between tokens of distinct tiles
    (``mutual``) or from tile-0 queries to the other tiles (``target``)
    within a Chebyshev ``radius``, 0 elsewhere."""
    if sigma is None:
        sigma = mfr_sigma(h)
    n = h * n_tiles * w_tile
    y, x, tile = _strip_positions(h, w_tile, n_tiles, n, device)[0]
    dy = y[:, None] - y[None, :]
    dx = x[:, None] - x[None, :]
    in_band = (dy.abs() <= radius) & (dx.abs() <= radius)
    if mode == "target":
        apply = (tile[:, None] == 0) & (tile[None, :] != 0)
    elif mode == "mutual":
        apply = tile[:, None] != tile[None, :]
    else:
        raise ValueError(mode)
    dist = torch.sqrt((dy * dy + dx * dx).float())
    bias = torch.where(apply & in_band, weight * torch.exp(-dist / sigma),
                       0.0)
    return bias.to(dtype)


def strip_attention_plain(q, k, v, *, h: int, w_strip: int, n_tiles: int,
                          mode: str = "target"):
    """Plain version of the strip attention: :func:`xla_attention` with the
    materialized :func:`mfr_strip_bias`."""
    bias = mfr_strip_bias(h, w_strip // n_tiles, n_tiles, mode=mode,
                          device=q.device)
    return xla_attention(q, k, v, bias=bias[None, None])


def flash_attention_mfr(q, k, v, *, h: int, w_tile: int, n_tiles: int,
                        radius: int = MFR_RADIUS, weight: float = MFR_WEIGHT,
                        sigma: float | None = None, mode: str = "target"):
    """Strip self-attention with the MFR band bias computed in the kernel
    (kernel #10, ``attn_mma_kernel<DP, MODE_MFR>``) from the token
    indices; q/k/v [B, N, H, D] with N = h * n_tiles * w_tile. bf16 on
    the card, d a multiple of 8 up to 160."""
    if sigma is None:
        sigma = mfr_sigma(h)
    if mode not in ("target", "mutual"):
        raise ValueError(mode)
    n = h * n_tiles * w_tile
    if q.shape[1] != n or k.shape[1] != n:
        raise ValueError(f"MFR strip attention is full-strip self-attention "
                         f"over {n} tokens, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.device.type != "cuda":
        bias = mfr_strip_bias(h, w_tile, n_tiles, radius=radius,
                              weight=weight, sigma=sigma, mode=mode,
                              device=q.device)
        return xla_attention(q, k, v, bias=bias[None, None])
    out = _launch("sdaof_attention_mfr", q, k, v, n_tiles * w_tile, w_tile,
                  int(radius), int(mode == "target"), float(weight) * _LOG2E,
                  1.0 / float(sigma), max_d=160)
    flash_attention_mfr.launches += 1
    return out


flash_attention_mfr.launches = 0


def strip_attention(q, k, v, *, h: int, w_strip: int, n_tiles: int,
                    mode: str = "target"):
    """Self-attention over a width-concatenated strip of ``n_tiles`` frames
    with the MFR band bias. Routed with the JAX gate minus its TPU test:
    Nq >= 1536 -> :func:`flash_attention_mfr`, smaller shapes -> the
    plain version."""
    if w_strip % n_tiles:
        raise ValueError(f"strip width {w_strip} does not split into "
                         f"{n_tiles} tiles")
    if q.shape[1] >= 1536:
        return flash_attention_mfr(q, k, v, h=h, w_tile=w_strip // n_tiles,
                                   n_tiles=n_tiles, mode=mode)
    return strip_attention_plain(q, k, v, h=h, w_strip=w_strip,
                                 n_tiles=n_tiles, mode=mode)
