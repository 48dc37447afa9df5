"""Attention for the port: the plain versions, the CUDA kernels, the
differentiable forms of training, and the router that picks between them.

Counterpart of ``sd_animation_optical_flow_tpu/ops/attention.py``. Shapes
keep the JAX package's layout: q [B, Nq, H, D], k/v [B, Nk, H, D] ->
out [B, Nq, H, D].

Kernels (``csrc/attention_sm90.cu``, ``csrc/attention_wide_sm90.cu``,
``csrc/attention_bwd_sm90.cu``; ``csrc/attention.cu`` holds their C entry
points), each with its plain version beside it:

* :func:`flash_attention_tpv` replaces the TPU's ``_flash_kernel_tpv``
  (launched there by ``flash_attention_tpv`` / ``shortk_attention`` /
  ``flash_attention_diff``): UNet self-attention at >= 1536 tokens and the
  short-K prompt cross-attention. Its kernel, ``attention_sm90_kernel``,
  is designed for Hopper: ``wgmma`` products in three consumer
  warpgroups (192 query rows a work unit, so the UNet's 1536-token level
  fills one wave of the card), a producer warpgroup that streams K/V
  through a ``cp.async`` ring of shared-memory stages and hands its
  registers to the consumers (``setmaxnreg``), and each key tile's
  softmax overlapped with the previous tile's PV product.
  At d = 40 one exp2 per score on the special-function units (0.155 ms at
  self L0) bounds it more than the tensor cores do (0.098 ms), which is
  why the overlap matters.
* :func:`flash_attention` replaces the TPU's ``_flash_kernel`` (launched
  by ``flash_attention``): wide heads, the VAE mid-block attention
  (d = 512) and the UNet's 160-wide heads at >= 1536 tokens. Its kernel,
  ``attention_wide_sm90_kernel``, is designed for Hopper: 64 query rows a
  block, two ``wgmma`` consumer warpgroups that each own half of d (the
  output of 64 rows at d = 512 does not fit one warpgroup's registers)
  and sum their partial scores through shared memory, and a producer
  warpgroup streaming K/V with TMA through a ring of d-half slots, each
  tile loaded once for a cluster of 2 or 4 blocks (multicast): every
  block reads all of K/V, and that traffic, not the softmax, is its wall.
* :func:`flash_attention_keymask` replaces the TPU's
  ``_flash_keymask_kernel_tpv`` (launched by ``flash_attention_keymask``
  via ``attention_injected``): the CFG K/V-injection attention, plain
  version :func:`attention_injected_plain`. Its kernel is
  ``attention_sm90_kernel`` whose uncond rows' units walk only their
  own keys.
* :func:`flash_attention_mfr` replaces the TPU's ``_flash_mfr_kernel``
  (launched by ``flash_attention_mfr`` via ``strip_attention``): strip
  self-attention with the MFR band bias, plain version
  :func:`strip_attention_plain`. Its kernel is ``attention_sm90_kernel``
  with the bias as an epilogue on the score tile: only key tiles whose
  strip rows lie within the radius of a warpgroup's query rows take it,
  from a table in shared memory.
  Both run every head width up to 160, as #5 below does: three consumer
  warpgroups of 64 query rows, on 32-key tiles at SD-1.5's 160-wide
  third UNet level. Each of the three, and :func:`flash_attention`,
  counts its launches by padded head width too
  (``<wrapper>.launches_by_dp``).
* :func:`flash_attention_banded` replaces the TPU's
  ``_flash_banded_kernel`` (launched by ``flash_attention_banded``):
  one frame's queries against ``n`` frames' keys with the banded
  cross-frame bias computed in the kernel; plain version
  :func:`flash_attention_banded_plain` (:func:`xla_attention` with the
  materialized :func:`banded_strip_bias`). Its kernel is
  ``attention_sm90_kernel`` with the bias added to the score tile before
  the softmax: a key tile out of the band of a warpgroup's query rows
  takes ``base`` on every score, the others each pair's bias, from a
  table in shared memory. Unlike the TPU kernel it takes no ``qpos`` /
  ``kpos`` coordinate inputs (the kernel steps each token's frame
  coordinates along the keys in registers), and its running max starts
  at a finite floor, as the TPU kernel's does, so a ``base`` of -inf
  gives no NaN.
* :func:`flash_fwd_stats` (``_flash_kernel_tpv_stats``, the same
  ``attention_sm90_kernel`` writing the LSE too),
  :func:`flash_bwd_dkv` (``_flash_bwd_dkv_kernel``) and
  :func:`flash_bwd_dq` (``_flash_bwd_dq_kernel``) are the forward with
  statistics and the two backward kernels of :func:`flash_attention_diff`,
  the differentiable self-attention of training; plain versions
  :func:`flash_fwd_stats_plain` and :func:`flash_bwd_plain`. The two
  backward kernels (``csrc/attention_bwd_sm90.cu``) are one Hopper design
  with two epilogues: persistent blocks whose consumer warpgroups each own
  64 rows of one axis (keys for dK / dV, queries for dQ) while a producer
  warpgroup streams the other axis through a ``cp.async`` ring; per tile
  two ``wgmma`` score products (S and dP), P and dS in registers, and the
  gradient products with the packed scores as register operands,
  overlapped with the next tile's scores. No atomics: each gradient is
  bitwise deterministic.

Every kernel computes the function of its plain version (softmax in f32)
with a tracked running max, so unlike the TPU's max-free forms they need
no bound on the logits. On a CPU tensor each wrapper returns its plain
version; on a CUDA tensor it launches its kernel (bf16 only) or raises.
``<wrapper>.launches`` counts kernel launches, and ``<wrapper>.kernel``
names the source and design of the kernel its last launch ran (a
:class:`_cuda.Kernel`; None before one). A wrapper whose kernel
has no backward raises on a CUDA tensor where a gradient would be
recorded through it; the router sends such inputs to
:func:`flash_attention_diff` or :func:`shortk_attention`.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

_LOG2E = math.log2(math.e)

# the kernels the wrappers launch, by route (``<wrapper>.kernel``)
_K_PLAIN = _cuda.kernel(
    "attention_sm90.cu", "attention_sm90_kernel<DP, PLAIN>: three wgmma "
    "consumer warpgroups of 64 query rows, a cp.async K/V ring")
_K_STATS = _cuda.kernel(
    "attention_sm90.cu", "attention_sm90_kernel<DP, PLAIN> (#1's design), "
    "storing each row's log-sum-exp")
_K_KEYMASK = _cuda.kernel(
    "attention_sm90.cu", "attention_sm90_kernel<DP, KEYMASK> (#1's "
    "design, 32-key tiles at d 160): an uncond row's units walk "
    "min(Nk, n_own) keys")
_K_MFR = _cuda.kernel(
    "attention_sm90.cu", "attention_sm90_kernel<DP, MFR> (#1's design, "
    "32-key tiles at d 160): the band bias added to the score tiles in "
    "band")
_K_WIDE = _cuda.kernel(
    "attention_wide_sm90.cu", "attention_wide_sm90_kernel: two wgmma "
    "warpgroups on the d-halves, a TMA K/V ring multicast to a cluster")
_K_BANDED = _cuda.kernel(
    "attention_sm90.cu", "attention_sm90_kernel<DP, BANDED> (#1's design, "
    "32-key tiles at d 160): base added to the key tiles out of band, the "
    "band bias per pair from a table on the others")
_K_BWD_DKV = _cuda.kernel(
    "attention_bwd_sm90.cu", "attention_bwd_dkv_sm90_kernel: wgmma "
    "warpgroups own 64 key rows each, q and dO through a cp.async ring")
_K_BWD_DQ = _cuda.kernel(
    "attention_bwd_sm90.cu", "attention_bwd_dq_sm90_kernel: wgmma "
    "warpgroups own 64 query rows each, k and v through a cp.async ring")


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


def _checked(q, k, v, max_d: int, *more):
    """Check q/k/v (and ``more``, shaped as q) for the CUDA kernels and
    return them with 16-byte rows (see :func:`_aligned`)."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, h, d) or v.shape != k.shape \
            or any(t.shape != q.shape for t in more):
        raise ValueError(f"attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for t in (q, k, v, *more):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA kernel takes bf16 q, k, v on one card, "
                            f"got {t.dtype} on {t.device}")
    if d % 8 or d > max_d:
        raise ValueError(f"the CUDA kernel takes d a multiple of 8 up to "
                         f"{max_d}, got {d}")
    return tuple(_aligned(t) for t in (q, k, v, *more))


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _launch(entry: str, q, k, v, *extra, max_d: int = 512):
    """Check q/k/v and launch the C entry point ``entry`` with the shared
    attention arguments, then ``extra``."""
    q, k, v = _checked(q, k, v, max_d)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    _cuda.call(entry, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), b, h, nq, k.shape[1], d,
               *_strides(q, k, v), _scale_log2(d), *extra)
    return out


def _scale_log2(d: int) -> float:
    return (1.0 / math.sqrt(d)) * _LOG2E


def _aligned(t):
    # the kernels load 16-byte row chunks: a view whose base or strides
    # break that alignment gets a contiguous copy (the fused-QKV column
    # slices of the UNet keep it and go in without one)
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % 8 == 0 for s in t.stride()[:3]):
        return t
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count_launch(wrapper, d: int) -> None:
    """One launch of ``wrapper``'s kernel at head dim ``d``: its count,
    and its count at d padded to a multiple of 16 (the kernel's DP)."""
    wrapper.launches += 1
    dp = -(-d // 16) * 16
    wrapper.launches_by_dp[dp] = wrapper.launches_by_dp.get(dp, 0) + 1


def flash_attention_tpv(q, k, v):
    """Online-softmax attention (kernel #1, ``attention_sm90_kernel`` in
    ``csrc/attention_sm90.cu``, replacing the TPU's ``_flash_kernel_tpv``:
    192 query rows a work unit in three consumer warpgroups, q k^T and p v with
    ``wgmma``, K/V tiles streamed by a producer warpgroup through a ring
    of shared-memory stages, tile t's softmax overlapped with tile t-1's
    p v, the ragged last K tile masked). Bound at d = 40 by the exp2 per
    score more than by the tensor cores. bf16 with d a multiple of 8
    (d <= 128; wider heads take kernel #2's design). Any strides along
    B/N/H that keep 16-byte rows, so the q/k/v column slices of a fused
    QKV projection go in without a copy; no column past d is read. No
    backward: under a recorded gradient use :func:`flash_attention_diff`
    or :func:`shortk_attention`, whose forwards launch this kernel."""
    if q.device.type != "cuda":
        return xla_attention(q, k, v)
    _cuda.refuse_grad("flash_attention_tpv", q, k, v)
    out = _launch("sdaof_attention", q, k, v)
    flash_attention_tpv.launches += 1
    flash_attention_tpv.kernel = _K_PLAIN if q.shape[-1] <= 128 else _K_WIDE
    return out


flash_attention_tpv.launches = 0
flash_attention_tpv.kernel = None


def flash_attention(q, k, v):
    """Online-softmax attention for wide heads (kernel #2,
    ``attention_wide_sm90_kernel`` in ``csrc/attention_wide_sm90.cu``,
    replacing the TPU's ``_flash_kernel``): one block per 64 query rows
    of a (batch row, head), two consumer warpgroups that each own half of
    d, compute the partial scores over that half with ``wgmma``, sum them
    through shared memory and run the same tracked-max softmax, then
    ``p v`` for their half of the output columns; a producer warpgroup
    streams K/V in d-half slots through a ring with TMA, each tile
    multicast to the 2 or 4 blocks of a cluster, and tile t's softmax
    overlaps tile t-1's ``p v``. bf16, d a multiple of 8 up to
    512 (d <= 128 runs :func:`flash_attention_tpv`'s kernel, which
    computes the same function); strided q/k/v as for
    :func:`flash_attention_tpv`, no column past d read. No backward, as
    the JAX ``flash_attention`` has no VJP."""
    if q.device.type != "cuda":
        return xla_attention(q, k, v)
    _cuda.refuse_grad("flash_attention", q, k, v)
    out = _launch("sdaof_attention", q, k, v)
    _count_launch(flash_attention, q.shape[-1])
    flash_attention.kernel = _K_PLAIN if q.shape[-1] <= 128 else _K_WIDE
    return out


flash_attention.launches = 0
flash_attention.launches_by_dp = {}
flash_attention.kernel = None


def attention(q, k, v, *, bias=None):
    """Route by shape, with the JAX router's gates (ops/attention.py
    ``attention``) minus its TPU test and environment knobs:

    * no bias, Nq >= 1536, Nk <= 512, d <= 128: short-K cross-attention
      -> :func:`flash_attention_tpv`;
    * no bias, Nq and Nk >= 1536: d <= 128 -> :func:`flash_attention_tpv`,
      d > 128 -> :func:`flash_attention`;
    * anything else -> :func:`xla_attention` (plain torch ops on either
      device, as JAX leaves those shapes to XLA). Every biased call goes
      there, as in JAX: the UNet's materialized ``attn_biases`` route is
      that plain route by design, not a fallback.

    Where a gradient is recorded through q, k or v (grad mode on and one
    of them requires grad) the two kernel routes take their
    differentiable forms, as JAX's ``jax.grad`` goes through the custom
    VJPs: the short-K gate -> :func:`shortk_attention`, the
    self-attention gate -> :func:`flash_attention_diff`. The wide-head
    route has no backward (the JAX ``flash_attention`` has no VJP) and
    raises. The route keys on ``requires_grad``, not on grad mode alone:
    the facades run with grad mode on, on weights that do not require
    grad."""
    nq, nk, d = q.shape[1], k.shape[1], q.shape[-1]
    grad = _cuda.records_grad(q, k, v)
    if bias is None and nq >= 1536 and nk <= 512 and d <= 128:
        return shortk_attention(q, k, v) if grad \
            else flash_attention_tpv(q, k, v)
    if bias is None and nq >= 1536 and nk >= 1536:
        if d > 128:
            if grad:
                raise RuntimeError(
                    f"attention at d = {d} > 128 with Nq, Nk >= 1536 routes "
                    "to flash_attention, which has no backward (neither has "
                    "the JAX flash_attention)")
            return flash_attention(q, k, v)
        return flash_attention_diff(q, k, v) if grad \
            else flash_attention_tpv(q, k, v)
    return xla_attention(q, k, v, bias=bias)


def sliced_attention(q, k, v, *, slice_size: int = 1024, bias=None):
    """Query-chunked :func:`xla_attention`: the score matrix is built
    ``slice_size`` query rows at a time, the bias sliced along its query
    axis (the JAX ``sliced_attention``, the reference's low-VRAM sliced
    attention). Plain torch ops; no kernel."""
    nq = q.shape[1]
    outs = []
    for s in range(0, nq, slice_size):
        e = min(s + slice_size, nq)
        b_slice = None if bias is None else bias[..., s:e, :]
        outs.append(xla_attention(q[:, s:e], k, v, bias=b_slice))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# differentiable attention (kernels #7, #8, #9): the forward with
# statistics and the flash backward of flash_attention_diff
# ---------------------------------------------------------------------------

def _scores_log2(q, k):
    """f32 scores in the log2 domain, [B, H, Nq, Nk]."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * _scale_log2(q.shape[-1])


def flash_fwd_stats_plain(q, k, v):
    """Plain version of :func:`flash_fwd_stats`: f32 softmax, out in q's
    dtype and ``lse`` [B * H, Nq] f32, the base-2 log-sum-exp of the
    scaled scores (``exp2(lse)`` is the JAX kernel's denominator ``l``
    when its max-free exponent is taken at zero)."""
    b, _, h, _ = q.shape
    s = _scores_log2(q, k)
    lse = torch.logsumexp(s * math.log(2.0), dim=-1) * _LOG2E
    p = torch.exp2(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return out, lse.reshape(b * h, -1)


def _recompute(q, k, v, do, lse, dvec):
    """f32 P = exp2(S - lse) and dS = P * (dO V^T - D), [B, H, Nq, Nk],
    from the [B * H, Nq] rows ``lse`` and ``dvec``."""
    b, nq, h, _ = q.shape
    p = torch.exp2(_scores_log2(q, k) - lse.reshape(b, h, nq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - dvec.reshape(b, h, nq, 1))


def _bwd_dkv_plain(q, k, v, do, lse, dvec):
    """Plain version of :func:`flash_bwd_dkv`: dV = P^T dO and
    dK = scale * dS^T Q."""
    p, ds = _recompute(q, k, v, do, lse, dvec)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) \
        / math.sqrt(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype)


def _bwd_dq_plain(q, k, v, do, lse, dvec):
    """Plain version of :func:`flash_bwd_dq`: dQ = scale * dS K."""
    _, ds = _recompute(q, k, v, do, lse, dvec)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) \
        / math.sqrt(q.shape[-1])
    return dq.to(q.dtype)


def flash_dvec(out, do):
    """D = rowsum(dO * O), [B * H, Nq] f32: one torch reduction, as JAX
    computes it in XLA beside its backward kernels."""
    b, nq, h, _ = out.shape
    dvec = (do.float() * out.float()).sum(-1)            # [B, Nq, H]
    return dvec.transpose(1, 2).reshape(b * h, nq).contiguous()


def flash_bwd_plain(q, k, v, out, lse, do):
    """Plain version of the flash backward: (dq, dk, dv) in the inputs'
    dtypes from the forward's ``out`` and ``lse`` and the cotangent
    ``do``; f32 recompute of P, D = rowsum(dO * O), dV = P^T dO,
    dP = dO V^T, dS = P * (dP - D), dK = scale * dS^T Q,
    dQ = scale * dS K."""
    dvec = flash_dvec(out, do)
    dk, dv = _bwd_dkv_plain(q, k, v, do, lse, dvec)
    return _bwd_dq_plain(q, k, v, do, lse, dvec), dk, dv


def flash_fwd_stats(q, k, v):
    """Attention that also returns the statistics its backward needs:
    (out [B, Nq, H, D], lse [B * H, Nq] f32). Kernel #7, replacing the
    TPU's ``_flash_kernel_tpv_stats``: kernel #1's
    ``attention_sm90_kernel`` that also writes each query row's
    ``m + log2(l)`` of the f32-scaled scores beside ``out`` (the backward
    kernels recompute P in f32 from it). Bounds and design as #1's. bf16
    on the card, d a multiple of 8 up to 128; q/k/v strided as for
    :func:`flash_attention_tpv`."""
    if q.device.type != "cuda":
        return flash_fwd_stats_plain(q, k, v)
    _cuda.refuse_grad("flash_fwd_stats", q, k, v)
    q, k, v = _checked(q, k, v, 128)
    b, nq, h, d = q.shape
    out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, nq), dtype=torch.float32, device=q.device)
    _cuda.call("sdaof_attention_fwd_stats", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
               b, h, nq, k.shape[1], d, *_strides(q, k, v), _scale_log2(d))
    flash_fwd_stats.launches += 1
    flash_fwd_stats.kernel = _K_STATS
    return out, lse


flash_fwd_stats.launches = 0
flash_fwd_stats.kernel = None


def _bwd_inputs(name, q, k, v, do, lse, dvec):
    # no double backward: refused under create_graph=True
    _cuda.refuse_grad(name, q, k, v, do)
    q, k, v, do = _checked(q, k, v, 128, do)
    b, nq, h, _ = q.shape
    for t in (lse, dvec):
        if t.shape != (b * h, nq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError("lse / dvec must be contiguous f32 [B * H, Nq] "
                             f"on q's card, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return q, k, v, do


def flash_bwd_dkv(q, k, v, do, lse, dvec):
    """dK and dV of the flash backward (kernel #8,
    ``attention_bwd_dkv_sm90_kernel``): each consumer warpgroup owns 64
    keys of one (b, h) and loops over the query tiles, recomputes S^T and
    P, and accumulates dV += P^T dO and dK += dS^T Q in f32 registers.
    Returns contiguous [B, Nk, H, D] in k's dtype. ``lse`` / ``dvec``:
    [B * H, Nq] f32."""
    if q.device.type != "cuda":
        return _bwd_dkv_plain(q, k, v, do, lse, dvec)
    q, k, v, do = _bwd_inputs("flash_bwd_dkv", q, k, v, do, lse, dvec)
    dk, dv = torch.empty_like(k, memory_format=torch.contiguous_format), \
        torch.empty_like(v, memory_format=torch.contiguous_format)
    b, nq, h, d = q.shape
    _cuda.call("sdaof_attention_bwd_dkv", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq,
               k.shape[1], d, *_strides(q, k, v, do), _scale_log2(d))
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.kernel = _K_BWD_DKV
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.kernel = None


def flash_bwd_dq(q, k, v, do, lse, dvec):
    """dQ of the flash backward (kernel #9,
    ``attention_bwd_dq_sm90_kernel``): each consumer warpgroup owns 64
    queries of one (b, h) and loops over the key tiles (the ragged last
    one masked), recomputes P and dS and accumulates dQ += dS K in f32
    registers. Returns contiguous [B, Nq, H, D] in q's dtype."""
    if q.device.type != "cuda":
        return _bwd_dq_plain(q, k, v, do, lse, dvec)
    q, k, v, do = _bwd_inputs("flash_bwd_dq", q, k, v, do, lse, dvec)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, nq, h, d = q.shape
    _cuda.call("sdaof_attention_bwd_dq", q.device, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               dvec.data_ptr(), dq.data_ptr(), b, h, nq, k.shape[1], d,
               *_strides(q, k, v, do), _scale_log2(d))
    flash_bwd_dq.launches += 1
    flash_bwd_dq.kernel = _K_BWD_DQ
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.kernel = None


class _FlashAttentionDiff(torch.autograd.Function):
    """The custom VJP of the JAX ``flash_attention_diff``: the forward
    saves (q, k, v, out, lse), the backward is D, then #8, then #9."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_fwd_stats(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dvec = flash_dvec(out, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dvec)
        return flash_bwd_dq(q, k, v, do, lse, dvec), dk, dv


def flash_attention_diff(q, k, v):
    """Differentiable flash attention (the JAX ``flash_attention_diff``):
    O(N) memory in both directions. With a gradient recorded through q,
    k or v the forward is kernel #7 and the backward kernels #8 and #9
    (on a CPU tensor: their plain versions); with nothing to record it is
    kernel #1, as the JAX primal is."""
    if not _cuda.records_grad(q, k, v):
        return flash_attention_tpv(q, k, v)
    return _FlashAttentionDiff.apply(q, k, v)


class _ShortKAttention(torch.autograd.Function):
    """The custom VJP of the JAX ``shortk_attention``: forward kernel #1,
    backward recomputed through :func:`xla_attention` (at a prompt-length
    K the score tensor is small)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_attention_tpv(q, k, v)

    @staticmethod
    def backward(ctx, do):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = xla_attention(q, k, v)
        return torch.autograd.grad(out, (q, k, v), do)


def shortk_attention(q, k, v):
    """Short-K attention (the prompt cross-attention) with a backward:
    the forward is kernel #1, the backward differentiates
    :func:`xla_attention`."""
    if not _cuda.records_grad(q, k, v):
        return flash_attention_tpv(q, k, v)
    return _ShortKAttention.apply(q, k, v)


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
    ``attention_sm90_kernel<DP, MODE_KEYMASK, NC>``): batch rows
    ``< n_uncond`` see keys ``< n_own`` only, the other rows see all keys.
    The uncond rows' units walk ``min(Nk, n_own)`` keys. bf16 on the
    card, d a multiple of 8 up to 160 (SD-1.5's widest head); q [B, Nq,
    H, D], k/v [B, Nk, H, D]."""
    b = q.shape[0]
    if not 1 <= n_own or not 0 <= n_uncond <= b:
        raise ValueError(f"keymask needs n_own >= 1 and 0 <= n_uncond <= B, "
                         f"got n_own={n_own}, n_uncond={n_uncond}, B={b}")
    if q.device.type != "cuda":
        return attention_injected_plain(q, k, v, n_own=n_own,
                                        n_uncond=n_uncond)
    _cuda.refuse_grad("flash_attention_keymask", q, k, v)
    out = _launch("sdaof_attention_keymask", q, k, v, int(n_own),
                  int(n_uncond), max_d=160)
    _count_launch(flash_attention_keymask, q.shape[-1])
    flash_attention_keymask.kernel = _K_KEYMASK
    return out


flash_attention_keymask.launches = 0
flash_attention_keymask.launches_by_dp = {}
flash_attention_keymask.kernel = None


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
    (kernel #10, ``attention_sm90_kernel<DP, MODE_MFR, NC>``) from the
    token indices; q/k/v [B, N, H, D] with N = h * n_tiles * w_tile.
    bf16 on the card, d a multiple of 8 up to 160."""
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
    _cuda.refuse_grad("flash_attention_mfr", q, k, v)
    out = _launch("sdaof_attention_mfr", q, k, v, n_tiles * w_tile, w_tile,
                  int(radius), int(mode == "target"), float(weight) * _LOG2E,
                  1.0 / float(sigma), max_d=160)
    _count_launch(flash_attention_mfr, q.shape[-1])
    flash_attention_mfr.kernel = _K_MFR
    return out


flash_attention_mfr.launches = 0
flash_attention_mfr.launches_by_dp = {}
flash_attention_mfr.kernel = None


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


# ---------------------------------------------------------------------------
# banded multi-frame attention (kernel #5)
# ---------------------------------------------------------------------------

def banded_strip_bias(h: int, w: int, n_frames: int, *, radius: int = 8,
                      weight: float = 0.0, sigma: float = 1.6,
                      base: float = -1000.0, dtype=torch.float32,
                      device=None):
    """Materialized banded cross-frame bias [h * w, n_frames * h * w]:
    query (y, x) against key (y', x') of any frame gets
    ``weight * exp(-dist / sigma)`` inside the ``|dy|, |dx| <= radius``
    band and ``base`` outside (the reference's Gaussian-decay band,
    built vectorised as the JAX ``banded_strip_bias``)."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    by = ys[:, None] - ys[None, :]                       # [h, h]
    bx = xs[:, None] - xs[None, :]                       # [w, w]
    dist = torch.sqrt((by[:, None, :, None] ** 2
                       + bx[None, :, None, :] ** 2).float())  # [h, w, h, w]
    val = weight * torch.exp(-dist / sigma)
    in_band = (by.abs()[:, None, :, None] <= radius) & \
        (bx.abs()[None, :, None, :] <= radius)
    bias = torch.where(in_band, val, base).reshape(h * w, h * w)
    return bias.repeat(1, n_frames).to(dtype)


def _banded_frames(q, k, h: int, w: int) -> int:
    nq, nk = q.shape[1], k.shape[1]
    if nq != h * w or nk % (h * w):
        raise ValueError(f"banded attention takes one {h}x{w} frame of "
                         f"queries ({h * w} tokens) against whole frames of "
                         f"keys, got Nq {nq}, Nk {nk}")
    return nk // (h * w)


def flash_attention_banded_plain(q, k, v, *, h: int, w: int,
                                 radius: int = 8, weight: float = 0.0,
                                 sigma: float = 1.6, base: float = -1000.0):
    """Plain version of :func:`flash_attention_banded`:
    :func:`xla_attention` with the materialized :func:`banded_strip_bias`
    (the function the JAX package's test holds its kernel to)."""
    bias = banded_strip_bias(h, w, _banded_frames(q, k, h, w),
                             radius=radius, weight=weight, sigma=sigma,
                             base=base, device=q.device)
    return xla_attention(q, k, v, bias=bias[None, None])


def flash_attention_banded(q, k, v, *, h: int, w: int, radius: int = 8,
                           weight: float = 0.0, sigma: float = 1.6,
                           base: float = -1000.0):
    """Multi-frame attention with the banded strip bias computed in the
    kernel (kernel #5, ``attention_sm90_kernel<DP, MODE_BANDED, NC>``):
    q [B, h*w, H, D] is one frame's tokens, k/v [B, n*h*w, H, D] the
    tokens of n frames joined along the token axis; key j sits at
    frame-local position j % (h*w). Every work unit of 192 query rows
    walks all n*h*w keys (no tile is skipped: with a finite ``base``
    every key counts). A warpgroup-uniform test adds ``base`` to a key
    tile that lies in one frame with no row within ``radius`` of the
    warpgroup's 64 query rows; the other tiles take each pair's bias,
    from a table in shared memory where w is a multiple of 8 and the
    radius at most 8, else from the formula. bf16 on the card, d a
    multiple of 8 up to 160 (32-key tiles at d 136-160). No backward
    (neither has the JAX kernel)."""
    if q.device.type != "cuda":
        return flash_attention_banded_plain(q, k, v, h=h, w=w, radius=radius,
                                            weight=weight, sigma=sigma,
                                            base=base)
    _banded_frames(q, k, h, w)
    _cuda.refuse_grad("flash_attention_banded", q, k, v)
    out = _launch("sdaof_attention_banded", q, k, v, int(h), int(w),
                  int(radius), float(weight) * _LOG2E, float(base) * _LOG2E,
                  1.0 / float(sigma), max_d=160)
    _count_launch(flash_attention_banded, q.shape[-1])
    flash_attention_banded.kernel = _K_BANDED
    return out


flash_attention_banded.launches = 0
flash_attention_banded.launches_by_dp = {}
flash_attention_banded.kernel = None
