"""LayerNorm-prologue projection and fused GEGLU feed-forward.

Counterpart of ``sd_animation_optical_flow_tpu/ops/ffn.py``. Weights take
the port's (torch) layout: a linear weight is [out, in].

Kernels, each with its plain version beside it:

* :func:`linear_ln_fused` replaces the TPU's ``_linear_ln_kernel``:
  ``LN(x) @ w^T``, the UNet's LN1 -> QKV and LN2 -> Q projections
  (``csrc/ffn_sm90.cu``: a wgmma kernel on the GEGLU's skeleton).
* :func:`geglu_ff_fused` replaces the TPU's ``_geglu_kernel`` /
  ``_geglu_kernel_ln``: ``[x +] FF([LN](x))`` with the GEGLU
  feed-forward, the transformer-block tail (``csrc/ffn_sm90.cu``: two
  wgmma kernels).

On a CPU tensor each wrapper returns its plain version (the unfused
chain); on a CUDA tensor it launches its kernel (bf16 only) or raises.
``<wrapper>.launches`` counts kernel launches, and ``<wrapper>.kernel``
names the source and design of the kernel its last launch ran (None
before one). Neither kernel has a
backward (neither has its Pallas original): on a CUDA tensor each wrapper
raises where a gradient would be recorded through its inputs, and the
UNet routes such calls to the plain chain.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.layers import layer_norm
from . import _cuda

# the kernels the wrappers launch (``<wrapper>.kernel``)
_K_LINEAR_LN = _cuda.kernel(
    "ffn_sm90.cu", "linear_ln_sm90_kernel<BN>: x by TMA into a resident "
    "128-byte-swizzled tile normalised in place, W through a TMA ring, "
    "wgmma, a TMA-store epilogue")
_K_GEGLU = _cuda.kernel(
    "ffn_sm90.cu", "geglu_up_sm90_kernel (LN prologue, W1, the GEGLU in "
    "registers) then geglu_down_sm90_kernel (W2, the bias and residual "
    "epilogue): two wgmma GEMMs")


def linear_ln_plain(x, w, ln_scale, ln_bias, ln_eps=1e-5):
    """The plain version of :func:`linear_ln_fused`."""
    xn = layer_norm({"scale": ln_scale, "bias": ln_bias}, x, eps=ln_eps)
    return xn @ w.to(x.dtype).t()


def geglu_ff_plain(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None,
                   ln_eps=1e-5, residual=False):
    """The plain version of :func:`geglu_ff_fused`: the unfused chain."""
    xn = x if ln_scale is None else \
        layer_norm({"scale": ln_scale, "bias": ln_bias}, x, eps=ln_eps)
    h = xn @ w1.to(x.dtype).t() + b1.to(x.dtype)
    h, gate = h.chunk(2, dim=-1)
    h = h * F.gelu(gate)
    out = h @ w2.to(x.dtype).t() + b2.to(x.dtype)
    return x + out if residual else out


def _rows(x):
    din = x.shape[-1]
    return x.reshape(-1, din).contiguous(), math.prod(x.shape[:-1]), din


def _aligned(t):
    # the kernels stage tiles with 16-byte loads (a view at an odd
    # offset gets a fresh copy)
    t = t.contiguous()
    return t if t.data_ptr() % 32 == 0 else t.clone()


def _check_bf16_cuda(*ts):
    for t in ts:
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise TypeError("the CUDA kernel takes bf16 tensors on the card, "
                            f"got {t.dtype} on {t.device}")


def linear_ln_fused(x, w, ln_scale, ln_bias, *, ln_eps: float = 1e-5):
    """``LN(x) @ w^T`` for x [..., din], w [dout, din] -> [..., dout].

    Kernel #3 (``linear_ln_sm90_kernel``, ``csrc/ffn_sm90.cu``): a block
    of 128 rows takes x by TMA into a resident 128-byte-swizzled tile,
    normalises it in place (f32 statistics, rounded to bf16), and runs
    wgmma products against w's 64-wide k chunks, which TMA streams
    through a ring; a TMA-store epilogue. Needs din a multiple of 16 up
    to 640 (the last 64-column chunk is zero-filled past din) and dout a
    multiple of 16."""
    if x.device.type != "cuda":
        return linear_ln_plain(x, w, ln_scale, ln_bias, ln_eps)
    _cuda.refuse_grad("linear_ln_fused", x, w, ln_scale, ln_bias)
    x2, m, din = _rows(x)
    dout = w.shape[0]
    if w.shape != (dout, din):
        raise ValueError(f"w {tuple(w.shape)} does not match din {din}")
    x2, w = _aligned(x2), _aligned(w.to(x.dtype))
    _check_bf16_cuda(x2, w)
    lns = _aligned(ln_scale.float())
    lnb = _aligned(ln_bias.float())
    y = torch.empty((m, dout), dtype=x.dtype, device=x.device)
    _cuda.call("sdaof_linear_ln", x.device, x2.data_ptr(), lns.data_ptr(),
               lnb.data_ptr(), w.data_ptr(), y.data_ptr(), m, din, dout,
               ln_eps)
    linear_ln_fused.launches += 1
    linear_ln_fused.kernel = _K_LINEAR_LN
    return y.reshape(*x.shape[:-1], dout)


linear_ln_fused.launches = 0
linear_ln_fused.kernel = None


def geglu_ff_fused(x, w1, b1, w2, b2, ln_scale=None, ln_bias=None, *,
                   ln_eps: float = 1e-5, residual: bool = False):
    """x [..., din] -> ``[x +] (h * gelu(gate)) @ w2^T + b2`` with
    ``h | gate = [LN](x) @ w1^T + b1``; w1 [2*dff, din] (value rows, then
    gate rows), w2 [din, dff].

    Kernel #4, two launches on the current stream (``csrc/ffn_sm90.cu``):
    ``geglu_up_sm90_kernel`` normalises 128-row blocks of x into shared
    memory and writes ``a = h * gelu(gate)`` [rows, dff] in bf16 (the
    TPU kernel's rounding point before w2) to a scratch tensor, then
    ``geglu_down_sm90_kernel`` computes ``a @ w2^T + b2 [+ x]``; both
    are wgmma GEMMs fed by a cp.async ring. ``.launches`` counts calls.
    Needs din a multiple of 64 up to 640 and dff a multiple of 64."""
    if x.device.type != "cuda":
        return geglu_ff_plain(x, w1, b1, w2, b2, ln_scale, ln_bias, ln_eps,
                              residual)
    _cuda.refuse_grad("geglu_ff_fused", x, w1, b1, w2, b2, ln_scale, ln_bias)
    x2, m, din = _rows(x)
    dff = w2.shape[1]
    if w1.shape != (2 * dff, din) or w2.shape != (din, dff):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do "
                         f"not match din {din}")
    x2 = _aligned(x2)
    w1, b1, w2, b2 = (_aligned(t.to(x.dtype)) for t in (w1, b1, w2, b2))
    _check_bf16_cuda(x2, w1, b1, w2, b2)
    if ln_scale is not None:
        lns = _aligned(ln_scale.float())
        lnb = _aligned(ln_bias.float())
        ln_ptrs = (lns.data_ptr(), lnb.data_ptr())
    else:
        ln_ptrs = (None, None)
    a = torch.empty((m, dff), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x2)
    _cuda.call("sdaof_geglu", x.device, x2.data_ptr(), *ln_ptrs,
               w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
               a.data_ptr(), y.data_ptr(), m, din, dff, ln_eps,
               int(residual))
    geglu_ff_fused.launches += 1
    geglu_ff_fused.kernel = _K_GEGLU
    return y.reshape(x.shape)


geglu_ff_fused.launches = 0
geglu_ff_fused.kernel = None
