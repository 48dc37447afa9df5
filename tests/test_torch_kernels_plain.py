"""Port parity for the modules that hold kernels (ops/attention.py,
ops/ffn.py): on the CPU each wrapper computes its plain version, held
here against the JAX launchers of the Pallas kernels it replaces, run in
interpret mode as the JAX package's own tests run them
(``flash_attention_tpv``, ``linear_ln_fused`` and ``geglu_ff_fused`` pick
interpret mode by themselves off the TPU; ``flash_attention`` needs the
``pallas_call`` patch of tests/test_attention.py), and against
``xla_attention``.

Tolerances as in tests/test_attention.py and tests/test_ffn.py: 2e-5 in
f32 (3e-5 for the LayerNorm-prologue kernels), 5e-2 in bf16. The
router's choices are checked separately."""

import functools
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sd_animation_optical_flow_tpu.ops import attention as JA
from sd_animation_optical_flow_tpu.ops import ffn as JF
from sd_animation_optical_flow_tpu_torch.ops import _cuda
from sd_animation_optical_flow_tpu_torch.ops import attention as TA
from sd_animation_optical_flow_tpu_torch.ops import ffn as TF
import torch_port_common  # noqa: F401  (thread count)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _qkv(np_rng, b, nq, nk, h, d):
    return tuple(np_rng.standard_normal((b, n, h, d)).astype(np.float32)
                 for n in (nq, nk, nk))


def _pair(a, jdt, tdt):
    """The same values in both frameworks, rounded to the dtype once."""
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(t.float().numpy()).astype(jdt), t


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


# ragged Nk = 231 (the 3x77 prompt) and d in {40, 80} at small N
ATTN_CASES = [(1, 64, 231, 2, 40), (2, 48, 231, 2, 80),
              (1, 96, 96, 2, 40), (1, 80, 130, 1, 80)]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,nq,nk,h,d", ATTN_CASES)
def test_flash_attention_tpv_plain_matches_jax(np_rng, dt, b, nq, nk, h, d):
    jdt, tdt, tol = DTYPES[dt]
    pairs = [_pair(a, jdt, tdt) for a in _qkv(np_rng, b, nq, nk, h, d)]
    (qj, qt), (kj, kt), (vj, vt) = pairs
    out = TA.flash_attention_tpv(qt, kt, vt)
    assert out.dtype == tdt and out.shape == (b, nq, h, d)
    _close(out, JA.flash_attention_tpv(qj, kj, vj, block_q=32, block_k=64),
           tol)
    _close(out, JA.xla_attention(qj, kj, vj), tol)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 64, 64, 1, 512),
                                         (1, 40, 72, 2, 160)])
def test_flash_attention_plain_matches_jax(np_rng, dt, b, nq, nk, h, d):
    jdt, tdt, tol = DTYPES[dt]
    pairs = [_pair(a, jdt, tdt) for a in _qkv(np_rng, b, nq, nk, h, d)]
    (qj, qt), (kj, kt), (vj, vt) = pairs
    out = TA.flash_attention(qt, kt, vt)
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call, interpret=True)):
        ref = JA.flash_attention(qj, kj, vj, block_q=32, block_k=32)
    _close(out, ref, tol)
    _close(out, JA.xla_attention(qj, kj, vj), tol)


def test_xla_attention_bias_matches_jax(np_rng):
    q, k, v = _qkv(np_rng, 2, 9, 13, 2, 8)
    bias = np_rng.standard_normal((2, 1, 9, 13)).astype(np.float32)
    ref = JA.xla_attention(*map(jnp.asarray, (q, k, v)),
                           bias=jnp.asarray(bias))
    out = TA.xla_attention(*map(torch.from_numpy, (q, k, v)),
                           bias=torch.from_numpy(bias))
    _close(out, ref, 2e-5)


@pytest.mark.parametrize("nq,nk,d,bias,expect", [
    (1536, 231, 40, False, "tpv"),      # short-K cross-attention
    (6144, 512, 128, False, "tpv"),
    (1536, 1536, 80, False, "tpv"),     # long self-attention
    (6144, 6144, 512, False, "wide"),   # VAE mid-block, d > 128
    (1536, 231, 160, False, "xla"),     # short K, wide head: XLA in JAX
    (384, 384, 160, False, "xla"),      # short sequences
    (1536, 1536, 80, True, "xla"),      # any bias
])
def test_router_gates(nq, nk, d, bias, expect):
    """attention() keeps the JAX router's shape gates."""
    calls = []
    spy = lambda name: (lambda q, k, v, **kw: calls.append(name) or q)
    q = torch.empty((1, nq, 1, d))
    k = torch.empty((1, nk, 1, d))
    with mock.patch.object(TA, "flash_attention_tpv", spy("tpv")), \
            mock.patch.object(TA, "flash_attention", spy("wide")), \
            mock.patch.object(TA, "xla_attention", spy("xla")):
        TA.attention(q, k, k, bias=torch.zeros(1) if bias else None)
    assert calls == [expect]


def _ffn_params(np_rng, din, dff):
    w1 = np_rng.standard_normal((din, 2 * dff)).astype(np.float32) * 0.05
    b1 = np_rng.standard_normal((2 * dff,)).astype(np.float32) * 0.05
    w2 = np_rng.standard_normal((dff, din)).astype(np.float32) * 0.05
    b2 = np_rng.standard_normal((din,)).astype(np.float32) * 0.05
    g = np_rng.standard_normal((din,)).astype(np.float32) * 0.1 + 1.0
    beta = np_rng.standard_normal((din,)).astype(np.float32) * 0.1
    return w1, b1, w2, b2, g, beta


# the last case is the UNet's L0 width (din 320, dff 1280), the shape the
# card's kernel is held to this plain version at
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("ln,residual,m,din,dff", [(True, True, 300, 64, 256),
                                                   (False, False, 256, 64, 256),
                                                   (True, True, 64, 320, 1280)])
def test_geglu_ff_plain_matches_jax(np_rng, dt, ln, residual, m, din, dff):
    jdt, tdt, tol = DTYPES[dt]
    x = np_rng.standard_normal((m, din)).astype(np.float32) * 0.5
    w1, b1, w2, b2, g, beta = _ffn_params(np_rng, din, dff)
    xj, xt = _pair(x, jdt, tdt)
    (w1j, w1t), (b1j, b1t), (w2j, w2t), (b2j, b2t) = (
        _pair(a, jdt, tdt) for a in (w1, b1, w2, b2))
    lnj = (jnp.asarray(g), jnp.asarray(beta)) if ln else (None, None)
    lnt = (torch.from_numpy(g), torch.from_numpy(beta)) if ln \
        else (None, None)
    ref = JF.geglu_ff_fused(xj, w1j, b1j, w2j, b2j, *lnj, residual=residual,
                            block_m=128, block_ff=128)
    # the port's weights are [out, in]
    out = TF.geglu_ff_fused(xt, w1t.t(), b1t, w2t.t(), b2t, *lnt,
                            residual=residual)
    assert out.shape == (m, din) and out.dtype == tdt
    _close(out, ref, max(tol, 3e-5))


# din 64, and the UNet's L0 QKV width (din 320 -> 960), at which the
# card holds kernel #3 to this plain version
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("m,din,dout", [
    pytest.param(300, 64, 192, id="300-192"),
    pytest.param(256, 64, 64, id="256-64"),
    pytest.param(64, 320, 960, id="64-320-960")])
def test_linear_ln_plain_matches_jax(np_rng, dt, m, din, dout):
    jdt, tdt, tol = DTYPES[dt]
    x = np_rng.standard_normal((2, m, din)).astype(np.float32) * 0.5
    w = np_rng.standard_normal((din, dout)).astype(np.float32) * 0.1
    g = np_rng.standard_normal((din,)).astype(np.float32) * 0.1 + 1.0
    beta = np_rng.standard_normal((din,)).astype(np.float32) * 0.1
    (xj, xt), (wj, wt) = _pair(x, jdt, tdt), _pair(w, jdt, tdt)
    ref = JF.linear_ln_fused(xj, wj, jnp.asarray(g), jnp.asarray(beta),
                             block_m=128)
    out = TF.linear_ln_fused(xt, wt.t(), torch.from_numpy(g),
                             torch.from_numpy(beta))
    assert out.shape == (2, m, dout) and out.dtype == tdt
    _close(out, ref, max(tol, 3e-5))


def test_wrappers_use_plain_version_on_cpu(np_rng):
    """A CPU tensor never reaches a kernel: the launch counters stay."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np_rng, 1, 8, 8, 1, 8))
    before = (TA.flash_attention_tpv.launches, TA.flash_attention.launches,
              TF.linear_ln_fused.launches, TF.geglu_ff_fused.launches)
    TA.flash_attention_tpv(q, k, v)
    TA.flash_attention(q, k, v)
    x = torch.randn(4, 16)
    TF.linear_ln_fused(x, torch.randn(32, 16), torch.ones(16),
                       torch.zeros(16))
    TF.geglu_ff_fused(x, torch.randn(128, 16), torch.zeros(128),
                      torch.randn(16, 64), torch.zeros(16))
    assert (TA.flash_attention_tpv.launches, TA.flash_attention.launches,
            TF.linear_ln_fused.launches,
            TF.geglu_ff_fused.launches) == before


def test_wrapper_kernels_name_their_sources():
    """Every kernel a wrapper's ``.kernel`` can name (its source and
    design, which chip_smoke.py reports) is defined in the source it
    names, in the mode it names."""
    root = Path(TA.__file__).resolve().parents[2]
    kernels = [v for mod in (TA, TF) for v in vars(mod).values()
               if isinstance(v, _cuda.Kernel)]
    assert len(kernels) == 10
    for kern in kernels:
        text = (root / kern.source).read_text()
        name, mode = re.match(r"(\w+)(?:<\w+, (\w+)>)?", kern.design).groups()
        assert re.search(rf"\b{name}\(", text), kern
        assert mode is None or f"MODE_{mode}" in text, kern
