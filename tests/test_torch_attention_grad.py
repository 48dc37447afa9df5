"""Port parity: the differentiable attention of training (kernels #7-#9
through their plain versions) against the JAX package on the CPU.

On a CPU tensor ``flash_attention_diff`` runs the plain versions of the
forward with statistics and of the two backward kernels; JAX runs its
Pallas kernels in interpret mode (off a TPU ``flash_attention_diff`` and
``shortk_attention`` interpret by themselves). Tolerances are the JAX
tests' own (tests/test_attention.py): 2e-4 on the output, 2e-3 on the
gradients, absolute and relative, f32. The router and UNet-gate tests
pin where a recorded gradient goes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.ops import attention as JA
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.ops import attention as TA

OUT_TOL, GRAD_TOL = 2e-4, 2e-3


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _qkv(seed, b, nq, nk, h, d):
    rng = np.random.default_rng(seed)
    return _rand(rng, b, nq, h, d), _rand(rng, b, nk, h, d), \
        _rand(rng, b, nk, h, d), _rand(rng, b, nq, h, d)


def _torch_grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(w))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_grads(fn, q, k, v, w):
    args = tuple(map(jnp.asarray, (q, k, v)))
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _close(a, b, tol, what):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("nq,nk", [(64, 64), (48, 37)])
@pytest.mark.parametrize("d", [16, 40])
def test_flash_attention_diff_matches_jax(nq, nk, d):
    """Forward and q/k/v gradients (a fixed cotangent) of the port's
    autograd Function against the JAX custom VJP, ragged K included."""
    q, k, v, w = _qkv(nq * 100 + nk + d, 2, nq, nk, 2, d)
    out, grads = _torch_grads(TA.flash_attention_diff, q, k, v, w)
    jout, jgrads = _jax_grads(JA.flash_attention_diff, q, k, v, w)
    _close(out, jout, OUT_TOL, "out")
    for g, jg, name in zip(grads, jgrads, "qkv"):
        _close(g, jg, GRAD_TOL, f"d{name}")


def test_flash_fwd_stats_plain_matches_jax():
    """``out`` and ``exp2(lse)`` against the JAX kernel's ``out`` and its
    max-free denominator ``l`` (equal at these bounded logits)."""
    q, k, v, _ = _qkv(1, 2, 48, 37, 2, 40)
    out, lse = TA.flash_fwd_stats_plain(*map(torch.from_numpy, (q, k, v)))
    jout, jl = JA._flash_fwd_stats(*map(jnp.asarray, (q, k, v)),
                                   JA.DEFAULT_BLOCK_Q, JA.DEFAULT_BLOCK_K)
    _close(out.numpy(), np.asarray(jout), OUT_TOL, "out")
    assert lse.shape == (2 * 2, 48) and lse.dtype == torch.float32
    l_jax = np.asarray(jl)[:, 0, :48]
    np.testing.assert_allclose(np.exp2(lse.numpy()), l_jax, rtol=1e-5)


@pytest.mark.parametrize("nq,nk,d", [(64, 64, 16), (48, 37, 40)])
def test_flash_bwd_plain_matches_jax(nq, nk, d):
    """The plain backward against the JAX ``_flash_bwd`` (kernels #8, #9
    in interpret mode) on the same forward residuals and cotangent."""
    q, k, v, w = _qkv(7 + d, 2, nq, nk, 2, d)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    out, lse = TA.flash_fwd_stats_plain(tq, tk, tv)
    grads = TA.flash_bwd_plain(tq, tk, tv, out, lse, tw)
    jq, jk, jv, jw = map(jnp.asarray, (q, k, v, w))
    jout, jl = JA._flash_fwd_stats(jq, jk, jv, JA.DEFAULT_BLOCK_Q,
                                   JA.DEFAULT_BLOCK_K)
    jgrads = JA._flash_bwd(jq, jk, jv, jout, jl, jw, JA.BWD_BLOCK_Q,
                           JA.BWD_BLOCK_K)
    for g, jg, name in zip(grads, jgrads, "qkv"):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(jg), GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("nk", [37, 77])
def test_shortk_attention_grads_match_jax(nk):
    q, k, v, w = _qkv(nk, 1, 64, nk, 2, 16)
    out, grads = _torch_grads(TA.shortk_attention, q, k, v, w)
    jout, jgrads = _jax_grads(
        lambda q, k, v: JA.shortk_attention(q, k, v, 64, 128), q, k, v, w)
    _close(out, jout, OUT_TOL, "out")
    for g, jg, name in zip(grads, jgrads, "qkv"):
        _close(g, jg, GRAD_TOL, f"d{name}")


def test_flash_attention_diff_runs_the_three_plain_kernels(monkeypatch):
    """Under a gradient the Function's forward is #7's wrapper and its
    backward #8's and #9's (here their plain versions, the tensors lying
    on the CPU); with nothing to record it is #1's wrapper."""
    calls = []

    def spy(name):
        real = getattr(TA, name)

        def wrapped(*a):
            calls.append(name)
            return real(*a)
        monkeypatch.setattr(TA, name, wrapped)

    for name in ("flash_fwd_stats", "flash_bwd_dkv", "flash_bwd_dq",
                 "flash_attention_tpv"):
        spy(name)
    q, k, v, w = map(torch.from_numpy, _qkv(3, 1, 40, 40, 2, 16))
    with torch.no_grad():
        TA.flash_attention_diff(q, k, v)
    assert calls == ["flash_attention_tpv"]
    calls.clear()
    q.requires_grad_()
    TA.flash_attention_diff(q, k, v).backward(w)
    assert calls == ["flash_fwd_stats", "flash_bwd_dkv", "flash_bwd_dq"]
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_flash_attention_diff_bf16_grads():
    q, k, v, w = (torch.from_numpy(a).bfloat16()
                  for a in _qkv(5, 1, 32, 32, 2, 8))
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    TA.flash_attention_diff(q, k, v).float().mul(w.float()).sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == torch.bfloat16
        assert torch.isfinite(t.grad.float()).all()


def _route(monkeypatch, q, k, v):
    """The name of the function the router sends (q, k, v) to."""
    seen = []
    for name in ("flash_attention_tpv", "flash_attention",
                 "flash_attention_diff", "shortk_attention",
                 "xla_attention"):
        monkeypatch.setattr(TA, name, lambda *a, _n=name, **kw:
                            seen.append(_n))
    TA.attention(q, k, v)
    return seen


@pytest.mark.parametrize("grad", [False, True])
def test_router_under_a_gradient(monkeypatch, grad):
    """Inputs that require grad take the differentiable routes; plain
    inputs keep the inference routes (launch counts unchanged)."""
    self_l0 = torch.zeros(1, 1536, 1, 40, requires_grad=grad)
    cross_k = torch.zeros(1, 77, 1, 40, requires_grad=grad)
    assert _route(monkeypatch, self_l0, self_l0, self_l0) == \
        ["flash_attention_diff" if grad else "flash_attention_tpv"]
    assert _route(monkeypatch, self_l0, cross_k, cross_k) == \
        ["shortk_attention" if grad else "flash_attention_tpv"]
    small = torch.zeros(1, 256, 1, 40, requires_grad=grad)
    assert _route(monkeypatch, small, small, small) == ["xla_attention"]
    wide = torch.zeros(1, 1536, 1, 160, requires_grad=grad)
    if grad:
        with pytest.raises(RuntimeError, match="no backward"):
            _route(monkeypatch, wide, wide, wide)
        with torch.no_grad():     # grad mode off: the inference route
            assert _route(monkeypatch, wide, wide, wide) == \
                ["flash_attention"]
    else:
        assert _route(monkeypatch, wide, wide, wide) == ["flash_attention"]


@pytest.mark.parametrize("grad", [False, True])
def test_fused_ffn_gate_closes_under_a_gradient(grad):
    """The bf16 LN-projection / GEGLU gate is open for inference inputs
    and closed where a gradient is recorded through x or a weight."""
    x = torch.zeros(2, 4096, 320, dtype=torch.bfloat16)
    w = torch.zeros(960, 320, requires_grad=grad)
    assert TU._fused_route(x, w) is (not grad)
    assert TU._fused_route(x.clone().requires_grad_(grad)) is (not grad)
    with torch.no_grad():
        assert TU._fused_route(x, w) is True
