"""Port parity: the K/V-injection and MFR-strip attention (kernels #6 and
#10 through their plain versions) and the UNet's ``ref_kv`` / ``strip``
routes and 9-channel input, against the JAX package on the CPU.

Kernels: on a CPU tensor each wrapper computes its plain version, held
here against the JAX launcher of the Pallas kernel it replaces in
interpret mode (``flash_attention_keymask`` under the ``pallas_call``
patch of tests/test_attention.py, ``flash_attention_mfr(interpret=True)``)
and against the JAX package's own plain forms. Tolerances: 2e-5 (f32) and
5e-2 (bf16) of the output scale, as in tests/test_torch_kernels_plain.py.

UNet: ``unet_apply`` with the three injection cases, strips with and
without stem dedup, and the 9-channel inpainting input, in f32 on shared
weights; output and every K/V pair within 1e-4 of their scale."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.ops import attention as JA
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.ops import attention as TA
from torch_port_common import (UNET_KW, jax_models, np_t, perturb_zero_convs,
                               rel_err, to_port, torch_configs)

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# one compile per signature is several times faster than eager op-by-op
# dispatch of the whole UNet on the CPU
JUNET = jax.jit(JU.unet_apply, static_argnames=("cfg", "strip"))


def _pair(a, jdt, tdt):
    """The same values in both frameworks, rounded to the dtype once."""
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(t.float().numpy()).astype(jdt), t


def _close(out, ref, tol):
    """max |out - ref| <= tol * max |ref| (the output's scale)."""
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) <= tol


def _interpret():
    return mock.patch.object(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


# n_uncond in {1, 2}, n_own < Nk, Nk not a multiple of the 64-key block,
# d in {40, 80, 160}; n_own off the card kernel's 128-key tile at d 40
# and off its 64-key tile at d 160 (SD-1.5's third UNet level)
KEYMASK_CASES = [(2, 48, 200, 2, 40, 100, 1), (4, 40, 150, 2, 80, 75, 2),
                 (2, 64, 130, 1, 40, 64, 1), (4, 33, 96, 2, 40, 33, 2),
                 (2, 56, 300, 2, 40, 150, 1), (2, 40, 96, 2, 160, 48, 1)]


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("b,nq,nk,h,d,n_own,n_uncond", KEYMASK_CASES)
def test_keymask_plain_matches_jax(np_rng, dt, b, nq, nk, h, d, n_own,
                                   n_uncond):
    jdt, tdt, tol = DTYPES[dt]
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(np_rng.standard_normal((b, n, h, d)).astype(np.float32), jdt,
              tdt) for n in (nq, nk, nk))
    out = TA.flash_attention_keymask(qt, kt, vt, n_own=n_own,
                                     n_uncond=n_uncond)
    assert out.dtype == tdt and out.shape == (b, nq, h, d)
    with _interpret():
        ref = JA.flash_attention_keymask(qj, kj, vj, n_own=n_own,
                                         n_uncond=n_uncond, block_q=32,
                                         block_k=64)
    _close(out, ref, tol)
    _close(out, JA.attention_injected(qj, kj, vj, n_own=n_own,
                                      n_uncond=n_uncond, use_flash=False),
           tol)
    _close(TA.attention_injected(qt, kt, vt, n_own=n_own,
                                 n_uncond=n_uncond), ref, tol)


def test_mfr_bias_and_sigma_match_jax():
    for h in (12, 24, 32, 48, 64, 96):
        assert abs(TA.mfr_sigma(h) - JA.mfr_sigma(h)) < 1e-12
    np.testing.assert_array_equal(
        TA._strip_positions(5, 7, 3, 128).numpy(),
        np.asarray(JA._strip_positions(5, 7, 3, 128)))
    for mode in ("target", "mutual"):
        for h, w_tile, n in ((4, 3, 2), (6, 5, 3)):
            np.testing.assert_allclose(
                TA.mfr_strip_bias(h, w_tile, n, radius=2, weight=1.5,
                                  mode=mode).numpy(),
                np.asarray(JA.mfr_strip_bias(h, w_tile, n, radius=2,
                                             weight=1.5, mode=mode)),
                rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        TA.mfr_strip_bias(4, 3, 2, mode="both")


@pytest.mark.parametrize("h,w_tile,n_tiles,mode", [
    (5, 7, 2, "target"), (6, 5, 3, "mutual"), (16, 12, 2, "mutual"),
    (4, 9, 2, "target")])
def test_mfr_bias_radius_clamp(h, w_tile, n_tiles, mode):
    """The CUDA kernel clamps the radius to max(h, w_tile) - 1: every
    pair of a strip has |dy| <= h - 1 and |dx| <= w_tile - 1, so any
    wider radius gives exactly the bias at the clamp, which is JAX's."""
    clamp = max(h, w_tile) - 1
    at_clamp = TA.mfr_strip_bias(h, w_tile, n_tiles, radius=clamp,
                                 mode=mode)
    for radius in (clamp + 1, clamp + 7, 1000):
        assert torch.equal(TA.mfr_strip_bias(h, w_tile, n_tiles,
                                             radius=radius, mode=mode),
                           at_clamp)
        np.testing.assert_allclose(
            at_clamp.numpy(),
            np.asarray(JA.mfr_strip_bias(h, w_tile, n_tiles, radius=radius,
                                         mode=mode)), rtol=1e-6, atol=1e-7)
    # one less than the clamp drops the pairs at the widest offset
    if clamp >= 1:
        assert not torch.equal(TA.mfr_strip_bias(h, w_tile, n_tiles,
                                                 radius=clamp - 1, mode=mode),
                               at_clamp)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mode", ["target", "mutual"])
@pytest.mark.parametrize("n_tiles,d", [(2, 40), (3, 80), (4, 160)])
def test_mfr_plain_matches_jax(np_rng, dt, mode, n_tiles, d):
    jdt, tdt, tol = DTYPES[dt]
    h, w_tile, heads = 6, 7, 2
    n = h * n_tiles * w_tile
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(np_rng.standard_normal((1, n, heads, d)).astype(np.float32),
              jdt, tdt) for _ in range(3))
    out = TA.flash_attention_mfr(qt, kt, vt, h=h, w_tile=w_tile,
                                 n_tiles=n_tiles, mode=mode)
    assert out.dtype == tdt and out.shape == (1, n, heads, d)
    ref = JA.flash_attention_mfr(qj, kj, vj, h=h, w_tile=w_tile,
                                 n_tiles=n_tiles, mode=mode, block_q=64,
                                 block_k=64, interpret=True)
    _close(out, ref, tol)
    bias = JA.mfr_strip_bias(h, w_tile, n_tiles, mode=mode)[None, None]
    _close(out, JA.xla_attention(qj, kj, vj, bias=bias), tol)
    _close(TA.strip_attention(qt, kt, vt, h=h, w_strip=n_tiles * w_tile,
                              n_tiles=n_tiles, mode=mode), ref, tol)


@pytest.mark.parametrize("nq,d,expect", [(1536, 40, "kernel"),
                                         (6144, 80, "kernel"),
                                         (1535, 40, "plain"),
                                         (1536, 160, "kernel")])
def test_injection_and_strip_router_gates(nq, d, expect):
    """attention_injected / strip_attention keep the JAX gate (Nq >=
    1536) minus its TPU test, at every SD-1.5 head width (40, 80, 160):
    on a CUDA tensor a shape past the gate never takes the plain
    version."""
    calls = []
    spy = lambda name: (lambda *a, **kw: calls.append(name))
    q = torch.empty((2, nq, 1, d))
    with mock.patch.object(TA, "flash_attention_keymask", spy("kernel")), \
            mock.patch.object(TA, "attention_injected_plain", spy("plain")), \
            mock.patch.object(TA, "flash_attention_mfr", spy("kernel")), \
            mock.patch.object(TA, "strip_attention_plain", spy("plain")):
        TA.attention_injected(q, q, q, n_own=nq, n_uncond=1)
        TA.strip_attention(q, q, q, h=1, w_strip=nq, n_tiles=1)
    assert calls == [expect, expect]


def test_new_wrappers_use_plain_version_on_cpu(np_rng):
    """A CPU tensor never reaches a kernel: the launch counters stay."""
    q = torch.from_numpy(np_rng.standard_normal((2, 24, 1, 8)).astype(
        np.float32))
    before = (TA.flash_attention_keymask.launches,
              TA.flash_attention_mfr.launches)
    TA.flash_attention_keymask(q, q, q, n_own=12, n_uncond=1)
    TA.flash_attention_mfr(q, q, q, h=2, w_tile=6, n_tiles=2)
    assert (TA.flash_attention_keymask.launches,
            TA.flash_attention_mfr.launches) == before
    with pytest.raises(ValueError):
        TA.flash_attention_keymask(q, q, q, n_own=0, n_uncond=1)
    with pytest.raises(ValueError):
        TA.flash_attention_mfr(q, q, q, h=2, w_tile=5, n_tiles=2)


# ---------------------------------------------------------------------------
# the UNet's injection and strip routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_pair():
    (ju, _, _), (up, _, _) = jax_models(seed=3)
    return ju, up, torch_configs()[0], to_port(up)


def _kv_close(kv_t, kv_j):
    assert len(kv_t) == len(kv_j)
    for (kt, vt), (kj, vj) in zip(kv_t, kv_j):
        assert kt.shape == kj.shape and vt.shape == vj.shape
        assert rel_err(kt, kj) < 1e-4 and rel_err(vt, vj) < 1e-4


def _ref_kv(np_rng, kv_shapes, batch, refs=2):
    """Random per-layer reference K/V: ``refs`` frames' tokens joined."""
    return tuple(tuple(np_rng.standard_normal(
        (batch, refs * n, c)).astype(np.float32) for _ in range(2))
        for (_, n, c) in kv_shapes)


@pytest.mark.parametrize("x_batch,ref_batch", [
    (2, 2),     # batch equals x's: K/V replaced wholesale
    (2, 1),     # CFG batch, one reference set for both frames' halves
    (4, 2)])    # CFG batch, per-frame reference sets (B // 2)
def test_unet_ref_kv_matches_jax(unet_pair, np_rng, x_batch, ref_batch):
    ju, up, tu, tp = unet_pair
    x = np_rng.standard_normal((x_batch, 8, 12, 4)).astype(np.float32)
    t = np.full((x_batch,), 301, np.int32)
    ctx = np_rng.standard_normal((x_batch, 7, 64)).astype(np.float32)
    _, kv0 = TU.unet_apply(tp, tu, np_t(x[:1]), torch.from_numpy(t[:1]),
                           np_t(ctx[:1]))
    rkv = _ref_kv(np_rng, [k.shape for k, _ in kv0], ref_batch)
    ref_out, ref_kv = JUNET(
        up, ju, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        ref_kv=jax.tree.map(jnp.asarray, rkv))
    out, kv = TU.unet_apply(tp, tu, np_t(x), torch.from_numpy(t), np_t(ctx),
                            ref_kv=tuple((np_t(k), np_t(v)) for k, v in rkv))
    assert out.shape == ref_out.shape
    assert rel_err(out, ref_out) < 1e-4
    _kv_close(kv, ref_kv)
    plain, _ = TU.unet_apply(tp, tu, np_t(x), torch.from_numpy(t), np_t(ctx))
    assert rel_err(plain, out) > 1e-3      # the injection reached the output


@pytest.mark.parametrize("mode,dedup", [("target", False), ("mutual", False),
                                        ("mutual", True)])
def test_unet_strip_matches_jax(unet_pair, np_rng, mode, dedup):
    ju, up, tu, tp = unet_pair
    strip_j, strip_t = JU.StripConfig(2, mode), TU.StripConfig(2, mode)
    x = np_rng.standard_normal((1, 8, 16, 4)).astype(np.float32)
    t = np.full((1,), 501, np.int32)
    ctx = np_rng.standard_normal((2, 7, 64)).astype(np.float32)
    if dedup:
        ref_out, ref_kv = JUNET(
            up, ju, jnp.asarray(x), jnp.asarray(t), None, strip=strip_j,
            context_pair=(jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:])))
        out, kv = TU.unet_apply(tp, tu, np_t(x), torch.from_numpy(t), None,
                                strip=strip_t,
                                context_pair=(np_t(ctx[:1]), np_t(ctx[1:])))
    else:
        ref_out, ref_kv = JUNET(up, ju, jnp.asarray(x),
                                        jnp.asarray(t), jnp.asarray(ctx[1:]),
                                        strip=strip_j)
        out, kv = TU.unet_apply(tp, tu, np_t(x), torch.from_numpy(t),
                                np_t(ctx[1:]), strip=strip_t)
    assert out.shape == ref_out.shape
    assert rel_err(out, ref_out) < 1e-4
    _kv_close(kv, ref_kv)


def test_unet_inpaint9_through_the_bridge(np_rng):
    """An SD15_INPAINT9-shaped small UNet (9 input channels) carried
    across by the weights bridge: one forward pass and its K/V match."""
    cfg_j = JU.UNetConfig(in_channels=9, **UNET_KW)
    cfg_t = TU.UNetConfig(in_channels=9, **UNET_KW)
    with numpy_init():
        up = JU.unet_init(jax.random.PRNGKey(4), cfg_j)
    perturb_zero_convs(up, np.random.default_rng(4))
    tp = to_port(up)
    assert tuple(tp["input_blocks"][0]["conv"]["w"].shape) == (32, 9, 3, 3)
    x = np_rng.standard_normal((2, 8, 12, 9)).astype(np.float32)
    t = np.asarray([11, 801], np.int32)
    ctx = np_rng.standard_normal((2, 7, 64)).astype(np.float32)
    ref_out, ref_kv = JUNET(up, cfg_j, jnp.asarray(x),
                                    jnp.asarray(t), jnp.asarray(ctx))
    out, kv = TU.unet_apply(tp, cfg_t, np_t(x), torch.from_numpy(t),
                            np_t(ctx))
    assert out.shape == (2, 8, 12, 4)
    assert rel_err(out, ref_out) < 1e-4
    _kv_close(kv, ref_kv)


def test_unet_refuses_what_is_not_ported(unet_pair):
    _, _, tu, tp = unet_pair
    x = torch.zeros((2, 8, 12, 4))
    t = torch.ones(2, dtype=torch.int32)
    ctx = torch.zeros((2, 7, 64))
    with pytest.raises(TypeError, match="SeqParallelConfig"):
        TU.unet_apply(tp, tu, x, t, ctx, sp=object())
    for kw in ({"ref_kv": (None,) * 11}, {"attn_biases": {}}):
        with pytest.raises(ValueError, match="context_pair"):
            TU.unet_apply(tp, tu, x[:1], t[:1], None,
                          context_pair=(ctx[:1], ctx[1:]), **kw)
