"""Port parity: banded multi-frame attention (kernel #5 through its plain
version), ``sliced_attention`` and the UNet's materialized
``attn_biases`` route, against the JAX package on the CPU.

Kernel: on a CPU tensor ``flash_attention_banded`` computes its plain
version (``xla_attention`` with the materialized ``banded_strip_bias``),
held here against the JAX launcher of the Pallas kernel it replaces,
``flash_attention_banded``, run as tests/test_attention.py runs it
(``pl.pallas_call`` patched to interpret mode; every call of that
jitted launcher in the suite is patched, so no cached trace skips the
patch), and against the JAX ``xla_attention`` with the JAX bias.
Tolerances: the bias within 1e-6; the op within 1e-4 absolute on
unit-scale f32 inputs (at most 6.6e-7 over these cases on a CPU: the
interpret-mode kernel sums its exp2 tiles in another order than the
one-pass softmax).

UNet: ``unet_apply(attn_biases=...)`` with a materialized MFR bias at
every layer, with ``ref_kv`` of two frames plus the banded bias, and the
CFG injection (reference batch 1 and B / 2) plus the banded bias, in f32
on shared weights; output and every K/V pair within 1e-4 of their
scale, as tests/test_torch_injection.py holds the other routes."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.ops import attention as JA
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.ops import attention as TA
from torch_port_common import jax_models, np_t, rel_err, to_port, \
    torch_configs

JUNET = jax.jit(JU.unet_apply, static_argnames=("cfg", "strip"))


def _interpret():
    return mock.patch.object(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


@pytest.mark.parametrize("h,w,n,kw", [
    (6, 4, 3, dict(radius=1, weight=1.0, sigma=1.0)),
    (8, 16, 2, dict(radius=3, weight=0.7, sigma=1.6)),
    (5, 7, 2, dict()),                                   # the defaults
    (4, 9, 1, dict(radius=2, weight=0.0, base=-30.0)),
    (3, 5, 3, dict(radius=0, weight=2.5, sigma=0.5, base=-float("inf")))])
def test_banded_strip_bias_matches_jax(h, w, n, kw):
    out = TA.banded_strip_bias(h, w, n, **kw)
    ref = np.asarray(JA.banded_strip_bias(h, w, n, **kw))
    assert out.shape == ref.shape == (h * w, n * h * w)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert TA.banded_strip_bias(h, w, n, dtype=torch.bfloat16, **kw).dtype \
        == torch.bfloat16


# the defaults are radius 8 at weight 0; "radius 8" weighs the band too;
# d = 160 is SD-1.5's widest head (the port's kernel pads it to DP 160)
BANDS = {"band": dict(radius=3, weight=0.7, sigma=1.6),
         "defaults": dict(),
         "radius 8": dict(radius=8, weight=0.7, sigma=1.6)}


@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("d", [16, 40, 160])
@pytest.mark.parametrize("h,w,n", [(8, 16, 2), (3, 5, 3)])
def test_banded_plain_matches_pallas(np_rng, h, w, n, d, band):
    kw = BANDS[band]
    b, heads = 2, 2
    q, k, v = (np_rng.standard_normal((b, m, heads, d)).astype(np.float32)
               for m in (h * w, n * h * w, n * h * w))
    launches = TA.flash_attention_banded.launches
    out = TA.flash_attention_banded(np_t(q), np_t(k), np_t(v), h=h, w=w,
                                    **kw)
    assert TA.flash_attention_banded.launches == launches    # plain on CPU
    assert out.dtype == torch.float32 and out.shape == q.shape
    with _interpret():
        ref = JA.flash_attention_banded(*map(jnp.asarray, (q, k, v)), h=h,
                                        w=w, block_q=32, block_k=64, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    bias = JA.banded_strip_bias(h, w, n, **kw)[None, None]
    ref_x = JA.xla_attention(*map(jnp.asarray, (q, k, v)), bias=bias)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_x), rtol=0,
                               atol=1e-4)
    plain = TA.flash_attention_banded_plain(np_t(q), np_t(k), np_t(v), h=h,
                                            w=w, **kw)
    assert torch.equal(plain, out)


def test_banded_guards():
    """The JAX launcher's assertions are ValueErrors here, in the wrapper
    and its plain version alike."""
    q = torch.zeros((1, 12, 2, 8))
    for nq, nk in ((12, 25), (13, 24), (12, 6)):
        for fn in (TA.flash_attention_banded,
                   TA.flash_attention_banded_plain):
            with pytest.raises(ValueError, match="banded"):
                fn(q[:, :1].expand(1, nq, 2, 8), q[:, :1].expand(1, nk, 2, 8),
                   q[:, :1].expand(1, nk, 2, 8), h=3, w=4)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("slice_size", [16, 64])
def test_sliced_attention_matches_jax(np_rng, with_bias, slice_size):
    q = np_rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    k, v = (np_rng.standard_normal((2, 53, 4, 16)).astype(np.float32)
            for _ in range(2))
    bias = np_rng.standard_normal((1, 1, 37, 53)).astype(np.float32) \
        if with_bias else None
    out = TA.sliced_attention(np_t(q), np_t(k), np_t(v),
                              slice_size=slice_size,
                              bias=None if bias is None else np_t(bias))
    ref = JA.sliced_attention(*map(jnp.asarray, (q, k, v)),
                              slice_size=slice_size,
                              bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    full = TA.xla_attention(np_t(q), np_t(k), np_t(v),
                            bias=None if bias is None else np_t(bias))
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the UNet's attn_biases route
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


def _layer_hw(tp, tu, h, w):
    """(h, w) of each spatial transformer's tokens, in capture order."""
    x = torch.zeros((1, h, w, 4))
    _, kv = TU.unet_apply(tp, tu, x, torch.ones(1, dtype=torch.int32),
                          torch.zeros((1, 7, 64)))
    by_tokens = {(h >> s) * (w >> s): (h >> s, w >> s) for s in range(4)}
    return [by_tokens[k.shape[1]] for k, _ in kv], [k.shape for k, _ in kv]


def test_unet_materialized_mfr_biases_match_jax(unet_pair, np_rng):
    """The port's mirror of tests/test_mfr.py: a materialized MFR bias at
    every layer's resolution equals the strip route and the JAX UNet."""
    ju, up, tu, tp = unet_pair
    x = np_rng.standard_normal((1, 8, 16, 4)).astype(np.float32)
    t = np.full((1,), 3, np.int32)
    ctx = np_rng.standard_normal((1, 7, 64)).astype(np.float32)
    hws, _ = _layer_hw(tp, tu, 8, 16)
    biases_t = {i: TA.mfr_strip_bias(hh, ww // 2, 2)[None, None]
                for i, (hh, ww) in enumerate(hws)}
    biases_j = {i: JA.mfr_strip_bias(hh, ww // 2, 2)[None, None]
                for i, (hh, ww) in enumerate(hws)}
    ref_out, ref_kv = JUNET(up, ju, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx), attn_biases=biases_j)
    args = (tp, tu, np_t(x), torch.from_numpy(t), np_t(ctx))
    out, kv = TU.unet_apply(*args, attn_biases=biases_t)
    assert out.shape == ref_out.shape
    assert rel_err(out, ref_out) < 1e-4
    _kv_close(kv, ref_kv)
    strip, _ = TU.unet_apply(*args, strip=TU.StripConfig(2, "target"))
    assert rel_err(out, strip) < 1e-4
    plain, _ = TU.unet_apply(*args)
    assert rel_err(plain, out) > 1e-3        # the bias reached the output


BAND_KW = dict(radius=2, weight=0.7, sigma=1.6)


@pytest.mark.parametrize("x_batch,ref_batch", [
    (2, 2),     # batch equals x's: K/V replaced wholesale
    (2, 1),     # CFG batch, one reference set: the key mask joins the bias
    (4, 2)])    # CFG batch, per-frame reference sets (B // 2)
def test_unet_banded_biases_with_ref_kv_match_jax(unet_pair, np_rng,
                                                  x_batch, ref_batch):
    """Queries of one frame against the reference K/V of two frames, with
    the banded cross-frame bias [h*w, 2*h*w] at every layer."""
    ju, up, tu, tp = unet_pair
    x = np_rng.standard_normal((x_batch, 8, 12, 4)).astype(np.float32)
    t = np.full((x_batch,), 301, np.int32)
    ctx = np_rng.standard_normal((x_batch, 7, 64)).astype(np.float32)
    hws, shapes = _layer_hw(tp, tu, 8, 12)
    rkv = tuple(tuple(np_rng.standard_normal((ref_batch, 2 * n, c)).astype(
        np.float32) for _ in range(2)) for (_, n, c) in shapes)
    biases_t = {i: TA.banded_strip_bias(hh, ww, 2, **BAND_KW)[None, None]
                for i, (hh, ww) in enumerate(hws)}
    biases_j = {i: JA.banded_strip_bias(hh, ww, 2, **BAND_KW)[None, None]
                for i, (hh, ww) in enumerate(hws)}
    ref_out, ref_kv = JUNET(up, ju, jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx),
                            ref_kv=jax.tree.map(jnp.asarray, rkv),
                            attn_biases=biases_j)
    args = (tp, tu, np_t(x), torch.from_numpy(t), np_t(ctx))
    ref_kv_t = tuple((np_t(k), np_t(v)) for k, v in rkv)
    out, kv = TU.unet_apply(*args, ref_kv=ref_kv_t, attn_biases=biases_t)
    assert out.shape == ref_out.shape
    assert rel_err(out, ref_out) < 1e-4
    _kv_close(kv, ref_kv)
    unbiased, _ = TU.unet_apply(*args, ref_kv=ref_kv_t)
    assert rel_err(unbiased, out) > 1e-3     # the bias reached the output
    with pytest.raises(ValueError, match="strip"):
        TU.unet_apply(*args, attn_biases=biases_t,
                      strip=TU.StripConfig(2, "mutual"))
