"""Port parity: VAE, UNet and CLIP text encoder on the same weights (the
JAX init, converted by the weights bridge) and the same numpy inputs, on
the CPU in f32, at the small configs of .claude/skills/verify/SKILL.md
(UNet 32 channels x (1,2,4), VAE 32 channels x (1,2,4), CLIP width 64).

Tolerance: 1e-4 relative to the output's largest magnitude (f32 through
a few dozen layers whose convolutions and products sum in different
orders in the two frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from torch_port_common import (jax_models, np_t, rel_err, to_port,
                               torch_configs)

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    (jcfgs, jparams) = jax_models(seed=3)
    return jcfgs, jparams, torch_configs(), tuple(map(to_port, jparams))


def test_vae_encode_decode(models, np_rng):
    (_, jv, _), (_, vp, _), (_, tv, _), (_, tp, _) = models
    img = np_rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jmean, jlogvar = jax.jit(lambda p, x: JV.encode_moments(p, jv, x))(
        vp, jnp.asarray(img))
    tmean, tlogvar = TV.encode_moments(tp, tv, np_t(img))
    assert tmean.shape == jmean.shape == (2, 8, 12, 4)
    assert rel_err(tmean, jmean) < TOL
    assert rel_err(tlogvar, jlogvar) < TOL

    # sampled encode: the same posterior noise in both frameworks
    eps = np_rng.standard_normal(jmean.shape).astype(np.float32)
    jz = (jmean + jnp.exp(0.5 * jlogvar) * eps) * jv.scale_factor
    tz = TV.encode(tp, tv, np_t(img), noise=np_t(eps))
    assert rel_err(tz, jz) < TOL
    assert rel_err(TV.encode(tp, tv, np_t(img), sample=False),
                   jmean * jv.scale_factor) < TOL
    with pytest.raises(ValueError):
        TV.encode(tp, tv, np_t(img))

    z = np_rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    jimg = jax.jit(lambda p, z: JV.decode(p, jv, z))(vp, jnp.asarray(z))
    timg = TV.decode(tp, tv, np_t(z))
    assert timg.shape == jimg.shape == (2, 32, 48, 3)
    assert rel_err(timg, jimg) < TOL


@pytest.mark.parametrize("dedup", [False, True])
def test_unet_apply(models, np_rng, dedup):
    (ju, _, _), (up, _, _), (tu, _, _), (tp, _, _) = models
    b = 1 if dedup else 2
    x = np_rng.standard_normal((b, 8, 12, 4)).astype(np.float32)
    t = np.array([401] * b, np.int32)
    ctx = np_rng.standard_normal((2, 13, 64)).astype(np.float32)
    if dedup:
        pair_j = (jnp.asarray(ctx[:1]), jnp.asarray(ctx[1:]))
        jout, jkv = jax.jit(lambda p, x, t: JU.unet_apply(
            p, ju, x, t, None, context_pair=pair_j))(
            up, jnp.asarray(x), jnp.asarray(t))
        tout, tkv = TU.unet_apply(tp, tu, np_t(x), torch.from_numpy(t), None,
                                  context_pair=(np_t(ctx[:1]),
                                                np_t(ctx[1:])))
        assert tout.shape[0] == 2
    else:
        jout, jkv = jax.jit(lambda p, x, t, c: JU.unet_apply(p, ju, x, t, c))(
            up, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
        tout, tkv = TU.unet_apply(tp, tu, np_t(x), torch.from_numpy(t),
                                  np_t(ctx))
    assert tout.shape == jout.shape
    assert float(np.abs(np.asarray(jout)).max()) > 1e-3   # not trivially 0
    assert rel_err(tout, jout) < TOL
    assert len(tkv) == len(jkv)
    for (tk, tv_), (jk, jv_) in zip(tkv, jkv):
        assert rel_err(tk, jk) < TOL and rel_err(tv_, jv_) < TOL


def test_unet_dedup_equals_doubled_batch(models, np_rng):
    """Stem dedup is exact in arithmetic: the half-batch stem with
    (ctx_u, ctx_c) gives the doubled-batch output (up to the batch-size
    dependent summation order of the CPU's convolutions)."""
    _, _, (tu, _, _), (tp, _, _) = models
    x = np_t(np_rng.standard_normal((1, 8, 12, 4)).astype(np.float32))
    t = torch.tensor([21], dtype=torch.int32)
    ctx = np_t(np_rng.standard_normal((2, 13, 64)).astype(np.float32))
    half, _ = TU.unet_apply(tp, tu, x, t, None,
                            context_pair=(ctx[:1], ctx[1:]))
    full, _ = TU.unet_apply(tp, tu, torch.cat([x, x]), torch.cat([t, t]),
                            ctx)
    assert rel_err(half, full) < TOL


def test_unet_unported_arguments_raise(models):
    _, _, (tu, _, _), (tp, _, _) = models
    x = torch.zeros((2, 8, 12, 4))
    t = torch.zeros((2,), dtype=torch.int32)
    ctx = torch.zeros((2, 13, 64))
    with pytest.raises(TypeError, match="SeqParallelConfig"):
        TU.unet_apply(tp, tu, x, t, ctx, sp=object())
    # class labels are ported: refused on a UNet without num_classes
    with pytest.raises(ValueError, match="class-conditional"):
        TU.unet_apply(tp, tu, x, t, ctx, y=torch.zeros(2, dtype=torch.int64))
    # ported, but not with the stem dedup (the CFG halves differ)
    for kw in ({"attn_biases": {}}, {"y": torch.zeros(1, dtype=torch.int64)}):
        with pytest.raises(ValueError, match="context_pair"):
            TU.unet_apply(tp, tu, x[:1], t[:1], None,
                          context_pair=(ctx[:1], ctx[1:]), **kw)


@pytest.mark.parametrize("clip_skip", [0, 2])
def test_clip_encode_chunked(models, clip_skip):
    (_, _, jc), (_, _, cp), (_, _, tc), (_, _, tp) = models
    raw = [(7 * i) % 997 + 1 for i in range(160)]   # spans all 3 chunks
    ids = np.stack([JCL.chunk_token_ids(raw),
                    JCL.chunk_token_ids(raw[:20])])      # [2, 3, 77]
    ref = jax.jit(lambda p, i: JCL.encode_chunked(
        p, jc, i, clip_skip=clip_skip))(cp, jnp.asarray(ids))
    out = TCL.encode_chunked(tp, tc, torch.from_numpy(ids),
                             clip_skip=clip_skip)
    assert out.shape == ref.shape == (2, 231, 64)
    assert rel_err(out, ref) < TOL
