"""Port parity: the flow front end — ``avg_pool2d`` / ``instance_norm``,
the correlation volume and its lookups, RAFT (full and small, all
iterations, GRU features, the on-the-fly correlation, a batch of 3,
bf16 storage, a warm start, the committed ``artifacts/raft_synth.npz``)
and the flow confidence (fb, learned, min, both directions, frames off
the multiple of 8) — against the JAX package on the CPU.

Same seeded numpy inputs and the same weights (the JAX tree through the
weights bridge, or the artifact npz through the port's loader) on both
sides, 64x96 frames (the 1/8 grid 8x12), at most 4 iterations. Each JAX
program is jitted once a config. Tolerances (stated per test): 1e-5 of
the output's scale where the arithmetic is the same f32 in another
order; flow within 1e-4 px and confidence within 1e-4 through RAFT's
iterations in f32; with bf16 correlation storage the rounding of equal
products can fall either side of a bf16 step, so flow within 2e-3 px
and confidence within 2e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import flowconf as JFC
from sd_animation_optical_flow_tpu.models import layers as JL
from sd_animation_optical_flow_tpu.models import raft as JR
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.ops import correlation as JC
from sd_animation_optical_flow_tpu.utils.checkpoint import load_pytree
from sd_animation_optical_flow_tpu_torch.models import flowconf as TFC
from sd_animation_optical_flow_tpu_torch.models import layers as TL
from sd_animation_optical_flow_tpu_torch.models import raft as TR
from sd_animation_optical_flow_tpu_torch.ops import correlation as TC
from sd_animation_optical_flow_tpu_torch.utils import jax_params as TP
from torch_port_common import np_t, rel_err, to_port

H, W = 64, 96
REDUCED = dict(corr_levels=2, corr_radius=2)


def _frames(rng, b, h=H, w=W, shift=(2, -3)):
    """A pair of [b, h, w, 3] RGB 0-255 frames: smooth noise and the same
    noise shifted by ``shift`` px, plus a little noise."""
    base = rng.uniform(0, 255, (b, h + 16, w + 16, 3)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (1, 2):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base)
    img1 = base[:, 8:8 + h, 8:8 + w]
    img2 = np.roll(base, shift, (1, 2))[:, 8:8 + h, 8:8 + w] \
        + rng.normal(0, 2, (b, h, w, 3)).astype(np.float32)
    return np.ascontiguousarray(img1), np.ascontiguousarray(img2)


def _jax_raft(cfg, seed=1):
    with numpy_init():
        return JR.raft_init(jax.random.PRNGKey(seed), cfg)


def _port_cfg(cfg):
    return TR.RAFTConfig(**cfg.__dict__)


# ---------------------------------------------------------------------------
# layers and correlation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,window,stride", [
    ((2, 8, 12, 5), 2, None), ((1, 9, 13, 3), 2, None),
    ((2, 12, 12, 4), 3, 2)])
def test_avg_pool2d_matches_jax(np_rng, shape, window, stride):
    """Tolerance 1e-6 of the scale (a 4- or 9-term f32 sum)."""
    x = np_rng.standard_normal(shape).astype(np.float32)
    ref = JL.avg_pool2d(jnp.asarray(x), window, stride)
    out = TL.avg_pool2d(np_t(x), window, stride)
    assert out.shape == ref.shape and rel_err(out, ref) < 1e-6


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(np_rng, affine):
    """f32 statistics, rounded once to the input dtype: 1e-5 of the scale
    in f32; bf16 input within one bf16 step (2^-8 relative)."""
    x = (np_rng.standard_normal((2, 8, 12, 6)) * 3 + 1).astype(np.float32)
    p = {"scale": np_rng.uniform(0.5, 1.5, 6).astype(np.float32),
         "bias": np_rng.standard_normal(6).astype(np.float32)} \
        if affine else None
    ref = JL.instance_norm(p, jnp.asarray(x))
    out = TL.instance_norm(None if p is None else
                           {k: np_t(v) for k, v in p.items()}, np_t(x))
    assert rel_err(out, ref) < 1e-5
    ref16 = JL.instance_norm(p, jnp.asarray(x, jnp.bfloat16))
    out16 = TL.instance_norm(None if p is None else
                             {k: np_t(v) for k, v in p.items()},
                             np_t(x).bfloat16())
    assert out16.dtype == torch.bfloat16
    assert rel_err(out16.float(), np.asarray(ref16, np.float32)) < 2 ** -7


def test_correlation_volume_and_lookups_match_jax(np_rng):
    """all_pairs_correlation, build_pyramid, CorrPyramid, lookup_pyramid
    at batch 1, 2 (the JAX flat path) and 3 (its per-image map), with
    coordinates partly outside the level, and bf16 storage: 1e-5 of the
    scale in f32; the pooled bf16 levels equal (both add in bf16, in the
    window's order), and the lookups on them within 1e-5."""
    b, h, w, d = 3, 8, 12, 16
    f1 = np_rng.standard_normal((b, h, w, d)).astype(np.float32)
    f2 = np_rng.standard_normal((b, h, w, d)).astype(np.float32)
    coords = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
              + np_rng.uniform(-4, 4, (b, h, w, 2))).astype(np.float32)
    jcorr = JC.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    tcorr = TC.all_pairs_correlation(np_t(f1), np_t(f2))
    assert tcorr.shape == (b, h, w, h, w) and rel_err(tcorr, jcorr) < 1e-5
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jpyr = JC.build_pyramid(jcorr.astype(jdt), 3)
        tpyr = TC.build_pyramid(np_t(np.asarray(jcorr.astype(jdt),
                                                np.float32)).to(dt), 3)
        for jl, tl in zip(jpyr, tpyr):
            assert tl.dtype == dt and tl.shape == jl.shape
            if dt == torch.float32:
                assert rel_err(tl, jl) < 1e-5
            else:
                assert np.array_equal(tl.float().numpy(),
                                      np.asarray(jl, np.float32))
        for nb in (1, 2, 3):
            jpb = [lv.reshape(b, h * w, *lv.shape[1:])[:nb].reshape(
                -1, *lv.shape[1:]) for lv in jpyr]
            tpb = [lv.reshape(b, h * w, *lv.shape[1:])[:nb].reshape(
                -1, *lv.shape[1:]) for lv in tpyr]
            ref = jax.jit(JC.lookup_pyramid, static_argnums=2)(
                jpb, jnp.asarray(coords[:nb]), 2)
            out = TC.lookup_pyramid(tpb, np_t(coords[:nb]), 2)
            assert out.shape == (nb, h, w, 3 * 25)
            assert rel_err(out, ref) < 1e-5, (dt, nb)
    ref = JC.CorrPyramid(jnp.asarray(f1), jnp.asarray(f2), 2, 3)(
        jnp.asarray(coords))
    out = TC.CorrPyramid(np_t(f1), np_t(f2), 2, 3)(np_t(coords))
    assert rel_err(out, ref) < 1e-5


def test_alt_correlation_matches_jax(np_rng):
    """The on-the-fly windowed correlation over fmap_pyramid: 1e-5 of the
    scale."""
    b, h, w, d = 2, 8, 12, 16
    f1 = np_rng.standard_normal((b, h, w, d)).astype(np.float32)
    f2 = np_rng.standard_normal((b, h, w, d)).astype(np.float32)
    coords = (np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
              + np_rng.uniform(-3, 3, (b, h, w, 2))).astype(np.float32)
    jpyr = JC.fmap_pyramid(jnp.asarray(f2), 3)
    tpyr = TC.fmap_pyramid(np_t(f2), 3)
    for jl, tl in zip(jpyr, tpyr):
        assert rel_err(tl, jl) < 1e-6
    ref = JC.alt_correlation_xla(jnp.asarray(f1), jpyr, jnp.asarray(coords),
                                 2)
    out = TC.alt_correlation_xla(np_t(f1), tpyr, np_t(coords), 2)
    assert out.shape == (b, h, w, 3 * 25) and rel_err(out, ref) < 1e-5


# ---------------------------------------------------------------------------
# RAFT
# ---------------------------------------------------------------------------

RAFT_CASES = {
    # name: (config, batch, apply kwargs, flow tolerance px)
    "full": (JR.RAFTConfig(iters=3, corr_dtype="float32", **REDUCED), 2,
             {}, 1e-4),
    "small": (JR.RAFTConfig.small_config(iters=3, corr_dtype="float32"), 2,
              {}, 1e-4),
    "all_iters_features": (JR.RAFTConfig(iters=3, corr_dtype="float32",
                                         **REDUCED), 1,
                           {"all_iters": True, "with_features": True}, 1e-4),
    "small_all_iters": (JR.RAFTConfig.small_config(iters=2,
                                                   corr_dtype="float32"), 1,
                        {"all_iters": True}, 1e-4),
    "alternate_corr": (JR.RAFTConfig(iters=3, alternate_corr=True,
                                     **REDUCED), 2, {}, 1e-4),
    "batch3_map": (JR.RAFTConfig(iters=2, corr_dtype="float32", **REDUCED),
                   3, {}, 1e-4),
    "bf16_storage": (JR.RAFTConfig(iters=3, **REDUCED), 2, {}, 2e-3),
    "flow_init": (JR.RAFTConfig(iters=2, corr_dtype="float32", **REDUCED),
                  1, {"flow_init": True}, 1e-4),
}


@pytest.mark.parametrize("case", list(RAFT_CASES))
def test_raft_apply_matches_jax(np_rng, case):
    """raft_apply on random JAX weights: every output within the case's
    flow tolerance (px; the GRU state within the same, absolute)."""
    cfg, b, kw, tol = RAFT_CASES[case]
    jp = _jax_raft(cfg)
    img1, img2 = _frames(np_rng, b)
    if kw.get("flow_init"):
        kw = {"flow_init": np_rng.uniform(-1, 1, (b, H // 8, W // 8, 2))
              .astype(np.float32)}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: np_t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    ref = jax.jit(lambda p, a, c: JR.raft_apply(p, cfg, a, c, **jkw))(
        jp, jnp.asarray(img1), jnp.asarray(img2))
    out = TR.raft_apply(to_port(jp), _port_cfg(cfg), np_t(img1), np_t(img2),
                        **tkw)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape, case
        err = float(np.abs(o.numpy() - np.asarray(r)).max())
        assert err < tol, (case, err)


def test_raft_artifact_full_config_matches_jax(np_rng):
    """The committed artifact at the full RAFTConfig (4 levels, radius 4,
    fnet 256), 4 iterations, f32 storage, loaded by each side's own
    loader: flow within 1e-4 px. The frames' shift (-3, +2) px is also
    read back to 0.5 px, so the weights loaded are the trained ones."""
    cfg = JR.RAFTConfig(iters=4, corr_dtype="float32")
    jp = load_pytree(TP.ARTIFACTS + "/raft_synth.npz", _jax_raft(cfg))
    tp = TP.load_npz_tree(TP.ARTIFACTS + "/raft_synth.npz", device="cpu")
    img1, img2 = _frames(np_rng, 1, shift=(2, -3))
    ref = jax.jit(lambda p, a, c: JR.raft_apply(p, cfg, a, c))(
        jp, jnp.asarray(img1), jnp.asarray(img2))
    out = TR.raft_apply(tp, _port_cfg(cfg), np_t(img1), np_t(img2))
    err = float(np.abs(out[1].numpy() - np.asarray(ref[1])).max())
    assert err < 1e-4, err
    # flow in img1's frame pointing into img2: img2 = img1 moved by (+2
    # rows, -3 columns), so the flow reads (x, y) = (-3, +2)
    med = np.median(out[1][0, 16:-16, 16:-16].numpy().reshape(-1, 2), 0)
    assert np.abs(med - np.array([-3.0, 2.0])).max() < 0.5, med


def test_raft_artifact_off_its_training_size_matches_jax(np_rng):
    """The artifact off its 128x192 training size: a (-3, +2) px shift of
    256x384 frames through each side's fb estimator (20 iterations, f32
    storage). Flow within 1e-4 px and confidence within 1e-4 of JAX, so
    the EPE each reads there (printed) is the artifact's, not the
    port's."""
    cfg = JR.RAFTConfig(corr_dtype="float32")
    jp = load_pytree(TP.ARTIFACTS + "/raft_synth.npz", _jax_raft(cfg))
    je = JFC.FlowConfidenceEstimator(jp, JFC.FlowConfidenceConfig(raft=cfg))
    te = TFC.FlowConfidenceEstimator(
        TP.load_npz_tree(TP.ARTIFACTS + "/raft_synth.npz", device="cpu"),
        TFC.FlowConfidenceConfig(raft=_port_cfg(cfg)), device="cpu")
    img1, img2 = _frames(np_rng, 1, 256, 384, shift=(-2, 3))
    jf, jc, _ = je.calc_batch(img1, img2)
    tf, tc, _ = te.calc_batch(img1, img2)
    assert np.abs(tf - jf).max() < 1e-4 and np.abs(tc - jc).max() < 1e-4
    for name, f in (("jax", jf), ("port", tf)):
        inner = f[0, 16:-16, 16:-16] - np.array([-3.0, 2.0])
        print(f"\n[artifact 256x384] {name}: interior EPE "
              f"{np.sqrt((inner ** 2).sum(-1)).mean():.4f} px")


def test_raft_helpers_match_jax(np_rng):
    """upflow8, upsample_flow_convex, coords_grid, pad_to_multiple and
    forward_interpolate: 1e-5 of the scale (forward_interpolate: equal)."""
    flow = np_rng.standard_normal((2, 8, 12, 2)).astype(np.float32)
    mask = np_rng.standard_normal((2, 8, 12, 576)).astype(np.float32)
    assert rel_err(TR.upflow8(np_t(flow)), JR.upflow8(jnp.asarray(flow))) \
        < 1e-5
    assert rel_err(TR.upsample_flow_convex(np_t(flow), np_t(mask)),
                   JR.upsample_flow_convex(jnp.asarray(flow),
                                           jnp.asarray(mask))) < 1e-5
    assert np.array_equal(TR.coords_grid(2, 5, 7, device="cpu").numpy(),
                          np.asarray(JR.coords_grid(2, 5, 7)))
    img = np_rng.uniform(0, 255, (2, 61, 90, 3)).astype(np.float32)
    (tp, thw), (jp, jhw) = TR.pad_to_multiple(np_t(img)), \
        JR.pad_to_multiple(jnp.asarray(img))
    assert thw == jhw and np.array_equal(tp.numpy(), np.asarray(jp))
    f = (np_rng.standard_normal((16, 24, 2)) * 3).astype(np.float32)
    assert np.array_equal(TR.forward_interpolate(f),
                          JR.forward_interpolate(f))


# ---------------------------------------------------------------------------
# flow confidence
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def conf_models():
    """A reduced RAFT (hidden 128, the head's width) and a random
    uncertainty head, in both frameworks on the same weights."""
    cfg = JR.RAFTConfig(iters=3, corr_dtype="float32", **REDUCED)
    jp = _jax_raft(cfg, seed=3)
    with numpy_init():
        jh = JFC.uncertainty_head_init(jax.random.PRNGKey(4), 128)
    return cfg, jp, jh, to_port(jp), to_port(jh)


def _estimators(conf_models, uncertainty, chunk=0):
    cfg, jp, jh, tp, th = conf_models
    jcfg = JFC.FlowConfidenceConfig(raft=cfg, uncertainty=uncertainty)
    tcfg = TFC.FlowConfidenceConfig(raft=_port_cfg(cfg),
                                    uncertainty=uncertainty)
    return (JFC.FlowConfidenceEstimator(jp, jcfg, head_params=jh),
            TFC.FlowConfidenceEstimator(tp, tcfg, chunk=chunk,
                                        head_params=th, device="cpu"))


@pytest.mark.parametrize("uncertainty", ["fb", "learned", "min"])
def test_flow_confidence_matches_jax(conf_models, np_rng, uncertainty):
    """calc_batch on 60x90 frames (padded to 64x96 and cropped back):
    flow within 1e-4 px, confidence within 1e-4 absolute, log-confidence
    within 1e-3 absolute where finite-valued and equal (-1e4) where a
    source falls outside the frame; calc (batch 1) within 1e-5 of
    calc_batch, and calc_batch_f16 its numbers in float16."""
    je, te = _estimators(conf_models, uncertainty)
    img1, img2 = _frames(np_rng, 2, 60, 90, shift=(3, -2))
    jf, jc, jl = je.calc_batch(img1, img2)
    tf, tc, tl = te.calc_batch(img1, img2)
    assert tf.shape == (2, 60, 90, 2) and tc.shape == (2, 60, 90)
    assert np.abs(tf - jf).max() < 1e-4
    assert np.abs(tc - jc).max() < 1e-4
    assert np.array_equal(tl <= -1e4, jl <= -1e4)
    assert (jl <= -1e4).any() and (jl > -1e4).any()
    finite = jl > -1e4
    assert np.abs(tl[finite] - jl[finite]).max() < 1e-3
    f0, c0, _ = te.calc(img1[0], img2[0])     # batch 1: other roundings
    assert np.abs(f0 - tf[0]).max() < 1e-5 and np.abs(c0 - tc[0]).max() \
        < 1e-5
    f16, c16 = te.calc_batch_f16(img1, img2)
    assert f16.dtype == np.float16 and np.array_equal(
        c16, tc.astype(np.float16))


@pytest.mark.parametrize("uncertainty", ["fb", "learned"])
def test_flow_confidence_bidir_and_chunks_match_jax(conf_models, np_rng,
                                                    uncertainty):
    """calc_batch_bidir_f16 (both directions from one RAFT batch) against
    the JAX one, within two float16 steps of the value (flow) and 1e-3
    (confidence); a chunked estimator (chunk 1 of a batch of 2) gives
    calc_batch's numbers within 1e-5."""
    je, te = _estimators(conf_models, uncertainty)
    img1, img2 = _frames(np_rng, 2, 60, 90, shift=(-2, 3))
    ref = je.calc_batch_bidir_f16(img1, img2)
    out = te.calc_batch_bidir_f16(img1, img2)
    for o, r, name in zip(out, ref, ("flow_st", "conf_st", "flow_ts",
                                     "conf_ts")):
        o, r = o.astype(np.float32), r.astype(np.float32)
        tol = 2e-3 * max(np.abs(r).max(), 1.0) if "flow" in name else 1e-3
        assert o.shape == r.shape and np.abs(o - r).max() <= tol, name
    _, chunked = _estimators(conf_models, uncertainty, chunk=1)
    whole = te.calc_batch(img1, img2)
    parts = chunked.calc_batch(img1, img2)
    for a, b in zip(whole, parts):
        assert np.abs(a - b).max() < 1e-5


def test_fb_confidence_and_head_match_jax(np_rng):
    """fb_confidence on given fields (with sources off the frame) and the
    learned head + confidence map: 1e-5 of the scale."""
    h, w = 16, 24
    fwd = (np_rng.standard_normal((h, w, 2)) * 3).astype(np.float32)
    bwd = (-fwd + np_rng.standard_normal((h, w, 2)) * 0.3).astype(np.float32)
    jc, jl = JFC.fb_confidence(jnp.asarray(fwd), jnp.asarray(bwd),
                               sigma=1.03, alpha=0.01)
    tc, tl = TFC.fb_confidence(np_t(fwd), np_t(bwd), sigma=1.03, alpha=0.01)
    assert rel_err(tc, jc) < 1e-5 and rel_err(tl, jl) < 1e-5
    with numpy_init():
        jh = JFC.uncertainty_head_init(jax.random.PRNGKey(2), 32)
    net = np_rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    fl = np_rng.standard_normal((2, 4, 6, 2)).astype(np.float32)
    jb = JFC.uncertainty_head_apply(jh, jnp.asarray(net), jnp.asarray(fl))
    tb = TFC.uncertainty_head_apply(to_port(jh), np_t(net), np_t(fl))
    assert rel_err(tb, jb) < 1e-5
    assert rel_err(TFC.learned_confidence(tb, (32, 48), 1 / 3),
                   JFC.learned_confidence(jb, (32, 48), 1 / 3)) < 1e-5
