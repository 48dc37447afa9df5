"""Port parity: the ControlNet slice's modules against the JAX package on
the CPU in f32 — the colour Canny and the HED hint's Sobel fallback
against cv2, the hint builders, ``controlnet_apply``, the HED network and
its edge map, the step weights and mixing, ``unet_apply(control=...)``
with and without the stem dedup, and DeepCache's partial forward.

Gates: the Canny maps equal cv2's; the Sobel fallback within 1e-5 of
cv2's (hint scale); modules within 1e-4 of the output's scale; HED edges
no pixel more than 1 from JAX's."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import controlnet as JCN
from sd_animation_optical_flow_tpu.models import hed as JHED
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu_torch.models import controlnet as TCN
from sd_animation_optical_flow_tpu_torch.models import hed as THED
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models.layers import Init
from sd_animation_optical_flow_tpu_torch.ops import filters as TFI
from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
    params_to_jax
from torch_port_common import (UNET_KW, jax_models, np_t,
                               perturb_zero_convs, rel_err, to_port)

TOL = 1e-4


def _frame(rng, h, w):
    """A blurred-noise BGR frame: edges of every direction and strength."""
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


# ---------------------------------------------------------------------------
# filters and hints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,low,high", [((64, 96), 30, 60),
                                         ((64, 96), 100, 200),
                                         ((37, 51), 10, 20)])
def test_colour_canny_equals_cv2(np_rng, hw, low, high):
    img = _frame(np_rng, *hw)
    ref = cv2.Canny(img, low, high)
    np.testing.assert_array_equal(
        TFI.canny(torch.from_numpy(img), low, high).numpy(), ref)
    hint = TCN.canny_hint(img, low, high, batch=2, device="cpu")
    np.testing.assert_array_equal(hint.numpy(),
                                  JCN.canny_hint(img, low, high, batch=2))


def test_gray_and_sobel_fallback_match_cv2(np_rng):
    raw = np_rng.integers(0, 256, (50, 70, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        TFI.bgr_to_gray_u8(torch.from_numpy(raw)).numpy(),
        cv2.cvtColor(raw, cv2.COLOR_BGR2GRAY))
    for hw in ((64, 96), (37, 51)):
        img = _frame(np_rng, *hw)
        ref = JCN.hed_hint(img, None, batch=2)
        out = TCN.hed_hint(img, None, batch=2, device="cpu")
        assert out.shape == ref.shape == (2,) + hw + (3,)
        assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_inpaint_hint_matches_jax(np_rng):
    img = _frame(np_rng, 32, 48)
    mask = np_rng.integers(0, 256, (32, 48)).astype(np.uint8)
    np.testing.assert_array_equal(
        TCN.inpaint_hint(img, mask, batch=2, device="cpu").numpy(),
        JCN.inpaint_hint(img, mask, batch=2))


# ---------------------------------------------------------------------------
# ControlNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nets():
    """The small UNet and a ControlNet of its config, zero convs perturbed,
    in both frameworks."""
    (ju, _, _), (up, _, _) = jax_models(seed=3)
    with numpy_init():
        cp = JCN.controlnet_init(jax.random.PRNGKey(4), ju)
    perturb_zero_convs(cp, np.random.default_rng(4))
    return ju, TU.UNetConfig(**UNET_KW), up, cp, to_port(up), to_port(cp)


def _control_inputs(rng, b=2, h=8, w=12):
    return (rng.standard_normal((b, h, w, 4)).astype(np.float32),
            rng.uniform(0, 1, (b, 8 * h, 8 * w, 3)).astype(np.float32),
            np.asarray([401, 401][:b], np.int32),
            rng.standard_normal((b, 13, 64)).astype(np.float32))


def test_controlnet_init_tree_matches_jax(nets):
    """The port's init builds the JAX tree: the same keys and shapes
    (through the weights bridge's layouts), zero convs zero."""
    ju, tu, _, cp, _, _ = nets
    tree = TCN.controlnet_init(Init(torch.Generator().manual_seed(0)), tu)
    ours = jax.tree_util.tree_flatten_with_path(params_to_jax(tree))[0]
    theirs = jax.tree_util.tree_flatten_with_path(cp)[0]
    assert [(p, np.shape(a)) for p, a in ours] == \
        [(p, np.shape(a)) for p, a in theirs]
    # one zero conv per input block (12 at SD-1.5's widths, 9 here)
    assert len(tree["zero_convs"]) == len(tree["input_blocks"]) == 9
    for conv in tree["zero_convs"] + [tree["middle_out"], tree["hint_out"]]:
        assert not conv["w"].any() and not conv["b"].any()


def test_controlnet_apply_matches_jax(nets, np_rng):
    ju, tu, _, cp, _, tcp = nets
    x, hint, t, ctx = _control_inputs(np_rng)
    ref = jax.jit(lambda p, *a: JCN.controlnet_apply(p, ju, *a))(
        cp, *map(jnp.asarray, (x, hint, t, ctx)))
    out = TCN.controlnet_apply(tcp, tu, np_t(x), np_t(hint),
                               torch.from_numpy(t), np_t(ctx))
    assert len(out) == len(ref) == 10       # 9 encoder + the middle
    for o, r in zip(out, ref):
        assert o.shape == r.shape and np.abs(np.asarray(r)).max() > 0
        assert rel_err(o, r) < TOL


def test_control_weights_and_mixing_match_jax(nets, np_rng):
    ju, tu, _, cp, _, tcp = nets
    progress = np.linspace(0.05, 1.0, 20)
    jspecs = [JCN.ControlSpec(cp, ju, None, 0.7, 0.0, 1.0),
              JCN.ControlSpec(cp, ju, None, 0.3, 0.0, 0.9)]
    tspecs = [TCN.ControlSpec(tcp, tu, None, 0.7, 0.0, 1.0),
              TCN.ControlSpec(tcp, tu, None, 0.3, 0.0, 0.9)]
    w = TCN.control_step_weights(tspecs, progress)
    np.testing.assert_array_equal(w, JCN.control_step_weights(jspecs,
                                                              progress))
    assert w[-1, 1] == 0 and w[-1, 0] == np.float32(0.7)
    res = [tuple(np_rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
                 for _ in range(10)) for _ in range(2)]
    ref = JCN.mix_controls([tuple(map(jnp.asarray, r)) for r in res], w[3])
    out = TCN.mix_controls([tuple(map(np_t, r)) for r in res], w[3])
    for o, r in zip(out, ref):
        assert rel_err(o, r) < 1e-6

    # control_residuals broadcasts a batch-1 hint over the CFG batch
    x, hint, t, ctx = _control_inputs(np_rng)
    one = [TCN.ControlSpec(tcp, tu, np_t(hint[:1]))]
    two = [TCN.ControlSpec(tcp, tu, np_t(np.repeat(hint[:1], 2, 0)))]
    a = TCN.control_residuals(one, np_t(x), torch.from_numpy(t), np_t(ctx))
    b = TCN.control_residuals(two, np_t(x), torch.from_numpy(t), np_t(ctx))
    for ra, rb in zip(a[0], b[0]):
        assert rel_err(ra, rb) < 1e-5     # conv algorithms by batch


# ---------------------------------------------------------------------------
# the UNet's control and DeepCache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True])
def test_unet_control_matches_jax(nets, np_rng, dedup):
    ju, tu, up, cp, tup, tcp = nets
    x, hint, t, ctx = _control_inputs(np_rng)
    ctl = jax.jit(lambda p, *a: JCN.controlnet_apply(p, ju, *a))(
        cp, *map(jnp.asarray, (x, hint, t, ctx)))
    ctl_np = [np.asarray(r) for r in ctl]

    def jfn(up, x, t, ctx, ctl):
        if dedup:
            return JU.unet_apply(up, ju, x[:1], t[:1], None, control=ctl,
                                 context_pair=(ctx[:1], ctx[1:]))[0]
        return JU.unet_apply(up, ju, x, t, ctx, control=ctl)[0]
    xs = np.repeat(x[:1], 2, 0)         # the CFG batch: one latent twice
    ref = jax.jit(jfn)(up, jnp.asarray(xs), jnp.asarray(t),
                       jnp.asarray(ctx), tuple(map(jnp.asarray, ctl_np)))
    tctl = tuple(map(np_t, ctl_np))
    if dedup:
        out, _ = TU.unet_apply(tup, tu, np_t(xs[:1]),
                               torch.from_numpy(t[:1]), None, control=tctl,
                               context_pair=(np_t(ctx[:1]), np_t(ctx[1:])))
    else:
        out, _ = TU.unet_apply(tup, tu, np_t(xs), torch.from_numpy(t),
                               np_t(ctx), control=tctl)
    plain, _ = TU.unet_apply(tup, tu, np_t(xs), torch.from_numpy(t),
                             np_t(ctx))
    assert out.shape == (2, 8, 12, 4)
    assert rel_err(out, ref) < TOL
    assert rel_err(plain, ref) > 1e-3        # the residuals reach the output


def test_unet_deepcache_matches_jax(nets, np_rng):
    ju, tu, up, _, tup, _ = nets
    x = np_rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    t = np.asarray([501, 501], np.int32)
    ctx = np_rng.standard_normal((2, 13, 64)).astype(np.float32)
    full = jax.jit(lambda p, *a: JU.unet_apply_deepcache(
        p, ju, *a, want_deep_cache=True))
    cached = jax.jit(lambda p, x, t, c, d: JU.unet_apply_deepcache(
        p, ju, x, t, c, deep_cache=d)[0])
    ref_out, ref_deep = full(up, *map(jnp.asarray, (x, t, ctx)))
    out, deep = TU.unet_apply_deepcache(tup, tu, np_t(x),
                                        torch.from_numpy(t), np_t(ctx))
    assert deep.shape == TU.deepcache_feat_shape(tu, 2, 8, 12) \
        == JU.deepcache_feat_shape(ju, 2, 8, 12)
    assert rel_err(out, ref_out) < TOL and rel_err(deep, ref_deep) < TOL
    # the full pass equals the UNet; a cached step reuses the feature
    plain, _ = TU.unet_apply(tup, tu, np_t(x), torch.from_numpy(t),
                             np_t(ctx))
    assert rel_err(out, plain) < 1e-6
    x2 = x + 0.1 * np_rng.standard_normal(x.shape).astype(np.float32)
    ref_c = cached(up, jnp.asarray(x2), jnp.asarray(t), jnp.asarray(ctx),
                   ref_deep)
    out_c, passed = TU.unet_apply_deepcache(
        tup, tu, np_t(x2), torch.from_numpy(t), np_t(ctx), deep_cache=deep)
    assert passed is deep and rel_err(out_c, ref_c) < TOL


# ---------------------------------------------------------------------------
# HED
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hed():
    with numpy_init():
        jp = JHED.hed_init(jax.random.PRNGKey(9))
    jp["norm"] = jnp.asarray([104.0, 117.0, 123.0], jnp.float32)
    return jp, to_port(jp)


def test_hed_apply_and_edges_match_jax(hed, np_rng):
    jp, tp = hed
    img = _frame(np_rng, 48, 64)
    ref_sides = jax.jit(JHED.hed_apply)(jp, jnp.asarray(img, jnp.float32)[None])
    sides = THED.hed_apply(tp, torch.from_numpy(img).float()[None])
    for i, (s, r) in enumerate(zip(sides, ref_sides)):
        assert s.shape == r.shape == (1, 48 >> i, 64 >> i, 1)
        assert rel_err(s, r) < TOL
    ref = JHED.hed_edges(jp, img)
    out = THED.make_hed_fn(tp)(img)
    assert out.dtype == torch.uint8 and out.shape == ref.shape == (48, 64)
    assert np.abs(out.numpy().astype(int) - ref.astype(int)).max() <= 1
    hint = TCN.hed_hint(img, THED.make_hed_fn(tp), batch=1, device="cpu")
    assert hint.shape == (1, 48, 64, 3)
    assert np.abs(hint.numpy() - JCN.hed_hint(img, JHED.make_hed_fn(jp),
                                              batch=1)).max() <= 1 / 255


def test_port_hed_matches_jax(np_rng):
    """The annotator's torch-layout state dict -> the same tree in both
    packages (the port's in OIHW, the layout the weights bridge gives)."""
    sd = {"norm": np_rng.standard_normal((1, 3, 1, 1)).astype(np.float32)}
    for i, (cin, cout, n) in enumerate(THED._BLOCKS, start=1):
        ch = cin
        for j in range(n):
            sd[f"block{i}.convs.{j}.weight"] = np_rng.standard_normal(
                (cout, ch, 3, 3)).astype(np.float32)
            sd[f"block{i}.convs.{j}.bias"] = np_rng.standard_normal(
                cout).astype(np.float32)
            ch = cout
        sd[f"block{i}.projection.weight"] = np_rng.standard_normal(
            (1, cout, 1, 1)).astype(np.float32)
        sd[f"block{i}.projection.bias"] = np_rng.standard_normal(
            1).astype(np.float32)
    ours = THED.port_hed(sd, device="cpu")
    theirs = to_port(JHED.port_hed(sd))
    a = jax.tree_util.tree_flatten_with_path(params_to_jax(ours))[0]
    b = jax.tree_util.tree_flatten_with_path(params_to_jax(theirs))[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)
    tree = THED.hed_init(Init(torch.Generator().manual_seed(0)))
    assert [p for p, _ in jax.tree_util.tree_flatten_with_path(
        params_to_jax(tree))[0]] == [p for p, _ in a]
