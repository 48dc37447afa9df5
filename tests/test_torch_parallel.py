"""Port parity: the serving side of ``parallel/`` — the mesh, ring and
Ulysses attention (with the MFR strip attention as Ulysses' inner
attention), the row-sharded layers and ``unet_apply(sp=)`` — on gloo
ranks on the CPU, against the JAX package on its 8-device virtual CPU
mesh (``tests/conftest.py``) on the same inputs.

The ranks are spawned processes (``tests/torch_parallel_ranks.py``, which
imports no JAX), one process group per world size for the whole module
(2 and 4 ranks), each rank on one thread; the tests compare what they
returned here. Tolerances start from the JAX tests' own
(``tests/test_parallel.py``): attention rtol = atol = 2e-5 (JAX's
``test_ulysses_attention_matches_dense``); the UNet 5e-4 of max |JAX|
(JAX's sharded-UNet tests); the row-sharded layers against the port's
unsharded ones 1e-6 of max |unsharded| (f32, the same ops on fewer
rows; the GroupNorm's combined statistics differ in rounding only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.ops import attention as JA
from sd_animation_optical_flow_tpu.parallel import mesh as JM
from sd_animation_optical_flow_tpu.parallel import ring_attention as JR
from sd_animation_optical_flow_tpu_torch.models import layers as TL
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.parallel import mesh as TM
from torch_parallel_ranks import Ranks
from torch_port_common import (UNET_KW, np_t, perturb_zero_convs, rel_err,
                               to_port)

ATTN_TOL = 2e-5
UNET_TOL = 5e-4
LAYER_TOL = 1e-6
WORLDS = (2, 4)
# q/k/v [2, 64, 8, 16]; the strip: 8 rows of 2 tiles 4 wide (64 tokens)
B, N, HEADS, D = 2, 64, 8, 16
STRIP_H, STRIP_W_TILE = 8, 4
UNET_LAT = (8, 12)      # rows split over 2 ranks at each of 3 levels


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return {t: rng.standard_normal((B, N, HEADS, D)).astype(np.float32)
            for t in "qkv"}


def _control_shapes(cfg, b, h, w):
    """The ControlNet residual shapes of ``cfg``'s UNet: one per input
    block (its output, the skip it adds to), then the middle block's."""
    mc, last = cfg.model_channels, len(cfg.channel_mult) - 1
    shapes = [(b, h, w, mc)]
    for lvl, mult in enumerate(cfg.channel_mult):
        shapes += [(b, h >> lvl, w >> lvl, mult * mc)] * cfg.num_res_blocks
        if lvl != last:
            shapes.append((b, h >> (lvl + 1), w >> (lvl + 1), mult * mc))
    return shapes + [(b, h >> last, w >> last, cfg.channel_mult[-1] * mc)]


def _unet_case():
    cfg = JU.UNetConfig(**UNET_KW)
    with numpy_init():
        params = JU.unet_init(jax.random.PRNGKey(3), cfg)
    perturb_zero_convs(params, np.random.default_rng(4))
    rng = np.random.default_rng(5)
    b, (h, w) = 2, UNET_LAT
    return {"jax": (cfg, params), "cfg": TU.UNetConfig(**UNET_KW),
            "params": to_port(params),
            "x": rng.standard_normal((b, h, w, 4)).astype(np.float32),
            "t": np.array([10, 500], np.int64),
            "ctx": rng.standard_normal((b, 7, 64)).astype(np.float32),
            "control": [rng.standard_normal(s).astype(np.float32) * 0.3
                        for s in _control_shapes(cfg, b, h, w)]}


def _layer_case():
    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(6)
    init = TL.Init(gen)
    return {"x": rng.standard_normal((2, 16, 12, 32)).astype(np.float32),
            "conv3": TL.conv2d_init(init, 32, 16, 3),
            "conv1": TL.conv2d_init(init, 32, 16, 1),
            "norm": {"scale": torch.randn(32, generator=gen),
                     "bias": torch.randn(32, generator=gen)}}


@pytest.fixture(scope="module")
def cases():
    attention = {"ring": _qkv(0), "ulysses": _qkv(1)}
    for i, mode in enumerate(("target", "mutual")):
        attention[f"strip_{mode}"] = dict(
            _qkv(2 + i), strip=(STRIP_H, 2 * STRIP_W_TILE, 2, mode))
    return {"attention": attention, "layers": _layer_case(),
            "unet": _unet_case()}


def _jax_mesh(world):
    return JM.make_mesh(dp=world, devices=jax.devices()[:world])


def _jax_refs(cases):
    """The JAX package's results: ring and Ulysses attention on a 2- and a
    4-device mesh, the dense strip attention (``xla_attention`` with the
    materialized ``mfr_strip_bias``, which JAX's
    ``test_ulysses_attn_fn_mfr_matches_dense`` holds its Ulysses form to;
    its shard_map compile of the strip attention takes ~5 s a mode) and
    ``unet_apply(sp=)`` on a 2-device mesh with the ControlNet
    residuals."""
    refs = {}
    for name, case in cases["attention"].items():
        qkv = [jnp.asarray(case[t]) for t in "qkv"]
        if name.startswith("strip"):
            h, w_strip, n_tiles, mode = case["strip"]
            bias = JA.mfr_strip_bias(h, w_strip // n_tiles, n_tiles,
                                     mode=mode)
            refs[name] = np.asarray(JA.xla_attention(*qkv,
                                                     bias=bias[None, None]))
            continue
        fn = JR.ring_attention if name == "ring" else JR.ulysses_attention
        for world in WORLDS:
            refs[name, world] = np.asarray(fn(*qkv, _jax_mesh(world),
                                              seq_axis="dp"))
    case = cases["unet"]
    cfg, params = case["jax"]
    sp = JU.SeqParallelConfig(mesh=_jax_mesh(2), axis="dp")
    refs["unet"] = jax.jit(lambda p, x, t, c, ctl: JU.unet_apply(
        p, cfg, x, t, c, control=ctl, sp=sp))(
        params, jnp.asarray(case["x"]), jnp.asarray(case["t"]),
        jnp.asarray(case["ctx"]), tuple(jnp.asarray(c)
                                        for c in case["control"]))
    return refs


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """(rank results {world: {job: [rank 0's result, ...]}}, JAX results):
    one gloo process group per world size, both running while JAX
    computes its side here; the UNet and the strip cases run at world 2
    only."""
    started = {}
    for world in WORLDS:
        jobs = ["mesh_checks", "attention_jobs", "layer_jobs"]
        inputs = {"attention": dict(cases["attention"]),
                  "layers": cases["layers"]}
        if world == 2:
            jobs.append("unet_jobs")
            inputs["unet"] = {k: v for k, v in cases["unet"].items()
                              if k != "jax"}
        else:
            inputs["attention"] = {k: v for k, v in
                                   inputs["attention"].items()
                                   if not k.startswith("strip")}
        started[world] = Ranks(world, tmp_path_factory.mktemp(f"w{world}"),
                               jobs, inputs)
    refs = _jax_refs(cases)
    return {world: r.results() for world, r in started.items()}, refs


def _whole(per_rank, name):
    """The ranks' token slices of output ``name``, in rank order."""
    return np.concatenate([r[name] for r in per_rank], axis=1)


def test_make_mesh_needs_a_matching_process_group(runs):
    """No process group here: make_mesh raises (no fallback to one
    device). In the ranks: a (world, 1) ('dp', 'tp') mesh, the refusal of
    a world size that differs, the batch slices and replicate_tree."""
    with pytest.raises(RuntimeError, match="process group"):
        TM.make_mesh(device_type="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        TU.SeqParallelConfig(mesh=object())
    for world in WORLDS:
        res = runs[0][world]["mesh_checks"]
        x = np.arange(world * 3.0, dtype=np.float32).reshape(-1, 1)
        for rank, r in enumerate(res):
            assert r["shape"] == (world, 1) and r["names"] == ("dp", "tp")
            assert "does not match" in r["mismatch"]
            np.testing.assert_array_equal(r["shard"], x[3 * rank:3 * rank + 3])
            np.testing.assert_array_equal(r["gathered"], x)
            np.testing.assert_array_equal(r["replicated"][0], [0.0, 0.0])
            assert r["replicated"][1] == 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_ring_and_ulysses_match_jax(runs, world, name):
    ranks, refs = runs
    got = _whole(ranks[world]["attention_jobs"], name)
    np.testing.assert_allclose(got, refs[name, world], rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("mode", ["target", "mutual"])
def test_ulysses_with_the_strip_attention_matches_jax(runs, mode):
    """Ulysses with the MFR strip attention as ``attn_fn`` (world 2)
    against the JAX package's dense strip attention."""
    ranks, refs = runs
    got = _whole(ranks[2]["attention_jobs"], f"strip_{mode}")
    np.testing.assert_allclose(got, refs[f"strip_{mode}"], rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    # the band bias changed the output
    plain = _whole(ranks[2]["attention_jobs"], "ulysses")
    assert np.abs(got - plain).max() > 1e-2


def test_ulysses_refuses_heads_off_the_mesh(runs):
    for world in WORLDS:
        for r in runs[0][world]["attention_jobs"]:
            assert "do not divide" in r["odd_heads"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("layer", ["conv3", "down", "conv1", "up", "norm"])
def test_row_sharded_layers_match_unsharded(cases, runs, world, layer):
    """The halo convolutions (3 x 3 at stride 1, the stride-2 down
    convolution, 1 x 1, the upsampling one) and the sharded GroupNorm,
    gathered, against the port's unsharded layers on the whole tensor."""
    case = cases["layers"]
    x = np_t(case["x"])
    want = {"conv3": lambda: TL.conv2d(case["conv3"], x),
            "down": lambda: TL.conv2d(case["conv3"], x, stride=2,
                                      padding=1),
            "conv1": lambda: TL.conv2d(case["conv1"], x),
            "up": lambda: TL.upsample2x_conv(case["conv3"], x),
            "norm": lambda: TL.group_norm(case["norm"], x, num_groups=4),
            }[layer]().numpy()
    for r in runs[0][world]["layer_jobs"]:
        assert r[layer].shape == want.shape
        assert rel_err(r[layer], want) <= LAYER_TOL


def test_unet_sp_matches_jax(runs):
    """``unet_apply(sp=)`` at world 2 with ControlNet residuals (whole,
    sliced to each rank's rows) and the K/V capture (gathered to whole
    tokens) against JAX's ``unet_apply(sp=)`` on a 2-device mesh; without
    ``capture_kv`` the same output and no kv_hist; ``ref_kv``,
    ``attn_biases`` and ``context_pair`` refused."""
    ranks, refs = runs
    want, want_kv = refs["unet"]
    for r in ranks[2]["unet_jobs"]:
        assert r["out"].shape == want.shape
        assert rel_err(r["out"], want) < UNET_TOL
        assert len(r["kv"]) == len(want_kv)
        for (k, v), (wk, wv) in zip(r["kv"], want_kv):
            assert k.shape == wk.shape and v.shape == wv.shape
            assert rel_err(k, wk) < UNET_TOL and rel_err(v, wv) < UNET_TOL
        assert r["same_without_capture"] and r["kv_without_capture"] is None
        assert all("does not compose" in e for e in r["refusals"])
