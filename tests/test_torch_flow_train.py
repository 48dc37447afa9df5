"""Port parity: the flow-training path (``training/synthetic_flow.py``,
``flow_train.py``, ``uncertainty_pretrain.py``, ``flow_eval.py``) and the
npz writer (``utils/checkpoint.py``, ``jax_params.params_to_jax``)
against the JAX package on the CPU.

Inputs are made from seeded numpy generators; both frameworks get the
same weights (the JAX tree through the weights bridge, or the committed
artifacts through each side's loader). RAFT runs at 64x96 with 2
iterations for the training steps (JAX's ``_tiny_cfg`` of
tests/test_flow_train.py, and the full ``RAFTConfig`` with f32 storage).
Tolerances are stated per test. Each JAX program is jitted once a
module (module fixtures)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sd_animation_optical_flow_tpu.models import flowconf as JFC
from sd_animation_optical_flow_tpu.models import raft as JR
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.training import flow_eval as JFE
from sd_animation_optical_flow_tpu.training import flow_train as JFT
from sd_animation_optical_flow_tpu.training import synthetic_flow as JSF
from sd_animation_optical_flow_tpu.training import uncertainty_pretrain as JUP
from sd_animation_optical_flow_tpu.utils.checkpoint import load_pytree
from sd_animation_optical_flow_tpu_torch.models import flowconf as TFC
from sd_animation_optical_flow_tpu_torch.models import raft as TR
from sd_animation_optical_flow_tpu_torch.models.layers import Init
from sd_animation_optical_flow_tpu_torch.training import flow_eval as TFE
from sd_animation_optical_flow_tpu_torch.training import flow_train as TFT
from sd_animation_optical_flow_tpu_torch.training import synthetic_flow as TSF
from sd_animation_optical_flow_tpu_torch.training import \
    uncertainty_pretrain as TUP
from sd_animation_optical_flow_tpu_torch.utils import jax_params as TP
from sd_animation_optical_flow_tpu_torch.utils.checkpoint import \
    save_npz_tree
from sd_animation_optical_flow_tpu_torch.utils.tree import (tree_leaves,
                                                            tree_map)
from torch_port_common import np_t, rel_err, to_port

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96
FIELDS = ("img1", "img2", "flow", "valid", "occluded", "disoccluded")
CFGS = {
    "tiny": JR.RAFTConfig(iters=2, corr_levels=2, corr_radius=2, small=True),
    "full": JR.RAFTConfig(corr_dtype="float32", iters=2),
}


def _port_cfg(cfg):
    return TR.RAFTConfig(**cfg.__dict__)


def _jax_raft(cfg, seed=1):
    with numpy_init():
        return JR.raft_init(jax.random.PRNGKey(seed), cfg)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        return [p for k in a for p in _pairs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [p for i in range(len(a))
                for p in _pairs(a[i], b[i], f"{path}/{i}")]
    return [(path, a, b)]


def _scene_close(port, ref, what):
    """Images within 1e-3 (0-255 scale), flow within 1e-4 px, valid /
    occluded / disoccluded equal."""
    for name, t, r in zip(FIELDS, port, ref):
        t = t.cpu().numpy()
        assert t.shape == r.shape and t.dtype == r.dtype, (what, name)
        if name in ("img1", "img2"):
            err = np.abs(t.astype(np.float64) - r).max()
            assert err <= 1e-3, (what, name, err)
        elif name == "flow":
            err = np.abs(t.astype(np.float64) - r).max()
            assert err <= 1e-4, (what, name, err)
        else:
            assert np.array_equal(t, r), (what, name)


# ---------------------------------------------------------------------------
# synthetic scenes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(32, 40), (64, 96)])
def test_render_scene_matches_jax(h, w):
    """Six seeds, plus the fixed-amplitude / fixed-shift variant."""
    for seed in range(6):
        ref = JSF.render_scene(np.random.default_rng(seed), h, w)
        out = TSF.render_scene(np.random.default_rng(seed), h, w,
                               device="cpu")
        _scene_close(out, ref, (h, w, seed))
    kw = dict(bg_amp=4.5, fg_shift=(-7.5, 3.25))
    ref = JSF.render_scene(np.random.default_rng(7), h, w, **kw)
    out = TSF.render_scene(np.random.default_rng(7), h, w, device="cpu",
                           **kw)
    _scene_close(out, ref, (h, w, "fixed"))


def test_synthetic_batch_matches_jax():
    """One generator drawn across a batch of 3 (the draws continue from
    scene to scene)."""
    ref = JSF.synthetic_batch(np.random.default_rng(5), 3, H, W)
    out = TSF.synthetic_batch(np.random.default_rng(5), 3, H, W,
                              device="cpu")
    _scene_close(out, ref, "batch")


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_prefetcher_matches_jax(workers):
    """The first two batches of seed 11 (batch 2, 32x40) equal JAX's
    stream (its per-scene SeedSequence children), for any worker count,
    within the scene tolerances; the wait time is counted."""
    ref = JUP._batch_prefetcher(11, 3, 2, 32, 40, workers=2)
    pre = TUP._batch_prefetcher(11, 3, 2, 32, 40, workers=workers,
                                device="cpu")
    got = iter(pre)
    for _ in range(2):
        _scene_close(next(got), next(ref), workers)
    assert pre.wait_s >= 0.0
    got.close()


def test_bilinear_field_and_inversion_match_jax(np_rng):
    """smooth_field, invert_field and multiscale_texture alone: the field
    within 1e-9 px (float64 on both sides), the inverse within 1e-5 px,
    the texture within 1e-3."""
    f_ref = JSF.smooth_field(np.random.default_rng(3), 40, 56, scale=8,
                             amplitude=6.0)
    f = TSF.smooth_field(np.random.default_rng(3), 40, 56, scale=8,
                         amplitude=6.0, device="cpu")
    assert f.dtype == torch.float64 and np.abs(f.numpy() - f_ref).max() < 1e-9
    inv = TSF.invert_field(f).numpy()
    assert np.abs(inv - JSF.invert_field(f_ref)).max() < 1e-5
    tex = TSF.multiscale_texture(np.random.default_rng(4), 40, 56,
                                 device="cpu").numpy()
    assert np.abs(tex - JSF.multiscale_texture(np.random.default_rng(4), 40,
                                               56)).max() < 1e-3


# ---------------------------------------------------------------------------
# losses and the optimizer
# ---------------------------------------------------------------------------

def test_sequence_loss_matches_jax(np_rng):
    """Loss and metrics within 1e-5 relative, at gamma 0.8 and 0.5, with
    invalid pixels and flows beyond max_flow masked out."""
    preds = np_rng.normal(0, 3, (4, 2, 16, 24, 2)).astype(np.float32)
    gt = np_rng.normal(0, 3, (2, 16, 24, 2)).astype(np.float32)
    gt[0, :2] = 500.0                                   # beyond max_flow
    preds[:, 1, 3:5] = gt[None, 1, 3:5] + 0.4           # inside 1 px
    valid = (np_rng.random((2, 16, 24)) > 0.2).astype(np.float32)
    for gamma in (0.8, 0.5):
        jl, jm = JFT.sequence_loss(jnp.asarray(preds), jnp.asarray(gt),
                                   jnp.asarray(valid), gamma=gamma)
        tl, tm = TFT.sequence_loss(np_t(preds), np_t(gt), np_t(valid),
                                   gamma=gamma)
        assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
        assert set(tm) == set(jm)
        for k in jm:
            assert abs(tm[k].item() - float(jm[k])) <= \
                1e-5 * max(abs(float(jm[k])), 1e-3), (k, gamma)


def test_uncertainty_nll_loss_matches_jax(np_rng):
    """The Laplace NLL, error / scale correlation and mean scale within
    1e-5 relative (the 1/8 scale upsampled 8x)."""
    log_b = np_rng.normal(0, 1, (2, 4, 6)).astype(np.float32)
    up = np_rng.normal(0, 2, (2, 32, 48, 2)).astype(np.float32)
    gt = up + np_rng.laplace(0, 0.7, up.shape).astype(np.float32)
    valid = (np_rng.random((2, 32, 48)) > 0.1).astype(np.float32)
    jn, jm = JFT.uncertainty_nll_loss(jnp.asarray(log_b), jnp.asarray(up),
                                      jnp.asarray(gt), jnp.asarray(valid))
    tn, tm = TFT.uncertainty_nll_loss(np_t(log_b), np_t(up), np_t(gt),
                                      np_t(valid))
    assert abs(tn.item() - float(jn)) <= 1e-5 * abs(float(jn))
    for k in jm:
        assert abs(tm[k].item() - float(jm[k])) <= \
            1e-5 * abs(float(jm[k])), k


def test_flow_optimizer_matches_optax(np_rng):
    """make_flow_optimizer against JAX's (clip_by_global_norm(1) then
    adamw(4e-4, weight_decay 1e-4)) on the same gradients, three steps,
    with gradient norms below and above the clip: every parameter (all of
    magnitude below 4) within 1e-6, a few f32 steps and 1/400 of the
    learning rate."""
    shapes = [(5, 7), (11,), (3, 3, 4, 2)]
    for scale in (1e-3, 10.0):
        p0 = [np_rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads = [[(np_rng.standard_normal(s) * scale).astype(np.float32)
                  for s in shapes] for _ in range(3)]
        tx = JFT.make_flow_optimizer()
        jp = [jnp.asarray(a) for a in p0]
        st = tx.init(jp)
        for g in grads:
            upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
            jp = optax.apply_updates(jp, upd)
        tp = [torch.tensor(a, requires_grad=True) for a in p0]
        opt = TFT.make_flow_optimizer()(tp)
        for g in grads:
            for p, a in zip(tp, g):
                p.grad = torch.tensor(a)
            opt.step()
        for a, b in zip(tp, jp):
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() \
                <= 1e-6, scale


# ---------------------------------------------------------------------------
# the RAFT train step
# ---------------------------------------------------------------------------

# Adam normalises each element's step to about +-lr whatever its size, so
# an element whose gradient is f32 noise (a bias before an instance norm,
# a ReLU or L1 kink) steps with a noise-given sign in each framework, and
# those differences grow step by step; eps 1e-3 damps every element whose
# gradient lies below it and leaves the large ones' steps sign-normalised
STEP_EPS = 1e-3
STEP_LR = 4e-4


@pytest.fixture(scope="module")
def flow_batch():
    return JSF.synthetic_batch(np.random.default_rng(0), 2, H, W)[:4]


@pytest.mark.parametrize("name", list(CFGS))
def test_flow_loss_and_grads_match_jax(flow_batch, name):
    """``flow_loss`` (raft_apply with all iterations, then the sequence
    loss) and its gradient against JAX's step objective under
    ``value_and_grad``: the loss and metrics within 1e-5 relative, every
    gradient leaf within 1e-4 of the tree's largest gradient; a leaf
    whose JAX values all lie below 1e-6 of it (a bias before an instance
    norm: structurally zero, f32 noise on both sides) stays below that
    floor. The batch-norm mean / var leaves get gradients."""
    cfg = CFGS[name]
    jp = _jax_raft(cfg)
    im1, im2, gt, valid = flow_batch

    def loss_fn(p):
        _, fu = JR.raft_apply(p, cfg, im1, im2, iters=2, all_iters=True)
        return JFT.sequence_loss(fu, gt, valid)
    (jl, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tp = tree_map(lambda t: t.requires_grad_(), to_port(jp))
    tl, tm = TFT.flow_loss(tp, _port_cfg(cfg), np_t(im1), np_t(im2),
                           np_t(gt), np_t(valid), iters=2)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for k in jm:
        assert abs(tm[k].item() - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    pairs = _pairs(tp, to_port(jg))
    top = max(float(b.abs().max()) for _, _, b in pairs)
    for path, a, b in pairs:
        g = a.grad.numpy()
        if float(b.abs().max()) < 1e-6 * top:
            assert np.abs(g).max() < 1e-6 * top, path
            continue
        err = float(np.abs(g - b.numpy()).max())
        assert err <= 1e-4 * top, (path, err / top)
    if name == "full":
        bn = tp["cnet"]["norm1"]
        assert bn["mean"].grad.abs().max() > 0 and \
            bn["var"].grad.abs().max() > 0


@pytest.mark.parametrize("name", list(CFGS))
def test_flow_train_steps_match_jax(flow_batch, name):
    """Three ``flow_train_step``s (clip by global norm 1, AdamW lr 4e-4,
    weight decay 1e-4, eps ``STEP_EPS``) against JAX's jitted step: the
    loss within 1e-5 relative each step, and every parameter after three
    steps within a quarter of the learning rate of JAX's; each batch-norm
    leaf (scale, bias, mean, var) moved, by JAX's update within 10%
    (their steps are as small as 1/100 of the learning rate). The clip
    binds (the first gradient's global norm is over 1)."""
    cfg = CFGS[name]
    jp = _jax_raft(cfg)
    im1, im2, gt, valid = flow_batch
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(STEP_LR, weight_decay=1e-4, eps=STEP_EPS))
    jstate = JFT.init_flow_train_state(jp, tx)
    state = TFT.init_flow_train_state(
        to_port(jp), lambda leaves: TFT.ClipAdamW(
            leaves, lr=STEP_LR, weight_decay=1e-4, eps=STEP_EPS))
    args = (np_t(im1), np_t(im2), np_t(gt), np_t(valid))
    loss, _ = TFT.flow_loss(state.params, _port_cfg(cfg), *args, iters=2)
    norm = torch.stack([g.pow(2).sum() for g in torch.autograd.grad(
        loss, tree_leaves(state.params))]).sum().sqrt()
    assert norm.item() > 1.0, norm
    for i in range(3):
        jstate, jl, _ = JFT.flow_train_step(jstate, cfg, tx, im1, im2, gt,
                                            valid, iters=2)
        state, tl, _ = TFT.flow_train_step(state, _port_cfg(cfg), *args,
                                           iters=2)
        assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl)), i
    assert state.step == 3
    start = to_port(jp)
    for (path, a, b), (_, s, _) in zip(
            _pairs(state.params, to_port(jstate.params)),
            _pairs(start, start)):
        err = float((a.detach() - b).abs().max())
        assert err <= 0.25 * STEP_LR, (path, err / STEP_LR)
        if "/norm" in path:        # the context encoder's batch norms
            moved = float((b - s).abs().max())
            assert moved > 0 and err <= 0.1 * moved, (path, err / moved)


def test_train_raft_synthetic_matches_jax():
    """Stage 1's loop, two steps of the tiny RAFT from the same weights on
    the prefetched stream of seed 4 (batch 2, 32x48, JAX's default
    optimizer at lr 2e-4): the final metrics within 1e-4 relative (the
    second step's forward sees the first update), the returned parameters
    detached and moved; the stage-2 loop on the result
    runs two head steps to finite metrics (its random init is each
    framework's own)."""
    cfg = CFGS["tiny"]
    jp = _jax_raft(cfg)
    kw = dict(steps=2, batch=2, h=32, w=48, iters=2, seed=4)
    _, jm = JUP.train_raft_synthetic(cfg, init_params=jp, **kw)
    logs = []
    tparams, tm = TUP.train_raft_synthetic(
        _port_cfg(cfg), init_params=to_port(jp), log=logs.append,
        device="cpu", **kw)
    assert set(tm) == set(jm) and len(logs) == 2
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-4 * max(abs(jm[k]), 1e-2), k
    # the parameters themselves are held to JAX's in
    # test_flow_train_steps_match_jax: at Adam's eps 1e-8 a bias before an
    # instance norm (a structurally zero gradient) steps +-lr by noise
    moved = [float((a - s).abs().max()) for _, a, s in
             _pairs(tparams, to_port(jp))]
    assert not any(a.requires_grad for a in tree_leaves(tparams))
    assert max(moved) > 2e-4
    head, hm = TUP.train_head_synthetic(tparams, _port_cfg(cfg), steps=2,
                                        batch=2, h=32, w=48, iters=2,
                                        device="cpu")
    assert head["conv1"]["w"].shape[1] == cfg.hidden_dim + 2
    assert all(np.isfinite(v) for v in hm.values()) and "bce" in hm


# ---------------------------------------------------------------------------
# the uncertainty head's step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact_raft():
    cfg = JR.RAFTConfig(corr_dtype="float32", iters=4)
    jp = load_pytree(TP.ARTIFACTS + "/raft_synth.npz", _jax_raft(cfg))
    tp = TP.load_npz_tree(TP.ARTIFACTS + "/raft_synth.npz", device="cpu")
    with numpy_init():
        jhead = JFC.uncertainty_head_init(jax.random.PRNGKey(2))
    return cfg, jp, tp, jhead


@pytest.mark.parametrize("bce_weight", [0.0, 0.3])
def test_uncertainty_train_steps_match_jax(artifact_raft, bce_weight):
    """Three head steps on the frozen committed RAFT (4 iterations, f32
    storage), batch 2 of 64x96 scenes with their disocclusion masks: the
    loss and metrics (nll, err_scale_corr, mean_b, and bce when its
    weight is on) within 1e-5 relative each step, and every head
    parameter after three steps (lr 1e-3, about +-1e-3 a step each)
    within 2e-3 of the learning rate of JAX's. Adam's eps is 1e-6: at
    1e-8 an element whose gradient is f32 noise steps +-lr with a
    noise-given sign (1.7e-2 of lr apart here)."""
    cfg, jp, tp, jhead = artifact_raft
    im1, im2, gt, valid, _, dis = JSF.synthetic_batch(
        np.random.default_rng(3), 2, H, W)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-3, weight_decay=1e-4, eps=1e-6))
    jstate = JFT.init_flow_train_state(jhead, tx)
    state = TFT.init_flow_train_state(
        to_port(jhead), lambda leaves: TFT.ClipAdamW(
            leaves, lr=1e-3, weight_decay=1e-4, eps=1e-6))
    args = [np_t(a) for a in (im1, im2, gt, valid)]
    for i in range(3):
        jstate, jl, jm = JFT.uncertainty_train_step(
            jstate, jp, cfg, tx, im1, im2, gt, valid, iters=4,
            disoccluded=dis, bce_weight=bce_weight)
        state, tl, tm = TFT.uncertainty_train_step(
            state, tp, _port_cfg(cfg), *args, iters=4,
            disoccluded=torch.from_numpy(dis), bce_weight=bce_weight)
        assert set(tm) == set(jm) and ("bce" in tm) == (bce_weight > 0)
        assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl)), i
        for k in jm:
            assert abs(tm[k].item() - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), (i, k)
    for path, a, b in _pairs(state.params, to_port(jstate.params)):
        err = float((a.detach() - b).abs().max())
        assert err <= 2e-3 * 1e-3, (path, err)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def test_eval_epe_matches_jax(artifact_raft):
    """The held-out EPE (seed 999) over 2 and 5 scenes (one and two
    chunks of 4) at 64x96, 4 iterations: within 1e-4 px (JAX runs its
    RAFT op by op here, ~18 s)."""
    cfg, jp, tp, _ = artifact_raft
    for n in (2, 5):
        ref = JUP.eval_epe(jp, cfg, n_scenes=n, h=H, w=W)
        out = TUP.eval_epe(tp, _port_cfg(cfg), n_scenes=n, h=H, w=W,
                           device="cpu")
        assert abs(out - ref) <= 1e-4, (n, out, ref)


def test_evaluate_masks_matches_jax(artifact_raft):
    """evaluate_masks (seed 12345, margin 12) on 2 scenes at 64x96 with
    the committed pair, 4 iterations: every recall, false rate and AUROC
    of fb / learned / min within 1e-3."""
    cfg, jp, tp, _ = artifact_raft
    jhead = load_pytree(TP.ARTIFACTS + "/uncertainty_head_synth.npz",
                        JFC.uncertainty_head_init(jax.random.PRNGKey(0)))
    thead = TP.load_npz_tree(TP.ARTIFACTS + "/uncertainty_head_synth.npz",
                             device="cpu")
    ref = JUP.evaluate_masks(jp, jhead, cfg, n_scenes=2, h=H, w=W)
    out = TUP.evaluate_masks(tp, thead, _port_cfg(cfg), n_scenes=2, h=H,
                             w=W, device="cpu")
    assert set(out) == set(ref) == {"fb", "learned", "min"}
    for mode in ref:
        assert set(out[mode]) == set(ref[mode])
        for k, v in ref[mode].items():
            assert abs(out[mode][k] - v) <= 1e-3, (mode, k, out[mode][k], v)


def test_flow_eval_matches_jax(artifact_raft):
    """flow_eval.evaluate over an in-memory list of 3 samples, 60x90
    (padded to 64x96) and 64x96, one with no valid pixel, 4 iterations:
    EPE within 1e-4 px, the px rates within 1e-3, n equal; max_samples
    cuts the list."""
    cfg, jp, tp, _ = artifact_raft
    scenes = [JSF.render_scene(np.random.default_rng(s), 64, 96)
              for s in range(3)]
    ds = [(s.img1, s.img2, s.flow, s.valid) for s in scenes]
    ds[1] = tuple(a[:60, :90] for a in ds[1])
    ds[2] = ds[2][:3] + (np.zeros_like(ds[2][3]),)
    for kw in ({}, {"max_samples": 2}):
        ref = JFE.evaluate(jp, cfg, ds, iters=4, **kw)
        out = TFE.evaluate(tp, _port_cfg(cfg), ds, iters=4, device="cpu",
                           **kw)
        assert out["n"] == ref["n"]
        assert abs(out["epe"] - ref["epe"]) <= 1e-4
        for k in ("1px", "3px", "5px"):
            assert abs(out[k] - ref[k]) <= 1e-3, k


# ---------------------------------------------------------------------------
# the npz writer
# ---------------------------------------------------------------------------

def test_save_npz_tree_reads_back_in_jax(tmp_path, np_rng):
    """A port-initialised full RAFT (random, seeded) written by
    save_npz_tree and read by JAX's load_pytree: raft_apply on both sides
    (4 iterations, f32 storage) within 1e-4 px, and params_to_jax inverts
    params_from_jax leaf for leaf (equal)."""
    cfg = JR.RAFTConfig(corr_dtype="float32", iters=4)
    tp = TR.raft_init(Init(torch.Generator().manual_seed(5)), _port_cfg(cfg))
    tp = tree_map(lambda t: t.contiguous(memory_format=torch.channels_last)
                  if t.dim() == 4 else t, tp)
    path = str(tmp_path / "raft.npz")
    save_npz_tree(path, tp)
    jp = load_pytree(path, _jax_raft(cfg))
    scene = JSF.synthetic_batch(np_rng, 1, H, W)
    ref = JR.raft_apply(jp, cfg, scene[0], scene[1])
    out = TR.raft_apply(tp, _port_cfg(cfg), np_t(scene[0]), np_t(scene[1]))
    assert float(np.abs(out[1].numpy() - np.asarray(ref[1])).max()) < 1e-4
    back = TP.params_from_jax(TP.params_to_jax(tp), device="cpu")
    for path_, a, b in _pairs(tp, back):
        assert torch.equal(a, b), path_


def test_committed_pair_round_trips_bit_equal(tmp_path):
    """The committed raft_synth.npz (float16) and uncertainty_head_synth.npz
    (float32) read by the port and written back by save_npz_tree: the
    same keys in the same order, every array equal in dtype and bits; and
    load_flow_estimator reads the written pair through raft_path /
    head_path as it reads the default."""
    paths = {}
    for name, dtype in (("raft_synth.npz", np.float16),
                        ("uncertainty_head_synth.npz", None)):
        src = TP.ARTIFACTS + "/" + name
        paths[name] = str(tmp_path / name)
        save_npz_tree(paths[name], TP.load_npz_tree(src, device="cpu"),
                      dtype=dtype)
        with np.load(src) as a, np.load(paths[name]) as b:
            assert a.files == b.files, name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and \
                    a[k].tobytes() == b[k].tobytes(), (name, k)
    default = TP.load_flow_estimator(device="cpu")
    est = TP.load_flow_estimator(raft_path=paths["raft_synth.npz"],
                                 head_path=paths["uncertainty_head_synth.npz"],
                                 device="cpu")
    for tree in ("params", "head_params"):
        for path_, a, b in _pairs(getattr(est, tree),
                                  getattr(default, tree)):
            assert torch.equal(a, b), (tree, path_)


def test_512x768_pair_reads_the_same_in_jax():
    """The pair trained at 512x768 (``artifacts/raft_synth_512x768.npz``,
    ``uncertainty_head_synth_512x768.npz``, written by
    train_flow_torch.py) through each side's fb estimator at 256x384 (20
    iterations, f32 storage) on a (-3, +2) px shift of a synthetic
    texture: flow within 1e-4 px and confidence within 1e-4 of JAX, so
    the EPE each reads (printed) is the pair's, not the port's."""
    paths = [f"{TP.ARTIFACTS}/{n}_512x768.npz"
             for n in ("raft_synth", "uncertainty_head_synth")]
    cfg = JR.RAFTConfig(corr_dtype="float32")
    je = JFC.FlowConfidenceEstimator(load_pytree(paths[0], _jax_raft(cfg)),
                                     JFC.FlowConfidenceConfig(raft=cfg))
    te = TP.load_flow_estimator(TFC.FlowConfidenceConfig(raft=_port_cfg(cfg)),
                                raft_path=paths[0], head_path=paths[1],
                                device="cpu")
    tex = JSF.multiscale_texture(np.random.default_rng(0), 288, 416)
    src, tgt = tex[16:272, 16:400], tex[18:274, 13:397]
    jf, jc, _ = je.calc_batch(src[None], tgt[None])
    tf, tc, _ = te.calc_batch(src[None], tgt[None])
    assert np.abs(tf - jf).max() < 1e-4 and np.abs(tc - jc).max() < 1e-4
    for name, f in (("jax", jf), ("port", tf)):
        inner = f[0, 16:-16, 16:-16] - np.array([-3.0, 2.0])
        print(f"\n[512x768 pair at 256x384] {name}: interior EPE "
              f"{np.sqrt((inner ** 2).sum(-1)).mean():.4f} px")


def test_flow_training_runs_without_jax(tmp_path):
    """The new modules import and run (a scene, a prefetched batch, one
    tiny train step, one head step, the writer), and train_flow_torch.py
    imports, in a fresh interpreter with JAX made unimportable."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'optax',\n"
        "          'sd_animation_optical_flow_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import numpy as np, torch\n"
        "import sd_animation_optical_flow_tpu_torch as M\n"
        "from sd_animation_optical_flow_tpu_torch.models import (flowconf,\n"
        "    raft)\n"
        "from sd_animation_optical_flow_tpu_torch.models.layers import Init\n"
        "from sd_animation_optical_flow_tpu_torch.training import (\n"
        "    flow_eval, flow_train as FT, synthetic_flow,\n"
        "    uncertainty_pretrain)\n"
        "from sd_animation_optical_flow_tpu_torch.utils import checkpoint\n"
        "cfg = raft.RAFTConfig(iters=2, corr_levels=2, corr_radius=2, "
        "small=True)\n"
        "b = next(iter(uncertainty_pretrain._batch_prefetcher(0, 1, 2, 32, "
        "40, device='cpu')))\n"
        "init = Init(torch.Generator().manual_seed(0))\n"
        "st = FT.init_flow_train_state(raft.raft_init(init, cfg), "
        "FT.make_flow_optimizer())\n"
        "st, loss, m = FT.flow_train_step(st, cfg, *b[:4], iters=2)\n"
        "hs = FT.init_flow_train_state(flowconf.uncertainty_head_init(init, "
        "cfg.hidden_dim), FT.make_flow_optimizer())\n"
        "hs, hl, _ = FT.uncertainty_train_step(hs, st.params, cfg, *b[:4], "
        "iters=2, disoccluded=b[5], bce_weight=0.3)\n"
        f"checkpoint.save_npz_tree({str(tmp_path / 'r.npz')!r}, st.params)\n"
        "assert M.render_scene is synthetic_flow.render_scene\n"
        "import train_flow_torch\n"
        "assert train_flow_torch.parse_args([]).batch == 4\n"
        "assert torch.isfinite(loss) and torch.isfinite(hl) and st.step == 1\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
