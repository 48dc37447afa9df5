"""Gloo ranks for the port's multi-rank CPU tests
(``tests/test_torch_parallel*.py``). This module imports torch and the
port only, never JAX: each rank is a spawned process that joins a gloo
process group over a ``file://`` store, runs jobs of this module on the
inputs the test wrote, and saves its results; the test then holds them
to the JAX package in its own process.

A job is a function of this module ``job(rank, inputs) -> result``
(nested dicts / lists of tensors, numpy arrays and plain values).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SPAWN_TIMEOUT_S = 240


class Ranks:
    """``world`` gloo ranks running every job of ``jobs`` (names of this
    module's functions), in order, inside one process group, started at
    construction; :meth:`results` waits for them. ``inputs`` go to each
    job (saved once with ``torch.save``). Several can run at once, each
    with its own ``workdir``."""

    def __init__(self, world: int, workdir, jobs, inputs):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.jobs = list(jobs)
        torch.save(inputs, self.workdir / "inputs.pt")
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(rank, world,
                                        str(self.workdir / "store"),
                                        str(self.workdir), self.jobs))
                      for rank in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        """{job: [result of rank 0, rank 1, ...]}; raises with the rank's
        traceback when a rank failed."""
        for p in self.procs:
            p.join(SPAWN_TIMEOUT_S)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        for r, p in enumerate(self.procs):
            err = self.workdir / f"error_{r}.txt"
            if err.exists():
                raise RuntimeError(f"rank {r} failed:\n{err.read_text()}")
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with {p.exitcode}")
        per_rank = [torch.load(self.workdir / f"result_{r}.pt",
                               weights_only=False)
                    for r in range(len(self.procs))]
        return {job: [res[job] for res in per_rank] for job in self.jobs}


def _rank_main(rank, world, store, workdir, jobs):
    torch.set_num_threads(1)
    workdir = Path(workdir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        results = {job: globals()[job](rank, inputs) for job in jobs}
        torch.save(results, workdir / f"result_{rank}.pt")
    except BaseException:
        (workdir / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else x


def _sp():
    from sd_animation_optical_flow_tpu_torch.models.unet import \
        SeqParallelConfig
    from sd_animation_optical_flow_tpu_torch.parallel.mesh import make_mesh
    return SeqParallelConfig(make_mesh(device_type="cpu"), "dp")


# ---------------------------------------------------------------------------
# jobs: the mesh, attention, the row-sharded layers, the UNet
# ---------------------------------------------------------------------------

def mesh_checks(rank, inputs):
    """make_mesh over the group, and its refusal of a world size that
    differs; shard_batch / gather_batch and replicate_tree."""
    from sd_animation_optical_flow_tpu_torch.parallel import mesh as M
    world = dist.get_world_size()
    mesh = M.make_mesh(device_type="cpu")
    out = {"shape": tuple(mesh.mesh.shape),
           "names": tuple(mesh.mesh_dim_names)}
    try:
        M.make_mesh(dp=world + 1, device_type="cpu")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    x = torch.arange(world * 3.0).reshape(world * 3, 1)
    out["shard"] = _np(M.shard_batch(x, mesh))
    out["gathered"] = _np(M.gather_batch(M.shard_batch(x, mesh), mesh))
    tree = {"w": torch.full((2,), float(rank)), "l": [torch.tensor([rank])]}
    M.replicate_tree(tree, mesh)
    out["replicated"] = [_np(tree["w"]), tree["l"][0].item()]
    return out


def attention_jobs(rank, inputs):
    """Ring and Ulysses attention (plain, and with the MFR strip attention
    as the inner ``attn_fn`` in both modes) on this rank's token slice;
    returns each local output."""
    from sd_animation_optical_flow_tpu_torch.ops.attention import \
        strip_attention
    from sd_animation_optical_flow_tpu_torch.parallel.ring_attention import \
        ring_attention, ulysses_attention
    sp = _sp()
    world = dist.get_world_size()
    out = {}
    for name, case in inputs["attention"].items():
        q, k, v = (torch.from_numpy(case[t]) for t in "qkv")
        nl = q.shape[1] // world
        q, k, v = (t[:, rank * nl:(rank + 1) * nl] for t in (q, k, v))
        if name == "ring":
            o = ring_attention(q, k, v, sp.mesh)
        elif name == "ulysses":
            o = ulysses_attention(q, k, v, sp.mesh)
        else:
            h, w_strip, n_tiles, mode = case["strip"]
            o = ulysses_attention(
                q, k, v, sp.mesh, attn_fn=lambda a, b, c: strip_attention(
                    a, b, c, h=h, w_strip=w_strip, n_tiles=n_tiles,
                    mode=mode))
        out[name] = _np(o)
    try:
        ulysses_attention(q[:, :, :1], k[:, :, :1], v[:, :, :1], sp.mesh)
        out["odd_heads"] = None
    except ValueError as e:
        out["odd_heads"] = str(e)
    return out


def layer_jobs(rank, inputs):
    """The row-sharded convolutions (3 x 3 stride 1 SAME, the stride-2
    down convolution, 1 x 1, the upsampling one) and GroupNorm on this
    rank's rows, gathered to whole tensors."""
    from sd_animation_optical_flow_tpu_torch.parallel import spatial as S
    sp = _sp()
    case = inputs["layers"]
    x = S.shard_rows(torch.from_numpy(case["x"]), sp)
    p3, p1 = case["conv3"], case["conv1"]
    return {
        "conv3": _np(S.gather(S.conv2d(p3, x, sp), sp)),
        "down": _np(S.gather(S.conv2d(p3, x, sp, stride=2, padding=1),
                             sp)),
        "conv1": _np(S.gather(S.conv2d(p1, x, sp), sp)),
        "up": _np(S.gather(S.upsample2x_conv(p3, x, sp), sp)),
        "norm": _np(S.gather(S.group_norm(case["norm"], x, sp,
                                          num_groups=4), sp)),
    }


def unet_jobs(rank, inputs):
    """``unet_apply(sp=)`` with ControlNet residuals and K/V capture, the
    same call without capture, and its refusals."""
    from sd_animation_optical_flow_tpu_torch.models import unet as U
    sp = _sp()
    case = inputs["unet"]
    cfg, params = case["cfg"], case["params"]
    args = [torch.from_numpy(case[k]) for k in ("x", "t", "ctx")]
    control = tuple(torch.from_numpy(c) for c in case["control"])
    out, kv = U.unet_apply(params, cfg, *args, control=control, sp=sp)
    out2, kv2 = U.unet_apply(params, cfg, *args, control=control, sp=sp,
                             capture_kv=False)
    refusals = []
    for kw in ({"ref_kv": (None,) * 16}, {"attn_biases": {}},
               {"context_pair": (args[2], args[2])}):
        try:
            U.unet_apply(params, cfg, *args, sp=sp, **kw)
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    return {"out": _np(out), "kv": [(_np(k), _np(v)) for k, v in kv],
            "same_without_capture": bool(torch.equal(out, out2)),
            "kv_without_capture": kv2, "refusals": refusals}


# ---------------------------------------------------------------------------
# jobs: the pipelines
# ---------------------------------------------------------------------------

def _noise_patches(case):
    """The facades' noise draws replaced by the case's noises (the JAX
    program's, which the test rebuilt for each latent shape)."""
    from unittest import mock

    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    kw = {}
    if "img2img_noise" in case:
        kw["draw_img2img_noise"] = lambda gen, shape, *a, **k: \
            case["img2img_noise"][tuple(shape)]
    if "inpaint_noise" in case:
        kw["draw_inpaint_noise"] = lambda gen, shape, *a, **k: \
            case["inpaint_noise"][tuple(shape)]
    return mock.patch.multiple(F, **kw)


def strip_img2img(rank, inputs):
    """The strip img2img (2 tiles, 'target') with ``sp`` and K/V capture."""
    from sd_animation_optical_flow_tpu_torch.models.unet import StripConfig
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    case = inputs["strip_img2img"]
    with _noise_patches(case):
        out, kv = F.img2img(case["sd"], torch.from_numpy(case["img"]), "a",
                            "b", 0.4, ddim_steps=4, seed=3,
                            strip=StripConfig(2, "target"), sp=_sp(),
                            capture_kv=True)
    return {"out": _np(out), "kv": [(_np(k), _np(v)) for k, v in kv]}


def inpaint_batch(rank, inputs):
    """``img2img_inpaint_batch`` with ``mesh`` (dp = the world size), a
    per-frame reference_kv and K/V capture."""
    from sd_animation_optical_flow_tpu_torch.parallel.mesh import make_mesh
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    case = inputs["inpaint_batch"]
    ref_kv = tuple((torch.from_numpy(k), torch.from_numpy(v))
                   for k, v in case["reference_kv"])
    with _noise_patches(case):
        out, kv = F.img2img_inpaint_batch(
            case["sd9"], case["imgs"], case["texts"], "n", case["masks"],
            case["refs"], denoising_strength=0.3, ddim_steps=4, mask_blur=0,
            seed=11, mesh=make_mesh(device_type="cpu"),
            reference_kv=ref_kv, capture_kv=True)
    return {"out": _np(out), "kv": [(_np(k), _np(v)) for k, v in kv]}


def _files(d):
    return {name: (Path(d) / name).read_bytes()
            for name in sorted(os.listdir(d))} if os.path.isdir(d) else None


def run_batched_dp(rank, inputs):
    """``pixel_inpaint.run_batched`` with dp = the world size, each rank
    into a directory of its own; then, on rank 0, the same frames at dp 0
    with the frame batch of one rank (the CPU's f32 rounding depends on
    a call's batch, so the two runs give each call the same one). Returns
    the files each run wrote."""
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    case = inputs["run_batched"]
    world = dist.get_world_size()
    run = lambda save_dir, fb, dp: PI.run_batched(
        iter(case["triples"]), save_dir, case["sd"], case["sd9"],
        case["est"], cfg=PI.PixelInpaintConfig(
            frame_batch=fb, dp=dp, flow_chunk=case["per_rank"], **case["kw"]))
    out_dir = run(f"{case['dir']}/rank{rank}", case["per_rank"] * world,
                  world)
    dp0 = _files(run(f"{case['dir']}/dp0", case["per_rank"], 0)) \
        if rank == 0 else None
    return {"out_dir": out_dir, "files": _files(out_dir), "dp0": dp0}


def seed_strip(rank, inputs):
    """The keyframe pipeline's seed strip (2 frames, 'mutual') with
    ``cfg.sp``, in a workspace of this rank's own."""
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        keyframe_inpaint as KI
    case = inputs["seed_strip"]
    kw = case["kw"]
    ws = KI.VideoWorkspace(f"{case['dir']}/rank{rank}", frames=case["frames"],
                           size=kw["size"], keep_every=1, device="cpu")
    cfg = KI.KeyframeInpaintConfig(sp=_sp(), **kw)
    with _noise_patches(case):
        frames, kv = KI.generate_seed_frames(case["sd"], None, ws,
                                             KI.FrameIndices(case["seeds"]),
                                             cfg)
    return {"frames": frames, "kv_shapes": [tuple(k.shape) for k, _ in kv]}


# ---------------------------------------------------------------------------
# jobs: tensor x data parallelism (parallel/sharding.py, unet_apply(tp=),
# the sharded train step)
# ---------------------------------------------------------------------------

def _tp_mesh(tp=2):
    from sd_animation_optical_flow_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(dp=dist.get_world_size() // tp, tp=tp,
                     device_type="cpu")


def tp_jobs(rank, inputs):
    """On a (world / 2, 2) ('dp', 'tp') mesh: the specs, shard_params then
    gather_params (equal to the input, bit for bit), this rank's local
    GEGLU rows of the first transformer block, the tp forward of the
    whole batch (each 'dp' rank its slice, gathered over 'dp'), a stepped
    AdamW state (``make_optimizer``'s) through ``shard_train_state``
    (whether its class, hyperparameters, step counts and gathered moments
    are the whole state's), and the refusals (heads off the mesh, tp with
    sp)."""
    import dataclasses

    from sd_animation_optical_flow_tpu_torch.models import unet as U
    from sd_animation_optical_flow_tpu_torch.parallel import mesh as M
    from sd_animation_optical_flow_tpu_torch.parallel import sharding as SH
    from sd_animation_optical_flow_tpu_torch.training import train_step as TT
    from sd_animation_optical_flow_tpu_torch.utils.tree import (tree_leaves,
                                                                tree_map)
    case = inputs["tp"]
    cfg, params = case["cfg"], case["params"]
    mesh = _tp_mesh()
    tp = U.TensorParallelConfig(mesh)
    local, specs = SH.shard_params(params, mesh)
    back = SH.gather_params(local, specs, mesh)
    x, t, ctx = (M.shard_batch(torch.from_numpy(case[k]), mesh)
                 for k in ("x", "t", "ctx"))
    out, _ = U.unet_apply(local, cfg, x, t, ctx, tp=tp)
    refusals = []
    for kw in ({"cfg": dataclasses.replace(cfg, num_heads=1)},
               {"sp": U.SeqParallelConfig(mesh, "dp")}):
        try:
            U.unet_apply(local, kw.get("cfg", cfg), x, t, ctx, tp=tp,
                         sp=kw.get("sp"))
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    whole = TT.init_train_state(params)
    for p in tree_leaves(whole.params):
        p.grad = torch.full_like(p, 0.01)
    whole.opt.step()
    sharded = TT.shard_train_state(whole, mesh)
    hyper = lambda o: {k: v for k, v in o.param_groups[0].items()
                       if k != "params"}
    adamw = type(sharded.opt) is torch.optim.AdamW \
        and hyper(sharded.opt) == hyper(whole.opt)
    state = lambda s, key: tree_map(lambda p: s.opt.state[p][key], s.params)
    for key in ("exp_avg", "exp_avg_sq", "step"):
        got = state(sharded, key)
        if key != "step":       # the moments gathered; the counts whole
            got = SH.gather_params(got, sharded.specs, mesh)
        adamw &= all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got), tree_leaves(state(whole, key))))
    blk = local["input_blocks"][1]["transformer"]["blocks"][0]
    return {"specs": specs if rank == 0 else None, "adamw_sharded": adamw,
            "round_trip": all(torch.equal(a, b) for a, b in zip(
                tree_leaves(back), tree_leaves(params))),
            "ff_proj": _np(blk["ff_proj"]["w"]),
            "tp_rank": mesh.get_local_rank("tp"),
            "out": _np(M.gather_batch(out, mesh)), "refusals": refusals}


def tp_train(rank, inputs):
    """``shard_train_state`` of ``adamw_with_ema_wings`` on a (world / 2,
    2) mesh, then the sharded ``make_train_step`` on the whole batches:
    from the given params for every batch ("fresh"), and from the given
    state (a port state from ``train_state_from_jax``, carried here by
    its params and ``opt.state_dict()``) for the last batch ("resume").
    Each: the losses, the step counts, the gradients of the whole
    (replicated) leaves after its last step, and on rank 0 the gathered
    params and EMA."""
    import functools

    from sd_animation_optical_flow_tpu_torch.parallel import sharding as SH
    from sd_animation_optical_flow_tpu_torch.training import optim as TO
    from sd_animation_optical_flow_tpu_torch.training import train_step as TT
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_leaves
    case = inputs["train"]
    mesh = _tp_mesh()
    make_opt = functools.partial(TO.adamw_with_ema_wings, **case["opt"])
    step = TT.make_train_step(case["cfg"], case["sched"])
    batches = [tuple(torch.from_numpy(np.asarray(a)) for a in b)
               for b in case["batches"]]
    out = {"tp_rank": mesh.get_local_rank("tp"),
           "dp_rank": mesh.get_local_rank("dp")}
    resume = case["resume"]
    for name, params, first in (("fresh", case["params"], 0),
                                ("resume", resume["params"],
                                 resume["step"])):
        state = TT.init_train_state(params, make_opt)
        if name == "resume":
            state.opt.load_state_dict(resume["opt"])
            state.opt.ema_step, state.step = resume["ema_step"], first
        state = TT.shard_train_state(state, mesh)
        losses = [step(state, *b).item() for b in batches[first:]]
        res = {"losses": losses, "step": state.step,
               "ema_step": state.opt.ema_step,
               "whole_grads": [
                   p.grad.clone() for p, s in zip(
                       tree_leaves(state.params), _spec_leaves(state.specs))
                   if "tp" not in s]}
        whole = SH.gather_params(state.params, state.specs, mesh)
        ema = SH.gather_params(TO.ema_params_of(state.opt, state.params),
                               state.specs, mesh)
        if rank == 0:
            res["params"], res["ema"] = _detached(whole), _detached(ema)
        out[name] = res
    return out


def _spec_leaves(specs):
    """The spec tuples of a spec tree, in leaf order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _detached(tree):
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_map
    return tree_map(lambda x: x.detach().clone(), tree)
