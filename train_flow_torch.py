#!/usr/bin/env python3
"""Train the flow pair, RAFT and its learned uncertainty head, on synthetic
scenes on the card, then evaluate it beside the committed pair.

The port's counterpart of ``cli.py train-uncertainty --size 512x768
--resume-raft artifacts/raft_synth.npz``:

  stage 1  RAFT (``RAFTConfig(corr_dtype="float32")``, ``--train-iters``
           GRU iterations) resumed from ``--resume``, ``--steps`` steps of
           ``flow_train_step`` (clip by global norm 1, AdamW at ``--lr``,
           weight decay 1e-4) on batches of ``--batch`` scenes rendered on
           the card ahead of the step (``uncertainty_pretrain.
           _batch_prefetcher``, seed ``--seed``);
  stage 2  the uncertainty head on the frozen stage-1 RAFT as written
           (float16), ``--head-steps`` steps of ``uncertainty_train_step``
           (Laplace NLL + ``--bce-weight`` x the disocclusion BCE, lr
           ``--head-lr``, seed ``--seed`` + 1).

Checkpoints go to ``--out`` every 200 steps (RAFT in float16, the head in
float32, the JAX package's npz format; the latest of each kept, the final
one renamed to the pair's name), each RAFT checkpoint with its
held-out EPE at the training size and the (-3, +2) px translation EPE at
the training size; a cut call leaves its last checkpoint behind, and
``--resume <checkpoint> --steps 0`` trains the head alone on it. The
final pair is ``raft_synth_<H>x<W>.npz`` and
``uncertainty_head_synth_<H>x<W>.npz``.

Printed: the card's name and power limit, whether TF32 is on, each
stage's s/step over its first 20 steps and over the stage, the share of
the stage the loop waited for scenes, its peak memory, one profiled
step's device busy time and idle share, the loss every 50 steps; then
for both pairs (committed and new) ``eval_epe`` at 128x192 and at the
training size, ``evaluate_masks`` at the training size (fb / learned /
min) and the translation EPE at 128x192, 256x384 and the training size
by chip_smoke's protocol (bf16 storage, 20 iterations, fb, the interior
16 px in), all in one JSON object as the last line.

Run from the repository root on a machine with one NVIDIA card:

    python3 train_flow_torch.py --steps 2000 --out chiprun_out/flow_train
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as S

ROOT = Path(__file__).resolve().parent
CKPT_EVERY = 200
LOG_EVERY = 50
PROFILE_STEP = 25
TRANSLATION_SIZES = ((128, 192), (256, 384))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="512x768",
                    help="training crop HxW (multiples of 8)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=600,
                    help="stage-1 (RAFT) steps; 0 keeps --resume as is")
    ap.add_argument("--head-steps", type=int, default=400)
    ap.add_argument("--train-iters", type=int, default=8,
                    help="RAFT GRU iterations during training")
    ap.add_argument("--lr", type=float, default=4e-4,
                    help="stage-1 (RAFT) learning rate")
    ap.add_argument("--head-lr", type=float, default=1e-3,
                    help="stage-2 (head) learning rate")
    ap.add_argument("--bce-weight", type=float, default=0.3,
                    help="disocclusion-BCE weight on the served confidence "
                         "mapping (0 = pure NLL)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", type=Path,
                    default=ROOT / "artifacts" / "raft_synth.npz",
                    help="RAFT npz that stage 1 starts from")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "flow_train")
    return ap.parse_args(argv)


def _load(path):
    from sd_animation_optical_flow_tpu_torch.config import _channels_last
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
        load_npz_tree
    return _channels_last(load_npz_tree(str(path), device="cuda"))


def translation(raft_path, head_path, sizes):
    """The (-3, +2) px translation through the default estimator (bf16
    storage, 20 iterations, fb): interior EPE and the share of the
    interior with confidence over 0.95, a seeded pair a size."""
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
        load_flow_estimator
    est = load_flow_estimator(raft_path=str(raft_path),
                              head_path=str(head_path), device="cuda")
    out = {}
    with torch.no_grad():
        for h, w in sizes:
            src, tgt = S._shifted_pair(np.random.default_rng(S.SEED + h), h,
                                       w, -3, 2)
            flow, conf, _ = est.calc_batch_device(src[None], tgt[None])
            out[f"{h}x{w}"] = {
                "epe_px": S._epe(flow, -3.0, 2.0),
                "conf_gt_095": (conf[:, 16:-16, 16:-16] > 0.95).float()
                .mean().item()}
    return out


def evaluate_pair(name, raft_path, head_path, cfg, h, w):
    """eval_epe at 128x192 and HxW, evaluate_masks at HxW, and the
    translation at 128x192, 256x384 and HxW."""
    from sd_animation_optical_flow_tpu_torch.training import \
        uncertainty_pretrain as UP
    t0 = time.time()
    raft, head = _load(raft_path), _load(head_path)
    res = {"raft": str(raft_path), "head": str(head_path)}
    for eh, ew in ((128, 192), (h, w)):
        res[f"eval_epe_{eh}x{ew}"] = UP.eval_epe(raft, cfg, h=eh, w=ew,
                                                  device="cuda")
    res[f"masks_{h}x{w}"] = UP.evaluate_masks(raft, head, cfg, h=h, w=w,
                                               device="cuda")
    res["translation"] = translation(raft_path, head_path,
                                     TRANSLATION_SIZES + ((h, w),))
    masks = res[f"masks_{h}x{w}"]
    S.log(f"[eval] {name}: held-out EPE {res['eval_epe_128x192']:.3f} px at "
          f"128x192, {res[f'eval_epe_{h}x{w}']:.3f} px at {h}x{w}; "
          "translation EPE " + ", ".join(
              f"{k} {v['epe_px']:.3f} px (conf > 0.95 on "
              f"{v['conf_gt_095']:.3f})"
              for k, v in res["translation"].items())
          + "; masks at 0.95 " + ", ".join(
              f"{m}: AUROC {r['auroc']:.3f} recall {r['recall@0.95']:.3f} "
              f"false {r['false_rate@0.95']:.3f}" for m, r in masks.items())
          + f" ({time.time() - t0:.1f} s)")
    return res


def run_stage(name, steps, batches, step_fn, checkpoint):
    """Drive ``step_fn(batch) -> (loss, metrics)`` over ``batches``; time
    the first 20 steps after the first and the whole stage, profile step
    ``PROFILE_STEP``, call ``checkpoint(n)`` every ``CKPT_EVERY`` steps and
    at the end (its time is left out of the stage's). Returns the stage's
    summary."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    summary = {"steps": steps, "checkpoints": []}
    t_start = time.perf_counter()
    t_first = None
    aside = 0.0             # checkpoint and profiler seconds
    loss = metrics = None
    for step, batch in enumerate(batches):
        if step == PROFILE_STEP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                loss, metrics = step_fn(batch)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t1)
            res = S.report_profile(prof, wall_ms, f"{name} step", top=10)
            summary["profile_busy_wall_ms"] = res
            summary["profile_idle_share"] = None if res is None else \
                1 - res[0] / res[1]
            aside += time.perf_counter() - t0 - wall_ms / 1e3
        else:
            loss, metrics = step_fn(batch)
        if step == 0:
            torch.cuda.synchronize()
            t_first = time.perf_counter()
            summary["first_step_s"] = t_first - t_start
        if step == 20:
            torch.cuda.synchronize()
            summary["s_per_step_first20"] = \
                (time.perf_counter() - t_first) / 20
            S.log(f"[{name}] s/step over steps 1-20: "
                  f"{summary['s_per_step_first20']:.4f} (step 0: "
                  f"{summary['first_step_s']:.2f} s)")
        if step % LOG_EVERY == 0 or step == steps - 1:
            el = time.perf_counter() - t_start - aside
            S.log(f"[{name}] step {step}: loss {float(loss):.4f} "
                  + " ".join(f"{k} {float(v):.4f}" for k, v in metrics.items())
                  + f" ({el:.0f} s, waited for scenes "
                  f"{batches.wait_s / max(el, 1e-9):.3f} of it)")
        if (step + 1) % CKPT_EVERY == 0 or step == steps - 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary["checkpoints"].append(checkpoint(step + 1))
            aside += time.perf_counter() - t0
    torch.cuda.synchronize()
    el = time.perf_counter() - t_start - aside
    summary.update({
        "seconds": el, "s_per_step": el / max(steps, 1),
        "scene_wait_share": batches.wait_s / max(el, 1e-9),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "final": {"loss": float(loss), **{k: float(v)
                                          for k, v in metrics.items()}}
        if loss is not None else None})
    S.log(f"[{name}] {steps} steps in {el:.1f} s: {summary['s_per_step']:.4f}"
          f" s/step, waited for scenes {summary['scene_wait_share']:.3f} of "
          f"it, peak {summary['peak_gib']:.2f} GiB")
    return summary


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("train_flow_torch: no CUDA device", file=sys.stderr)
        return 2
    from sd_animation_optical_flow_tpu_torch.models import flowconf as FC
    from sd_animation_optical_flow_tpu_torch.models import raft as RF
    from sd_animation_optical_flow_tpu_torch.models.layers import Init
    from sd_animation_optical_flow_tpu_torch.training import flow_train as FT
    from sd_animation_optical_flow_tpu_torch.training import \
        uncertainty_pretrain as UP
    from sd_animation_optical_flow_tpu_torch.utils.checkpoint import \
        save_npz_tree
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import ARTIFACTS

    h, w = (int(x) for x in args.size.split("x"))
    card = S.card_line()
    S.log(f"[card] {card}")
    S.log(f"[precision] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (torch's defaults: cuDNN's "
          "convolutions in TF32, the correlation matmul in f32)")
    args.out.mkdir(parents=True, exist_ok=True)
    cfg = RF.RAFTConfig(corr_dtype="float32")
    committed = (Path(ARTIFACTS) / "raft_synth.npz",
                 Path(ARTIFACTS) / "uncertainty_head_synth.npz")
    result = {"card": card, "size": [h, w], "args": {
        k: str(v) if isinstance(v, Path) else v
        for k, v in vars(args).items()}}
    result["committed"] = evaluate_pair("committed pair", *committed, cfg,
                                        h, w)
    raft_path = args.out / f"raft_synth_{h}x{w}.npz"
    head_path = args.out / f"uncertainty_head_synth_{h}x{w}.npz"

    # stage 1: RAFT
    if args.steps > 0:
        state = FT.init_flow_train_state(_load(args.resume),
                                         FT.make_flow_optimizer(lr=args.lr))
        S.log(f"[raft] resumed from {args.resume}; {args.steps} steps, "
              f"batch {args.batch} of {h}x{w}, {args.train_iters} "
              f"iterations, lr {args.lr}")

        def raft_step(b):
            _, loss, metrics = FT.flow_train_step(
                state, cfg, *b[:4], iters=args.train_iters)
            return loss, metrics

        def raft_checkpoint(n):
            path = args.out / f"raft_step{n:05d}.npz"
            save_npz_tree(str(path), state.params, dtype=np.float16)
            for old in args.out.glob("raft_step*.npz"):   # the latest only
                if old != path:
                    old.unlink()
            raft = _load(path)
            rec = {"step": n, "path": str(path),
                   f"eval_epe_{h}x{w}": UP.eval_epe(raft, cfg, h=h, w=w,
                                                    device="cuda"),
                   "translation_epe_px": translation(
                       path, committed[1], ((h, w),))[f"{h}x{w}"]["epe_px"]}
            S.log(f"[raft] checkpoint {path.name}: held-out EPE "
                  f"{rec[f'eval_epe_{h}x{w}']:.4f} px, translation EPE "
                  f"{rec['translation_epe_px']:.4f} px at {h}x{w}")
            return rec

        batches = UP._batch_prefetcher(args.seed, args.steps, args.batch, h,
                                       w, device="cuda")
        result["raft"] = run_stage("raft", args.steps, batches, raft_step,
                                   raft_checkpoint)
        Path(result["raft"]["checkpoints"][-1]["path"]).replace(raft_path)
        del state
    else:
        raft_path.write_bytes(args.resume.read_bytes())
    torch.cuda.empty_cache()

    # stage 2: the head, on the RAFT as written
    raft = _load(raft_path)
    head = FC.uncertainty_head_init(
        Init(torch.Generator("cuda").manual_seed(args.seed + 1),
             device="cuda"), hidden_dim=cfg.hidden_dim)
    hstate = FT.init_flow_train_state(head,
                                      FT.make_flow_optimizer(lr=args.head_lr))
    S.log(f"[head] on {raft_path.name}; {args.head_steps} steps, batch "
          f"{args.batch}, lr {args.head_lr}, bce weight {args.bce_weight}")

    def head_step(b):
        _, loss, metrics = FT.uncertainty_train_step(
            hstate, raft, cfg, *b[:4], iters=args.train_iters,
            disoccluded=b[5], bce_weight=args.bce_weight)
        return loss, metrics

    def head_checkpoint(n):
        path = args.out / f"head_step{n:05d}.npz"
        save_npz_tree(str(path), hstate.params)
        for old in args.out.glob("head_step*.npz"):
            if old != path:
                old.unlink()
        return {"step": n, "path": str(path)}

    batches = UP._batch_prefetcher(args.seed + 1, args.head_steps,
                                   args.batch, h, w, device="cuda")
    result["head"] = run_stage("head", args.head_steps, batches, head_step,
                               head_checkpoint)
    if result["head"]["checkpoints"]:
        Path(result["head"]["checkpoints"][-1]["path"]).replace(head_path)
    else:
        save_npz_tree(str(head_path), hstate.params)
    del hstate, raft
    torch.cuda.empty_cache()

    result["new"] = evaluate_pair("new pair", raft_path, head_path, cfg, h,
                                  w)
    S.log(card)
    S.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
