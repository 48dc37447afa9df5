#!/usr/bin/env python3
"""Flicker suppression of the port's pixel pipeline on the card, and the
cost of its segment batches.

The port's counterpart of ``benchmarks/temporal_consistency.py``. A
48-frame 512x768 clip is a crop of one base texture (seeded noise,
blurred at sigma 9 with the port's ``gaussian_blur``) sliding 1 px a
frame in x and y; at ``keep_every`` 3 the 16 processed frames move
exactly 3 px apart, so the inputs are consistent under the known shift
and the warped inter-frame PSNR of the outputs,

    psnr_t = PSNR(out_t[3:, 3:], out_{t+1}[:-3, :-3]),

measures the generation's flicker alone (mean and min over the 15
pairs). ``sd15`` and ``sd15-inpaint9`` from seeds 0 and 1, bf16, sharing
one VAE and CLIP as the JAX benchmark's bundles do; ``ddim``, 50 steps,
strength 0.4, seed 1234, ``key_frame_thres`` 1e9 (frame 0 the only key
frame), frame batch 8. Rows:

* naive: per-frame ``img2img`` (the flicker the pipeline exists to fix);
* oracle: ``run_batched`` fed by ``array_frame_generator`` with the
  ground-truth flow and an in-bounds confidence (:class:`OracleFlow`);
* artifact: the same with the committed ``artifacts/raft_synth.npz`` and
  the learned confidence head ``uncertainty_head_synth.npz``;
* oracle_ppw: the oracle with ``propagated_pixel_weight`` 0.9;
* kf_artifact: the keyframe pipeline (``keyframe_inpaint.run``,
  ``warp_and_inpaint_crossattn``, the config's defaults: windows of 30
  frames at stride 15 and dilation 2, one seed frame, one reference)
  with the artifact row's flow, the JAX benchmark's KF=1 row;
  kf_pair_512x768_fb: the same with the pair trained at 512x768 and fb
  confidence, when the checkout has it;
* pair_512x768: the artifact row with the pair trained at 512x768
  (``artifacts/raft_synth_512x768.npz`` and
  ``uncertainty_head_synth_512x768.npz``, ``train_flow_torch.py``) and its
  learned head, when the checkout has it; pair_512x768_fb: the same RAFT
  with the forward-backward confidence (the pipeline's default), which
  tells the flow's share of the margin from the head's.

The weights are random and differ from JAX's, so the margins over naive
are what compare with the JAX rows.

Then the timing row, on the artifact row's frames: ``run`` (frame batch
1) against ``run_batched`` at frame batch 8 with ``pad_tail_batch`` on
and off, and ``run_batched`` fed by ``array_frame_generator`` (detection
on its own stream, beside the denoise) against pre-built triples; s/frame
on the host clock (synchronized), each variant ``--repeats`` times in
mirrored order; and one batch (a key frame and 8 non-key frames, the
window after the key frame's ``converted_`` file) under the profiler for
``run_batched`` and for ``run``: device busy ms and idle share.

Run from the repository root on a machine with one NVIDIA card:

    python3 temporal_consistency_torch.py [--repeats 2] [--out DIR] [--kf-only]

(``--kf-only``: the naive and keyframe rows alone.)

Prints one line per row and turn, the card line, and a JSON summary as
the last line. Exits nonzero without a card, or when a row's output is
incomplete or not finite.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as S

H, W = 512, 768
SHIFT = 3                     # px a processed frame, both axes
N_FRAMES = 48
KEEP_EVERY = 3
FRAME_BATCH = 8
STRENGTH, STEPS, SEED = 0.4, 50, 1234
PROMPT = "masterpiece,best quality"
ROOT = Path(__file__).resolve().parent


def make_clip(device):
    """The 48 BGR uint8 frames: crops of one blurred noise texture, frame
    i offset by (i, i) px."""
    from sd_animation_optical_flow_tpu_torch.ops.filters import \
        gaussian_blur
    rng = np.random.default_rng(0)
    base = (rng.random((H + 64, W + 64, 3)) * 255).astype(np.uint8)
    blurred = gaussian_blur(torch.as_tensor(base, device=device).float(),
                            9.0)
    base = torch.floor(blurred + 0.5).clamp(0, 255).to(torch.uint8)
    base = base.cpu().numpy()
    return np.stack([base[8 + i:8 + i + H, 8 + i:8 + i + W]
                     for i in range(N_FRAMES)])


def warped_psnr(outs):
    """(mean, min) PSNR of each adjacent output pair after undoing the
    known shift; the overlap crop leaves out the new content."""
    vals = []
    for a, b in zip(outs[:-1], outs[1:]):
        x = a[SHIFT:, SHIFT:].astype(np.float64)
        y = b[:-SHIFT, :-SHIFT].astype(np.float64)
        mse = np.mean((x - y) ** 2)
        vals.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
    return float(np.mean(vals)), float(np.min(vals))


class OracleFlow:
    """The ground-truth flow and an in-bounds confidence for the clip, on
    tensors: each target's integer shift against the source found by a
    search over 0..48 px on a 128 x 128 corner (exact by construction),
    as the JAX benchmark's ``OracleFlow`` does."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def calc_batch_device(self, src, tgt):
        s = src[..., 0].float()
        t = tgt[..., 0].float()
        b, h, w = s.shape
        errs = torch.stack([(s[:, d:d + 128, d:d + 128]
                             - t[:, :128, :128]).abs().mean((1, 2))
                            for d in range(0, 49)], 1)
        d = errs.argmin(1).float()[:, None, None]           # [B, 1, 1]
        yy = torch.arange(h, device=s.device)[None, :, None]
        xx = torch.arange(w, device=s.device)[None, None, :]
        conf = ((yy + d <= h - 1) & (xx + d <= w - 1)).float()
        flow = d[..., None].expand(b, h, w, 2).contiguous()
        return flow, conf, torch.log(conf + 1e-30)


def read_outputs(out_dir):
    from sd_animation_optical_flow_tpu_torch.utils.images import \
        read_png_bgr
    names = sorted(f for f in os.listdir(out_dir)
                   if f.startswith("converted_"))
    return [read_png_bgr(os.path.join(out_dir, f)) for f in names]


def pixel_cfg(**kw):
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    return PI.PixelInpaintConfig(
        size=(W, H), keep_every=KEEP_EVERY, key_frame_thres=1e9,
        frame_batch=FRAME_BATCH, write_vis=False, ddim_steps=STEPS,
        denoising_strength=STRENGTH, seed=SEED, **kw)


def frame_gen(frames, cfg):
    from sd_animation_optical_flow_tpu_torch.pipelines import keyframes as KF
    return KF.array_frame_generator(frames, KF.FrameGenConfig(
        size=cfg.size, keep_every=cfg.keep_every,
        threshold=cfg.key_frame_thres), device="cuda")


def pixel_row(name, frames, sd, sd9, flow, out_root, ppw=0.0):
    """run_batched over the clip (frames through array_frame_generator):
    (outputs, seconds, mean mask coverage of the non-key frames)."""
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    cfg = pixel_cfg(propagated_pixel_weight=ppw)
    covers = []
    fused = PI.warp_mask_fused

    def warp_mask(*a, **k):
        warped, mask = fused(*a, **k)
        covers.append(mask.mean((1, 2)))
        return warped, mask
    t0 = time.time()
    with mock.patch.object(PI, "warp_mask_fused", warp_mask):
        out_dir = PI.run_batched(frame_gen(frames, cfg), f"{out_root}/{name}",
                                 sd, sd9, flow, tagger=None, cfg=cfg)
    torch.cuda.synchronize()
    secs = time.time() - t0
    cover = torch.cat(covers).tolist()
    return read_outputs(out_dir), secs, cover


def naive_row(proc, sd):
    """Per-frame img2img of the 16 processed frames."""
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines.tagger import \
        NEGATIVE_PROMPT
    from sd_animation_optical_flow_tpu_torch.utils.images import (
        bgr_u8_to_model, model_to_bgr_u8)
    t0 = time.time()
    outs = []
    for fr in proc:
        img, _ = F.img2img(sd, bgr_u8_to_model(fr, sd.device), PROMPT,
                           NEGATIVE_PROMPT, STRENGTH, STEPS, seed=SEED)
        outs.append(model_to_bgr_u8(img))
    return outs, time.time() - t0


def kf_row(name, frames, sd, sd9, flow, out_root):
    """The keyframe pipeline's KF=1 row: ``keyframe_inpaint.run`` in
    ``warp_and_inpaint_crossattn`` over the clip at ``keep_every`` 3 (the
    JAX row's configuration: the config's defaults but the benchmark's
    steps, strength and flow batch 8): (AI frames, seconds, None)."""
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        keyframe_inpaint as KI
    video = KI.VideoWorkspace(f"{out_root}/{name}", frames=frames,
                              size=(W, H), keep_every=KEEP_EVERY)
    cfg = KI.KeyframeInpaintConfig(
        size=(W, H), mode="warp_and_inpaint_crossattn", ddim_steps=STEPS,
        denoising_strength=STRENGTH, seed=SEED, flow_batch=8)
    t0 = time.time()
    KI.run(video, sd, sd9, flow, tagger=None, cfg=cfg)
    torch.cuda.synchronize()
    secs = time.time() - t0
    return [video.get_ai_frame(i) for i in range(video.num_frames)], secs, \
        None


def timing(frames, sd, sd9, flow, out_root, repeats):
    """s/frame of run (batch 1) and run_batched (batch 8: padded tail,
    unpadded tail, fed by the generator) over the 16 processed frames,
    each variant ``repeats`` times in mirrored order."""
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    cfg = pixel_cfg()
    triples = list(frame_gen(frames, cfg))
    n = len(triples)
    variants = {
        "run": lambda: PI.run(iter(triples), f"{out_root}/t_run", sd, sd9,
                              flow, cfg=dataclasses.replace(
                                  cfg, frame_batch=1)),
        "batched_pad": lambda: PI.run_batched(
            iter(triples), f"{out_root}/t_pad", sd, sd9, flow, cfg=cfg),
        "batched_nopad": lambda: PI.run_batched(
            iter(triples), f"{out_root}/t_nopad", sd, sd9, flow,
            cfg=dataclasses.replace(cfg, pad_tail_batch=False)),
        "batched_generator": lambda: PI.run_batched(
            frame_gen(frames, cfg), f"{out_root}/t_gen", sd, sd9, flow,
            cfg=cfg),
    }
    order = list(variants)
    times = {k: [] for k in variants}
    for r in range(repeats):
        for k in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.time()
            variants[k]()
            torch.cuda.synchronize()
            times[k].append((time.time() - t0) / n)
            S.log(f"[timing] {k}: {times[k][-1]:.4f} s/frame over {n} "
                  f"frames (turn {len(times[k])})")
    return {k: {"s_a_frame": v, "best": min(v)} for k, v in times.items()}


def profile_one_batch(frames, sd, sd9, flow, out_root):
    """A key frame and 8 non-key frames through run_batched (one batch)
    and through run, each profiled from the key frame's converted_ file
    to the end: device busy ms, wall ms and idle share of the non-key
    work. The key frame is the profiler's warm-up step (a schedule
    stepped at its converted_ file), so the profiler's start-up stays
    out of the window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    cfg = pixel_cfg()
    triples = list(frame_gen(frames, cfg))[:1 + FRAME_BATCH]
    out = {}
    for name, fn in (("run_batched", PI.run_batched), ("run", PI.run)):
        start = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:

            class Writer(PI.PngWriter):
                def submit(self, path, img):
                    super().submit(path, img)
                    if path.endswith("converted_000000.png"):
                        torch.cuda.synchronize()
                        prof.step()
                        start["t"] = time.time()
            with mock.patch.object(PI, "PngWriter", Writer):
                fn(iter(triples), f"{out_root}/p_{name}", sd, sd9, flow,
                   cfg=cfg if name == "run_batched" else
                   dataclasses.replace(cfg, frame_batch=1))
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.time() - start["t"])
        res = S.report_profile(prof, wall_ms, f"{name}, {FRAME_BATCH} "
                               "non-key frames after the key frame",
                               top=8)
        out[name] = None if res is None else {
            "busy_ms": res[0], "wall_ms": res[1],
            "idle_share": 1 - res[0] / res[1],
            "busy_ms_a_frame": res[0] / FRAME_BATCH,
            "wall_ms_a_frame": res[1] / FRAME_BATCH}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2,
                    help="turns of each timing variant")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "temporal",
                    help="where the rows' PNGs go (emptied first)")
    ap.add_argument("--kf-only", action="store_true",
                    help="only the naive and the keyframe pipeline's rows "
                         "(no pixel-pipeline rows, no timing)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("temporal_consistency_torch: no CUDA device", file=sys.stderr)
        return 2
    from sd_animation_optical_flow_tpu_torch import config as C
    from sd_animation_optical_flow_tpu_torch.models.flowconf import \
        FlowConfidenceConfig
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import (
        ARTIFACTS, load_flow_estimator)
    from sd_animation_optical_flow_tpu_torch.ops import _cuda
    card = S.card_line()
    S.log(f"[card] {card}")
    t0 = time.time()
    _cuda.library()
    S.log(f"[build] the kernels in {time.time() - t0:.1f} s")
    shutil.rmtree(args.out, ignore_errors=True)
    args.out.mkdir(parents=True)
    t0 = time.time()
    sd = C.create_model("sd15", dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    sd9 = C.create_model("sd15-inpaint9", dtype=torch.bfloat16,
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    sd9 = dataclasses.replace(sd9, vae_params=sd.vae_params,
                              clip_params=sd.clip_params)
    artifact = load_flow_estimator(FlowConfidenceConfig(
        uncertainty="learned"), device="cuda")
    new_pair = [os.path.join(ARTIFACTS, f"{n}_{H}x{W}.npz")
                for n in ("raft_synth", "uncertainty_head_synth")]
    trained = {mode: load_flow_estimator(
        FlowConfidenceConfig(uncertainty=mode), raft_path=new_pair[0],
        head_path=new_pair[1], device="cuda")
        for mode in ("learned", "fb")} \
        if all(os.path.exists(p) for p in new_pair) else {}
    frames = make_clip("cuda")
    proc = frames[::KEEP_EVERY]
    S.log(f"[init] models, flow estimator and clip in "
          f"{time.time() - t0:.1f} s; {len(proc)} processed frames of "
          f"{H}x{W}")
    failures = []
    check, _ = warped_psnr(list(proc))
    S.log(f"[clip] input warped PSNR {check:.1f} dB (construction check)")
    if check < 100:
        failures.append(f"input clip warped PSNR {check:.1f} dB")

    rows = {}
    outs, secs = naive_row(proc, sd)
    rows["naive"] = (outs, secs, None)
    variants = [] if args.kf_only else [
        ("oracle", OracleFlow(), 0.0), ("artifact", artifact, 0.0),
        ("oracle_ppw", OracleFlow(), 0.9)]
    if trained and not args.kf_only:
        variants += [(f"pair_{H}x{W}", trained["learned"], 0.0),
                     (f"pair_{H}x{W}_fb", trained["fb"], 0.0)]
    for name, flow, ppw in variants:
        rows[name] = pixel_row(name, frames, sd, sd9, flow, args.out, ppw)
    kf_variants = [("kf_artifact", artifact)] + (
        [(f"kf_pair_{H}x{W}_fb", trained["fb"])] if trained else [])
    for name, flow in kf_variants:
        rows[name] = kf_row(name, frames, sd, sd9, flow, args.out)
    table = {}
    for name, (outs, secs, cover) in rows.items():
        ok = len(outs) == len(proc) and all(
            o.shape == (H, W, 3) for o in outs)
        mean, lo = warped_psnr(outs) if ok else (math.nan, math.nan)
        table[name] = {"mean_db": mean, "min_db": lo, "seconds": secs,
                       "mask_coverage_mean": (None if cover is None else
                                              float(np.mean(cover)))}
        if not (ok and math.isfinite(mean)):
            failures.append(f"row {name}: {len(outs)} outputs, {mean} dB")
    for name, r in table.items():
        r["margin_db"] = r["mean_db"] - table["naive"]["mean_db"]
        S.log(f"[row] {name}: warped PSNR {r['mean_db']:.2f} dB (min "
              f"{r['min_db']:.2f}), {r['margin_db']:+.2f} dB over naive; "
              f"{r['seconds']:.1f} s; mask coverage "
              + ("-" if r["mask_coverage_mean"] is None
                 else f"{r['mask_coverage_mean']:.4f}"))

    times = prof = None
    if not args.kf_only:
        times = timing(frames, sd, sd9, artifact, args.out, args.repeats)
        prof = profile_one_batch(frames, sd, sd9, artifact, args.out)
    summary = {"rows": table, "timing": times, "profile_one_batch": prof,
               "frame_batch": FRAME_BATCH, "steps": STEPS,
               "strength": STRENGTH, "size": [H, W], "card": card}
    if failures:
        S.log(json.dumps(summary))
        for f in failures:
            print(f"temporal_consistency_torch FAILED: {f}", file=sys.stderr)
        return 1
    S.log(card)
    S.log(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
