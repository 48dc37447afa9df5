#!/usr/bin/env python3
"""A/B of the inpaint re-noise hook's timestep on the card.

Runs the keyframe pipeline's injected inpaint (``chip_smoke.py`` step 2:
``create_model("sd15-inpaint9")`` at full width, random weights, one
512x768 frame, strength 0.8, 50-step schedule, CFG 7, two keyframes' K/V
injected) in two variants, alternated in one process:

* ``host``: the port as it is, ``q_sample`` gets a host int timestep;
* ``device``: ``q_sample`` gets the [B] timestep tensor on the card, as
  the hook did before, which reads it back to the host (a stream sync)
  once per CFG evaluation.

Order device, host, host, device, repeated ``--rounds`` times: each
round is two pairs, one with each variant first. Each turn is the best
of ``--timed`` frames on the host clock (synchronized). After the rounds
each variant is profiled once (device busy ms, profiled wall ms, idle
share); the profiler's own host cost stays out of the timed turns. Run
from the repository root on a machine with one NVIDIA card:

    python3 renoise_sync_ab.py [--rounds 5] [--timed 2]

Prints one line per turn and a JSON summary as the last line: the
median s/frame of each variant, the device variant's interquartile
spread, and the pairs the host variant won.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

import chip_smoke as S


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--timed", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("renoise_sync_ab: no CUDA device", file=sys.stderr)
        return 2
    from sd_animation_optical_flow_tpu_torch import config as C
    from sd_animation_optical_flow_tpu_torch.diffusion import multistep as M
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines.keyframe_inpaint \
        import concat_ref_kv

    card = S.card_line()
    S.log(f"[card] {card}")
    gen = torch.Generator("cuda").manual_seed(S.SEED)
    sd = C.create_model("sd15", dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    S.perturb_zero_convs(sd.unet_params, gen)
    sd9 = C.create_model("sd15-inpaint9", dtype=torch.bfloat16,
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    S.perturb_zero_convs(sd9.unet_params, gen)
    prompt, neg = "a watercolor fox in the snow", "lowres, blurry"
    rand_img = lambda: torch.rand((1, S.H, S.W, 3), generator=gen,
                                  device="cuda") * 2 - 1
    kvs = [F.img2img(sd, rand_img(), prompt, neg, 0.4, ddim_steps=S.STEPS,
                     cfg_scale=S.CFG, seed=S.SEED, capture_kv=True)[1]
           for _ in range(2)]
    ref_kv = concat_ref_kv(kvs)
    frame, warped = rand_img(), rand_img()
    mask = S._blob_mask(S.H, S.W, S.H * 0.49, S.W * 0.51, S.H * 0.29, gen)

    def inject():
        out = F.img2img_inpaint(
            sd9, frame, prompt, neg, 0.8, ddim_steps=S.STEPS,
            reference_img=warped, mask=mask, mask_blur=4, cfg_scale=S.CFG,
            seed=S.SEED, reference_kv=ref_kv, want_init_decoded=False)[0]
        torch.cuda.synchronize()
        return out

    host_q_sample = M.q_sample

    def device_q_sample(sched, x0, t, noise):
        ts = torch.full((x0.shape[0],), t, dtype=torch.int32,
                        device=x0.device)
        return host_q_sample(sched, x0, ts, noise)

    variants = {"host": host_q_sample, "device": device_q_sample}
    outs = {}
    for name, fn in variants.items():   # warm-up, and the two must agree
        M.q_sample = fn
        outs[name] = inject()
    M.q_sample = host_q_sample
    same = bool(torch.equal(outs["host"], outs["device"]))
    S.log(f"[ab] host and device timestep give identical frames: {same}")

    turns = {name: [] for name in variants}
    wins = 0
    profiled = {}
    try:
        for r in range(args.rounds):
            pair = {}
            for name in ("device", "host", "host", "device"):
                M.q_sample = variants[name]
                secs = []
                for _ in range(args.timed):
                    t0 = time.time()
                    inject()
                    secs.append(time.time() - t0)
                turns[name].append(min(secs))
                pair[name] = min(secs)
                if len(pair) == 2:
                    wins += pair["host"] < pair["device"]
                    pair = {}
                S.log(f"[ab] round {r} {name}: {min(secs):.3f} s/frame "
                      f"(runs {', '.join(f'{t:.3f}' for t in secs)})")
        for name in ("device", "host"):
            M.q_sample = variants[name]
            busy, wall = S.profile_frame(inject, name, top=0)
            profiled[name] = {"busy_ms": busy, "wall_ms": wall,
                              "idle": 1 - busy / wall}
    finally:
        M.q_sample = host_q_sample

    q1, _, q3 = statistics.quantiles(turns["device"], n=4)
    summary = {name: statistics.median(ts) for name, ts in turns.items()}
    S.log(json.dumps({"renoise_sync_ab_s_per_frame": summary,
                      "device_iqr_s": q3 - q1, "host_wins": wins,
                      "pairs": 2 * args.rounds, "profiled": profiled,
                      "identical": same, "turns": turns, "card": card}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
