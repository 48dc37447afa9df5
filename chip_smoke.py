#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``sd_animation_optical_flow_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

or, for the kernel table alone (phases 1-3), of the port in this checkout
or in another tree of the repository (an earlier commit unpacked with
``git archive``), which prints no result line:

    python3 chip_smoke.py --kernels [TREE]

Phases (any failure exits nonzero; nothing falls back to the CPU):
 1. print the card (name, power limit) and the f32 matmul/conv precision;
 2. build the CUDA kernels from ``sd_animation_optical_flow_tpu_torch/csrc``;
 3. hold each kernel against its plain PyTorch version at the SD-1.5
    512x768 main path's shapes in bf16 (the training kernels at the
    training step's), and time kernel, plain version and one PyTorch
    library call for the same function, each in two ways (``cuda_ms``);
 4. one UNet evaluation at full SD-1.5 width on the card (bf16, kernels)
    against the same weights and inputs on the CPU in f32 (plain
    versions);
 5. drive the main path — ``create_model("sd15")`` with random weights,
    ``img2img`` on one 512x768 image at strength 0.4, 50 steps, CFG 7 —
    with ``sampler="ddim"`` and ``"dpmpp:10"``, check the output and that
    every kernel's launch count went up, time each frame, and profile
    one frame of each (device busy time, top kernels); then the keyframe
    pipeline's generation step with ``create_model("sd15-inpaint9")``
    beside it: K/V capture on two keyframes, an inpaint injecting both
    (kernel #6), the same batched with per-frame K/V, a 2-frame seed
    strip and a [target | reference] strip inpaint (kernel #10), a
    4-frame seed strip (512x3072: #10 at d = 160, SD-1.5's third UNet
    level) and a capture on two 1024x1536 keyframes with an inpaint
    injecting both (#6 at d = 160), these two on a 20-step schedule, each
    checked (output, 16-pair K/V stores, its kernel launched, at d = 160
    where the step reaches it), timed and profiled; then the ``[pixel]``
    phase, with both bundles: the flow estimator from the committed
    artifacts, RAFT + fb confidence on the card against the CPU (256x384),
    a known translation (gated at 128x192, the artifact's training size;
    read at 512x768), RAFT's time a fb pair, and
    ``pixel_inpaint.run`` on five 512x768 frames (its PNGs, masks and
    launches checked, each frame timed, a non-key frame profiled), key-
    frame detection on the card (its edge maps equal the CPU's) and
    ``run_batched`` at frame batch 4 (``run``'s files at >= 40 dB, its
    launches checked, timed); then the ``[control]`` phase, with both
    bundles: one ControlNet at SD-1.5's width and a random HED, card
    against CPU (``hed_edges``, the colour ``canny_hint``,
    ``controlnet_apply``), then img2img with the keyframe pipeline's two
    controls (HED 0.7, Canny 0.3), the ControlNet inpaint, img2img with
    ``target_img`` in latent and pixel space, the inpaint with
    ``cfg_interval=2`` and img2img with ``deepcache_interval=3`` (#1
    launched less than by plain img2img), each checked and timed, the
    first profiled; then the ``[kfpipe]`` phase, with both bundles, the
    flow pair trained at 512x768 and ``[control]``'s ControlNet and HED:
    ``keyframe_inpaint.run`` on an 8-frame 512x768 pan clip (two levels)
    in the CLI's configuration (crossattn, level batch 4; run A) and in
    ``both`` mode through the serial loop with the ControlNets (run B),
    each frame checked, the launches of #1-#4, #6 (A) and #10 checked,
    s per frame by level; the fused prep and ``expand_mask`` card
    against CPU, the K/V store's round trip, the frame pipe's cache hits
    (its C++ library built by g++ into ``build/native/``), a back-fill
    chunk profiled; and ``ofgen.run`` on 3 frames; then the ``[variants]``
    phase on ``sd15`` and, one after the other, ``sd15-depth`` and
    ``sd-upscale``: ``txt2img``, ``img2img_invert``, PLMS, DDPM steps,
    the standalone DPM-Solver++(2M) (plain and inpaint), depth2img with
    a full-width DPT and latent upscaling at 512x768 (50 steps, CFG 7),
    a full-width VQ round trip, OpenCLIP and T5, each checked and timed
    (each entry point: the median of 3 runs after a counted warm-up run);
    bf16 ``txt2img`` against the same bundle in f32 (>= 40 dB decoded);
    the standalone DPM++ and ``ddim_sample`` against the multistep
    engine (>= 40 dB decoded), the class-conditional UNet, the DPT, VQ's
    indices and the two text encoders card against CPU; #1-#4 launched
    on every UNet path, #5-#10 on none; then the ``[parallel]`` phase on
    an NCCL process group of world size 1 and ``make_mesh(dp=1)``: the
    keyframe pipeline's 2-tile 512x1536 seed strip with ``sp`` and
    without (>= 40 dB, equal launches of #1, #3, #4 and #10, #10 > 0,
    both profiled), ``img2img_inpaint_batch`` with ``mesh`` against the
    plain batch (2e-2 x max |out|, #6 launched), ``run_batched`` at
    dp 1 against dp 0 (equal files), on ``make_mesh(dp=1, tp=1)`` one
    UNet evaluation on the ``shard_params`` tree with ``tp`` against the
    whole params (2e-2 x max |eps|, equal launches of #1, #3 and #4) and
    two sharded fine-tuning steps (``shard_train_state``) against two
    unsharded ones (losses, params and EMA within 1e-6; #7-#9 ten each
    a step); then
    the ``[banded]`` phase: one full-width UNet
    evaluation with the two keyframes' K/V injected and the banded
    cross-frame bias materialized at every self-attention
    (``attn_biases``: the plain route, as in JAX), checked against the
    unbiased call and the CPU in f32; then the diffusion fine-tuning
    step on ``sd15`` (f32 master weights, bf16 activations, batch 2 at
    512x768, ``adamw_with_ema_wings``):
    one step's gradient against the f32 plain route, three steps with
    their launches checked (#7, #8, #9 ten each, #1 at least ten, the
    fused FFN kernels none), the parameters and the EMA checked, timed
    and profiled. No pipeline path runs kernel #5 (none does in JAX):
    its launches are those of one call per check shape through
    ``flash_attention_banded``, made apart from the comparisons;
 6. print the kernel table as one JSON line, each phase's wall seconds
    and their total, the card line, and the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is
# the larger of bytes / memory rate and operations / bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# softmax's floor beside the bound: one exp2 per score on the special-
# function units, 16 a clock per SM: 132 x 16 x ~1.83 GHz (the clock of
# the bf16 figure)
PEAK_EXP2_PER_S = 3.9e12

H, W = 512, 768                 # image size of the main path
STRENGTH, STEPS, CFG = 0.4, 50, 7.0
# keyframe steps 6 and 7 (4x the 512x768 work a UNet evaluation) take a
# 20-step schedule: the profiler's pass over their launches at 50 steps
# took chip_smoke past half its time limit. Widths are not cut.
L2_STEPS = 20
SEED = 1234


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = True) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events).
    ``queued``: a spin kernel of ~5 ms ahead of the start event holds the
    card while the host queues the calls, so a call shorter than its
    host-side launch (the cross-attention rows, ~0.03 ms) is timed on the
    device. Unqueued, such a call reads the host's launch rate; the
    kernel rows give both readings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def _attn_case(gen, b, nq, nk, h, d, self_attn):
    """q/k/v laid out as the UNet makes them: self-attention slices q, k
    and v out of one fused [B, N, 3*H*D] projection, cross-attention
    takes a contiguous q and slices k, v out of one [B, Nk, 2*H*D]."""
    mk = lambda n, parts: torch.randn(
        (b, n, parts * h * d), generator=gen, device="cuda",
        dtype=torch.float32).to(torch.bfloat16)
    heads = lambda t: t.reshape(b, t.shape[1], h, d)
    if self_attn:
        q, k, v = (heads(t) for t in mk(nq, 3).chunk(3, dim=-1))
    else:
        q = heads(mk(nq, 1))
        k, v = (heads(t) for t in mk(nk, 2).chunk(2, dim=-1))
    flops = 4.0 * b * h * nq * nk * d
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + q.numel())
    return (q, k, v), flops, nbytes


def _sdpa(q, k, v):
    # library yardstick on its own [B, H, N, D] layout
    return torch.nn.functional.scaled_dot_product_attention(q, k, v)


def _by_head(plain, q, k, v, **kw):
    """A plain version run one head at a time: at 12288 strip tokens its
    f32 [B, H, N, N] scores would take ~10 GB per copy."""
    return torch.cat([plain(q[:, :, i:i + 1], k[:, :, i:i + 1],
                            v[:, :, i:i + 1], **kw)
                      for i in range(q.shape[2])], dim=2)


def check_kernels():
    from sd_animation_optical_flow_tpu_torch.ops import attention as A
    from sd_animation_optical_flow_tpu_torch.ops import ffn as FF

    gen = torch.Generator("cuda").manual_seed(SEED)
    rows = []

    def record(name, kernel_fn, plain_fn, library_fn, flops, nbytes,
               tol, wrapper, replaces, iters, note="", exps=None):
        """Hold each output of ``kernel_fn`` (a tensor or a tuple) to the
        same output of ``plain_fn``: max |err| <= tol * max |plain| per
        output; the row reports the output with the largest err / limit.
        ``exps``: the exponentials the function needs (attention: one per
        score), for the exp floor in the log line. Kernel and library are
        timed queued (the row's ``ms``, ``library_ms``) and unqueued
        (``ms_unqueued``, ``library_ms_unqueued``). The row's ``source``
        and ``design`` are what ``wrapper.kernel`` names after the call
        (null for a tree whose wrappers do not name it)."""
        outs = kernel_fn()
        torch.cuda.synchronize()
        source, design = getattr(wrapper, "kernel", None) or (None, None)
        refs = plain_fn()
        torch.cuda.synchronize()
        if isinstance(outs, torch.Tensor):
            outs, refs = (outs,), (refs,)
        ok, worst = True, None
        for out, ref in zip(outs, refs):
            e = (out.float() - ref.float()).abs().max().item()
            sc = ref.float().abs().max().item()
            ok = ok and bool(torch.isfinite(out).all()) and e <= tol * sc
            if worst is None or e / max(sc, 1e-30) > worst[0] / max(
                    worst[1], 1e-30):
                worst = (e, sc, ref.float().pow(2).mean().sqrt().item())
        err, scale, rms = worst
        del outs, refs
        ms = cuda_ms(kernel_fn, iters)
        ms_unq = cuda_ms(kernel_fn, iters, queued=False)
        plain_ms = cuda_ms(plain_fn, max(2, iters // 4))
        lib_ms = cuda_ms(library_fn, iters) if library_fn else None
        lib_unq = cuda_ms(library_fn, iters, queued=False) \
            if library_fn else None
        bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                             flops / PEAK_BF16_FLOPS)
        exp_ms = None if exps is None else 1e3 * exps / PEAK_EXP2_PER_S
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": err,
               "tol": tol * scale, "ms": ms, "ms_unqueued": ms_unq,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / PEAK_BYTES_PER_S
               > flops / PEAK_BF16_FLOPS else "operations",
               "library_ms": lib_ms, "library_ms_unqueued": lib_unq,
               "design": design, "ok": ok}
        log(f"[kernel] {name}: max|err| {err:.3e} (tol {tol * scale:.3e} ="
            f" {tol:g} * max|plain| {scale:.3e}; rms(plain) {rms:.3e}; worst "
            f"output) "
            f"{'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.3f} ms  library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f"{'' if lib_ms is None else f' (kernel / library {ms / lib_ms:.2f})'}"
            f"  bound {bound_ms:.4f} ms ({row['bound_by']})"
            f"{'' if exp_ms is None else f'  exp floor {exp_ms:.4f} ms'}"
            f"  unqueued: kernel {ms_unq:.4f} ms"
            f"{'' if lib_unq is None else f'  library {lib_unq:.4f} ms (kernel / library {ms_unq / lib_unq:.2f})'}"
            f"{note}")
        rows.append(row)

    tpv_rep = "sd_animation_optical_flow_tpu/ops/attention.py:135"
    # every tolerance is relative to the largest output of the plain
    # version, with no floor: 2e-2 of it is ~2.5 bf16 ulps there (both
    # sides round to bf16 at the end; the kernel rounds unnormalised
    # probabilities, the plain version normalised ones)
    attn_tol = 2e-2
    for label, (b, nq, nk, h, d) in {
            "self L0": (2, 6144, 6144, 8, 40),
            "self L1": (2, 1536, 1536, 8, 80),
            "cross L0": (2, 6144, 231, 8, 40),
            "cross L1": (2, 1536, 231, 8, 80)}.items():
        (q, k, v), flops, nbytes = _attn_case(gen, b, nq, nk, h, d,
                                              label.startswith("self"))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        record(f"flash_attention_tpv [{label}]",
               lambda: A.flash_attention_tpv(q, k, v),
               lambda: A.xla_attention(q, k, v),
               lambda: _sdpa(qt, kt, vt), flops, nbytes, attn_tol,
               A.flash_attention_tpv, tpv_rep, iters=10,
               exps=b * h * nq * nk)

    # kernel #2: the VAE mid-block attention of one frame and of the
    # 2-frame VAE, and the UNet's 160-wide L2 heads at a 1024x1536 frame
    # (32 x 48 latent tokens), which attention() routes to it
    for label, (b, n, h, d) in {"VAE mid": (1, 6144, 1, 512),
                                "VAE mid 2 frames": (2, 6144, 1, 512),
                                "L2 1024x1536": (2, 1536, 8, 160)}.items():
        (q, k, v), flops, nbytes = _attn_case(gen, b, n, n, h, d, True)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        record(f"flash_attention [{label}]",
               lambda: A.flash_attention(q, k, v),
               lambda: A.xla_attention(q, k, v), lambda: _sdpa(qt, kt, vt),
               flops, nbytes, attn_tol, A.flash_attention,
               "sd_animation_optical_flow_tpu/ops/attention.py:62", iters=10,
               exps=b * h * n * n)

    # kernel #6 at the injected inpaint's shapes: q sliced out of the fused
    # QKV projection, k/v the [own | reference] rows the UNet builds
    # (contiguous), CFG batch 2, one uncond row; L2 (d 160) reaches the
    # gate at a 1024x1536 frame (32 x 48 latent tokens: keyframe step 7)
    for label, (nq, d) in {"inject L0": (6144, 40),
                           "inject L1": (1536, 80),
                           "inject L2 1024x1536": (1536, 160)}.items():
        b, h, nk, n_own, n_unc = 2, 8, 2 * nq, nq, 1
        (q, _, _), _, _ = _attn_case(gen, b, nq, nq, h, d, True)
        k, v = (torch.randn((b, nk, h, d), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        # useful work: the uncond rows see n_own keys, the cond rows all
        keys = n_unc * n_own + (b - n_unc) * nk
        flops = 4.0 * h * d * nq * keys
        nbytes = 2.0 * (2 * q.numel() + 2 * h * d * keys)
        allowed = torch.ones((b, 1, 1, nk), dtype=torch.bool, device="cuda")
        allowed[:n_unc, ..., n_own:] = False
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        record(f"flash_attention_keymask [{label}]",
               lambda: A.flash_attention_keymask(q, k, v, n_own=n_own,
                                                 n_uncond=n_unc),
               lambda: A.attention_injected_plain(q, k, v, n_own=n_own,
                                                  n_uncond=n_unc),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=allowed),
               flops, nbytes, attn_tol, A.flash_attention_keymask,
               "sd_animation_optical_flow_tpu/ops/attention.py:288", iters=10,
               exps=h * nq * keys)

    # kernel #10 at the strips' shapes (2 tiles of a 512x768 frame: latent
    # 64 x 192 at L0, 32 x 96 at L1; L2 (d 160) reaches the gate with 4
    # tiles: 16 x 96, keyframe step 6), q/k/v slices of the fused QKV;
    # attention_sm90_kernel's MFR mode, 32-key tiles at d 160
    for label, (hh, w_tile, tiles, d, mode) in {
            "strip L0 mutual": (64, 96, 2, 40, "mutual"),
            "strip L0 target": (64, 96, 2, 40, "target"),
            "strip L1 mutual": (32, 48, 2, 80, "mutual"),
            "strip L2 4 tiles mutual": (16, 24, 4, 160, "mutual")}.items():
        b, h, n = 2, 8, hh * tiles * w_tile
        (q, k, v), flops, nbytes = _attn_case(gen, b, n, n, h, d, True)
        bias = A.mfr_strip_bias(hh, w_tile, tiles, mode=mode, device="cuda")
        bias16 = bias.to(torch.bfloat16)[None, None]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kw = dict(h=hh, w_strip=tiles * w_tile, n_tiles=tiles, mode=mode)
        record(f"flash_attention_mfr [{label}]",
               lambda: A.flash_attention_mfr(q, k, v, h=hh, w_tile=w_tile,
                                             n_tiles=tiles, mode=mode),
               lambda: _by_head(A.strip_attention_plain, q, k, v, **kw),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=bias16),
               flops, nbytes, attn_tol, A.flash_attention_mfr,
               "sd_animation_optical_flow_tpu/ops/attention.py:1078",
               iters=5, exps=b * h * n * n)

    check_banded_kernel(gen, record, rows, attn_tol)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    # outputs are sums of din bf16 products rounded to bf16: 2e-2 of the
    # plain version's largest output, as for attention
    ffn_tol = 2e-2
    # kernel #3 at the UNet's LN1 -> QKV and LN2 -> Q projections: L0 of
    # the CFG pair (12288 rows of 320) and L1 of a 2-frame batch (6144
    # rows of 640, as keyframe steps 3-5 run it)
    for lvl, (m, din) in {"L0": (12288, 320), "L1": (6144, 640)}.items():
        x = randn(m, din)
        lns = 1.0 + 0.1 * torch.randn(din, generator=gen, device="cuda")
        lnb = 0.1 * torch.randn(din, generator=gen, device="cuda")
        for label, dout in (("QKV", 3 * din), ("Q", din)):
            w = randn(dout, din, scale=1.0 / math.sqrt(din))
            record(f"linear_ln_fused [{label} {lvl}]",
                   lambda: FF.linear_ln_fused(x, w, lns, lnb),
                   lambda: FF.linear_ln_plain(x, w, lns, lnb, 1e-5),
                   lambda: torch.nn.functional.layer_norm(
                       x, (din,), lns.to(x.dtype), lnb.to(x.dtype)) @ w.t(),
                   2.0 * m * din * dout,
                   2.0 * (x.numel() + w.numel() + m * dout) + 8.0 * din,
                   ffn_tol, FF.linear_ln_fused,
                   "sd_animation_optical_flow_tpu/ops/ffn.py:192", iters=20)

    # kernel #4 at the UNet's transformer tails: L0 of the CFG pair
    # (12288 rows of 320) and L1 of a 2-frame batch (6144 rows of 640, as
    # keyframe steps 3-5 run it), dff 4 din, LN and the residual
    for label, (m, din) in {"L0 tail": (12288, 320),
                            "L1 tail": (6144, 640)}.items():
        dff = 4 * din
        x = randn(m, din)
        lns = 1.0 + 0.1 * torch.randn(din, generator=gen, device="cuda")
        lnb = 0.1 * torch.randn(din, generator=gen, device="cuda")
        w1 = randn(2 * dff, din, scale=1.0 / math.sqrt(din))
        b1 = randn(2 * dff, scale=1.0 / math.sqrt(din))
        w2 = randn(din, dff, scale=1.0 / math.sqrt(dff))
        b2 = randn(din, scale=1.0 / math.sqrt(dff))

        def geglu_library():
            F = torch.nn.functional
            hh, g = F.linear(F.layer_norm(x, (din,), lns.to(x.dtype),
                                          lnb.to(x.dtype)), w1, b1).chunk(2, -1)
            return x + F.linear(hh * F.gelu(g), w2, b2)

        # the bound counts the function's inputs and output, not the
        # [m, dff] intermediate the two kernels pass through device memory
        record(f"geglu_ff_fused [{label}]",
               lambda: FF.geglu_ff_fused(x, w1, b1, w2, b2, lns, lnb,
                                         residual=True),
               lambda: FF.geglu_ff_plain(x, w1, b1, w2, b2, lns, lnb, 1e-5,
                                          True),
               geglu_library, 2.0 * m * din * 2 * dff + 2.0 * m * dff * din,
               2.0 * (2 * x.numel() + w1.numel() + b1.numel() + w2.numel()
                      + b2.numel()) + 8.0 * din,
               ffn_tol, FF.geglu_ff_fused,
               "sd_animation_optical_flow_tpu/ops/ffn.py:54", iters=20)
    check_training_kernels(gen, record, rows, attn_tol)
    return rows


def _band_pairs(h, w, radius):
    """In-band (query, key) pairs of one h x w frame against one frame:
    sum over (y, x) of the band's rows times its columns."""
    span = lambda n: sum(min(n - 1, i + radius) - max(0, i - radius) + 1
                         for i in range(n))
    return span(h) * span(w)


def check_banded_kernel(gen, record, rows, tol):
    """Kernel #5 at the three UNet levels of a 512x768 frame against two
    frames' keys (q a slice of the fused QKV projection, k/v the
    contiguous joined reference rows the UNet injects), weight 0 and 0.7,
    and L0 with base = -inf. Before each comparison one call through
    ``flash_attention_banded`` with its counters reset drives the op; its
    counts are the row's ``drive_launches`` and ``launches_by_dp`` (by
    padded head width; null for a tree whose wrapper keeps none). The bound counts every key
    (with a finite base every key weighs); the log line adds the bound of
    the in-band pairs alone, the floor an exact tile skip could reach."""
    from sd_animation_optical_flow_tpu_torch.ops import attention as A
    for label, (hh, ww, d, weight, base) in {
            "L0 w0": (64, 96, 40, 0.0, -1000.0),
            "L0 w0.7": (64, 96, 40, 0.7, -1000.0),
            "L0 base -inf": (64, 96, 40, 0.0, -math.inf),
            "L1 w0": (32, 48, 80, 0.0, -1000.0),
            "L1 w0.7": (32, 48, 80, 0.7, -1000.0),
            "L2 w0": (16, 24, 160, 0.0, -1000.0),
            "L2 w0.7": (16, 24, 160, 0.7, -1000.0)}.items():
        b, h, frames, nq = 2, 8, 2, hh * ww
        nk = frames * nq
        (q, _, _), _, _ = _attn_case(gen, b, nq, nq, h, d, True)
        k, v = (torch.randn((b, nk, h, d), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        kw = dict(h=hh, w=ww, weight=weight, base=base)
        bias16 = A.banded_strip_bias(hh, ww, frames, weight=weight,
                                     base=base, dtype=torch.bfloat16,
                                     device="cuda")[None, None]
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops = 4.0 * b * h * nq * nk * d
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        band_flops = 4.0 * b * h * d * frames * _band_pairs(hh, ww, 8)
        band_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S,
                            band_flops / PEAK_BF16_FLOPS)
        A.flash_attention_banded.launches = 0
        by_dp = getattr(A.flash_attention_banded, "launches_by_dp", None)
        if by_dp is not None:
            by_dp.clear()
        A.flash_attention_banded(q, k, v, **kw)
        drive = A.flash_attention_banded.launches
        drive_dp = None if by_dp is None else dict(by_dp)
        record(f"flash_attention_banded [{label}]",
               lambda: A.flash_attention_banded(q, k, v, **kw),
               lambda: _by_head(A.flash_attention_banded_plain, q, k, v,
                                **kw),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=bias16),
               flops, nbytes, tol, A.flash_attention_banded,
               "sd_animation_optical_flow_tpu/ops/attention.py:178",
               iters=5, note=f"; in-band pairs only {band_ms:.4f} ms",
               exps=b * h * nq * nk)
        rows[-1]["drive_launches"] = drive
        rows[-1]["launches_by_dp"] = drive_dp
        log(f"[kernel]   drive: {drive} launch(es), by padded head width "
            f"{rows[-1]['launches_by_dp']}")
        del q, k, v, qt, kt, vt, bias16


def _stats_by_head(q, k, v):
    """flash_fwd_stats_plain one head at a time (f32 [B, 1, N, N] scores:
    302 MB at L0 instead of 2.4 GB)."""
    from sd_animation_optical_flow_tpu_torch.ops import attention as A
    b, nq, h, _ = q.shape
    outs, lses = zip(*(A.flash_fwd_stats_plain(
        q[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1])
        for i in range(h)))
    return torch.cat(outs, dim=2), torch.stack(lses, 1).reshape(b * h, nq)


def _bwd_by_head(plain, q, k, v, do, lse, dvec):
    """A plain backward (outputs shaped as q / k) one head at a time."""
    b, nq, h, _ = q.shape
    rows = lambda t, i: t.reshape(b, h, nq)[:, i].contiguous()
    parts = [plain(q[:, :, i:i + 1], k[:, :, i:i + 1], v[:, :, i:i + 1],
                   do[:, :, i:i + 1], rows(lse, i), rows(dvec, i))
             for i in range(h)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=2)
    return tuple(torch.cat(p, dim=2) for p in zip(*parts))


def check_training_kernels(gen, record, rows, tol):
    """Kernels #7 (forward with statistics), #8 (dK, dV) and #9 (dQ) at
    the training step's self-attention shapes (batch 2, bf16, q/k/v
    slices of the fused QKV projection), each against its plain version
    (one head at a time). Library: SDPA's forward for #7; SDPA's backward
    (autograd of its output with the same dO) for the pair #8 + #9,
    reported once, on the #8 row; a log line gives the pair's time and
    its ratio to it, with and without the D = rowsum(dO * O) pass that
    SDPA's backward holds inside it. ``record`` adds the rows."""
    from sd_animation_optical_flow_tpu_torch.ops import attention as A
    rep = "sd_animation_optical_flow_tpu/ops/attention.py:"
    for label, (b, n, h, d) in {"self L0": (2, 6144, 8, 40),
                                "self L1": (2, 1536, 8, 80)}.items():
        (q, k, v), _, _ = _attn_case(gen, b, n, n, h, d, True)
        do = torch.randn((b, n, h, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        out, lse = A.flash_fwd_stats(q, k, v)
        dvec = A.flash_dvec(out, do)
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        sdpa_out = _sdpa(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        qkv_bytes = 2.0 * 3 * b * n * h * d
        stat_bytes = 4.0 * b * h * n
        flop = b * h * n * n * d
        record(f"flash_fwd_stats [{label}]",
               lambda: A.flash_fwd_stats(q, k, v),
               lambda: _stats_by_head(q, k, v),
               lambda: _sdpa(qt.detach(), kt.detach(), vt.detach()),
               4.0 * flop, qkv_bytes + 2.0 * b * n * h * d + stat_bytes,
               tol, A.flash_fwd_stats, rep + "600", iters=10,
               exps=b * h * n * n)
        record(f"flash_bwd_dkv [{label}]",
               lambda: A.flash_bwd_dkv(q, k, v, do, lse, dvec),
               lambda: _bwd_by_head(A._bwd_dkv_plain, q, k, v, do, lse,
                                    dvec),
               lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                           retain_graph=True),
               8.0 * flop, qkv_bytes + 2.0 * b * n * h * d
               + 2 * stat_bytes + 2 * 2.0 * b * n * h * d,
               tol, A.flash_bwd_dkv, rep + "631", iters=10,
               exps=b * h * n * n)
        record(f"flash_bwd_dq [{label}]",
               lambda: A.flash_bwd_dq(q, k, v, do, lse, dvec),
               lambda: _bwd_by_head(A._bwd_dq_plain, q, k, v, do, lse,
                                    dvec),
               None, 6.0 * flop, qkv_bytes + 2.0 * b * n * h * d
               + 2 * stat_bytes + 2.0 * b * n * h * d,
               tol, A.flash_bwd_dq, rep + "673", iters=10,
               exps=b * h * n * n)
        dkv, dq = rows[-2], rows[-1]
        d_ms = cuda_ms(lambda: A.flash_dvec(out, do), 10)
        d_unq = cuda_ms(lambda: A.flash_dvec(out, do), 10, queued=False)
        pair, pair_unq = dkv["ms"] + dq["ms"], \
            dkv["ms_unqueued"] + dq["ms_unqueued"]
        lib, lib_unq = dkv["library_ms"], dkv["library_ms_unqueued"]
        log(f"[kernel] flash_bwd pair #8 + #9 [{label}]: {dkv['ms']:.3f} + "
            f"{dq['ms']:.3f} = {pair:.3f} ms, SDPA's backward {lib:.3f} ms "
            f"(pair / library {pair / lib:.2f}; with the D pass "
            f"{d_ms:.3f} ms {(pair + d_ms) / lib:.2f}); unqueued "
            f"{pair_unq:.3f} ms, SDPA's backward {lib_unq:.3f} ms (pair / "
            f"library {pair_unq / lib_unq:.2f}; with the D pass "
            f"{d_unq:.3f} ms {(pair_unq + d_unq) / lib_unq:.2f})")
        del sdpa_out


# ---------------------------------------------------------------------------
# phases 4-5: the model
# ---------------------------------------------------------------------------

def perturb_zero_convs(params, gen):
    """Give the zero-initialised output convs (resblock out_conv,
    transformer proj_out, the final conv; ControlNet's zero_convs,
    middle_out and hint_out) small random weights, so every attention
    reaches the output and every ControlNet residual is nonzero."""
    def perturb(sub):
        w = sub["w"]
        if w.any():
            return
        bound = 0.1 / math.sqrt(w[0].numel())
        sub["w"] = ((torch.rand(w.shape, generator=gen, device=w.device)
                     * 2 - 1) * bound).to(w.dtype).contiguous(
            memory_format=torch.channels_last)

    def walk(tree):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                if key == "zero_convs":
                    for conv in sub:
                        perturb(conv)
                elif key in ("out_conv", "proj_out", "conv", "middle_out",
                             "hint_out") \
                        and isinstance(sub, dict) and "w" in sub:
                    perturb(sub)
                else:
                    walk(sub)
        elif isinstance(tree, list):
            for sub in tree:
                walk(sub)
    walk(params)


def to_cpu_f32(tree):
    if isinstance(tree, dict):
        return {k: to_cpu_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu_f32(v) for v in tree]
    return tree.float().cpu().contiguous()


def check_unet_against_cpu(sd, gen):
    """One CFG UNet evaluation (stem dedup) on the card in bf16 against
    the same weights and inputs on the CPU in f32 (plain versions)."""
    from sd_animation_optical_flow_tpu_torch.models import unet as U
    x = torch.randn((1, H // 8, W // 8, 4), generator=gen, device="cuda")
    t = torch.full((1,), 401, dtype=torch.int32, device="cuda")
    ctx_c = sd.get_learned_conditioning("a watercolor fox in the snow")
    ctx_u = sd.get_learned_conditioning("")
    out_gpu, _ = U.unet_apply(sd.unet_params, sd.unet_cfg,
                              x.to(torch.bfloat16), t, None,
                              context_pair=(ctx_u, ctx_c))
    torch.cuda.synchronize()
    t0 = time.time()
    out_cpu, _ = U.unet_apply(to_cpu_f32(sd.unet_params), sd.unet_cfg,
                              x.cpu(), t.cpu(), None,
                              context_pair=(ctx_u.float().cpu(),
                                            ctx_c.float().cpu()))
    diff = out_gpu.float().cpu() - out_cpu
    rel = (diff.norm() / out_cpu.norm()).item()
    log(f"[unet] card bf16 vs CPU f32, one CFG eval at 64x96 latent: "
        f"rel L2 err {rel:.4e}, |out| rms {out_cpu.pow(2).mean().sqrt():.4f}"
        f" (CPU {time.time() - t0:.1f} s)")
    return rel


def reset_counts(kernels):
    """Set every wrapper's launch count to 0, and its counts by padded
    head width where it keeps them (``launches_by_dp``)."""
    for fn in kernels.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_dp"):
            fn.launches_by_dp.clear()


def dp_counts(kernels):
    """The launches by padded head width of the wrappers that count them."""
    return {name: dict(sorted(fn.launches_by_dp.items()))
            for name, fn in kernels.items() if hasattr(fn, "launches_by_dp")}


def run_main_path(sd, kernels, gen, repeats: int = 2):
    """img2img per sampler: one run with the launch counters reset just
    before it and read just after, then ``repeats`` timed runs (the
    frame time is their minimum; host clock, synchronized)."""
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    img = torch.rand((1, H, W, 3), generator=gen, device="cuda") * 2 - 1

    def frame(sampler):
        out, _ = F.img2img(sd, img, "a watercolor fox in the snow",
                           "lowres, blurry", STRENGTH, ddim_steps=STEPS,
                           cfg_scale=CFG, seed=SEED, sampler=sampler)
        torch.cuda.synchronize()
        return out

    results = {}
    for sampler in ("ddim", "dpmpp:10"):
        reset_counts(kernels)
        torch.cuda.synchronize()
        out = frame(sampler)
        counts = {name: fn.launches for name, fn in kernels.items()}
        times = []
        for _ in range(repeats):
            t0 = time.time()
            frame(sampler)
            times.append(time.time() - t0)
        ok_shape = tuple(out.shape) == (1, H, W, 3)
        ok_range = bool(torch.isfinite(out).all()) \
            and out.abs().max().item() <= 1.0
        log(f"[main] img2img sampler={sampler}: {min(times):.3f} s/frame "
            f"(runs {', '.join(f'{t:.3f}' for t in times)}), shape "
            f"{tuple(out.shape)} finite-in-range {ok_range}, std "
            f"{out.float().std().item():.4f}, launches {counts}")
        results[sampler] = (min(times), counts, ok_shape and ok_range)
        profile_frame(lambda: frame(sampler), sampler)
    return results


def _blob_mask(h, w, cy, cx, r, gen):
    """A blob (a disc with a wavy rim) covering part of an h x w frame."""
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    phase = float(torch.rand((), generator=gen, device="cuda")) * 6.28
    ang = torch.atan2(yy - cy, xx - cx)
    rad = r * (1 + 0.2 * torch.sin(5 * ang + phase))
    return (((yy - cy) ** 2 + (xx - cx) ** 2).sqrt() < rad).float()


def run_keyframe_path(sd, sd9, kernels, gen):
    """The keyframe pipeline's generation step, five steps in its order:
    capture K/V on two keyframes (img2img), inject both into an inpaint
    on the 9-channel model, the same batched with per-frame K/V, a
    2-frame seed strip ('mutual') and a [target | reference] strip
    inpaint ('target'); then two steps at SD-1.5's third UNet level (d =
    160 past the attention gate): a 4-frame seed strip (the JAX
    ``generate_seed_frames`` with ``n_seed_frames = 4``, 'mutual') and,
    at 1024x1536, K/V capture on two keyframes with an inpaint injecting
    both. Each step runs once with the launch counters reset just before
    it and read just after, once more timed (host clock, synchronized),
    and once under the profiler. Returns {step: (s/frame, counts, ok)},
    the failures found and the two 512x768 keyframes' captured K/V."""
    from sd_animation_optical_flow_tpu_torch.models.unet import \
        NUM_KV_LAYERS, StripConfig
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines.keyframe_inpaint \
        import concat_ref_kv
    prompt, neg = "a watercolor fox in the snow", "lowres, blurry"
    rand_img = lambda w: torch.rand((1, H, w, 3), generator=gen,
                                    device="cuda") * 2 - 1
    keys = [rand_img(W) for _ in range(2)]
    frame, warped = rand_img(W), rand_img(W)
    mask = _blob_mask(H, W, H * 0.49, W * 0.51, H * 0.29, gen)
    # steps 6 and 7: two more seed keyframes; 1024x1536 keyframes, frame,
    # reference and mask
    seeds = keys + [rand_img(W) for _ in range(2)]
    big = lambda: torch.rand((1, 2 * H, 2 * W, 3), generator=gen,
                             device="cuda") * 2 - 1
    big_keys, big_frame, big_warped = [big() for _ in range(2)], big(), big()
    big_mask = _blob_mask(2 * H, 2 * W, H * 0.98, W * 1.02, H * 0.58, gen)
    f = sd.vae_cfg.downscale
    failures, results = [], {}
    kv_store = {}

    def kv_ok(kv, batch, h=H, w=W):
        # 16 pairs, [batch, tokens at the layer's level, C], contiguous,
        # for an h x w image (a strip: w its whole width); the UNet level
        # of each transformer in capture order (6 encoder, the middle one
        # at level 3, 9 decoder)
        if kv is None or len(kv) != NUM_KV_LAYERS:
            return False
        for (k, v), lv in zip(kv, [0, 0, 1, 1, 2, 2, 3, 2, 2, 2, 1, 1, 1,
                                   0, 0, 0]):
            n = (h // f >> lv) * (w // f >> lv)
            c = sd.unet_cfg.model_channels * sd.unet_cfg.channel_mult[lv]
            if k.shape != (batch, n, c) or v.shape != k.shape \
                    or not k.is_contiguous():
                return False
        return True

    def capture():
        outs, kvs = [], []
        for key in keys:
            out, kv = F.img2img(sd, key, prompt, neg, 0.4, ddim_steps=STEPS,
                                cfg_scale=CFG, seed=SEED, capture_kv=True)
            outs.append(out)
            kvs.append(kv)
        torch.cuda.synchronize()
        kv_store["keys"] = kvs
        return torch.cat(outs), all(kv_ok(kv, 1) for kv in kvs), 2

    def inject():
        ref_kv = concat_ref_kv(kv_store["keys"])
        out, _, _, kv = F.img2img_inpaint(
            sd9, frame, prompt, neg, 0.8, ddim_steps=STEPS,
            reference_img=warped, mask=mask, mask_blur=4, cfg_scale=CFG,
            seed=SEED, reference_kv=ref_kv, capture_kv=True,
            want_init_decoded=False)
        torch.cuda.synchronize()
        return out, kv_ok(kv, 1), 1

    def inject_batch():
        ka, kb = kv_store["keys"]
        per_frame = tuple(
            (torch.cat([torch.cat([a[0], b[0]], 1), torch.cat([b[0], a[0]],
                                                              1)]),
             torch.cat([torch.cat([a[1], b[1]], 1), torch.cat([b[1], a[1]],
                                                              1)]))
            for a, b in zip(ka, kb))
        out, kv = F.img2img_inpaint_batch(
            sd9, torch.cat([frame, warped]), [prompt, prompt], neg,
            torch.stack([mask, mask.flip(1)]), torch.cat([warped, frame]),
            0.8, ddim_steps=STEPS, mask_blur=4, cfg_scale=CFG, seed=SEED,
            reference_kv=per_frame, capture_kv=True)
        frames = F.split_kv_batch(kv, 2)
        torch.cuda.synchronize()
        return out, kv_ok(kv, 2) and all(kv_ok(fk, 1) for fk in frames), 2

    def seed_strip():
        out, kv = F.img2img(sd, torch.cat(keys, dim=2), prompt, neg, 0.8,
                            ddim_steps=STEPS, cfg_scale=CFG, seed=SEED,
                            strip=StripConfig(2, "mutual"), capture_kv=True)
        torch.cuda.synchronize()
        return out, kv_ok(kv, 1, w=2 * W), 2

    def target_strip():
        strip_mask = torch.cat([mask, torch.zeros_like(mask)], dim=1)
        strip_img = torch.cat([frame, keys[0]], dim=2)
        out, _, _, _ = F.img2img_inpaint(
            sd9, strip_img, prompt, neg, 0.8, ddim_steps=STEPS,
            reference_img=torch.cat([warped, keys[0]], dim=2),
            mask=strip_mask, mask_blur=4, cfg_scale=CFG, seed=SEED,
            strip=StripConfig(2, "target"), want_init_decoded=False)
        torch.cuda.synchronize()
        return out, True, 1

    def seed_strip4():
        # the 4-frame seed strip, 512x3072: L2 is 16 x 96 tokens, d = 160
        out, kv = F.img2img(sd, torch.cat(seeds, dim=2), prompt, neg, 0.8,
                            ddim_steps=L2_STEPS, cfg_scale=CFG, seed=SEED,
                            strip=StripConfig(4, "mutual"), capture_kv=True)
        torch.cuda.synchronize()
        return out, kv_ok(kv, 1, w=4 * W), 4

    def inject_big():
        # capture on two 1024x1536 keyframes (L2: 32 x 48 tokens, d = 160),
        # then the injected inpaint of one frame; s/frame per inpainted
        # frame, the captures included
        kvs = [F.img2img(sd, key, prompt, neg, 0.4, ddim_steps=L2_STEPS,
                         cfg_scale=CFG, seed=SEED, capture_kv=True)[1]
               for key in big_keys]
        out, _, _, kv = F.img2img_inpaint(
            sd9, big_frame, prompt, neg, 0.8, ddim_steps=L2_STEPS,
            reference_img=big_warped, mask=big_mask, mask_blur=4,
            cfg_scale=CFG, seed=SEED, reference_kv=concat_ref_kv(kvs),
            capture_kv=True, want_init_decoded=False)
        torch.cuda.synchronize()
        return out, all(kv_ok(k, 1, 2 * H, 2 * W) for k in [*kvs, kv]), 1

    # step: (run, output shape, kernels it must launch, the d = 160
    # instantiation it must launch)
    mask_kv = ("flash_attention_keymask", "linear_ln_fused")
    mfr = ("flash_attention_mfr", "linear_ln_fused")
    steps = {"1 capture": (capture, (2, H, W, 3), (), None),
             "2 inject": (inject, (1, H, W, 3), mask_kv, None),
             "3 inject batch": (inject_batch, (2, H, W, 3), mask_kv, None),
             "4 seed strip": (seed_strip, (1, H, 2 * W, 3), mfr, None),
             "5 target strip": (target_strip, (1, H, 2 * W, 3), mfr, None),
             "6 4-tile seed strip": (seed_strip4, (1, H, 4 * W, 3), mfr,
                                     "flash_attention_mfr"),
             "7 inject at 1024x1536": (inject_big, (1, 2 * H, 2 * W, 3),
                                       mask_kv + ("flash_attention",),
                                       "flash_attention_keymask")}
    for name, (run, shape, must_launch, must_160) in steps.items():
        reset_counts(kernels)
        torch.cuda.synchronize()
        out, kv_good, frames = run()
        counts = {k: fn.launches for k, fn in kernels.items()}
        by_dp = dp_counts(kernels)
        t0 = time.time()
        run()
        secs = (time.time() - t0) / frames
        ok_out = tuple(out.shape) == shape and bool(
            torch.isfinite(out).all()) and out.abs().max().item() <= 1.0
        cut = f" ({L2_STEPS}-step schedule, not {STEPS})" if must_160 else ""
        log(f"[keyframe] step {name}{cut}: {secs:.3f} s/frame, output "
            f"{tuple(out.shape)} finite-in-range {ok_out}, std "
            f"{out.float().std().item():.4f}, K/V store ok {kv_good}, "
            f"launches {counts}, by padded head width {by_dp}")
        if not (ok_out and kv_good):
            failures.append(f"keyframe step {name}: bad output or K/V")
        for k in must_launch:
            if counts[k] == 0:
                failures.append(f"keyframe step {name}: {k} never launched")
        if must_160 and not by_dp[must_160].get(160):
            failures.append(f"keyframe step {name}: {must_160} never "
                            "launched at d = 160")
        results[name] = (secs, counts, ok_out and kv_good)
        if name != "1 capture":
            profile_frame(run, f"step {name}")
    return results, failures, kv_store["keys"]


# ---------------------------------------------------------------------------
# the pixel-inpaint pipeline
# ---------------------------------------------------------------------------

PIXEL_FRAMES = 5                 # frame 0 a key frame, 1-4 not
PIXEL_KERNELS = ("flash_attention_tpv", "flash_attention", "linear_ln_fused",
                 "geglu_ff_fused")


def _texture(rng, h, w, octaves=(4, 8, 16, 32)):
    """[h, w, 3] float32 0..255: seeded noise bilinearly upsampled from
    grids 1/4 .. 1/32 of the size, summed with falling weights (blurred
    noise with structure at several scales)."""
    img = torch.zeros((1, 3, h, w))
    amp = 1.0
    for sc in octaves:
        grid = torch.from_numpy(rng.standard_normal(
            (1, 3, max(h // sc, 2), max(w // sc, 2))).astype("float32"))
        img += amp * torch.nn.functional.interpolate(
            grid, size=(h, w), mode="bilinear", align_corners=True)
        amp *= 0.7
    img = img[0].permute(1, 2, 0)
    img -= img.min()
    return (img * (255.0 / img.max())).numpy()


def _shifted_pair(rng, h, w, dx, dy):
    """(src, tgt) RGB float32 [h, w, 3]: tgt(x, y) = src(x + dx, y + dy),
    so the flow target -> source is (dx, dy) everywhere."""
    tex = _texture(rng, h + 32, w + 32)
    src = tex[16:16 + h, 16:16 + w]
    tgt = tex[16 + dy:16 + dy + h, 16 + dx:16 + dx + w]
    return src.copy(), tgt.copy()


def _pan_frames(rng, n, h, w):
    """n BGR uint8 frames: a textured scene panning 2 px a frame to the
    left, and a textured rectangle (a quarter of each side) moving 4 px
    right and 3 px down a frame over it."""
    import numpy as np
    bg = _texture(rng, h, w + 2 * n)
    fg = _texture(rng, h // 4, w // 4)
    frames = []
    for k in range(n):
        f = bg[:, 2 * k:2 * k + w].copy()
        y, x = h // 3 + 3 * k, w // 3 + 4 * k
        f[y:y + h // 4, x:x + w // 4] = fg
        frames.append(np.ascontiguousarray(
            np.clip(np.round(f), 0, 255).astype(np.uint8)[..., ::-1]))
    return frames


def _epe(flow, dx, dy, border=16):
    """Mean endpoint error of flow [B, H, W, 2] against the constant flow
    (dx, dy) over the interior (a border cut off)."""
    f = flow[:, border:-border, border:-border]
    return float(((f[..., 0] - dx) ** 2 + (f[..., 1] - dy) ** 2)
                 .sqrt().mean())


def run_pixel_phase(sd, sd9, kernels):
    """The pixel-inpaint pipeline (``pipelines/pixel_inpaint.run``) at
    512x768 with its flow front end:

    1. the flow estimator from the committed artifacts
       (``load_flow_estimator``: RAFT ``raft_synth.npz``, the uncertainty
       head ``uncertainty_head_synth.npz``);
    2. RAFT + fb confidence on the card against the same weights on the
       CPU, one seeded 256x384 pair, f32 correlation storage, 20
       iterations: flow mean |diff| <= 1e-2 px, confidence max |diff| <=
       2e-2;
    3. a known translation, flow (-3, +2) px, default config (bf16
       storage, 20 iterations, fb): at 128x192, the size the artifact was
       trained at, interior EPE <= 0.5 px; at 192x288 .. 512x768 EPE and
       the confident share are read and printed (the artifact does not
       generalize past its size, in JAX as here); the learned confidence
       once at 512x768, finite in [0, 1]; RAFT's ms a fb pair at 512x768
       (CUDA events) and its device busy time (profiler);
    4. ``run`` on 5 seeded 512x768 frames (a panning scene with an
       occluder; frame 0 a key frame) with ``sd15`` / ``sd15-inpaint9``,
       ddim, 50 steps, strength 0.4, ``write_vis``: every converted_ /
       vis_ / pixel_confidence_ PNG written and decoded to its shape, the
       flow, confidence and images finite, each non-key frame's mask
       neither empty nor whole, kernels #1-#4 launched and #5-#10 not
       (counters reset just before the run, read just after); a second
       run timed frame by frame (host clock, synchronized), a third with
       frame 1 profiled;
    5. ``keyframes.array_frame_generator`` over the same frames with the
       detector on the card (``check_detector``), and ``run_batched`` at
       frame batch 4 held to ``run``'s files (``check_run_batched``).
    Returns (summary dict, the launch counts of the counted run and of
    the counted run_batched, failures)."""
    import contextlib
    import os
    import tempfile

    import numpy as np

    from sd_animation_optical_flow_tpu_torch.models import flowconf as FC
    from sd_animation_optical_flow_tpu_torch.models import raft as RF
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    from sd_animation_optical_flow_tpu_torch.utils.images import \
        read_png_bgr
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import (
        ARTIFACTS, load_flow_estimator)
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_leaves
    rng = np.random.default_rng(SEED)
    failures, summary = [], {}

    t0 = time.time()
    est = load_flow_estimator(device="cuda")
    torch.cuda.synchronize()
    summary["load_s"] = time.time() - t0
    n_raft = sum(t.numel() for t in tree_leaves(est.params))
    log(f"[pixel] flow estimator from artifacts/raft_synth.npz ({n_raft} "
        f"RAFT parameters) and uncertainty_head_synth.npz on the card in "
        f"{summary['load_s']:.2f} s")

    # 2. the card against the CPU, f32 storage (TF32 is off)
    cfg32 = FC.FlowConfidenceConfig(raft=RF.RAFTConfig(corr_dtype="float32"))
    card = FC.FlowConfidenceEstimator(est.params, cfg32, device="cuda")
    cpu = FC.FlowConfidenceEstimator(to_cpu_f32(est.params), cfg32,
                                     device="cpu")
    src, tgt = _shifted_pair(rng, 256, 384, -3, 2)
    t0 = time.time()
    fg, cg, _ = card.calc_batch_device(src[None], tgt[None])
    fc, cc, _ = cpu.calc_batch_device(src[None], tgt[None])
    flow_d = (fg.cpu() - fc).abs().mean().item()
    conf_d = (cg.cpu() - cc).abs().max().item()
    summary["card_vs_cpu"] = {"flow_mean_abs_px": flow_d,
                              "conf_max_abs": conf_d}
    log(f"[pixel] RAFT + fb confidence, 256x384, f32 storage, 20 "
        f"iterations: card vs CPU flow mean |diff| {flow_d:.3e} px (limit "
        f"1e-2), confidence max |diff| {conf_d:.3e} (limit 2e-2); CPU "
        f"{time.time() - t0:.1f} s")
    if not (flow_d <= 1e-2 and conf_d <= 2e-2):
        failures.append(f"pixel: RAFT card vs CPU flow {flow_d:.3e} px, "
                        f"confidence {conf_d:.3e}")
    del cpu

    # 3. the known translation, at the artifact's training size (gated)
    # and at sizes up to the pipeline's (read)
    summary["translation"] = {}
    for h, w in ((128, 192), (192, 288), (256, 384), (384, 576), (H, W)):
        src, tgt = _shifted_pair(rng, h, w, -3, 2)
        flow, conf, _ = est.calc_batch_device(src[None], tgt[None])
        epe = _epe(flow, -3.0, 2.0)
        c95 = (conf[:, 16:-16, 16:-16] > 0.95).float().mean().item()
        med = flow[0, 16:-16, 16:-16].reshape(-1, 2).median(0).values
        summary["translation"][f"{h}x{w}"] = {"epe_px": epe,
                                              "conf_gt_095": c95}
        log(f"[pixel] known translation (-3, +2) px at {h}x{w}, default "
            f"config (bf16 storage, 20 iterations, fb): interior EPE "
            f"{epe:.3f} px, median flow ({med[0]:.3f}, {med[1]:.3f}), "
            f"confidence > 0.95 on {c95:.3f} of the interior"
            + (" (gate: EPE <= 0.5 px)" if h == 128 else
               " (read, not gated: the artifact was trained at 128x192)"))
        if not math.isfinite(epe) or (h == 128 and epe > 0.5):
            failures.append(f"pixel: known translation at {h}x{w} EPE "
                            f"{epe:.3f} px")
    # the pair trained at the pipeline's size, when the checkout has it
    new_pair = [os.path.join(ARTIFACTS, f"{n}_{H}x{W}.npz")
                for n in ("raft_synth", "uncertainty_head_synth")]
    est_new = None
    if all(os.path.exists(p) for p in new_pair):
        est_new = load_flow_estimator(raft_path=new_pair[0],
                                      head_path=new_pair[1], device="cuda")
        src_n, tgt_n = _shifted_pair(np.random.default_rng(SEED + 1), H, W,
                                     -3, 2)
        flow, conf, _ = est_new.calc_batch_device(src_n[None], tgt_n[None])
        epe = _epe(flow, -3.0, 2.0)
        c95 = (conf[:, 16:-16, 16:-16] > 0.95).float().mean().item()
        summary["translation_new_pair"] = {"epe_px": epe, "conf_gt_095": c95}
        log(f"[pixel] the {H}x{W} pair ({os.path.basename(new_pair[0])}, "
            f"{os.path.basename(new_pair[1])}): known translation (-3, +2) "
            f"px at {H}x{W}, default config: interior EPE {epe:.3f} px, "
            f"confidence > 0.95 on {c95:.3f} of the interior (gate: EPE <= "
            f"0.5 px)")
        if not math.isfinite(epe) or epe > 0.5:
            failures.append(f"pixel: the {H}x{W} pair's translation EPE "
                            f"{epe:.3f} px")
    learned = FC.FlowConfidenceEstimator(
        est.params, FC.FlowConfidenceConfig(uncertainty="learned"),
        head_params=est.head_params, device="cuda")
    _, conf_l, _ = learned.calc_batch_device(src[None], tgt[None])
    lo, hi = conf_l.min().item(), conf_l.max().item()
    ok_l = bool(torch.isfinite(conf_l).all()) and 0.0 <= lo and hi <= 1.0
    summary["learned_conf_range"] = [lo, hi]
    log(f"[pixel] learned confidence at {H}x{W}: range [{lo:.4f}, {hi:.4f}]"
        f", finite in [0, 1] {ok_l}")
    if not ok_l:
        failures.append(f"pixel: learned confidence range [{lo}, {hi}]")

    # RAFT's time a fb pair at 512x768: CUDA events around back-to-back
    # pairs, unqueued (its ~6000 launches a pair overflow the launch
    # queue, so a spin kernel ahead of them would hold the host too), and
    # the profiler's device busy time of one pair
    src_d = torch.as_tensor(src, device="cuda")[None]
    tgt_d = torch.as_tensor(tgt, device="cuda")[None]
    pair = lambda: est.calc_batch_device(src_d, tgt_d)
    raft_ms = cuda_ms(pair, iters=2, warmup=1, queued=False)
    prof = profile_frame(lambda: (pair(), torch.cuda.synchronize()),
                         f"RAFT fb pair {H}x{W}", top=10)
    summary["raft_fb_pair_ms"] = raft_ms
    summary["raft_profile_busy_wall_ms"] = prof
    log(f"[pixel] RAFT + fb confidence a pair at {H}x{W} (bf16 storage, 20 "
        f"iterations, both directions): {raft_ms:.2f} ms a pair (CUDA "
        f"events, 2 back-to-back pairs, unqueued); device busy "
        + (f"{prof[0]:.2f} ms" if prof else "not measured")
        + " (profiler, one pair)")
    del src_d, tgt_d

    # 4. the pipeline
    frames = _pan_frames(rng, PIXEL_FRAMES, H, W)
    triples = [(f, i == 0, i) for i, f in enumerate(frames)]
    cfg = PI.PixelInpaintConfig(name="smoke", denoising_strength=STRENGTH,
                                ddim_steps=STEPS, sampler="ddim",
                                write_vis=True)
    # recorded as device tensors, read after each run: the spies add no
    # host sync inside the pipeline
    seen = {"mask": [], "finite": [], "submit_t": []}
    hook = {"fn": None}

    class Writer(PI.PngWriter):
        def submit(self, path, img):
            super().submit(path, img)
            if "converted_" in path:
                torch.cuda.synchronize()
                seen["submit_t"].append(time.time())
                if hook["fn"] is not None:
                    hook["fn"]()

    def spy(fn, outputs):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen["finite"].append(torch.isfinite(outputs(out)).all())
            return out
        return wrapped

    warp_mask_fused = PI.warp_mask_fused

    def warp_mask(*a, **k):
        warped, mask = warp_mask_fused(*a, **k)
        seen["mask"].append(mask.mean())
        seen["finite"].append(torch.isfinite(warped).all())
        return warped, mask
    patches = [mock.patch.object(PI, "PngWriter", Writer),
               mock.patch.object(PI, "warp_mask_fused", warp_mask),
               mock.patch.object(F, "img2img", spy(F.img2img,
                                                   lambda o: o[0])),
               mock.patch.object(F, "img2img_inpaint",
                                 spy(F.img2img_inpaint, lambda o: o[0])),
               mock.patch.object(est, "calc_batch_device", spy(
                   est.calc_batch_device,
                   lambda o: torch.cat([o[0].flatten(), o[1].flatten()])))]
    out_root = Path(__file__).resolve().parent / "build"
    out_root.mkdir(parents=True, exist_ok=True)

    def pipeline(tmp, flow_est=est, name="clip"):
        seen["mask"], seen["finite"], seen["submit_t"] = [], [], []
        t_start = time.time()
        out_dir = PI.run(iter(triples), f"{tmp}/{name}", sd, sd9, flow_est,
                         tagger=None, cfg=cfg)
        ts = [t_start] + seen["submit_t"]
        return out_dir, [b - a for a, b in zip(ts, ts[1:])]

    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory(dir=out_root) as tmp, \
            contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        reset_counts(kernels)
        torch.cuda.synchronize()
        out_dir, first_s = pipeline(tmp)
        counts = {k: fn.launches for k, fn in kernels.items()}
        names = sorted(os.listdir(out_dir))
        want = sorted(f"{kind}_{i:06d}.png" for i in range(PIXEL_FRAMES)
                      for kind in ("converted", "vis", "pixel_confidence"))
        shapes = {n: read_png_bgr(os.path.join(out_dir, n)).shape
                  for n in names}
        ok_files = names == want and all(
            shapes[n] == ((H, 6 * W, 3) if n.startswith("vis_")
                          else (H, W, 3)) for n in names)
        cover = [m.item() for m in seen["mask"]]
        # img2img once, then a flow, a warp + mask and an inpaint a frame
        finite = len(seen["finite"]) == 1 + 3 * (PIXEL_FRAMES - 1) and \
            all(f.item() for f in seen["finite"])
        log(f"[pixel] run on {PIXEL_FRAMES} frames of {H}x{W} (frame 0 a "
            f"key frame; sd15 / sd15-inpaint9, ddim, {STEPS} steps, "
            f"strength {STRENGTH}): {len(names)} PNGs, all present and "
            f"decoded to their shapes {ok_files}; flow, confidence and "
            f"images finite {finite}; mask coverage of frames 1-"
            f"{PIXEL_FRAMES - 1}: {', '.join(f'{c:.4f}' for c in cover)}; "
            f"launches {counts}; first run s/frame "
            f"{', '.join(f'{s:.3f}' for s in first_s)}")
        if not (ok_files and finite):
            failures.append(f"pixel: outputs {names} shapes ok {ok_files}, "
                            f"finite {finite}")
        if len(cover) != PIXEL_FRAMES - 1 or \
                not all(0.0 < c < 1.0 for c in cover):
            failures.append(f"pixel: mask coverage {cover}")
        for k in kernels:
            if (counts[k] == 0) == (k in PIXEL_KERNELS):
                failures.append(f"pixel: {k} launched {counts[k]} times")

        if est_new is not None:
            pipeline(tmp, est_new, "clip_new_pair")
            cover_new = [m.item() for m in seen["mask"]]
            summary["mask_coverage_new_pair"] = cover_new
            log(f"[pixel] run on the same frames with the {H}x{W} pair: mask "
                f"coverage of frames 1-{PIXEL_FRAMES - 1}: "
                f"{', '.join(f'{c:.4f}' for c in cover_new)} (the committed "
                f"pair's: {', '.join(f'{c:.4f}' for c in cover)})")

        _, frame_s = pipeline(tmp)
        summary["frame_s"] = {"key": frame_s[0], "nonkey": frame_s[1:]}
        summary["mask_coverage"] = cover
        log(f"[pixel] s/frame (host clock, synchronized): key frame "
            f"{frame_s[0]:.3f} (img2img, then frame 1's flow), non-key "
            f"frames {', '.join(f'{s:.3f}' for s in frame_s[1:])} (each: "
            f"warp + mask, the next frame's flow, the inpaint)")

        # frame 1 under the profiler: frame 0 its warm-up step
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            hook["fn"] = prof.step
            _, prof_s = pipeline(tmp)
            hook["fn"] = None
        summary["profile_busy_wall_ms"] = report_profile(
            prof, 1e3 * prof_s[1], "pixel non-key frame 1")

        # 5. key-frame detection on the card, then run_batched
        failures += check_detector(frames, cfg, summary)
        batched_counts, batched_failures = check_run_batched(
            cfg, out_dir, frame_s, kernels, summary,
            lambda d: PI.run_batched(iter(triples), f"{tmp}/batched", sd,
                                     sd9, est, tagger=None, cfg=d),
            seen)
        failures += batched_failures
    return summary, [counts, batched_counts], failures


def check_detector(frames, cfg, summary):
    """``keyframes.array_frame_generator`` with ``EdgeDetector`` on the
    card over the pipeline's frames: the card's edge maps equal the CPU
    detector's pixel for pixel, frame 0 is a key frame; each frame's
    mean pixel distance to its key frame's map, its flag, and the
    detector's ms a frame (host clock: upload, detection on the
    detector's stream, read back through its event). Returns failures."""
    import numpy as np

    from sd_animation_optical_flow_tpu_torch.pipelines import keyframes as KF
    failures = []
    gen_cfg = KF.FrameGenConfig(size=(W, H), keep_every=1,
                                threshold=cfg.key_frame_thres)
    flags = [k for _, k, _ in KF.array_frame_generator(frames, gen_cfg,
                                                        device="cuda")]
    card, cpu = KF.EdgeDetector("cuda"), KF.EdgeDetector("cpu")
    card(frames[0])
    t0 = time.time()
    maps = [card(f) for f in frames]
    det_ms = 1e3 * (time.time() - t0) / len(frames)
    same = [bool(np.array_equal(m, cpu(f))) for m, f in zip(maps, frames)]
    # each frame against the last key frame before it, as the generator
    # compares them
    dist, key = [], 0
    for i, m in enumerate(maps):
        dist.append(KF.mean_pixel_distance(m, maps[key]))
        key = i if flags[i] else key
    summary["detector"] = {"flags": flags, "mean_pixel_distance": dist,
                           "card_equals_cpu": same, "ms_a_frame": det_ms,
                           "edge_share": [float((m > 0).mean())
                                          for m in maps]}
    log(f"[pixel] key-frame detection (array_frame_generator, EdgeDetector "
        f"on the card, threshold {cfg.key_frame_thres}): flags {flags}; "
        f"mean pixel distance to the last key frame's map "
        f"{', '.join(f'{d:.3f}' for d in dist)}; edge maps equal to the "
        f"CPU detector's pixel for pixel {same}; {det_ms:.2f} ms a frame "
        f"(host clock, {H}x{W})")
    if not all(same):
        failures.append(f"pixel: card edge maps equal the CPU's {same}")
    if not flags[0]:
        failures.append("pixel: frame 0 is not a key frame")
    return failures


def check_run_batched(cfg, run_dir, run_s, kernels, summary, run_batched,
                      seen):
    """``run_batched(cfg)`` (``pixel_inpaint.run_batched`` over ``run``'s
    triples) at frame batch 4 (the four non-key frames one batch): a
    counted run (launch counters reset just before it, read just after:
    #1-#4 launched, #5-#10 not), its files against ``run``'s
    (``run_dir``): the same names, every converted_ frame at >= 40 dB
    PSNR of ``run``'s (BASELINE.md's gate); then a timed run, its
    s/frame beside ``run``'s (``run_s``). Returns (launch counts,
    failures)."""
    import dataclasses
    import os

    import numpy as np

    from sd_animation_optical_flow_tpu_torch.utils.images import \
        read_png_bgr
    failures = []
    bcfg = dataclasses.replace(cfg, frame_batch=4)
    reset_counts(kernels)
    torch.cuda.synchronize()
    bdir = run_batched(bcfg)
    counts = {k: fn.launches for k, fn in kernels.items()}
    names = sorted(os.listdir(bdir))
    ok_names = names == sorted(os.listdir(run_dir))
    psnr, max_diff = [], []
    for i in range(PIXEL_FRAMES):
        name = f"converted_{i:06d}.png"
        a = read_png_bgr(os.path.join(bdir, name)).astype(np.float64)
        b = read_png_bgr(os.path.join(run_dir, name)).astype(np.float64)
        mse = float(((a - b) ** 2).mean())
        psnr.append(float("inf") if mse == 0 else
                    10 * math.log10(255.0 ** 2 / mse))
        max_diff.append(int(np.abs(a - b).max()))
    seen["submit_t"] = []
    t0 = time.time()
    run_batched(bcfg)
    wall = time.time() - t0
    # converted_ submits: the key frame's after its img2img, the batch's
    # four at its finalize
    t_key, t_end = seen["submit_t"][0], seen["submit_t"][-1]
    key_s, batch_s = t_key - t0, (t_end - t_key) / (PIXEL_FRAMES - 1)
    summary["run_batched"] = {
        "frame_batch": 4, "psnr_vs_run_db": psnr, "max_abs_diff": max_diff,
        "launches": counts, "wall_s": wall, "key_s": key_s,
        "nonkey_s_a_frame": batch_s,
        "run_nonkey_s_a_frame": sum(run_s[1:]) / len(run_s[1:])}
    log(f"[pixel] run_batched, frame batch 4 (frames 1-4 one batch): same "
        f"files as run {ok_names}; converted_ PSNR against run "
        f"{', '.join(f'{p:.2f}' for p in psnr)} dB (gate 40), max |diff| "
        f"{max_diff}; launches {counts}")
    log(f"[pixel] s/frame (host clock, synchronized): run_batched key "
        f"{key_s:.3f}, non-key {batch_s:.3f} a frame (the batch's flow, "
        f"warp + mask and inpaint over 4 frames), {wall:.3f} s for the 5 "
        f"frames; run: key {run_s[0]:.3f}, non-key "
        f"{summary['run_batched']['run_nonkey_s_a_frame']:.3f} a frame, "
        f"{sum(run_s):.3f} s")
    if not ok_names:
        failures.append(f"pixel: run_batched wrote {names}")
    if not all(p >= 40.0 for p in psnr):
        failures.append(f"pixel: run_batched PSNR against run {psnr}")
    for k in kernels:
        if (counts[k] == 0) == (k in PIXEL_KERNELS):
            failures.append(f"pixel run_batched: {k} launched {counts[k]} "
                            "times")
    return counts, failures


# ---------------------------------------------------------------------------
# ControlNet, HED and the sampler hooks
# ---------------------------------------------------------------------------

CONTROL_KERNELS = PIXEL_KERNELS       # #1-#4: ControlNet runs the UNet's


def _rel_l2(a, b):
    return ((a.float().cpu() - b).norm() / b.norm()).item()


def run_control_phase(sd, sd9, kernels, gen):
    """ControlNet, the HED annotator and the sampler hooks at 512x768:

    1. one ControlNet at SD-1.5's width (``controlnet_init`` on the card,
       bf16, its zero convs perturbed) and a random HED at its published
       widths (f32);
    2. card against CPU: ``hed_edges`` on a 256x384 frame (no pixel more
       than 1 apart), the colour ``canny_hint`` at 512x768 (equal), and
       ``controlnet_apply`` at 512x768, bf16 on the card against f32 on
       the CPU (every residual within 0.1 rel L2);
    3. drive on one 512x768 frame (strength 0.4, 50 steps, CFG 7), each
       run once with the launch counters reset and read, once timed:
       ``img2img`` with the keyframe pipeline's controls (HED 0.7 over [0,
       1], Canny 0.3 over [0, 0.9], hints from the frame; profiled once),
       ``img2img_inpaint`` on sd15-inpaint9 with them (the ControlNet
       branch), ``img2img`` with ``target_img`` in latent and in pixel
       space, ``img2img_inpaint`` with ``cfg_interval=2`` and ``img2img``
       with ``deepcache_interval=3`` (#1 launched fewer times than by
       plain ``img2img``). Returns (summary, the launch counts of each
       run, failures, the keyframe pipeline's control bundle: the
       ControlNet, its config and the HED function)."""
    import numpy as np
    from sd_animation_optical_flow_tpu_torch.config import _channels_last
    from sd_animation_optical_flow_tpu_torch.models import controlnet as CN
    from sd_animation_optical_flow_tpu_torch.models import hed as HED
    from sd_animation_optical_flow_tpu_torch.models.layers import Init
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    failures, summary, all_counts = [], {}, []
    t0 = time.time()
    cn = _channels_last(CN.controlnet_init(Init(
        torch.Generator("cuda").manual_seed(2), torch.bfloat16, "cuda"),
        sd.unet_cfg))
    perturb_zero_convs(cn, gen)
    hed = _channels_last(HED.hed_init(Init(
        torch.Generator("cuda").manual_seed(3), torch.float32, "cuda")))
    rng = np.random.default_rng(SEED)
    frame = np.ascontiguousarray(np.clip(np.round(_texture(rng, H, W)), 0,
                                         255).astype(np.uint8))
    # the input shift at the frame's channel means: the random net's
    # logits then span both sides of 0 instead of saturating
    hed["norm"] = torch.as_tensor(frame.reshape(-1, 3).mean(0),
                                  dtype=torch.float32, device="cuda")
    n_cn = sum(t.numel() for t in _leaves(cn))
    log(f"[control] ControlNet ({n_cn / 1e6:.1f} M parameters, bf16) and "
        f"HED ({sum(t.numel() for t in _leaves(hed)) / 1e6:.1f} M, f32) "
        f"random init on the card in {time.time() - t0:.1f} s")

    # card against CPU
    small = np.ascontiguousarray(frame[::2, ::2])
    e_card = HED.hed_edges(hed, small).cpu()
    e_cpu = HED.hed_edges(to_cpu_f32(hed), small)
    hed_diff = int((e_card.int() - e_cpu.int()).abs().max())
    canny_card = CN.canny_hint(frame, 100, 200, batch=1, device="cuda")
    canny_cpu = CN.canny_hint(frame, 100, 200, batch=1, device="cpu")
    canny_equal = torch.equal(canny_card.cpu(), canny_cpu)
    hed_fn = HED.make_hed_fn(hed)
    hints = {"hed": CN.hed_hint(frame, hed_fn, batch=2, device="cuda"),
             "canny": CN.canny_hint(frame, 100, 200, batch=2,
                                    device="cuda")}
    x = torch.randn((1, H // 8, W // 8, 4), generator=gen, device="cuda")
    t = torch.full((1,), 401, dtype=torch.int32, device="cuda")
    ctx = sd.get_learned_conditioning("a watercolor fox in the snow")
    res_card = CN.controlnet_apply(cn, sd.unet_cfg, x.bfloat16(),
                                   hints["hed"][:1], t, ctx)
    torch.cuda.synchronize()
    t1 = time.time()
    res_cpu = CN.controlnet_apply(to_cpu_f32(cn), sd.unet_cfg, x.cpu(),
                                  hints["hed"][:1].cpu(), t.cpu(),
                                  ctx.float().cpu())
    rels = [_rel_l2(a, b) for a, b in zip(res_card, res_cpu)]
    summary["card_vs_cpu"] = {"hed_edges_max_diff": hed_diff,
                              "canny_equal": canny_equal,
                              "controlnet_rel_l2": rels}
    log(f"[control] card vs CPU: hed_edges at {H // 2}x{W // 2} max |diff| "
        f"{hed_diff} (edge values {len(e_cpu.unique())} distinct, mean "
        f"{e_cpu.float().mean():.1f}); colour canny_hint at {H}x{W} equal "
        f"{canny_equal} ({int(canny_cpu[0, ..., 0].sum())} edge pixels); "
        f"controlnet_apply at {H}x{W}, bf16 vs f32, rel L2 of the "
        f"{len(rels)} residuals max {max(rels):.4e} (CPU "
        f"{time.time() - t1:.1f} s)")
    if hed_diff > 1:
        failures.append(f"control: hed_edges card vs CPU differ by "
                        f"{hed_diff}")
    if not canny_equal:
        failures.append("control: canny_hint card vs CPU differ")
    if len(rels) != 13 or not all(math.isfinite(r) and r <= 0.1
                                  for r in rels):
        failures.append(f"control: controlnet_apply rel L2 {rels}")

    # the drives
    controls = (CN.ControlSpec(cn, sd.unet_cfg, hints["hed"], 0.7, 0.0, 1.0),
                CN.ControlSpec(cn, sd.unet_cfg, hints["canny"], 0.3, 0.0,
                               0.9))
    img = torch.from_numpy(frame[..., ::-1].copy()).to("cuda")[None] \
        .float() / 127.5 - 1.0
    target = torch.rand((1, H, W, 3), generator=gen, device="cuda") * 2 - 1
    mask = _blob_mask(H, W, H * 0.49, W * 0.51, H * 0.29, gen)
    prompt, neg = "a watercolor fox in the snow", "lowres, blurry"
    common = dict(ddim_steps=STEPS, cfg_scale=CFG, seed=SEED)

    def i2i(**kw):
        return F.img2img(sd, img, prompt, neg, STRENGTH, **common, **kw)[0]

    def inpaint(**kw):
        return F.img2img_inpaint(sd9, img, prompt, neg, 0.8,
                                 reference_img=target, mask=mask,
                                 mask_blur=4, want_init_decoded=False,
                                 **common, **kw)[0]

    drives = {
        "plain img2img": lambda: i2i(),
        "1 img2img controls": lambda: i2i(control_specs=controls),
        "2 inpaint controls": lambda: inpaint(control_specs=controls),
        "3a img2img latent guidance": lambda: i2i(target_img=target),
        "3b img2img pixel guidance": lambda: i2i(target_img=target,
                                                 guidance_space="pixel"),
        "4 inpaint cfg_interval 2": lambda: inpaint(cfg_interval=2),
        "5 img2img deepcache 3": lambda: i2i(deepcache_interval=3)}
    outs, counts, secs = {}, {}, {}
    for name, run in drives.items():
        reset_counts(kernels)
        torch.cuda.synchronize()
        outs[name] = run()
        torch.cuda.synchronize()
        counts[name] = {k: fn.launches for k, fn in kernels.items()}
        t1 = time.time()
        run()
        torch.cuda.synchronize()
        secs[name] = time.time() - t1
        out = outs[name]
        ok = tuple(out.shape) == (1, H, W, 3) and bool(
            torch.isfinite(out).all()) and out.abs().max().item() <= 1.0
        base = outs["plain img2img"]
        diff = (out.float() - base.float()).abs().mean().item()
        log(f"[control] {name}: {secs[name]:.3f} s/frame, output "
            f"{tuple(out.shape)} finite-in-range {ok}, mean |out - plain "
            f"img2img| {diff:.4f}, launches {counts[name]}")
        if not ok:
            failures.append(f"control {name}: bad output")
        if name != "plain img2img" and name.split()[1] == "img2img" \
                and diff == 0.0:
            failures.append(f"control {name}: equals plain img2img")
        for k in CONTROL_KERNELS:
            if counts[name][k] == 0:
                failures.append(f"control {name}: {k} never launched")
        all_counts.append(counts[name])
    plain_n = counts["plain img2img"]["flash_attention_tpv"]
    dc_n = counts["5 img2img deepcache 3"]["flash_attention_tpv"]
    if not dc_n < plain_n:
        failures.append(f"control: DeepCache launched #1 {dc_n} times, "
                        f"plain img2img {plain_n}")
    summary["frame_s"] = secs
    summary["launches"] = counts
    summary["profile_busy_wall_ms"] = profile_frame(
        drives["1 img2img controls"], "control img2img with 2 ControlNets")
    return summary, all_counts, failures, (cn, sd.unet_cfg, hed_fn)


# ---------------------------------------------------------------------------
# the keyframe pipeline and ofgen
# ---------------------------------------------------------------------------

KFPIPE_FRAMES = 8
# run A (crossattn, level batch 4) launches these; run B ('both', serial,
# ControlNets) all but #6, which only K/V injection reaches
KFPIPE_KERNELS = ("flash_attention_tpv", "flash_attention", "linear_ln_fused",
                  "geglu_ff_fused", "flash_attention_keymask",
                  "flash_attention_mfr")
KFPIPE_IDLE = ("flash_attention_banded", "flash_fwd_stats", "flash_bwd_dkv",
               "flash_bwd_dq")


def run_kfpipe_phase(sd, sd9, control, kernels, card):
    """The keyframe pipeline (``pipelines/keyframe_inpaint.run``) and the
    warp-as-guidance pipeline (``pipelines/ofgen.run``) at 512x768, with
    the flow pair trained at 512x768 (fb confidence) and an 8-frame pan
    clip (``_pan_frames``); windows of 2 frames, stride 2, so the clip
    builds two levels (8 -> 4 -> 2 key frames) and 2 seed frames or 3:

    * run A, the CLI's configuration: ``warp_and_inpaint_crossattn``,
      ``level_batch`` 4 (2 frames a chunk at 512x768), ``flow_batch`` 8,
      ``n_seed_frames`` 2, 50 steps at strength 0.8;
    * run B: ``both`` ([target | reference] strips), ``level_batch`` 1
      (the serial loop), the ``[control]`` phase's ControlNet and HED as
      the control bundle, 20 steps.

    Each run: every frame generated, 512x768, its model outputs finite;
    its launches (counters reset just before, read just after) reach
    #1-#4, #6 (A) and #10 (both), and not #5 or #7-#9; s per generated
    frame of the seed strip and of each level's back-fill (host clock,
    synchronized). Then on run A's workspace: the fused prep
    (``_fused_prep_impl``, two references, f32 correlation) on the card
    against the CPU at 256x384 (merged within 4 LSB on >= 99% of pixels,
    covered >= 99% equal), its device time at 512x768 (profiler);
    ``expand_mask`` card against CPU (equal); the K/V store round trip
    (equal at f16) and its ms; the frame pipe's cache hits; one back-fill
    chunk of 2 frames under the profiler. Last ``ofgen.run`` on 3 frames
    (defaults: strength 0.4, 50 steps; flow from the same pair): 3
    converted_, 3 raw_ and 2 wrapped_ PNGs, s/frame. Returns (summary,
    the launch counts of runs A, B and ofgen, failures)."""
    import contextlib
    import os
    import tempfile

    import numpy as np

    from sd_animation_optical_flow_tpu_torch.models import flowconf as FC
    from sd_animation_optical_flow_tpu_torch.models import raft as RF
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        keyframe_inpaint as KI
    from sd_animation_optical_flow_tpu_torch.pipelines import ofgen as OF
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import (
        ARTIFACTS, load_flow_estimator)
    failures, summary, all_counts = [], {}, []
    pair = [os.path.join(ARTIFACTS, f"{n}_{H}x{W}.npz")
            for n in ("raft_synth", "uncertainty_head_synth")]
    est = load_flow_estimator(raft_path=pair[0], head_path=pair[1],
                              device="cuda")
    clip = _pan_frames(np.random.default_rng(SEED + 2), KFPIPE_FRAMES, H, W)

    # spies: outputs recorded as device tensors and read after each run;
    # the timed steps synchronize around themselves
    seen = {"finite": [], "kv": None, "steps": []}

    def spy(fn, image_of, keep_kv=False):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen["finite"].append(torch.isfinite(image_of(out)).all())
            if keep_kv and out[1] is not None:
                seen["kv"] = out[1]
            return out
        return wrapped

    def timed(fn, level_of, frames_of):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seen["steps"].append((level_of(a, k), frames_of(a, k),
                                  time.time() - t0))
            return out
        return wrapped

    patches = [
        mock.patch.object(F, "img2img", spy(F.img2img, lambda o: o[0],
                                            keep_kv=True)),
        mock.patch.object(F, "img2img_inpaint",
                          spy(F.img2img_inpaint, lambda o: o[0])),
        mock.patch.object(F, "img2img_inpaint_batch", spy(
            F.img2img_inpaint_batch,
            lambda o: o[0] if isinstance(o, tuple) else o)),
        mock.patch.object(KI, "generate_seed_frames", timed(
            KI.generate_seed_frames, lambda a, k: "seed",
            lambda a, k: len(a[3]))),
        mock.patch.object(KI, "_backfill_level_batched", timed(
            KI._backfill_level_batched, lambda a, k: a[7],
            lambda a, k: len(a[3]))),
        mock.patch.object(KI, "generate_with_refs", timed(
            KI.generate_with_refs, lambda a, k: k["level"],
            lambda a, k: 1))]
    shape = dict(size=(W, H), keep_every=1, kernel_size=2, stride=2,
                 dilation=1, n_seed_frames=2)
    runs = {"A": (KI.KeyframeInpaintConfig(
                mode="warp_and_inpaint_crossattn", level_batch=4,
                flow_batch=8, **shape), None),
            "B": (KI.KeyframeInpaintConfig(mode="both", level_batch=1,
                                           ddim_steps=20, **shape),
                  control)}
    out_root = Path(__file__).resolve().parent / "build"
    out_root.mkdir(parents=True, exist_ok=True)
    videos = {}
    with tempfile.TemporaryDirectory(dir=out_root) as tmp, \
            contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        for name, (cfg, bundle) in runs.items():
            video = KI.VideoWorkspace(f"{tmp}/{name}", frames=clip,
                                      size=(W, H), keep_every=1)
            videos[name] = video
            seen["finite"], seen["steps"] = [], []
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.time()
            KI.run(video, sd, sd9, est, tagger=None, cfg=cfg,
                   control_bundle=bundle)
            torch.cuda.synchronize()
            secs = time.time() - t0
            counts = {k: fn.launches for k, fn in kernels.items()}
            all_counts.append(counts)
            ai = [video.get_ai_frame(i) for i in range(video.num_frames)]
            ok = all(a is not None and a.shape == (H, W, 3) for a in ai) \
                and bool(seen["finite"]) \
                and all(f.item() for f in seen["finite"])
            levels = {}
            for level, n, s in seen["steps"]:
                tot = levels.setdefault(str(level), [0, 0.0])
                tot[0] += n
                tot[1] += s
            per_frame = {lv: s / n for lv, (n, s) in levels.items()}
            seeds = sorted(os.listdir(f"{tmp}/{name}/seed"))
            keys = {d: sorted(os.listdir(f"{tmp}/{name}/{d}"))
                    for d in sorted(os.listdir(f"{tmp}/{name}"))
                    if d.startswith("d")}
            summary[f"run_{name}"] = {
                "seconds": secs, "frames": video.num_frames,
                "s_per_frame_by_level": per_frame,
                "frames_by_level": {lv: n for lv, (n, _) in levels.items()},
                "launches": counts}
            log(f"[kfpipe] run {name} ({cfg.mode}, level_batch "
                f"{cfg.level_batch}, {cfg.ddim_steps} steps at strength "
                f"{cfg.denoising_strength}"
                + (", 2 ControlNets" if bundle else "") + f"): "
                f"{video.num_frames} frames of {H}x{W} in {secs:.2f} s; key "
                f"frames {keys}, seeds {seeds}; all generated, finite "
                f"{ok}; launches {counts}")
            for lv, s in per_frame.items():
                log(f"[kfpipe] run {name} s per generated frame, "
                    + ("seed strip" if lv == "seed" else f"level {lv} "
                       "back-fill")
                    + f" ({levels[lv][0]} frames): {s:.3f} s ({card})")
            if not ok:
                failures.append(f"kfpipe run {name}: frames or outputs bad")
            must = KFPIPE_KERNELS if name == "A" else tuple(
                k for k in KFPIPE_KERNELS if k != "flash_attention_keymask")
            for k in must:
                if counts[k] == 0:
                    failures.append(f"kfpipe run {name}: {k} never launched")
            for k in KFPIPE_IDLE:
                if counts[k]:
                    failures.append(f"kfpipe run {name}: {k} launched "
                                    f"{counts[k]} times")
        stack.close()               # the spies and timers off

        video = videos["A"]
        cfg_a = runs["A"][0]
        failures += _kfpipe_checks(video, est, seen["kv"], summary, card, KI,
                                   FC, RF)

        # one back-fill chunk under the profiler: the last 2 frames without
        # a K/V store (level 0's), from the frames with one (the seeds and
        # level 1), at level 1 (each frame stores its K/V)
        stored = {int(f[:5]) for f in os.listdir(
            f"{video.workspace_dir}/crossattn")}
        chunk = [i for i in range(video.num_frames) if i not in stored][-2:]
        rest = KI.FrameIndices(stored)
        cache = KI.FlowCache(est, video.workspace_dir, cfg_a.flow_batch)
        back = lambda: (KI._backfill_level_batched(
            sd9, None, video, KI.FrameIndices(chunk), rest, cache, cfg_a, 1,
            video.workspace_dir), torch.cuda.synchronize())
        reset_counts(kernels)
        prof = profile_frame(back, f"kfpipe back-fill chunk of frames "
                             f"{chunk} (crossattn, 40 steps)")
        summary["backfill_chunk"] = {
            "frames": chunk, "profile_busy_wall_ms": prof,
            "launches": {k: fn.launches for k, fn in kernels.items()}}
        log(f"[kfpipe] back-fill chunk of 2 frames under the profiler: "
            + (f"device busy {prof[0]:.1f} ms of {prof[1]:.1f} ms (idle "
               f"{1 - prof[0] / prof[1]:.3f})" if prof else "not measured")
            + f"; wrapper launches {summary['backfill_chunk']['launches']} "
            f"({card})")
        for v in videos.values():
            v.close()

        # ofgen on 3 frames, flow from the 512x768 pair
        def flow_calc(prev, cur):
            flow, _, _ = est.calc(prev[..., ::-1], cur[..., ::-1])
            return flow
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.time()
        out_dir = OF.run(clip[:3], f"{tmp}/ofgen", sd, flow_calc)
        torch.cuda.synchronize()
        of_s = (time.time() - t0) / 3
        of_counts = {k: fn.launches for k, fn in kernels.items()}
        all_counts.append(of_counts)
        names = sorted(os.listdir(out_dir))
        kinds = {k: sum(n.startswith(k + "_") for n in names)
                 for k in ("converted", "raw", "wrapped")}
        ok_of = kinds == {"converted": 3, "raw": 3, "wrapped": 2} and all(
            KI.read_png_bgr(os.path.join(out_dir, n)).shape == (H, W, 3)
            for n in names)
        summary["ofgen"] = {"s_per_frame": of_s, "files": kinds,
                            "launches": of_counts}
        log(f"[kfpipe] ofgen.run on 3 frames of {H}x{W} (strength 0.4, 50 "
            f"steps, latent guidance toward the warped previous frame): "
            f"{of_s:.3f} s/frame ({card}); files {kinds} at {H}x{W} {ok_of}; "
            f"launches {of_counts}")
        if not ok_of:
            failures.append(f"kfpipe ofgen: files {names}")
        for k in PIXEL_KERNELS:
            if of_counts[k] == 0:
                failures.append(f"kfpipe ofgen: {k} never launched")
    return summary, all_counts, failures


def _kfpipe_checks(video, est, kv, summary, card, KI, FC, RF):
    """[kfpipe]'s checks on run A's workspace (see run_kfpipe_phase)."""
    import numpy as np
    failures = []
    # the fused prep, card against CPU at 256x384, two references
    h, w = H // 2, W // 2
    crop = lambda a: np.ascontiguousarray(a[:h, :w])
    refs, idx = (0, 2), 1
    src = np.stack([crop(video.get_raw_frame(r)) for r in refs])
    ai = np.stack([crop(video.get_ai_frame(r)) for r in refs])
    tgt = crop(video.get_raw_frame(idx))
    cfg32 = FC.FlowConfidenceConfig(raft=RF.RAFTConfig(corr_dtype="float32"))
    outs = {}
    t0 = time.time()
    for dev, params, head in (("cuda", est.params, est.head_params),
                              ("cpu", to_cpu_f32(est.params),
                               to_cpu_f32(est.head_params))):
        up = lambda a: torch.as_tensor(a, device=dev)
        outs[dev] = [o.cpu() for o in KI._fused_prep_impl(
            params, head, cfg32, up(src), up(tgt), up(ai), thres=0.5,
            expand="dilate")]
    diff = (outs["cuda"][0].int() - outs["cpu"][0].int()).abs()
    within4 = (diff <= 4).float().mean().item()
    cov_eq = (outs["cuda"][1] == outs["cpu"][1]).float().mean().item()
    cover = (outs["cpu"][1] > 0).float().mean().item()
    summary["fused_prep_card_vs_cpu"] = {"merged_within_4": within4,
                                         "covered_equal": cov_eq,
                                         "covered_share": cover}
    log(f"[kfpipe] fused prep (RAFT + fb, 2 references, f32 correlation) "
        f"at {h}x{w}, card vs CPU: merged within 4 LSB on {within4:.5f} of "
        f"pixels (>= 0.99), covered equal on {cov_eq:.5f} (>= 0.99); "
        f"covered share {cover:.4f}; CPU and card {time.time() - t0:.1f} s")
    if not (within4 >= 0.99 and cov_eq >= 0.99):
        failures.append(f"kfpipe: fused prep card vs CPU merged {within4}, "
                        f"covered {cov_eq}")

    # its device time at 512x768, as run A calls it (one reference)
    prep = lambda: (KI.fused_flow_warp_merge(est, video, [0], idx,
                                             thres=0.5, expand="none"),
                    torch.cuda.synchronize())
    prep()
    prof = profile_frame(prep, f"kfpipe fused prep {H}x{W}, 1 reference")
    summary["fused_prep_profile_busy_wall_ms"] = prof
    log(f"[kfpipe] fused prep at {H}x{W}, one reference (RAFT fb pair, "
        f"warp, merge; bf16 correlation): device busy "
        + (f"{prof[0]:.2f} ms of {prof[1]:.2f} ms wall" if prof
           else "not measured") + f" ({card})")

    # expand_mask, card against CPU
    frame = video.get_raw_frame(idx)
    mask = (_blob_mask(H, W, H * 0.5, W * 0.4, H * 0.2,
                       torch.Generator("cuda").manual_seed(SEED))
            * 255).to(torch.uint8)
    e_card = KI.expand_mask(mask, frame)
    e_cpu = KI.expand_mask(mask.cpu(), frame)
    same = torch.equal(e_card.cpu(), e_cpu)
    summary["expand_mask_equal"] = same
    log(f"[kfpipe] expand_mask at {H}x{W}, card vs CPU equal {same} (mask "
        f"{(mask > 0).float().mean().item():.4f} -> "
        f"{(e_cpu > 0).float().mean().item():.4f} of the frame)")
    if not same:
        failures.append("kfpipe: expand_mask card vs CPU differ")

    # the K/V store: the seed strip's 16 pairs, round trip at f16
    if kv is None:
        failures.append("kfpipe: no K/V captured")
    else:
        torch.cuda.synchronize()
        t0 = time.time()
        video.put_kv(9999, kv)
        put_ms = 1e3 * (time.time() - t0)
        t0 = time.time()
        back = video.get_kv(9999)
        torch.cuda.synchronize()
        get_ms = 1e3 * (time.time() - t0)
        video.remove_kv(9999)
        equal = len(back) == len(kv) and all(
            torch.equal(b, t.half().bfloat16())
            for pb, pk in zip(back, kv) for b, t in zip(pb, pk))
        mb = sum(t.numel() for p in kv for t in p) * 2 / 2 ** 20
        summary["kv_store"] = {"equal_at_f16": equal, "put_ms": put_ms,
                               "get_ms": get_ms, "mib_f16": mb}
        log(f"[kfpipe] K/V store round trip ({len(kv)} pairs, {mb:.1f} MiB "
            f"at f16): equal {equal}; put_kv {put_ms:.1f} ms, get_kv "
            f"{get_ms:.1f} ms (host clock, synchronized; {card})")
        if not equal:
            failures.append("kfpipe: K/V store round trip differs")

    stats = video._frame_pipe.stats()
    summary["frame_pipe"] = stats
    log(f"[kfpipe] frame pipe over run A: {stats}")
    if stats["cache_hits"] <= 0:
        failures.append(f"kfpipe: frame pipe never hit its cache {stats}")
    return failures


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the other samplers and model variants
# ---------------------------------------------------------------------------

VARIANT_KERNELS = PIXEL_KERNELS       # #1-#4 on every UNet path
# no injection, strip, banded bias or gradient on these paths
VARIANT_IDLE = ("flash_attention_banded", "flash_attention_keymask",
                "flash_attention_mfr", "flash_fwd_stats", "flash_bwd_dkv",
                "flash_bwd_dq")
VARIANT_F32_LIMIT = 1e-3      # f32 card vs f32 CPU, TF32 off: sum order only
VARIANT_TIMED = 3             # timed runs of an entry point after its warm-up
# bf16 txt2img against the same weights in f32 (the dtype JAX's txt2img
# runs its UNet and VAE in): BASELINE.md's 40 dB quality gate
VARIANT_BF16_PSNR = 40.0


def _psnr_pm1(a, b):
    """PSNR of two images in [-1, 1] (peak to peak 2)."""
    mse = (a.float() - b.float()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10 * math.log10(4.0 / mse)


def _median_line(runs, unit="s", scale=1.0):
    """'median (min-max) unit' of a drive's timed runs."""
    v = sorted(scale * r for r in runs)
    return (f"{statistics.median(v):.3f} {unit} (median of {len(v)} after "
            f"a warm-up; {v[0]:.3f}-{v[-1]:.3f})")


def run_variants_phase(sd, kernels, gen, card):
    """The other samplers and model variants at 512x768, CFG 7, in the
    ``sd`` bundle's dtype (bf16); each drive runs once with the launch
    counters reset just before it and read just after, and each timed
    entry point then runs ``VARIANT_TIMED`` more times (host clock,
    synchronized; the median is printed, with the spread):

    * ``txt2img`` (50 DDIM steps), ``img2img_invert`` (50 steps, cfg 1),
      ``plms_decode`` (t_enc 20 of 50 from ``stochastic_encode`` of a
      VAE-encoded frame; exactly 21 UNet evaluations, read as #4's
      launches over those of one CFG evaluation), ``p_sample`` (10 DDPM
      steps from t = 999), the standalone ``dpmpp_2m_decode`` (10 steps
      from the dpmpp:10 entry level, plain and with the inpaint
      re-noise), each sampler's latent decoded;
    * ``txt2img`` on the same weights in f32 (the plain route, the dtype
      JAX's ``txt2img`` runs in), decoded PSNR >= ``VARIANT_BF16_PSNR``
      against the bf16 image; beside it, for scale, the f32 run from x_T
      rounded to bf16 (no gate);
    * cross-checks on the card: the standalone DPM++ against the
      multistep engine's ``make_dpmpp_coeffs`` and ``ddim_sample`` from a
      given x_T against the engine's ``make_ddim_coeffs(ddim, 50)`` (the
      JAX identities), each pair decoded at >= 40 dB;
    * ``img2img_depth2img`` on ``create_model("sd15-depth")`` with a
      full-width ``DPTConfig()`` from random weights (head bias 0.5),
      strength 0.5, 50 steps, and the DPT's device ms; ``upscale`` on
      ``create_model("sd-upscale")``, 64x96 -> 512x768 at noise level
      20, 50 steps; a full-width VQ round trip (``VQConfig()``, bf16);
      OpenCLIP and T5 at full width on 77 tokens (f32);
    * card against CPU: the class-conditional UNet with y at full width
      on a [1, 16, 24, 7] latent, the DPT at 256x384 (the position
      table resized to a non-square grid), OpenCLIP and T5 at full width
      with 2 layers (f32 both sides: ``VARIANT_F32_LIMIT``), VQ
      ``quantize``'s indices (equal on >= 99.9%);
    * one txt2img UNet evaluation under the profiler.

    #1-#4 must launch on every UNet path, #2 on the VQ round trip, #5-#10
    on none. Returns (summary, the launch counts of each drive,
    failures)."""
    import dataclasses

    from sd_animation_optical_flow_tpu_torch import config as C
    from sd_animation_optical_flow_tpu_torch.config import _channels_last
    from sd_animation_optical_flow_tpu_torch.diffusion import ddim as D
    from sd_animation_optical_flow_tpu_torch.diffusion import ddpm_sampler \
        as DDPM
    from sd_animation_optical_flow_tpu_torch.diffusion import multistep as MS
    from sd_animation_optical_flow_tpu_torch.diffusion.dpm_solver import (
        dpmpp_2m_decode, uniform_timesteps_desc)
    from sd_animation_optical_flow_tpu_torch.diffusion.plms import \
        plms_decode
    from sd_animation_optical_flow_tpu_torch.diffusion.schedule import \
        make_ddim_params_traced
    from sd_animation_optical_flow_tpu_torch.models import depth as DE
    from sd_animation_optical_flow_tpu_torch.models import text_encoders \
        as TE
    from sd_animation_optical_flow_tpu_torch.models import unet as U
    from sd_animation_optical_flow_tpu_torch.models import vae as V
    from sd_animation_optical_flow_tpu_torch.models import vq as VQ
    from sd_animation_optical_flow_tpu_torch.models.layers import Init
    from sd_animation_optical_flow_tpu_torch.ops import attention as A
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        specializations as SP
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_map
    failures, summary, all_counts = [], {}, []
    prompt, neg = "a watercolor fox in the snow", "lowres, blurry"
    f = sd.vae_cfg.downscale
    h, w = H // f, W // f
    ctx_c = sd.get_learned_conditioning(prompt)
    ctx_u = sd.get_learned_conditioning(neg)
    cond, uncond = D.CondBundle(ctx_c), D.CondBundle(ctx_u)
    unet_fn = F._unet_fn(sd)
    sched = sd.sched
    ddim = make_ddim_params_traced(sched, STEPS)
    img = torch.rand((1, H, W, 3), generator=gen, device="cuda") * 2 - 1
    decode = lambda z: V.decode(sd.vae_params, sd.vae_cfg,
                                z.to(sd.dtype)).clamp(-1.0, 1.0)
    decoded = lambda z: (z, decode(z))
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")

    def check_image(name, out, shape=(1, H, W, 3)):
        ok = tuple(out.shape) == shape and bool(torch.isfinite(out).all()) \
            and out.abs().max().item() <= 1.0
        if not ok:
            failures.append(f"variants {name}: output {tuple(out.shape)} "
                            "not finite / in [-1, 1] / of shape "
                            f"{shape}")
        return ok

    def drive(name, run, need=VARIANT_KERNELS, timed=0, timed_run=None):
        """Run once with the counters reset just before and read just
        after (the warm-up of the timed runs), then ``timed`` more runs
        of ``timed_run`` (default ``run``; a sampler without its decode)
        on the host clock, synchronized. Returns (the counted run's
        output, the timed runs' seconds, counts)."""
        reset_counts(kernels)
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in kernels.items()}
        all_counts.append(counts)
        for k in need:
            if counts[k] == 0:
                failures.append(f"variants {name}: {k} never launched")
        summary.setdefault("launches", {})[name] = counts
        runs = []
        for _ in range(timed):
            t0 = time.time()
            (timed_run or run)()
            torch.cuda.synchronize()
            runs.append(time.time() - t0)
        if runs:
            summary.setdefault("runs_s", {})[name] = runs
        return out, runs, counts

    # one CFG evaluation as txt2img makes it (f32 carry, bf16 UNet): #4's
    # launches a evaluation, and its profile
    x_T = rn(1, h, w, 4)
    ts = torch.full((1,), int(ddim.timesteps[-1]), dtype=torch.int32,
                    device="cuda")
    one_eval = lambda: D.cfg_model_call(unet_fn, x_T, ts, cond, uncond, CFG)
    _, _, c_eval = drive("one CFG evaluation", one_eval,
                         need=("flash_attention_tpv", "linear_ln_fused",
                               "geglu_ff_fused"))
    n4 = c_eval["geglu_ff_fused"]
    prof = profile_frame(one_eval, "variants txt2img UNet evaluation")
    summary["txt2img_eval_busy_wall_ms"] = prof

    # txt2img, then the same weights in f32, then ddim_sample against the
    # multistep engine
    out, runs, _ = drive("txt2img", lambda: F.txt2img(
        sd, prompt, neg, H, W, ddim_steps=STEPS, cfg_scale=CFG, seed=SEED),
        timed=VARIANT_TIMED)
    check_image("txt2img", out)
    log(f"[variants] txt2img {STEPS} steps: {_median_line(runs)} an image, "
        f"std {out.float().std().item():.4f} [{card}]")
    summary["txt2img_s"] = statistics.median(runs)
    t0 = time.time()
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    sd32 = dataclasses.replace(
        sd, unet_params=f32(sd.unet_params), vae_params=f32(sd.vae_params),
        clip_params=f32(sd.clip_params), dtype=torch.float32)
    # the kernels take bf16: f32 attention goes to the plain version (the
    # FFN's router already sends f32 there)
    plain = mock.patch.multiple(A, flash_attention_tpv=A.xla_attention,
                                flash_attention=A.xla_attention)
    with plain:
        img32 = F.txt2img(sd32, prompt, neg, H, W, ddim_steps=STEPS,
                          cfg_scale=CFG, seed=SEED)
    s32 = time.time() - t0
    x_T32 = torch.randn((1, h, w, 4), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    with plain:
        img32r = F._txt2img_core(
            sd32, sd32.get_learned_conditioning(prompt),
            sd32.get_learned_conditioning(neg), x_T32.bfloat16().float(),
            ddim_steps=STEPS, cfg_scale=CFG)
    psnr_bf16 = _psnr_pm1(out, img32)
    psnr_xt = _psnr_pm1(img32r, img32)
    rel_bf16 = _rel_l2(out, img32.cpu())
    log(f"[variants] txt2img bf16 (kernels) vs the same weights in f32 (plain "
        f"route, JAX's dtype here): decoded PSNR {psnr_bf16:.2f} dB (>= "
        f"{VARIANT_BF16_PSNR:g}), rel L2 "
        f"{rel_bf16:.3e}; for scale, f32 from x_T rounded to bf16 vs f32: "
        f"{psnr_xt:.2f} dB (f32 run {s32:.1f} s, one run) [{card}]")
    summary["txt2img_bf16_vs_f32"] = {"psnr_db": psnr_bf16,
                                      "rel_l2": rel_bf16,
                                      "f32_xT_bf16_psnr_db": psnr_xt}
    if not psnr_bf16 >= VARIANT_BF16_PSNR:
        failures.append(f"variants: txt2img bf16 vs f32 {psnr_bf16:.2f} dB")
    del sd32, img32, img32r
    torch.cuda.empty_cache()
    (lat_a, img_a), _, _ = drive("ddim_sample", lambda: decoded(
        D.ddim_sample(unet_fn, sched, ddim, cond, uncond, x_T=x_T,
                      cfg_scale=CFG)))
    (lat_b, img_b), _, _ = drive("multistep ddim", lambda: decoded(
        MS.multistep_decode(unet_fn, MS.make_ddim_coeffs(ddim, STEPS), x_T,
                            cond, uncond, cfg_scale=CFG)))
    check_image("ddim_sample", img_a)
    psnr = _psnr_pm1(img_a, img_b)
    rel = ((lat_a - lat_b).norm() / lat_b.norm()).item()
    log(f"[variants] ddim_sample vs multistep_decode(make_ddim_coeffs(ddim, "
        f"{STEPS})) from one x_T: decoded PSNR {psnr:.2f} dB (>= 40), "
        f"latent rel L2 {rel:.3e}")
    summary["ddim_vs_engine"] = {"psnr_db": psnr, "latent_rel": rel}
    if not psnr >= 40.0:
        failures.append(f"variants: ddim_sample vs the engine {psnr:.2f} dB")

    # DDIM inversion
    lat, runs, _ = drive("img2img_invert", lambda: F.img2img_invert(
        sd, img, prompt, neg, ddim_steps=STEPS, seed=SEED),
        timed=VARIANT_TIMED)
    ok = tuple(lat.shape) == (1, h, w, 4) and bool(torch.isfinite(lat).all())
    if not ok:
        failures.append(f"variants img2img_invert: latent {tuple(lat.shape)}")
    log(f"[variants] img2img_invert {STEPS} steps (cfg 1): "
        f"{_median_line(runs)} an image, latent std "
        f"{lat.float().std().item():.4f} [{card}]")
    summary["invert_s"] = statistics.median(runs)

    # PLMS from the main path's stochastic_encode
    init_latent = V.encode(sd.vae_params, sd.vae_cfg, img.to(sd.dtype),
                           noise=rn(1, h, w, 4))
    t_enc = F._t_enc(STRENGTH, STEPS)       # 20 of 50, the main path's
    x1 = D.stochastic_encode(ddim, init_latent, t_enc, rn(1, h, w, 4))
    out, runs, c_plms = drive("plms", lambda: decode(plms_decode(
        unet_fn, sched, ddim, x1, cond, uncond, t_enc, cfg_scale=CFG)),
        timed=VARIANT_TIMED)
    check_image("plms", out)
    evals = c_plms["geglu_ff_fused"] / max(n4, 1)
    log(f"[variants] plms_decode t_enc {t_enc} of {STEPS} incl. the decode: "
        f"{_median_line(runs)} an image, {evals:g} UNet evaluations (#4 "
        f"{c_plms['geglu_ff_fused']} / {n4} an evaluation; t_enc + 1 = "
        f"{t_enc + 1}) [{card}]")
    summary["plms_s"], summary["plms_evals"] = statistics.median(runs), evals
    if evals != t_enc + 1:
        failures.append(f"variants plms: {evals} UNet evaluations")

    # DDPM ancestral steps from t = 999 (timed without the decode)
    pc = DDPM.posterior_coefs(sched)
    ddpm_noise = rn(10, 1, h, w, 4)

    def ddpm():
        x = x_T
        for i, t_i in enumerate(range(999, 989, -1)):
            t = torch.full((1,), t_i, dtype=torch.int32, device="cuda")
            x = DDPM.p_sample(unet_fn, sched, pc, x, t, cond, uncond,
                              noise=ddpm_noise[i], cfg_scale=CFG)
        return x
    out, runs, _ = drive("ddpm", lambda: decode(ddpm()), timed=VARIANT_TIMED,
                         timed_run=ddpm)
    check_image("ddpm", out)
    log(f"[variants] p_sample 10 DDPM steps from t = 999, without the "
        f"decode: {_median_line(runs, 'ms', 1e3 / 10)} a step [{card}]")
    summary["ddpm_ms_step"] = 1e3 * statistics.median(runs) / 10

    # the standalone DPM-Solver++(2M), plain and with the inpaint re-noise
    # (timed without the decode), and the engine's coefficients on the
    # same x
    dts = uniform_timesteps_desc(sched, int(ddim.timesteps[t_enc]), 10)
    dpmpp = lambda: dpmpp_2m_decode(unet_fn, sched, dts, x1, cond, uncond,
                                    cfg_scale=CFG)
    (lat_p, img_p), runs, _ = drive("dpmpp", lambda: decoded(dpmpp()),
                                    timed=VARIANT_TIMED, timed_run=dpmpp)
    check_image("dpmpp", img_p)
    nmask = _blob_mask(h, w, h * 0.5, w * 0.5, h * 0.3, gen)[None, :, :, None]
    renoise = rn(10, 1, h, w, 4)
    inpaint = lambda: dpmpp_2m_decode(
        unet_fn, sched, dts, x1, cond, uncond, cfg_scale=CFG,
        init_latent=init_latent, nmask=nmask, renoise_gate=[1.0] * 10,
        renoise_noise=renoise)
    out, runs_inp, _ = drive("dpmpp inpaint", lambda: decode(inpaint()),
                             timed=VARIANT_TIMED, timed_run=inpaint)
    check_image("dpmpp inpaint", out)
    (lat_e, img_e), _, _ = drive("multistep dpmpp", lambda: decoded(
        MS.multistep_decode(unet_fn, MS.make_dpmpp_coeffs(sched, dts), x1,
                            cond, uncond, cfg_scale=CFG)))
    psnr = _psnr_pm1(img_p, img_e)
    rel = ((lat_p.float() - lat_e.float()).norm()
           / lat_e.float().norm()).item()
    log(f"[variants] dpmpp_2m_decode 10 steps, without the decode: "
        f"{_median_line(runs, 'ms', 1e3 / 10)} a step; with the inpaint "
        f"re-noise {_median_line(runs_inp, 'ms', 1e3 / 10)}; vs "
        f"multistep_decode(make_dpmpp_coeffs): decoded PSNR {psnr:.2f} dB "
        f"(>= 40), latent rel L2 {rel:.3e} [{card}]")
    summary["dpmpp_ms_step"] = 1e3 * statistics.median(runs) / 10
    summary["dpmpp_inpaint_ms_step"] = 1e3 * statistics.median(runs_inp) / 10
    summary["dpmpp_vs_engine"] = {"psnr_db": psnr, "latent_rel": rel}
    if not psnr >= 40.0:
        failures.append(f"variants: dpmpp_2m_decode vs the engine "
                        f"{psnr:.2f} dB")

    # depth2img with a full-width DPT
    t0 = time.time()
    sdd = C.create_model("sd15-depth", dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(5))
    perturb_zero_convs(sdd.unet_params, gen)
    dcfg = DE.DPTConfig()
    dp = _channels_last(DE.dpt_init(Init(torch.Generator("cuda")
                                         .manual_seed(6), torch.float32,
                                         "cuda"), dcfg))
    dp["head"][2]["b"] = torch.full((1,), 0.5, device="cuda")
    depth = SP.DepthConditioner(dp, dcfg)
    log(f"[variants] sd15-depth and a DPTConfig() DPT "
        f"({sum(t.numel() for t in _leaves(dp)) / 1e6:.1f} M parameters, "
        f"f32) random init in {time.time() - t0:.1f} s")
    out, runs, _ = drive("depth2img", lambda: SP.img2img_depth2img(
        sdd, depth, img, prompt, neg, 0.5, ddim_steps=STEPS, cfg_scale=CFG,
        seed=SEED)[0], timed=VARIANT_TIMED)
    check_image("depth2img", out)
    cc = SP.depth_concat(depth, img, (h, w))
    dpt_ms = cuda_ms(lambda: SP.depth_concat(depth, img, (h, w)), iters=3,
                     queued=False)
    log(f"[variants] img2img_depth2img strength 0.5, {STEPS} steps: "
        f"{_median_line(runs)} an image; the DPT + depth_to_concat at "
        f"{H}x{W} (f32) {dpt_ms:.1f} ms (CUDA events), depth channel std "
        f"{cc.std().item():.4f} [{card}]")
    summary["depth2img_s"] = statistics.median(runs)
    summary["dpt_ms"] = dpt_ms
    if not cc.std().item() > 0:
        failures.append("variants depth2img: a constant depth channel")
    small = torch.rand((1, H // 2, W // 2, 3), generator=gen,
                       device="cuda") * 2 - 1
    d_card = DE.dpt_apply(dp, dcfg, DE.midas_normalize((small + 1) * 0.5))
    t0 = time.time()
    d_cpu = DE.dpt_apply(to_cpu_f32(dp), dcfg,
                         DE.midas_normalize((small.cpu() + 1) * 0.5))
    rel_dpt = _rel_l2(d_card, d_cpu)
    grid, p = dcfg.img_size // dcfg.patch, dcfg.patch
    log(f"[variants] DPT card vs CPU at {H // 2}x{W // 2} (grid "
        f"{H // 2 // p}x{W // 2 // p} from the {grid}x{grid} table), f32: "
        f"rel L2 {rel_dpt:.3e} (<= {VARIANT_F32_LIMIT:g}; CPU "
        f"{time.time() - t0:.1f} s)")
    summary["dpt_rel_l2_cpu"] = rel_dpt
    if not rel_dpt <= VARIANT_F32_LIMIT:
        failures.append(f"variants: DPT card vs CPU {rel_dpt:.3e}")
    del sdd, depth, dp
    torch.cuda.empty_cache()

    # the latent upscaler
    sdu = C.create_model("sd-upscale", dtype=torch.bfloat16, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(4))
    perturb_zero_convs(sdu.unet_params, gen)
    x_low = torch.rand((1, h, w, 3), generator=gen, device="cuda") * 2 - 1
    (out, lvl), runs, _ = drive("upscale", lambda: SP.upscale(
        sdu, x_low, prompt, neg, noise_level=[20], ddim_steps=STEPS,
        cfg_scale=CFG, seed=SEED), timed=VARIANT_TIMED)
    check_image("upscale", out)
    log(f"[variants] upscale {h}x{w} -> {tuple(out.shape[1:3])}, noise level "
        f"{lvl.tolist()}, {STEPS} steps: {_median_line(runs)} an image "
        f"[{card}]")
    summary["upscale_s"] = statistics.median(runs)
    if lvl.tolist() != [20]:
        failures.append(f"variants upscale: level {lvl.tolist()} != [20]")
    xs = torch.randn((1, 16, 24, 7), generator=gen, device="cuda")
    tt = torch.full((1,), 401, dtype=torch.int32, device="cuda")
    yy = torch.tensor([20], device="cuda")
    f32_card = tree_map(lambda t: t.float(), sdu.unet_params)
    del sdu
    torch.cuda.empty_cache()
    u_card, _ = U.unet_apply(f32_card, C.SD_UPSCALE.unet, xs, tt,
                             ctx_c.float(), y=yy)
    t0 = time.time()
    u_cpu, _ = U.unet_apply(to_cpu_f32(f32_card), C.SD_UPSCALE.unet,
                            xs.cpu(), tt.cpu(), ctx_c.float().cpu(),
                            y=yy.cpu())
    rel_u = _rel_l2(u_card, u_cpu)
    log(f"[variants] class-conditional UNet (sd-upscale, y = 20) card vs CPU "
        f"on a [1, 16, 24, 7] latent, f32: rel L2 {rel_u:.3e} (<= "
        f"{VARIANT_F32_LIMIT:g}; CPU {time.time() - t0:.1f} s)")
    summary["unet_y_rel_l2_cpu"] = rel_u
    if not rel_u <= VARIANT_F32_LIMIT:
        failures.append(f"variants: class-conditional UNet card vs CPU "
                        f"{rel_u:.3e}")
    del f32_card, u_card
    torch.cuda.empty_cache()

    # the VQ first stage
    vcfg = VQ.VQConfig()
    vqp = _channels_last(VQ.vq_init(Init(torch.Generator("cuda")
                                         .manual_seed(7), torch.bfloat16,
                                         "cuda"), vcfg))
    vq_trip = lambda: VQ.vq_decode(vqp, vcfg, VQ.vq_encode_prequant(
        vqp, vcfg, img.to(torch.bfloat16)))
    out, _, _ = drive("vq round trip", vq_trip, need=("flash_attention",))
    ok = tuple(out.shape) == (1, H, W, 3) and bool(torch.isfinite(out).all())
    if not ok:
        failures.append(f"variants vq: output {tuple(out.shape)} not finite")
    vq_ms = cuda_ms(vq_trip, iters=3, queued=False)
    z = VQ.vq_encode_prequant(vqp, vcfg, img.to(torch.bfloat16)).float()
    _, _, idx_card = VQ.quantize(vqp["quantize"], vcfg, z)
    _, _, idx_cpu = VQ.quantize(to_cpu_f32(vqp["quantize"]), vcfg, z.cpu())
    same = (idx_card.cpu() == idx_cpu).float().mean().item()
    log(f"[variants] VQ round trip (VQConfig(), bf16, n_embed "
        f"{vcfg.n_embed}) at {H}x{W}: {vq_ms:.1f} ms (CUDA events, 3 "
        f"calls after 2); quantize's indices card vs CPU equal on "
        f"{same:.5f} (>= 0.999), {len(idx_cpu.unique())} codes used "
        f"[{card}]")
    summary["vq_ms"], summary["vq_index_agreement"] = vq_ms, same
    if not same >= 0.999:
        failures.append(f"variants: VQ indices card vs CPU agree on {same}")
    del vqp
    torch.cuda.empty_cache()

    # OpenCLIP and T5 at full width
    for name, cfg_, init_, apply_ in (
            ("OpenCLIP", TE.OpenCLIPTextConfig(), TE.openclip_text_init,
             TE.openclip_text_apply),
            ("T5", TE.T5Config(), TE.t5_encoder_init, TE.t5_encoder_apply)):
        p = init_(Init(torch.Generator("cuda").manual_seed(8), torch.float32,
                       "cuda"), cfg_)
        ids = torch.randint(0, cfg_.vocab_size, (1, 77), generator=gen,
                            device="cuda")
        out = apply_(p, cfg_, ids)
        ms = cuda_ms(lambda: apply_(p, cfg_, ids), iters=3, queued=False)
        width = out.shape[-1]
        ok = tuple(out.shape) == (1, 77, width) and bool(
            torch.isfinite(out).all())
        two = dataclasses.replace(cfg_, layers=2)
        p2 = {**p, "layers": p["layers"][:2]}
        rel = _rel_l2(apply_(p2, two, ids), apply_(to_cpu_f32(p2), two,
                                                   ids.cpu()))
        log(f"[variants] {name} full width ({cfg_.layers} layers, f32) on 77 "
            f"tokens: {ms:.2f} ms (CUDA events), finite {ok}; card vs CPU "
            f"with 2 layers rel L2 {rel:.3e} (<= {VARIANT_F32_LIMIT:g}) "
            f"[{card}]")
        summary[f"{name.lower()}_ms"] = ms
        summary[f"{name.lower()}_rel_l2_cpu"] = rel
        if not ok:
            failures.append(f"variants {name}: output not finite / shape")
        if not rel <= VARIANT_F32_LIMIT:
            failures.append(f"variants {name}: card vs CPU {rel:.3e}")
        del p, p2

    for k in VARIANT_IDLE:
        n = sum(c[k] for c in all_counts)
        if n:
            failures.append(f"variants: {k} launched {n} times")
    return summary, all_counts, failures


# ---------------------------------------------------------------------------
# the serving side of parallel/ at world size 1
# ---------------------------------------------------------------------------

PARALLEL_STEPS, PARALLEL_STRENGTH = 20, 0.4
PARALLEL_PSNR = 40.0            # BASELINE.md's gate, decoded frames
PARALLEL_BATCH_LIMIT = 2e-2     # x max |out|, the kernel rows' limit
PARALLEL_KERNELS = ("flash_attention_tpv", "linear_ln_fused",
                    "geglu_ff_fused", "flash_attention_mfr")


def _psnr255(a, b):
    import numpy as np
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def run_parallel_phase(sd, sd9, keys_kv, kernels, gen, card):
    """The serving side of ``parallel/`` on one card: an NCCL process group
    of world size 1 over a ``file://`` store in a temporary directory
    (no gloo fallback: the phase fails if NCCL does not start) and
    ``make_mesh(dp=1)`` on cuda, then, each run with the launch counters
    reset just before it and read just after (host clock, synchronized):

    (a) the keyframe pipeline's 2-tile 'mutual' seed strip at 512x1536
        (``generate_seed_frames``, sd15, 20 steps at strength 0.4, CFG 7,
        K/V captured) with ``cfg.sp`` (rows sharded over the mesh's dp
        axis: halo convolutions, reduced GroupNorms, Ulysses with #10
        inside) and without: decoded frames at >= ``PARALLEL_PSNR`` of
        each other, the launches of #1, #3, #4 and #10 equal, #10 > 0;
    (b) ``img2img_inpaint_batch`` on sd15-inpaint9, 2 frames of 512x768
        with per-frame K/V of the two keyframes, with ``mesh`` (dp 1) and
        without: within ``PARALLEL_BATCH_LIMIT`` x max |out|, the K/V
        stores equal in shape, #6 launched;
    (c) ``pixel_inpaint.run_batched`` on 3 frames (a key frame, then one
        batch of 2) at dp 1 and dp 0: the same files, byte for byte;
    (d) one sd15 UNet evaluation at 512x768 (CFG batch 2, bf16) on the
        ``shard_params`` tree with ``tp`` (tp 1: the collectives run, #4
        with its bias and residual added after the reduction) and on the
        whole params without: eps within ``PARALLEL_BATCH_LIMIT`` x max
        |eps|, the launches of #1, #3 and #4 equal and above 0;
    (e) the sharded train step (:func:`check_sharded_train`).

    Each pair of (a), (b) and (d) runs plain, parallel, plain, parallel
    (the first two counted; the lesser time of each printed), and (a)
    once more each under the profiler; (c) runs once each. At world size 1
    the collectives
    move nothing between cards: the s/image beside each pair is the cost
    of the collectives and the re-slicing, not a speed-up. The group is
    destroyed at the end.
    Returns (summary, the launch counts of each inference run, those of
    each sharded train step, failures)."""
    import os
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from sd_animation_optical_flow_tpu_torch.models.unet import (
        SeqParallelConfig, TensorParallelConfig, unet_apply)
    from sd_animation_optical_flow_tpu_torch.parallel.mesh import make_mesh
    from sd_animation_optical_flow_tpu_torch.parallel.sharding import \
        shard_params
    from sd_animation_optical_flow_tpu_torch.pipelines import facades as F
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        keyframe_inpaint as KI
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
        load_flow_estimator
    failures, summary, all_counts, train_counts = [], {}, [], []
    prompt, neg = "a watercolor fox in the snow", "lowres, blurry"
    out_root = Path(__file__).resolve().parent / "build"
    out_root.mkdir(parents=True, exist_ok=True)

    def counted(run):
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.time()
        out = run()
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}
        all_counts.append(counts)
        return out, secs, counts

    def pair(calls):
        """{name: run} of the plain call and the parallel one: each run
        once counted, in that order, then once more; {name: (the counted
        run's output, the lesser of its two times, its counts)}."""
        res = {name: list(counted(run)) for name, run in calls.items()}
        for name, run in calls.items():
            torch.cuda.synchronize()
            t0 = time.time()
            run()
            torch.cuda.synchronize()
            res[name][1] = min(res[name][1], time.time() - t0)
        return res

    with tempfile.TemporaryDirectory(dir=out_root) as tmp:
        os.environ["NCCL_SOCKET_IFNAME"] = "lo"
        try:
            torch.cuda.set_device(0)
            dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                    world_size=1, rank=0)
            mesh = make_mesh(dp=1, tp=1)
            warm = torch.ones(1, device="cuda")
            dist.all_reduce(warm, group=mesh.get_group("dp"))
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            failures.append(f"parallel: NCCL at world size 1 did not start "
                            f"({e})")
            if dist.is_initialized():
                dist.destroy_process_group()
            return summary, all_counts, train_counts, failures
        log(f"[parallel] process group {dist.get_backend()} world size "
            f"{dist.get_world_size()}, mesh {mesh.mesh_dim_names} "
            f"{tuple(mesh.mesh.shape)} on {mesh.device_type}")
        try:
            # (a) the seed strip, sp and not
            frames = _pan_frames(np.random.default_rng(SEED + 3), 2, H, W)
            video = KI.VideoWorkspace(f"{tmp}/ws", frames=frames,
                                      size=(W, H), keep_every=1)
            def seed_strip(sp):
                cfg = KI.KeyframeInpaintConfig(
                    size=(W, H), keep_every=1, ddim_steps=PARALLEL_STEPS,
                    denoising_strength=PARALLEL_STRENGTH, sp=sp)
                return lambda: KI.generate_seed_frames(
                    sd, None, video, KI.FrameIndices([0, 1]), cfg)
            calls = {"plain": seed_strip(None),
                     "sp": seed_strip(SeqParallelConfig(mesh))}
            strips = pair(calls)
            (tiles_sp, kv_sp), (tiles, kv) = strips["sp"][0], \
                strips["plain"][0]
            psnr = min(_psnr255(a, b) for a, b in zip(tiles_sp, tiles))
            same = {k: (strips["sp"][2][k], strips["plain"][2][k])
                    for k in PARALLEL_KERNELS}
            kv_ok = [tuple(k.shape) for k, _ in kv_sp] \
                == [tuple(k.shape) for k, _ in kv]
            summary["seed_strip"] = {
                "psnr_db": psnr, "s_sp": strips["sp"][1],
                "s_plain": strips["plain"][1], "launches": same,
                "profile_busy_wall_ms": {
                    name: profile_frame(run, f"parallel seed strip {name}")
                    for name, run in calls.items()}}
            if not psnr >= PARALLEL_PSNR:
                failures.append(f"parallel: seed strip sp vs plain "
                                f"{psnr:.2f} dB < {PARALLEL_PSNR}")
            if any(a != b for a, b in same.values()) \
                    or not same["flash_attention_mfr"][0]:
                failures.append(f"parallel: seed strip launches {same}")
            if not kv_ok:
                failures.append("parallel: seed strip K/V shapes differ")

            # (b) the dp batch, mesh and not
            ka, kb = keys_kv
            per_frame = tuple(
                tuple(torch.cat([torch.cat([a[i], b[i]], 1),
                                 torch.cat([b[i], a[i]], 1)])
                      for i in range(2))
                for a, b in zip(ka, kb))
            imgs = torch.rand((2, H, W, 3), generator=gen,
                              device="cuda") * 2 - 1
            refs = torch.rand((2, H, W, 3), generator=gen,
                              device="cuda") * 2 - 1
            mask = _blob_mask(H, W, H * 0.49, W * 0.51, H * 0.29, gen)
            masks = torch.stack([mask, mask.flip(1)])
            def batch(m):
                return lambda: F.img2img_inpaint_batch(
                    sd9, imgs, [prompt, prompt], neg, masks, refs,
                    PARALLEL_STRENGTH, ddim_steps=PARALLEL_STEPS,
                    mask_blur=4, cfg_scale=CFG, seed=SEED,
                    reference_kv=per_frame, capture_kv=True, mesh=m)
            batches = pair({"plain": batch(None), "mesh": batch(mesh)})
            (out, bkv), (ref, ref_kv) = batches["mesh"][0], \
                batches["plain"][0]
            err = (out.float() - ref.float()).abs().max().item() \
                / max(ref.float().abs().max().item(), 1e-12)
            kv_ok = [tuple(k.shape) for k, _ in bkv] \
                == [tuple(k.shape) for k, _ in ref_kv]
            summary["inpaint_batch"] = {
                "rel_err": err, "s_mesh": batches["mesh"][1],
                "s_plain": batches["plain"][1],
                "keymask_launches": batches["mesh"][2][
                    "flash_attention_keymask"]}
            if not (err <= PARALLEL_BATCH_LIMIT and kv_ok
                    and tuple(out.shape) == (2, H, W, 3)):
                failures.append(f"parallel: dp batch rel err {err:.3e}, K/V "
                                f"shapes equal {kv_ok}")
            if not batches["mesh"][2]["flash_attention_keymask"]:
                failures.append("parallel: dp batch never launched #6")

            # (c) run_batched, dp 1 and dp 0
            est = load_flow_estimator(device="cuda")
            triples = [(f, i == 0, i) for i, f in enumerate(
                _pan_frames(np.random.default_rng(SEED + 4), 3, H, W))]
            files, pixel_s = {}, {}
            for dp in (0, 1):
                cfg = PI.PixelInpaintConfig(
                    name="smoke", denoising_strength=PARALLEL_STRENGTH,
                    ddim_steps=PARALLEL_STEPS, frame_batch=2, dp=dp,
                    write_vis=False)
                out_dir, secs, _ = counted(lambda: PI.run_batched(
                    iter(triples), f"{tmp}/dp{dp}", sd, sd9, est,
                    tagger=None, cfg=cfg))
                files[dp] = {n: Path(out_dir, n).read_bytes()
                             for n in sorted(os.listdir(out_dir))}
                pixel_s[dp] = secs / len(triples)
            equal = len(files[1]) == 3 and files[1] == files[0]
            summary["run_batched"] = {"files_equal": equal,
                                      "s_a_frame_dp1": pixel_s[1],
                                      "s_a_frame_dp0": pixel_s[0]}
            if not equal:
                failures.append("parallel: run_batched dp 1 files differ "
                                f"from dp 0 ({sorted(files[1])})")

            # (d) the tp forward at tp 1 against the whole params
            local, _ = shard_params(sd.unet_params, mesh)
            lat = torch.randn((1, H // 8, W // 8, 4), generator=gen,
                              device="cuda").to(sd.dtype).repeat(2, 1, 1, 1)
            t = torch.full((2,), 401, dtype=torch.int32, device="cuda")
            ctx = torch.cat([sd.get_learned_conditioning(neg),
                             sd.get_learned_conditioning(prompt)]).to(sd.dtype)

            def evaluate(params, tp):
                def run():
                    with torch.no_grad():
                        return unet_apply(params, sd.unet_cfg, lat, t, ctx,
                                          tp=tp)[0]
                return run
            evals = pair({"plain": evaluate(sd.unet_params, None),
                          "tp": evaluate(local, TensorParallelConfig(mesh))})
            eps, eps_tp = (evals[k][0].float() for k in ("plain", "tp"))
            err = (eps_tp - eps).abs().max().item() \
                / max(eps.abs().max().item(), 1e-12)
            same = {k: (evals["tp"][2][k], evals["plain"][2][k])
                    for k in PARALLEL_KERNELS[:3]}
            summary["tp_forward"] = {
                "rel_err": err, "s_tp": evals["tp"][1],
                "s_plain": evals["plain"][1], "launches": same}
            if not (err <= PARALLEL_BATCH_LIMIT
                    and bool(torch.isfinite(eps_tp).all())):
                failures.append(f"parallel: tp forward rel err {err:.3e}")
            if any(a != b or not a for a, b in same.values()):
                failures.append(f"parallel: tp forward launches {same}")
            del local, evals, eps, eps_tp

            # (e) the sharded train step at dp 1 x tp 1
            summary["sharded_train"], train_counts, train_failures = \
                check_sharded_train(sd, mesh, kernels, gen)
            failures += train_failures
        finally:
            dist.destroy_process_group()
    s = summary
    log(f"[parallel] world size 1, s/image sp vs not (host clock, "
        f"synchronized): seed strip 512x1536 {s['seed_strip']['s_sp']:.3f} "
        f"vs {s['seed_strip']['s_plain']:.3f} s ({PARALLEL_STEPS} steps at "
        f"{PARALLEL_STRENGTH}, decoded PSNR {s['seed_strip']['psnr_db']:.2f} "
        f"dB, launches sp/plain {s['seed_strip']['launches']}); dp batch of "
        f"2 at 512x768 {s['inpaint_batch']['s_mesh'] / 2:.3f} vs "
        f"{s['inpaint_batch']['s_plain'] / 2:.3f} s a frame (rel err "
        f"{s['inpaint_batch']['rel_err']:.3e}, #6 "
        f"{s['inpaint_batch']['keymask_launches']}); run_batched 3 frames "
        f"dp 1 vs 0 {s['run_batched']['s_a_frame_dp1']:.3f} vs "
        f"{s['run_batched']['s_a_frame_dp0']:.3f} s a frame (files equal "
        f"{s['run_batched']['files_equal']}); tp forward at tp 1 "
        f"{s['tp_forward']['s_tp']:.4f} vs {s['tp_forward']['s_plain']:.4f} "
        f"s an evaluation (rel err {s['tp_forward']['rel_err']:.3e}, "
        f"launches tp/plain {s['tp_forward']['launches']}) [{card}]")
    return summary, all_counts, train_counts, failures


FLOWTRAIN_HW = (128, 192)
FLOWTRAIN_ITERS = 8


def run_flowtrain_phase(kernels):
    """The flow-training path (``training/``) on the card, f32, TF32 off:

    1. one synthetic 128x192 scene (``synthetic_flow.render_scene``, seed
       ``SEED``) rendered on the card against the same seed on the CPU:
       images within 1e-3, flow within 1e-4 px, valid / occluded /
       disoccluded equal;
    2. one ``flow_train_step`` of the full RAFT (``RAFTConfig(corr_dtype=
       "float32")``, 8 iterations, the committed ``raft_synth.npz`` as the
       start, ``make_flow_optimizer()``) on that scene on the card against
       the same step on the CPU: the loss and the gradient's global norm
       before the clip within 1e-3 relative, the parameters finite after
       it, no kernel of the table launched (counts reset just before,
       read just after); then a second card step timed.
    Returns (summary, the launch counts, failures)."""
    import numpy as np

    from sd_animation_optical_flow_tpu_torch.models import raft as RF
    from sd_animation_optical_flow_tpu_torch.training import flow_train as FT
    from sd_animation_optical_flow_tpu_torch.training import \
        synthetic_flow as SF
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import (
        ARTIFACTS, load_npz_tree)
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_leaves
    failures, summary = [], {}
    h, w = FLOWTRAIN_HW
    t0 = time.time()
    scene = SF.render_scene(np.random.default_rng(SEED), h, w, device="cuda")
    ref = SF.render_scene(np.random.default_rng(SEED), h, w, device="cpu")
    diff = {name: (a.cpu() != b).sum().item() if a.dtype == torch.bool
            else (a.cpu() - b).abs().max().item()
            for name, a, b in zip(SF.FlowScene._fields, scene, ref)}
    summary["scene_card_vs_cpu"] = diff
    ok = diff["img1"] <= 1e-3 and diff["img2"] <= 1e-3 and \
        diff["flow"] <= 1e-4 and diff["valid"] == 0 and \
        diff["occluded"] == 0 and diff["disoccluded"] == 0
    log(f"[flowtrain] a {h}x{w} scene rendered on the card against the CPU "
        f"(seed {SEED}): max |diff| image "
        f"{max(diff['img1'], diff['img2']):.3e}"
        f" (limit 1e-3), flow {diff['flow']:.3e} px (limit 1e-4), mask "
        f"pixels differing: valid {diff['valid']:g}, occluded "
        f"{diff['occluded']}, disoccluded {diff['disoccluded']} (limit 0)")
    if not ok:
        failures.append(f"flowtrain: scene card vs CPU {diff}")

    cfg = RF.RAFTConfig(corr_dtype="float32")
    path = f"{ARTIFACTS}/raft_synth.npz"
    batch = [t[None] for t in scene[:4]]
    res = {}
    for label, dev in (("card", "cuda"), ("cpu", "cpu")):
        state = FT.init_flow_train_state(load_npz_tree(path, device=dev),
                                         FT.make_flow_optimizer())
        on_card = label == "card"
        if on_card:
            reset_counts(kernels)
            torch.cuda.synchronize()
        t1 = time.time()
        _, loss, _ = FT.flow_train_step(
            state, cfg, *[t.to(dev) for t in batch], iters=FLOWTRAIN_ITERS)
        res[label] = (loss.item(), state.opt.grad_norm.item(),
                      time.time() - t1)
        if on_card:
            counts = {k: fn.launches for k, fn in kernels.items()}
            finite = all(bool(torch.isfinite(p).all())
                         for p in tree_leaves(state.params))
            torch.cuda.synchronize()
            t1 = time.time()
            FT.flow_train_step(state, cfg, *batch, iters=FLOWTRAIN_ITERS)
            torch.cuda.synchronize()
            second_s = time.time() - t1
        del state
    rel_loss = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    rel_norm = abs(res["card"][1] - res["cpu"][1]) / abs(res["cpu"][1])
    summary.update({"loss": [res["card"][0], res["cpu"][0]],
                    "grad_norm": [res["card"][1], res["cpu"][1]],
                    "rel_loss": rel_loss, "rel_grad_norm": rel_norm,
                    "card_step_s": [res["card"][2], second_s],
                    "cpu_step_s": res["cpu"][2], "counts": counts})
    log(f"[flowtrain] one flow_train_step, full RAFT at {h}x{w}, batch 1, "
        f"{FLOWTRAIN_ITERS} iterations, f32 (TF32 off), from the committed "
        f"artifact: loss card {res['card'][0]:.6f} / CPU {res['cpu'][0]:.6f} "
        f"(rel {rel_loss:.2e}, limit 1e-3), gradient norm before the clip "
        f"card {res['card'][1]:.6f} / CPU {res['cpu'][1]:.6f} (rel "
        f"{rel_norm:.2e}, limit 1e-3); parameters finite {finite}; card "
        f"step {res['card'][2]:.3f} s (first) / {second_s:.3f} s, CPU "
        f"{res['cpu'][2]:.1f} s; launches {counts}; phase "
        f"{time.time() - t0:.1f} s")
    if not (rel_loss <= 1e-3 and rel_norm <= 1e-3 and finite):
        failures.append(f"flowtrain: loss rel {rel_loss:.2e}, gradient norm "
                        f"rel {rel_norm:.2e}, finite {finite}")
    for k, n in counts.items():
        if n:
            failures.append(f"flowtrain: {k} launched {n} times")
    return summary, counts, failures


def run_banded_phase(sd, keys_kv, kernels, gen):
    """The UNet's materialized ``attn_biases`` route at full width: one
    bf16 evaluation, x batch 1 at the 64x96 latent, t 401, the cond
    context, ``ref_kv`` = the two keyframes' K/V joined
    (``concat_ref_kv``: batch 1, so it replaces K/V wholesale) and at
    each of the 16 self-attentions ``banded_strip_bias(h_l, w_l, 2)`` at
    its level's latent size. Checks: the output is finite, differs from
    the same call without biases, and is within 0.1 relative L2 of the
    same call on the CPU in f32; the counters reset just before and read
    just after (no kernel #5: biased attention takes the plain route, as
    in JAX). Returns (summary dict, failures)."""
    from sd_animation_optical_flow_tpu_torch.models import unet as U
    from sd_animation_optical_flow_tpu_torch.ops.attention import \
        banded_strip_bias
    from sd_animation_optical_flow_tpu_torch.pipelines.keyframe_inpaint \
        import concat_ref_kv
    f = sd.vae_cfg.downscale
    h0, w0 = H // f, W // f
    levels = [0, 0, 1, 1, 2, 2, 3, 2, 2, 2, 1, 1, 1, 0, 0, 0]
    biases = {i: banded_strip_bias(h0 >> lv, w0 >> lv, 2,
                                   device="cuda")[None, None]
              for i, lv in enumerate(levels)}
    ref_kv = concat_ref_kv(keys_kv)
    x = torch.randn((1, h0, w0, 4), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.full((1,), 401, dtype=torch.int32, device="cuda")
    ctx = sd.get_learned_conditioning("a watercolor fox in the snow")
    call = lambda **kw: U.unet_apply(sd.unet_params, sd.unet_cfg, x, t, ctx,
                                     ref_kv=ref_kv, **kw)
    with torch.no_grad():
        call(attn_biases=biases)                 # warm-up
        reset_counts(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out, kv = call(attn_biases=biases)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        unbiased, _ = call()
        t0 = time.time()
        out_cpu, _ = U.unet_apply(
            to_cpu_f32(sd.unet_params), sd.unet_cfg, x.float().cpu(),
            t.cpu(), ctx.float().cpu(), ref_kv=to_cpu_f32(
                [list(p) for p in ref_kv]),
            attn_biases={i: b.cpu() for i, b in biases.items()})
        cpu_s = time.time() - t0
    rel_l2 = lambda a, b: ((a.float().cpu() - b.float().cpu()).norm()
                           / b.float().cpu().norm()).item()
    rel_cpu, rel_unbiased = rel_l2(out, out_cpu), rel_l2(out, unbiased)
    finite = bool(torch.isfinite(out).all())
    # x's own K/V: half the tokens of the two frames' reference rows
    kv_ok = len(kv) == 16 and all(
        k.shape == (1, rk.shape[1] // 2, rk.shape[2])
        for (k, _), (rk, _) in zip(kv, ref_kv))
    log(f"[banded] sd15 UNet at {h0}x{w0} latent, ref_kv of 2 keyframes, "
        f"banded bias at 16 self-attentions: {secs:.3f} s (host clock, "
        f"synchronized), peak {peak:.2f} GiB, finite {finite}, K/V ok "
        f"{kv_ok}; rel L2 vs the CPU f32 call {rel_cpu:.4e} (CPU "
        f"{cpu_s:.1f} s), vs the unbiased call {rel_unbiased:.4e}; launches "
        f"{counts}")
    failures = []
    if not (finite and kv_ok and rel_cpu <= 0.1 and rel_unbiased > 1e-3):
        failures.append(f"banded: finite {finite}, K/V ok {kv_ok}, rel L2 "
                        f"vs CPU {rel_cpu:.3e} (<= 0.1), vs unbiased "
                        f"{rel_unbiased:.3e} (> 1e-3)")
    summary = {"s": secs, "peak_gib": peak, "rel_l2_cpu": rel_cpu,
               "rel_l2_unbiased": rel_unbiased, "counts": counts}
    return summary, failures


TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 2, 3, 1e-5
TRAIN_KERNELS = ("flash_fwd_stats", "flash_bwd_dkv", "flash_bwd_dq")


def _grad_list(params, cfg, sched, x0, ctx, t, noise):
    from sd_animation_optical_flow_tpu_torch.training.losses import p_losses
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_leaves
    leaves = tree_leaves(params)
    loss = p_losses(params, cfg, sched, x0, ctx, t, noise)
    return loss.item(), list(torch.autograd.grad(loss, leaves))


def _train_batch(sd, gen):
    """The training batch: ``TRAIN_BATCH`` VAE-encoded random 512x768
    images and CLIP encodings of 77-token prompts, both in the bundle's
    dtype."""
    from sd_animation_optical_flow_tpu_torch.models import clip as CL
    from sd_animation_optical_flow_tpu_torch.models import vae as V
    prompts = ["a watercolor fox in the snow, " * 12,
               "an oil painting of a harbour at dusk, " * 10]
    with torch.no_grad():
        imgs = torch.rand((TRAIN_BATCH, H, W, 3), generator=gen,
                          device="cuda") * 2 - 1
        x0 = V.encode(sd.vae_params, sd.vae_cfg, imgs.to(sd.dtype),
                      generator=gen)
        ids = torch.stack([torch.from_numpy(sd.tokenizer.chunked(p)[0])
                           for p in prompts]).long().to("cuda")
        ctx = CL.clip_text_apply(sd.clip_params, sd.clip_cfg, ids,
                                 clip_skip=sd.clip_skip).to(sd.dtype)
    return x0, ctx


def run_train_phase(sd, kernels, gen):
    """The diffusion fine-tuning step at full SD-1.5 width: f32 master
    weights (the bundle's UNet, zero-init convs perturbed) with bf16
    activations, batch 2 of VAE-encoded random 512x768 images and CLIP
    encodings of 77-token prompts, eps, ``adamw_with_ema_wings`` at lr
    1e-5. First one step's gradient on the kernel route against the
    same step on the plain route in f32 activations (the routed
    attention functions swapped for ``xla_attention``); then
    ``TRAIN_STEPS`` steps, each with the launch counters reset just
    before and read just after, then one profiled step. Returns
    (summary dict, per-step counts, failures)."""
    import functools
    from sd_animation_optical_flow_tpu_torch.ops import attention as A
    from sd_animation_optical_flow_tpu_torch.training import losses as TL
    from sd_animation_optical_flow_tpu_torch.training import optim as TO
    from sd_animation_optical_flow_tpu_torch.training import train_step as TT
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_leaves
    failures = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x0, ctx = _train_batch(sd, gen)
    cfg, sched = sd.unet_cfg, sd.sched
    state = TT.init_train_state(sd.unet_params, functools.partial(
        TO.adamw_with_ema_wings, lr=TRAIN_LR))
    leaves = tree_leaves(state.params)
    n_params = sum(p.numel() for p in leaves)
    log(f"[train] x0 {tuple(x0.shape)} {x0.dtype}, context "
        f"{tuple(ctx.shape)}, {len(leaves)} f32 parameter tensors "
        f"({n_params / 1e6:.1f} M)")
    draws = [TL.sample_t_noise(sched, x0, gen) for _ in range(TRAIN_STEPS)]

    # step 1's gradient: kernel route (bf16) against the f32 plain route
    reset_counts(kernels)
    t1, noise1 = draws[0]
    with mock.patch.multiple(A, flash_attention_diff=A.xla_attention,
                             shortk_attention=A.xla_attention):
        loss_p, g_plain = _grad_list(state.params, cfg, sched, x0.float(),
                                     ctx.float(), t1, noise1.float())
    torch.cuda.synchronize()
    plain_launches = sum(fn.launches for fn in kernels.values())
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    loss_k, g_kern = _grad_list(state.params, cfg, sched, x0, ctx, t1,
                                noise1)
    dot = sum((a * b).sum() for a, b in zip(g_kern, g_plain)).item()
    nk2 = sum(a.pow(2).sum() for a in g_kern).item()
    np2 = sum(b.pow(2).sum() for b in g_plain).item()
    nd2 = sum((a - b).pow(2).sum() for a, b in zip(g_kern, g_plain)).item()
    grad_rel = math.sqrt(nd2 / np2)
    grad_cos = dot / math.sqrt(nk2 * np2)
    del g_kern, g_plain
    log(f"[train] step-1 gradient, kernel route bf16 vs plain route f32 "
        f"(batch {TRAIN_BATCH}): rel L2 {grad_rel:.4e}, cosine "
        f"{grad_cos:.6f}; loss {loss_k:.6f} vs {loss_p:.6f}; kernel "
        f"launches on the plain route {plain_launches}; peak "
        f"{plain_peak:.2f} GiB on the plain route")
    if not (grad_rel <= 0.1) or plain_launches:
        failures.append(f"train: gradient rel L2 {grad_rel:.3e} > 0.1 or "
                        f"kernels on the plain route ({plain_launches})")

    p0 = [p.detach().clone() for p in leaves]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = TT.make_train_step(cfg, sched, parameterization="eps")
    losses, times, counts = [], [], []
    for i, (t, noise) in enumerate(draws):
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.time()
        loss = step(state, x0, ctx, t, noise).item()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        losses.append(loss)
        counts.append({k: fn.launches for k, fn in kernels.items()})
        if i == 0:
            unchanged = sum(torch.equal(p, q) for p, q in zip(leaves, p0))
            frac = sum((p != q).sum().item() for p, q in zip(leaves, p0)) \
                / n_params
            log(f"[train] after step 1: {len(leaves) - unchanged} of "
                f"{len(leaves)} parameter tensors changed ({frac:.4f} of "
                f"the entries)")
            if unchanged:
                failures.append(f"train: {unchanged} parameter tensors "
                                "unchanged by step 1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ema = [state.opt.state[p]["ema"] for p in leaves]
    ema_moved = sum(not torch.equal(e, q) for e, q in zip(ema, p0))
    ema_lags = sum(not torch.equal(e, p.detach())
                   for e, p in zip(ema, leaves))
    snapshot_gib = 4.0 * n_params / 2**30
    del p0
    for i, c in enumerate(counts):
        log(f"[train] step {i + 1}: loss {losses[i]:.6f}, {times[i]:.3f} s "
            f"(host clock), launches {c}")
        if c["flash_attention_tpv"] < 10 or c["linear_ln_fused"] \
                or c["geglu_ff_fused"] or c["flash_attention_keymask"] \
                or any(c[k] != 10 for k in TRAIN_KERNELS):
            failures.append(f"train step {i + 1}: launches {c} (want #7 = "
                            "#8 = #9 = 10, #1 >= 10, #3 = #4 = #6 = 0)")
    log(f"[train] EMA after {TRAIN_STEPS} steps: {ema_moved} of "
        f"{len(leaves)} tensors moved from the start, {ema_lags} differ "
        f"from the params (ema_step {state.opt.ema_step})")
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"train: non-finite loss {losses}")
    if ema_moved < len(leaves) or ema_lags == 0:
        failures.append("train: the EMA did not move")
    secs = min(times[1:])
    log(f"[train] {secs:.3f} s/step (min of steps 2-{TRAIN_STEPS}; host "
        f"clock, synchronized); peak device memory over the steps "
        f"{peak:.2f} GiB (with a {snapshot_gib:.2f} GiB f32 snapshot of "
        f"the params for the checks)")
    t, noise = draws[-1]
    prof = profile_frame(lambda: (step(state, x0, ctx, t, noise),
                                  torch.cuda.synchronize()), "train step")
    summary = {"s_per_step": secs, "step_s": times, "losses": losses,
               "grad_rel_l2": grad_rel, "grad_cos": grad_cos,
               "peak_gib": peak, "plain_route_peak_gib": plain_peak,
               "profile_busy_wall_ms": prof}
    return summary, counts, failures


SHARDED_STEPS = 2
SHARDED_TOL = 1e-6      # losses relative; leaves x max |leaf|


def check_sharded_train(sd, mesh, kernels, gen):
    """``[parallel]`` (e): the sharded fine-tuning step at dp 1 x tp 1 on
    ``mesh``, beside the unsharded one. The ``[train]`` phase's set-up
    (f32 master weights from the bundle's UNet, bf16 activations, batch
    ``TRAIN_BATCH`` of 512x768, ``adamw_with_ema_wings`` at
    ``TRAIN_LR``, eps): ``SHARDED_STEPS`` steps of an unsharded state,
    then of a state built from the same params through
    ``shard_train_state``, both on the same t and noise; the first state
    is freed (its params and EMA kept for the comparison) before the
    second is built. Each step timed (host clock, synchronized) with the
    launch counters reset just before it and read just after. Passes
    when the losses agree within ``SHARDED_TOL`` relative, every gathered
    param and EMA leaf within ``SHARDED_TOL`` x its max |leaf|, and every
    sharded step launched #7 = #8 = #9 = 10, #1 >= 10 and no #3, #4 or
    #6. Returns (summary, the sharded steps' counts, failures)."""
    import functools
    from sd_animation_optical_flow_tpu_torch.parallel.sharding import \
        gather_params
    from sd_animation_optical_flow_tpu_torch.training import losses as TL
    from sd_animation_optical_flow_tpu_torch.training import optim as TO
    from sd_animation_optical_flow_tpu_torch.training import train_step as TT
    from sd_animation_optical_flow_tpu_torch.utils.tree import tree_leaves
    failures, counts, runs = [], [], {}
    x0, ctx = _train_batch(sd, gen)
    draws = [TL.sample_t_noise(sd.sched, x0, gen)
             for _ in range(SHARDED_STEPS)]
    make_opt = functools.partial(TO.adamw_with_ema_wings, lr=TRAIN_LR)
    step = TT.make_train_step(sd.unet_cfg, sd.sched)
    for name in ("plain", "sharded"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = TT.init_train_state(sd.unet_params, make_opt)
        if name == "sharded":
            state = TT.shard_train_state(state, mesh)
        losses, times = [], []
        for t, noise in draws:
            reset_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.time()
            losses.append(step(state, x0, ctx, t, noise).item())
            torch.cuda.synchronize()
            times.append(time.time() - t0)
            if name == "sharded":
                counts.append({k: fn.launches for k, fn in kernels.items()})
        peak = torch.cuda.max_memory_allocated() / 2**30
        params = state.params
        ema = TO.ema_params_of(state.opt, params)
        if name == "sharded":
            params, ema = (gather_params(tree, state.specs, mesh)
                           for tree in (params, ema))
        runs[name] = (losses, times, peak,
                      [p.detach() for p in tree_leaves(params)],
                      tree_leaves(ema))
        del state, params, ema      # the moments and gradients go
    (loss_p, time_p, peak_p, par_p, ema_p), \
        (loss_s, time_s, peak_s, par_s, ema_s) = runs["plain"], \
        runs["sharded"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_s, loss_p))
    leaf_err = {
        what: max((a - b).abs().max().item()
                  / max(b.abs().max().item(), 1e-30)
                  for a, b in zip(mine, ref))
        for what, mine, ref in (("param", par_s, par_p),
                                ("ema", ema_s, ema_p))}
    del runs, par_p, par_s, ema_p, ema_s
    for i, c in enumerate(counts):
        if c["flash_attention_tpv"] < 10 or c["linear_ln_fused"] \
                or c["geglu_ff_fused"] or c["flash_attention_keymask"] \
                or any(c[k] != 10 for k in TRAIN_KERNELS):
            failures.append(f"parallel: sharded train step {i + 1} "
                            f"launches {c} (want #7 = #8 = #9 = 10, #1 >= "
                            "10, #3 = #4 = #6 = 0)")
    if not (loss_err <= SHARDED_TOL and all(math.isfinite(x)
                                            for x in loss_s)):
        failures.append(f"parallel: sharded losses {loss_s} vs {loss_p}")
    if not max(leaf_err.values()) <= SHARDED_TOL:
        failures.append(f"parallel: sharded params / EMA after "
                        f"{SHARDED_STEPS} steps: {leaf_err}")
    log(f"[parallel] sharded train step at dp 1 x tp 1 vs unsharded, "
        f"batch {TRAIN_BATCH} at 512x768: s/step {time_s[-1]:.3f} vs "
        f"{time_p[-1]:.3f} (step 1 {time_s[0]:.3f} vs {time_p[0]:.3f}; host "
        f"clock, synchronized), losses {loss_s} vs {loss_p} (rel err "
        f"{loss_err:.3e}), max leaf err {leaf_err}, peak device memory "
        f"{peak_s:.2f} vs {peak_p:.2f} GiB (the unsharded state's params "
        f"and EMA kept through the sharded run), launches {counts}")
    summary = {"s_per_step": time_s[-1], "s_per_step_plain": time_p[-1],
               "step_s": time_s, "step_s_plain": time_p, "losses": loss_s,
               "losses_plain": loss_p, "loss_rel_err": loss_err,
               "leaf_rel_err": leaf_err, "peak_gib": peak_s,
               "peak_gib_plain": peak_p}
    return summary, counts, failures


# the second template argument of attention_sm90_kernel: the mode
_MODES = {"Li0E": "PLAIN", "Li1E": "KEYMASK", "Li2E": "MFR",
          "Li4E": "BANDED"}


def _kernel_name(mangled: str) -> str:
    """``name<N>`` of a mangled kernel (a length-prefixed name ending in
    ``_kernel``, its first template argument an int N: DP, or BN for
    linear_ln_sm90_kernel), ``name<DP, MODE>`` where a second one names a
    mode, ``name<DP, MODE, NC>`` where a third gives attention_sm90_kernel's
    consumer warpgroups, else the input."""
    for m in re.finditer(r"(?=(\d+)([a-z]))", mangled):
        at = m.start(2)
        name = mangled[at:at + int(m.group(1))]
        if name.endswith("_kernel"):
            t = re.match(r"ILi(\d+)E(Li\d+E)?(?:Li(\d+)E)?",
                         mangled[at + len(name):])
            if not t:
                return name
            mode = _MODES.get(t.group(2) or "")
            return name + f"<{t.group(1)}" + (f", {mode}" if mode else "") \
                + (f", {t.group(3)}" if t.group(3) else "") + ">"
    return mangled


def ptxas_report(text: str, named=("attention_sm90_kernel",
                                     "attention_wide_sm90_kernel",
                                     "attention_bwd_dkv_sm90_kernel",
                                     "attention_bwd_dq_sm90_kernel",
                                     "geglu_up_sm90_kernel",
                                     "geglu_down_sm90_kernel",
                                     "linear_ln_sm90_kernel")):
    """Lines of the ptxas report (``nvcc -Xptxas -v``) worth printing:
    registers and spills of every instantiation of the ``named`` kernels
    (wgmma kernels whose registers setmaxnreg hands over), and anywhere
    spills, wgmma pipelines that ptxas had to serialize, or a register
    hand-over it could not honour."""
    lines, fn = [], ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            short = _kernel_name(fn)
            continue
        mine = any(n in fn for n in named)
        if "spill" in line and (mine or " 0 bytes spill stores" not in line):
            lines.append(f"{short}: {line.strip()}")
        elif mine and "Used" in line and "registers" in line:
            lines.append(f"{short}: {line.split(':', 1)[-1].strip()}")
        elif "wgmma" in line.lower() or "setmaxnreg" in line:
            lines.append(line.strip())
    return lines


def profile_frame(run, label, top: int = 8):
    """One frame under torch.profiler: device busy time (sum of kernel
    times on the one stream) against the profiled frame's wall time, and
    the kernels that take the most device time. Profiling adds host
    overhead, so the idle share is an upper bound. Returns (busy ms,
    wall ms), or None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        wall_ms = 1e3 * (time.time() - t0)
    return report_profile(prof, wall_ms, label, top)


def device_activities(prof):
    """(name, ms) of every device activity (kernels, copies, fills) of a
    finished profile, from the profiler's raw results: building its per-op
    event tree (``key_averages``) takes seconds of host time for every few
    thousand launches, reading the raw list next to none."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation() and e.duration_ns() > 0]


def report_profile(prof, wall_ms, label, top: int = 8):
    """Print and return (busy ms, wall ms) of a finished profile over
    ``wall_ms`` of host time (see ``profile_frame``)."""
    # kernels, copies and fills only: a record_function range (the
    # optimizer's "Optimizer.step#...") also carries device time, that
    # of the kernels inside it
    by_name = {}
    for name, ms in device_activities(prof):
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += ms
        tot[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms == 0:
        log(f"[profile] {label}: no device time recorded (not measured)")
        return None
    log(f"[profile] {label}: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms"
        f" profiled wall (idle share {1 - busy_ms / wall_ms:.3f}); "
        f"{sum(n for _, n in by_name.values())} kernel launches")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile] {label}:   {ms:8.2f} ms x{n:<5d} {name[:90]}")
    # kernel #4 is two device kernels a call (geglu_up_sm90_kernel, then
    # geglu_down_sm90_kernel; one, geglu_kernel, before them): counted together
    geglu = [(re.search(r"geglu_\w+", name).group(0), ms, n)
             for name, (ms, n) in by_name.items() if "geglu" in name]
    if geglu:
        ms = sum(m for _, m, _ in geglu)
        calls = max(n for _, _, n in geglu)
        log(f"[profile] {label}: #4 ("
            + ", ".join(f"{name} x{n}" for name, _, n in geglu)
            + f") {ms:.2f} ms, {ms / calls:.4f} ms a call")
    return busy_ms, wall_ms


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="?", type=Path, const=Path(__file__).parent,
                    metavar="TREE", help="only the kernel table, of the port in TREE "
                    "(default: this checkout); no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.kernels:
        sys.path.insert(0, str(args.kernels.resolve()))
    try:
        from sd_animation_optical_flow_tpu_torch import config as C
        from sd_animation_optical_flow_tpu_torch.ops import _cuda
        from sd_animation_optical_flow_tpu_torch.ops import attention as A
        from sd_animation_optical_flow_tpu_torch.ops import ffn as FF
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    if args.kernels:
        log(f"[tree] the port in {Path(A.__file__).resolve().parents[1]}")
    failures = []
    card = card_line()
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[precision] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
        f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    phases = {}     # wall seconds of each phase
    start = t0 = time.time()
    so = _cuda.build()
    _cuda.library()
    sources = ", ".join(sorted(p.name for p in _cuda.CSRC.glob("*.cu")))
    if _cuda.CSRC.resolve() != (Path(__file__).resolve().parent
                                / "sd_animation_optical_flow_tpu_torch" / "csrc"):
        log(f"[build] {so.name} in {time.time() - t0:.1f} s from the tree's "
            f"sources: {sources}")
    else:
        log(f"[build] {so.name} in {time.time() - t0:.1f} s: "
            "attention_sm90_kernel<DP, MODE, NC> (#1 and #7: three wgmma "
            "consumer warpgroups, cp.async K/V ring; #10, the MFR strip "
            "bias as an epilogue on the score tile; #6, the CFG key mask "
            "as a per-unit key bound, the uncond rows' units walking "
            "min(Nk, n_own) keys; #5, attention_sm90_kernel<DP, BANDED, 3>, "
            "the banded bias: base on the key tiles out of band, each "
            "pair's from a table on the others; #5, #6 and #10 at d = 160 "
            "on 32-key tiles; csrc/attention_sm90.cu); "
            "attention_wide_sm90_kernel (#2: two wgmma consumer warpgroups "
            "on the two d-halves, TMA K/V ring multicast across a cluster; "
            "csrc/attention_wide_sm90.cu); "
            "attention_bwd_dkv_sm90_kernel, attention_bwd_dq_sm90_kernel (#8 "
            "and #9: one wgmma skeleton, a cp.async ring of the streamed "
            "axis; csrc/attention_bwd_sm90.cu); "
            "linear_ln_sm90_kernel (#3: the GEGLU up kernel's skeleton, "
            "x by TMA into a resident 128-byte-swizzled tile normalised in "
            "place, W's 64-wide k chunks through a TMA ring, one wgmma "
            "chain a 160- or 64-column tile, a TMA-store epilogue) and "
            "geglu_up_sm90_kernel, geglu_down_sm90_kernel (#4: two wgmma "
            "GEMMs on one skeleton, a TMA ring each; the LN prologue and "
            "the GEGLU in registers, then W2 with the bias and residual "
            "epilogue); csrc/ffn_sm90.cu")
    for line in ptxas_report(so.with_suffix(".log").read_text()):
        log(f"[ptxas] {line}")
    phases["build"] = time.time() - t0

    t0 = time.time()
    rows = check_kernels()
    phases["kernels"] = time.time() - t0
    failures += [r["name"] for r in rows if not r["ok"]]
    if args.kernels:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0

    gen = torch.Generator("cuda").manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sd = C.create_model("sd15", dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    perturb_zero_convs(sd.unet_params, gen)

    sd9 = C.create_model("sd15-inpaint9", dtype=torch.bfloat16,
                         device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    perturb_zero_convs(sd9.unet_params, gen)
    log(f"[model] sd15 and sd15-inpaint9 random init on the card in "
        f"{time.time() - t0:.1f} s")
    phases["models"] = time.time() - t0

    kernels = {"flash_attention_tpv": A.flash_attention_tpv,
               "flash_attention": A.flash_attention,
               "linear_ln_fused": FF.linear_ln_fused,
               "geglu_ff_fused": FF.geglu_ff_fused,
               "flash_attention_keymask": A.flash_attention_keymask,
               "flash_attention_mfr": A.flash_attention_mfr,
               "flash_fwd_stats": A.flash_fwd_stats,
               "flash_bwd_dkv": A.flash_bwd_dkv,
               "flash_bwd_dq": A.flash_bwd_dq,
               "flash_attention_banded": A.flash_attention_banded}
    img2img_kernels = list(kernels)[:4]
    t0 = time.time()
    unet_rel = check_unet_against_cpu(sd, gen)
    phases["unet_vs_cpu"] = time.time() - t0
    # bf16 through 16 transformer blocks and 25 resblocks of random
    # weights against f32: a few percent of the output's norm
    if not math.isfinite(unet_rel) or unet_rel > 0.1:
        failures.append(f"unet card-vs-cpu rel err {unet_rel:.3e} > 0.1")

    t0 = time.time()
    main = run_main_path(sd, kernels, gen)
    phases["img2img"] = time.time() - t0
    for sampler, (secs, counts, ok) in main.items():
        if not ok:
            failures.append(f"img2img {sampler}: bad output")
        for name in img2img_kernels:
            if counts[name] == 0:
                failures.append(f"img2img {sampler}: {name} never launched")
    t0 = time.time()
    keyframe, kf_failures, keys_kv = run_keyframe_path(sd, sd9, kernels, gen)
    phases["keyframe"] = time.time() - t0
    failures += kf_failures
    log(f"[main] peak device memory, both bundles and the K/V stores "
        f"resident: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.time()
    pixel, pixel_counts, pixel_failures = run_pixel_phase(sd, sd9, kernels)
    phases["pixel"] = time.time() - t0
    failures += pixel_failures
    t0 = time.time()
    control, control_counts, control_failures, control_bundle = \
        run_control_phase(sd, sd9, kernels, gen)
    phases["control"] = time.time() - t0
    failures += control_failures
    t0 = time.time()
    kfpipe, kfpipe_counts, kfpipe_failures = run_kfpipe_phase(
        sd, sd9, control_bundle, kernels, card)
    phases["kfpipe"] = time.time() - t0
    failures += kfpipe_failures
    del control_bundle
    torch.cuda.empty_cache()
    t0 = time.time()
    variants, variants_counts, variants_failures = run_variants_phase(
        sd, kernels, gen, card)
    phases["variants"] = time.time() - t0
    failures += variants_failures
    t0 = time.time()
    parallel, parallel_counts, sharded_counts, parallel_failures = \
        run_parallel_phase(sd, sd9, keys_kv, kernels, gen, card)
    phases["parallel"] = time.time() - t0
    failures += parallel_failures
    del sd9
    torch.cuda.empty_cache()
    t0 = time.time()
    flowtrain, flowtrain_counts, flowtrain_failures = \
        run_flowtrain_phase(kernels)
    phases["flowtrain"] = time.time() - t0
    failures += flowtrain_failures
    t0 = time.time()
    banded, banded_failures = run_banded_phase(sd, keys_kv, kernels, gen)
    phases["banded"] = time.time() - t0
    failures += banded_failures
    del keys_kv
    inference = list(main.values()) + list(keyframe.values()) \
        + [(None, c, None)
           for c in pixel_counts + control_counts + kfpipe_counts
           + variants_counts + parallel_counts] \
        + [(None, banded["counts"], None), (None, flowtrain_counts, None)]
    # the training kernels run only where a gradient is recorded
    for name in TRAIN_KERNELS:
        if any(c[name] for _, c, _ in inference):
            failures.append(f"{name} launched on an inference path")
    t0 = time.time()
    train, train_counts, train_failures = run_train_phase(sd, kernels, gen)
    phases["train"] = time.time() - t0
    failures += train_failures

    table = []
    paths = inference + [(None, c, None)
                         for c in train_counts + sharded_counts]
    for name, fn in kernels.items():
        mine = [r for r in rows if r["name"].startswith(name + " ")]
        launches = sum(c[name] for _, c, _ in paths)
        if name == "flash_attention_banded":
            # on no pipeline path, as in JAX: its drives beside the checks
            launches = sum(r["drive_launches"] for r in mine)
        for r in mine:
            table.append({k: r[k] for k in (
                "name", "route", "source", "replaces")}
                | {"launches": launches}
                | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "design")}
                | ({"launches_by_dp": r["launches_by_dp"]}
                   if "launches_by_dp" in r else {}))
    log(json.dumps({"kernels": table}))
    log(json.dumps({"frame_s": {s: v[0] for s, v in main.items()},
                    "keyframe_step_s": {s: v[0] for s, v in keyframe.items()},
                    "pixel": pixel, "control": control, "kfpipe": kfpipe,
                    "variants": variants, "parallel": parallel,
                    "flowtrain": flowtrain,
                    "banded": banded, "train": train,
                    "unet_rel_err": unet_rel,
                    "card": card}))
    log(f"[time] wall s by phase {json.dumps({k: round(v, 1) for k, v in phases.items()})}"
        f", total {time.time() - start:.1f} s")
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
