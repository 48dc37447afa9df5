"""Driver of the pixel-inpaint pipeline's batched entry point,
``pipelines/pixel_inpaint.run_batched``, as a user runs it on a clip.

Set-up draws the configuration's SD-1.5 and SD-1.5-inpainting weights
from the seed on the device (``harness/weights.py``; one VAE and one text
tower), hands them to the program as ldm checkpoints, loads the committed
RAFT pair and confidence head, makes the traffic's clips and runs one
clip at a short step count, which reaches every shape and kernel of the
window. The window then runs clips back to back, each through one
``run_batched`` call writing its PNGs, until ``seconds`` have passed; the
clip in flight finishes and counts.

The check (``check``) judges one finished clip, drawn from the seed,
against the plain reference (``reference/pixel.py``) in float32: every
frame it wrote (key frames from their raw frame; non-key frames from
their raw frame, the raw key frame and the program's own AI key frame as
written, the warp's source, which the key frame's own check judges), and
every flow and confidence its RAFT computed (``FlowProxy`` keeps them).
Each frame is judged against its own reference, so a frame written under
another's name, or a batch row given another row's result, fails.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.profiler import record_function

from portbench.counts import flops as FL
from portbench.harness.manifest import ROOT
from portbench.harness.png import read_png
from portbench.harness.record import (CLIP_SPAN, FLOW_SPAN, WINDOW_SPAN,
                                      Record, Trace, Traced)
from portbench.harness.traffic import key_flags, make_clips
from portbench.harness.weights import ldm_checkpoint, make_state
from portbench.reference import pixel as RP
from portbench.reference import raft as RR
from portbench.reference.sd import (build_modules, fp8_round, load,
                                    quantize_fp8)

# the traffic and the check's sample draw from the seed apart from the
# weights
TRAFFIC_SALT = 0x5EED_C11B
CHECK_SALT = 0xC4EC_5A3B
# non-key frames the reference computes at once (its f32 activations)
BLOCK = 4


class FlowProxy:
    """The program's flow estimator, handed to ``run_batched`` in its
    place: every ``calc_batch_device`` call runs inside a ``FLOW_SPAN``
    range and its pairs are counted. While ``keep`` is set, (flow buffer,
    confidence buffer, [buffer row or -1 for each pair of a clip in call
    order]), the flows and confidences of the real pairs are copied into
    the buffers (made at set-up, so memory stays as it was)."""

    def __init__(self, est):
        self.est = est
        self.device = est.device
        self.pairs = 0
        self.keep = None
        self.at = 0

    def calc_batch_device(self, src, tgt):
        b = int(src.shape[0])
        self.pairs += b
        with record_function(FLOW_SPAN):
            out = self.est.calc_batch_device(src, tgt)
        if self.keep is not None:
            flow_buf, conf_buf, rows = self.keep
            r = 0
            while r < b:                # runs of real pairs, copied as slices
                j = rows[self.at + r]
                m = 1
                while (j >= 0 and r + m < b
                       and rows[self.at + r + m] == j + m):
                    m += 1
                if j >= 0:
                    flow_buf[j:j + m].copy_(out[0][r:r + m])
                    conf_buf[j:j + m].copy_(out[1][r:r + m])
                r += m
        self.at += b
        return out


def rms_levels(a: np.ndarray, b: np.ndarray) -> float:
    """Root mean square difference of two uint8 frames, in levels."""
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


@dataclasses.dataclass
class Frames:
    """A clip's frames as one side computed them: {frame index: uint8 BGR
    image}, {non-key frame index: (flow [2, H, W], confidence [H, W])}
    and {non-key frame index: share of its pixels inpainted}."""
    images: dict
    flows: dict
    mask_share: dict


class _Profile:
    """``torch.profiler`` over part of the window. ``full``: CPU and CUDA
    activities inside the ``WINDOW_SPAN`` range, with every kernel launch
    logged at ``ops/_cuda.call``; else CUDA activities alone, which cost
    the host next to nothing, between two host syncs."""

    def __init__(self, device, rec: Record, full: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        if full or not acts:
            acts.append(ProfilerActivity.CPU)
        self.device = device
        self.rec = rec
        self.patch = self.span = None
        if full:
            from sd_animation_optical_flow_tpu_torch.ops import _cuda
            real = _cuda.call

            def logged(name, dev, *args):
                rec.calls.append((name, args))
                return real(name, dev, *args)
            self.patch = mock.patch.object(_cuda, "call", logged)
            self.span = record_function(WINDOW_SPAN)
        self.prof = profile(activities=acts)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def start(self):
        if self.patch is not None:
            self.patch.start()
        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()
        if self.span is not None:
            self.span.__enter__()

    def stop(self) -> float:
        """Stop; the host seconds since :meth:`start`."""
        if self.span is not None:
            self.span.__exit__(None, None, None)
        self._sync()
        host_s = time.perf_counter() - self.t0
        self.prof.stop()
        if self.patch is not None:
            self.patch.stop()
        return host_s

    def read(self) -> Trace:
        t = time.perf_counter()
        trace = Trace.from_profile(self.prof)
        self.rec.extra["trace_read_s"] = (self.rec.extra.get(
            "trace_read_s", 0.0) + time.perf_counter() - t)
        return trace


class Driver:
    def __init__(self, cell, seed: int, device, workdir):
        self.seed = int(seed) & ((1 << 63) - 1)
        self.device = torch.device(device)
        self.workdir = Path(workdir)
        self.cfg = cell.config
        self.spec = cell.spec
        self.traffic = cell.traffic
        self.raft_path = str(ROOT / self.cfg["flow"]["raft"])
        self.head_path = str(ROOT / self.cfg["flow"]["head"])
        self.settings = RP.PixelSettings.from_config(self.cfg)

    # -- the program ---------------------------------------------------

    def _pipeline_cfg(self, steps):
        from sd_animation_optical_flow_tpu_torch.pipelines.pixel_inpaint \
            import PixelInpaintConfig
        s, p = self.settings, self.spec["pipeline"]
        return PixelInpaintConfig(
            name="portbench", size=(self.traffic["width"],
                                    self.traffic["height"]),
            denoising_strength=s.strength, ddim_steps=steps,
            confidence_thres=s.confidence_thres, mask_dilate=s.mask_dilate,
            mask_blur=s.mask_blur, seed=self.seed,
            prompt_extra=self.cfg["pipeline"]["prompt_extra"],
            write_vis=False, frame_batch=p["frame_batch"],
            flow_chunk=p["flow_chunk"], pad_tail_batch=p["pad_tail_batch"])

    def setup(self):
        from sd_animation_optical_flow_tpu_torch import config as C
        from sd_animation_optical_flow_tpu_torch.models.clip import \
            CLIPTextConfig
        from sd_animation_optical_flow_tpu_torch.models.flowconf import \
            FlowConfidenceConfig
        from sd_animation_optical_flow_tpu_torch.models.unet import UNetConfig
        from sd_animation_optical_flow_tpu_torch.models.vae import VAEConfig
        from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
            load_flow_estimator
        cfg, sch = self.cfg, self.cfg["schedule"]
        tup = lambda d: {k: tuple(v) if isinstance(v, list) else v
                         for k, v in d.items()}
        vae = VAEConfig(**tup(cfg["vae"]))
        clip = CLIPTextConfig(**cfg["clip"])
        specs = {
            unet: C.BundleSpec(
                timesteps=sch["timesteps"], linear_start=sch["linear_start"],
                linear_end=sch["linear_end"], scale_factor=cfg["scale_factor"],
                conditioning_key="crossattn" if cin == 4 else "hybrid",
                unet=UNetConfig(in_channels=cin, **tup(cfg["unet"])),
                vae=vae, clip=clip)
            for unet, cin in (("unet", 4), ("unet9", 9))}
        dtype = getattr(torch, cfg["dtype"])
        state = make_state(cfg, self.seed, self.device, dtype)
        self.sd = specs["unet"].build(
            state_dict=ldm_checkpoint(state, "unet"), dtype=dtype,
            device=self.device)
        sd9 = specs["unet9"].build(
            state_dict=ldm_checkpoint(state, "unet9"), dtype=dtype,
            device=self.device)
        self.sd9 = dataclasses.replace(sd9, vae_params=self.sd.vae_params,
                                       clip_params=self.sd.clip_params)
        del state, sd9
        self.flow = FlowProxy(load_flow_estimator(
            FlowConfidenceConfig(uncertainty="learned"),
            raft_path=self.raft_path, head_path=self.head_path,
            device=self.device))
        self.prepare_traffic()
        h, w = self.traffic["height"], self.traffic["width"]
        n_real = self.flags.count(False)
        self.kept = (torch.zeros((n_real, h, w, 2), device=self.device),
                     torch.zeros((n_real, h, w), device=self.device))
        self.run_clip(0, self.workdir / "warmup",
                      self._pipeline_cfg(self.spec["warmup_steps"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.pcfg = self._pipeline_cfg(self.settings.ddim_steps)
        self.clip_flops = self._clip_flops()

    def prepare_traffic(self):
        self.clips = make_clips(self.traffic, self.seed ^ TRAFFIC_SALT,
                                self.device)
        self.flags = key_flags(self.traffic)

    def pair_rows(self):
        """For each flow pair of a clip in the order ``run_batched`` asks
        for them, the index of its frame among the clip's non-key frames,
        or -1 for a padded pair."""
        p = self.spec["pipeline"]
        bsz = max(p["frame_batch"], 1)
        rows, run, j = [], 0, 0
        for is_key in self.flags + [True]:
            if run and (is_key or run == bsz):
                rows += list(range(j, j + run))
                if p["pad_tail_batch"] and run < bsz:
                    rows += [-1] * (bsz - run)
                j += run
                run = 0
            if not is_key:
                run += 1
        return rows

    def run_clip(self, index: int, save_dir: Path, pcfg) -> str:
        from sd_animation_optical_flow_tpu_torch.pipelines.pixel_inpaint \
            import run_batched
        clip = self.clips[index % len(self.clips)]
        base = index * len(clip)
        triples = [(f, k, base + i)
                   for i, (f, k) in enumerate(zip(clip, self.flags))]
        return run_batched(triples, str(save_dir), self.sd, self.sd9,
                           self.flow, None, pcfg)

    def _clip_flops(self) -> float:
        """Model FLOPs of one clip as the pipeline computes it: per key
        frame an img2img (encode, t_enc CFG evaluations, decode); per
        batch of non-key frames (padded rows included) the flow pairs, two
        encodes, t_enc CFG evaluations of the inpainting UNet, a decode.
        The CLIP encodes are cached across the window and not counted."""
        cfg, hw = self.cfg, (self.traffic["height"], self.traffic["width"])
        lat = (hw[0] // 8, hw[1] // 8)
        te = RP.t_enc(self.settings)
        p = self.spec["pipeline"]
        key = (FL.vae_encode(cfg, 1, hw) + te * FL.unet(cfg, "unet", 2, lat)
               + FL.vae_decode(cfg, 1, hw))
        total, run = 0.0, 0
        for is_key in self.flags + [True]:
            if run and (is_key or run == p["frame_batch"]):
                b = p["frame_batch"] if p["pad_tail_batch"] else run
                total += (b * FL.flow_pair(self.raft_path, self.head_path, *hw)
                          + 2 * FL.vae_encode(cfg, b, hw)
                          + te * FL.unet(cfg, "unet9", 2 * b, lat)
                          + FL.vae_decode(cfg, b, hw))
                run = 0
            if is_key:
                total += key
            else:
                run += 1
        return total - key          # the sentinel key frame after the clip

    def window(self, seconds: float, trace: bool) -> Record:
        """Clips back to back until ``seconds`` have passed. The check's
        clip is drawn from the seed among the finished ones as they come
        (one-item reservoir sampling), and its flows kept. With ``trace``
        the first clips, up to the cell's ``trace_seconds``, run under a
        CUDA-only profile (``rec.timed``: the device's busy time against
        the host's), the next ones, as long again, under the full profile
        with every kernel launch logged (``rec.trace``, ``rec.traced``);
        the rest of the window runs untraced."""
        rec = Record()
        n = len(self.flags)
        rng = np.random.default_rng(self.seed ^ CHECK_SALT)
        rows = self.pair_rows()
        self.done, self.chosen = [], None
        phases = [False, True] if trace else []
        prof, ended = None, []
        t0 = time.perf_counter()
        try:
            while True:
                if prof is None and phases:
                    prof = _Profile(self.device, rec, phases.pop(0))
                    since = (self.flow.pairs, len(self.done))
                    prof.start()
                i = len(self.done)
                take = rng.integers(i + 1) == 0
                self.flow.keep = self.kept + (rows,) if take else None
                self.flow.at = 0
                with record_function(CLIP_SPAN):
                    out = self.run_clip(i, self.workdir / f"clip{i}",
                                        self.pcfg)
                self.done.append((i, out))
                if take:
                    self.chosen = i
                rec.window_s = time.perf_counter() - t0
                if prof is not None and (
                        time.perf_counter() - prof.t0
                        >= self.spec["trace_seconds"]
                        or rec.window_s >= seconds):
                    clips = len(self.done) - since[1]
                    part = Traced(frames=n * clips,
                                  pairs=self.flow.pairs - since[0],
                                  window_s=prof.stop(),
                                  model_flops=self.clip_flops * clips)
                    ended.append((prof, part))
                    prof = None
                if rec.window_s >= seconds:
                    break
        finally:
            self.flow.keep = None
            if prof is not None:
                prof.stop()
        for prof, part in ended:
            trace_ = prof.read()
            if prof.patch is not None:
                rec.trace, rec.traced = trace_, part
            else:
                part.busy_s = trace_.busy_s()
                rec.timed, rec.top_ops = part, trace_.top_device_ops()
        rec.attempted = n * len(self.done)
        rec.failed = sum(
            not os.path.exists(f"{out}/converted_{i * n + k:06d}.png")
            for i, out in self.done for k in range(n))
        rec.frames = rec.attempted - rec.failed
        return rec

    def release(self):
        """Free the program's state before the reference runs."""
        self.sd = self.sd9 = self.flow = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------

    def sample(self):
        """The judged clip: (clip index, its output directory)."""
        return self.done[self.chosen]

    def program_frames(self, clip_i, out) -> Frames:
        """The judged clip as the program wrote it, with the flows the
        window kept."""
        n = len(self.flags)
        others = [k for k, f in enumerate(self.flags) if not f]
        return Frames(
            images={k: read_png(f"{out}/converted_{clip_i * n + k:06d}.png")
                    for k in range(n)},
            flows={k: (self.kept[0][j].permute(2, 0, 1), self.kept[1][j])
                   for j, k in enumerate(others)},
            mask_share={})

    def reference_models(self, fp8: bool = False):
        """The reference's modules in float32 with the run's weights (or
        the control: the same in float8 e4m3)."""
        state = make_state(self.cfg, self.seed, self.device,
                           getattr(torch, self.cfg["dtype"]))
        models = load(build_modules(self.cfg, "meta"), state)
        del state
        if fp8:
            for m in models.values():
                quantize_fp8(m)
        raft = RR.load_npz(self.raft_path, self.device)
        head = RR.load_npz(self.head_path, self.device)
        s = self.settings
        with torch.no_grad():
            ctx = {"c": RP.text_context(models["clip"], self.cfg["pipeline"][
                "prompt"], self.device),
                "u": RP.text_context(models["clip"], s.negative_prompt,
                                     self.device)}
        return models, raft, head, ctx

    def frames_of(self, key_ai, models, raft, head, ctx, clip_i,
                  flow_round=None) -> Frames:
        """Every frame of clip ``clip_i`` as ``models`` compute it, the
        non-key frames ``BLOCK`` at a time. ``key_ai(k)``
        gives the AI key frame that feeds the warp (None: the key frames
        computed here)."""
        clip = self.clips[clip_i % len(self.clips)]
        dev = self.device
        raw = lambda k: torch.as_tensor(clip[k], device=dev)
        seg_key = lambda k: max(j for j in range(k + 1) if self.flags[j])
        res = Frames({}, {}, {})
        with torch.no_grad():
            for kk in (k for k, f in enumerate(self.flags) if f):
                res.images[kk] = RP.key_frame(
                    models, ctx, self.settings, raw(kk),
                    self.seed).cpu().numpy()
                ai = torch.as_tensor(res.images[kk] if key_ai is None
                                     else key_ai(kk), device=dev)
                seg = [k for k, f in enumerate(self.flags)
                       if not f and seg_key(k) == kk]
                for b in range(0, len(seg), BLOCK):
                    ks = seg[b:b + BLOCK]
                    imgs, flow, conf, share = RP.non_key_frames(
                        models, raft, head, ctx, self.settings, raw(kk), ai,
                        torch.stack([raw(k) for k in ks]), self.seed,
                        flow_round=flow_round)
                    for j, k in enumerate(ks):
                        res.images[k] = imgs[j].cpu().numpy()
                        res.flows[k] = (flow[j], conf[j])
                        res.mask_share[k] = float(share[j])
        return res

    def judge(self, made: Frames, ref: Frames):
        """[(name, value, limit)]: the worst frame of the clip for each
        number. ``key_rms`` / ``inpaint_rms``: RMS difference of a key /
        non-key frame from its reference, in levels; ``flow_epe``: mean
        endpoint error of a non-key frame's flow, px; ``conf_mae``: mean
        absolute difference of its confidence."""
        lim = self.spec["check"]["limits"]
        others = [k for k, f in enumerate(self.flags) if not f]
        self.per_frame = {
            "rms": [rms_levels(made.images[k], ref.images[k])
                    for k in range(len(self.flags))],
            "epe": {k: float((made.flows[k][0].float() - ref.flows[k][0])
                             .norm(dim=0).mean()) for k in others},
            "mae": {k: float((made.flows[k][1].float() - ref.flows[k][1])
                             .abs().mean()) for k in others}}
        rms = self.per_frame["rms"]
        worst = lambda vals: max(vals, default=0.0)
        return [("key_rms", worst(v for k, v in enumerate(rms)
                                  if self.flags[k]), lim["key_rms"]),
                ("inpaint_rms", worst(rms[k] for k in others),
                 lim["inpaint_rms"]),
                ("flow_epe", worst(self.per_frame["epe"].values()),
                 lim["flow_epe"]),
                ("conf_mae", worst(self.per_frame["mae"].values()),
                 lim["conf_mae"])]

    def _no_tf32(self, fn):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def control(self):
        """The control's numbers: the reference in the program's place
        with float8 weights and inputs in the SD models and float8
        operands in the flow's products, on the seed's first clip, judged
        as a run is."""
        self.prepare_traffic()
        self.done, self.chosen = [(0, None)], 0

        def run():
            made = self.frames_of(None, *self.reference_models(fp8=True), 0,
                                  flow_round=fp8_round)
            gc.collect()
            self.ref = self.frames_of(lambda k: made.images[k],
                                      *self.reference_models(), 0)
            return self.judge(made, self.ref)
        return self._no_tf32(run)

    def check(self):
        """[(name, value, limit)] of the judged clip (run after
        :meth:`release`)."""
        clip_i, out = self.sample()
        made = self.program_frames(clip_i, out)
        self.ref = self._no_tf32(lambda: self.frames_of(
            lambda k: made.images[k], *self.reference_models(), clip_i))
        return self.judge(made, self.ref)
