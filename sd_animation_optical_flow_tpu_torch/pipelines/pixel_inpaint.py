"""The pixel-inpaint pipeline: keyframe img2img, flow warp and
confidence-masked inpainting, on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/pixel_inpaint.py``.
Per frame:

* a key frame -> plain img2img at the denoising strength; it becomes the
  reference (raw frame, AI frame) pair;
* any other frame -> flow + confidence key frame -> frame, the AI key
  frame warped along the flow and the mask dilate(confidence < 0.95)
  (``warp_mask_fused``), then seeded inpainting on the 9-channel model
  with the raw frame as reference, and the optional propagated-pixel mix.

Outputs keep the reference's contract: ``converted_%06d.png``, the
6-panel ``vis_%06d.png`` strips and ``pixel_confidence_%06d.png``, in
``<save_dir>_pixel_warp-<name>``. ``run_video`` decodes a video file and
detects its key frames (``keyframes.frame_generator``, which needs cv2);
``run_batched`` denoises the non-key frames of a key frame's segment in
batches of ``frame_batch``, with the same outputs as ``run``, and with
``dp`` splits each batch over data-parallel ranks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.flowconf import FlowConfidenceEstimator
from ..ops.filters import dilate, ellipse_kernel
from ..ops.warp import warp_mask_fused
from ..parallel import mesh as PM
from ..utils.images import (PngWriter, bgr_f32_to_u8, bgr_f32d_to_model,
                            bgr_u8_to_model, model_to_bgr_f32d,
                            model_to_bgr_u8, queue_host_copies, write_png)
from ..utils.profiling import annotate
from . import facades as F
from .keyframes import FrameGenConfig, frame_generator
from .tagger import NEGATIVE_PROMPT


@dataclass
class PixelInpaintConfig:
    """The JAX config's fields, with its defaults."""
    name: str = "tpu"
    size: Tuple[int, int] = (512, 768)      # (width, height)
    keep_every: int = 3
    key_frame_thres: float = 24.0
    denoising_strength: float = 0.4
    confidence_thres: float = 0.95
    propagated_pixel_weight: float = 0.0
    mask_dilate: int = 7
    mask_blur: int = 16
    ddim_steps: int = 50
    seed: int = 1234
    prompt_extra: str = ""
    write_vis: bool = True
    guidance_schedule_func: Callable[[float], float] = lambda p: 1.0
    sampler: str = "ddim"        # or 'dpmpp' / 'dpmpp:N'
    cfg_interval: int = 1
    deepcache_interval: int = 0
    # run_batched: non-key frames of a key frame's segment per batch (they
    # all warp the same AI key frame, so they are independent)
    frame_batch: int = 1
    # flow pairs per RAFT call in run_batched (0: the whole batch)
    flow_chunk: int = 4
    # > 0: shard run_batched's frame batches over the 'dp' axis of a mesh
    # of this many ranks (an initialised process group of world size dp;
    # every rank runs run_batched on the same frames, rank 0 writes);
    # frame_batch % dp must be 0
    dp: int = 0
    # pad a segment's ragged tail batch up to frame_batch by repeating its
    # last frame (the padding's outputs are dropped): every batch then has
    # one shape; the outputs are the same either way
    pad_tail_batch: bool = True


def generate_mask(cum_confidence: np.ndarray, log_confidence: np.ndarray,
                  thres: float = 0.8, dilate_size: int = 7, device="cuda"):
    """The low-confidence inpaint mask: 255 where confidence < thres,
    dilated by an ellipse (on ``device``), and log-confidence reset to 0
    there. Returns (mask_u8, log_confidence) as numpy."""
    mask = (cum_confidence < thres).astype(np.float32)
    log_confidence = np.where(cum_confidence < thres, 0.0, log_confidence)
    mask = dilate(torch.from_numpy(mask).to(device),
                  ellipse_kernel(dilate_size)).cpu().numpy()
    return (mask * 255).astype(np.uint8), log_confidence


def mix_propagated_ai_frame(raw_ai_frame: np.ndarray,
                            warped_ai_frame: np.ndarray,
                            mask_u8: np.ndarray,
                            weight: float = 1.0) -> np.ndarray:
    """Blend freshly inpainted and propagated pixels: ``weight`` of the
    warped frame outside the mask, 1 - ``weight`` inside it."""
    if weight < 0.001:
        return raw_ai_frame
    w = np.where(mask_u8 <= 127, weight, 1.0 - weight)[..., None]
    out = raw_ai_frame.astype(np.float32) * (1 - w) + \
        warped_ai_frame.astype(np.float32) * w
    return np.clip(out, 0, 255).astype(np.uint8)


def _prompt_for(tagger, frame_bgr, extra: str) -> str:
    """The tagger's prompt for the frame, or the fixed prefix. ``tagger``
    is None or any object with ``available`` and ``build_prompt``."""
    if tagger is not None and tagger.available:
        return tagger.build_prompt(frame_bgr, extra)
    base = "masterpiece,best quality,"
    return base + extra if extra else base[:-1]


def run_inpainting(sd_inpaint: F.StableDiffusionBundle, tagger,
                   warped_ai_frame_bgr: np.ndarray,
                   reference_frame_bgr: np.ndarray,
                   mask_u8: np.ndarray, cfg: PixelInpaintConfig):
    """Seeded masked inpainting: prompt from the raw frame, image = the
    warped AI frame, reference = the raw frame. Returns (inpainted,
    decoded init latent) as BGR uint8."""
    prompt = _prompt_for(tagger, reference_frame_bgr, cfg.prompt_extra)
    dev = sd_inpaint.device
    img, _, init_dec, _ = F.img2img_inpaint(
        sd_inpaint,
        image=bgr_u8_to_model(warped_ai_frame_bgr, dev),
        c_text=prompt,
        uc_text=NEGATIVE_PROMPT,
        denoising_strength=cfg.denoising_strength,
        ddim_steps=cfg.ddim_steps,
        reference_img=bgr_u8_to_model(reference_frame_bgr, dev),
        mask=(mask_u8.astype(np.float32) / 255.0),
        mask_blur=cfg.mask_blur,
        guidance_schedule_func=cfg.guidance_schedule_func,
        seed=cfg.seed)
    return model_to_bgr_u8(img), model_to_bgr_u8(init_dec)


def keyframe_img2img(sd: F.StableDiffusionBundle, tagger,
                     frame_bgr: np.ndarray, cfg: PixelInpaintConfig):
    """The key frame's plain img2img -> BGR uint8."""
    prompt = _prompt_for(tagger, frame_bgr, cfg.prompt_extra)
    with annotate("sdaof.wait.upload"):
        frame_d = bgr_u8_to_model(frame_bgr, sd.device)
    img, _ = F.img2img(sd, frame_d, prompt, NEGATIVE_PROMPT,
                       cfg.denoising_strength, cfg.ddim_steps, seed=cfg.seed,
                       sampler=cfg.sampler, cfg_interval=cfg.cfg_interval,
                       deepcache_interval=cfg.deepcache_interval)
    # drains the stream: the key frame feeds every warp of its segment
    with annotate("sdaof.wait.key_readback"):
        return model_to_bgr_u8(img)


def _lookahead(iterable):
    """Yield (item, next_item_or_None): the loop queues frame t+1's flow
    before it reads frame t's results."""
    it = iter(iterable)
    try:
        cur = next(it)
    except StopIteration:
        return
    for nxt in it:
        yield cur, nxt
        cur = nxt
    yield cur, None


def run(frames: Iterable[Tuple[np.ndarray, bool, int]],
        save_dir: str,
        sd: F.StableDiffusionBundle,
        sd_inpaint: F.StableDiffusionBundle,
        flow_estimator: FlowConfidenceEstimator,
        tagger=None,
        cfg: PixelInpaintConfig = PixelInpaintConfig()):
    """Run the pipeline over (frame_bgr, is_key, index) triples and write
    its PNGs into ``<save_dir>_pixel_warp-<name>`` (returned).

    The next frame's flow + confidence is queued before the current
    frame's inpaint, and its results are read only when that frame comes
    up: on one CUDA stream this orders the work, nothing runs beside it.
    The warp, the mask and the inpaint stay on the device; the host sees
    the frames it writes. PNGs are written behind on worker threads."""
    out_dir = f"{save_dir}_pixel_warp-{cfg.name}"
    os.makedirs(out_dir, exist_ok=True)
    dev = sd_inpaint.device
    kernel = ellipse_kernel(cfg.mask_dilate)

    reference_frame: Optional[np.ndarray] = None
    reference_ai_frame: Optional[np.ndarray] = None
    reference_ai_d = None   # device BGR float copy of the AI reference
    pending_flow = None     # the current frame's queued flow, if any

    def dispatch_flow(ref_bgr, cur_bgr):
        # uint8 upload; BGR -> RGB here, the f32 cast in the estimator
        rgb = lambda f: torch.as_tensor(np.ascontiguousarray(f),
                                        device=flow_estimator.device
                                        )[None].flip(-1)
        return flow_estimator.calc_batch_device(rgb(ref_bgr), rgb(cur_bgr))

    writer = PngWriter()
    try:
        for (frame_bgr, is_key, counter), nxt in _lookahead(frames):
            if is_key:
                pending_flow = None
                ai_frame = keyframe_img2img(sd, tagger, frame_bgr, cfg)
                reference_frame = frame_bgr
                reference_ai_frame = ai_frame
                reference_ai_d = None   # uploaded on the first warp
                if nxt is not None and not nxt[1]:
                    pending_flow = dispatch_flow(reference_frame, nxt[0])
                if cfg.write_vis:
                    vis = np.concatenate([frame_bgr, frame_bgr, ai_frame,
                                          ai_frame, frame_bgr, ai_frame],
                                         axis=1)
                    writer.submit(f"{out_dir}/vis_{counter:06d}.png", vis)
                    writer.submit(
                        f"{out_dir}/pixel_confidence_{counter:06d}.png",
                        np.ones(frame_bgr.shape[:2], np.uint8))
            else:
                if pending_flow is None:
                    pending_flow = dispatch_flow(reference_frame, frame_bgr)
                flow_d, conf_d, _ = pending_flow
                pending_flow = None
                if nxt is not None and not nxt[1]:
                    pending_flow = dispatch_flow(reference_frame, nxt[0])

                if reference_ai_d is None:
                    reference_ai_d = torch.as_tensor(
                        np.ascontiguousarray(reference_ai_frame),
                        device=dev).float()
                warped_d, mask01_d = warp_mask_fused(
                    reference_ai_d, flow_d[0].to(dev), conf_d[0].to(dev),
                    kernel, conf_thres=cfg.confidence_thres)

                prompt = _prompt_for(tagger, frame_bgr, cfg.prompt_extra)
                img_out, _, _, _ = F.img2img_inpaint(
                    sd_inpaint,
                    image=bgr_f32d_to_model(warped_d),
                    c_text=prompt, uc_text=NEGATIVE_PROMPT,
                    denoising_strength=cfg.denoising_strength,
                    ddim_steps=cfg.ddim_steps,
                    reference_img=bgr_u8_to_model(frame_bgr, dev),
                    mask=mask01_d, mask_blur=cfg.mask_blur,
                    guidance_schedule_func=cfg.guidance_schedule_func,
                    seed=cfg.seed, want_init_decoded=False,
                    sampler=cfg.sampler, cfg_interval=cfg.cfg_interval)
                raw_ai_d = model_to_bgr_f32d(img_out)
                if cfg.propagated_pixel_weight >= 0.001:
                    wt = cfg.propagated_pixel_weight
                    w = torch.where(mask01_d <= 0.5, wt, 1.0 - wt)[..., None]
                    ai_d = raw_ai_d * (1.0 - w) + warped_d * w
                else:
                    ai_d = raw_ai_d
                # the AI reference stays the key frame's: every warp runs
                # key frame -> frame
                ai_frame = bgr_f32_to_u8(ai_d)

                if cfg.write_vis:
                    conf = conf_d[0].cpu().numpy()
                    conf_u8 = np.clip(conf * 255, 0, 255).astype(np.uint8)
                    writer.submit(
                        f"{out_dir}/pixel_confidence_{counter:06d}.png",
                        conf_u8)
                    warped_ai = bgr_f32_to_u8(warped_d)
                    mask_u8 = (mask01_d.cpu().numpy() * 255).astype(np.uint8)
                    masked = warped_ai.copy()
                    masked[mask_u8 > 127] = np.array([0, 0, 255], np.uint8)
                    vis = np.concatenate([reference_frame, frame_bgr,
                                          bgr_f32_to_u8(raw_ai_d), ai_frame,
                                          warped_ai, masked], axis=1)
                    writer.submit(f"{out_dir}/vis_{counter:06d}.png", vis)

            writer.submit(f"{out_dir}/converted_{counter:06d}.png", ai_frame)
    finally:
        writer.close()
    return out_dir


def run_video(video_path: str, save_dir: str, sd, sd_inpaint,
              flow_estimator, tagger=None,
              cfg: PixelInpaintConfig = PixelInpaintConfig()):
    """``run`` over a video file: decoded and its key frames detected by
    ``keyframes.frame_generator`` (cv2 decodes; the detector runs on the
    inpaint bundle's device)."""
    frames = frame_generator(video_path, FrameGenConfig(
        size=cfg.size, keep_every=cfg.keep_every,
        threshold=cfg.key_frame_thres), device=sd_inpaint.device)
    return run(frames, save_dir, sd, sd_inpaint, flow_estimator, tagger, cfg)


# ---------------------------------------------------------------------------
# batched segments
# ---------------------------------------------------------------------------

def _dispatch_batch_flow(batch, reference_frame, flow_estimator,
                         flow_chunk: int = 4):
    """Queue a batch's flow + confidence against the key frame, without a
    host sync, so it runs behind the previous batch's denoise. The frames
    are uploaded once, as uint8 (the inpaint stage reuses them), and RAFT
    runs in ``flow_chunk``-pair calls (<= 0: one call) against the
    broadcast reference. Returns device (flow, conf, frames_u8)."""
    dev = flow_estimator.device
    with annotate("sdaof.wait.upload"):
        frames_u8_d = torch.as_tensor(np.stack([f for f, _ in batch]),
                                      device=dev)             # u8 BGR
    with annotate("sdaof.wait.upload"):
        ref_u8_d = torch.as_tensor(np.ascontiguousarray(reference_frame),
                                   device=dev)
    flows, confs = [], []
    chunk = flow_chunk if flow_chunk > 0 else len(batch)
    for s in range(0, len(batch), chunk):
        tgt = frames_u8_d[s:s + chunk].flip(-1)
        src = ref_u8_d[None].flip(-1).expand(tgt.shape)
        flow_d, conf_d, _ = flow_estimator.calc_batch_device(src, tgt)
        flows.append(flow_d)
        confs.append(conf_d)
    return torch.cat(flows), torch.cat(confs), frames_u8_d


def _dispatch_batch_denoise(batch, flow_pair, reference_frame,
                            reference_ai_frame, sd_inpaint, tagger, cfg,
                            mesh=None, n_real=None):
    """Queue one batch's device work (warp + mask, the batched inpaint,
    the propagated-pixel mix, the uint8 conversion) and its copies to
    the host, without a host sync. Returns what the finalize needs: the
    host buffers, their event, and the host state captured now.
    ``n_real``: with tail padding, how many leading frames are real.
    ``mesh``: the inpaint's frames split over its 'dp' ranks; a ragged
    batch (not a multiple of dp) is denoised whole on every rank."""
    if n_real is None:
        n_real = len(batch)
    if mesh is not None and len(batch) % PM.axis_group(mesh, "dp")[2]:
        mesh = None
    flow_d, conf_d, frames_u8_d = flow_pair
    dev = sd_inpaint.device
    with annotate("sdaof.wait.upload"):
        ref_ai_d = torch.as_tensor(np.ascontiguousarray(reference_ai_frame),
                                   device=dev).float()
    warped_d, mask01_d = warp_mask_fused(                     # [B,H,W,3]
        ref_ai_d, flow_d.to(dev), conf_d.to(dev),
        ellipse_kernel(cfg.mask_dilate), conf_thres=cfg.confidence_thres)

    # prompt only the real frames: a padded duplicate would pay a tagger
    # inference whose output is dropped
    prompts = [_prompt_for(tagger, f, cfg.prompt_extra)
               for f, _ in batch[:n_real]]
    prompts += [prompts[-1]] * (len(batch) - n_real)
    imgs_model = warped_d.flip(-1) / 127.5 - 1.0
    refs_model = frames_u8_d.to(dev).flip(-1).float() / 127.5 - 1.0
    outs = F.img2img_inpaint_batch(
        sd_inpaint, imgs_model, prompts, NEGATIVE_PROMPT, mask01_d,
        refs_model, denoising_strength=cfg.denoising_strength,
        ddim_steps=cfg.ddim_steps, mask_blur=cfg.mask_blur,
        guidance_schedule_func=cfg.guidance_schedule_func, seed=cfg.seed,
        sampler=cfg.sampler, cfg_interval=cfg.cfg_interval, mesh=mesh)
    outs_bgr = torch.clamp(outs.float() * 127.5 + 127.5, 0, 255).flip(-1)
    if cfg.propagated_pixel_weight >= 0.001:
        wt = cfg.propagated_pixel_weight
        w = torch.where(mask01_d <= 0.5, wt, 1.0 - wt)[..., None]
        outs_bgr = outs_bgr * (1.0 - w) + warped_d * w

    # clipped and floored to uint8 on the device (numpy's astype(uint8)
    # of the clipped range), so only uint8 crosses to the host
    out = {"outs": torch.floor(torch.clamp(outs_bgr[:n_real], 0, 255)
                               ).to(torch.uint8)}
    if cfg.write_vis:
        out["conf"] = torch.clamp(conf_d[:n_real] * 255, 0, 255
                                  ).to(torch.uint8)
        out["warped"] = torch.floor(torch.clamp(warped_d[:n_real], 0, 255)
                                    ).to(torch.uint8)
        out["mask"] = (mask01_d[:n_real] * 255).to(torch.uint8)
    # read back through pinned buffers and this batch's own event: a
    # .cpu() here would also wait for the next batch's work queued behind
    hosts, ready = queue_host_copies(list(out.values()))
    return {"batch": batch, "n_real": n_real,
            "reference_frame": reference_frame,
            "host": dict(zip(out, hosts)), "ready": ready}


def _finalize_batch(res, out_dir, cfg, writer=None):
    """Wait for a dispatched batch's host copies (its event alone) and
    write its PNGs, behind on ``writer``'s threads when given."""
    put = writer.submit if writer is not None else write_png
    with annotate("sdaof.wait.batch_readback"):
        if res["ready"] is not None:
            res["ready"].synchronize()
    host = {k: t.numpy() for k, t in res["host"].items()}
    outs_u8 = host["outs"]
    for i, (frame_bgr, counter) in enumerate(res["batch"][:res["n_real"]]):
        put(f"{out_dir}/converted_{counter:06d}.png", outs_u8[i])
        if cfg.write_vis:
            put(f"{out_dir}/pixel_confidence_{counter:06d}.png",
                host["conf"][i])
            masked = host["warped"][i].copy()
            masked[host["mask"][i] > 127] = np.array([0, 0, 255], np.uint8)
            vis = np.concatenate([res["reference_frame"], frame_bgr,
                                  outs_u8[i], outs_u8[i], host["warped"][i],
                                  masked], axis=1)
            put(f"{out_dir}/vis_{counter:06d}.png", vis)


def _process_batch(batch, flow_pair, out_dir, reference_frame,
                   reference_ai_frame, sd_inpaint, tagger, cfg,
                   n_real=None):
    """Dispatch and finalize one batch back to back (``run_batched``
    overlaps the two across batches instead)."""
    res = _dispatch_batch_denoise(batch, flow_pair, reference_frame,
                                  reference_ai_frame, sd_inpaint, tagger,
                                  cfg, n_real=n_real)
    _finalize_batch(res, out_dir, cfg)


def run_batched(frames: Iterable[Tuple[np.ndarray, bool, int]],
                save_dir: str,
                sd: F.StableDiffusionBundle,
                sd_inpaint: F.StableDiffusionBundle,
                flow_estimator: FlowConfidenceEstimator,
                tagger=None,
                cfg: PixelInpaintConfig = PixelInpaintConfig()):
    """Segment-batched :func:`run`: the non-key frames of a key frame's
    segment go in batches of ``cfg.frame_batch`` (all warp the same AI
    key frame, so they are independent) through one flow, warp + mask
    and inpaint call each. The files and frames are :func:`run`'s.

    A three-stage software pipeline on the one stream: while batch k's
    denoise runs on the card, batch k+1's flow is queued behind it and
    batch k-1's frames are read back (its own event) and written.

    ``cfg.dp`` > 0: data parallelism over a mesh of dp ranks (the
    initialised process group; ``make_mesh`` raises without one). Every
    rank calls with the same frames and bundles: the bundles' weights are
    broadcast from rank 0 (``replicate_tree``, in place), every rank
    computes the same flow and key frames, each denoises its frame_batch
    / dp frames of a batch, and rank 0 alone writes the files.

    While a profiler runs, each stage (``sdaof.pixel.key`` / ``flow`` /
    ``denoise`` / ``finalize`` / ``close``) and each place the host may
    block on the card or the PNG writer (``sdaof.wait.*``) is a range in
    its trace (``utils/profiling.annotate``)."""
    out_dir = f"{save_dir}_pixel_warp-{cfg.name}"
    bsz = max(cfg.frame_batch, 1)
    mesh = None
    if cfg.dp > 0:
        if bsz % cfg.dp:
            raise ValueError(f"frame_batch={bsz} not divisible by "
                             f"dp={cfg.dp}")
        mesh = PM.make_mesh(dp=cfg.dp,
                            device_type=sd_inpaint.device.type)
        for bundle in (sd, sd_inpaint):
            PM.replicate_tree((bundle.unet_params, bundle.vae_params,
                               bundle.clip_params), mesh)
    write = mesh is None or dist.get_rank() == 0
    if write:
        os.makedirs(out_dir, exist_ok=True)

    reference_frame = None
    reference_ai_frame = None
    pending: list = []
    inflight = None      # ((batch, n_real), flow_pair) with its flow queued
    denoised = None      # a queued denoise awaiting its finalize
    writer = PngWriter()

    def process_inflight():
        nonlocal inflight, denoised
        if inflight is not None:
            (batch, n_real), flow_pair = inflight
            inflight = None
            with annotate("sdaof.pixel.denoise"):
                res = _dispatch_batch_denoise(
                    batch, flow_pair, reference_frame, reference_ai_frame,
                    sd_inpaint, tagger, cfg, mesh=mesh, n_real=n_real)
            prev, denoised = denoised, (res if write else None)
            if prev is not None:
                with annotate("sdaof.pixel.finalize"):
                    _finalize_batch(prev, out_dir, cfg, writer)

    def queue_batch():
        """Queue this batch's flow, then the previous batch's denoise
        behind it."""
        nonlocal pending, inflight
        if not pending:
            return
        batch, n_real = pending, len(pending)
        if cfg.pad_tail_batch and 0 < n_real < bsz:
            batch = batch + [batch[-1]] * (bsz - n_real)
        with annotate("sdaof.pixel.flow"):
            new = ((batch, n_real),
                   _dispatch_batch_flow(batch, reference_frame,
                                        flow_estimator, cfg.flow_chunk))
        pending = []
        process_inflight()
        inflight = new

    try:
        for frame_bgr, is_key, counter in frames:
            if is_key:
                queue_batch()
                process_inflight()
                with annotate("sdaof.pixel.key"):
                    ai_frame = keyframe_img2img(sd, tagger, frame_bgr, cfg)
                    reference_frame = frame_bgr
                    reference_ai_frame = ai_frame
                    if not write:
                        continue
                    writer.submit(f"{out_dir}/converted_{counter:06d}.png",
                                  ai_frame)
                    if cfg.write_vis:
                        vis = np.concatenate([frame_bgr, frame_bgr, ai_frame,
                                              ai_frame, frame_bgr, ai_frame],
                                             axis=1)
                        writer.submit(f"{out_dir}/vis_{counter:06d}.png",
                                      vis)
                        writer.submit(
                            f"{out_dir}/pixel_confidence_{counter:06d}.png",
                            np.ones(frame_bgr.shape[:2], np.uint8))
            else:
                pending.append((frame_bgr, counter))
                if len(pending) >= bsz:
                    queue_batch()
        queue_batch()
        with annotate("sdaof.pixel.close"):
            process_inflight()
            if denoised is not None:
                with annotate("sdaof.pixel.finalize"):
                    _finalize_batch(denoised, out_dir, cfg, writer)
                denoised = None
            with annotate("sdaof.wait.png"):
                writer.close()
    finally:
        writer.close()          # a no-op once closed
    return out_dir
