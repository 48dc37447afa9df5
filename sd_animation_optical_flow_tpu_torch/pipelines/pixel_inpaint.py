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
``<save_dir>_pixel_warp-<name>``. ``run_video`` (video decode and key
frame detection) and ``run_batched`` (segment batches) are not ported
yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.flowconf import FlowConfidenceEstimator
from ..ops.filters import dilate, ellipse_kernel
from ..ops.warp import warp_mask_fused
from ..utils.images import (PngWriter, bgr_f32_to_u8, bgr_f32d_to_model,
                            bgr_u8_to_model, model_to_bgr_f32d,
                            model_to_bgr_u8)
from . import facades as F

NEGATIVE_PROMPT = "worst quality, low quality, normal quality"


@dataclass
class PixelInpaintConfig:
    """The JAX config's fields that ``run`` reads; the frame-selection
    (``size``, ``keep_every``, ``key_frame_thres``) and batching
    (``frame_batch``, ``flow_chunk``, ``dp``, ``pad_tail_batch``) fields
    come with ``run_video`` and ``run_batched``."""
    name: str = "tpu"
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
    img, _ = F.img2img(sd, bgr_u8_to_model(frame_bgr, sd.device), prompt,
                       NEGATIVE_PROMPT, cfg.denoising_strength,
                       cfg.ddim_steps, seed=cfg.seed, sampler=cfg.sampler,
                       cfg_interval=cfg.cfg_interval,
                       deepcache_interval=cfg.deepcache_interval)
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
    """Video decode and key-frame detection (``pipelines/keyframes.py``)
    are not ported yet."""
    raise NotImplementedError("run_video is not ported to the torch "
                              "package yet (ROADMAP §1 item 5)")


def run_batched(*args, **kwargs):
    """The segment-batched pixel pipeline is not ported yet."""
    raise NotImplementedError("run_batched is not ported to the torch "
                              "package yet (ROADMAP §1 item 5)")
