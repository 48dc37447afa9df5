"""Warp-as-guidance pipeline (the reference's ``ofgen.py`` variant), on
torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/ofgen.py``:
frame-to-frame stabilization without inpainting. The flow between
consecutive raw frames backward-warps the previous *converted* frame
(with the negated forward flow), an unsharp mask sharpens it, and img2img
takes it as a per-step, per-pixel pred_x0 guidance target: weight 0.6
early / 0.4 late in the denoise, 0.1 where the flow moves more than 1.5
px. The warp, the unsharp mask and the conversion to uint8 run on the
bundle's device; each frame's two images (the guidance target and the
converted frame) come to the host in one copy.

Outputs: ``raw_%06d.png``, ``wrapped_%06d.png``, ``converted_%06d.png``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from ..ops.filters import gaussian_blur
from ..ops.warp import warp_frame
from ..utils.images import bgr_u8_to_model, write_png
from . import facades as F
from .tagger import NEGATIVE_PROMPT, Tagger


@dataclass
class OfgenConfig:
    denoising_strength: float = 0.4
    ddim_steps: int = 50
    dist_thres: float = 1.5
    weight_early: float = 0.6
    weight_late: float = 0.4
    weight_moving: float = 0.1
    early_until: float = 0.8
    seed: int = 1234
    prompt_extra: str = ""
    unsharp_amount: float = 0.12     # the reference's 1.12 / -0.12


def unsharp_ofgen(img_bgr_u8, amount: float = 0.12, device="cuda"):
    """(1 + amount) img - amount blur(img), blur the sigma-2 Gaussian of 13
    taps, clipped and truncated to uint8. img_bgr_u8 [H, W, 3] (numpy, or
    a tensor that stays on its device; numpy goes to ``device``) ->
    uint8 tensor."""
    img = img_bgr_u8 if torch.is_tensor(img_bgr_u8) else torch.as_tensor(
        np.ascontiguousarray(img_bgr_u8), device=device)
    img = img.float()
    blurred = gaussian_blur(img, 2.0, ksize=13)
    out = (1 + amount) * img - amount * blurred
    return out.clamp(0.0, 255.0).to(torch.uint8)


def make_guidance_schedule(dist: np.ndarray, cfg: OfgenConfig):
    """Per-step weight-map schedule: a host function p -> [H, W] float32
    map (``weight_early`` before ``early_until``, ``weight_late`` after,
    ``weight_moving`` where ``dist`` > ``dist_thres``)."""
    def schedule(p):
        w = np.full(dist.shape,
                    cfg.weight_early if p < cfg.early_until
                    else cfg.weight_late, np.float32)
        w[dist > cfg.dist_thres] = cfg.weight_moving
        return w
    return schedule


def _model_to_bgr_u8(img):
    """Device [1, H, W, 3] RGB [-1, 1] -> [H, W, 3] BGR uint8 on the same
    device (``utils.images.model_to_bgr_u8``'s arithmetic)."""
    arr = torch.clamp(img[0].float() * 127.5 + 127.5, 0.0, 255.0)
    return arr.to(torch.uint8).flip(-1)


def run(frames: Iterable[np.ndarray], save_dir: str,
        sd: F.StableDiffusionBundle, flow_calc,
        tagger: Optional[Tagger] = None,
        cfg: OfgenConfig = OfgenConfig()):
    """frames: iterable of BGR uint8 arrays. ``flow_calc(prev, cur)``
    returns the forward flow prev -> cur [H, W, 2] (RAFT contract; numpy
    or a tensor). Returns ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    dev = sd.device
    last_frame: Optional[np.ndarray] = None
    last_converted: Optional[torch.Tensor] = None

    for ctr, frame in enumerate(frames):
        target = None
        if last_frame is not None:
            flow = flow_calc(last_frame, frame)
            flow_h = flow.float().cpu().numpy() if torch.is_tensor(flow) \
                else np.asarray(flow, np.float32)
            dist = np.sqrt(flow_h[..., 0] ** 2 + flow_h[..., 1] ** 2)
            # backward warp with the NEGATED forward flow
            warped = warp_frame(last_converted.float(),
                                -torch.as_tensor(flow_h, device=dev))
            target = unsharp_ofgen(warped.clamp(0.0, 255.0).to(torch.uint8),
                                   cfg.unsharp_amount)
        else:
            dist = np.zeros(frame.shape[:2], np.float32)

        prompt = "masterpiece,best quality,"
        if tagger is not None and tagger.available:
            prompt = tagger.build_prompt(frame, cfg.prompt_extra)
        elif cfg.prompt_extra:
            prompt += cfg.prompt_extra

        out, _ = F.img2img(
            sd, bgr_u8_to_model(frame, dev), prompt, NEGATIVE_PROMPT,
            cfg.denoising_strength, cfg.ddim_steps,
            target_img=None if target is None
            else target.flip(-1).float()[None] / 127.5 - 1.0,
            guidance_schedule_func=make_guidance_schedule(dist, cfg),
            seed=cfg.seed)
        converted = _model_to_bgr_u8(out)
        outs = torch.stack([converted] + ([] if target is None
                                          else [target])).cpu().numpy()
        if target is not None:
            write_png(f"{save_dir}/wrapped_{ctr:06d}.png", outs[1])
        write_png(f"{save_dir}/raw_{ctr:06d}.png", frame)
        write_png(f"{save_dir}/converted_{ctr:06d}.png", outs[0])
        last_frame = frame
        last_converted = converted
    return save_dir
