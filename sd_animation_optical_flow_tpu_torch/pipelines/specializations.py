"""LatentDiffusion specializations: depth2img and latent upscaling.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/specializations.py``
(``DepthConditioner``, ``img2img_depth2img``, ``upscale``). depth2img runs
the DPT on the input frame and feeds its normalized depth to a 5-channel
UNet as the concat channel, through the img2img core (DDIM, CFG stem
dedup). The upscaler samples a latent on the low-res image's grid from
the prior, conditioned on the noise-augmented low-res image (concat) and
its noise level (the class label of a 7-channel class-conditional UNet),
and decodes it. Every noise is an argument of the cores and drawn from
``torch.Generator(sd.device).manual_seed(seed)`` by the public facades.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..diffusion import ddim as D
from ..diffusion import upscaling as UP
from ..diffusion.schedule import make_ddim_params_traced
from ..models import depth as DP
from ..models import vae as V
from .facades import (StableDiffusionBundle, _latent_core, _latent_shape,
                      _t_enc, _unet_fn, draw_img2img_noise)


# ---------------------------------------------------------------------------
# depth2img
# ---------------------------------------------------------------------------

@dataclass
class DepthConditioner:
    """The depth stage: a DPT whose output becomes the UNet's fifth input
    channel. Its params are f32 (the DPT runs in f32)."""
    params: dict
    cfg: DP.DPTConfig


def depth_concat(depth: DepthConditioner, img, latent_hw):
    """The DPT on ``img`` [B, H, W, 3] in [-1, 1] (as f32, mapped to [0,
    1] and normalized) -> the depth concat channel [B, h, w, 1] in [-1,
    1] at ``latent_hw``."""
    img01 = (img.float() + 1.0) * 0.5
    d = DP.dpt_apply(depth.params, depth.cfg,
                     DP.midas_normalize(img01, depth.cfg))
    return DP.depth_to_concat(d, latent_hw)


def _depth2img_core(sd: StableDiffusionBundle, depth: DepthConditioner,
                    img, ctx_cond, ctx_uncond, enc_noise, noise, *,
                    t_enc: int, ddim_steps: int, cfg_scale: float,
                    capture_kv: bool):
    """VAE encode (posterior noise ``enc_noise``), the depth channel, then
    the img2img core with it as ``c_concat`` (``noise``: the
    ``stochastic_encode`` noise). Returns (image, final latent,
    kv_hist)."""
    init_latent = V.encode(sd.vae_params, sd.vae_cfg, img.to(sd.dtype),
                           noise=enc_noise)
    c_concat = depth_concat(depth, img, tuple(init_latent.shape[1:3]))
    return _latent_core(sd, init_latent, ctx_cond, ctx_uncond, noise,
                        t_enc=t_enc, ddim_steps=ddim_steps,
                        cfg_scale=cfg_scale, sampler="ddim",
                        c_concat=c_concat.to(sd.dtype),
                        capture_kv=capture_kv)


def img2img_depth2img(sd: StableDiffusionBundle, depth: DepthConditioner,
                      img, c_text: str, uc_text: str,
                      denoising_strength: float = 0.5,
                      ddim_steps: int = 50, cfg_scale: float = 7.0,
                      seed: int = 1234, capture_kv: bool = False):
    """Depth-conditioned img2img: the DPT's depth of ``img`` [B, H, W, 3]
    in [-1, 1], min-max normalized at the latent's size, is the concat
    channel of a 5-channel UNet (4 latent + 1 depth). Returns (image,
    kv_hist or None)."""
    if sd.unet_cfg.in_channels != 5:
        raise ValueError("depth2img needs a 5-channel UNet (4 latent + 1 "
                         f"depth), got in_channels {sd.unet_cfg.in_channels}")
    img = torch.as_tensor(img, device=sd.device)
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    shape = _latent_shape(sd, img.shape)
    b = shape[0]
    t_enc = _t_enc(denoising_strength, ddim_steps)
    gen = torch.Generator(sd.device).manual_seed(seed)
    noise = draw_img2img_noise(gen, shape, t_enc, target=False, pixel=False,
                               device=sd.device)
    out, _, kv = _depth2img_core(
        sd, depth, img, ctx_c.expand(b, -1, -1), ctx_u.expand(b, -1, -1),
        noise.enc, noise.forward, t_enc=t_enc, ddim_steps=ddim_steps,
        cfg_scale=cfg_scale, capture_kv=capture_kv)
    return out, kv


# ---------------------------------------------------------------------------
# latent upscaling
# ---------------------------------------------------------------------------

def _upscale_core(sd: StableDiffusionBundle, x_low, ctx_cond, ctx_uncond,
                  noise_level, aug_noise, x_T, *, ddim_steps: int,
                  cfg_scale: float,
                  low_scale_cfg: UP.LowScaleConfig = UP.LowScaleConfig()):
    """Noise-augment ``x_low`` to ``noise_level`` ([B] int) with
    ``aug_noise``, then DDIM from the prior sample ``x_T`` [B, h, w, 4]
    (h, w the low-res grid) with the augmented image as the concat
    channels and the level as the class label of both CFG halves (plain
    batch doubling: the stem dedup does not take labels), then the VAE
    decode. Returns (image clipped to [-1, 1], the level)."""
    zx, lvl = UP.noise_augment(UP.make_low_scale_schedule(low_scale_cfg),
                               x_low, aug_noise, noise_level)
    ddim = make_ddim_params_traced(sd.sched, ddim_steps)
    model_fn = _unet_fn(sd, y=torch.cat([lvl, lvl]))
    z = D.ddim_decode(model_fn, sd.sched, ddim, x_T.to(x_low.dtype),
                      D.CondBundle(ctx_cond, zx), D.CondBundle(ctx_uncond, zx),
                      ddim_steps, cfg_scale=cfg_scale,
                      parameterization=sd.parameterization)
    img = V.decode(sd.vae_params, sd.vae_cfg, z)
    return img.clamp(-1.0, 1.0), lvl


def upscale(sd: StableDiffusionBundle, x_low, c_text: str, uc_text: str,
            noise_level=None, ddim_steps: int = 50, cfg_scale: float = 7.0,
            seed: int = 1234, max_noise_level: int = 350,
            low_scale_cfg: UP.LowScaleConfig = UP.LowScaleConfig()):
    """Latent upscaling: x_low [B, h, w, 3] in [-1, 1] -> image [B, f h, f w,
    3], f the VAE's factor (the sampled latent lies on the low-res grid).
    ``noise_level``: [B] int levels, or None to draw them uniformly below
    ``max_noise_level``. The UNet must take 4 + 3 channels and be
    class-conditional on the level. The level, the augmentation noise and
    x_T are drawn in that order from ``torch.Generator(sd.device)
    .manual_seed(seed)``. Returns (image, the level used)."""
    if sd.unet_cfg.in_channels != 7:
        raise ValueError("the upscaler needs a 7-channel UNet (4 latent + 3 "
                         f"low-res), got in_channels "
                         f"{sd.unet_cfg.in_channels}")
    if sd.unet_cfg.num_classes is None:
        raise ValueError("the upscaler's UNet must be class-conditional on "
                         "the noise level (num_classes)")
    x_low = torch.as_tensor(x_low, device=sd.device).to(sd.dtype)
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    b, h, w, _ = x_low.shape
    gen = torch.Generator(sd.device).manual_seed(seed)
    if noise_level is None:
        noise_level = torch.randint(0, max_noise_level, (b,), generator=gen,
                                    device=sd.device)
    aug_noise = torch.randn(tuple(x_low.shape), generator=gen,
                            device=sd.device)
    x_T = torch.randn((b, h, w, 4), generator=gen, device=sd.device)
    return _upscale_core(sd, x_low, ctx_c.expand(b, -1, -1),
                         ctx_u.expand(b, -1, -1), noise_level, aug_noise,
                         x_T, ddim_steps=ddim_steps, cfg_scale=cfg_scale,
                         low_scale_cfg=low_scale_cfg)
