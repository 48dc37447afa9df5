"""log_images: the training/debug image-panel dictionary.

Counterpart of ``sd_animation_optical_flow_tpu/utils/log_images.py``
(the parity surface of LatentDiffusion.log_images): inputs, VAE
reconstruction, prompt panel, forward-diffusion row, sampled images
(DDIM) and a CFG-scaled sample set, on the port's ``diffusion/ddim.py``
and ``diffusion/schedule.py``. Returns a dict of uint8 HWC numpy images
(grids), ready for the pipelines' vis dumps.

The JAX function splits its four draws from ``PRNGKey(seed)``; here they
come from a ``torch.Generator`` seeded by ``seed`` on the bundle's device
(:func:`draw_log_images_noise`), or are given (``noise=``), so a caller
can feed the JAX program's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..diffusion import ddim as D
from ..diffusion.schedule import make_ddim_params_traced, q_sample
from ..models import unet as U
from ..models import vae as V
from .logging_images import (denoise_row_grid, log_txt_as_img, make_grid,
                             to_uint8)


@dataclass(frozen=True)
class LogImagesNoise:
    """The draws of :func:`log_images`, each shaped as the latent [N, h,
    w, z_channels]: the VAE posterior sample's noise, the forward-
    diffusion row's noise (one draw for every t, as in JAX), x_T of the
    sampled panel and of the CFG panel (None without ``cfg_scale``)."""
    enc: torch.Tensor
    diffusion: torch.Tensor
    samples: torch.Tensor
    samples_cfg: Optional[torch.Tensor] = None


def draw_log_images_noise(generator: torch.Generator, latent_shape,
                          cfg: bool) -> LogImagesNoise:
    """The four draws from ``generator`` on its device, in f32."""
    rn = lambda: torch.randn(tuple(latent_shape), generator=generator,
                             device=generator.device)
    return LogImagesNoise(rn(), rn(), rn(), rn() if cfg else None)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def log_images(sd, images, prompts: Sequence[str], *,
               n_row: int = 4, sample: bool = True, ddim_steps: int = 20,
               cfg_scale: Optional[float] = None,
               uc_prompt: str = "", n_diffusion_row: int = 6,
               seed: int = 0, noise: Optional[LogImagesNoise] = None
               ) -> Dict[str, np.ndarray]:
    """images [N, H, W, 3] in [-1, 1] (a tensor or array); prompts: one
    per image; ``sd`` a ``pipelines.facades.StableDiffusionBundle``.

    Keys mirror the reference's dict: 'inputs', 'reconstruction',
    'conditioning', 'diffusion_row', 'samples', and
    'samples_cfg_scale_{s}' when ``cfg_scale``. ``noise``: the draws
    (default: :func:`draw_log_images_noise` from ``seed``)."""
    images = torch.as_tensor(images, device=sd.device).float()
    n, h, w, _ = images.shape
    f = sd.vae_cfg.downscale
    shape = (n, h // f, w // f, sd.vae_cfg.z_channels)
    if noise is None:
        gen = torch.Generator(sd.device).manual_seed(seed)
        noise = draw_log_images_noise(gen, shape, cfg_scale is not None)
    decode = lambda lat: _np(V.decode(sd.vae_params, sd.vae_cfg,
                                      lat.to(sd.dtype)))
    out: Dict[str, np.ndarray] = {}

    out["inputs"] = to_uint8(make_grid(_np(images), nrow=n_row))

    with torch.no_grad():
        z = V.encode(sd.vae_params, sd.vae_cfg, images.to(sd.dtype),
                     noise=noise.enc)
        out["reconstruction"] = to_uint8(make_grid(decode(z), nrow=n_row))

        out["conditioning"] = to_uint8(make_grid(
            log_txt_as_img((w, h), list(prompts)), nrow=n_row))

        # forward diffusion row: q_sample at evenly spaced t, decoded
        T = sd.sched.num_timesteps
        row: List[np.ndarray] = []
        for t_scalar in np.linspace(0, T - 1, n_diffusion_row).astype(int):
            t = torch.full((n,), int(t_scalar), dtype=torch.long)
            zt = q_sample(sd.sched, z, t, noise.diffusion.to(z.dtype))
            row.append(decode(zt))
        out["diffusion_row"] = to_uint8(denoise_row_grid(row))

        if not sample:
            return out
        ctx_c = torch.cat([sd.get_learned_conditioning(p) for p in prompts])
        ctx_u = sd.get_learned_conditioning(uc_prompt).expand(
            n, -1, -1).contiguous()
        ddim = make_ddim_params_traced(sd.sched, ddim_steps)

        def model_fn(x, t, ctx, control=None):
            eps, _ = U.unet_apply(sd.unet_params, sd.unet_cfg,
                                  x.to(sd.dtype), t, ctx)
            return eps.to(x.dtype)

        panels = [("samples", noise.samples, 1.0)]
        if cfg_scale is not None:
            panels.append((f"samples_cfg_scale_{cfg_scale:.2f}",
                           noise.samples_cfg, float(cfg_scale)))
        for key, x_T, scale in panels:
            lat = D.ddim_sample(model_fn, sd.sched, ddim,
                                D.CondBundle(crossattn=ctx_c),
                                D.CondBundle(crossattn=ctx_u),
                                x_T=x_T.to(z.dtype), cfg_scale=scale,
                                parameterization=sd.parameterization)
            out[key] = to_uint8(make_grid(decode(lat), nrow=n_row))
    return out
