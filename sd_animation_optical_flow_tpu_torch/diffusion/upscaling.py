"""Low-res conditioning for latent upscaling diffusion.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/upscaling.py``
(``LowScaleConfig``, ``make_low_scale_schedule``, ``simple_image_concat``,
``noise_augment``, ``upscale_conditioning``): the low-res image is
optionally noise-augmented with its own linear beta schedule and
concatenated to the latent, and the noise level is fed to the UNet as
its class label. The level and the noise are arguments, or drawn from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .schedule import DiffusionSchedule, make_linear_schedule, q_sample


@dataclass(frozen=True)
class LowScaleConfig:
    """The low-scale schedule: linear 1e-4 -> 2e-2 over 1000 steps."""
    timesteps: int = 1000
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    max_noise_level: int = 1000


def make_low_scale_schedule(cfg: LowScaleConfig = LowScaleConfig()
                            ) -> DiffusionSchedule:
    return make_linear_schedule(cfg.timesteps, cfg.linear_start,
                                cfg.linear_end)


def simple_image_concat(x_low):
    """No noise augmentation: (x_low, level 0 [B] int32)."""
    return x_low, torch.zeros((x_low.shape[0],), dtype=torch.int32,
                              device=x_low.device)


def noise_augment(sched: DiffusionSchedule, x_low,
                  noise: Optional[torch.Tensor] = None, noise_level=None, *,
                  generator: Optional[torch.Generator] = None,
                  max_noise_level: int = 1000):
    """q-sample the low-res image to a per-sample noise level: the given
    ``noise_level`` ([B] int), or one drawn uniformly in [0,
    max_noise_level) from ``generator``. ``noise`` (shaped as x_low) is
    given or drawn from ``generator`` after the level. Returns (z, level
    [B] int32 on x_low's device)."""
    b = x_low.shape[0]
    if noise_level is None:
        if generator is None:
            raise ValueError("noise_augment draws the level: pass "
                             "noise_level or a generator")
        noise_level = torch.randint(0, max_noise_level, (b,),
                                    generator=generator,
                                    device=generator.device)
    lvl = torch.as_tensor(noise_level).to(x_low.device, torch.int32)
    if noise is None:
        if generator is None:
            raise ValueError("noise_augment draws the noise: pass noise or "
                             "a generator")
        noise = torch.randn(tuple(x_low.shape), generator=generator,
                            device=generator.device)
    return q_sample(sched, x_low, lvl, noise.to(x_low.device, x_low.dtype)), \
        lvl


def upscale_conditioning(sched: DiffusionSchedule, x_low,
                         noise: Optional[torch.Tensor] = None,
                         noise_level=None, *,
                         generator: Optional[torch.Generator] = None,
                         max_noise_level: int = 1000, augment: bool = True):
    """The upscaler's conditioning pieces (c_concat, c_adm): the
    (noise-augmented) low-res image and its noise level."""
    if augment:
        return noise_augment(sched, x_low, noise, noise_level,
                             generator=generator,
                             max_noise_level=max_noise_level)
    return simple_image_concat(x_low)
