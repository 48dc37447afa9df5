"""Diffusion training loss.

Counterpart of ``sd_animation_optical_flow_tpu/training/losses.py``: the
simple diffusion objective (noise x0 at a timestep t, predict, MSE) with
the eps / v / x0 parameterizations, channel-concat conditioning and
class labels.
The JAX ``p_losses`` draws t and the noise from its rng key; here both
are inputs, so a test can feed both frameworks the same arrays, and
:func:`p_losses_sampled` draws them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..diffusion.schedule import DiffusionSchedule, get_v, q_sample
from ..models import unet as U


def sample_t_noise(sched: DiffusionSchedule, x0, generator: torch.Generator):
    """t ~ U[0, T) [B] int64 and noise ~ N(0, 1) shaped as x0, from
    ``generator`` on its device (noise in x0's dtype, on x0's device)."""
    dev = generator.device
    t = torch.randint(0, sched.num_timesteps, (x0.shape[0],),
                      generator=generator, device=dev)
    noise = torch.randn(x0.shape, generator=generator, device=dev)
    return t, noise.to(x0.device, x0.dtype)


def p_losses(unet_params, unet_cfg: U.UNetConfig, sched: DiffusionSchedule,
             x0, context, t, noise, *, parameterization: str = "eps",
             c_concat=None, y=None, tp=None):
    """Mean squared error of the UNet's prediction at ``x_t =
    q_sample(x0, t, noise)`` against the ``parameterization`` target:
    ``noise`` (eps), ``get_v(x0, t, noise)`` (v) or ``x0``.

    x0 [B, h, w, 4] latents, whose dtype the activations take (the
    params are cast to it, as in the JAX layers); context [B, L, C];
    t [B] int (kept on the host for the schedule lookups); noise shaped
    as x0. ``c_concat``: channel-concat conditioning appended clean to
    the noised latent (the inpainting UNet's mask and masked-image
    latent, the depth model's depth, the upscaler's low-res image).
    ``y``: [B] int class / adm labels of a class-conditional UNet (the
    upscaler's noise level). ``tp``: a ``TensorParallelConfig``, with
    ``unet_params`` this rank's local tree (``models/unet.py``). The mean
    is taken in f32 (the JAX mean of a bf16 array returns bf16)."""
    if parameterization not in ("eps", "v", "x0"):
        raise ValueError(parameterization)
    t = torch.as_tensor(t).long().cpu()
    noise = noise.to(x0.dtype)
    x_noisy = q_sample(sched, x0, t, noise)
    if c_concat is not None:
        x_noisy = torch.cat([x_noisy, c_concat.to(x_noisy.dtype)], dim=-1)
    pred, _ = U.unet_apply(unet_params, unet_cfg, x_noisy, t.to(x0.device),
                           context, y=y, tp=tp)
    target = {"eps": lambda: noise, "x0": lambda: x0,
              "v": lambda: get_v(sched, x0, t, noise)}[parameterization]()
    return (pred.float() - target.float()).pow(2).mean()


def p_losses_sampled(unet_params, unet_cfg: U.UNetConfig,
                     sched: DiffusionSchedule, x0, context,
                     generator: torch.Generator, **kw):
    """:func:`p_losses` with t and the noise drawn from ``generator``."""
    t, noise = sample_t_noise(sched, x0, generator)
    return p_losses(unet_params, unet_cfg, sched, x0, context, t, noise, **kw)
