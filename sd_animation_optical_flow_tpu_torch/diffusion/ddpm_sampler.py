"""DDPM ancestral sampling.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/ddpm_sampler.py``
(``PosteriorCoefs``, ``posterior_coefs``, ``q_mean_variance``,
``predict_start_from_noise``, ``q_posterior``, ``p_mean_variance``,
``p_sample``, ``p_sample_loop``). The posterior coefficients are derived
from the schedule in f32, as the JAX package does:

  posterior_variance   = beta_t (1 - acp_{t-1}) / (1 - acp_t)
  posterior_mean_coef1 = beta_t sqrt(acp_{t-1}) / (1 - acp_t)
  posterior_mean_coef2 = (1 - acp_{t-1}) sqrt(alpha_t) / (1 - acp_t)

They stay f32 where they meet the latent, so a bf16 latent's moments
come out f32, as JAX promotes them. Every noise is an argument or drawn
from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .ddim import CondBundle, cfg_model_call
from .schedule import DiffusionSchedule, predict_start_from_z_and_v


class PosteriorCoefs(NamedTuple):
    variance: torch.Tensor                 # [T] f32 (host)
    log_variance_clipped: torch.Tensor     # [T]
    mean_coef1: torch.Tensor               # [T]
    mean_coef2: torch.Tensor               # [T]
    sqrt_recip_acp: torch.Tensor           # [T]
    sqrt_recipm1_acp: torch.Tensor         # [T]


def posterior_coefs(sched: DiffusionSchedule,
                    v_posterior: float = 0.0) -> PosteriorCoefs:
    """The posterior buffers in f32 (``v_posterior`` mixes in beta_t)."""
    betas = sched.betas.numpy()
    acp = sched.alphas_cumprod.numpy()
    acp_prev = sched.alphas_cumprod_prev.numpy()
    one, v = np.float32(1.0), np.float32(v_posterior)
    alphas = one - betas
    var = (one - v) * betas * (one - acp_prev) / (one - acp) + v * betas
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return PosteriorCoefs(
        variance=t(var),
        log_variance_clipped=t(np.log(np.maximum(var, np.float32(1e-20)))),
        mean_coef1=t(betas * np.sqrt(acp_prev) / (one - acp)),
        mean_coef2=t((one - acp_prev) * np.sqrt(alphas) / (one - acp)),
        sqrt_recip_acp=t(np.sqrt(one / acp)),
        sqrt_recipm1_acp=t(np.sqrt(one / acp - one)),
    )


def _gather(a, t, like):
    """a[t] as [B, 1, ..., 1] f32 on ``like``'s device (t: [B] int). The
    lookup is made where t lies: a t on the card gathers from a copy of
    the [T] table sent there, so no step waits on a device-to-host
    read."""
    idx = torch.as_tensor(t).long()
    if idx.device != a.device:
        a = a.to(idx.device)
    return a[idx].to(like.device).reshape((idx.shape[0],)
                                          + (1,) * (like.dim() - 1))


def q_mean_variance(sched: DiffusionSchedule, x0, t):
    """q(x_t | x_0) moments (mean, variance, log variance)."""
    mean = _gather(sched.sqrt_alphas_cumprod, t, x0) * x0
    var = _gather(1.0 - sched.alphas_cumprod, t, x0)
    return mean, var, torch.log(var)


def predict_start_from_noise(pc: PosteriorCoefs, x_t, t, noise):
    """x0-hat from eps."""
    return (_gather(pc.sqrt_recip_acp, t, x_t) * x_t
            - _gather(pc.sqrt_recipm1_acp, t, x_t) * noise)


def q_posterior(pc: PosteriorCoefs, x0, x_t, t):
    """q(x_{t-1} | x_t, x_0) moments (mean, variance, clipped log
    variance)."""
    mean = (_gather(pc.mean_coef1, t, x0) * x0
            + _gather(pc.mean_coef2, t, x0) * x_t)
    return mean, _gather(pc.variance, t, x0), \
        _gather(pc.log_variance_clipped, t, x0)


def p_mean_variance(model_fn: Callable, sched: DiffusionSchedule,
                    pc: PosteriorCoefs, x, t, cond: CondBundle,
                    uncond: Optional[CondBundle] = None, *,
                    cfg_scale: float = 1.0, parameterization: str = "eps",
                    clip_denoised: bool = True):
    """Model -> x0-hat (eps, v or x0 parameterization; clipped to [-1, 1]
    with ``clip_denoised``) -> the posterior moments. CFG by batch
    doubling when ``cfg_scale`` != 1 and ``uncond`` is given, else one
    call with ``cond``'s concat channels appended."""
    if parameterization not in ("eps", "v", "x0"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    if cfg_scale != 1.0 and uncond is not None:
        out = cfg_model_call(model_fn, x, t, cond, uncond, cfg_scale)
    else:
        x_in = x if cond.concat is None else \
            torch.cat([x, cond.concat.to(x.dtype)], dim=-1)
        out = model_fn(x_in, t, cond.crossattn, None)
    if parameterization == "v":
        x0 = predict_start_from_z_and_v(sched, x, t, out)
    elif parameterization == "x0":
        x0 = out
    else:
        x0 = predict_start_from_noise(pc, x, t, out)
    if clip_denoised:
        x0 = torch.clamp(x0, -1.0, 1.0)
    return q_posterior(pc, x0, x, t)


def p_sample(model_fn: Callable, sched: DiffusionSchedule,
             pc: PosteriorCoefs, x, t, cond: CondBundle,
             uncond: Optional[CondBundle] = None, *, noise,
             cfg_scale: float = 1.0, parameterization: str = "eps",
             clip_denoised: bool = True, temperature: float = 1.0):
    """One ancestral step: mean + std * ``noise`` * temperature, the noise
    (shaped as x, or broadcast to it) zeroed where t == 0. t: [B] int."""
    mean, _var, log_var = p_mean_variance(
        model_fn, sched, pc, x, t, cond, uncond, cfg_scale=cfg_scale,
        parameterization=parameterization, clip_denoised=clip_denoised)
    noise = noise.to(x.device, x.dtype) * temperature
    nonzero = (torch.as_tensor(t, device=x.device) > 0).to(x.dtype).reshape(
        (x.shape[0],) + (1,) * (x.dim() - 1))
    return mean + nonzero * torch.exp(0.5 * log_var) * noise


def intermediate_indices(num_timesteps: int, n: int) -> np.ndarray:
    """The steps whose x ``p_sample_loop`` returns for ``n``
    intermediates: linspace(0, T - 1, n) in float32, truncated to int32,
    as the JAX loop picks them (in f32, so no index moves across an
    integer)."""
    return np.linspace(np.float32(0), np.float32(num_timesteps - 1), n,
                       dtype=np.float32).astype(np.int32)


def p_sample_loop(model_fn: Callable, sched: DiffusionSchedule,
                  cond: CondBundle, uncond: Optional[CondBundle] = None, *,
                  shape=None, x_T: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  cfg_scale: float = 1.0, parameterization: str = "eps",
                  clip_denoised: bool = True, temperature: float = 1.0,
                  v_posterior: float = 0.0, return_intermediates: int = 0):
    """The full T-step ancestral chain from t = T - 1 down to 0.

    ``x_T`` is given, or drawn in f32 with ``shape`` from ``generator``.
    Step i's noise is ``noise[i]`` ([T, ...]) when the stack is given,
    else drawn from ``generator`` (in x's shape, f32) at that step.
    ``return_intermediates`` > 0 also returns that many evenly spaced
    snapshots of x after a step (:func:`intermediate_indices`, oldest
    first), stacked [n, ...]."""
    if noise is None and generator is None:
        raise ValueError("p_sample_loop needs a noise stack or a generator")
    pc = posterior_coefs(sched, v_posterior)
    if x_T is None:
        if shape is None or generator is None:
            raise ValueError("p_sample_loop needs x_T, or shape and "
                             "generator")
        x_T = torch.randn(tuple(shape), generator=generator,
                          device=generator.device)
    T = sched.num_timesteps
    keep = intermediate_indices(T, return_intermediates) \
        if return_intermediates else np.zeros((0,), np.int32)
    kept = {}
    x = x_T
    for i, t_i in enumerate(range(T - 1, -1, -1)):
        t = torch.full((x.shape[0],), t_i, dtype=torch.int32,
                       device=x.device)
        n_i = noise[i] if noise is not None else torch.randn(
            tuple(x.shape), generator=generator, device=generator.device)
        x = p_sample(model_fn, sched, pc, x, t, cond, uncond, noise=n_i,
                     cfg_scale=cfg_scale, parameterization=parameterization,
                     clip_denoised=clip_denoised, temperature=temperature)
        if i in keep:
            kept[i] = x
    if return_intermediates:
        return x, torch.stack([kept[int(k)] for k in keep])
    return x
