"""Diffusion beta schedule and DDIM sub-schedule.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/schedule.py``
(``make_linear_schedule``, ``q_sample``, the v-parameterization helpers
``get_v``, ``predict_eps_from_z_and_v``, ``predict_start_from_z_and_v``,
``DDIMParams``, ``make_ddim_params``, ``make_ddim_params_traced``), and
``rounded``, the samplers'
per-step scalar in the carry's dtype. The
arrays are host data: float32 tensors on the CPU, computed with numpy in
the JAX package's precision (f64 schedule, f32 storage), from which the
samplers read per-step scalars.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor                    # [T] f32
    alphas_cumprod: torch.Tensor           # [T]
    alphas_cumprod_prev: torch.Tensor      # [T]
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_linear_schedule(timesteps: int = 1000,
                         linear_start: float = 0.00085,
                         linear_end: float = 0.0120) -> DiffusionSchedule:
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
    )


def rounded(v, dtype) -> torch.Tensor:
    """A host scalar as a 0-dim CPU tensor rounded to ``dtype``: the JAX
    samplers cast each per-step scalar to the carry's dtype and compute
    with it there."""
    return torch.tensor(float(v), dtype=torch.float32).to(dtype)


def _coefs(sched: DiffusionSchedule, t, like):
    """(sqrt(alpha_bar_t), sqrt(1 - alpha_bar_t)) for t a host int (two
    floats) or [B] int (two [B, 1, 1, 1] tensors on ``like``'s device),
    rounded to ``like``'s dtype, as in the JAX package. A host int, or a
    [B] tensor on the CPU, keeps the lookup on the host: a [B] tensor on
    the card costs a device-to-host read, which waits for the queued
    work."""
    if isinstance(t, int):
        r = lambda a: a[t].to(like.dtype).item()
        return r(sched.sqrt_alphas_cumprod), \
            r(sched.sqrt_one_minus_alphas_cumprod)
    idx = torch.as_tensor(t).long().cpu()
    r = lambda a: a[idx].to(like.dtype).to(like.device).reshape(-1, 1, 1, 1)
    return r(sched.sqrt_alphas_cumprod), \
        r(sched.sqrt_one_minus_alphas_cumprod)


def q_sample(sched: DiffusionSchedule, x0, t, noise):
    """Forward noising q(x_t | x_0). t: one host int for the whole batch,
    or [B] int (see :func:`_coefs`)."""
    a, s = _coefs(sched, t, x0)
    return a * x0 + s * noise


def get_v(sched: DiffusionSchedule, x0, t, noise):
    """The v-parameterization target ``sqrt(a) * noise - sqrt(1 - a) *
    x0``."""
    a, s = _coefs(sched, t, x0)
    return a * noise - s * x0


def predict_eps_from_z_and_v(sched: DiffusionSchedule, x_t, t, v):
    """v-parameterization -> eps."""
    a, s = _coefs(sched, t, x_t)
    return a * v + s * x_t


def predict_start_from_z_and_v(sched: DiffusionSchedule, x_t, t, v):
    """v-parameterization -> x0."""
    a, s = _coefs(sched, t, x_t)
    return a * x_t - s * v


@dataclass(frozen=True)
class DDIMParams:
    timesteps: torch.Tensor      # [S] int32 ddpm timesteps (shifted by +1)
    alphas: torch.Tensor         # [S] alpha_cumprod at those timesteps
    alphas_prev: torch.Tensor    # [S]
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor         # [S] (0 for eta=0)

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_ddim_params(sched: DiffusionSchedule, num_steps: int,
                     eta: float = 0.0,
                     discretize: str = "uniform") -> DDIMParams:
    T = sched.num_timesteps
    if discretize == "uniform":
        c = T // num_steps
        ts = np.arange(0, T, c)
    elif discretize == "quad":
        ts = (np.linspace(0, np.sqrt(T * 0.8), num_steps) ** 2).astype(int)
    else:
        raise ValueError(f"unknown ddim discretization {discretize!r}")
    ts = ts + 1   # the reference's +1 shift

    ac = sched.alphas_cumprod.numpy()
    alphas = ac[ts]
    alphas_prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return DDIMParams(
        timesteps=torch.from_numpy(ts.astype(np.int32)),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)),
        sigmas=f32(sigmas),
    )


def make_ddim_params_traced(sched: DiffusionSchedule, num_steps: int,
                            eta: float = 0.0) -> DDIMParams:
    """Uniform DDIM params as the JAX facades build them
    (``make_ddim_params_traced``): exactly ``num_steps`` timesteps
    (:func:`make_ddim_params` keeps every multiple of T // num_steps, one
    more where that does not divide T, and fails where the last is T),
    gathered from the f32 schedule arrays, with every derived array
    (``sqrt_one_minus_alphas``, ``sigmas``) computed in f32."""
    T = sched.num_timesteps
    c = T // num_steps
    ts = np.arange(0, T, c, dtype=np.int32)[:num_steps] + np.int32(1)
    ac = sched.alphas_cumprod.numpy()
    alphas = ac[ts]
    alphas_prev = np.concatenate([ac[0:1], ac[ts[:-1]]])
    one = np.float32(1.0)
    sigmas = np.float32(eta) * np.sqrt((one - alphas_prev) / (one - alphas)
                                       * (one - alphas / alphas_prev))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return DDIMParams(
        timesteps=torch.from_numpy(ts),
        alphas=f32(alphas),
        alphas_prev=f32(alphas_prev),
        sqrt_one_minus_alphas=f32(np.sqrt(one - alphas)),
        sigmas=f32(sigmas),
    )
