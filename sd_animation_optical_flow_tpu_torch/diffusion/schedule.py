"""Diffusion beta schedule and DDIM sub-schedule.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/schedule.py``
(``make_linear_schedule``, ``q_sample``, ``DDIMParams``,
``make_ddim_params``). The
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


def q_sample(sched: DiffusionSchedule, x0, t, noise):
    """Forward noising q(x_t | x_0). t: one host int for the whole batch,
    or [B] int; the per-row scalars round to x0's dtype, as in the JAX
    package. A host int keeps the schedule lookup on the host: a [B]
    tensor on the card costs a device-to-host read, which waits for the
    queued work."""
    if isinstance(t, int):
        r = lambda a: a[t].to(x0.dtype).item()
        return (r(sched.sqrt_alphas_cumprod) * x0
                + r(sched.sqrt_one_minus_alphas_cumprod) * noise)
    idx = torch.as_tensor(t).long().cpu()
    a = sched.sqrt_alphas_cumprod[idx].to(x0.dtype).to(x0.device)
    s = sched.sqrt_one_minus_alphas_cumprod[idx].to(x0.dtype).to(x0.device)
    return a.reshape(-1, 1, 1, 1) * x0 + s.reshape(-1, 1, 1, 1) * noise


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
