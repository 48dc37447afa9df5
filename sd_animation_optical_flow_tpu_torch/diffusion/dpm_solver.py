"""DPM-Solver++(2M): the standalone sampler and its timestep spacing.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/dpm_solver.py``
(``dpmpp_2m_decode``, ``uniform_timesteps_desc``): the data-prediction
multistep variant, second order in the log-SNR domain, deterministic
but for the inpaint re-noise, with the same CFG and masked re-noising
hooks as :func:`..diffusion.ddim.ddim_decode`. The steps are the
multistep engine's (``multistep.make_dpmpp_coeffs``), which the facades
run too.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .ddim import CondBundle
from .multistep import make_dpmpp_coeffs, multistep_decode
from .schedule import DiffusionSchedule


def dpmpp_2m_decode(
    model_fn: Callable,
    sched: DiffusionSchedule,
    timesteps,
    x: torch.Tensor,
    cond: CondBundle,
    uncond: CondBundle,
    *,
    cfg_scale: float = 7.0,
    parameterization: str = "eps",
    init_latent: Optional[torch.Tensor] = None,
    nmask: Optional[torch.Tensor] = None,
    renoise_gate=None,
    renoise_noise: Optional[torch.Tensor] = None,
):
    """Run S = len(timesteps) - 1 second-order steps from x at noise level
    ``timesteps[0]`` (descending ddpm timesteps, host ints) and return
    the last step's x0 prediction (the final x still carries
    sigma[last]).

    The steps are :func:`..diffusion.multistep.make_dpmpp_coeffs` run by
    :func:`..diffusion.multistep.multistep_decode`: CFG by batch doubling
    (no stem dedup), eps or v parameterization, the 2M combination
    ``(1 + 1/2r) x0 - (1/2r) x0_prev`` formed in f32 and cast back to
    x's dtype, skipped on the first step and where |r| <= 1e-5.

    Inpaint re-noise (``init_latent`` with ``nmask``): before step i,
    where ``renoise_gate[i] > 0`` (host floats, default all on), the
    known region is re-imposed as ``(1 - nm) * q_sample(init_latent,
    t_i, renoise_noise[i]) + nm * x``; ``renoise_noise`` [S, 1 or B, ...]
    is the per-step noise, never drawn here."""
    ts = np.asarray(timesteps).astype(np.int64)
    n_steps = len(ts) - 1
    if n_steps <= 0:
        return x
    if init_latent is not None and nmask is not None:
        if renoise_noise is None:
            raise ValueError("the inpaint re-noise needs renoise_noise")
        if renoise_gate is None:
            renoise_gate = [1.0] * n_steps
    return multistep_decode(
        model_fn, make_dpmpp_coeffs(sched, ts), x, cond, uncond,
        cfg_scale=cfg_scale, parameterization=parameterization, sched=sched,
        init_latent=init_latent, nmask=nmask, renoise_gate=renoise_gate,
        renoise_noise=renoise_noise)


def uniform_timesteps_desc(sched: DiffusionSchedule, t_start: int,
                           num_steps: int) -> np.ndarray:
    """[num_steps+1] descending ddpm timesteps (int32) from t_start down
    to ~1, matching the img2img t_enc entry point. Spaced in float32 and
    rounded half-to-even, as ``jnp.linspace`` + ``jnp.round`` do."""
    del sched   # kept for the JAX signature; the spacing needs no schedule
    ts = np.linspace(np.float32(t_start), np.float32(1), num_steps + 1,
                     dtype=np.float32)
    return np.round(ts).astype(np.int32)
