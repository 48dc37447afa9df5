"""PLMS (pseudo linear multistep) sampler.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/plms.py``
(``plms_decode``): Adams-Bashforth multistep over the eps predictions,
eta = 0, CFG by batch doubling. Step 0 is a predictor-corrector (a
second evaluation at the next index); steps 1, 2 and 3+ blend orders 2,
3 and 4 of the past predictions. A run makes t_enc + 1 model calls.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ddim import CondBundle, cfg_model_call
from .sampling_util import norm_thresholding
from .schedule import (DDIMParams, DiffusionSchedule,
                       predict_eps_from_z_and_v, rounded)


def plms_decode(model_fn: Callable, sched: DiffusionSchedule,
                ddim: DDIMParams, x: torch.Tensor, cond: CondBundle,
                uncond: CondBundle, t_enc: int, *, cfg_scale: float = 7.0,
                parameterization: str = "eps",
                dynamic_threshold: Optional[float] = None):
    """Run t_enc PLMS steps from DDIM index t_enc - 1 down to 0 and return
    the final latent. ``dynamic_threshold`` rescales pred_x0 only (norm
    thresholding); the direction term keeps the raw eps. The per-step
    scalars are rounded to x's dtype, as in the JAX package."""
    if t_enc == 0:
        return x
    b, dt = x.shape[0], x.dtype

    def eps_at(x, index):
        t_i = int(ddim.timesteps[index])
        ts = torch.full((b,), t_i, dtype=torch.int32, device=x.device)
        out = cfg_model_call(model_fn, x, ts, cond, uncond, cfg_scale)
        if parameterization == "v":
            return predict_eps_from_z_and_v(sched, x, t_i, out)
        return out

    def x_prev_from(x, e_t, index):
        a_t = rounded(ddim.alphas[index], dt)
        a_prev = rounded(ddim.alphas_prev[index], dt)
        s1m = rounded(ddim.sqrt_one_minus_alphas[index], dt).item()
        pred_x0 = (x - s1m * e_t) / torch.sqrt(a_t).item()
        if dynamic_threshold is not None:
            pred_x0 = norm_thresholding(pred_x0, dynamic_threshold)
        dir_xt = torch.sqrt(1.0 - a_prev).item() * e_t
        return torch.sqrt(a_prev).item() * pred_x0 + dir_xt

    old: list = []          # past eps, most recent first (at most 3 read)
    for i in range(t_enc):
        index = t_enc - 1 - i
        e_t = eps_at(x, index)
        if i == 0:
            # predictor-corrector: a second evaluation at the next index
            e_next = eps_at(x_prev_from(x, e_t, index), max(index - 1, 0))
            e_use = (e_t + e_next) / 2
        elif i == 1:
            e_use = (3 * e_t - old[0]) / 2
        elif i == 2:
            e_use = (23 * e_t - 16 * old[0] + 5 * old[1]) / 12
        else:
            e_use = (55 * e_t - 59 * old[0] + 37 * old[1]
                     - 9 * old[2]) / 24
        x = x_prev_from(x, e_use, index)
        old = [e_t] + old[:2]
    return x
