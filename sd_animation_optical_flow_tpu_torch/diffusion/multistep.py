"""Unified multistep sampler engine: DDIM (eta=0) and DPM-Solver++(2M)
as one affine update fed different per-step coefficients.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/multistep.py``
(``MultistepCoeffs``, ``make_ddim_coeffs``, ``make_dpmpp_coeffs``,
``multistep_decode``). Each step is

    x0     = (x - s1m_i * eps_theta(x, t_i)) / sa_i
    d      = (1 + w_i) * x0 - w_i * x0_prev
    x_next = c_x_i * x + c_0_i * d

with host-side scalars. The JAX engine scans over padded slots under one
compiled program; here the engine is a Python loop over the active slots
(PyTorch runs eagerly, so padding buys nothing), and padded slots are
skipped as identity steps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .ddim import CondBundle, cfg_model_call
from .schedule import (DDIMParams, DiffusionSchedule,
                       predict_eps_from_z_and_v, q_sample, rounded)


class MultistepCoeffs(NamedTuple):
    """Per-slot sampler scalars ([S] numpy arrays, host data). Slots with
    ``active == False`` are identity steps."""
    timesteps: np.ndarray   # [S] int32 ddpm timestep fed to the model
    sa: np.ndarray          # [S] f32 sqrt(alpha_cumprod) at the slot
    s1m: np.ndarray         # [S] f32 sqrt(1 - alpha_cumprod)
    c_x: np.ndarray         # [S] f32 weight of x in the update
    c_0: np.ndarray         # [S] f32 weight of d in the update
    w: np.ndarray           # [S] f32 previous-x0 mix weight
    active: np.ndarray      # [S] bool
    out_x: float            # f32 weight of final x in the output
    out_x0: float           # f32 weight of last x0 in the output

    @property
    def num_slots(self) -> int:
        return int(self.timesteps.shape[0])


def _pad(arrs, n_active, pad_to):
    """Append identity slots (ts 0, sa 1, s1m 0, c_x 1, c_0 0, w 0)."""
    if pad_to is None or pad_to == n_active:
        return arrs + (np.ones((n_active,), bool),)
    if pad_to < n_active:
        raise ValueError(f"pad_to={pad_to} < {n_active} active slots")
    k = pad_to - n_active
    ts, sa, s1m, c_x, c_0, w = arrs
    pad1 = lambda a, v: np.concatenate([a, np.full((k,), v, a.dtype)])
    return (pad1(ts, 0), pad1(sa, 1.0), pad1(s1m, 0.0), pad1(c_x, 1.0),
            pad1(c_0, 0.0), pad1(w, 0.0),
            np.concatenate([np.ones((n_active,), bool),
                            np.zeros((k,), bool)]))


def make_ddim_coeffs(ddim: DDIMParams, t_enc: int,
                     pad_to: Optional[int] = None) -> MultistepCoeffs:
    """Exact eta=0 DDIM decode (indices t_enc-1 .. 0) as engine
    coefficients: c_x = sqrt((1-a_prev)/(1-a_t)),
    c_0 = sqrt(a_prev) - c_x*sqrt(a_t)."""
    idx = np.arange(t_enc - 1, -1, -1)
    ts = ddim.timesteps.numpy()[idx].astype(np.int32)
    a_t = ddim.alphas.numpy().astype(np.float64)[idx]
    a_prev = ddim.alphas_prev.numpy().astype(np.float64)[idx]
    sa = np.sqrt(a_t)
    s1m = ddim.sqrt_one_minus_alphas.numpy().astype(np.float64)[idx]
    c_x = np.sqrt(1.0 - a_prev) / s1m
    c_0 = np.sqrt(a_prev) - c_x * sa
    w = np.zeros((t_enc,))
    arrs = _pad((ts, sa.astype(np.float32), s1m.astype(np.float32),
                 c_x.astype(np.float32), c_0.astype(np.float32),
                 w.astype(np.float32)), t_enc, pad_to)
    return MultistepCoeffs(*arrs, out_x=1.0, out_x0=0.0)


def make_dpmpp_coeffs(sched: DiffusionSchedule, timesteps,
                      pad_to: Optional[int] = None) -> MultistepCoeffs:
    """DPM-Solver++(2M) (data prediction, second order in log-SNR) as
    engine coefficients. ``timesteps``: [S+1] descending ddpm timesteps
    (x enters at timesteps[0]); S steps. Output is the last x0."""
    ts_all = np.asarray(timesteps).astype(np.int64)
    n = len(ts_all) - 1
    ac = sched.alphas_cumprod.numpy().astype(np.float64)[ts_all]
    alpha = np.sqrt(ac)
    sigma = np.sqrt(1.0 - ac)
    lam = np.log(alpha) - np.log(sigma)
    h = lam[1:] - lam[:-1]
    h_prev = np.concatenate([[0.0], h[:-1]])
    r = h_prev / np.where(h == 0, 1.0, h)
    w = np.where((np.arange(n) >= 1) & (np.abs(r) > 1e-5),
                 1.0 / (2.0 * np.where(r == 0, 1.0, r)), 0.0)
    c_x = sigma[1:] / sigma[:-1]
    c_0 = -alpha[1:] * np.expm1(-h)
    arrs = _pad((ts_all[:n].astype(np.int32), alpha[:n].astype(np.float32),
                 sigma[:n].astype(np.float32), c_x.astype(np.float32),
                 c_0.astype(np.float32), w.astype(np.float32)), n, pad_to)
    return MultistepCoeffs(*arrs, out_x=0.0, out_x0=1.0)


def _scalar(v, dtype) -> float:
    """A host scalar rounded to ``dtype``, as a float."""
    return rounded(v, dtype).item()


def multistep_decode(
    model_fn: Callable,
    coeffs: MultistepCoeffs,
    x: torch.Tensor,
    cond: CondBundle,
    uncond: CondBundle,
    *,
    cfg_scale: float = 7.0,
    cfg_dedup: bool = False,
    parameterization: str = "eps",
    sched: Optional[DiffusionSchedule] = None,
    init_latent: Optional[torch.Tensor] = None,
    nmask: Optional[torch.Tensor] = None,
    renoise_gate=None,
    renoise_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the coefficient schedule over x (deterministic). The model
    predicts eps, or v with ``parameterization="v"`` (the guided v is
    turned into eps at the slot's timestep, which needs ``sched``). The
    prev-x0 mix is combined in f32 and cast back, so a bf16 carry stays
    bf16.

    Inpainting re-noise (``init_latent`` with ``nmask``, the hook of the
    JAX ``ddim_decode`` / ``dpmpp_2m_decode``): before slot i's model
    call, where ``renoise_gate[i] > 0`` (host floats; the last entry
    serves slots past its end, as a JAX gather clamps), the known region
    is re-imposed as ``x = (1 - nm) * q_sample(init_latent, t_i,
    renoise_noise[i]) + nm * x``. ``renoise_noise`` [S, 1 or B, h, w, c] is the per-slot noise (a
    batch of 1 broadcasts over the batch); it is never drawn here."""
    if parameterization not in ("eps", "v"):
        raise ValueError("multistep_decode handles eps- or v-prediction "
                         f"models, got parameterization={parameterization!r}")
    if parameterization == "v" and sched is None:
        raise ValueError("v-prediction needs sched")
    inpaint = init_latent is not None and nmask is not None
    if inpaint and (sched is None or renoise_gate is None
                    or renoise_noise is None):
        raise ValueError("inpainting re-noise needs sched, renoise_gate and "
                         "renoise_noise")
    b = x.shape[0]
    dt = x.dtype
    x0 = torch.zeros_like(x)
    for i in range(coeffs.num_slots):
        if not coeffs.active[i]:
            continue
        t_i = int(coeffs.timesteps[i])
        ts = torch.full((b,), t_i, dtype=torch.int32, device=x.device)
        if inpaint and float(renoise_gate[min(i, len(renoise_gate) - 1)]) > 0:
            noised = q_sample(sched, init_latent, t_i,
                              renoise_noise[i].to(x.device, dt))
            nm = nmask.to(dt)
            x = (1.0 - nm) * noised + nm * x
        e = cfg_model_call(model_fn, x, ts, cond, uncond, cfg_scale,
                           dedup=cfg_dedup)
        if parameterization == "v":
            e = predict_eps_from_z_and_v(sched, x, t_i, e)
        x0_prev = x0
        x0 = (x - _scalar(coeffs.s1m[i], dt) * e) / _scalar(coeffs.sa[i], dt)
        w = coeffs.w[i]
        d = (float(np.float32(1.0) + w) * x0.float()
             - float(w) * x0_prev.float()).to(dt)
        x = _scalar(coeffs.c_x[i], dt) * x + _scalar(coeffs.c_0[i], dt) * d
    return _scalar(coeffs.out_x, dt) * x + _scalar(coeffs.out_x0, dt) * x0
