"""Classifier-free guidance, the DDIM forward noising, the
hook-carrying DDIM decode, full-chain sampling and inversion.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/ddim.py``
(``CondBundle``, ``cfg_model_call``, ``guidance_progress``,
``stochastic_encode``, ``ddim_decode``, ``ddim_sample``,
``ddim_encode``). A DDIM decode with no hook runs through the multistep
engine (:mod:`.multistep`); :func:`ddim_decode` carries the hooks:
guidance blending, ControlNet residuals, CFG caching, DeepCache and the
sampler options of the reference's DDIM sampler. :func:`ddim_sample`
walks the whole chain from noise through it; :func:`ddim_encode` runs
the deterministic inversion up the chain.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.controlnet import mix_controls
from .sampling_util import norm_thresholding
from .schedule import (DDIMParams, DiffusionSchedule,
                       predict_eps_from_z_and_v, q_sample, rounded)


class CondBundle(NamedTuple):
    """Conditioning for one CFG pass. ``concat`` is the channel-concat
    conditioning of the inpaint models; None means pure cross-attention
    conditioning."""
    crossattn: torch.Tensor                 # [B, L, D]
    concat: Optional[torch.Tensor] = None   # [B, h, w, Cc] or None


def _cfg_batch(x, t, cond: CondBundle, uncond: CondBundle):
    """The doubled [uncond | cond] batch: (x with the concat channels, t,
    context)."""
    x_in = torch.cat([x, x], dim=0)
    if cond.concat is not None:
        cc = torch.cat([uncond.concat, cond.concat], dim=0)
        x_in = torch.cat([x_in, cc.to(x.dtype)], dim=-1)
    return (x_in, torch.cat([t, t], dim=0),
            torch.cat([uncond.crossattn, cond.crossattn], dim=0))


def cfg_model_call(model_fn: Callable, x, t, cond: CondBundle,
                   uncond: CondBundle, scale: float, control=None,
                   dedup: bool = False):
    """Classifier-free guidance with batch doubling ([uncond|cond]).

    ``dedup``: CFG stem dedup — pass the model the HALF-batch latent and
    the (ctx_u, ctx_c) pair; the UNet runs its stem once and doubles the
    batch at the first cross-attention (models.unet ``context_pair``).
    Needs identical (or absent) concat conditioning across the halves,
    else plain doubling."""
    if dedup and (cond.concat is uncond.concat or cond.concat is None):
        x_in = x
        if cond.concat is not None:
            x_in = torch.cat([x, cond.concat.to(x.dtype)], dim=-1)
        out = model_fn(x_in, t, (uncond.crossattn, cond.crossattn), control)
        out_u, out_c = out.chunk(2, dim=0)
        return out_u + scale * (out_c - out_u)
    out = model_fn(*_cfg_batch(x, t, cond, uncond), control)
    out_u, out_c = out.chunk(2, dim=0)
    return out_u + scale * (out_c - out_u)


def guidance_progress(t_enc: int, total_steps: int):
    """Per-step denoise progress p handed to guidance and re-noise gate
    schedules: p_i = (i + (S - t_enc) + 1) / S (numpy [t_enc])."""
    i = np.arange(t_enc)
    return (i + (total_steps - t_enc) + 1) / total_steps


def stochastic_encode(ddim: DDIMParams, x0, t_enc: int, noise):
    """Noise x0 to DDIM step t_enc (alphas gathered at index t_enc, one
    past the first decode index, as the reference indexes them). The
    scalars round to x0's dtype first, as in the JAX package."""
    a = torch.sqrt(ddim.alphas[t_enc]).to(x0.dtype).item()
    s = ddim.sqrt_one_minus_alphas[t_enc].to(x0.dtype).item()
    return a * x0 + s * noise.to(x0.dtype)


def ddim_decode(
    model_fn: Callable,
    sched: DiffusionSchedule,
    ddim: DDIMParams,
    x_latent: torch.Tensor,
    cond: CondBundle,
    uncond: CondBundle,
    t_enc: int,
    *,
    cfg_scale: float = 7.0,
    parameterization: str = "eps",
    guidance_latent: Optional[torch.Tensor] = None,
    guidance_strength: Optional[torch.Tensor] = None,
    guidance_space: str = "latent",
    pixel_fns=None,
    guidance_noise: Optional[torch.Tensor] = None,
    guidance_encode_noise: Optional[torch.Tensor] = None,
    init_latent: Optional[torch.Tensor] = None,
    nmask: Optional[torch.Tensor] = None,
    renoise_gate=None,
    renoise_noise: Optional[torch.Tensor] = None,
    control_residuals=None,
    control_weights=None,
    sigma_noise: Optional[torch.Tensor] = None,
    dropout_keep: Optional[torch.Tensor] = None,
    dynamic_threshold: Optional[float] = None,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    cfg_schedule=None,
    score_fn: Optional[Callable] = None,
    quantize_fn: Optional[Callable] = None,
    cfg_interval: int = 1,
    deepcache_interval: int = 0,
    deepcache_fns=None,
    cfg_dedup: bool = False,
):
    """Run t_enc guided DDIM steps from x_latent (DDIM indices t_enc-1 ..
    0) and return the final latent. ``model_fn(x, t, ctx, control)``
    predicts eps (or v with ``parameterization="v"``); ``ctx`` is a
    (ctx_u, ctx_c) pair under ``cfg_dedup``.

    Every stochastic term is an argument, a stack over the steps whose
    batch is 1 (broadcast over the batch: the JAX ``tile_noise``) or B;
    none is drawn here.

    * Inpaint re-noise (``init_latent`` with ``nmask``): before step i,
      where ``renoise_gate[i] > 0`` (host floats, default all on), the
      known region is re-imposed as ``(1 - nm) * q_sample(init_latent,
      t_i, renoise_noise[i]) + nm * x``.
    * Guidance (``guidance_latent`` with ``guidance_strength`` [t_enc,
      ...] broadcast to the latent): in ``"latent"`` space pred_x0 is
      lerped toward the guidance latent. In ``"pixel"`` space (the
      reference's noised blending) the guidance latent is noised to the
      next index with ``guidance_noise[i]``, its x0 predicted by the same
      CFG model, both x0s decoded, blended in pixel space (a latent-size
      strength map is repeated up to the image), clipped and re-encoded
      with the posterior noise ``guidance_encode_noise[i]``; ``pixel_fns``
      = (vae_encode(x, noise), vae_decode(z)). Either way e_t is rederived
      from the blended x0.
    * ControlNet: ``control_residuals`` (a list over nets of 13-tuples on
      the CFG batch) mixed each step with ``control_weights[i]`` [n_nets].
    * ``cfg_interval`` > 1: CFG caching. Every k-th step runs the full CFG
      batch and caches cond - uncond; the steps between run the cond half
      alone (its half of the control residuals) and reuse the cached
      difference: e = e_c + (s - 1) * diff.
    * ``deepcache_interval`` > 0: every k-th step runs
      ``deepcache_fns[0](x, t, ctx) -> (out, deep)`` on the doubled
      batch, the steps between ``deepcache_fns[1](x, t, ctx, deep)``.
      Does not compose with ``cfg_interval``.
    * ``cfg_dedup``: the stem dedup of :func:`cfg_model_call`.
    * Sampler options: ``cfg_schedule`` (per-step CFG scale, overrides
      ``cfg_scale``), ``score_fn(e_t, x, ts, i)``, ``quantize_fn(pred_x0)``,
      ``dynamic_threshold`` (norm thresholding of pred_x0 only),
      ``sigma_noise`` [t_enc, ...] (needed where a step's sigma is not 0)
      scaled by ``temperature``, and ``noise_dropout`` with its keep masks
      ``dropout_keep`` [t_enc, ...] (bool)."""
    if t_enc == 0:
        return x_latent
    x = x_latent
    b, dt = x.shape[0], x.dtype
    use_guidance = guidance_latent is not None and guidance_strength is not None
    use_inpaint = init_latent is not None and nmask is not None
    pixel = use_guidance and guidance_space == "pixel"
    if use_guidance and guidance_space not in ("latent", "pixel"):
        raise ValueError(f"unknown guidance_space {guidance_space!r}")
    if pixel and (pixel_fns is None or guidance_noise is None
                  or guidance_encode_noise is None):
        raise ValueError("pixel guidance needs pixel_fns, guidance_noise and "
                         "guidance_encode_noise")
    if use_inpaint and renoise_noise is None:
        raise ValueError("the inpaint re-noise needs renoise_noise")
    if deepcache_interval > 0:
        if deepcache_fns is None:
            raise ValueError("deepcache_interval needs deepcache_fns")
        if cfg_interval != 1:
            raise ValueError("DeepCache and CFG caching do not compose")
    sigmas = ddim.sigmas[:t_enc]
    if bool((sigmas != 0).any()) and sigma_noise is None:
        raise ValueError("a step with sigma > 0 needs sigma_noise")
    if noise_dropout > 0.0 and sigma_noise is not None and dropout_keep is None:
        raise ValueError("noise_dropout needs dropout_keep")
    n_ddim = ddim.num_steps
    sc = lambda v: rounded(v, dt)
    cfg_diff = deep = None

    for i in range(t_enc):
        index = t_enc - 1 - i
        t_i = int(ddim.timesteps[index])
        ts = torch.full((b,), t_i, dtype=torch.int32, device=x.device)
        if use_inpaint and float(renoise_gate[i] if renoise_gate is not None
                                 else 1.0) > 0:
            noised = q_sample(sched, init_latent, t_i,
                              renoise_noise[i].to(x.device, dt))
            nm = nmask.to(dt)
            x = (1.0 - nm) * noised + nm * x

        control = None
        if control_residuals is not None:
            control = mix_controls(control_residuals, control_weights[i])

        scale_i = float(cfg_schedule[i]) if cfg_schedule is not None \
            else cfg_scale
        if deepcache_interval > 0:
            x_in, t_in, ctx2 = _cfg_batch(x, ts, cond, uncond)
            full_fn, cached_fn = deepcache_fns
            if i % deepcache_interval == 0:
                out2, deep = full_fn(x_in, t_in, ctx2)
            else:
                out2 = cached_fn(x_in, t_in, ctx2, deep)
            o_u, o_c = out2.chunk(2, dim=0)
            model_out = o_u + scale_i * (o_c - o_u)
        elif cfg_interval > 1:
            if i % cfg_interval == 0:
                out = model_fn(*_cfg_batch(x, ts, cond, uncond), control)
                o_u, o_c = out.chunk(2, dim=0)
                cfg_diff = o_c - o_u
            else:
                x_in = x if cond.concat is None else \
                    torch.cat([x, cond.concat.to(dt)], dim=-1)
                ctrl_c = None if control is None else \
                    tuple(r[r.shape[0] // 2:] for r in control)
                o_c = model_fn(x_in, ts, cond.crossattn, ctrl_c)
            model_out = o_c + (scale_i - 1.0) * cfg_diff
        else:
            model_out = cfg_model_call(model_fn, x, ts, cond, uncond,
                                       scale_i, control=control,
                                       dedup=cfg_dedup)
        e_t = predict_eps_from_z_and_v(sched, x, t_i, model_out) \
            if parameterization == "v" else model_out
        if score_fn is not None:
            e_t = score_fn(e_t, x, ts, i)

        a_t, a_prev = sc(ddim.alphas[index]), sc(ddim.alphas_prev[index])
        s1m = sc(ddim.sqrt_one_minus_alphas[index]).item()
        sigma_t = sc(ddim.sigmas[index])
        sqrt_at = torch.sqrt(a_t).item()
        pred_x0 = (x - s1m * e_t) / sqrt_at
        if quantize_fn is not None:
            pred_x0 = quantize_fn(pred_x0)
        if dynamic_threshold is not None:
            # pred_x0 only: dir_xt keeps the raw e_t
            pred_x0 = norm_thresholding(pred_x0, dynamic_threshold)

        if use_guidance:
            gs = guidance_strength[i].to(dt)
            if pixel:
                vae_encode, vae_decode = pixel_fns
                idx1 = min(index + 1, n_ddim - 1)
                a_g = sc(math.sqrt(float(ddim.alphas[idx1]))).item()
                s_g = sc(ddim.sqrt_one_minus_alphas[idx1]).item()
                g_noised = a_g * guidance_latent.to(dt) \
                    + s_g * guidance_noise[i].to(x.device, dt)
                g_out = cfg_model_call(model_fn, g_noised, ts, cond, uncond,
                                       scale_i, control=control,
                                       dedup=cfg_dedup)
                e_g = predict_eps_from_z_and_v(sched, g_noised, t_i, g_out) \
                    if parameterization == "v" else g_out
                pred_x0_g = (g_noised - s1m * e_g) / sqrt_at
                dec = vae_decode(pred_x0)
                dec_g = vae_decode(pred_x0_g)
                # a latent-size strength map is repeated up to the image
                if gs.dim() >= 3 and 1 < gs.shape[-3] != dec.shape[-3]:
                    f = dec.shape[-3] // gs.shape[-3]
                    gs = gs.repeat_interleave(f, dim=-3).repeat_interleave(
                        f, dim=-2)
                blended = torch.clamp(dec * (1.0 - gs) + dec_g * gs,
                                      -1.0, 1.0)
                pred_x0 = vae_encode(blended, guidance_encode_noise[i])
            else:
                pred_x0 = pred_x0 * (1.0 - gs) + guidance_latent.to(dt) * gs
            e_t = (x - sqrt_at * pred_x0) / s1m

        c_dir = torch.sqrt(torch.clamp(1.0 - a_prev - sigma_t ** 2,
                                       min=0.0)).item()
        x = torch.sqrt(a_prev).item() * pred_x0 + c_dir * e_t
        if float(sigma_t) != 0.0:
            noise = float(sigma_t) * sigma_noise[i].to(x.device, dt) \
                * temperature
            if noise_dropout > 0.0:
                keep = dropout_keep[i].to(x.device)
                noise = torch.where(keep, noise / (1.0 - noise_dropout),
                                    torch.zeros_like(noise))
            x = x + noise
    return x


def ddim_sample(
    model_fn: Callable,
    sched: DiffusionSchedule,
    ddim: DDIMParams,
    cond: CondBundle,
    uncond: CondBundle,
    *,
    shape=None,
    x_T: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    cfg_scale: float = 7.0,
    parameterization: str = "eps",
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    renoise_noise: Optional[torch.Tensor] = None,
    sigma_noise: Optional[torch.Tensor] = None,
    dropout_keep: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    noise_dropout: float = 0.0,
    dynamic_threshold: Optional[float] = None,
    cfg_schedule=None,
    score_fn: Optional[Callable] = None,
    dtype=None,
):
    """Full-chain DDIM sampling from pure noise: :func:`ddim_decode` over
    every step of ``ddim`` from ``x_T``.

    ``x_T`` is given, or drawn from ``generator`` (on its device) with
    ``shape`` in ``dtype``, f32 by default whatever the model's dtype, as
    the JAX ``ddim_sample`` draws it. ``mask`` [.., h, w, 1]: 1 keeps the
    known region ``x0``, re-noised before each step with
    ``renoise_noise[i]`` (the base sampler's polarity, the inverse of
    the inpaint facades' ``nmask``: nmask = 1 - mask). ``sigma_noise``,
    ``dropout_keep`` and the sampler options are :func:`ddim_decode`'s."""
    if x_T is None:
        if shape is None or generator is None:
            raise ValueError("ddim_sample needs x_T, or shape and generator")
        x_T = torch.randn(tuple(shape), generator=generator,
                          device=generator.device,
                          dtype=dtype or torch.float32)
    nmask = None if mask is None else (1.0 - mask)
    return ddim_decode(
        model_fn, sched, ddim, x_T, cond, uncond, ddim.num_steps,
        cfg_scale=cfg_scale, parameterization=parameterization,
        init_latent=x0, nmask=nmask, renoise_noise=renoise_noise,
        sigma_noise=sigma_noise, dropout_keep=dropout_keep,
        dynamic_threshold=dynamic_threshold, temperature=temperature,
        noise_dropout=noise_dropout, cfg_schedule=cfg_schedule,
        score_fn=score_fn)


def ddim_encode(
    model_fn: Callable,
    sched: DiffusionSchedule,
    ddim: DDIMParams,
    x0: torch.Tensor,
    cond: CondBundle,
    uncond: Optional[CondBundle] = None,
    t_enc: Optional[int] = None,
    *,
    cfg_scale: float = 1.0,
    timestep_indexing: str = "index",
):
    """Deterministic DDIM inversion: run x0 UP the chain for ``t_enc``
    steps (default all of ``ddim``'s):

      x_{i+1} = sqrt(a_next / a) x_i
                + sqrt(a_next) (sqrt(1 / a_next - 1) - sqrt(1 / a - 1)) e_t

    with a = alphas_prev[i], a_next = alphas[i], the scalars in x's dtype.
    CFG (batch doubling, no stem dedup) when ``cfg_scale`` != 1 and
    ``uncond`` is given, else one model call on ``cond``'s context.

    ``timestep_indexing``: 'index' feeds the model the LOOP INDEX i as
    the timestep, the reference sampler's quirk, kept bit for bit;
    'timestep' feeds ``ddim.timesteps[i]``."""
    del sched   # kept for the JAX signature; the walk reads ``ddim`` only
    if timestep_indexing not in ("index", "timestep"):
        raise ValueError(f"unknown timestep_indexing {timestep_indexing!r}")
    t_enc = t_enc if t_enc is not None else ddim.num_steps
    x = x0
    b, dt = x.shape[0], x.dtype
    use_cfg = cfg_scale != 1.0 and uncond is not None
    for i in range(t_enc):
        t_i = i if timestep_indexing == "index" else int(ddim.timesteps[i])
        ts = torch.full((b,), t_i, dtype=torch.int32, device=x.device)
        if use_cfg:
            e_t = cfg_model_call(model_fn, x, ts, cond, uncond, cfg_scale)
        else:
            e_t = model_fn(x, ts, cond.crossattn, None)
        a = rounded(ddim.alphas_prev[i], dt)
        a_next = rounded(ddim.alphas[i], dt)
        c_x = torch.sqrt(a_next / a).item()
        c_e = (torch.sqrt(a_next) * (torch.sqrt(1.0 / a_next - 1.0)
                                     - torch.sqrt(1.0 / a - 1.0))).item()
        x = c_x * x + c_e * e_t
    return x
