"""Classifier-free guidance and the DDIM forward noising.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/ddim.py``
(``CondBundle``, ``cfg_model_call``, ``guidance_progress``,
``stochastic_encode``). The guided
DDIM decode itself runs through the multistep engine
(:mod:`.multistep`), as the JAX package's main path does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .schedule import DDIMParams


class CondBundle(NamedTuple):
    """Conditioning for one CFG pass. ``concat`` is the channel-concat
    conditioning of the inpaint models; None means pure cross-attention
    conditioning."""
    crossattn: torch.Tensor                 # [B, L, D]
    concat: Optional[torch.Tensor] = None   # [B, h, w, Cc] or None


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
    x_in = torch.cat([x, x], dim=0)
    t_in = torch.cat([t, t], dim=0)
    ctx = torch.cat([uncond.crossattn, cond.crossattn], dim=0)
    if cond.concat is not None:
        cc = torch.cat([uncond.concat, cond.concat], dim=0)
        x_in = torch.cat([x_in, cc.to(x_in.dtype)], dim=-1)
    out = model_fn(x_in, t_in, ctx, control)
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
