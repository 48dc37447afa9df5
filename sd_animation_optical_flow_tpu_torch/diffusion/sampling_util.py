"""Sampler-side tensor helpers: dynamic (norm) thresholding of pred_x0.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/sampling_util.py``
(``append_dims``, ``norm_thresholding``, ``spatial_norm_thresholding``),
read by the DDIM and PLMS samplers' ``dynamic_threshold``. NHWC, as in
the JAX package: the spatial variant reduces over the trailing channel
axis.
"""

from __future__ import annotations

import torch


def append_dims(x: torch.Tensor, target_dims: int) -> torch.Tensor:
    """Right-pad ``x`` with singleton dims until it has ``target_dims``."""
    dims_to_append = target_dims - x.dim()
    if dims_to_append < 0:
        raise ValueError(
            f"input has {x.dim()} dims but target_dims is {target_dims}")
    return x[(...,) + (None,) * dims_to_append]


def norm_thresholding(x0: torch.Tensor, value: float) -> torch.Tensor:
    """Rescale each batch element so its RMS (taken in f32) is at most
    ``value``: x0 * value / max(rms, value). Elements already below the
    threshold are unchanged."""
    rms = x0.float().square().reshape(x0.shape[0], -1).mean(1).sqrt()
    s = append_dims(torch.clamp(rms, min=value), x0.dim()).to(x0.dtype)
    return x0 * (torch.tensor(value, dtype=x0.dtype, device=x0.device) / s)


def spatial_norm_thresholding(x0: torch.Tensor, value: float) -> torch.Tensor:
    """Per-pixel variant: the RMS over the channel axis (NHWC -> the last
    axis, taken in f32), clamped below by ``value``: x0 * value / s."""
    s = x0.float().square().mean(-1, keepdim=True).sqrt()
    s = torch.clamp(s, min=value).to(x0.dtype)
    return x0 * (torch.tensor(value, dtype=x0.dtype, device=x0.device) / s)
