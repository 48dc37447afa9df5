"""Diagonal Gaussian posterior utilities.

Counterpart of ``sd_animation_optical_flow_tpu/diffusion/distributions.py``:
sample / mode / KL / NLL over (mean, logvar) moment pairs (the logvar
is clamped at encode time, ``models/vae.encode_moments``). The sample's
noise is an argument, shaped as ``mean``.
"""

from __future__ import annotations

import math

import torch


def sample(mean, logvar, noise):
    """mean + exp(logvar / 2) * noise."""
    return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)


def mode(mean, logvar):
    return mean


def kl(mean, logvar, other_mean=None, other_logvar=None, axes=(1, 2, 3)):
    """KL(this || other), summed over ``axes``; other defaults to N(0, I)."""
    var = torch.exp(logvar)
    if other_mean is None:
        return 0.5 * torch.sum(mean ** 2 + var - 1.0 - logvar, dim=axes)
    other_var = torch.exp(other_logvar)
    return 0.5 * torch.sum(
        (mean - other_mean) ** 2 / other_var + var / other_var
        - 1.0 - logvar + other_logvar, dim=axes)


def nll(mean, logvar, x, axes=(1, 2, 3)):
    """Negative log-likelihood of x, summed over ``axes``."""
    logtwopi = math.log(2.0 * math.pi)
    return 0.5 * torch.sum(
        logtwopi + logvar + (x - mean) ** 2 / torch.exp(logvar), dim=axes)
