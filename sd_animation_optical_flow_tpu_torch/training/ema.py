"""Exponential moving average of parameters (training aux).

Counterpart of ``sd_animation_optical_flow_tpu/training/ema.py`` (LitEma
parity): a shadow tree with the warm-up decay
``min(decay, (1 + n) / (10 + n))``, functional — state in, state out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.tree import tree_map


@dataclass(frozen=True)
class EMAState:
    shadow: dict
    num_updates: int


def ema_init(params) -> EMAState:
    return EMAState(shadow=tree_map(lambda p: p.detach().clone(), params),
                    num_updates=0)


@torch.no_grad()
def ema_update(state: EMAState, params, decay: float = 0.9999) -> EMAState:
    n = state.num_updates + 1
    # the decay in f32, as the JAX package computes it
    d = float(np.minimum(np.float32(decay),
                         np.float32(1.0 + n) / np.float32(10.0 + n)))
    shadow = tree_map(lambda s, p: s - (1.0 - d) * (s - p.detach()),
                      state.shadow, params)
    return EMAState(shadow=shadow, num_updates=n)


def ema_params(state: EMAState):
    """The evaluation weights."""
    return state.shadow
