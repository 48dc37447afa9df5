"""Optimizers: AdamW with EMA "wings".

Counterpart of ``sd_animation_optical_flow_tpu/training/optim.py``
(parity with the reference's AdamWwithEMAandWings): AdamW whose state
also carries an f32 exponential moving average of the parameters, with
the warm-up capped decay ``min(ema_decay, 1 - step^-ema_power)``
applied to the updated parameters. The JAX package builds it as an optax
transformation; here it is a ``torch.optim.AdamW`` whose per-parameter
state gains ``"ema"``.
"""

from __future__ import annotations

import torch

from ..utils.tree import tree_map


class AdamWWithEMAWings(torch.optim.AdamW):
    """``torch.optim.AdamW`` (optax's ``adamw``: the same b1, b2, eps and
    decoupled weight decay on every parameter) plus an f32 EMA of the
    parameters in ``state[p]["ema"]``. ``ema_step`` counts the EMA
    updates (the JAX ``EMAWingsState.step``)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, ema_decay: float = 0.9999,
                 ema_power: float = 1.0):
        super().__init__(params, lr=lr, betas=(b1, b2), eps=eps,
                         weight_decay=weight_decay)
        self.ema_decay = ema_decay
        self.ema_power = ema_power
        self.ema_step = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = super().step(closure)
        self.ema_step += 1
        decay = min(self.ema_decay, 1.0 - self.ema_step ** -self.ema_power)
        emas, params = [], []
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if "ema" not in state:
                    # the JAX state starts at the parameters; every
                    # first update has decay 0 and lands on them anyway
                    state["ema"] = p.detach().float().clone()
                emas.append(state["ema"])
                params.append(p.detach().float())
        torch._foreach_mul_(emas, decay)
        torch._foreach_add_(emas, params, alpha=1.0 - decay)
        return loss


def adamw_with_ema_wings(params, lr: float = 1e-3, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8,
                         weight_decay: float = 1e-2,
                         ema_decay: float = 0.9999,
                         ema_power: float = 1.0) -> AdamWWithEMAWings:
    """AdamW + parameter-EMA wings over ``params`` (an iterable of leaf
    tensors), with the JAX function's defaults."""
    return AdamWWithEMAWings(params, lr=lr, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay, ema_decay=ema_decay,
                             ema_power=ema_power)


def ema_params_of(opt: torch.optim.Optimizer, params):
    """The EMA shadow of the parameter tree ``params`` held by ``opt``
    (before the first step: the parameters themselves, in f32)."""
    if not isinstance(opt, AdamWWithEMAWings):
        raise ValueError("no EMA wings in this optimizer")
    return tree_map(lambda p: opt.state[p]["ema"] if "ema" in opt.state[p]
                    else p.detach().float(), params)
