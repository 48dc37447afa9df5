"""Diffusion fine-tuning step.

Counterpart of ``sd_animation_optical_flow_tpu/training/train_step.py``
on one card: ``p_losses`` -> backward -> optimizer step. The params are
a tree of f32 leaf tensors with ``requires_grad`` (the master weights);
the activations take x0's dtype, as the JAX layers cast params to the
activation dtype, so on the card a bf16 x0 gives bf16 activations, f32
master weights and f32 gradients. Under the gradient the UNet's
self-attentions at >= 1536 tokens run kernel #7 forward and #8 / #9
backward, the prompt cross-attentions kernel #1 forward (see
``ops/attention.py`` ``attention``), and the fused FFN kernels #3 / #4
stay off (``models/unet.py`` ``_fused_route``).

The JAX step is one jitted function of (state, batch, rng) that returns
a new state; here the step updates the state in place (the optimizer
is torch's) and takes t and the noise as inputs (``losses.sample_t_noise``
draws them from a ``torch.Generator``). The optax transformation ``tx``
of the JAX ``make_train_step`` is the optimizer held in the state. The
dp x tp sharded step (``shard_train_state``) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..diffusion.schedule import DiffusionSchedule
from ..models import unet as U
from ..utils.tree import tree_leaves, tree_map
from .losses import p_losses


@dataclass
class TrainState:
    params: dict                 # f32 leaf tensors with requires_grad
    opt: torch.optim.Optimizer   # over tree_leaves(params)
    step: int = 0


def make_optimizer(params, lr: float = 1e-5, weight_decay: float = 1e-2):
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
    decay on every leaf) as ``torch.optim.AdamW`` over ``params``."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def trainable(params):
    """A copy of the tree as f32 leaf tensors with ``requires_grad`` (conv
    weights keep their memory format)."""
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True)
                    .requires_grad_(), params)


def init_train_state(params, make_opt: Callable = make_optimizer
                     ) -> TrainState:
    """``make_opt(leaves)`` builds the optimizer over the f32 copy of
    ``params`` (``make_optimizer``, or e.g. ``functools.partial(
    optim.adamw_with_ema_wings, lr=1e-5)``)."""
    params = trainable(params)
    return TrainState(params=params, opt=make_opt(tree_leaves(params)))


def make_train_step(unet_cfg: U.UNetConfig, sched: DiffusionSchedule, *,
                    parameterization: str = "eps"):
    """Build ``step(state, x0, context, t, noise, c_concat=None, y=None)
    -> loss``: one optimizer step on ``p_losses``; the returned loss is
    detached (f32, on x0's device)."""

    def step(state: TrainState, x0, context, t, noise, c_concat=None,
             y=None):
        loss = p_losses(state.params, unet_cfg, sched, x0, context, t, noise,
                        parameterization=parameterization, c_concat=c_concat,
                        y=y)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        return loss.detach()

    return step


def shard_train_state(state: TrainState, mesh):
    """The dp x tp sharded state — not ported yet."""
    raise NotImplementedError("the sharded train step (shard_train_state) is "
                              "not ported to the torch package yet (ROADMAP "
                              "§1 item 8)")
