"""Diffusion fine-tuning step, on one card or sharded dp x tp.

Counterpart of ``sd_animation_optical_flow_tpu/training/train_step.py``:
``p_losses`` -> backward -> optimizer step. The params are a tree of f32
leaf tensors with ``requires_grad`` (the master weights); the
activations take x0's dtype, as the JAX layers cast params to the
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
of the JAX ``make_train_step`` is the optimizer held in the state.

The sharded step (:func:`shard_train_state`): the JAX package places the
state on a ('dp', 'tp') mesh and GSPMD inserts the collectives; here
every rank of a ``torch.distributed`` mesh (``parallel/mesh.make_mesh``)
holds its 'tp' part of the params, the optimizer moments and the EMA
(``parallel/sharding.py``), takes its 'dp' slice of the whole batch,
runs the UNet with ``tp`` (``models/unet.py``) and all-reduces the
gradients over 'dp' as a mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..diffusion.schedule import DiffusionSchedule
from ..models import unet as U
from ..parallel.mesh import axis_group, shard_batch
from ..parallel.sharding import shard_leaf, unet_param_specs
from ..utils.tree import tree_leaves, tree_map, tree_map_with_path
from .losses import p_losses
from .optim import AdamWWithEMAWings


@dataclass
class TrainState:
    params: dict                 # f32 leaf tensors with requires_grad
    opt: torch.optim.Optimizer   # over tree_leaves(params)
    step: int = 0
    # set by shard_train_state: params holds this rank's 'tp' part, laid
    # out by specs (parallel/sharding.unet_param_specs)
    mesh: Optional[DeviceMesh] = None
    specs: Optional[dict] = None


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
    detached (f32, on x0's device).

    For a state from :func:`shard_train_state` every rank of its mesh
    passes the same whole batch; each takes its 'dp' slice of every input
    (``parallel/mesh.shard_batch``, the JAX batch sharding), runs the loss
    on it with ``tp``, all-reduces every gradient over 'dp' and divides
    by the 'dp' size (equal slices: the whole batch's mean loss, as in
    JAX), and returns the loss averaged over 'dp'. Replicated params get
    equal gradients on every 'tp' rank from the UNet's collectives
    alone."""

    def step(state: TrainState, x0, context, t, noise, c_concat=None,
             y=None):
        if state.mesh is None:
            loss = p_losses(state.params, unet_cfg, sched, x0, context, t,
                            noise, parameterization=parameterization,
                            c_concat=c_concat, y=y)
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
            state.opt.step()
            state.step += 1
            return loss.detach()
        mesh = state.mesh
        local = lambda a: None if a is None else shard_batch(
            torch.as_tensor(a), mesh, "dp")
        loss = p_losses(state.params, unet_cfg, sched, local(x0),
                        local(context), local(t), local(noise),
                        parameterization=parameterization,
                        c_concat=local(c_concat), y=local(y),
                        tp=U.TensorParallelConfig(mesh))
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        group, _, n = axis_group(mesh, "dp")
        grads = [p.grad for p in tree_leaves(state.params)
                 if p.grad is not None]
        for g in grads:
            dist.all_reduce(g, group=group)
        torch._foreach_div_(grads, float(n))
        state.opt.step()
        state.step += 1
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return loss / n

    return step


def _same_optimizer(opt: torch.optim.Optimizer, leaves):
    """A new optimizer of ``opt``'s class over ``leaves`` with its
    hyperparameters (one parameter group) and no per-parameter state."""
    if len(opt.param_groups) != 1:
        raise ValueError(f"shard_train_state takes an optimizer of one "
                         f"parameter group, got {len(opt.param_groups)}")
    if isinstance(opt, AdamWWithEMAWings):
        new = AdamWWithEMAWings(leaves, ema_decay=opt.ema_decay,
                                ema_power=opt.ema_power)
        new.ema_step = opt.ema_step
    elif type(opt) is torch.optim.AdamW:
        new = torch.optim.AdamW(leaves)
    else:
        raise TypeError(f"shard_train_state cannot shard the state of "
                        f"{type(opt).__name__} (AdamW or "
                        f"AdamWWithEMAWings)")
    new.defaults = dict(opt.defaults)
    new.param_groups[0].update({k: v for k, v in opt.param_groups[0].items()
                                if k != "params"})
    return new


def shard_train_state(state: TrainState, mesh: DeviceMesh) -> TrainState:
    """The state placed on ``mesh`` with the UNet's dp x tp layout (JAX's
    ``shard_train_state``): every rank of the mesh calls it with the same
    whole state. The params become this rank's 'tp' part
    (``parallel/sharding.unet_param_specs``; new f32 leaf tensors with
    ``requires_grad``, whole leaves copied too); the optimizer is rebuilt
    over them with the same class and hyperparameters; every
    per-parameter tensor of its state shaped as its parameter (AdamW's
    ``exp_avg`` / ``exp_avg_sq``, the wings' ``"ema"``) is sharded as
    the parameter is (JAX's ``place_opt``), and the step counts (AdamW's
    per-parameter ``step``, ``ema_step``) stay whole. A state from
    ``utils/jax_params.train_state_from_jax`` shards the same way.
    ``parallel/sharding.gather_params(state.params, state.specs,
    state.mesh)`` reads the whole params back (and so the EMA, through
    ``optim.ema_params_of``). Raises TypeError unless ``mesh`` is a
    torch DeviceMesh."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"shard_train_state needs a torch DeviceMesh "
                        f"(parallel.mesh.make_mesh), got "
                        f"{type(mesh).__name__}")
    if state.mesh is not None:
        raise ValueError("the train state is sharded already")
    specs = unet_param_specs(state.params)
    placed = []

    def own_part(path, x, spec):
        part = shard_leaf(path, x.detach(), spec, mesh)
        return part if "tp" in spec else part.clone()

    def place(path, p, spec):
        q = own_part(path, p, spec).requires_grad_()
        placed.append((path, p, spec, q))
        return q

    params = tree_map_with_path(place, state.params, specs)
    opt = _same_optimizer(state.opt, [q for *_, q in placed])
    for path, p, spec, q in placed:
        opt.state[q] = {
            k: (own_part(path, v, spec) if v.shape == p.shape
                else v.clone()) if isinstance(v, torch.Tensor) else v
            for k, v in state.opt.state.get(p, {}).items()}
    return TrainState(params=params, opt=opt, step=state.step, mesh=mesh,
                      specs=specs)
