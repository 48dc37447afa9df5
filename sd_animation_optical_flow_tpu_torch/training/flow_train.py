"""Optical-flow training: RAFT sequence loss + train step, and the
learned uncertainty head's step.

Counterpart of ``sd_animation_optical_flow_tpu/training/flow_train.py``.
The loss follows the RAFT recipe: exponentially weighted L1 over the
per-iteration predictions (gamma^(N-i-1)), invalid / extreme-flow pixels
masked out, plus end-point-error metrics. The optimizer is RAFT's: clip
by global norm, then AdamW (optax's ``clip_by_global_norm`` + ``adamw``).

The JAX step is one jitted function of (state, ...) returning a new
state; here the step updates the state in place (the optimizer is
torch's and lives in the state, built by the factory
``make_flow_optimizer`` returns) and returns it with the detached loss and
metrics (tensors on the inputs' device; nothing waits for the card).
Every leaf of the parameter tree trains, as JAX's ``value_and_grad`` over
the whole tree does: the context encoder's batch-norm ``mean`` and
``var`` included, weight decay too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..models import flowconf as FC
from ..models import raft as RF
from ..utils.tree import tree_leaves
from .train_step import trainable


def sequence_loss(flow_preds, flow_gt, valid, *, gamma: float = 0.8,
                  max_flow: float = 400.0):
    """flow_preds [I, N, H, W, 2] (per-iteration upsampled predictions),
    flow_gt [N, H, W, 2], valid [N, H, W] in {0, 1}.

    Returns (loss, metrics dict with epe / 1px / 3px / 5px rates)."""
    n_iters = flow_preds.shape[0]
    mag = flow_gt.pow(2).sum(-1).sqrt()
    mask = ((valid >= 0.5) & (mag < max_flow)).to(flow_preds.dtype)
    denom = mask.sum().clamp_min(1.0)

    weights = gamma ** torch.arange(n_iters - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    l1 = (flow_preds - flow_gt[None]).abs().sum(-1)           # [I, N, H, W]
    per_iter = (l1 * mask[None]).sum((1, 2, 3)) / denom
    loss = (weights * per_iter).sum()

    epe_map = (flow_preds[-1] - flow_gt).pow(2).sum(-1).sqrt()
    metrics = {"epe": (epe_map * mask).sum() / denom}
    for px in (1, 3, 5):
        metrics[f"{px}px"] = ((epe_map < px) * mask).sum() / denom
    return loss, metrics


class ClipAdamW(torch.optim.AdamW):
    """optax's ``chain(clip_by_global_norm(clip), adamw(lr, weight_decay))``:
    every gradient is scaled by clip / max(||g||, clip), ||g|| the norm
    over ALL leaves (``clip_grad_norm_`` divides by ||g|| + 1e-6 instead),
    then torch's AdamW (optax's: b1 0.9, b2 0.999, decoupled weight decay
    on every leaf). A leaf without a gradient takes a zero one, as it
    would in optax (its moments decay, its weight decay applies).
    ``grad_norm`` holds the last step's norm before the clip (a tensor on
    the parameters' device)."""

    def __init__(self, params, lr: float = 4e-4, weight_decay: float = 1e-4,
                 clip: float = 1.0, eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=eps,
                         weight_decay=weight_decay)
        self.clip = clip

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = torch.stack([g.pow(2).sum() for g in grads]).sum().sqrt()
        torch._foreach_mul_(grads, self.clip / norm.clamp_min(self.clip))
        self.grad_norm = norm
        return super().step(closure)


def make_flow_optimizer(lr: float = 4e-4, weight_decay: float = 1e-4,
                        clip: float = 1.0) -> Callable:
    """RAFT's AdamW + gradient clipping recipe, as a factory
    ``leaves -> ClipAdamW`` for :func:`init_flow_train_state`."""
    return lambda leaves: ClipAdamW(leaves, lr=lr, weight_decay=weight_decay,
                                    clip=clip)


@dataclass
class FlowTrainState:
    params: dict                 # f32 leaf tensors with requires_grad
    opt: torch.optim.Optimizer   # over tree_leaves(params)
    step: int = 0


def init_flow_train_state(params, tx: Callable) -> FlowTrainState:
    """``tx(leaves)`` (``make_flow_optimizer(...)``) builds the optimizer
    over an f32 copy of ``params`` whose leaves require grad."""
    params = trainable(params)
    return FlowTrainState(params=params, opt=tx(tree_leaves(params)))


def _apply_step(state, loss):
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    state.step += 1


def flow_loss(params, cfg: RF.RAFTConfig, image1, image2, flow_gt, valid, *,
              iters: int = 12, gamma: float = 0.8):
    """The step's objective: ``raft_apply(..., all_iters=True)`` then the
    sequence loss. Returns (loss, metrics)."""
    _, flows_up = RF.raft_apply(params, cfg, image1, image2, iters=iters,
                                all_iters=True)
    return sequence_loss(flows_up, flow_gt, valid, gamma=gamma)


def flow_train_step(state: FlowTrainState, cfg: RF.RAFTConfig, image1,
                    image2, flow_gt, valid, *, iters: int = 12,
                    gamma: float = 0.8):
    """One optimization step. images [N, H, W, 3] RGB 0..255 float32.
    Returns (state, loss, metrics)."""
    loss, metrics = flow_loss(state.params, cfg, image1, image2, flow_gt,
                              valid, iters=iters, gamma=gamma)
    _apply_step(state, loss)
    return state, loss.detach(), {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# learned uncertainty decoder training (PDCNet+'s recipe: the confidence
# comes from a head trained on a frozen matching network)
# ---------------------------------------------------------------------------

def uncertainty_nll_loss(log_b_low, flow_up, flow_gt, valid):
    """Laplace negative log-likelihood of the FLOW ERROR under the head's
    predicted per-pixel scale.

    log_b_low [N, H/8, W/8] (head output), flow_up / flow_gt [N, H, W, 2],
    valid [N, H, W]. The scale upsamples bilinearly (half-pixel centres)
    to full resolution as ``flowconf.learned_confidence`` does at
    inference. Returns (nll, metrics) with the error / scale correlation
    and the mean scale."""
    h, w = flow_up.shape[1:3]
    log_b = F.interpolate(log_b_low[:, None], size=(h, w), mode="bilinear",
                          align_corners=False)[:, 0]
    b = torch.exp(log_b)
    e_abs = (flow_up - flow_gt).abs().sum(-1)                # |ex| + |ey|
    mask = (valid >= 0.5).to(b.dtype)
    denom = mask.sum().clamp_min(1.0)
    nll_map = e_abs / b + 2.0 * log_b + 2.0 * math.log(2.0)
    nll = (nll_map * mask).sum() / denom

    def masked_corr(a, c):
        ma = (a * mask).sum() / denom
        mc = (c * mask).sum() / denom
        va = ((a - ma) ** 2 * mask).sum() / denom
        vc = ((c - mc) ** 2 * mask).sum() / denom
        cov = ((a - ma) * (c - mc) * mask).sum() / denom
        return cov / torch.sqrt(va * vc + 1e-12)

    metrics = {"nll": nll, "err_scale_corr": masked_corr(b, e_abs),
               "mean_b": (b * mask).sum() / denom}
    return nll, metrics


def uncertainty_loss(head_params, raft_params, cfg: RF.RAFTConfig, image1,
                     image2, flow_gt, valid, *, iters: int = 12,
                     disoccluded=None, bce_weight: float = 0.0,
                     radius: float = 1.0 / 3.0):
    """The head step's objective: RAFT frozen (run without a gradient,
    JAX's ``stop_gradient`` on its flow and GRU state), the Laplace NLL,
    plus ``bce_weight`` times a class-balanced BCE of the served
    confidence mapping against ``disoccluded`` when both are given.
    Returns (loss, metrics)."""
    with torch.no_grad():
        flow_low, flow_up, net = RF.raft_apply(
            raft_params, cfg, image1, image2, iters=iters,
            with_features=True)
    log_b = FC.uncertainty_head_apply(head_params, net, flow_low)
    nll, metrics = uncertainty_nll_loss(log_b, flow_up, flow_gt, valid)
    if disoccluded is None or bce_weight <= 0.0:
        return nll, metrics
    conf = FC.learned_confidence(log_b, flow_up.shape[1:3], radius)
    conf = conf.clamp(1e-6, 1.0 - 1e-6)
    dis = disoccluded >= 0.5
    n_pos = dis.sum().to(conf.dtype).clamp_min(1.0)
    n_neg = (~dis).sum().to(conf.dtype).clamp_min(1.0)
    # balanced per-class means: disoccluded pixels are a few percent of
    # the frame and would otherwise vanish from the gradient
    bce = 0.5 * ((-torch.log1p(-conf) * dis).sum() / n_pos
                 + (-torch.log(conf) * ~dis).sum() / n_neg)
    return nll + bce_weight * bce, {**metrics, "bce": bce}


def uncertainty_train_step(state: FlowTrainState, raft_params,
                           cfg: RF.RAFTConfig, image1, image2, flow_gt,
                           valid, *, iters: int = 12, disoccluded=None,
                           bce_weight: float = 0.0,
                           radius: float = 1.0 / 3.0):
    """One head-only optimization step (``state`` holds the head's
    parameters; ``raft_params`` stay frozen). Returns (state, loss,
    metrics)."""
    loss, metrics = uncertainty_loss(
        state.params, raft_params, cfg, image1, image2, flow_gt, valid,
        iters=iters, disoccluded=disoccluded, bce_weight=bce_weight,
        radius=radius)
    _apply_step(state, loss)
    return state, loss.detach(), {k: v.detach() for k, v in metrics.items()}
