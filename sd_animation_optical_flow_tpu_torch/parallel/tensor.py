"""Tensor-parallel collectives that autograd understands.

The JAX package shards the UNet's transformer weights over the mesh's
'tp' axis and lets GSPMD insert the reductions (``parallel/sharding.py``
there). Here the two Megatron-style boundaries are written by hand, each
as a ``torch.autograd.Function`` over the 'tp' group:

* :func:`copy_to_tp` at the input of a column-split projection: the
  identity forward (every rank holds the whole input), an all-reduce of
  the input's gradient backward (each rank computed the part that flows
  through its own columns);
* :func:`reduce_from_tp` at the output of a row-split projection: an
  all-reduce of the partial products forward, the identity backward
  (every rank needs the whole output's gradient, which it already has).

``torch.distributed.nn.functional.all_reduce`` is not used for the
latter: its backward all-reduces the gradient again, which multiplies it
by the tp size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient over ``group``
    backward: the input of a column-split projection."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward, identity backward: the
    partial products of a row-split projection."""
    return _ReduceFromTP.apply(x, group)
