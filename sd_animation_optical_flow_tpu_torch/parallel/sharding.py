"""Tensor-parallel layout of the UNet's parameters over the mesh's 'tp' axis.

Counterpart of ``sd_animation_optical_flow_tpu/parallel/sharding.py``:
the q / k / v and GEGLU up-projections are split on their output
features (each 'tp' rank holds ``num_heads / tp`` heads and ``4 * dim /
tp`` GEGLU columns), the output projections on their input features (each
rank computes a partial sum, reduced over 'tp' in ``models/unet.py``);
convolutions, norms, embeddings and the output projections' biases stay
whole on every rank. The JAX package hands the layout to GSPMD; here
each rank holds its local tree (:func:`shard_params`) and the UNet's
``tp`` argument runs the collectives (``parallel/tensor.py``).

Specs are tuples in the manner of a ``PartitionSpec``: one entry per
dimension of the leaf, "tp" where it is split, ``()`` for a whole leaf.
**The port's layout differs from JAX's.** A linear weight here is
[out, in] (``models/layers.linear``; ``utils/jax_params`` transposes),
so JAX's ``P(None, "tp")`` (split the output features of [in, out]) is
the port's ``("tp", None)``, and JAX's ``P("tp", None)`` is the port's
``(None, "tp")``: a port spec is the JAX spec reversed.

GEGLU's pairing: ``ff_proj`` holds the value rows, then the gate rows
([8 * dim, dim] here; the JAX forward splits them after the product). A
contiguous split would give rank 0 the value rows and rank 1 the gate
rows, so each half is split over 'tp' on its own and a rank holds
``cat(value[r], gate[r])``: the local GEGLU's own split pairs them again.
:func:`gather_params` undoes this. GSPMD gets there by resharding; the
port gets there by layout.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..utils.tree import tree_map_with_path
from .mesh import axis_group, gather_dim

COL_KEYS = ("to_q", "to_k", "to_v", "ff_proj")   # weight [out, in]: split out
ROW_KEYS = ("to_out", "ff_out")                  # weight [out, in]: split in
PAIRED_KEYS = ("ff_proj",)                       # value rows, then gate rows


def _spec(path, leaf):
    if leaf.ndim == 2 and path[-1] == "w":
        for name in path:
            if name in COL_KEYS:
                return ("tp", None)
            if name in ROW_KEYS:
                return (None, "tp")
    if leaf.ndim == 1 and path[-1] == "b" and any(n in COL_KEYS
                                                  for n in path):
        return ("tp",)
    return ()


def unet_param_specs(params):
    """The spec tree of a UNet parameter tree (same structure): ``("tp",
    None)`` for the column-split weights, ``(None, "tp")`` for the
    row-split ones, ``("tp",)`` for ``ff_proj``'s bias, ``()`` for the
    rest (JAX's ``unet_param_specs`` in the port's [out, in] layout)."""
    return tree_map_with_path(_spec, params)


def _paired(path):
    return any(n in PAIRED_KEYS for n in path)


def shard_leaf(path, leaf, spec, mesh: DeviceMesh):
    """This rank's part of ``leaf`` (whole on every rank; at ``path`` in the
    UNet tree, with ``spec``): a new tensor when split, ``leaf`` itself
    when whole. Optimizer moments and the EMA shard through it as their
    parameter does."""
    if "tp" not in spec:
        return leaf
    _, rank, n = axis_group(mesh, "tp")
    dim = spec.index("tp")
    halves = 2 if _paired(path) else 1
    size = leaf.shape[dim] // halves
    if leaf.shape[dim] % (halves * n):
        raise ValueError(f"{'/'.join(path)} {tuple(leaf.shape)}: dim {dim} "
                         f"does not split over {n} 'tp' ranks")
    k = size // n
    parts = [leaf.narrow(dim, h * size + rank * k, k) for h in range(halves)]
    if halves == 2:
        return torch.cat(parts, dim)
    return parts[0].clone(memory_format=torch.contiguous_format)


def shard_params(params, mesh: DeviceMesh):
    """(this rank's local tree, the spec tree) of a UNet parameter tree,
    whole on every rank, over ``mesh``'s 'tp' axis. Split leaves are new
    tensors; whole leaves are the input's own."""
    specs = unet_param_specs(params)
    local = tree_map_with_path(lambda p, x, s: shard_leaf(p, x, s, mesh),
                               params, specs)
    return local, specs


def _whole(path, leaf, spec, group, n):
    if "tp" not in spec:
        return leaf
    dim = spec.index("tp")
    full = gather_dim(leaf, dim, group, n)
    if not _paired(path):
        return full
    # [n ranks x (value, gate) x k] -> [(value, gate) x n ranks x k]
    k = leaf.shape[dim] // 2
    shape = full.shape
    full = full.reshape(*shape[:dim], n, 2, k, *shape[dim + 1:])
    return full.transpose(dim, dim + 1).reshape(shape)


def gather_params(local, specs, mesh: DeviceMesh):
    """The inverse of :func:`shard_params`: every rank's local leaves
    all-gathered over 'tp' into the whole tree (on every rank), the GEGLU
    pairing undone. Whole leaves are returned as they are."""
    group, _, n = axis_group(mesh, "tp")
    return tree_map_with_path(lambda p, x, s: _whole(p, x, s, group, n),
                              local, specs)
