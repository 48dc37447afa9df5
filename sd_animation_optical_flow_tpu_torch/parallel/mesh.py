"""Device mesh for SPMD scale-out on ``torch.distributed``.

Counterpart of ``sd_animation_optical_flow_tpu/parallel/mesh.py``: a
("dp", "tp") mesh over the ranks of a process group. The JAX package
runs one program over many devices and lets GSPMD place the data; here
every rank runs the same program on its own device (SPMD), holds whole
(replicated) tensors unless a function says otherwise, and the
collectives of ``parallel/ring_attention.py``, ``parallel/spatial.py``
and ``parallel/tensor.py`` stand where GSPMD and ``shard_map`` insert
theirs. The 'dp' axis carries batches (``shard_batch``, the sharded
train step's gradient mean) and strips (``sp``); the 'tp' axis splits
the UNet's transformer weights (``parallel/sharding.py``, the UNet's
``tp``).

``make_mesh`` never starts a process group of its own: the caller
initialises one (``torch.distributed.init_process_group``, world size dp
* tp) and the mesh is built over it. The JAX ``replicated`` sharding has
no counterpart: whole tensors on every rank are the default layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.tree import tree_leaves


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ('dp', 'tp') mesh over the initialised process group, whose world
    size must be dp * tp (default: every rank on dp). Raises when there
    is no process group or its size differs; it never falls back to one
    device. ``device_type`` "cuda" unless the caller asks for "cpu"."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group (torch.distributed"
            ".init_process_group) of world size dp * tp; none is")
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp < 1 or tp < 1 or dp * tp != n:
        raise ValueError(f"dp * tp = {dp} * {tp} does not match the process "
                         f"group's world size {n}")
    return init_device_mesh(device_type, (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index, size) of ``mesh``'s ``axis``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp"):
    """This rank's slice of axis 0 (the JAX ``batch_sharding``): the
    ``axis`` ranks hold contiguous equal slices in rank order."""
    _, rank, n = axis_group(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over {n} "
                         f"'{axis}' ranks")
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def gather_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp"):
    """Inverse of :func:`shard_batch`: the slices of every ``axis`` rank,
    concatenated along axis 0 on every rank."""
    group, _, n = axis_group(mesh, axis)
    return gather_dim(x, 0, group, n)


def gather_dim(x: torch.Tensor, dim: int, group, n: int):
    """All-gather ``x`` from the ``n`` ranks of ``group`` and concatenate
    along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def replicate_tree(tree, mesh: DeviceMesh):
    """Broadcast every tensor leaf of ``tree`` in place from the mesh's
    first rank to all of its ranks, so ranks that initialised different
    weights agree. Returns ``tree``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    src = int(mesh.mesh.flatten()[0])
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf, src=src)
    return tree
