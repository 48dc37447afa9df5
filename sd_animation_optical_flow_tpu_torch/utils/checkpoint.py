"""The JAX package's checkpoint format, written from port trees.

Counterpart of the writer in ``sd_animation_optical_flow_tpu/utils/
checkpoint.py`` (``save_pytree``): a flat ``.npz`` of arrays keyed by the
``/``-joined tree path (dict keys sorted, list items by index), in the
JAX layouts (``utils/jax_params.params_to_jax``), so the JAX package's
``load_pytree`` and the port's ``jax_params.load_npz_tree`` both read it.
"""

from __future__ import annotations

import os

import numpy as np

from .jax_params import params_to_jax

_SEP = "/"


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {_SEP.join(prefix): tree}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, prefix + (key,)))
    return out


def save_npz_tree(path: str, tree, dtype=None):
    """Save a port parameter tree as the JAX package's flat npz; float
    leaves cast to ``dtype`` (a numpy dtype) when given, as ``cli.py
    train-uncertainty`` stores RAFT in float16."""
    flat = _flatten(params_to_jax(tree))
    if dtype is not None:
        flat = {k: a.astype(dtype) if a.dtype.kind == "f" else a
                for k, a in flat.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
