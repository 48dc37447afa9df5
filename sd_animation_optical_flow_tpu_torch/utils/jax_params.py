"""Weights bridge: JAX param pytrees -> the port's param trees.

The JAX package builds its models as nested dicts (and lists) of arrays
(``unet_init``, ``vae_init``, ``clip_text_init``); the port keeps the
same tree with torch tensors in torch layouts. This module converts one
into the other, so both frameworks can run on the same weights:

* a conv weight ``w`` [kh, kw, in, out] (HWIO) -> [out, in, kh, kw]
  (OIHW);
* a linear weight ``w`` [in, out] -> [out, in];
* everything else (biases, GroupNorm / LayerNorm ``scale`` and ``bias``,
  embedding tables) keeps its shape.

:func:`params_to_jax` is the exact inverse (numpy leaves in the JAX
layouts), for the npz writer in ``utils/checkpoint.py``.

Input leaves are anything ``numpy.asarray`` reads (numpy or JAX arrays);
the port itself never imports JAX. The ldm checkpoint names of each
entry are in ``sd_animation_optical_flow_tpu/utils/port_weights.py``.

:func:`train_state_from_jax` carries a JAX training state (params, the
optax ``adamw`` moments and the EMA wings) into the port's
``TrainState``, so a JAX run can be resumed in the port.

:func:`load_npz_tree` reads the JAX package's own checkpoint format (a
flat ``.npz`` keyed by ``/``-joined tree paths, integer parts indexing
lists), and :func:`load_flow_estimator` builds the pixel pipeline's
flow + confidence estimator from a RAFT and uncertainty-head pair in that
format (by default the repository's committed artifacts).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..training.optim import AdamWWithEMAWings
from ..training.train_step import TrainState, init_train_state
from .tree import tree_leaves, tree_map


def _leaf(key, a, dtype, device):
    a = np.asarray(a)
    if a.dtype.kind not in "iub":     # float leaves (bf16 included) -> f32
        a = a.astype(np.float32)
    if key == "w" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif key == "w" and a.ndim == 2:
        a = a.T
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, *, dtype=torch.float32, device="cuda", _key=None):
    """Convert a JAX param tree (dicts / lists / tuples of arrays) to the
    port's tree of tensors on ``device``; float leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype=dtype, device=device, _key=k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, dtype=dtype, device=device)
                          for v in tree)
    return _leaf(_key, tree, dtype, device)


def _leaf_to_jax(key, t):
    t = t.detach().cpu().contiguous()      # channels_last -> row major
    if t.is_floating_point():
        t = t.float()
    a = t.numpy()
    if key == "w" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)
    elif key == "w" and a.ndim == 2:
        a = a.T
    return np.ascontiguousarray(a)


def params_to_jax(tree, *, _key=None):
    """The port's tree of tensors -> the JAX tree of numpy arrays (OIHW ->
    HWIO, linear [out, in] -> [in, out]; float leaves as float32): the
    inverse of :func:`params_from_jax`."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v, _key=k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_jax(v) for v in tree)
    return _leaf_to_jax(_key, tree)


def _unflatten(flat: dict):
    """{'a/0/b': leaf, ...} -> nested dicts, with a list wherever every
    key of a level is an integer (the JAX tree's lists)."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(tree)


def load_npz_tree(path: str, *, dtype=torch.float32, device="cuda"):
    """A flat path-keyed ``.npz`` (the JAX ``utils/checkpoint.py``
    ``save_pytree`` format) -> the port's param tree on ``device``, float
    leaves cast to ``dtype``, layouts converted as
    :func:`params_from_jax` does."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_jax(_unflatten(flat), dtype=dtype, device=device)


ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "artifacts")


def load_flow_estimator(cfg=None, *, raft_path=None, head_path=None,
                        device="cuda"):
    """The pixel pipeline's ``FlowConfidenceEstimator`` on ``device`` from a
    RAFT npz (the full RAFT, ``RAFTConfig()`` shapes) and the learned
    confidence head trained against it (loaded for every mode, used by
    'learned' and 'min'); by default the committed pair
    ``artifacts/raft_synth.npz`` and ``artifacts/
    uncertainty_head_synth.npz``. ``cfg``: a ``FlowConfidenceConfig``
    (default: RAFT at its defaults, fb confidence)."""
    from ..config import _channels_last
    from ..models.flowconf import (FlowConfidenceConfig,
                                   FlowConfidenceEstimator)
    paths = (raft_path or os.path.join(ARTIFACTS, "raft_synth.npz"),
             head_path or os.path.join(ARTIFACTS,
                                       "uncertainty_head_synth.npz"))
    raft, head = (_channels_last(load_npz_tree(p, device=device))
                  for p in paths)
    return FlowConfidenceEstimator(raft, cfg or FlowConfidenceConfig(),
                                   head_params=head, device=device)


def _find(state, has):
    """The first node of a (nested tuple) optimizer state that has all the
    fields ``has``, or None; read by field name, since the port cannot
    import optax's types."""
    if all(hasattr(state, f) for f in has):
        return state
    if isinstance(state, tuple):
        for sub in state:
            found = _find(sub, has)
            if found is not None:
                return found
    return None


def train_state_from_jax(params, opt_state, make_opt, *, step: int = 0,
                         device="cuda") -> TrainState:
    """A JAX ``TrainState``'s (params, opt_state, step) -> the port's
    ``TrainState`` with ``make_opt`` (as for ``init_train_state``) holding
    the same optimizer state: the optax ``ScaleByAdamState`` (count, mu,
    nu) becomes AdamW's (step, exp_avg, exp_avg_sq), with the layout
    transposes of :func:`params_from_jax`, and an ``EMAWingsState``'s
    shadow and step become an :class:`AdamWWithEMAWings`' ``"ema"``
    state and ``ema_step``. Both frameworks then take the same next
    step."""
    state = init_train_state(params_from_jax(params, device=device), make_opt)
    state.step = int(step)
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    wings = _find(opt_state, ("inner", "ema_params", "step"))
    if wings is not None and not isinstance(state.opt, AdamWWithEMAWings):
        raise ValueError("the JAX state carries EMA wings: make_opt must "
                         "build an AdamWWithEMAWings")
    # every moment tree mirrors the params tree: pair leaves by path
    trees = [adam.mu, adam.nu] + ([wings.ema_params] if wings else [])
    leaves = [tree_leaves(tree_map(lambda _, x: x, state.params,
                                   params_from_jax(t, device=device)))
              for t in trees]
    count = float(np.asarray(adam.count))
    for i, p in enumerate(tree_leaves(state.params)):
        st = state.opt.state[p]
        st["step"] = torch.tensor(count, dtype=torch.float32)
        st["exp_avg"] = torch.empty_like(p).copy_(leaves[0][i])
        st["exp_avg_sq"] = torch.empty_like(p).copy_(leaves[1][i])
        if wings is not None:
            st["ema"] = torch.empty_like(p).copy_(leaves[2][i])
    if wings is not None:
        state.opt.ema_step = int(np.asarray(wings.step))
    return state

