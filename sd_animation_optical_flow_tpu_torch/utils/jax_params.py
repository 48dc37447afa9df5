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

Input leaves are anything ``numpy.asarray`` reads (numpy or JAX arrays);
the port itself never imports JAX. The ldm checkpoint names of each
entry are in ``sd_animation_optical_flow_tpu/utils/port_weights.py``.
"""

from __future__ import annotations

import numpy as np
import torch


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


def params_from_jax(tree, *, dtype=torch.float32, device="cpu", _key=None):
    """Convert a JAX param tree (dicts / lists / tuples of arrays) to the
    port's tree of tensors on ``device``; float leaves cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dtype=dtype, device=device, _key=k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, dtype=dtype, device=device)
                          for v in tree)
    return _leaf(_key, tree, dtype, device)
