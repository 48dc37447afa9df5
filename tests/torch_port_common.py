"""Shared set-up for the port's parity tests (tests/test_torch_*.py): the
small configs, JAX-side random weights with the zero-initialised output
convs perturbed, and their conversion to the port through the weights
bridge. Inputs and noise are numpy arrays made from a seed; both
frameworks get the same ones."""

from __future__ import annotations

import jax
import numpy as np
import torch

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
    params_from_jax

# tier-1 runs several test files side by side: keep torch to few threads
torch.set_num_threads(2)

UNET_KW = dict(model_channels=32, channel_mult=(1, 2, 4),
               attention_resolutions=(1, 2), num_heads=4, context_dim=64)
VAE_KW = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)
CLIP_KW = dict(vocab_size=1000, width=64, layers=2, heads=4)


# the zero-initialised convs: the UNet's resblock / transformer outputs and
# final conv, ControlNet's middle-block and hint-encoder outputs (its
# per-block ``zero_convs`` list is matched by name below)
_ZERO_CONVS = ("out_conv", "proj_out", "conv", "middle_out", "hint_out")


def perturb_zero_convs(tree, rng):
    """Give the zero-initialised output convs small random weights, so
    every attention reaches the output and every ControlNet residual is
    nonzero (in place, numpy leaves)."""
    def perturb(conv):
        if not np.asarray(conv["w"]).any():
            conv["w"] = (rng.standard_normal(np.shape(conv["w"]))
                         * 0.05).astype(np.float32)

    if isinstance(tree, dict):
        for key, sub in tree.items():
            if key == "zero_convs":
                for conv in sub:
                    perturb(conv)
            elif key in _ZERO_CONVS and isinstance(sub, dict) \
                    and "w" in sub:
                perturb(sub)
            else:
                perturb_zero_convs(sub, rng)
    elif isinstance(tree, list):
        for sub in tree:
            perturb_zero_convs(sub, rng)
    return tree


def jax_models(seed=0):
    """(configs, JAX param trees) of the small UNet / VAE / CLIP."""
    cfgs = (JU.UNetConfig(**UNET_KW), JV.VAEConfig(**VAE_KW),
            JCL.CLIPTextConfig(**CLIP_KW))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    with numpy_init():
        unet_p = JU.unet_init(k1, cfgs[0])
        vae_p = JV.vae_init(k2, cfgs[1])
        clip_p = JCL.clip_text_init(k3, cfgs[2])
    perturb_zero_convs(unet_p, np.random.default_rng(seed + 1))
    return cfgs, (unet_p, vae_p, clip_p)


def torch_configs():
    return (TU.UNetConfig(**UNET_KW), TV.VAEConfig(**VAE_KW),
            TCL.CLIPTextConfig(**CLIP_KW))


def to_port(tree):
    return params_from_jax(tree, dtype=torch.float32, device="cpu")


def np_t(a):
    """numpy/JAX array -> f32 CPU tensor."""
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def rel_err(a, b):
    """max |a - b| relative to max |b| (the output's scale)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def jax_t_noise(rng, x0, num_timesteps=1000):
    """The t and noise the JAX ``p_losses`` draws from ``rng`` (``k_t,
    k_noise = split(rng)``, then ``randint``, then ``normal``)."""
    k_t, k_noise = jax.random.split(rng)
    t = jax.random.randint(k_t, (x0.shape[0],), 0, num_timesteps)
    noise = jax.random.normal(k_noise, x0.shape, np.float32)
    return torch.from_numpy(np.array(t)), np_t(noise)


def close_tree(port_tree, jax_tree, tol, what):
    """Leaf by leaf: max |port - jax| <= tol * max |jax| (JAX leaves in
    the port's layout). A leaf whose JAX values all lie below 1e-6 of the
    tree's largest is structurally zero (in the small UNet, 32 channels in
    32 groups, a per-channel shift before a GroupNorm has no gradient:
    both sides hold f32 noise there), and both sides must stay below
    that floor."""
    pairs = _leaf_pairs(port_tree, to_port(jax_tree))
    floor = 1e-6 * max(float(b.abs().max()) for _, (_, b) in pairs)
    for name, (a, b) in pairs:
        a = a.detach()
        if float(b.abs().max()) < floor:
            assert float(a.abs().max()) < floor, f"{what} {name}: not ~0"
            continue
        err = rel_err(a.numpy(), b.numpy())
        assert err <= tol, f"{what} {name}: {err:.2e} > {tol:g}"


def _leaf_pairs(a, b, path=""):
    if isinstance(a, dict):
        return [p for k in a for p in _leaf_pairs(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [p for i in range(len(a))
                for p in _leaf_pairs(a[i], b[i], f"{path}/{i}")]
    return [(path, (a, b))]


def fill_zero_leaves(tree, rng):
    """A copy with small random values in the all-zero leaves (the norm
    biases): after three steps of ~lr those would hold ~3e-5, no scale
    for a relative tolerance."""
    return jax.tree.map(
        lambda a: a if np.asarray(a).any() else
        (0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)
