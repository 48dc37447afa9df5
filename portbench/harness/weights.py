"""Random SD-1.x weights from a seed, made on the device.

One ``torch.Generator`` on the device, seeded with the run's seed, draws
one uniform buffer per part (the 4-channel UNet, the 9-channel inpainting
UNet, the VAE, the CLIP text tower) in a few large calls; each parameter
is a slice of it, scaled as PyTorch's default initialisation scales it
(convolutions and linear layers U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
norms 1 + U(-0.1, 0.1) and U(-0.1, 0.1), embeddings std 0.02) and stored
in the served dtype. No layer is zero, so every layer shows in the
output. The program reads them as a checkpoint with ldm names; the
reference reads the same tensors by their parameter names.

The VAE's posterior is shaped as a trained KL VAE's is (``posterior``):
at PyTorch's scales its mean, times the scale factor, has a standard
deviation of ~0.04 and its log-variance ~0, so the posterior noise (the
same draw for every frame of a batch) swamps the frame and the frames of
a clip come out a few levels apart. The mean's rows of ``quant_conv`` are
scaled by ``LATENT_GAIN`` (the scaled latent's deviation ~1, which is
what the scale factor normalises) and the log-variance's bias lowered by
``LOGVAR_SHIFT`` (a posterior deviation of ~0.0025), so each frame's
output follows its input.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..reference.sd import (CLIP_PREFIX, UNET_PREFIX, VAE_PREFIX,
                            build_modules)

PARTS = ("unet", "unet9", "vae", "clip")
_CHUNK = 1 << 27
LATENT_GAIN = 24.0
LOGVAR_SHIFT = -12.0


def _scales(module: nn.Module):
    """(parameter name, shape, scale, shift) in ``named_parameters`` order."""
    kinds = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                kinds[full] = (0.1, 1.0 if pname == "weight" else 0.0)
            elif isinstance(m, nn.Embedding):
                kinds[full] = (0.02 * math.sqrt(3.0), 0.0)
            else:
                fan_in = m.weight[0].numel()
                kinds[full] = (1.0 / math.sqrt(fan_in), 0.0)
    return [(n, tuple(p.shape)) + kinds[n]
            for n, p in module.named_parameters()]


def posterior(vae: dict) -> None:
    """Scale the VAE's mean rows of ``quant_conv`` by ``LATENT_GAIN`` and
    shift its log-variance bias by ``LOGVAR_SHIFT``, in place."""
    w, b = vae["quant_conv.weight"], vae["quant_conv.bias"]
    z = w.shape[0] // 2
    gain = torch.tensor([LATENT_GAIN] * z + [1.0] * z, device=w.device)
    shift = torch.tensor([0.0] * z + [LOGVAR_SHIFT] * z, device=b.device)
    vae["quant_conv.weight"] = (w.float() * gain[:, None, None, None]
                                ).to(w.dtype)
    vae["quant_conv.bias"] = (b.float() * gain + shift).to(b.dtype)


def make_state(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{part: {parameter name: tensor}} for the configuration's modules."""
    meta = build_modules(cfg, "meta")
    gen = torch.Generator(device).manual_seed(seed)
    state = {}
    for part in PARTS:
        plan = _scales(meta[part])
        total = sum(math.prod(s) for _, s, _, _ in plan)
        buf = torch.empty(total, dtype=dtype, device=device)
        for off in range(0, total, _CHUNK):
            n = min(_CHUNK, total - off)
            u = torch.rand(n, generator=gen, device=device) * 2.0 - 1.0
            buf[off:off + n] = u.to(dtype)
        leaves, off = {}, 0
        for name, shape, scale, shift in plan:
            n = math.prod(shape)
            leaves[name] = (buf[off:off + n].view(shape).float() * scale
                            + shift).to(dtype)
            off += n
        state[part] = leaves
        del buf
    posterior(state["vae"])
    return state


def ldm_checkpoint(state: dict, unet: str = "unet") -> dict:
    """A checkpoint's state dict (ldm / HF names) of ``state``'s ``unet``
    part with the shared VAE and text tower."""
    sd = {UNET_PREFIX + k: v for k, v in state[unet].items()}
    sd.update({VAE_PREFIX + k: v for k, v in state["vae"].items()})
    sd.update({CLIP_PREFIX + k: v for k, v in state["clip"].items()})
    return sd
