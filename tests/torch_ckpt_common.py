"""Tiny reference-named checkpoints for the port's checkpoint and CLI
tests (``tests/test_torch_port_weights.py``, ``tests/test_torch_config_
cli.py``, ``tests/test_torch_cli_ranks.py``) and for chip_smoke.py's
``[cli]`` phase. Its module level imports torch, numpy and the torch
modules of ``tests/torch_sd_ref.py`` only, never JAX or PyYAML (the
card's machine has neither).

A checkpoint is a ``.ckpt`` with a nested ``state_dict`` of float16
tensors in CompVis/ldm naming, as real SD-1.5 files are: the UNet
(``model.diffusion_model.``), the KL VAE (``first_stage_model.``) and the
CLIP text tower (``cond_stage_model.transformer.text_model.``), at the
tiny widths of ``TINY_SPEC`` (a flat-schema YAML spec for
``config.load_spec``), plus a Lightning-style entry that is not a
tensor.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from torch_sd_ref import TorchUNet, TorchVAEDecoder, TorchVAEEncoder

TINY_UNET = dict(model_channels=32, channel_mult=[1, 2],
                 attention_resolutions=[1], num_heads=2, context_dim=32)
TINY_VAE = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1)
TINY_CLIP = dict(vocab_size=49408, width=32, layers=1, heads=2)
TINY_SPEC = {"unet": {"in_channels": 4, **TINY_UNET}, "vae": TINY_VAE,
             "clip": TINY_CLIP}
TINY_SPEC9 = {**TINY_SPEC, "unet": {**TINY_SPEC["unet"], "in_channels": 9},
              "conditioning_key": "hybrid"}

CLIP_PREFIX = "cond_stage_model.transformer.text_model."
ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"


def clip_text_state_dict(width, layers, vocab=49408, positions=77,
                         prefix=CLIP_PREFIX, gen=None):
    """Random CLIP text-tower weights under the HF CLIPTextModel names
    (a transformers model's state dict, without transformers)."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    rand = lambda *s, scale=0.02: torch.randn(s, generator=gen) * scale
    sd = {"embeddings.token_embedding.weight": rand(vocab, width),
          "embeddings.position_embedding.weight": rand(positions, width),
          "embeddings.position_ids": torch.arange(positions)[None],
          "final_layer_norm.weight": 1 + rand(width, scale=0.1),
          "final_layer_norm.bias": rand(width)}
    lin = {"self_attn.q_proj": (width, width), "self_attn.k_proj":
           (width, width), "self_attn.v_proj": (width, width),
           "self_attn.out_proj": (width, width),
           "mlp.fc1": (4 * width, width), "mlp.fc2": (width, 4 * width)}
    for i in range(layers):
        base = f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[base + ln + ".weight"] = 1 + rand(width, scale=0.1)
            sd[base + ln + ".bias"] = rand(width)
        for name, (o, n) in lin.items():
            sd[base + name + ".weight"] = rand(o, n,
                                               scale=1 / math.sqrt(n))
            sd[base + name + ".bias"] = rand(o)
    return {prefix + k: v for k, v in sd.items()}


def _prefixed(module, prefix):
    return {prefix + k: v.detach().clone()
            for k, v in module.state_dict().items()}


def ldm_state_dict(in_channels: int, seed: int) -> dict:
    """The tiny bundle's weights in ldm naming (float32 tensors)."""
    torch.manual_seed(seed)
    unet = TorchUNet(in_channels=in_channels, **TINY_UNET)
    vae_kw = {**TINY_VAE, "ch_mult": tuple(TINY_VAE["ch_mult"])}
    enc, dec = TorchVAEEncoder(**vae_kw), TorchVAEDecoder(**vae_kw)
    quant, post = torch.nn.Conv2d(8, 8, 1), torch.nn.Conv2d(4, 4, 1)
    sd = _prefixed(unet, "model.diffusion_model.")
    sd.update(_prefixed(enc, "first_stage_model.encoder."))
    sd.update(_prefixed(dec, "first_stage_model.decoder."))
    sd.update(_prefixed(quant, "first_stage_model.quant_conv."))
    sd.update(_prefixed(post, "first_stage_model.post_quant_conv."))
    sd.update(clip_text_state_dict(TINY_CLIP["width"], TINY_CLIP["layers"],
                                   gen=torch.Generator().manual_seed(seed)))
    return sd


def save_ckpt(path, state_dict, dtype=torch.float16):
    """A Lightning-style ``.ckpt``: float tensors stored in ``dtype``."""
    sd = {k: v.to(dtype) if v.is_floating_point() else v
          for k, v in state_dict.items()}
    torch.save({"state_dict": sd, "global_step": 1000}, path)


def write_tiny_files(d: Path) -> dict:
    """The CLI tests' inputs under ``d``, by name: the two tiny specs
    ('spec', 'spec9') and their checkpoints ('ckpt', 'ckpt9'), a
    raft-things checkpoint of the committed artifact's weights ('raft',
    through ``tests/test_port_weights.py``'s ``make_raft_state_dict``)
    and a 12-frame 64x64 clip of ``tests/test_pipeline.py``'s synthetic
    frames encoded by cv2 ('video'; None where cv2 has no encoder)."""
    import yaml
    from test_pipeline import _synthetic_frames
    from test_port_weights import make_raft_state_dict
    from test_video_io import _write_video
    from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
        _unflatten
    d.mkdir(parents=True, exist_ok=True)
    paths = {"spec": d / "sd.yaml", "spec9": d / "sd9.yaml",
             "ckpt": d / "sd.ckpt", "ckpt9": d / "sd9.ckpt",
             "raft": d / "raft.pth", "video": d / "clip.avi"}
    for key, doc in (("spec", TINY_SPEC), ("spec9", TINY_SPEC9)):
        paths[key].write_text(yaml.safe_dump(doc))
    save_ckpt(paths["ckpt"], ldm_state_dict(4, 0))
    save_ckpt(paths["ckpt9"], ldm_state_dict(9, 1))
    with np.load(ARTIFACTS / "raft_synth.npz") as data:
        raft = _unflatten({k: data[k] for k in data.files})
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in make_raft_state_dict(raft).items()},
               paths["raft"])
    if not _write_video(str(paths["video"]), _synthetic_frames(12, 64, 64)):
        paths["video"] = None
    return {k: v and str(v) for k, v in paths.items()}

