"""Model configuration and construction.

Counterpart of ``sd_animation_optical_flow_tpu/config.py``: ``BundleSpec``,
``SD15``, ``SD15_INPAINT9``, ``SD15_DEPTH``, ``SD_UPSCALE``, ``load_spec``
(a builtin name, or a YAML file in this package's flat schema or in the
reference's OmegaConf schema, whose known fields are translated) and
``create_model``. A bundle's weights come from a checkpoint with ldm
names (``utils/port_weights.py``), converted leaf by leaf onto the target
device in the target dtype, or, without one, are drawn at random from an
explicit ``torch.Generator`` straight on that device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import torch

from .diffusion.schedule import make_linear_schedule
from .models.clip import CLIPTextConfig, clip_text_init
from .models.layers import Init
from .models.unet import UNetConfig, unet_init
from .models.vae import VAEConfig, vae_init
from .pipelines.facades import StableDiffusionBundle
from .pipelines.tokenizer import PromptTokenizer

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@dataclass
class BundleSpec:
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    scale_factor: float = 0.18215
    parameterization: str = "eps"
    conditioning_key: str = "crossattn"
    clip_skip: int = 0
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip: CLIPTextConfig = field(default_factory=CLIPTextConfig)

    def build(self, generator: Optional[torch.Generator] = None,
              state_dict=None, dtype=torch.float32,
              device="cuda") -> StableDiffusionBundle:
        """The bundle on ``device``: its UNet, VAE and CLIP ported from
        ``state_dict`` (ldm names, ``utils/port_weights.py``) when one is
        given, else random weights (weightless smoke mode) drawn from
        ``generator``, by default one seeded with 0 on ``device``."""
        device = torch.device(device)
        vae_cfg = VAEConfig(**{**self.vae.__dict__,
                               "scale_factor": self.scale_factor}) \
            if self.vae.scale_factor != self.scale_factor else self.vae
        if state_dict is not None:
            from .utils.port_weights import (port_clip_text, port_unet,
                                             port_vae)
            kw = dict(dtype=dtype, device=device)
            unet_p, m1 = port_unet(state_dict, self.unet, **kw)
            vae_p, m2 = port_vae(state_dict, vae_cfg, **kw)
            clip_p, m3 = port_clip_text(state_dict, self.clip, **kw)
            missing = m1 + m2 + m3
            if missing:
                # strict=False loading, like the reference
                print(f"[config] {len(missing)} keys missing from "
                      f"checkpoint (strict=False), e.g. {missing[:3]}")
        else:
            if generator is None:
                generator = torch.Generator(device).manual_seed(0)
            init = Init(generator, dtype=dtype, device=device)
            unet_p = _channels_last(unet_init(init, self.unet))
            vae_p = _channels_last(vae_init(init, vae_cfg))
            clip_p = clip_text_init(init, self.clip)
        return StableDiffusionBundle(
            unet_params=unet_p, unet_cfg=self.unet,
            vae_params=vae_p, vae_cfg=vae_cfg,
            clip_params=clip_p, clip_cfg=self.clip,
            sched=make_linear_schedule(self.timesteps, self.linear_start,
                                       self.linear_end),
            parameterization=self.parameterization,
            tokenizer=PromptTokenizer(), clip_skip=self.clip_skip,
            dtype=dtype, device=device)


def _channels_last(tree):
    """Conv weights in channels_last memory, the layout cuDNN takes for
    the NHWC activations (no per-call weight relayout)."""
    if isinstance(tree, dict):
        return {k: _channels_last(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_channels_last(v) for v in tree]
    if tree.ndim == 4:
        return tree.contiguous(memory_format=torch.channels_last)
    return tree


SD15 = BundleSpec()
# the 9-channel inpainting UNet: 4 latent + 1 mask + 4 masked-image
# latent channels, concatenated before the input conv ('hybrid')
SD15_INPAINT9 = BundleSpec(conditioning_key="hybrid",
                           unet=UNetConfig(in_channels=9))
# depth2img: 4 latent + 1 depth channel (pipelines/specializations.py)
SD15_DEPTH = BundleSpec(conditioning_key="hybrid",
                        unet=UNetConfig(in_channels=5))
# the latent upscaler: 4 latent + 3 low-res channels, class-conditional
# on the low-res image's augmentation noise level
SD_UPSCALE = BundleSpec(conditioning_key="hybrid",
                        unet=UNetConfig(in_channels=7, num_classes=1000))


def _spec_from_reference_yaml(doc: dict) -> BundleSpec:
    """Translate the reference's OmegaConf schema (guided_ldm_*.yaml)."""
    m = doc["model"]["params"]
    up = m["unet_config"]["params"]
    unet = UNetConfig(
        in_channels=up.get("in_channels", 4),
        out_channels=up.get("out_channels", 4),
        model_channels=up.get("model_channels", 320),
        num_res_blocks=up.get("num_res_blocks", 2),
        attention_resolutions=tuple(up.get("attention_resolutions",
                                           (4, 2, 1))),
        channel_mult=tuple(up.get("channel_mult", (1, 2, 4, 4))),
        num_heads=up.get("num_heads", 8),
        transformer_depth=up.get("transformer_depth", 1),
        context_dim=up.get("context_dim", 768))
    dd = m["first_stage_config"]["params"]["ddconfig"]
    vae = VAEConfig(
        ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        in_channels=dd.get("in_channels", 3), out_ch=dd.get("out_ch", 3),
        z_channels=dd.get("z_channels", 4),
        embed_dim=m["first_stage_config"]["params"].get("embed_dim", 4),
        scale_factor=m.get("scale_factor", 0.18215))
    return BundleSpec(
        timesteps=m.get("timesteps", 1000),
        linear_start=m.get("linear_start", 0.00085),
        linear_end=m.get("linear_end", 0.0120),
        scale_factor=m.get("scale_factor", 0.18215),
        parameterization=m.get("parameterization", "eps"),
        conditioning_key=m.get("conditioning_key", "crossattn"),
        unet=unet, vae=vae)


def load_spec(path_or_name: str) -> BundleSpec:
    """A builtin spec by name ('sd15', 'sd15-inpaint9', 'sd15-depth',
    'sd-upscale'), or a YAML file: this package's flat schema (top-level
    BundleSpec fields and 'unet' / 'vae' / 'clip' sections, e.g.
    ``configs/sd15.yaml``) or the reference's OmegaConf schema (a
    'model' with a 'target'). PyYAML is imported only for a file."""
    builtins = {"sd15": SD15, "sd15-inpaint9": SD15_INPAINT9,
                "sd15-depth": SD15_DEPTH, "sd-upscale": SD_UPSCALE}
    if path_or_name in builtins:
        return builtins[path_or_name]
    import yaml
    with open(path_or_name) as f:
        doc = yaml.safe_load(f)
    if "model" in doc and "target" in doc.get("model", {}):
        return _spec_from_reference_yaml(doc)
    # YAML sequences arrive as lists: tuples keep the frozen configs
    # hashable and equal to the builtins
    detuple = lambda d: {k: tuple(v) if isinstance(v, list) else v
                         for k, v in d.items()}
    unet = UNetConfig(**detuple(doc.get("unet", {})))
    vae = VAEConfig(**detuple(doc.get("vae", {})))
    clip = CLIPTextConfig(**detuple(doc.get("clip", {})))
    top = {k: v for k, v in doc.items()
           if k not in ("unet", "vae", "clip")}
    return BundleSpec(unet=unet, vae=vae, clip=clip, **detuple(top))


def create_model(path_or_name: str, ckpt_path: Optional[str] = None,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> StableDiffusionBundle:
    """The reference's create_model + load_state_dict in one step: the
    spec (``load_spec``) built with the weights of ``ckpt_path`` (a
    ``.ckpt`` / ``.safetensors`` with ldm names) when given, else with
    random weights drawn from ``generator`` (default: seed 0 on
    ``device``)."""
    spec = load_spec(path_or_name)
    state_dict = None
    if ckpt_path:
        from .utils.port_weights import load_state_dict
        state_dict = load_state_dict(ckpt_path)
    return spec.build(generator=generator, state_dict=state_dict,
                      dtype=dtype, device=device)
