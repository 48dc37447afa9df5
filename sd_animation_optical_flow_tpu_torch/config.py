"""Model configuration and construction.

Counterpart of ``sd_animation_optical_flow_tpu/config.py``: ``BundleSpec``,
``SD15``, ``SD15_INPAINT9``, ``SD15_DEPTH``, ``SD_UPSCALE``, ``load_spec``
for their names and ``create_model``. Models are built from random
weights drawn from an explicit ``torch.Generator`` straight on the target
device in the target dtype. Checkpoint loading and YAML specs are not
ported yet.
"""

from __future__ import annotations

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
              dtype=torch.float32, device="cuda") -> StableDiffusionBundle:
        """Random-weight bundle on ``device`` (weightless smoke mode).
        ``generator`` defaults to one seeded with 0 on ``device``."""
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        vae_cfg = VAEConfig(**{**self.vae.__dict__,
                               "scale_factor": self.scale_factor}) \
            if self.vae.scale_factor != self.scale_factor else self.vae
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


def load_spec(path_or_name: str) -> BundleSpec:
    """A builtin spec by name: 'sd15', 'sd15-inpaint9', 'sd15-depth' or
    'sd-upscale'. YAML specs are not ported yet."""
    builtins = {"sd15": SD15, "sd15-inpaint9": SD15_INPAINT9,
                "sd15-depth": SD15_DEPTH, "sd-upscale": SD_UPSCALE}
    if path_or_name in builtins:
        return builtins[path_or_name]
    raise NotImplementedError(
        f"spec {path_or_name!r} is not ported to the torch package yet: "
        "only the builtins " + ", ".join(map(repr, builtins)) + " are "
        "(YAML specs: ROADMAP §1 item 9)")


def create_model(path_or_name: str, ckpt_path: Optional[str] = None,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> StableDiffusionBundle:
    """Build a model stack from a spec name, with random weights drawn
    from ``generator`` (default: seed 0 on ``device``)."""
    if ckpt_path:
        raise NotImplementedError(
            "checkpoint loading is not ported to the torch package yet "
            "(ROADMAP §1 item 9)")
    return load_spec(path_or_name).build(generator=generator, dtype=dtype,
                                         device=device)
