"""Model facade: plain img2img.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/facades.py``
(``StableDiffusionBundle``, ``img2img``), main route only: CLIP chunked
encode -> VAE encode (sampled) -> ``stochastic_encode`` -> CFG UNet steps
through the multistep engine (DDIM or DPM-Solver++(2M), stem dedup) ->
VAE decode.

Noise is explicit: :func:`_img2img_core` takes the posterior noise and
the forward-noising noise as tensors (the tests hand both frameworks the
same arrays); :func:`img2img` draws them from
``torch.Generator(device).manual_seed(seed)``. torch and JAX generators
give different numbers from one seed, so the same seed does not give the
JAX package's image.

Images are NHWC in [-1, 1].
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

from ..diffusion import ddim as D
from ..diffusion import multistep as M
from ..diffusion.dpm_solver import uniform_timesteps_desc
from ..diffusion.schedule import (DiffusionSchedule, make_ddim_params,
                                  make_linear_schedule)
from ..models import clip as CL
from ..models import unet as U
from ..models import vae as V
from .tokenizer import PromptTokenizer

_SAMPLER = re.compile(r"ddim|dpmpp(:[1-9][0-9]*)?")


@dataclass
class StableDiffusionBundle:
    """One SD model stack: params, configs, schedule, tokenizer."""
    unet_params: dict
    unet_cfg: U.UNetConfig
    vae_params: dict
    vae_cfg: V.VAEConfig
    clip_params: dict
    clip_cfg: CL.CLIPTextConfig
    sched: DiffusionSchedule = field(default_factory=make_linear_schedule)
    parameterization: str = "eps"
    tokenizer: PromptTokenizer = field(default_factory=PromptTokenizer)
    clip_skip: int = 0
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        self.device = torch.device(self.device)
        self._text_cache: dict = {}

    def get_learned_conditioning(self, text: str):
        """Chunked CLIP encode -> [1, 231, 768], cached per prompt."""
        if text not in self._text_cache:
            ids = torch.from_numpy(self.tokenizer.chunked(text)[None])
            ctx = CL.encode_chunked(self.clip_params, self.clip_cfg,
                                    ids.to(self.device),
                                    clip_skip=self.clip_skip)
            self._text_cache[text] = ctx.to(self.dtype)
        return self._text_cache[text]


def _t_enc(denoising_strength: float, steps: int) -> int:
    return int(min(denoising_strength, 0.999) * steps)


def check_sampler(sampler: str) -> str:
    """Accept 'ddim', 'dpmpp' or 'dpmpp:N' (N a positive int)."""
    if not isinstance(sampler, str) or not _SAMPLER.fullmatch(sampler):
        raise ValueError(f"unknown sampler {sampler!r}: expected 'ddim', "
                         "'dpmpp' or 'dpmpp:N' with N a positive integer")
    return sampler


def sampler_coeffs(sched: DiffusionSchedule, ddim_steps: int, t_enc: int,
                   sampler: str) -> M.MultistepCoeffs:
    """The multistep engine's coefficients for ``sampler`` entering at DDIM
    step ``t_enc`` of a ``ddim_steps`` schedule. 'dpmpp' runs t_enc
    second-order steps; 'dpmpp:N' pins N steps from the same entry noise
    level."""
    ddim = make_ddim_params(sched, ddim_steps)
    if check_sampler(sampler) == "ddim":
        return M.make_ddim_coeffs(ddim, t_enc)
    n = int(sampler.split(":", 1)[1]) if ":" in sampler else max(t_enc, 1)
    dts = uniform_timesteps_desc(sched, int(ddim.timesteps[t_enc]), n)
    return M.make_dpmpp_coeffs(sched, dts)


def _img2img_core(sd: StableDiffusionBundle, img, ctx_cond, ctx_uncond,
                  enc_noise, noise, *, t_enc: int, ddim_steps: int,
                  cfg_scale: float, sampler: str):
    """VAE encode (posterior sample with ``enc_noise``) -> stochastic_encode
    with ``noise`` -> CFG multistep decode (stem dedup) -> VAE decode.
    Returns (image clipped to [-1, 1], final latent)."""
    init_latent = V.encode(sd.vae_params, sd.vae_cfg, img.to(sd.dtype),
                           noise=enc_noise)
    ddim = make_ddim_params(sd.sched, ddim_steps)
    x1 = D.stochastic_encode(ddim, init_latent, t_enc, noise)

    def model_fn(x, t, ctx, control=None):
        pair = ctx if isinstance(ctx, tuple) else None
        out, _ = U.unet_apply(sd.unet_params, sd.unet_cfg, x, t,
                              None if pair is not None else ctx,
                              context_pair=pair)
        return out

    coeffs = sampler_coeffs(sd.sched, ddim_steps, t_enc, sampler)
    decoded = M.multistep_decode(
        model_fn, coeffs, x1, D.CondBundle(crossattn=ctx_cond),
        D.CondBundle(crossattn=ctx_uncond), cfg_scale=cfg_scale,
        cfg_dedup=True, parameterization=sd.parameterization)
    img_out = V.decode(sd.vae_params, sd.vae_cfg, decoded)
    return img_out.clamp(-1.0, 1.0), decoded


def img2img(sd: StableDiffusionBundle, img, c_text: str, uc_text: str,
            denoising_strength: float = 0.3, ddim_steps: int = 50,
            target_img=None, guidance_schedule_func=None,
            guidance_weight=None, cfg_scale: float = 7.0,
            seed: int = 1234, reference_kv=None, capture_kv: bool = False,
            control_specs=(), guidance_space: str = "latent",
            sampler: str = "ddim", cfg_interval: int = 1,
            deepcache_interval: int = 0, strip=None, sp=None):
    """Plain img2img. img: [B, H, W, 3] in [-1, 1] (a tensor; moved to the
    bundle's device). Returns (image, None): K/V capture is not ported.

    ``sampler``: 'ddim' (eta 0) or 'dpmpp' / 'dpmpp:N' (DPM-Solver++(2M)).
    The guidance, ControlNet, K/V, strip, sequence-parallel, DeepCache and
    CFG-interval hooks of the JAX facade are not ported yet and raise
    NotImplementedError."""
    unported = {
        "target_img (guidance blending)": (target_img is not None, "6"),
        "control_specs (ControlNet)": (bool(control_specs), "9"),
        "reference_kv (K/V injection)": (reference_kv is not None, "8"),
        "capture_kv (K/V capture)": (capture_kv, "8"),
        "strip (MFR strips)": (strip is not None, "9"),
        "sp (sequence parallelism)": (sp is not None, "11"),
        "deepcache_interval": (deepcache_interval != 0, "9"),
        "cfg_interval != 1": (cfg_interval != 1, "9"),
    }
    for what, (given, item) in unported.items():
        if given:
            raise NotImplementedError(
                f"{what} is not ported to the torch package yet "
                f"(ROADMAP §1 item {item})")
    check_sampler(sampler)
    img = img.to(sd.device)
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    f = sd.vae_cfg.downscale
    b, h, w, _ = img.shape
    shape = (b, h // f, w // f, sd.vae_cfg.embed_dim)
    gen = torch.Generator(sd.device).manual_seed(seed)
    enc_noise = torch.randn(shape, generator=gen, device=sd.device)
    noise = torch.randn(shape, generator=gen, device=sd.device)
    out, _ = _img2img_core(
        sd, img, ctx_c.expand(b, -1, -1), ctx_u.expand(b, -1, -1),
        enc_noise, noise, t_enc=_t_enc(denoising_strength, ddim_steps),
        ddim_steps=ddim_steps, cfg_scale=cfg_scale, sampler=sampler)
    return out, None
