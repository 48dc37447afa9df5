"""Model facades: img2img, img2img_inpaint, img2img_inpaint_batch,
img2img_latent_inpaint, txt2img, img2img_invert.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/facades.py``
(``StableDiffusionBundle``, ``img2img``, ``build_inpaint_conditioning``,
``img2img_inpaint`` on its fused path and its ControlNet branch,
``img2img_inpaint_batch``, ``img2img_latent_inpaint``,
``split_kv_batch``, ``txt2img`` with ``_txt2img_core``,
``img2img_invert``): CLIP chunked encode -> VAE encode (sampled) ->
``stochastic_encode`` -> CFG UNet steps -> VAE decode, with the K/V
capture pass (the terminal-step UNet pass whose 16 self-attention (k, v)
pairs the keyframe pipeline stores and injects into later frames), K/V
injection (``reference_kv``), MFR strips (``strip``), sequence
parallelism (``sp``: the UNet's rows sharded over a mesh axis, the VAE and
the sampler's elementwise updates replicated) and data-parallel batches
(``img2img_inpaint_batch``'s ``mesh``).

A call with no hook runs its steps through the multistep engine (DDIM
or DPM-Solver++(2M); stem dedup unless K/V are injected; the inpaint
re-noise before each step). A DDIM call with a hook on (guidance
blending toward ``target_img``, ControlNet ``control_specs``,
``cfg_interval != 1`` or ``deepcache_interval > 0``) runs through the
hook-carrying ``diffusion.ddim.ddim_decode``, as every DDIM call of the
JAX package does; on DDIM with no hook both give the same steps.

Noise is explicit: the core functions take every noise as a tensor (the
tests hand both frameworks the same arrays); the public facades draw
them from ``torch.Generator(device).manual_seed(seed)``. torch and JAX
generators give different numbers from one seed, so the same seed does
not give the JAX package's image.

Images are NHWC in [-1, 1]; masks [H, W] (or [B, H, W]) in [0, 1].
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..diffusion import ddim as D
from ..diffusion import multistep as M
from ..diffusion.dpm_solver import uniform_timesteps_desc
from ..diffusion.schedule import (DiffusionSchedule,
                                  make_ddim_params_traced,
                                  make_linear_schedule)
from ..models import clip as CL
from ..models import unet as U
from ..models import vae as V
from ..models.controlnet import control_residuals, control_step_weights
from ..ops.filters import fill_masked, gaussian_blur
from ..ops.resize import resize
from ..parallel import mesh as PM
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
    ddim = make_ddim_params_traced(sched, ddim_steps)
    if check_sampler(sampler) == "ddim":
        return M.make_ddim_coeffs(ddim, t_enc)
    n = int(sampler.split(":", 1)[1]) if ":" in sampler else max(t_enc, 1)
    dts = uniform_timesteps_desc(sched, int(ddim.timesteps[t_enc]), n)
    return M.make_dpmpp_coeffs(sched, dts)


def _check_sp(sp):
    if sp is not None and not isinstance(sp, U.SeqParallelConfig):
        raise TypeError(f"sp must be a SeqParallelConfig, got "
                        f"{type(sp).__name__}")


def _latent_core(sd: StableDiffusionBundle, init_latent, ctx_cond,
                 ctx_uncond, noise, *, t_enc: int, ddim_steps: int,
                 cfg_scale: float, sampler: str, c_concat=None, nmask=None,
                 renoise_gate=None, renoise_noise=None, ref_kv=None,
                 capture_kv: bool = False, final_composite: bool = False,
                 strip=None, guidance_latent=None, guidance_strength=None,
                 guidance_space: str = "latent", guidance_noise=None,
                 guidance_encode_noise=None, controls=(),
                 control_weights=None, cfg_interval: int = 1,
                 deepcache_interval: int = 0, sp=None):
    """The JAX ``_img2img_core``: ``stochastic_encode`` with ``noise`` ->
    CFG decode (with the inpaint re-noise when ``nmask`` is given) ->
    optional final composite -> optional K/V capture -> VAE decode.
    Returns (image clipped to [-1, 1], final latent, kv_hist or None).

    With no hook the steps run through the multistep engine. On DDIM a
    hook — guidance toward ``guidance_latent`` (``guidance_strength``
    [t_enc, 1, h, w, 1]; in pixel space with the per-step noise stacks
    ``guidance_noise`` and ``guidance_encode_noise``), ``controls`` (a
    sequence of ``ControlSpec`` with their [t_enc, n_nets] host
    ``control_weights``), ``cfg_interval != 1`` or ``deepcache_interval >
    0`` — sends them through ``ddim_decode``. The ControlNet residuals
    are computed once, from [x1, x1] at the first step's timestep with
    the context [uncond | cond]. On DPM-Solver++ guidance is refused,
    and controls, ``cfg_interval`` and ``deepcache_interval`` do not
    change the image (the JAX DPM++ decode has no such hooks: it drops
    the residuals it computed), so no residual is computed.

    Stem dedup is on unless ``ref_kv`` or ``sp`` is given (the CFG halves
    then see different K/V; the sharded UNet takes no ``context_pair``) or
    CFG caching or DeepCache is on; with ``c_concat``
    both CondBundles share the one tensor, so dedup holds for the
    inpaint model too. The capture pass runs the UNet once more at t = 1
    on the final latent (with ``c_concat`` appended), ``ctx_cond`` only,
    no injection, controls or strip bias (as in the JAX package); the
    stored pairs are contiguous copies, not views of the fused QKV
    projections. Under ``sp`` every UNet evaluation is row-sharded and
    gathers its output; the capture pass also gathers its K/V to whole
    tokens."""
    ddim = make_ddim_params_traced(sd.sched, ddim_steps)
    x1 = D.stochastic_encode(ddim, init_latent, t_enc, noise)

    def model_fn(x, t, ctx, control=None):
        pair = ctx if isinstance(ctx, tuple) else None
        out, _ = U.unet_apply(sd.unet_params, sd.unet_cfg, x, t,
                              None if pair is not None else ctx,
                              ref_kv=ref_kv, control=control, strip=strip,
                              sp=sp, context_pair=pair, capture_kv=False)
        return out

    inpaint = nmask is not None
    use_guidance = guidance_latent is not None
    cond = D.CondBundle(ctx_cond, c_concat)
    uncond = D.CondBundle(ctx_uncond, c_concat)
    if check_sampler(sampler) != "ddim" and use_guidance:
        raise ValueError("guidance blending (target_img) needs the 'ddim' "
                         f"sampler, got {sampler!r}")
    hooked = sampler == "ddim" and (use_guidance or bool(controls)
                                    or cfg_interval != 1
                                    or deepcache_interval > 0)
    if not hooked:
        decoded = M.multistep_decode(
            model_fn, sampler_coeffs(sd.sched, ddim_steps, t_enc, sampler),
            x1, cond, uncond, cfg_scale=cfg_scale,
            cfg_dedup=ref_kv is None and sp is None,
            parameterization=sd.parameterization, sched=sd.sched,
            init_latent=init_latent if inpaint else None, nmask=nmask,
            renoise_gate=renoise_gate, renoise_noise=renoise_noise)
    else:
        residuals = None
        if controls and t_enc > 0:
            b = init_latent.shape[0]
            t_ctrl = torch.full((2 * b,), int(ddim.timesteps[t_enc - 1]),
                                dtype=torch.int32, device=x1.device)
            residuals = control_residuals(
                controls, torch.cat([x1, x1]), t_ctrl,
                torch.cat([ctx_uncond, ctx_cond]))
        pixel_fns = (
            lambda xp, n: V.encode(sd.vae_params, sd.vae_cfg, xp, noise=n),
            lambda z: V.decode(sd.vae_params, sd.vae_cfg, z))
        decoded = D.ddim_decode(
            model_fn, sd.sched, ddim, x1, cond, uncond, t_enc,
            cfg_scale=cfg_scale, parameterization=sd.parameterization,
            guidance_latent=guidance_latent,
            guidance_strength=guidance_strength,
            guidance_space=guidance_space, pixel_fns=pixel_fns,
            guidance_noise=guidance_noise,
            guidance_encode_noise=guidance_encode_noise,
            init_latent=init_latent if inpaint else None, nmask=nmask,
            renoise_gate=renoise_gate, renoise_noise=renoise_noise,
            control_residuals=residuals, control_weights=control_weights,
            cfg_interval=cfg_interval,
            cfg_dedup=(ref_kv is None and sp is None and cfg_interval == 1
                       and deepcache_interval == 0),
            **_deepcache_kwargs(sd, deepcache_interval, ref_kv, controls,
                                c_concat, strip, sp))
    if final_composite and inpaint:
        # the mask in the latent's dtype: an f32 mask would promote the
        # composite, and with it the capture pass, to f32
        nm = nmask.to(decoded.dtype)
        decoded = init_latent * (1.0 - nm) + decoded * nm

    kv_hist = None
    if capture_kv:
        ts = torch.ones((init_latent.shape[0],), dtype=torch.int32,
                        device=decoded.device)
        x_cap = decoded if c_concat is None else \
            torch.cat([decoded, c_concat.to(decoded.dtype)], dim=-1)
        _, kv = U.unet_apply(sd.unet_params, sd.unet_cfg, x_cap, ts,
                             ctx_cond, sp=sp)
        kv_hist = tuple((k.contiguous(), v.contiguous()) for k, v in kv)
    img = V.decode(sd.vae_params, sd.vae_cfg, decoded)
    return img.clamp(-1.0, 1.0), decoded, kv_hist


def _deepcache_kwargs(sd: StableDiffusionBundle, deepcache_interval: int,
                      ref_kv, controls, c_concat, strip, sp=None):
    """``ddim_decode``'s DeepCache arguments when the knob is on: plain
    cross-attention img2img only (the partial forward has no K/V
    injection, ControlNet, concat conditioning, strip bias or sequence
    parallelism)."""
    if deepcache_interval <= 0:
        return {}
    if ref_kv is not None or controls or c_concat is not None \
            or strip is not None or sp is not None:
        raise ValueError("deepcache_interval supports only plain "
                         "cross-attention img2img: no reference_kv, "
                         "control_specs, inpaint conditioning, strip or sp")

    def full_fn(x, t, ctx):
        return U.unet_apply_deepcache(sd.unet_params, sd.unet_cfg, x, t, ctx)

    def cached_fn(x, t, ctx, deep):
        return U.unet_apply_deepcache(sd.unet_params, sd.unet_cfg, x, t, ctx,
                                      deep_cache=deep)[0]
    return {"deepcache_interval": deepcache_interval,
            "deepcache_fns": (full_fn, cached_fn)}


def _img2img_core(sd: StableDiffusionBundle, img, ctx_cond, ctx_uncond,
                  enc_noise, noise, *, t_enc: int, ddim_steps: int,
                  cfg_scale: float, sampler: str, **hooks):
    """VAE encode (posterior sample with ``enc_noise``) then
    :func:`_latent_core` with ``hooks`` (its keyword arguments). Returns
    (image, final latent, kv_hist)."""
    init_latent = V.encode(sd.vae_params, sd.vae_cfg, img.to(sd.dtype),
                           noise=enc_noise)
    return _latent_core(sd, init_latent, ctx_cond, ctx_uncond, noise,
                        t_enc=t_enc, ddim_steps=ddim_steps,
                        cfg_scale=cfg_scale, sampler=sampler, **hooks)


class Img2ImgNoise(NamedTuple):
    """Every noise of one img2img call: the posterior noise of the frame's
    encode (``enc``) and the ``stochastic_encode`` noise (``forward``),
    [B, h, w, c]; with guidance the posterior noise of ``target_img``'s
    encode (``target``), and in pixel space the per-step stacks [t_enc,
    B, h, w, c] of the guidance latent's noise (``guide``) and of the
    blended x0's re-encode (``guide_enc``); None where unused."""
    enc: torch.Tensor
    forward: torch.Tensor
    target: Optional[torch.Tensor] = None
    guide: Optional[torch.Tensor] = None
    guide_enc: Optional[torch.Tensor] = None


def draw_img2img_noise(gen: torch.Generator, latent_shape, t_enc: int, *,
                       target: bool, pixel: bool, device) -> Img2ImgNoise:
    """Draw an :class:`Img2ImgNoise` from ``gen``, the hook-free call's two
    noises first (so a hook leaves them as they were)."""
    rn = lambda shape: torch.randn(shape, generator=gen, device=device)
    shape = tuple(latent_shape)
    enc, forward = rn(shape), rn(shape)
    tgt = rn(shape) if target else None
    steps = (t_enc,) + shape
    return Img2ImgNoise(enc, forward, tgt, rn(steps) if pixel else None,
                        rn(steps) if pixel else None)


def _prep_controls(control_specs, t_enc: int, ddim_steps: int):
    """ControlSpecs -> (the specs, their [t_enc, n_nets] host step weights
    over the denoise progress), or ((), None) without any."""
    if not control_specs:
        return (), None
    progress = D.guidance_progress(max(t_enc, 1), ddim_steps)
    return tuple(control_specs), control_step_weights(control_specs,
                                                      progress)


def _guidance_strength_array(schedule_func, weight_map, t_enc: int,
                             total_steps: int, latent_shape, device):
    """The per-step guidance strengths [t_enc, 1, h, w, 1] (f32 on
    ``device``) from a host schedule function (progress p -> a float or
    a map, resized bicubically to the latent; default 0.1) and an
    optional per-pixel weight map (resized bilinearly). The JAX package
    multiplies the weight map in against the wrong axes (its product
    fails unless h == w); here it scales each latent pixel."""
    h, w = latent_shape[-3], latent_shape[-2]
    rows = []
    for p in D.guidance_progress(t_enc, total_steps):
        g = np.asarray(schedule_func(p) if schedule_func is not None
                       else 0.1, np.float32)
        if g.ndim == 0:
            g = torch.full((h, w), float(g))
        else:
            g = resize(torch.from_numpy(g)[:, :, None], (h, w),
                       "cubic")[..., 0]
        rows.append(g[None, :, :, None])
    gs = torch.stack(rows).to(device)
    if weight_map is not None:
        wm = torch.as_tensor(np.asarray(weight_map, np.float32),
                             device=device)
        gs = gs * resize(wm[:, :, None], (h, w), "linear")[None, None]
    return gs


def img2img(sd: StableDiffusionBundle, img, c_text: str, uc_text: str,
            denoising_strength: float = 0.3, ddim_steps: int = 50,
            target_img=None, guidance_schedule_func=None,
            guidance_weight=None, cfg_scale: float = 7.0,
            seed: int = 1234, reference_kv=None, capture_kv: bool = False,
            control_specs=(), guidance_space: str = "latent",
            sampler: str = "ddim", cfg_interval: int = 1,
            deepcache_interval: int = 0, strip=None, sp=None):
    """Plain img2img. img: [B, H, W, 3] in [-1, 1] (moved to the bundle's
    device). Returns (image, kv_hist): kv_hist is the 16-layer tuple of
    (k, v) [B, N, C] when ``capture_kv``, else None.

    ``sampler``: 'ddim' (eta 0) or 'dpmpp' / 'dpmpp:N' (DPM-Solver++(2M)).
    ``reference_kv``: per-layer (k, v) to inject (batch 1 or B).
    ``strip``: a ``StripConfig`` — img is a width-concatenated strip.
    ``target_img``: guidance blending of each step's x0 toward its latent
    with the strengths of ``guidance_schedule_func`` (progress -> float
    or map; default 0.1) times the optional ``guidance_weight`` map, in
    ``guidance_space`` 'latent' (an x0 lerp) or 'pixel' (the noised
    blending: one more CFG UNet evaluation and three VAE passes a step).
    ``control_specs``: ControlSpecs (``models.controlnet``).
    ``cfg_interval`` > 1: CFG caching; ``deepcache_interval`` > 0:
    DeepCache (plain cross-attention only: no ``reference_kv``,
    ``control_specs`` or ``strip``; not with ``cfg_interval``).

    The JAX facade's limits hold: DPM++ refuses ``target_img``, and on
    DPM++ ``control_specs``, ``cfg_interval`` and ``deepcache_interval``
    do not change the image.

    ``sp``: a ``SeqParallelConfig`` — every rank of its mesh axis calls
    with the same arguments; the UNet's rows are sharded over them (the
    stem dedup off, as in JAX), everything else runs replicated, and
    every rank returns the whole image."""
    _check_sp(sp)
    check_sampler(sampler)
    img = img.to(sd.device)
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    shape = _latent_shape(sd, img.shape)
    b = shape[0]
    t_enc = _t_enc(denoising_strength, ddim_steps)
    use_guidance = target_img is not None and t_enc > 0
    gen = torch.Generator(sd.device).manual_seed(seed)
    noise = draw_img2img_noise(gen, shape, t_enc, target=use_guidance,
                               pixel=use_guidance
                               and guidance_space == "pixel",
                               device=sd.device)
    hooks = {}
    if use_guidance:
        hooks = dict(
            guidance_latent=V.encode(
                sd.vae_params, sd.vae_cfg,
                torch.as_tensor(target_img, device=sd.device).to(sd.dtype),
                noise=noise.target),
            guidance_strength=_guidance_strength_array(
                guidance_schedule_func, guidance_weight, t_enc, ddim_steps,
                shape, sd.device),
            guidance_space=guidance_space, guidance_noise=noise.guide,
            guidance_encode_noise=noise.guide_enc)
    controls, weights = _prep_controls(control_specs, t_enc, ddim_steps)
    out, _, kv = _img2img_core(
        sd, img, ctx_c.expand(b, -1, -1), ctx_u.expand(b, -1, -1),
        noise.enc, noise.forward, t_enc=t_enc, ddim_steps=ddim_steps,
        cfg_scale=cfg_scale, sampler=sampler, ref_kv=reference_kv,
        capture_kv=capture_kv, strip=strip, controls=controls,
        control_weights=weights, cfg_interval=cfg_interval,
        deepcache_interval=deepcache_interval, sp=sp, **hooks)
    return out, kv


# ---------------------------------------------------------------------------
# inpainting
# ---------------------------------------------------------------------------

class InpaintNoise(NamedTuple):
    """Every noise of one inpaint call (the JAX program draws them inside
    ``_inpaint_fused``; here they are inputs). ``enc`` and ``cdt`` are
    the posterior noises of the two VAE encodes, [1, h, w, c] broadcast
    over the batch; ``fill`` [B, h, w, c] randomises the masked latent
    on the fill path (None with a reference); ``forward`` [1 or B, ...]
    is the ``stochastic_encode`` noise; ``renoise`` [S, 1 or B, ...] the
    per-step re-noise stack."""
    enc: torch.Tensor
    cdt: torch.Tensor
    fill: Optional[torch.Tensor]
    forward: torch.Tensor
    renoise: torch.Tensor


def draw_inpaint_noise(gen: torch.Generator, latent_shape, n_slots: int, *,
                       has_reference: bool, tile_noise: bool,
                       tile_renoise: bool, device) -> InpaintNoise:
    """Draw an :class:`InpaintNoise` from ``gen``. ``tile_noise``: one
    forward noise for the whole batch; ``tile_renoise``: one re-noise per
    step for the whole batch (the JAX DDIM sampler tiles it with
    ``tile_noise``, DPM++ never does)."""
    one = (1,) + tuple(latent_shape[1:])
    rn = lambda shape: torch.randn(shape, generator=gen, device=device)
    enc, cdt = rn(one), rn(one)
    fill = None if has_reference else rn(tuple(latent_shape))
    forward = rn(one if tile_noise else tuple(latent_shape))
    step = one if tile_renoise else tuple(latent_shape)
    return InpaintNoise(enc, cdt, fill, forward, rn((max(n_slots, 1),) + step))


def build_inpaint_conditioning(sd: StableDiffusionBundle, image, mask01,
                               noise):
    """5-channel inpaint conditioning: the rounded mask (1 channel, latent
    resolution, nearest) and the VAE latent of the mask-zeroed image (4
    channels, posterior noise ``noise`` [1 or B, h, w, c]). image
    [B, H, W, 3]; mask01 [H, W] (shared by the batch) or [B, H, W]."""
    cmask = torch.round(mask01 if mask01.dim() == 3 else mask01[None])
    cmask = cmask[..., None]
    cond_latent = V.encode(sd.vae_params, sd.vae_cfg,
                           image * (1.0 - cmask.to(image.dtype)), noise=noise)
    h, w = cond_latent.shape[1:3]
    cmask_lat = resize(cmask, (h, w), "nearest")
    return torch.cat([cmask_lat.to(cond_latent.dtype), cond_latent], dim=-1)


def _inpaint_fused(sd: StableDiffusionBundle, image, reference_img, mask01,
                   ctx_c, ctx_u, gates, ref_kv, noise: InpaintNoise, *,
                   mask_blur: int, t_enc: int, ddim_steps: int,
                   cfg_scale: float, capture_kv: bool,
                   final_composite: bool, has_reference: bool,
                   want_init_decoded: bool, sampler: str = "ddim",
                   cfg_interval: int = 1, strip=None, sp=None):
    """image / reference_img [B, H, W, 3]; mask01 [B, H, W]. Mask blur ->
    composite (or the multi-radius fill without a reference) -> VAE
    encode -> binarised latent mask -> 5-channel conditioning -> the
    core (CFG caching with ``cfg_interval`` > 1 on DDIM). Returns
    (image, composited input, decoded init latent or None, kv_hist)."""
    dtype = image.dtype
    m = mask01.float()
    image_mask = torch.stack([gaussian_blur(mm, float(mask_blur))
                              for mm in m]) if mask_blur > 0 else m
    image_mask = image_mask.clamp(0.0, 1.0)
    m4 = image_mask[..., None].to(dtype)
    if has_reference:
        composited = image * (1.0 - m4) + reference_img * m4
    else:
        # fill path: seed the masked pixels with multi-radius blurred
        # colors before encoding
        composited = fill_masked(image, torch.round(image_mask)).to(dtype)

    # the posterior noises are [1, ...], broadcast over the batch (the
    # JAX _vae_encode_tiled): frame i matches a single-frame encode
    init_latent = V.encode(sd.vae_params, sd.vae_cfg, composited,
                           noise=noise.enc)
    h, w = init_latent.shape[1:3]
    nmask = torch.round(resize(image_mask[..., None], (h, w), "linear"))
    if not has_reference:
        # fill path: randomise the masked latent (kept in the latent's
        # dtype, which the UNet's weights share)
        init_latent = ((1.0 - nmask) * init_latent
                       + nmask * noise.fill).to(init_latent.dtype)

    c_concat = build_inpaint_conditioning(sd, composited, image_mask,
                                          noise.cdt)

    out, _, kv = _latent_core(
        sd, init_latent, ctx_c, ctx_u, noise.forward, t_enc=t_enc,
        ddim_steps=ddim_steps, cfg_scale=cfg_scale, sampler=sampler,
        c_concat=c_concat, nmask=nmask, renoise_gate=gates,
        renoise_noise=noise.renoise, ref_kv=ref_kv, capture_kv=capture_kv,
        final_composite=final_composite, strip=strip,
        cfg_interval=cfg_interval, sp=sp)
    init_decoded = V.decode(sd.vae_params, sd.vae_cfg, init_latent).clamp(
        -1.0, 1.0) if want_init_decoded else None
    return out, composited, init_decoded, kv


def _gates(guidance_schedule_func, t_enc: int, ddim_steps: int):
    """Per-step re-noise gates (host floats) and whether the final
    composite runs (the last gate > 0)."""
    fn = guidance_schedule_func or (lambda p: 0.1)
    if t_enc == 0:
        return np.zeros((1,), np.float32), True
    gates = np.asarray([float(fn(p)) for p in
                        D.guidance_progress(t_enc, ddim_steps)], np.float32)
    return gates, bool(gates[-1] > 0)


def _latent_shape(sd: StableDiffusionBundle, image_shape):
    f = sd.vae_cfg.downscale
    b, h, w, _ = image_shape
    return (b, h // f, w // f, sd.vae_cfg.embed_dim)


def img2img_inpaint(sd: StableDiffusionBundle, image, c_text: str,
                    uc_text: str, denoising_strength: float = 0.05,
                    ddim_steps: int = 50, reference_img=None, mask=None,
                    mask_blur: int = 16, guidance_schedule_func=None,
                    cfg_scale: float = 7.0, seed: int = 1234,
                    reference_kv=None, capture_kv: bool = False,
                    control_specs=(), want_init_decoded: bool = True,
                    sampler: str = "ddim", cfg_interval: int = 1,
                    strip=None, sp=None):
    """Masked inpainting img2img on the inpainting model (9-channel UNet).

    image / reference_img: [1, H, W, 3] in [-1, 1]; mask: [H, W] in {0, 1}
    (1 = inpaint). Without ``reference_img`` the masked pixels are filled
    from their surroundings and denoised from full strength. Returns
    (image, composited_input, init_latent_decoded or None, kv_hist).
    ``cfg_interval`` > 1: CFG caching (DDIM).

    With ``control_specs`` the call takes the JAX facade's ControlNet
    branch: the mask blurred as one [H, W] map, the composite (without a
    reference: the image itself, not the multi-radius fill), then DDIM
    with ``cfg_interval`` 1 whatever ``sampler`` and ``cfg_interval``
    say, as the JAX branch passes neither on. ``sp``: sequence
    parallelism of the UNet, as in :func:`img2img`."""
    _check_sp(sp)
    if mask is None:
        raise ValueError("img2img_inpaint requires a mask")
    check_sampler(sampler)
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    mask01 = torch.as_tensor(mask, dtype=torch.float32, device=sd.device)
    has_reference = reference_img is not None
    if not has_reference:
        denoising_strength = 1.0
    if control_specs:
        sampler, cfg_interval = "ddim", 1
    t_enc = _t_enc(denoising_strength, ddim_steps)
    gates, final_composite = _gates(guidance_schedule_func, t_enc,
                                    ddim_steps)
    img_d = torch.as_tensor(image, device=sd.device).to(sd.dtype)
    ref_d = img_d if not has_reference else \
        torch.as_tensor(reference_img, device=sd.device).to(sd.dtype)
    n_slots = sampler_coeffs(sd.sched, ddim_steps, t_enc, sampler).num_slots
    gen = torch.Generator(sd.device).manual_seed(seed)
    noise = draw_inpaint_noise(gen, _latent_shape(sd, img_d.shape), n_slots,
                               has_reference=has_reference, tile_noise=False,
                               tile_renoise=False, device=sd.device)
    if control_specs:
        return _inpaint_controlled(
            sd, img_d, ref_d if has_reference else None, mask01, ctx_c,
            ctx_u, gates, reference_kv, noise, control_specs,
            mask_blur=mask_blur, t_enc=t_enc, ddim_steps=ddim_steps,
            cfg_scale=cfg_scale, capture_kv=capture_kv,
            final_composite=final_composite,
            want_init_decoded=want_init_decoded, strip=strip, sp=sp)
    return _inpaint_fused(
        sd, img_d, ref_d, mask01[None], ctx_c, ctx_u, gates, reference_kv,
        noise, mask_blur=mask_blur, t_enc=t_enc, ddim_steps=ddim_steps,
        cfg_scale=cfg_scale, capture_kv=capture_kv,
        final_composite=final_composite, has_reference=has_reference,
        want_init_decoded=want_init_decoded, sampler=sampler,
        cfg_interval=cfg_interval, strip=strip, sp=sp)


def _blurred_mask(mask01, mask_blur: int):
    """The [H, W] mask blurred (sigma ``mask_blur``) and clipped to [0, 1]."""
    m = gaussian_blur(mask01, float(mask_blur)) if mask_blur > 0 else mask01
    return m.clamp(0.0, 1.0)


def _inpaint_controlled(sd: StableDiffusionBundle, image, reference_img,
                        mask01, ctx_c, ctx_u, gates, ref_kv,
                        noise: InpaintNoise, control_specs, *,
                        mask_blur: int, t_enc: int, ddim_steps: int,
                        cfg_scale: float, capture_kv: bool,
                        final_composite: bool, want_init_decoded: bool,
                        strip=None, sp=None):
    """The ControlNet branch of ``img2img_inpaint`` (the JAX facade's
    unfused path): image [1, H, W, 3], reference_img the same or None
    (then the image itself is encoded and its masked latent randomised
    with ``noise.fill``), mask01 [H, W]; DDIM. Returns (image,
    composited input, decoded init latent or None, kv_hist)."""
    image_mask = _blurred_mask(mask01, mask_blur)
    composited = image
    if reference_img is not None:
        m = image_mask[None, :, :, None].to(image.dtype)
        composited = image * (1.0 - m) + reference_img * m
    init_latent = V.encode(sd.vae_params, sd.vae_cfg, composited,
                           noise=noise.enc)
    h, w = init_latent.shape[1:3]
    nmask = torch.round(resize(image_mask[:, :, None], (h, w),
                               "linear"))[None]
    if reference_img is None:
        init_latent = ((1.0 - nmask) * init_latent
                       + nmask * noise.fill).to(init_latent.dtype)
    c_concat = build_inpaint_conditioning(sd, composited, image_mask,
                                          noise.cdt)
    controls, weights = _prep_controls(control_specs, t_enc, ddim_steps)
    out, _, kv = _latent_core(
        sd, init_latent, ctx_c, ctx_u, noise.forward, t_enc=t_enc,
        ddim_steps=ddim_steps, cfg_scale=cfg_scale, sampler="ddim",
        c_concat=c_concat, nmask=nmask, renoise_gate=gates,
        renoise_noise=noise.renoise, ref_kv=ref_kv, capture_kv=capture_kv,
        final_composite=final_composite, strip=strip, controls=controls,
        control_weights=weights, sp=sp)
    init_decoded = V.decode(sd.vae_params, sd.vae_cfg, init_latent).clamp(
        -1.0, 1.0) if want_init_decoded else None
    return out, composited, init_decoded, kv


def img2img_latent_inpaint(sd: StableDiffusionBundle, warped_latent,
                           reference_img, mask, c_text: str, uc_text: str,
                           denoising_strength: float = 0.05,
                           ddim_steps: int = 50, mask_blur: int = 16,
                           guidance_schedule_func=None,
                           cfg_scale: float = 7.0, seed: int = 1234,
                           reference_kv=None, capture_kv: bool = False,
                           control_specs=()):
    """Latent-space inpaint on the inpainting model: blend the warped
    latent [1, h, w, 4] with the encoded reference [1, H, W, 3] by the
    binarised latent mask (mask [H, W], 1 = inpaint: the reference), then
    inpaint-condition on its decode and denoise with DDIM; where the last
    re-noise gate is on, the result is composited against the warped
    latent. Returns (image, decoded_latent, init_latent_decoded,
    kv_hist)."""
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    warped_latent = torch.as_tensor(warped_latent,
                                    device=sd.device).to(sd.dtype)
    reference_img = torch.as_tensor(reference_img,
                                    device=sd.device).to(sd.dtype)
    mask01 = torch.as_tensor(mask, dtype=torch.float32, device=sd.device)
    t_enc = _t_enc(denoising_strength, ddim_steps)
    gen = torch.Generator(sd.device).manual_seed(seed)
    noise = draw_inpaint_noise(gen, warped_latent.shape, t_enc,
                               has_reference=True, tile_noise=False,
                               tile_renoise=False, device=sd.device)
    image_mask = _blurred_mask(mask01, mask_blur)
    ref_latent = V.encode(sd.vae_params, sd.vae_cfg, reference_img,
                          noise=noise.enc)
    h, w = ref_latent.shape[1:3]
    nmask = torch.round(resize(image_mask[:, :, None], (h, w),
                               "linear"))[None]
    init_latent = ((1.0 - nmask) * warped_latent
                   + nmask * ref_latent).to(ref_latent.dtype)
    init_decoded = V.decode(sd.vae_params, sd.vae_cfg,
                            init_latent).clamp(-1.0, 1.0)
    c_concat = build_inpaint_conditioning(sd, init_decoded, image_mask,
                                          noise.cdt)
    gates, final = _gates(guidance_schedule_func, t_enc, ddim_steps)
    controls, weights = _prep_controls(control_specs, t_enc, ddim_steps)
    out, decoded, kv = _latent_core(
        sd, init_latent, ctx_c, ctx_u, noise.forward, t_enc=t_enc,
        ddim_steps=ddim_steps, cfg_scale=cfg_scale, sampler="ddim",
        c_concat=c_concat, nmask=nmask, renoise_gate=gates,
        renoise_noise=noise.renoise, ref_kv=reference_kv,
        capture_kv=capture_kv, controls=controls, control_weights=weights)
    if final:
        nm = nmask.to(decoded.dtype)
        decoded = warped_latent * (1.0 - nm) + decoded * nm
        out = V.decode(sd.vae_params, sd.vae_cfg, decoded).clamp(-1.0, 1.0)
    return out, decoded, init_decoded, kv


def img2img_inpaint_batch(sd: StableDiffusionBundle, images, c_texts,
                          uc_text: str, masks, reference_imgs,
                          denoising_strength: float = 0.05,
                          ddim_steps: int = 50, mask_blur: int = 16,
                          guidance_schedule_func=None,
                          cfg_scale: float = 7.0, seed: int = 1234,
                          sampler: str = "ddim", cfg_interval: int = 1,
                          mesh=None, reference_kv=None,
                          capture_kv: bool = False):
    """B independent masked-inpainting frames in one batch. The noise is
    drawn once and broadcast over the batch (the DDIM re-noise too), so
    frame i matches a single-frame ``img2img_inpaint`` fed the same
    noise.

    images / reference_imgs: [B, H, W, 3] in [-1, 1]; masks [B, H, W] in
    {0, 1}; c_texts: B prompts. ``reference_kv``: per-layer (k, v) with
    batch B (each frame injects its own references) or 1 (one set for
    all). ``cfg_interval`` > 1: CFG caching (DDIM). Returns images [B, H,
    W, 3], and with ``capture_kv`` also the batch's kv_hist (split it per
    frame with :func:`split_kv_batch`).

    ``mesh``: a DeviceMesh with a 'dp' axis (``parallel.mesh.make_mesh``)
    — data parallelism: every rank of the axis calls with the same
    arguments and denoises its B / dp frames (the same tiled noise, its
    slice of a per-frame ``reference_kv``); the images and the captured
    K/V are all-gathered, so every rank returns the whole batch."""
    check_sampler(sampler)
    images = torch.as_tensor(images, device=sd.device).to(sd.dtype)
    refs = torch.as_tensor(reference_imgs, device=sd.device).to(sd.dtype)
    masks = torch.as_tensor(masks, dtype=torch.float32, device=sd.device)
    b = images.shape[0]
    if len(c_texts) != b:
        raise ValueError(f"{len(c_texts)} prompts for {b} frames")
    t_enc = _t_enc(denoising_strength, ddim_steps)
    gates, final_composite = _gates(guidance_schedule_func, t_enc,
                                    ddim_steps)
    n_slots = sampler_coeffs(sd.sched, ddim_steps, t_enc, sampler).num_slots
    gen = torch.Generator(sd.device).manual_seed(seed)
    noise = draw_inpaint_noise(gen, _latent_shape(sd, images.shape), n_slots,
                               has_reference=True, tile_noise=True,
                               tile_renoise=sampler == "ddim",
                               device=sd.device)
    ctx_c = torch.cat([sd.get_learned_conditioning(t) for t in c_texts])
    if mesh is not None:
        shard = lambda t: PM.shard_batch(t, mesh)
        images, refs, masks, ctx_c = map(shard, (images, refs, masks, ctx_c))
        # the DPM++ re-noise is per frame ([S, B, ...]); the rest is tiled
        if noise.renoise.shape[1] == b:
            noise = noise._replace(
                renoise=shard(noise.renoise.movedim(1, 0)).movedim(0, 1))
        if reference_kv is not None:
            reference_kv = tuple(
                kv if kv is None or kv[0].shape[0] != b
                else tuple(map(shard, kv)) for kv in reference_kv)
    ctx_u = sd.get_learned_conditioning(uc_text).expand(images.shape[0], -1,
                                                        -1)
    out, _, _, kv = _inpaint_fused(
        sd, images, refs, masks, ctx_c, ctx_u, gates, reference_kv, noise,
        mask_blur=mask_blur, t_enc=t_enc, ddim_steps=ddim_steps,
        cfg_scale=cfg_scale, capture_kv=capture_kv,
        final_composite=final_composite, has_reference=True,
        want_init_decoded=False, sampler=sampler, cfg_interval=cfg_interval)
    if mesh is not None:
        out = PM.gather_batch(out, mesh)
        if kv is not None:
            kv = tuple(tuple(PM.gather_batch(t, mesh) for t in pair)
                       for pair in kv)
    return (out, kv) if capture_kv else out


def split_kv_batch(kv_hist, b: int):
    """Split a captured batch-B kv_hist into B per-frame kv_hist tuples
    (each layer's k/v sliced to batch 1, the store / injection shape)."""
    if kv_hist is None:
        return [None] * b
    return [tuple((k[i:i + 1], v[i:i + 1]) for k, v in kv_hist)
            for i in range(b)]


# ---------------------------------------------------------------------------
# txt2img and DDIM inversion
# ---------------------------------------------------------------------------

def _unet_fn(sd: StableDiffusionBundle, **kw):
    """``model_fn(x, t, ctx, control)`` of the bundle's UNet (plain CFG
    batching; ``kw`` go to ``unet_apply``). The UNet runs in the
    bundle's dtype and its output takes x's dtype, so an f32 carry stays
    f32 (see :func:`_txt2img_core`)."""
    def model_fn(x, t, ctx, control=None):
        out, _ = U.unet_apply(sd.unet_params, sd.unet_cfg, x.to(sd.dtype), t,
                              ctx, **kw)
        return out.to(x.dtype)
    return model_fn


def _txt2img_core(sd: StableDiffusionBundle, ctx_cond, ctx_uncond, x_T, *,
                  ddim_steps: int, cfg_scale: float, eta: float = 0.0,
                  sigma_noise: Optional[torch.Tensor] = None):
    """``ddim_sample`` over every step of the f32-traced DDIM schedule from
    ``x_T`` (plain CFG batching, no stem dedup, as in JAX), then the VAE
    decode, clipped to [-1, 1]. ``sigma_noise`` [ddim_steps, B, h, w, c]
    is needed where eta > 0.

    The JAX sampler draws x_T in f32, so its DDIM carry is f32 whatever
    the bundle's dtype; here too. The JAX layers then run the UNet and
    the VAE in f32 as well; here they run in the bundle's dtype (the
    card's kernels take bf16), the carry cast to it for each call."""
    ddim = make_ddim_params_traced(sd.sched, ddim_steps, eta=eta)
    lat = D.ddim_sample(
        _unet_fn(sd), sd.sched, ddim, D.CondBundle(ctx_cond),
        D.CondBundle(ctx_uncond), x_T=x_T, cfg_scale=cfg_scale,
        parameterization=sd.parameterization, sigma_noise=sigma_noise)
    img = V.decode(sd.vae_params, sd.vae_cfg, lat.to(sd.dtype))
    return img.clamp(-1.0, 1.0)


def txt2img(sd: StableDiffusionBundle, c_text: str, uc_text: str = "",
            height: int = 512, width: int = 768, ddim_steps: int = 50,
            cfg_scale: float = 7.0, eta: float = 0.0, seed: int = 1234,
            batch: int = 1):
    """Generation from pure noise: [batch, height, width, 3] in [-1, 1].
    x_T (f32) and, with eta > 0, the per-step noise are drawn from
    ``torch.Generator(sd.device).manual_seed(seed)``."""
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    if batch > 1:
        ctx_c = ctx_c.repeat(batch, 1, 1)
        ctx_u = ctx_u.repeat(batch, 1, 1)
    f = sd.vae_cfg.downscale
    shape = (batch, height // f, width // f, sd.vae_cfg.z_channels)
    gen = torch.Generator(sd.device).manual_seed(seed)
    x_T = torch.randn(shape, generator=gen, device=sd.device)
    sigma_noise = torch.randn((ddim_steps,) + shape, generator=gen,
                              device=sd.device) if eta > 0 else None
    return _txt2img_core(sd, ctx_c, ctx_u, x_T, ddim_steps=ddim_steps,
                         cfg_scale=cfg_scale, eta=eta,
                         sigma_noise=sigma_noise)


def _invert_core(sd: StableDiffusionBundle, img, ctx_cond, ctx_uncond,
                 enc_noise, *, t_enc: Optional[int], ddim_steps: int,
                 cfg_scale: float, timestep_indexing: str):
    """VAE encode (posterior sample with ``enc_noise``) then
    ``ddim_encode`` on the f32-traced DDIM schedule."""
    lat = V.encode(sd.vae_params, sd.vae_cfg, img.to(sd.dtype),
                   noise=enc_noise)
    ddim = make_ddim_params_traced(sd.sched, ddim_steps)
    return D.ddim_encode(_unet_fn(sd), sd.sched, ddim, lat,
                         D.CondBundle(ctx_cond), D.CondBundle(ctx_uncond),
                         t_enc, cfg_scale=cfg_scale,
                         timestep_indexing=timestep_indexing)


def img2img_invert(sd: StableDiffusionBundle, img, c_text: str,
                   uc_text: str = "", t_enc: Optional[int] = None,
                   ddim_steps: int = 50, cfg_scale: float = 1.0,
                   seed: int = 1234, timestep_indexing: str = "index"):
    """Deterministic DDIM inversion of an image up the noise chain; returns
    the encoded latent. ``cfg_scale`` 1 (the default) makes one
    single-batch UNet call a step. The encode's posterior noise is drawn
    from ``torch.Generator(sd.device).manual_seed(seed)``."""
    img = torch.as_tensor(img, device=sd.device)
    ctx_c = sd.get_learned_conditioning(c_text)
    ctx_u = sd.get_learned_conditioning(uc_text)
    gen = torch.Generator(sd.device).manual_seed(seed)
    enc_noise = torch.randn(_latent_shape(sd, img.shape), generator=gen,
                            device=sd.device)
    return _invert_core(sd, img, ctx_c, ctx_u, enc_noise, t_enc=t_enc,
                        ddim_steps=ddim_steps, cfg_scale=cfg_scale,
                        timestep_indexing=timestep_indexing)
