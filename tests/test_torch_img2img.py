"""Port parity: samplers (DDIM / DPM++(2M) coefficients, the multistep
engine, CFG, stochastic_encode) and the img2img slice as a whole, against
the JAX package on the same weights and the same numpy noise, on the CPU
in f32.

The slice: the port's ``_img2img_core`` against the JAX composition
``encode_moments -> mean + std*eps -> stochastic_encode(noise) ->
multistep_decode(cfg_dedup=True) -> decode`` at t_enc = 3 of 10 DDIM
steps, for both samplers. Gate: >= 80 dB PSNR on the decoded frame
(peak-to-peak 2); the measured figures are printed (-s) and recorded in
PERF.md."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import ddim as JD
from sd_animation_optical_flow_tpu.diffusion import dpm_solver as JDPM
from sd_animation_optical_flow_tpu.diffusion import multistep as JM
from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu_torch import config as TC
from sd_animation_optical_flow_tpu_torch.diffusion import ddim as TD
from sd_animation_optical_flow_tpu_torch.diffusion import dpm_solver as TDPM
from sd_animation_optical_flow_tpu_torch.diffusion import multistep as TM
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer
from torch_port_common import (jax_models, np_t, rel_err, to_port,
                               torch_configs)

JSCHED, TSCHED = JS.make_linear_schedule(), TS.make_linear_schedule()


def _coeff_fields(c):
    return [np.asarray(getattr(c, f)) for f in
            ("timesteps", "sa", "s1m", "c_x", "c_0", "w", "active",
             "out_x", "out_x0")]


@pytest.mark.parametrize("t_enc,pad_to", [(20, None), (3, 8), (1, None)])
def test_make_ddim_coeffs(t_enc, pad_to):
    jc = JM.make_ddim_coeffs(JS.make_ddim_params(JSCHED, 50), t_enc, pad_to)
    tc = TM.make_ddim_coeffs(TS.make_ddim_params(TSCHED, 50), t_enc, pad_to)
    for a, b in zip(_coeff_fields(tc), _coeff_fields(jc)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t_start,n,pad_to", [(401, 10, None), (201, 7, 12),
                                              (981, 20, None), (61, 3, 3)])
def test_dpmpp_timesteps_and_coeffs(t_start, n, pad_to):
    jts = np.asarray(JDPM.uniform_timesteps_desc(JSCHED, t_start, n))
    tts = TDPM.uniform_timesteps_desc(TSCHED, t_start, n)
    np.testing.assert_array_equal(tts, jts)
    jc = JM.make_dpmpp_coeffs(JSCHED, jts, pad_to)
    tc = TM.make_dpmpp_coeffs(TSCHED, tts, pad_to)
    for a, b in zip(_coeff_fields(tc), _coeff_fields(jc)):
        np.testing.assert_array_equal(a, b)


def test_stochastic_encode_and_cfg(np_rng):
    x0 = np_rng.standard_normal((2, 4, 5, 4)).astype(np.float32)
    noise = np_rng.standard_normal(x0.shape).astype(np.float32)
    jd, td = JS.make_ddim_params(JSCHED, 50), TS.make_ddim_params(TSCHED, 50)
    ref = JD.stochastic_encode(jd, jnp.asarray(x0), 20, jnp.asarray(noise))
    out = TD.stochastic_encode(td, np_t(x0), 20, np_t(noise))
    assert rel_err(out, ref) < 1e-6

    # a linear toy model: eps = 0.1 * x + mean(ctx) (per batch row)
    ctx = np_rng.standard_normal((2, 3, 5)).astype(np.float32)
    jfn = lambda x, t, c, control=None: 0.1 * x + (
        jnp.concatenate(c) if isinstance(c, tuple) else c).mean(
            axis=(1, 2))[:, None, None, None]
    tfn = lambda x, t, c, control=None: 0.1 * x + (
        torch.cat(c) if isinstance(c, tuple) else c).mean(
            dim=(1, 2))[:, None, None, None]
    for dedup in (False, True):
        xs = x0[:1]
        ref = JD.cfg_model_call(
            jfn, jnp.asarray(xs), jnp.ones(1), JD.CondBundle(
                jnp.asarray(ctx[1:])), JD.CondBundle(jnp.asarray(ctx[:1])),
            7.0, dedup=dedup)
        out = TD.cfg_model_call(
            tfn, np_t(xs), torch.ones(1), TD.CondBundle(np_t(ctx[1:])),
            TD.CondBundle(np_t(ctx[:1])), 7.0, dedup=dedup)
        assert rel_err(out, ref) < 1e-6


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_multistep_decode_toy_model(np_rng, sampler):
    x = np_rng.standard_normal((1, 4, 5, 4)).astype(np.float32)
    ctx = np_rng.standard_normal((2, 3, 5)).astype(np.float32)
    if sampler == "ddim":
        args = (JM.make_ddim_coeffs(JS.make_ddim_params(JSCHED, 50), 5, 7),
                TM.make_ddim_coeffs(TS.make_ddim_params(TSCHED, 50), 5, 7))
    else:
        ts = np.asarray(JDPM.uniform_timesteps_desc(JSCHED, 401, 6))
        args = (JM.make_dpmpp_coeffs(JSCHED, ts, 8),
                TM.make_dpmpp_coeffs(TSCHED, ts, 8))
    # a toy eps-model of the dedup contract: half batch in, [u|c] out
    def jfn(x, t, c, control=None):
        xx, tt = jnp.concatenate([x, x]), jnp.concatenate([t, t])
        return jnp.tanh(xx) * (tt[:, None, None, None] / 1000.0) \
            + jnp.concatenate(c).mean(axis=(1, 2))[:, None, None, None]

    def tfn(x, t, c, control=None):
        xx, tt = torch.cat([x, x]), torch.cat([t, t])
        return torch.tanh(xx) * (tt[:, None, None, None] / 1000.0) \
            + torch.cat(c).mean(dim=(1, 2))[:, None, None, None]

    ref = JM.multistep_decode(jfn, args[0], jnp.asarray(x),
                              JD.CondBundle(jnp.asarray(ctx[1:])),
                              JD.CondBundle(jnp.asarray(ctx[:1])),
                              cfg_scale=7.0, cfg_dedup=True)
    out = TM.multistep_decode(tfn, args[1], np_t(x),
                              TD.CondBundle(np_t(ctx[1:])),
                              TD.CondBundle(np_t(ctx[:1])),
                              cfg_scale=7.0, cfg_dedup=True)
    assert rel_err(out, ref) < 1e-5
    # eps and v (v needs the schedule; held to JAX's dpmpp_2m_decode in
    # test_torch_samplers.py); any other parameterization is refused
    for kw, match in ((dict(parameterization="x0"), "eps- or v"),
                      (dict(parameterization="v"), "sched")):
        with pytest.raises(ValueError, match=match):
            TM.multistep_decode(tfn, args[1], np_t(x),
                                TD.CondBundle(np_t(ctx[1:])),
                                TD.CondBundle(np_t(ctx[:1])), **kw)


@pytest.fixture(scope="module")
def bundles():
    (ju, jv, jc), (up, vp, cp) = jax_models(seed=5)
    tu, tv, tc = torch_configs()
    sd = TF.StableDiffusionBundle(
        unet_params=to_port(up), unet_cfg=tu, vae_params=to_port(vp),
        vae_cfg=tv, clip_params=to_port(cp), clip_cfg=tc,
        tokenizer=PromptTokenizer(hf_name_or_path=None), device="cpu")
    return (ju, jv, up, vp), sd


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp:3"])
def test_img2img_slice_matches_jax(bundles, np_rng, sampler):
    (ju, jv, up, vp), sd = bundles
    t_enc, steps = 3, 10
    img = np_rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    ctx_c = np_rng.standard_normal((1, 231, 64)).astype(np.float32)
    ctx_u = np_rng.standard_normal((1, 231, 64)).astype(np.float32)
    enc_noise = np_rng.standard_normal((1, 8, 12, 4)).astype(np.float32)
    noise = np_rng.standard_normal((1, 8, 12, 4)).astype(np.float32)

    ddim = JS.make_ddim_params(JSCHED, steps)
    if sampler == "ddim":
        coeffs = JM.make_ddim_coeffs(ddim, t_enc)
    else:
        dts = JDPM.uniform_timesteps_desc(JSCHED, int(ddim.timesteps[t_enc]),
                                          3)
        coeffs = JM.make_dpmpp_coeffs(JSCHED, np.asarray(dts))

    def jax_slice(up, vp, img, ctx_c, ctx_u, enc_noise, noise):
        mean, logvar = JV.encode_moments(vp, jv, img)
        lat = (mean + jnp.exp(0.5 * logvar) * enc_noise) * jv.scale_factor
        x1 = JD.stochastic_encode(ddim, lat, t_enc, noise)

        def model_fn(x, t, c, control=None):
            return JU.unet_apply(up, ju, x, t, None, context_pair=c)[0]
        out = JM.multistep_decode(model_fn, coeffs, x1,
                                  JD.CondBundle(ctx_c), JD.CondBundle(ctx_u),
                                  cfg_scale=7.0, cfg_dedup=True)
        return jnp.clip(JV.decode(vp, jv, out), -1, 1), out

    ref_img, ref_lat = jax.jit(jax_slice)(
        up, vp, *map(jnp.asarray, (img, ctx_c, ctx_u, enc_noise, noise)))
    out_img, out_lat, kv = TF._img2img_core(
        sd, np_t(img), np_t(ctx_c), np_t(ctx_u), np_t(enc_noise),
        np_t(noise), t_enc=t_enc, ddim_steps=steps, cfg_scale=7.0,
        sampler=sampler)
    psnr = _psnr(out_img, ref_img)
    print(f"\n[slice {sampler}] decoded-frame PSNR {psnr:.1f} dB, latent "
          f"rel err {rel_err(out_lat, ref_lat):.2e}")
    assert out_img.shape == ref_img.shape == (1, 32, 48, 3) and kv is None
    assert psnr >= 80.0
    assert rel_err(out_lat, ref_lat) < 1e-4


def test_img2img_api_on_cpu(bundles):
    """The public entry point end to end on the CPU: seeded noise is
    deterministic, both samplers run, and an ``sp`` that is not a
    SeqParallelConfig and bad sampler strings are refused at the
    boundary."""
    _, sd = bundles
    img = torch.rand((1, 32, 48, 3)) * 2 - 1
    a, kv = TF.img2img(sd, img, "a fox", "", 0.4, ddim_steps=5, seed=7)
    b, _ = TF.img2img(sd, img, "a fox", "", 0.4, ddim_steps=5, seed=7)
    c, _ = TF.img2img(sd, img, "a fox", "", 0.4, ddim_steps=5, seed=7,
                      sampler="dpmpp:2")
    assert kv is None and a.shape == (1, 32, 48, 3)
    assert torch.equal(a, b) and torch.isfinite(c).all()
    assert a.abs().max() <= 1.0
    for bad in ("ddpm", "dpm", "dpmpp:", "dpmpp:x", "dpmpp:0", "DDIM"):
        with pytest.raises(ValueError, match="sampler"):
            TF.img2img(sd, img, "a fox", "", sampler=bad)
    with pytest.raises(TypeError, match="SeqParallelConfig"):
        TF.img2img(sd, img, "a fox", "", sp=object())


def test_create_model_boundaries(tmp_path):
    with pytest.raises(FileNotFoundError):
        TC.create_model("sd15", ckpt_path=str(tmp_path / "absent.ckpt"),
                        device="cpu")
    assert TC.load_spec(os.path.join(TC.CONFIG_DIR, "sd15.yaml")) == TC.SD15
    depth, up = TC.load_spec("sd15-depth"), TC.load_spec("sd-upscale")
    assert depth.unet.in_channels == 5 and depth.unet.num_classes is None
    assert up.unet.in_channels == 7 and up.unet.num_classes == 1000
    assert TC.load_spec("sd15-inpaint9").unet.in_channels == 9
    assert TC.load_spec("sd15-inpaint9").conditioning_key == "hybrid"
    spec = TC.load_spec("sd15")
    assert spec.unet.model_channels == 320 and spec.vae.ch == 128 \
        and spec.clip.width == 768 and spec.scale_factor == 0.18215
