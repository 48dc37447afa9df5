"""Port parity: the inpainting path — resize, mask blur, the fill,
``q_sample``, the K/V store helpers, ``_inpaint_fused`` (both samplers,
with and without injected K/V, with K/V capture, and the no-reference
fill path) and ``img2img_inpaint_batch`` with per-frame K/V — against the
JAX package on the CPU in f32.

Every noise the JAX program draws inside ``_inpaint_fused`` (the two
posterior noises, the fill noise, the forward noise, the per-step
re-noise) is rebuilt here along the same key splits and handed to the
port as tensors. Gates: helpers within 1e-5 of the output's scale (the
rounded masks exactly); the decoded frame >= 80 dB PSNR (peak-to-peak 2)
and every captured K/V pair within 1e-4 of its scale, at t_enc = 3 of 10
steps (the JAX compiles stay short). The facades are also driven on the
CPU end to end (capture -> injection)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.ops import filters as JFI
from sd_animation_optical_flow_tpu.ops import resize as JR
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import keyframe_inpaint as JKI
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu_torch.diffusion import ddim as TD
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.ops import filters as TFI
from sd_animation_optical_flow_tpu_torch.ops import resize as TR
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines import \
    keyframe_inpaint as TKI
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from torch_port_common import (UNET_KW, jax_models, np_t,
                               perturb_zero_convs, rel_err, to_port,
                               torch_configs)

H, W, STEPS, T_ENC = 32, 48, 10, 3


def _blob(shape, center, radius):
    """A disc mask (1 inside): edges off the pixel grid, so no latent
    pixel of the blurred, resized mask sits at exactly 0.5."""
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    return (((yy - center[0]) ** 2 + (xx - center[1]) ** 2)
            < radius ** 2).astype(np.float32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,src,dst", [
    ("linear", (32, 48), (8, 12)), ("linear", (8, 12), (32, 48)),
    ("nearest", (32, 48), (8, 12)), ("area", (40, 24), (5, 3)),
    ("area", (10, 14), (23, 9))])      # area upscale: the linear path
def test_resize_matches_jax(np_rng, mode, src, dst):
    x = np_rng.uniform(size=(2,) + src + (3,)).astype(np.float32)
    np.testing.assert_array_equal(TR.resize_matrix(src[0], dst[0], mode),
                                  JR.resize_matrix(src[0], dst[0], mode))
    ref = JR.resize(jnp.asarray(x), dst, mode)
    assert rel_err(TR.resize(np_t(x), dst, mode), ref) < 1e-5


def test_gaussian_blur_and_fill_match_jax(np_rng):
    m = _blob((H, W), (13.3, 21.7), 9.1)
    for sigma in (4.0, 1.5):
        ref = JFI.gaussian_blur(jnp.asarray(m), sigma)
        assert rel_err(TFI.gaussian_blur(np_t(m), sigma), ref) < 1e-5
    np.testing.assert_array_equal(TFI.gaussian_kernel_1d(2.0),
                                  JFI.gaussian_kernel_1d(2.0))
    img = np_rng.uniform(-1, 1, (1, 64, 80, 3)).astype(np.float32)
    hole = _blob((64, 80), (30.2, 41.6), 17.3)[None]
    ref = JFI.fill_masked(jnp.asarray(img), jnp.asarray(hole))
    out = TFI.fill_masked(np_t(img), np_t(hole))
    assert out.shape == img.shape and rel_err(out, ref) < 1e-5


def test_build_inpaint_conditioning_matches_jax(models, np_rng):
    jsd, tsd = models
    img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    mask = _blob((H, W), (10.4, 30.2), 7.6)
    key = jax.random.PRNGKey(2)
    ref = JF.build_inpaint_conditioning(jsd, jnp.asarray(img),
                                        jnp.asarray(mask), key)
    # the JAX encode draws its posterior noise at the latent's shape
    noise = np_t(jax.random.normal(key, (1, H // 4, W // 4, 4)))
    out = TF.build_inpaint_conditioning(tsd, np_t(img), np_t(mask), noise)
    assert out.shape == (1, H // 4, W // 4, 5)
    np.testing.assert_array_equal(out[..., 0].numpy(),
                                  np.asarray(ref[..., 0]))
    assert rel_err(out, ref) < 1e-5


def test_q_sample_and_progress_match_jax(np_rng):
    x0 = np_rng.standard_normal((2, 4, 6, 4)).astype(np.float32)
    noise = np_rng.standard_normal((1, 4, 6, 4)).astype(np.float32)
    t = np.asarray([1, 781], np.int32)
    ref = JS.q_sample(JS.make_linear_schedule(), jnp.asarray(x0),
                      jnp.asarray(t), jnp.asarray(noise))
    out = TS.q_sample(TS.make_linear_schedule(), np_t(x0),
                      torch.from_numpy(t), np_t(noise))
    assert rel_err(out, ref) < 1e-6
    from sd_animation_optical_flow_tpu.diffusion import ddim as JD
    np.testing.assert_array_equal(TD.guidance_progress(7, 20),
                                  JD.guidance_progress(7, 20))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q_sample_host_timestep_matches_tensor_path(np_rng, dtype):
    """The re-noise hook's host-int timestep gives the [B]-tensor path's
    values exactly (the same scalars rounded to x0's dtype)."""
    x0 = torch.from_numpy(np_rng.standard_normal((2, 4, 6, 4)).astype(
        np.float32)).to(dtype)
    noise = torch.from_numpy(np_rng.standard_normal((1, 4, 6, 4)).astype(
        np.float32)).to(dtype)
    sched = TS.make_linear_schedule()
    for t in (1, 521, 981):
        out = TS.q_sample(sched, x0, t, noise)
        ref = TS.q_sample(sched, x0, torch.full((2,), t, dtype=torch.int32),
                          noise)
        assert out.dtype == dtype
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_kv_store_helpers_match_jax(np_rng):
    kvs = [tuple((np_rng.standard_normal((2, n, 8)).astype(np.float32),
                  np_rng.standard_normal((2, n, 8)).astype(np.float32))
                 for n in (12, 3)) for _ in range(2)]
    ref = JKI.concat_ref_kv([None] + [jax.tree.map(jnp.asarray, kv)
                                      for kv in kvs])
    out = TKI.concat_ref_kv([None] + [tuple((np_t(k), np_t(v))
                                            for k, v in kv) for kv in kvs])
    assert TKI.concat_ref_kv([None]) is None
    for (ko, vo), (kr, vr) in zip(out, ref):
        np.testing.assert_array_equal(ko.numpy(), np.asarray(kr))
        np.testing.assert_array_equal(vo.numpy(), np.asarray(vr))
    frames_t, frames_j = TF.split_kv_batch(out, 2), JF.split_kv_batch(ref, 2)
    assert TF.split_kv_batch(None, 3) == [None] * 3
    for ft, fj in zip(frames_t, frames_j):
        for (kt, vt), (kj, vj) in zip(ft, fj):
            assert kt.shape[0] == 1
            np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


# ---------------------------------------------------------------------------
# the inpaint program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The inpainting model (9-channel UNet) in both frameworks on shared
    weights, plus the JAX and port bundles around them."""
    from sd_animation_optical_flow_tpu.models import unet as JU
    from sd_animation_optical_flow_tpu.models.layers import numpy_init
    (_, jv, jc), (_, vp, cp) = jax_models(seed=6)
    ju = JU.UNetConfig(in_channels=9, **UNET_KW)
    with numpy_init():
        up = JU.unet_init(jax.random.PRNGKey(6), ju)
    perturb_zero_convs(up, np.random.default_rng(6))
    _, tv, tc = torch_configs()
    jsd = JF.StableDiffusionBundle(
        unet_params=up, unet_cfg=ju, vae_params=vp, vae_cfg=jv,
        clip_params=cp, clip_cfg=jc, tokenizer=JTok(hf_name_or_path=None))
    tsd = TF.StableDiffusionBundle(
        unet_params=to_port(up), unet_cfg=TU.UNetConfig(in_channels=9,
                                                        **UNET_KW),
        vae_params=to_port(vp), vae_cfg=tv, clip_params=to_port(cp),
        clip_cfg=tc, tokenizer=TTok(hf_name_or_path=None), device="cpu")
    return jsd, tsd


def jax_noise(seed, lat_shape, t_enc, n_slots, sampler, *, tile_noise,
              has_reference):
    """The noises of the JAX ``_inpaint_fused`` for PRNGKey(seed), rebuilt
    along its key splits, as the port's InpaintNoise."""
    k_enc, k_cdt, k_rand, k_core = jax.random.split(jax.random.PRNGKey(seed),
                                                    4)
    one = (1,) + tuple(lat_shape[1:])
    full = tuple(lat_shape)
    normal = lambda k, s: np_t(jax.random.normal(k, s, jnp.float32))
    k_noise, k_decode, _ = jax.random.split(k_core, 3)
    if sampler == "ddim":
        renoise = [normal(jax.random.split(k)[0], one if tile_noise else full)
                   for k in jax.random.split(k_decode, t_enc)]
    else:
        renoise = [normal(k, full)
                   for k in jax.random.split(k_decode, n_slots)]
    return TF.InpaintNoise(
        enc=normal(k_enc, one), cdt=normal(k_cdt, one),
        fill=None if has_reference else normal(k_rand, full),
        forward=normal(k_noise, one if tile_noise else full),
        renoise=torch.stack(renoise))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


def _kv_close(kv_t, kv_j):
    assert len(kv_t) == len(kv_j)
    for (kt, vt), (kj, vj) in zip(kv_t, kv_j):
        assert kt.shape == kj.shape and kt.is_contiguous()
        assert rel_err(kt, kj) < 1e-4 and rel_err(vt, vj) < 1e-4


def _ref_kv(np_rng, tsd, batch):
    """Random reference K/V of two frames, in the capture's layer shapes."""
    _, kv = TU.unet_apply(tsd.unet_params, tsd.unet_cfg,
                          torch.zeros((1, H // 4, W // 4, 9)),
                          torch.ones(1, dtype=torch.int32),
                          torch.zeros((1, 7, 64)))
    return tuple(tuple(np_rng.standard_normal(
        (batch, 2 * k.shape[1], k.shape[2])).astype(np.float32)
        for _ in range(2)) for k, _ in kv)


@pytest.mark.parametrize("sampler,inject,has_reference", [
    ("ddim", True, True),       # K/V injection + capture
    ("dpmpp:3", False, True),   # the other sampler, capture
    ("ddim", False, False)])    # the fill path (no reference image)
def test_inpaint_fused_matches_jax(models, np_rng, sampler, inject,
                                   has_reference):
    jsd, tsd = models
    seed = 11
    img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    ref_img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    mask = _blob((H, W), (14.6, 22.3), 8.7)[None]
    ctx_c, ctx_u = (np_rng.standard_normal((1, 231, 64)).astype(np.float32)
                    for _ in range(2))
    # a gate schedule that switches the re-noise off for the last step
    gates = np.asarray([0.1, 0.1, 0.0], np.float32)
    final_composite = sampler != "ddim"
    rkv = _ref_kv(np_rng, tsd, 1) if inject else None
    n_slots = TF.sampler_coeffs(tsd.sched, STEPS, T_ENC, sampler).num_slots
    kw = dict(mask_blur=2, t_enc=T_ENC, ddim_steps=STEPS, cfg_scale=7.0,
              capture_kv=has_reference, final_composite=final_composite,
              has_reference=has_reference, want_init_decoded=True,
              sampler=sampler)

    ref = JF._inpaint_fused(
        jsd.unet_params, jsd.unet_cfg, jsd.vae_params, jsd.vae_cfg,
        jsd.sched, jnp.asarray(img), jnp.asarray(ref_img if has_reference
                                                 else img),
        jnp.asarray(mask), jnp.asarray(ctx_c), jnp.asarray(ctx_u),
        jnp.asarray(gates), None if rkv is None
        else jax.tree.map(jnp.asarray, rkv), jax.random.PRNGKey(seed),
        parameterization="eps", tile_noise=False, **kw)
    noise = jax_noise(seed, (1, H // 4, W // 4, 4), T_ENC, n_slots, sampler,
                      tile_noise=False, has_reference=has_reference)
    out = TF._inpaint_fused(
        tsd, np_t(img), np_t(ref_img if has_reference else img), np_t(mask),
        np_t(ctx_c), np_t(ctx_u), gates, None if rkv is None
        else tuple((np_t(k), np_t(v)) for k, v in rkv), noise, **kw)
    psnr = _psnr(out[0], ref[0])
    print(f"\n[inpaint {sampler} inject={inject} ref={has_reference}] "
          f"decoded-frame PSNR {psnr:.1f} dB")
    assert out[0].shape == (1, H, W, 3) and psnr >= 80.0
    assert rel_err(out[1], ref[1]) < 1e-5            # composited input
    assert _psnr(out[2], ref[2]) >= 80.0             # decoded init latent
    if has_reference:
        _kv_close(out[3], ref[3])
    else:
        assert out[3] is None and ref[3] is None


def test_inpaint_batch_per_frame_kv_matches_jax(models, np_rng,
                                                monkeypatch):
    """img2img_inpaint_batch with per-frame reference K/V (batch 2) and
    K/V capture against the JAX facade, the port fed the JAX noises."""
    jsd, tsd = models
    b = 2
    imgs = np_rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    refs = np_rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    masks = np.stack([_blob((H, W), (12.4, 19.2), 7.7),
                      _blob((H, W), (18.1, 30.6), 9.3)])
    rkv = _ref_kv(np_rng, tsd, b)
    kw = dict(denoising_strength=0.3, ddim_steps=STEPS, mask_blur=2,
              capture_kv=True)
    ref_out, ref_kv = JF.img2img_inpaint_batch(
        jsd, imgs, ["a fox", "a cat"], "", masks, refs,
        reference_kv=jax.tree.map(jnp.asarray, rkv), **kw)
    noise = jax_noise(1234, (b, H // 4, W // 4, 4), T_ENC, T_ENC, "ddim",
                      tile_noise=True, has_reference=True)
    monkeypatch.setattr(TF, "draw_inpaint_noise", lambda *a, **k: noise)
    out, kv = TF.img2img_inpaint_batch(
        tsd, imgs, ["a fox", "a cat"], "", masks, refs,
        reference_kv=tuple((np_t(k), np_t(v)) for k, v in rkv), **kw)
    psnr = _psnr(out, ref_out)
    print(f"\n[inpaint batch, per-frame K/V] PSNR {psnr:.1f} dB")
    assert out.shape == (b, H, W, 3) and psnr >= 80.0
    _kv_close(kv, ref_kv)


def test_facades_on_cpu(models):
    """The public entry points end to end on the CPU: capture K/V with
    img2img on the 4-channel model, inject them into an inpaint on the
    9-channel model, batch it, render a strip; the output contract holds
    and the hooks that are not ported are refused."""
    _, tsd9 = models
    (_, _, _), (up, vp, cp) = jax_models(seed=5)
    tu, tv, tc = torch_configs()
    tsd = TF.StableDiffusionBundle(
        unet_params=to_port(up), unet_cfg=tu, vae_params=to_port(vp),
        vae_cfg=tv, clip_params=to_port(cp), clip_cfg=tc,
        tokenizer=TTok(hf_name_or_path=None), device="cpu")
    g = torch.Generator().manual_seed(0)
    key_a, key_b = (torch.rand((1, H, W, 3), generator=g) * 2 - 1
                    for _ in range(2))
    kvs = []
    for key in (key_a, key_b):
        out, kv = TF.img2img(tsd, key, "a fox", "", 0.4, ddim_steps=5,
                             capture_kv=True)
        assert out.shape == (1, H, W, 3) and out.abs().max() <= 1.0
        assert len(kv) == 11 and all(k.is_contiguous() for k, _ in kv)
        kvs.append(kv)
    ref_kv = TKI.concat_ref_kv(kvs)
    assert ref_kv[0][0].shape == (1, 2 * (H // 4) * (W // 4), 32)

    mask = torch.from_numpy(_blob((H, W), (16.2, 24.5), 9.4))
    out, comp, init_dec, kv = TF.img2img_inpaint(
        tsd9, key_b, "a fox", "", 0.8, ddim_steps=5, reference_img=key_a,
        mask=mask, mask_blur=4, reference_kv=ref_kv, capture_kv=True)
    assert out.shape == comp.shape == init_dec.shape == (1, H, W, 3)
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0
    assert len(kv) == 11 and kv[0][0].shape == (1, (H // 4) * (W // 4), 32)
    fill, _, _, _ = TF.img2img_inpaint(tsd9, key_b, "a fox", "",
                                       ddim_steps=4, mask=mask)
    assert torch.isfinite(fill).all()

    batch = torch.cat([key_a, key_b])
    masks = torch.stack([mask, mask])
    outs, bkv = TF.img2img_inpaint_batch(
        tsd9, batch, ["a fox", "a fox"], "", masks, batch.flip(0),
        denoising_strength=0.4, ddim_steps=5, capture_kv=True,
        reference_kv=tuple((torch.cat([k, k]), torch.cat([v, v]))
                           for k, v in ref_kv))
    frames = TF.split_kv_batch(bkv, 2)
    assert outs.shape == (2, H, W, 3) and frames[1][0][0].shape[0] == 1
    one, _, _, _ = TF.img2img_inpaint(
        tsd9, key_b, "a fox", "", 0.4, ddim_steps=5, reference_img=key_a,
        mask=mask, reference_kv=ref_kv, want_init_decoded=False)
    # the batch draws its noise once for all frames, so frame 1 is the
    # single-frame call with the same seed
    assert rel_err(outs[1], one[0]) < 1e-4

    strip = torch.cat([key_a, key_b], dim=2)
    s_out, s_kv = TF.img2img(tsd, strip, "a fox", "", 0.8, ddim_steps=5,
                             strip=TU.StripConfig(2, "mutual"),
                             capture_kv=True)
    assert s_out.shape == (1, H, 2 * W, 3) and len(s_kv) == 11
    t_out, _, _, _ = TF.img2img_inpaint(
        tsd9, strip, "a fox", "", 0.8, ddim_steps=5, reference_img=strip,
        mask=torch.cat([mask, torch.zeros_like(mask)], dim=1),
        strip=TU.StripConfig(2, "target"))
    assert t_out.shape == (1, H, 2 * W, 3) and torch.isfinite(t_out).all()

    with pytest.raises(TypeError, match="SeqParallelConfig"):
        TF.img2img_inpaint(tsd9, key_b, "", "", mask=mask, sp=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        TF.img2img_inpaint_batch(tsd9, batch, ["", ""], "", masks, batch,
                                 mesh=object())
    with pytest.raises(ValueError, match="mask"):
        TF.img2img_inpaint(tsd9, key_b, "", "")
