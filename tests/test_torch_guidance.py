"""Port parity: the hook-carrying ``ddim_decode`` and the facades' hooks
(guidance blending in latent and pixel space, ControlNet, CFG caching,
DeepCache) against the JAX package on the CPU in f32.

``ddim_decode``: one hook at a time on a toy eps-model (cheap to trace),
every stochastic term rebuilt along the JAX decode's key splits and
handed to the port as a tensor stack. Gate: the final latent within 1e-4
of its scale.

The facades: the tiny bundles of ``tests/test_torch_pixel.py`` (a
4-channel and a 9-channel UNet, their zero-initialised output convs
perturbed, and a ControlNet of their config) at t_enc = 3 of 10 DDIM
steps, the port fed the JAX program's noises. Gate: >= 80 dB PSNR
(peak-to-peak 2) on the decoded frame; the pixel pipeline's ``run``
with ``cfg_interval=2`` against the JAX ``run`` on its converted frames
at >= 40 dB (peak 255), the gate of ``tests/test_torch_pixel.py``.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import ddim as JD
from sd_animation_optical_flow_tpu.diffusion import sampling_util as JSU
from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.models import controlnet as JCN
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import pixel_inpaint as JPI
from sd_animation_optical_flow_tpu_torch.diffusion import ddim as TD
from sd_animation_optical_flow_tpu_torch.diffusion import \
    sampling_util as TSU
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.models import controlnet as TCN
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines import \
    pixel_inpaint as TPI
from test_pipeline import _synthetic_frames
from test_torch_inpaint import jax_noise
from test_torch_pixel import (KW, _converted_psnr, _jax_noises,
                              _tiny_bundles, tiny)  # noqa: F401
from torch_port_common import np_t, perturb_zero_convs, rel_err, to_port

JSCHED, TSCHED = JS.make_linear_schedule(), TS.make_linear_schedule()
H, W, STEPS, T_ENC = 32, 48, 10, 3
LAT = (H // 2, W // 2)          # the tiny VAE downscales by 2


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


def test_norm_thresholding_matches_jax(np_rng):
    x0 = np_rng.standard_normal((3, 4, 5, 4)).astype(np.float32)
    x0[1] *= 0.1                          # one element under the threshold
    out = TSU.norm_thresholding(np_t(x0), 0.8)
    assert rel_err(out, JSU.norm_thresholding(jnp.asarray(x0), 0.8)) < 1e-6
    assert torch.equal(out[1], np_t(x0[1]))
    assert TSU.append_dims(torch.zeros(3), 4).shape == (3, 1, 1, 1)
    with pytest.raises(ValueError, match="target_dims"):
        TSU.append_dims(torch.zeros(3, 2), 1)


# ---------------------------------------------------------------------------
# ddim_decode on a toy model, one hook at a time
# ---------------------------------------------------------------------------

def _toy(xp):
    """A toy eps-model in framework ``xp`` (jnp or torch): full CFG batch
    or the dedup pair, optional concat channels and control residuals."""
    cat = (lambda a: jnp.concatenate(a, 0)) if xp is jnp else torch.cat

    def fn(x, t, ctx, control=None):
        if isinstance(ctx, tuple):
            x, t, ctx = cat([x, x]), cat([t, t]), cat(list(ctx))
        lat = x[..., :4]
        e = xp.tanh(0.7 * lat + ctx.mean((1, 2))[:, None, None, None]) \
            * (t[:, None, None, None] / 1000.0)
        if x.shape[-1] > 4:
            e = e + 0.05 * x[..., 4:].sum(-1, keepdims=True)
        if control is not None:
            e = e + 0.1 * control[0] + 0.05 * control[-1]
        return e
    return fn


def _toy_vae(xp):
    """(encode(x, noise-or-key), decode(z)) in framework ``xp``: decode
    repeats the latent up 2x; encode pools it back and adds 0.1 noise."""
    if xp is jnp:
        def enc(x, k):
            b, h, w, _ = x.shape
            m = x.reshape(b, h // 2, 2, w // 2, 2, 3).mean((2, 4))
            m = jnp.concatenate([m, m[..., :1]], -1)
            return m + 0.1 * jax.random.normal(k, m.shape, m.dtype)
        dec = lambda z: jnp.tanh(jnp.repeat(jnp.repeat(z[..., :3], 2, 1),
                                            2, 2))
    else:
        def enc(x, n):
            b, h, w, _ = x.shape
            m = x.reshape(b, h // 2, 2, w // 2, 2, 3).mean((2, 4))
            return torch.cat([m, m[..., :1]], -1) + 0.1 * n
        dec = lambda z: torch.tanh(z[..., :3].repeat_interleave(
            2, 1).repeat_interleave(2, 2))
    return enc, dec


def _step_noises(rng, t_enc, shape, *, inpaint, pixel, tile, dropout=0.0):
    """The per-step noises of the JAX ddim_decode for ``rng``, along its
    key splits, as port tensor stacks."""
    one = (1,) + shape[1:] if tile else shape
    out = {"renoise": [], "guide": [], "guide_enc": [], "sigma": [],
           "keep": []}
    for key in jax.random.split(rng, t_enc):
        if inpaint:
            k_noise, key = jax.random.split(key)
            out["renoise"].append(jax.random.normal(k_noise, one))
        if pixel:
            k_g, k_e, key = jax.random.split(key, 3)
            out["guide"].append(jax.random.normal(k_g, shape))
            out["guide_enc"].append(jax.random.normal(k_e, shape))
        k_sig, k_drop = jax.random.split(key)
        out["sigma"].append(jax.random.normal(k_sig, one))
        out["keep"].append(jax.random.bernoulli(k_drop, 1.0 - dropout,
                                                shape))
    return {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
            for k, v in out.items() if v}


HOOKS = ["plain", "inpaint_tiled", "latent_guidance", "pixel_guidance",
         "controls", "cfg_interval", "deepcache", "dedup", "v",
         "sampler_options"]


@pytest.mark.parametrize("hook", HOOKS)
def test_ddim_decode_hook_matches_jax(np_rng, hook):
    t_enc, b = 4, 2 if hook == "inpaint_tiled" else 1
    shape = (b, 4, 6, 4)
    x = np_rng.standard_normal(shape).astype(np.float32)
    ctx = np_rng.standard_normal((2 * b, 3, 5)).astype(np.float32)
    eta = 0.5 if hook == "sampler_options" else 0.0
    jddim = JS.make_ddim_params(JSCHED, 10, eta=eta)
    tddim = TS.make_ddim_params(TSCHED, 10, eta=eta)
    rng = jax.random.PRNGKey(3)
    jkw, tkw = {}, {}
    concat = None

    def both(name, a, to_t=np_t):
        jkw[name], tkw[name] = jnp.asarray(a), to_t(a)

    if hook == "inpaint_tiled":
        both("init_latent", np_rng.standard_normal(shape).astype(np.float32))
        both("nmask", (np_rng.uniform(size=(1, 4, 6, 1)) > 0.5)
             .astype(np.float32))
        both("renoise_gate", np.asarray([0.1, 0.1, 0.0, 0.1], np.float32),
             to_t=np.asarray)
        jkw["tile_noise"] = True
    if hook in ("latent_guidance", "pixel_guidance"):
        both("guidance_latent",
             np_rng.standard_normal(shape).astype(np.float32))
        both("guidance_strength", np_rng.uniform(
            0, 0.6, (t_enc, 1, 4, 6, 1)).astype(np.float32))
        jkw["guidance_space"] = tkw["guidance_space"] = hook.split("_")[0]
        if hook == "pixel_guidance":
            jkw["pixel_fns"], tkw["pixel_fns"] = _toy_vae(jnp), _toy_vae(torch)
    if hook in ("controls", "cfg_interval"):
        res = [tuple(np_rng.standard_normal((2 * b,) + shape[1:])
                     .astype(np.float32) for _ in range(3)) for _ in range(2)]
        jkw["control_residuals"] = [tuple(map(jnp.asarray, r)) for r in res]
        tkw["control_residuals"] = [tuple(map(np_t, r)) for r in res]
        w = np.asarray([[0.7, 0.3]] * (t_enc - 1) + [[0.7, 0.0]],
                       np.float32)
        both("control_weights", w, to_t=np.asarray)
    if hook == "cfg_interval":
        jkw["cfg_interval"] = tkw["cfg_interval"] = 2
        concat = np_rng.standard_normal(shape[:3] + (5,)).astype(np.float32)
    if hook == "deepcache":
        def fns(xp):
            def deep(x, t, ctx):
                return xp.tanh(0.5 * x) + ctx.mean((1, 2))[:, None, None,
                                                            None]

            def out(x, t, d):
                return d * (t[:, None, None, None] / 1000.0) + 0.1 * x
            return ((lambda x, t, c: (out(x, t, deep(x, t, c)),
                                      deep(x, t, c))),
                    (lambda x, t, c, d: out(x, t, d)))
        jkw["deepcache_interval"] = tkw["deepcache_interval"] = 3
        jkw["deepcache_fns"], tkw["deepcache_fns"] = fns(jnp), fns(torch)
        jkw["deepcache_init"] = jnp.zeros((2 * b,) + shape[1:])
    if hook in ("dedup", "controls"):
        jkw["cfg_dedup"] = tkw["cfg_dedup"] = True
    if hook == "v":
        jkw["parameterization"] = tkw["parameterization"] = "v"
    if hook == "sampler_options":
        sched = np.asarray([7.0, 5.0, 3.0, 6.0], np.float32)
        both("cfg_schedule", sched, to_t=np.asarray)
        jkw["score_fn"] = lambda e, x, t, i: 0.9 * e + 0.01 * x
        tkw["score_fn"] = lambda e, x, t, i: 0.9 * e + 0.01 * x
        jkw["quantize_fn"] = lambda x0: x0 - 0.1 * jnp.tanh(x0)
        tkw["quantize_fn"] = lambda x0: x0 - 0.1 * torch.tanh(x0)
        for k, v in (("dynamic_threshold", 0.9), ("temperature", 0.8),
                     ("noise_dropout", 0.3)):
            jkw[k] = tkw[k] = v

    noises = _step_noises(
        rng, t_enc, shape, inpaint=hook == "inpaint_tiled",
        pixel=hook == "pixel_guidance", tile=hook == "inpaint_tiled",
        dropout=0.3 if hook == "sampler_options" else 0.0)
    if hook == "inpaint_tiled":
        tkw["renoise_noise"] = noises["renoise"]
    if hook == "pixel_guidance":
        tkw["guidance_noise"] = noises["guide"]
        tkw["guidance_encode_noise"] = noises["guide_enc"]
    if hook == "sampler_options":
        tkw["sigma_noise"] = noises["sigma"]
        tkw["dropout_keep"] = noises["keep"]

    jc = lambda a, cc: JD.CondBundle(jnp.asarray(a), None if cc is None
                                     else jnp.asarray(cc))
    tc = lambda a, cc: TD.CondBundle(np_t(a), None if cc is None
                                     else np_t(cc))
    ref = JD.ddim_decode(_toy(jnp), JSCHED, jddim, jnp.asarray(x),
                         jc(ctx[b:], concat), jc(ctx[:b], concat), t_enc,
                         rng=rng, **jkw)
    out = TD.ddim_decode(_toy(torch), TSCHED, tddim, np_t(x),
                         tc(ctx[b:], concat), tc(ctx[:b], concat), t_enc,
                         **tkw)
    assert out.shape == shape
    assert rel_err(out, ref) < 1e-4, hook
    if hook not in ("plain", "dedup"):         # dedup is exact
        plain = JD.ddim_decode(_toy(jnp), JSCHED, jddim, jnp.asarray(x),
                               jc(ctx[b:], concat), jc(ctx[:b], concat),
                               t_enc, rng=rng)
        assert rel_err(plain, ref) > 1e-4, hook    # the hook did something


def test_ddim_decode_refusals(np_rng):
    x = torch.zeros((1, 4, 6, 4))
    c = TD.CondBundle(torch.zeros((1, 3, 5)))
    ddim = TS.make_ddim_params(TSCHED, 10)
    run = lambda **kw: TD.ddim_decode(_toy(torch), TSCHED, ddim, x, c, c, 2,
                                      **kw)
    assert torch.equal(TD.ddim_decode(_toy(torch), TSCHED, ddim, x, c, c, 0),
                       x)
    fns = (lambda *a: None, lambda *a: None)
    for kw, match in (
            ({"deepcache_interval": 2, "deepcache_fns": fns,
              "cfg_interval": 2}, "compose"),
            ({"deepcache_interval": 2}, "deepcache_fns"),
            ({"init_latent": x, "nmask": x}, "renoise_noise"),
            ({"guidance_latent": x, "guidance_strength": torch.zeros(2),
              "guidance_space": "pixel"}, "pixel"),
            ({"guidance_latent": x, "guidance_strength": torch.zeros(2),
              "guidance_space": "nope"}, "guidance_space")):
        with pytest.raises(ValueError, match=match):
            run(**kw)
    with pytest.raises(ValueError, match="sigma_noise"):
        TD.ddim_decode(_toy(torch), TSCHED, TS.make_ddim_params(TSCHED, 10,
                                                                eta=1.0),
                       x, c, c, 2)


# ---------------------------------------------------------------------------
# the facades
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """JAX and port bundles of the tiny 4- and 9-channel models on shared
    weights, their output convs perturbed (else every UNet output is 0),
    and a ControlNet of their config (zero convs perturbed)."""
    k4, k9, kc = jax.random.split(jax.random.PRNGKey(8), 3)
    pairs = _tiny_bundles(k4, 4), _tiny_bundles(k9, 9)
    for i, (jsd, tsd) in enumerate(pairs):
        perturb_zero_convs(jsd.unet_params, np.random.default_rng(i))
        tsd.unet_params = to_port(jsd.unet_params)
    cfg = pairs[0][0].unet_cfg
    with numpy_init():
        cn = JCN.controlnet_init(kc, cfg)
    perturb_zero_convs(cn, np.random.default_rng(2))
    tcfg = pairs[0][1].unet_cfg
    return ((pairs[0][0], pairs[1][0], (cn, cfg)),
            (pairs[0][1], pairs[1][1], (to_port(cn), tcfg)))


def _controls(net, cn_mod, frame, device=None):
    """The keyframe pipeline's two controls on one frame: HED (its Sobel
    fallback) 0.7 over [0, 1], Canny 0.3 over [0, 0.9]."""
    params, cfg = net
    kw = {} if device is None else {"device": device}
    return (cn_mod.ControlSpec(params, cfg, cn_mod.hed_hint(frame, None, 2,
                                                            **kw), 0.7),
            cn_mod.ControlSpec(params, cfg, cn_mod.canny_hint(
                frame, 100, 200, 2, **kw), 0.3, 0.0, 0.9))


def _img2img_noise(seed, shape, t_enc, *, target, pixel):
    """The JAX img2img's noises for PRNGKey(seed) along its key splits."""
    k_enc, k_tgt, k_core = jax.random.split(jax.random.PRNGKey(seed), 3)
    k_noise, k_decode, _ = jax.random.split(k_core, 3)
    normal = lambda k: np_t(jax.random.normal(k, shape))
    guide = guide_enc = None
    if pixel:
        splits = [jax.random.split(k, 3) for k in
                  jax.random.split(k_decode, t_enc)]
        guide = torch.stack([normal(s[0]) for s in splits])
        guide_enc = torch.stack([normal(s[1]) for s in splits])
    return TF.Img2ImgNoise(normal(k_enc), normal(k_noise),
                           normal(k_tgt) if target else None, guide,
                           guide_enc)


def _frame_u8(rng):
    """The control frame: 8x the latent (the hint encoder's stride; the
    tiny VAE downscales by 2, so 4x the image)."""
    img = rng.uniform(0, 255, (8 * LAT[0], 8 * LAT[1], 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5)


IMG2IMG_CASES = {
    "latent guidance and deepcache": dict(target=True,
                                          guidance_space="latent",
                                          deepcache_interval=2),
    "pixel guidance": dict(target=True, guidance_space="pixel"),
    "controls and cfg_interval": dict(controls=True, cfg_interval=2),
}


@pytest.mark.parametrize("case", list(IMG2IMG_CASES))
def test_img2img_hooks_match_jax(models, np_rng, monkeypatch, case):
    (jsd, _, jnet), (tsd, _, tnet) = models
    kw = dict(IMG2IMG_CASES[case])
    target, controls = kw.pop("target", False), kw.pop("controls", False)
    img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    common = dict(denoising_strength=0.3, ddim_steps=STEPS, seed=21, **kw)
    jkw, tkw = dict(common), dict(common)
    if target:
        tgt = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
        jkw["target_img"], tkw["target_img"] = jnp.asarray(tgt), np_t(tgt)
        sched = lambda p: 0.2 + 0.3 * p
        jkw["guidance_schedule_func"] = tkw["guidance_schedule_func"] = sched
    if controls:
        frame = _frame_u8(np_rng)
        jkw["control_specs"] = _controls(jnet, JCN, frame)
        tkw["control_specs"] = _controls(tnet, TCN, frame, "cpu")
    ref, _ = JF.img2img(jsd, jnp.asarray(img), "a fox", "", **jkw)
    noise = _img2img_noise(21, (1,) + LAT + (4,), T_ENC, target=target,
                           pixel=kw.get("guidance_space") == "pixel")
    monkeypatch.setattr(TF, "draw_img2img_noise", lambda *a, **k: noise)
    out, _ = TF.img2img(tsd, np_t(img), "a fox", "", **tkw)
    plain, _ = TF.img2img(tsd, np_t(img), "a fox", "", 0.3, STEPS, seed=21)
    psnr = _psnr(out, ref)
    print(f"\n[img2img {case}] decoded-frame PSNR {psnr:.1f} dB, "
          f"{_psnr(plain, ref):.1f} dB without the hook")
    assert out.shape == (1, H, W, 3) and psnr >= 80.0
    assert _psnr(plain, ref) < 60.0          # the hook changed the image


@pytest.mark.parametrize("controls", [True, False])
def test_img2img_inpaint_hooks_match_jax(models, np_rng, monkeypatch,
                                         controls):
    """With controls: the unfused ControlNet branch; without: the fused
    path with CFG caching (cfg_interval 2)."""
    (_, jsd9, jnet), (_, tsd9, tnet) = models
    img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    ref_img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    mask = (((yy - 14.6) ** 2 + (xx - 22.3) ** 2) < 8.7 ** 2).astype(
        np.float32)
    kw = dict(denoising_strength=0.3, ddim_steps=STEPS, mask_blur=2,
              seed=5, capture_kv=True)
    jkw, tkw = dict(kw), dict(kw)
    if controls:
        frame = _frame_u8(np_rng)
        jkw["control_specs"] = _controls(jnet, JCN, frame)
        tkw["control_specs"] = _controls(tnet, TCN, frame, "cpu")
    else:
        jkw["cfg_interval"] = tkw["cfg_interval"] = 2
    ref = JF.img2img_inpaint(jsd9, jnp.asarray(img), "a fox", "",
                             reference_img=jnp.asarray(ref_img),
                             mask=jnp.asarray(mask), **jkw)
    noise = jax_noise(5, (1,) + LAT + (4,), T_ENC, T_ENC, "ddim",
                      tile_noise=False, has_reference=True)
    monkeypatch.setattr(TF, "draw_inpaint_noise", lambda *a, **k: noise)
    out = TF.img2img_inpaint(tsd9, np_t(img), "a fox", "",
                             reference_img=np_t(ref_img), mask=mask, **tkw)
    psnr = _psnr(out[0], ref[0])
    print(f"\n[img2img_inpaint controls={controls}] PSNR {psnr:.1f} dB")
    assert out[0].shape == (1, H, W, 3) and psnr >= 80.0
    assert rel_err(out[1], ref[1]) < 1e-5            # composited input
    assert _psnr(out[2], ref[2]) >= 80.0             # decoded init latent
    for (k, v), (rk, rv) in zip(out[3], ref[3]):
        assert rel_err(k, rk) < 1e-4 and rel_err(v, rv) < 1e-4


def test_img2img_inpaint_batch_cfg_interval_matches_jax(models, np_rng,
                                                        monkeypatch):
    (_, jsd9, _), (_, tsd9, _) = models
    b = 2
    imgs = np_rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    refs = np_rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    masks = (np_rng.uniform(size=(b, H, W)) > 0.7).astype(np.float32)
    kw = dict(denoising_strength=0.3, ddim_steps=STEPS, mask_blur=2,
              cfg_interval=2)
    ref = JF.img2img_inpaint_batch(jsd9, imgs, ["a fox", "a cat"], "",
                                   masks, refs, **kw)
    noise = jax_noise(1234, (b,) + LAT + (4,), T_ENC, T_ENC, "ddim",
                      tile_noise=True, has_reference=True)
    monkeypatch.setattr(TF, "draw_inpaint_noise", lambda *a, **k: noise)
    out = TF.img2img_inpaint_batch(tsd9, imgs, ["a fox", "a cat"], "",
                                   masks, refs, **kw)
    psnr = _psnr(out, ref)
    print(f"\n[img2img_inpaint_batch cfg_interval=2] PSNR {psnr:.1f} dB")
    assert out.shape == (b, H, W, 3) and psnr >= 80.0


def test_img2img_latent_inpaint_matches_jax(models, np_rng, monkeypatch):
    (_, jsd9, jnet), (_, tsd9, tnet) = models
    warped = np_rng.standard_normal((1,) + LAT + (4,)).astype(np.float32)
    ref_img = np_rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    mask = (np_rng.uniform(size=(H, W)) > 0.6).astype(np.float32)
    frame = _frame_u8(np_rng)
    kw = dict(denoising_strength=0.3, ddim_steps=STEPS, mask_blur=2,
              seed=17, guidance_schedule_func=lambda p: 0.1)
    ref = JF.img2img_latent_inpaint(
        jsd9, jnp.asarray(warped), jnp.asarray(ref_img), mask, "a fox", "",
        control_specs=_controls(jnet, JCN, frame), **kw)
    k_enc, k_cdt, k_core = jax.random.split(jax.random.PRNGKey(17), 3)
    k_noise, k_decode, _ = jax.random.split(k_core, 3)
    shape = warped.shape
    normal = lambda k: np_t(jax.random.normal(k, shape))
    noise = TF.InpaintNoise(
        normal(k_enc), normal(k_cdt), None, normal(k_noise),
        torch.stack([normal(jax.random.split(k)[0])
                     for k in jax.random.split(k_decode, T_ENC)]))
    monkeypatch.setattr(TF, "draw_inpaint_noise", lambda *a, **k: noise)
    out = TF.img2img_latent_inpaint(
        tsd9, np_t(warped), np_t(ref_img), mask, "a fox", "",
        control_specs=_controls(tnet, TCN, frame, "cpu"), **kw)
    psnr = _psnr(out[0], ref[0])
    print(f"\n[img2img_latent_inpaint, controls] PSNR {psnr:.1f} dB")
    assert out[0].shape == (1, H, W, 3) and psnr >= 80.0
    assert rel_err(out[1], ref[1]) < 1e-4           # the decoded latent
    assert _psnr(out[2], ref[2]) >= 80.0            # decoded init latent


def test_facade_hook_limits(models):
    """The JAX facade's limits: DPM++ refuses guidance, ignores controls
    and cfg_interval; DeepCache refuses K/V injection and controls, and
    CFG caching beside it."""
    _, (tsd, tsd9, tnet) = models
    img = torch.rand((1, H, W, 3)) * 2 - 1
    specs = _controls(tnet, TCN, _frame_u8(np.random.default_rng(0)), "cpu")
    run = lambda **kw: TF.img2img(tsd, img, "a fox", "", 0.3, STEPS,
                                  seed=3, **kw)[0]
    with pytest.raises(ValueError, match="ddim"):
        run(target_img=img, sampler="dpmpp:2")
    base = run(sampler="dpmpp:2")
    for kw in ({"control_specs": specs}, {"cfg_interval": 2},
               {"deepcache_interval": 2}):
        assert torch.equal(run(sampler="dpmpp:2", **kw), base)
    kv = TF.img2img(tsd, img, "a fox", "", 0.3, STEPS, capture_kv=True)[1]
    for kw in ({"reference_kv": kv}, {"control_specs": specs},
               {"strip": TU.StripConfig(2)}):
        with pytest.raises(ValueError, match="deepcache"):
            run(deepcache_interval=2, **kw)
    with pytest.raises(ValueError, match="compose"):
        run(deepcache_interval=2, cfg_interval=2)
    # the ControlNet inpaint branch runs DDIM whatever the sampler says
    mask = torch.zeros((H, W))
    mask[8:20, 10:30] = 1
    a = TF.img2img_inpaint(tsd9, img, "a", "", 0.3, STEPS, reference_img=img,
                           mask=mask, control_specs=specs, seed=3)[0]
    b = TF.img2img_inpaint(tsd9, img, "a", "", 0.3, STEPS, reference_img=img,
                           mask=mask, control_specs=specs, seed=3,
                           sampler="dpmpp:2", cfg_interval=3)[0]
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_guidance_strength_array(np_rng):
    """Scalar schedules equal JAX's; a map schedule is resized bicubically
    (cv2's INTER_CUBIC in JAX, the port's resize here: within 1e-5); the
    weight map scales each latent pixel."""
    sched = lambda p: 0.5 * p
    ref = JF._guidance_strength_array(sched, None, 3, 10, (1, 8, 12, 4))
    out = TF._guidance_strength_array(sched, None, 3, 10, (1, 8, 12, 4),
                                      "cpu")
    assert out.shape == (3, 1, 8, 12, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    gmap = np_rng.uniform(size=(16, 24)).astype(np.float32)
    ref = JF._guidance_strength_array(lambda p: gmap * p, None, 3, 10,
                                      (1, 8, 12, 4))
    out = TF._guidance_strength_array(lambda p: gmap * p, None, 3, 10,
                                      (1, 8, 12, 4), "cpu")
    assert np.abs(out.numpy() - np.asarray(ref)).max() < 1e-5
    wm = np_rng.uniform(size=(32, 48)).astype(np.float32)
    out_w = TF._guidance_strength_array(sched, wm, 3, 10, (1, 8, 12, 4),
                                        "cpu")
    wm_lat = cv2.resize(wm, (12, 8), interpolation=cv2.INTER_LINEAR)
    base = TF._guidance_strength_array(sched, None, 3, 10, (1, 8, 12, 4),
                                       "cpu")
    assert np.abs(out_w.numpy() - base.numpy()
                  * wm_lat[None, None, :, :, None]).max() < 1e-5


def test_pixel_run_cfg_interval_matches_jax(tmp_path, models, tiny):
    """The pixel pipeline with CFG caching: key frames through img2img,
    the others through img2img_inpaint, both on the hooked decode (the
    perturbed tiny bundles, the tiny RAFT)."""
    (jsd, jsd9, _), (tsd, tsd9, _) = models
    (_, _, jest), (_, _, test) = tiny
    frames = _synthetic_frames(n=3)
    triples = [(f, i == 0, i) for i, f in enumerate(frames)]
    jdir = JPI.run(iter(triples), str(tmp_path / "jax"), jsd, jsd9, jest,
                   cfg=JPI.PixelInpaintConfig(size=(64, 64), cfg_interval=2,
                                              **KW))
    p1, p2 = _jax_noises()
    with p1, p2:
        tdir = TPI.run(iter(triples), str(tmp_path / "port"), tsd, tsd9,
                       test, cfg=TPI.PixelInpaintConfig(cfg_interval=2,
                                                        **KW))
    psnr = _converted_psnr(tdir, jdir, "pixel run cfg_interval=2")
    assert len(psnr) == 3 and all(v >= 40.0 for v in psnr.values()), psnr
