"""Port parity: class conditioning, latent upscaling, the DPT depth model,
depth2img, txt2img and the DDIM inversion against the JAX package on the
CPU in f32, on small models with shared weights. The JAX facades are
called through their public entry points; the port's cores take the
noises the JAX programs draw, rebuilt along their key splits.

Gates: latent relative error <= 1e-4 and decoded PSNR >= 80 dB (peak to
peak 2) for the facades; 1e-5 relative for the models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.diffusion import upscaling as JUP
from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import depth as JDP
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import specializations as JSP
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu.training import losses as JL
from sd_animation_optical_flow_tpu_torch import config as TC
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.diffusion import upscaling as TUP
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import depth as TDP
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.models.layers import Init
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines import \
    specializations as TSP
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from sd_animation_optical_flow_tpu_torch.training import losses as TL
from sd_animation_optical_flow_tpu_torch.utils.tree import (tree_leaves,
                                                            tree_map)
from torch_port_common import (CLIP_KW, UNET_KW, VAE_KW, np_t,
                               perturb_zero_convs, rel_err, to_port)

PROMPT, NEG = "a watercolor fox", "blurry"
DPT_KW = dict(patch=8, width=32, layers=4, heads=4, hooks=(0, 1, 2, 3),
              reassemble_ch=(8, 16, 32, 32), features=8, img_size=64)


def _bundles(in_channels=4, num_classes=None, seed=0):
    """(JAX bundle, port bundle) of the small UNet / VAE / CLIP with the
    same weights (the UNet's zero convs perturbed)."""
    ucfg = dict(UNET_KW, in_channels=in_channels, num_classes=num_classes)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    jcfg = (JU.UNetConfig(**ucfg), JV.VAEConfig(**VAE_KW),
            JCL.CLIPTextConfig(**CLIP_KW))
    with numpy_init():
        ps = (JU.unet_init(k1, jcfg[0]), JV.vae_init(k2, jcfg[1]),
              JCL.clip_text_init(k3, jcfg[2]))
    perturb_zero_convs(ps[0], np.random.default_rng(seed + 1))
    jsd = JF.StableDiffusionBundle(
        unet_params=ps[0], unet_cfg=jcfg[0], vae_params=ps[1],
        vae_cfg=jcfg[1], clip_params=ps[2], clip_cfg=jcfg[2],
        tokenizer=JTok(hf_name_or_path=None))
    tsd = TF.StableDiffusionBundle(
        unet_params=to_port(ps[0]), unet_cfg=TU.UNetConfig(**ucfg),
        vae_params=to_port(ps[1]), vae_cfg=TV.VAEConfig(**VAE_KW),
        clip_params=to_port(ps[2]), clip_cfg=TCL.CLIPTextConfig(**CLIP_KW),
        tokenizer=TTok(hf_name_or_path=None), device="cpu")
    return jsd, tsd


@pytest.fixture(scope="module")
def plain():
    return _bundles(seed=2)


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(4.0 / mse)


def _gate(name, out, ref, latent=None, ref_latent=None):
    """Print and check the facade gate: PSNR >= 80 dB on the images and
    relative error <= 1e-4 on the latents (the images where the facade
    returns no latent)."""
    psnr = _psnr(out, ref)
    err = rel_err(out if latent is None else latent,
                  ref if ref_latent is None else ref_latent)
    print(f"\n[{name}] PSNR {psnr:.1f} dB, rel err {err:.2e}")
    assert tuple(out.shape) == tuple(np.shape(ref))
    assert psnr >= 80.0 and err <= 1e-4


# ---------------------------------------------------------------------------
# class conditioning
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def classy():
    # two levels keep the JAX gradient's compile short
    cfg = dict(UNET_KW, channel_mult=(1, 2), attention_resolutions=(1,),
               num_classes=10)
    with numpy_init():
        p = JU.unet_init(jax.random.PRNGKey(5), JU.UNetConfig(**cfg))
    perturb_zero_convs(p, np.random.default_rng(5))
    return JU.UNetConfig(**cfg), p, TU.UNetConfig(**cfg)


def test_unet_class_conditioning_matches_jax(classy, np_rng):
    jcfg, jp, tcfg = classy
    tp = to_port(jp)
    assert tuple(tp["label_emb"].shape) == (10, tcfg.time_embed_dim)
    x = np_rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    ctx = np_rng.standard_normal((2, 7, 64)).astype(np.float32)
    t, y = np.array([5, 801], np.int32), np.array([3, 7], np.int32)
    ref, _ = jax.jit(lambda p, *a: JU.unet_apply(p, jcfg, *a[:3], y=a[3]))(
        jp, *map(jnp.asarray, (x, t, ctx, y)))
    out, _ = TU.unet_apply(tp, tcfg, np_t(x), torch.from_numpy(t), np_t(ctx),
                           y=torch.from_numpy(y))
    assert rel_err(out, ref) < 1e-5
    other, _ = TU.unet_apply(tp, tcfg, np_t(x), torch.from_numpy(t),
                             np_t(ctx), y=torch.tensor([0, 0]))
    assert float((other - out).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="class"):
        TU.unet_apply(tp, tcfg, np_t(x), torch.from_numpy(t), np_t(ctx))
    with pytest.raises(ValueError, match="context_pair"):
        TU.unet_apply(tp, tcfg, np_t(x[:1]), torch.from_numpy(t[:1]), None,
                      y=torch.tensor([1]),
                      context_pair=(np_t(ctx[:1]), np_t(ctx[1:])))
    plain_cfg = TU.UNetConfig(**dict(UNET_KW, channel_mult=(1, 2),
                                     attention_resolutions=(1,)))
    plain = TU.unet_init(Init(torch.Generator().manual_seed(0)), plain_cfg)
    assert "label_emb" not in plain
    with pytest.raises(ValueError, match="class"):
        TU.unet_apply(plain, plain_cfg, np_t(x), torch.from_numpy(t),
                      np_t(ctx), y=torch.tensor([1, 2]))


def test_p_losses_with_y_value_and_grad(classy, np_rng):
    jcfg, jp, tcfg = classy
    x0 = np_rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = np_rng.standard_normal((2, 7, 64)).astype(np.float32)
    y = np.array([9, 2], np.int32)
    rng = jax.random.PRNGKey(4)
    jsched, tsched = JS.make_linear_schedule(), TS.make_linear_schedule()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: JL.p_losses(p, jcfg, jsched, *a[:3], y=a[3])))(
            jp, jnp.asarray(x0), jnp.asarray(ctx), rng, jnp.asarray(y))
    k_t, k_noise = jax.random.split(rng)
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000)))
    noise = np_t(jax.random.normal(k_noise, x0.shape))
    params = tree_map(lambda a: a.requires_grad_(), to_port(jp))
    loss = TL.p_losses(params, tcfg, tsched, np_t(x0), np_t(ctx), t, noise,
                       y=torch.from_numpy(y))
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    gtree = tree_map(lambda _: next(grads), params)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    pairs = _leaf_pairs(gtree, to_port(jgrads))
    scale = max(float(b.abs().max()) for a, b in pairs)
    for a, b in pairs:
        assert float((a - b).abs().max()) <= 1e-4 * scale
    # the label table's gradient reaches exactly the two rows used
    rows = torch.nonzero(gtree["label_emb"].abs().sum(1)).flatten()
    assert set(rows.tolist()) == {2, 9}


def _leaf_pairs(a, b):
    """(port leaf, JAX leaf) pairs of two trees, matched by key."""
    if isinstance(a, dict):
        return [p for k in a for p in _leaf_pairs(a[k], b[k])]
    if isinstance(a, (list, tuple)):
        return [p for x, y in zip(a, b) for p in _leaf_pairs(x, y)]
    return [(a, b)]


# ---------------------------------------------------------------------------
# upscaling helpers, the DPT and depth_to_concat
# ---------------------------------------------------------------------------

def test_upscaling_functions(np_rng):
    js, ts = JUP.make_low_scale_schedule(), TUP.make_low_scale_schedule()
    for f in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    x = np_rng.uniform(-1, 1, (2, 6, 8, 3)).astype(np.float32)
    z, lvl = TUP.simple_image_concat(np_t(x))
    assert torch.equal(z, np_t(x)) and lvl.tolist() == [0, 0]
    rng = jax.random.PRNGKey(8)
    k_lvl, k_noise = jax.random.split(rng)
    noise = np_t(jax.random.normal(k_noise, x.shape))
    for level in (None, np.array([17, 940], np.int32)):
        ref_z, ref_l = JUP.upscale_conditioning(
            js, jnp.asarray(x), rng, None if level is None
            else jnp.asarray(level), max_noise_level=350)
        lv = np.asarray(jax.random.randint(k_lvl, (2,), 0, 350)) \
            if level is None else level
        out_z, out_l = TUP.upscale_conditioning(ts, np_t(x), noise,
                                                torch.tensor(lv))
        assert out_l.tolist() == np.asarray(ref_l).tolist()
        assert rel_err(out_z, ref_z) < 1e-6
    drawn = TUP.noise_augment(ts, np_t(x), generator=torch.Generator()
                              .manual_seed(0), max_noise_level=5)[1]
    assert drawn.dtype == torch.int32 and int(drawn.max()) < 5


@pytest.fixture(scope="module")
def dpt():
    cfg = JDP.DPTConfig(**DPT_KW)
    with numpy_init():
        p = JDP.dpt_init(jax.random.PRNGKey(6), cfg)
    # a random DPT's ReLU head can clip to a constant: bias it positive
    p["head"][2]["b"] = np.array([0.5], np.float32)
    return cfg, p, TDP.DPTConfig(**DPT_KW), to_port(p)


@pytest.mark.parametrize("hw", [(64, 64), (64, 96), (48, 80)])
def test_dpt_matches_jax(dpt, np_rng, hw):
    """Square (the position table as it is) and non-square inputs (the
    table resized; 48x80 gives the /2 branch an odd grid)."""
    jcfg, jp, tcfg, tp = dpt
    img = np_rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    ref = jax.jit(lambda p, x: JDP.dpt_apply(p, jcfg, x))(jp, jnp.asarray(img))
    out = TDP.dpt_apply(tp, tcfg, np_t(img))
    assert tuple(out.shape) == (2,) + hw
    assert float(out.std()) > 0 and rel_err(out, ref) < 1e-5


def test_depth_to_concat_matches_jax(np_rng):
    d = np_rng.uniform(0, 3, (2, 64, 96)).astype(np.float32)
    ref = JDP.depth_to_concat(jnp.asarray(d), (16, 24))
    out = TDP.depth_to_concat(np_t(d), (16, 24))
    assert tuple(out.shape) == (2, 16, 24, 1) and rel_err(out, ref) < 1e-6
    assert float(out.min()) >= -1.0 and float(out.max()) <= 1.0
    img = np_rng.uniform(0, 1, (1, 8, 8, 3)).astype(np.float32)
    assert rel_err(TDP.midas_normalize(np_t(img)),
                   JDP.midas_normalize(jnp.asarray(img))) == 0.0


# ---------------------------------------------------------------------------
# the facades
# ---------------------------------------------------------------------------

def test_img2img_depth2img_matches_jax(dpt, np_rng):
    jcfg, jp, tcfg, tp = dpt
    jsd, tsd = _bundles(in_channels=5, seed=3)
    img = np_rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)
    seed, steps, strength = 5, 6, 0.5
    ref, _ = JSP.img2img_depth2img(jsd, JSP.DepthConditioner(jp, jcfg),
                                   jnp.asarray(img), PROMPT, NEG,
                                   denoising_strength=strength,
                                   ddim_steps=steps, seed=seed)
    k_enc, k_core = jax.random.split(jax.random.PRNGKey(seed))
    lat_shape = (1, 8, 16, 4)
    enc = np_t(jax.random.normal(k_enc, lat_shape))
    noise = np_t(jax.random.normal(jax.random.split(k_core, 3)[0],
                                   lat_shape))
    depth = TSP.DepthConditioner(tp, tcfg)
    out, _, kv = TSP._depth2img_core(
        tsd, depth, np_t(img), tsd.get_learned_conditioning(PROMPT),
        tsd.get_learned_conditioning(NEG), enc, noise,
        t_enc=TF._t_enc(strength, steps), ddim_steps=steps, cfg_scale=7.0,
        capture_kv=False)
    assert kv is None
    _gate("depth2img", out, ref)
    a, _ = TSP.img2img_depth2img(tsd, depth, np_t(img), PROMPT, NEG,
                                 ddim_steps=3, seed=1)
    b, _ = TSP.img2img_depth2img(tsd, depth, np_t(img), PROMPT, NEG,
                                 ddim_steps=3, seed=1)
    assert torch.equal(a, b) and float(a.abs().max()) <= 1.0
    with pytest.raises(ValueError, match="5-channel"):
        TSP.img2img_depth2img(_bundles(seed=3)[1], depth, np_t(img), PROMPT,
                              NEG)


def test_upscale_matches_jax(np_rng):
    jsd, tsd = _bundles(in_channels=7, num_classes=1000, seed=4)
    x_low = np_rng.uniform(-1, 1, (1, 8, 12, 3)).astype(np.float32)
    seed, steps = 9, 4
    ref, ref_lvl = JSP.upscale(jsd, jnp.asarray(x_low), PROMPT, NEG,
                               ddim_steps=steps, seed=seed)
    k_aug, k_prior, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    k_lvl, k_noise = jax.random.split(k_aug)
    lvl = torch.from_numpy(np.array(jax.random.randint(k_lvl, (1,), 0, 350)))
    aug = np_t(jax.random.normal(k_noise, x_low.shape))
    x_T = np_t(jax.random.normal(k_prior, (1, 8, 12, 4)))
    out, out_lvl = TSP._upscale_core(
        tsd, np_t(x_low), tsd.get_learned_conditioning(PROMPT),
        tsd.get_learned_conditioning(NEG), lvl, aug, x_T, ddim_steps=steps,
        cfg_scale=7.0)
    assert out_lvl.tolist() == np.asarray(ref_lvl).tolist()
    _gate("upscale", out, ref)
    # the public facade: a given level comes back, the image is x4 here
    img, used = TSP.upscale(tsd, np_t(x_low), PROMPT, NEG, noise_level=[20],
                            ddim_steps=2)
    assert used.tolist() == [20] and tuple(img.shape) == (1, 32, 48, 3)
    with pytest.raises(ValueError, match="7-channel"):
        TSP.upscale(_bundles(seed=4)[1], np_t(x_low), PROMPT, NEG)
    with pytest.raises(ValueError, match="class-conditional"):
        TSP.upscale(_bundles(in_channels=7, seed=4)[1], np_t(x_low), PROMPT,
                    NEG)


@pytest.mark.parametrize("batch,eta", [(1, 0.0), (2, 0.5)])
def test_txt2img_matches_jax(plain, batch, eta):
    jsd, tsd = plain
    seed, steps, shape = 3, 4, (batch, 8, 12, 4)
    ref = JF.txt2img(jsd, PROMPT, NEG, height=32, width=48, ddim_steps=steps,
                     eta=eta, seed=seed, batch=batch)
    k_T, rest = jax.random.split(jax.random.PRNGKey(seed))
    x_T = np_t(jax.random.normal(k_T, shape))
    sig = np_t(np.stack([np.asarray(jax.random.normal(
        jax.random.split(k)[0], shape)) for k in jax.random.split(rest, steps)]))
    ctx = [tsd.get_learned_conditioning(t).repeat(batch, 1, 1)
           for t in (PROMPT, NEG)]
    out = TF._txt2img_core(tsd, *ctx, x_T, ddim_steps=steps, cfg_scale=7.0,
                           eta=eta, sigma_noise=sig if eta else None)
    _gate(f"txt2img batch {batch} eta {eta}", out, ref)
    pub = TF.txt2img(tsd, PROMPT, NEG, 32, 48, ddim_steps=2, eta=eta,
                     seed=1, batch=batch)
    assert tuple(pub.shape) == (batch, 32, 48, 3)
    assert torch.equal(pub, TF.txt2img(tsd, PROMPT, NEG, 32, 48, ddim_steps=2,
                                       eta=eta, seed=1, batch=batch))


def test_img2img_invert_matches_jax(plain, np_rng):
    jsd, tsd = plain
    img = np_rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    seed, steps, t_enc = 6, 10, 4
    ref = JF.img2img_invert(jsd, jnp.asarray(img), PROMPT, NEG, t_enc=t_enc,
                            ddim_steps=steps, seed=seed)
    enc = np_t(jax.random.normal(jax.random.PRNGKey(seed), (1, 8, 12, 4)))
    out = TF._invert_core(tsd, np_t(img), tsd.get_learned_conditioning(PROMPT),
                          tsd.get_learned_conditioning(NEG), enc, t_enc=t_enc,
                          ddim_steps=steps, cfg_scale=1.0,
                          timestep_indexing="index")
    dec = lambda z: TV.decode(tsd.vae_params, tsd.vae_cfg, np_t(z))
    _gate("img2img_invert", dec(out), dec(ref), out, ref)
    pub = TF.img2img_invert(tsd, np_t(img), PROMPT, NEG, t_enc=2,
                            ddim_steps=steps, seed=1,
                            timestep_indexing="timestep")
    assert tuple(pub.shape) == (1, 8, 12, 4) and torch.isfinite(pub).all()


def test_depth_and_upscale_specs():
    depth, up = TC.load_spec("sd15-depth"), TC.load_spec("sd-upscale")
    assert depth.unet.in_channels == 5 and depth.unet.num_classes is None
    assert up.unet.in_channels == 7 and up.unet.num_classes == 1000
    assert depth.conditioning_key == up.conditioning_key == "hybrid"
    assert up.unet.model_channels == 320 and depth.vae.ch == 128
    narrow = TU.UNetConfig(**dict(up.unet.__dict__, model_channels=32,
                                  channel_mult=(1, 2),
                                  attention_resolutions=(1,),
                                  context_dim=64))
    p = TU.unet_init(Init(torch.Generator().manual_seed(0)), narrow)
    assert tuple(p["label_emb"].shape) == (1000, 128)
    assert p["input_blocks"][0]["conv"]["w"].shape[1] == 7
