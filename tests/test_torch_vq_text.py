"""Port parity: the VQ first stage and the OpenCLIP / T5 text encoders
against the JAX package on the CPU in f32, on small configs with shared
weights; the weights bridge on the new trees in both directions; and the
new modules without JAX.

Gates: 1e-5 relative on values and gradients, equality for VQ's
indices and T5's relative-position buckets."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import depth as JDP
from sd_animation_optical_flow_tpu.models import text_encoders as JTE
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models import vq as JVQ
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu_torch.models import text_encoders as TTE
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.models import vq as TVQ
from sd_animation_optical_flow_tpu_torch.utils.jax_params import \
    params_to_jax
from torch_port_common import UNET_KW, np_t, rel_err, to_port

REPO = Path(__file__).resolve().parents[1]
BACKBONE = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1, double_z=False,
                scale_factor=1.0)
OPENCLIP_KW = dict(vocab_size=1000, width=64, layers=3, heads=4)
T5_KW = dict(vocab_size=500, d_model=64, d_kv=16, d_ff=96, heads=4,
             layers=2)


@pytest.fixture(scope="module")
def vq():
    jcfg = JVQ.VQConfig(backbone=JV.VAEConfig(**BACKBONE), n_embed=64)
    with numpy_init():
        p = JVQ.vq_init(jax.random.PRNGKey(0), jcfg)
    # a codebook on the latents' scale, so the search has real contests
    p["quantize"]["embedding"] = np.random.default_rng(0).standard_normal(
        (64, 4)).astype(np.float32)
    tcfg = TVQ.VQConfig(backbone=TV.VAEConfig(**BACKBONE), n_embed=64)
    return jcfg, p, tcfg, to_port(p)


def test_quantize_value_loss_and_straight_through(vq, np_rng):
    jcfg, jp, tcfg, tp = vq
    z = np_rng.standard_normal((2, 6, 7, 4)).astype(np.float32)
    w = np_rng.standard_normal(z.shape).astype(np.float32)

    def jf(emb, z):
        zq, loss, idx = JVQ.quantize({"embedding": emb}, jcfg, z)
        return jnp.sum(zq * w) + 3.0 * loss, (zq, loss, idx)
    (_, (jzq, jloss, jidx)), (jg_emb, jg_z) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(jp["quantize"][
            "embedding"]), jnp.asarray(z))
    emb = tp["quantize"]["embedding"].clone().requires_grad_()
    tz = np_t(z).requires_grad_()
    zq, loss, idx = TVQ.quantize({"embedding": emb}, tcfg, tz)
    (zq * np_t(w)).sum().add(3.0 * loss).backward()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert tuple(idx.shape) == (2, 6, 7) and len(idx.unique()) > 10
    assert rel_err(zq.detach(), jzq) < 1e-6
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert rel_err(tz.grad, jg_z) < 1e-5 and rel_err(emb.grad, jg_emb) < 1e-5
    # straight through: d(sum(z_q * w))/dz is w plus the commitment term
    assert not torch.equal(tz.grad, np_t(w))


def test_vq_encode_decode_and_code(vq, np_rng):
    jcfg, jp, tcfg, tp = vq
    img = np_rng.uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32)
    jzq, _, jidx = JVQ.vq_encode(jp, jcfg, jnp.asarray(img))
    zq, _, idx = TVQ.vq_encode(tp, tcfg, np_t(img))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert rel_err(zq, jzq) < 1e-5
    h = TVQ.vq_encode_prequant(tp, tcfg, np_t(img))
    assert rel_err(h, JVQ.vq_encode_prequant(jp, jcfg, jnp.asarray(img))) \
        < 1e-5
    for first in (True, False):
        ref = JVQ.vq_decode(jp, jcfg, jnp.asarray(h.numpy()),
                            quantize_first=first)
        out = TVQ.vq_decode(tp, tcfg, h, quantize_first=first)
        assert tuple(out.shape) == (1, 16, 24, 3) and rel_err(out, ref) < 1e-5
    ref = JVQ.vq_decode_code(jp, jcfg, jidx)
    out = TVQ.vq_decode_code(tp, tcfg, idx)
    assert rel_err(out, ref) < 1e-5
    assert rel_err(TVQ.embed_code(tp["quantize"], idx),
                   JVQ.embed_code(jp["quantize"], jidx)) == 0.0


@pytest.fixture(scope="module")
def openclip():
    jcfg = JTE.OpenCLIPTextConfig(**OPENCLIP_KW)
    with numpy_init():
        p = JTE.openclip_text_init(jax.random.PRNGKey(1), jcfg)
    return p, to_port(p)


@pytest.mark.parametrize("penultimate", [True, False])
def test_openclip_matches_jax_and_is_causal(openclip, np_rng, penultimate):
    jp, tp = openclip
    jcfg = JTE.OpenCLIPTextConfig(**OPENCLIP_KW, penultimate=penultimate)
    tcfg = TTE.OpenCLIPTextConfig(**OPENCLIP_KW, penultimate=penultimate)
    ids = np_rng.integers(0, 1000, (2, 77)).astype(np.int32)
    ref = JTE.openclip_text_apply(jp, jcfg, jnp.asarray(ids))
    out = TTE.openclip_text_apply(tp, tcfg, torch.from_numpy(ids))
    assert tuple(out.shape) == (2, 77, 64) and rel_err(out, ref) < 1e-5
    late = ids.copy()
    late[:, 40:] = (late[:, 40:] + 1) % 1000
    out2 = TTE.openclip_text_apply(tp, tcfg, torch.from_numpy(late))
    assert torch.equal(out2[:, :40], out[:, :40])
    assert not torch.equal(out2[:, 40:], out[:, 40:])


@pytest.mark.parametrize("n,buckets,dist", [(77, 32, 128), (300, 32, 128),
                                            (64, 16, 32), (513, 64, 256)])
def test_t5_relative_buckets_equal(n, buckets, dist):
    out = TTE.t5_relative_buckets(n, buckets, dist)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(JTE.t5_relative_buckets(n, buckets, dist)))


@pytest.fixture(scope="module")
def t5():
    cfg = JTE.T5Config(**T5_KW)
    with numpy_init():
        p = JTE.t5_encoder_init(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(2)
    for lp in p["layers"]:          # RMSNorm scales off 1, so they count
        lp["norm1"] = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    return cfg, p, TTE.T5Config(**T5_KW), to_port(p)


def test_t5_encoder_matches_jax(t5, np_rng):
    jcfg, jp, tcfg, tp = t5
    ids = np_rng.integers(0, 500, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[1, 14:] = 0
    for m in (None, mask):
        ref = JTE.t5_encoder_apply(jp, jcfg, jnp.asarray(ids),
                                   None if m is None else jnp.asarray(m))
        out = TTE.t5_encoder_apply(tp, tcfg, torch.from_numpy(ids),
                                   None if m is None else torch.from_numpy(m))
        assert tuple(out.shape) == (2, 20, 64) and rel_err(out, ref) < 1e-5
    # the masked keys are not read: a padded token changes nothing before
    # it in the masked row
    padded = ids.copy()
    padded[1, 15] = (padded[1, 15] + 7) % 500
    a = TTE.t5_encoder_apply(tp, tcfg, torch.from_numpy(ids),
                             torch.from_numpy(mask))
    b = TTE.t5_encoder_apply(tp, tcfg, torch.from_numpy(padded),
                             torch.from_numpy(mask))
    assert torch.equal(a[1, :14], b[1, :14]) and torch.equal(a[0], b[0])


def test_clip_t5_encode(t5, openclip, np_rng):
    _, _, tcfg, tp = t5
    ids = torch.from_numpy(np_rng.integers(0, 500, (1, 77)).astype(np.int32))
    ocfg = TTE.OpenCLIPTextConfig(**OPENCLIP_KW)
    enc = TTE.clip_t5_encode(
        lambda x: TTE.openclip_text_apply(openclip[1], ocfg, x),
        lambda x: TTE.t5_encoder_apply(tp, tcfg, x))
    out = enc(ids)
    assert isinstance(out, list) and len(out) == 2
    assert torch.equal(out[0], TTE.openclip_text_apply(openclip[1], ocfg, ids))
    assert torch.equal(out[1], TTE.t5_encoder_apply(tp, tcfg, ids))
    assert rel_err(out[1], JTE.clip_t5_encode(
        lambda x: None, lambda x: JTE.t5_encoder_apply(
            t5[1], t5[0], x))(jnp.asarray(ids.numpy()))[1]) < 1e-5


def test_weights_bridge_round_trips_the_new_trees(vq, openclip, t5):
    """DPT, VQ, OpenCLIP, T5 and a class-conditional UNet cross into the
    port and back unchanged (the VQ codebook and the embedding tables are
    not transposed; conv and linear weights are)."""
    dcfg = JDP.DPTConfig(patch=8, width=32, layers=2, heads=4,
                         hooks=(0, 1, 1, 1), reassemble_ch=(8, 8, 16, 16),
                         features=8, img_size=32)
    with numpy_init():
        trees = {"dpt": JDP.dpt_init(jax.random.PRNGKey(3), dcfg),
                 "unet": JU.unet_init(jax.random.PRNGKey(4), JU.UNetConfig(
                     **UNET_KW, num_classes=5))}
    trees.update(vq=vq[1], openclip=openclip[0], t5=t5[1])
    port = to_port(trees)
    assert tuple(port["vq"]["quantize"]["embedding"].shape) == (64, 4)
    assert tuple(port["t5"]["rel_bias"].shape) == (32, 4)
    assert tuple(port["dpt"]["patch_embed"]["w"].shape) == (32, 3, 8, 8)
    assert tuple(port["t5"]["layers"][0]["wi0"]["w"].shape) == (96, 64)
    back = params_to_jax(port)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    pairs = list(zip(flat(trees), flat(back)))
    assert len(pairs) == len(flat(trees))
    for (pa, a), (pb, b) in pairs:
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_new_modules_import_and_run_without_jax():
    """The new modules and their entry points import, and run a tiny
    call, in a fresh interpreter with JAX made unimportable."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'optax',\n"
        "          'sd_animation_optical_flow_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import torch\n"
        "import sd_animation_optical_flow_tpu_torch as M\n"
        "from sd_animation_optical_flow_tpu_torch.diffusion import (\n"
        "    ddim, ddpm_sampler, distributions, dpm_solver, plms,\n"
        "    sampling_util, schedule, upscaling)\n"
        "from sd_animation_optical_flow_tpu_torch.models import (depth,\n"
        "    text_encoders as te, vq)\n"
        "from sd_animation_optical_flow_tpu_torch.models.layers import Init\n"
        "from sd_animation_optical_flow_tpu_torch.pipelines import (\n"
        "    specializations)\n"
        "assert M.txt2img and M.img2img_invert and M.upscale\n"
        "assert M.img2img_depth2img is specializations.img2img_depth2img\n"
        "init = Init(torch.Generator().manual_seed(0))\n"
        "cfg = te.T5Config(vocab_size=50, d_model=32, d_kv=8, d_ff=48,\n"
        "                  heads=4, layers=1)\n"
        "out = te.t5_encoder_apply(te.t5_encoder_init(init, cfg), cfg,\n"
        "                          torch.zeros((1, 5), dtype=torch.int64))\n"
        "s = schedule.make_linear_schedule()\n"
        "pc = ddpm_sampler.posterior_coefs(s)\n"
        "assert out.shape == (1, 5, 32) and pc.variance.shape == (1000,)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
