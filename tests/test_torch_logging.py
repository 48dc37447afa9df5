"""Port parity: the host-side logging modules — ``utils/flow_viz.py``,
``utils/logging_images.py`` and ``utils/log_images.py`` — against the JAX
package's on the same inputs, made from a seed; ``utils/profiling.py``'s
``trace`` and ``annotate``; and every item-9a module importing in a fresh
interpreter where cv2 and PIL cannot be imported (the card's machine has
neither).

Tolerances: the numpy helpers equal (no tolerance); ``log_images``' uint8
panels within 1 LSB (the tiny bundle's f32 VAE and DDIM chain agree with
JAX's to rounding, and a value on a quantisation edge may land on either
side), with JAX's four draws fed to the port."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu.utils import flow_viz as JFV
from sd_animation_optical_flow_tpu.utils import log_images as JLI
from sd_animation_optical_flow_tpu.utils import logging_images as JLG
from sd_animation_optical_flow_tpu.utils import profiling as JPR
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from sd_animation_optical_flow_tpu_torch.utils import flow_viz as TFV
from sd_animation_optical_flow_tpu_torch.utils import log_images as TLI
from sd_animation_optical_flow_tpu_torch.utils import logging_images as TLG
from sd_animation_optical_flow_tpu_torch.utils import profiling as TPR
from torch_port_common import (CLIP_KW, UNET_KW, VAE_KW, np_t,
                               perturb_zero_convs, to_port)

REPO = Path(__file__).resolve().parent.parent
MODULES_9A = ("training.degradation", "training.flow_data", "utils.flow_io",
              "utils.flow_viz", "utils.logging_images", "utils.log_images",
              "utils.profiling")


def _flow(seed, h=20, w=30, scale=6.0):
    return (np.random.default_rng(seed).standard_normal((h, w, 2))
            * scale).astype(np.float32)


HELPERS = {
    "colorwheel": lambda M: M.make_colorwheel(),
    "flow_to_image": lambda M: M.flow_to_image(_flow(0)),
    "flow_to_image_clip_bgr": lambda M: M.flow_to_image(
        _flow(1), clip_flow=3.0, convert_to_bgr=True),
    "flow_to_image_zero": lambda M: M.flow_to_image(np.zeros((4, 5, 2))),
}
GRIDS = {
    "make_grid": lambda M: M.make_grid(
        np.random.default_rng(2).random((5, 6, 7, 3)).astype(np.float32),
        nrow=2, padding=1, pad_value=0.5),
    "make_grid_u8": lambda M: M.make_grid(
        np.random.default_rng(3).integers(0, 256, (3, 4, 4, 1), np.uint8)),
    "denoise_row_grid": lambda M: M.denoise_row_grid(
        [np.random.default_rng(4 + i).random((2, 5, 5, 3)) for i in
         range(3)]),
    "to_uint8": lambda M: M.to_uint8(
        np.random.default_rng(5).uniform(-1.3, 1.3, (9, 9, 3))),
    "log_txt_as_img": lambda M: M.log_txt_as_img(
        (96, 40), ["a watercolor fox in the snow, at dusk", "b"], size=8),
}


@pytest.mark.parametrize("name", sorted(HELPERS) + sorted(GRIDS))
def test_viz_and_grid_helpers_match_jax(name):
    """flow_to_image (plain, clipped to BGR, all-zero flow), the colour
    wheel, make_grid, denoise_row_grid, to_uint8 and log_txt_as_img:
    equal arrays, dtypes and shapes."""
    fn, mods = (HELPERS[name], (TFV, JFV)) if name in HELPERS \
        else (GRIDS[name], (TLG, JLG))
    a, b = (fn(M) for M in mods)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _bundles():
    """(JAX bundle, port bundle) of the small UNet / VAE / CLIP with the
    same weights (the UNet's zero convs perturbed), f32."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    jcfg = (JU.UNetConfig(**UNET_KW), JV.VAEConfig(**VAE_KW),
            JCL.CLIPTextConfig(**CLIP_KW))
    with numpy_init():
        ps = (JU.unet_init(k1, jcfg[0]), JV.vae_init(k2, jcfg[1]),
              JCL.clip_text_init(k3, jcfg[2]))
    perturb_zero_convs(ps[0], np.random.default_rng(12))
    jsd = JF.StableDiffusionBundle(
        unet_params=ps[0], unet_cfg=jcfg[0], vae_params=ps[1],
        vae_cfg=jcfg[1], clip_params=ps[2], clip_cfg=jcfg[2],
        tokenizer=JTok(hf_name_or_path=None))
    tsd = TF.StableDiffusionBundle(
        unet_params=to_port(ps[0]), unet_cfg=TU.UNetConfig(**UNET_KW),
        vae_params=to_port(ps[1]), vae_cfg=TV.VAEConfig(**VAE_KW),
        clip_params=to_port(ps[2]), clip_cfg=TCL.CLIPTextConfig(**CLIP_KW),
        tokenizer=TTok(hf_name_or_path=None), device="cpu")
    return jsd, tsd


def test_count_params_on_a_tree_carried_across():
    jsd, tsd = _bundles()
    for j, t in ((jsd.unet_params, tsd.unet_params),
                 (jsd.vae_params, tsd.vae_params)):
        assert TLG.count_params(t) == JLG.count_params(j) > 0


def _jax_draws(seed, latent_shape, cfg):
    """The four draws the JAX ``log_images`` makes from ``seed``: the VAE
    posterior's (k_enc), the diffusion row's (k_diff), and x_T of each
    sample panel (the first key of ``split(k_samp)`` / ``split(k_cfg)``,
    as ``ddim_sample`` draws it)."""
    k_enc, k_diff, k_samp, k_cfg = jax.random.split(
        jax.random.PRNGKey(seed), 4)
    normal = lambda k: np_t(jax.random.normal(k, latent_shape))
    x_t = lambda k: normal(jax.random.split(k)[0])
    return TLI.LogImagesNoise(normal(k_enc), normal(k_diff), x_t(k_samp),
                              x_t(k_cfg) if cfg else None)


@pytest.mark.parametrize("cfg_scale", [None, 3.0])
def test_log_images_matches_jax(cfg_scale):
    """The panel dict on the small bundle, 2 images of 32x48, 3 DDIM
    steps, with JAX's draws fed in: the same keys, shapes and uint8
    panels within 1 LSB; without ``noise`` the port draws its own from
    the seed (the same keys, samples that differ)."""
    jsd, tsd = _bundles()
    imgs = np.random.default_rng(13).uniform(-1, 1, (2, 32, 48, 3)) \
        .astype(np.float32)
    kw = dict(ddim_steps=3, cfg_scale=cfg_scale, n_diffusion_row=3, seed=4)
    prompts = ["a watercolor fox", "an oil harbour"]
    want = JLI.log_images(jsd, imgs, prompts, **kw)
    f = tsd.vae_cfg.downscale
    noise = _jax_draws(4, (2, 32 // f, 48 // f, 4), cfg_scale is not None)
    got = TLI.log_images(tsd, imgs, prompts, noise=noise, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.uint8 and got[k].shape == want[k].shape
        diff = np.abs(got[k].astype(int) - want[k].astype(int))
        assert diff.max() <= 1, (k, diff.max())
    own = TLI.log_images(tsd, imgs, prompts, **kw)
    assert own.keys() == want.keys()
    assert not np.array_equal(own["samples"], got["samples"])


def test_stage_timer_trace_and_annotate(tmp_path):
    """``trace`` writes a Chrome trace to its directory holding the
    ``annotate`` range; outside a profile ``annotate`` is the module's one
    null context, and the port keeps no stage timer of its own (JAX's
    ``StageTimer`` / ``stage`` have no counterpart: the ranges in the
    profiler's trace take their place)."""
    assert TPR.annotate("sdaof_region") is TPR.NULL_SPAN
    for name in ("StageTimer", "stage", "GLOBAL_TIMER"):
        assert hasattr(JPR, name) and not hasattr(TPR, name), name
    with TPR.trace(str(tmp_path / "tr")):
        with TPR.annotate("sdaof_region"):
            torch.ones(8).sum()
    files = list((tmp_path / "tr").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sdaof_region" for e in events)
    assert TPR.annotate("sdaof_region") is TPR.NULL_SPAN


def test_9a_modules_import_without_cv2_and_pil(tmp_path):
    """In a fresh interpreter where cv2 and PIL (and JAX) cannot be
    imported: every 9a module imports, the numpy paths run, and a cv2 or
    PIL path raises ImportError when called."""
    code = f"""
import sys
for n in ('cv2', 'PIL', 'jax', 'jaxlib', 'sd_animation_optical_flow_tpu'):
    sys.modules[n] = None
import importlib
import numpy as np
mods = {{m: importlib.import_module('sd_animation_optical_flow_tpu_torch.'
                                   + m) for m in {MODULES_9A!r}}}
io = mods['utils.flow_io']
flow = np.ones((3, 4, 2), np.float32)
io.write_flo({str(tmp_path / 'a.flo')!r}, flow)
assert (io.read_flo({str(tmp_path / 'a.flo')!r}) == flow).all()
assert mods['utils.flow_viz'].flow_to_image(flow).shape == (3, 4, 3)
assert mods['utils.logging_images'].count_params({{'w': flow}}) == 24
calls = [lambda: io.read_flow_kitti('x.png'),
         lambda: mods['training.degradation'].add_jpeg_noise(
             flow[..., :1].repeat(3, -1), np.random.default_rng(0)),
         lambda: mods['training.flow_data'].FlowAugmentor((2, 2))
             .spatial_transform(flow, flow, flow, np.random.default_rng(0)),
         lambda: mods['utils.logging_images'].log_txt_as_img((8, 8), ['a'])]
for call in calls:
    try:
        call()
        raise SystemExit('ran without cv2 / PIL')
    except ImportError:
        pass
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
