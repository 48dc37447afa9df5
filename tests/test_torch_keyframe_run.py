"""Port parity: the keyframe pipeline's generation — the four modes of
``generate_with_refs``, ``generate_seed_frames`` and ``run`` end to end —
against the JAX ``pipelines/keyframe_inpaint.py`` on the CPU; and the
level-batched back-fill against the port's serial loop.

Tiny bundles on shared weights (VAE 16 x (1, 2, 2, 2), a /8 latent as
SD's, so the ControlNet hint of a frame meets its latent; UNet 16 x (1,
2) with attention at the first level; CLIP 32 x 1; the zero-initialised
output convs perturbed), a ControlNet of the 4-channel UNet's config
(HED by its Sobel fallback), and the tiny random RAFT of
``tests/test_torch_keyframe_pipeline.py``. The port's noise draws are
replaced (``unittest.mock``) by the JAX program's noises for each call's
latent shape (strips and batches change it). Gate: every generated frame
at >= 40 dB PSNR of JAX's (peak 255), BASELINE.md's pipeline gate; ``run``
also picks the same key frames (``dNN/``) and writes the same files.
``warp_and_inpaint`` at ``level_batch`` 4 against the serial loop: every
frame within 1 LSB on >= 99% of its pixels (the JAX test's bar)."""

import os
import shutil
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import controlnet as JCN
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import keyframe_inpaint as JKI
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import controlnet as TCN
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines import \
    keyframe_inpaint as TKI
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from test_pipeline import _synthetic_frames
from test_torch_guidance import _img2img_noise
from test_torch_inpaint import jax_noise
from test_torch_keyframe_pipeline import raft_pair  # noqa: F401
from test_torch_pixel import _psnr255
from torch_port_common import perturb_zero_convs, to_port

KW = dict(denoising_strength=0.3, ddim_steps=8)


def _bundles(key, in_channels):
    """A tiny SD bundle in both frameworks, on shared weights."""
    kv, ku, kc = jax.random.split(key, 3)
    vcfg = JV.VAEConfig(ch=16, ch_mult=(1, 2, 2, 2), num_res_blocks=1)
    ucfg = JU.UNetConfig(in_channels=in_channels, model_channels=16,
                         channel_mult=(1, 2), attention_resolutions=(1,),
                         num_heads=2, context_dim=32)
    ccfg = JCL.CLIPTextConfig(vocab_size=49408, width=32, layers=1, heads=2)
    with numpy_init():
        jsd = JF.StableDiffusionBundle(
            unet_params=JU.unet_init(ku, ucfg), unet_cfg=ucfg,
            vae_params=JV.vae_init(kv, vcfg), vae_cfg=vcfg,
            clip_params=JCL.clip_text_init(kc, ccfg), clip_cfg=ccfg,
            tokenizer=JTok(hf_name_or_path=None))
    perturb_zero_convs(jsd.unet_params, np.random.default_rng(in_channels))
    tsd = TF.StableDiffusionBundle(
        unet_params=to_port(jsd.unet_params),
        unet_cfg=TU.UNetConfig(**ucfg.__dict__),
        vae_params=to_port(jsd.vae_params),
        vae_cfg=TV.VAEConfig(**vcfg.__dict__),
        clip_params=to_port(jsd.clip_params),
        clip_cfg=TCL.CLIPTextConfig(**ccfg.__dict__),
        tokenizer=TTok(hf_name_or_path=None), device="cpu")
    return jsd, tsd


@pytest.fixture(scope="module")
def models(raft_pair):  # noqa: F811
    """((JAX sd, sd9, estimator, control bundle), (the port's))."""
    k4, k9, kc = jax.random.split(jax.random.PRNGKey(31), 3)
    (jsd, tsd), (jsd9, tsd9) = _bundles(k4, 4), _bundles(k9, 9)
    with numpy_init():
        cn = JCN.controlnet_init(kc, jsd.unet_cfg)
    perturb_zero_convs(cn, np.random.default_rng(2))
    jest, test = raft_pair
    return ((jsd, jsd9, jest, (cn, jsd.unet_cfg, None)),
            (tsd, tsd9, test, (to_port(cn), tsd.unet_cfg, None)))


def _jax_noises(seed=1234):
    """Feed the port the JAX program's noises of PRNGKey(seed) for each
    call's latent shape: img2img's (the seed strip) and the inpaint's
    (single frames, strips and level batches)."""
    def img2img_noise(gen, latent_shape, t_enc, *, target, pixel, device):
        return _img2img_noise(seed, tuple(latent_shape), t_enc,
                              target=target, pixel=pixel)

    def inpaint_noise(gen, latent_shape, n_slots, *, has_reference,
                      tile_noise, tile_renoise, device):
        return jax_noise(seed, tuple(latent_shape), n_slots, n_slots, "ddim",
                         tile_noise=tile_noise, has_reference=has_reference)
    return mock.patch.multiple(TF, draw_img2img_noise=img2img_noise,
                               draw_inpaint_noise=inpaint_noise)


def _cfg(mod, **kw):
    return mod.KeyframeInpaintConfig(size=(64, 64), keep_every=1, **kw)


# ---------------------------------------------------------------------------
# config, prompt, controls
# ---------------------------------------------------------------------------

def test_keyframe_config_prompt_and_controls_match_jax(tmp_path, models):
    """The config's fields and defaults, the prompt and the default
    controls' hints equal JAX's; a sequence-parallel ``sp`` reaches the
    facades, which refuse one that is not a SeqParallelConfig."""
    jd, td = JKI.KeyframeInpaintConfig().__dict__, \
        TKI.KeyframeInpaintConfig().__dict__
    assert jd == td
    assert TKI.KeyframeInpaintConfig.guidance_schedule_func(0.3) == 1.0

    class Tagger:
        available = True

        def build_prompt(self, frame, extra):
            return "tagged," + extra
    for tagger in (None, Tagger()):
        for extra in ("", "x,y"):
            assert TKI._prompt(tagger, None, extra) == \
                JKI._prompt(tagger, None, extra)
    frame = np.ascontiguousarray(_synthetic_frames(2, 64, 64)[1])
    (_, _, _, jctl), (_, _, _, tctl) = models
    want = JKI._default_controls(jctl, frame)
    got = TKI._default_controls(tctl, frame, device="cpu")
    assert TKI._default_controls(None, frame) == ()
    for g, w in zip(got, want):
        assert (g.weight, g.guidance_start, g.guidance_end) == \
            (w.weight, w.guidance_start, w.guidance_end)
        assert g.hint.shape == (2, 64, 64, 3)
        assert np.abs(g.hint.numpy() - np.asarray(w.hint)).max() < 1e-6
    ws = TKI.VideoWorkspace(str(tmp_path / "ws"), frames=[frame],
                            size=(64, 64), keep_every=1, device="cpu")
    with pytest.raises(TypeError, match="SeqParallelConfig"):
        TKI.generate_seed_frames(models[1][0], None, ws,
                                 TKI.FrameIndices([0]),
                                 _cfg(TKI, sp=object(), **KW))


# ---------------------------------------------------------------------------
# generation steps
# ---------------------------------------------------------------------------

def _seeded_workspaces(tmp_path, models, frames, refs):
    """JAX and port workspaces over ``frames`` whose reference frames have
    AI frames (the raw frames, brightened) and the same K/V stores
    (captured by the JAX img2img, one file copied to both)."""
    (jsd, _, _, _), _ = models
    jws = JKI.VideoWorkspace(str(tmp_path / "jax"), frames=frames,
                             size=(64, 64), keep_every=1)
    tws = TKI.VideoWorkspace(str(tmp_path / "port"), frames=frames,
                             size=(64, 64), keep_every=1, device="cpu")
    for r in refs:
        ai = np.clip(frames[r].astype(np.int16) + 20, 0, 255).astype(np.uint8)
        jws.put_ai_frame(r, ai)
        tws.put_ai_frame(r, ai)
        _, kv = JF.img2img(jsd, JKI.bgr_u8_to_model(frames[r]), "a", "",
                           0.3, 8, capture_kv=True)
        jws.put_kv(r, kv)
        shutil.copy(jws._kv(r), tws._kv(r))
    return jws, tws


GEN_CASES = {
    "warp_and_inpaint_crossattn": dict(mode="warp_and_inpaint_crossattn"),
    "crossattn, staged prep": dict(mode="warp_and_inpaint_crossattn",
                                   fused_prep=False),
    "warp_and_inpaint": dict(mode="warp_and_inpaint"),
    "self_attn": dict(mode="self_attn"),
    "both, with controls": dict(mode="both", controls=True),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_with_refs_matches_jax(tmp_path, models, case):
    """Frame 2 from references 0 and 3 (K/V of both injected in the
    crossattn modes): the frame at >= 40 dB of JAX's, the warp modes'
    vis panel written, the K/V captured where JAX captures."""
    kw = dict(GEN_CASES[case])
    controls = kw.pop("controls", False)
    (jsd, jsd9, jest, jctl), (tsd, tsd9, test, tctl) = models
    frames = _synthetic_frames(4, 64, 64)
    jws, tws = _seeded_workspaces(tmp_path, models, frames, [0, 3])
    jcfg = _cfg(JKI, num_ref_for_generation=2, **kw, **KW)
    tcfg = _cfg(TKI, num_ref_for_generation=2, **kw, **KW)
    jfc = JKI.FlowCache(jest, jws.workspace_dir)
    tfc = TKI.FlowCache(test, tws.workspace_dir)
    jframe, jkv = JKI.generate_with_refs(
        jsd9, None, jws, 2, JKI.FrameIndices([0, 3]), jfc, jcfg,
        control_bundle=jctl if controls else None,
        reference_kv=[jws.get_kv(0), jws.get_kv(3)], level=1,
        workspace=jws.workspace_dir)
    with _jax_noises():
        tframe, tkv = TKI.generate_with_refs(
            tsd9, None, tws, 2, TKI.FrameIndices([0, 3]), tfc, tcfg,
            control_bundle=tctl if controls else None,
            reference_kv=[tws.get_kv(0), tws.get_kv(3)], level=1,
            workspace=tws.workspace_dir)
    psnr = _psnr255(tframe, jframe)
    print(f"\n[generate_with_refs {case}] PSNR {psnr:.1f} dB")
    assert tframe.shape == (64, 64, 3) and psnr >= 40.0
    assert (tkv is None) == (jkv is None)
    if tkv is not None:
        assert [k.shape for k, _ in tkv] == [k.shape for k, _ in jkv]
    vis = os.path.join("render_vis", "u01", "00002.png")
    assert os.path.exists(os.path.join(tws.workspace_dir, vis)) == \
        os.path.exists(os.path.join(jws.workspace_dir, vis))
    if kw["mode"].startswith("warp"):
        assert _psnr255(TKI.read_png_bgr(os.path.join(tws.workspace_dir,
                                                      vis)),
                        TKI.read_png_bgr(os.path.join(jws.workspace_dir,
                                                      vis))) >= 40.0


@pytest.mark.parametrize("n_seed", [1, 2])
def test_generate_seed_frames_matches_jax(tmp_path, models, n_seed):
    """The seed strip ('mutual' for 2 frames): each frame at >= 40 dB of
    JAX's, the strip's K/V captured."""
    (jsd, _, _, _), (tsd, _, _, _) = models
    frames = _synthetic_frames(4, 64, 64)
    jws = JKI.VideoWorkspace(str(tmp_path / "jax"), frames=frames,
                             size=(64, 64), keep_every=1)
    tws = TKI.VideoWorkspace(str(tmp_path / "port"), frames=frames,
                             size=(64, 64), keep_every=1, device="cpu")
    seeds = [0, 3][:n_seed]
    jout, jkv = JKI.generate_seed_frames(jsd, None, jws,
                                         JKI.FrameIndices(seeds),
                                         _cfg(JKI, **KW))
    with _jax_noises():
        tout, tkv = TKI.generate_seed_frames(tsd, None, tws,
                                             TKI.FrameIndices(seeds),
                                             _cfg(TKI, **KW))
    assert len(tout) == n_seed
    for t, j in zip(tout, jout):
        psnr = _psnr255(t, j)
        print(f"\n[seed strip of {n_seed}] PSNR {psnr:.1f} dB")
        assert t.shape == (64, 64, 3) and psnr >= 40.0
    assert [k.shape for k, _ in tkv] == [k.shape for k, _ in jkv]


# ---------------------------------------------------------------------------
# run end to end
# ---------------------------------------------------------------------------

def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("level_batch", [1, 3])
def test_run_crossattn_matches_jax(tmp_path, models, level_batch):
    """run in warp_and_inpaint_crossattn on 6 synthetic frames (windows of
    3, two seed frames): the same key frames at each level, the same
    files, every AI frame at >= 40 dB of JAX's; serial (level_batch 1)
    and in chunks of 3."""
    (jsd, jsd9, jest, _), (tsd, tsd9, test, _) = models
    frames = _synthetic_frames(6, 64, 64)
    kw = dict(kernel_size=3, stride=3, dilation=1, n_seed_frames=2,
              num_ref_for_generation=1, level_batch=level_batch, **KW)
    jws = JKI.VideoWorkspace(str(tmp_path / "jax"), frames=frames,
                             size=(64, 64), keep_every=1)
    JKI.run(jws, jsd, jsd9, jest, tagger=None, cfg=_cfg(JKI, **kw))
    tws = TKI.VideoWorkspace(str(tmp_path / "port"), frames=frames,
                             size=(64, 64), keep_every=1, device="cpu")
    with _jax_noises():
        out = TKI.run(tws, tsd, tsd9, test, tagger=None,
                      cfg=_cfg(TKI, **kw))
    assert out == tws.workspace_dir
    tree = _tree(tws.workspace_dir)
    assert tree == _tree(jws.workspace_dir)
    print(f"\n[run crossattn, level_batch {level_batch}] key frames "
          + ", ".join(f for f in tree if f.startswith("d")))
    psnr = [_psnr255(tws.get_ai_frame(i), jws.get_ai_frame(i))
            for i in range(6)]
    print(f"\n[run crossattn, level_batch {level_batch}] AI-frame PSNR "
          + ", ".join(f"{p:.1f}" for p in psnr))
    assert all(p >= 40.0 for p in psnr), psnr


def test_level_batched_warp_and_inpaint_matches_serial(tmp_path, models):
    """warp_and_inpaint (no K/V chain) at level_batch 4 against the serial
    loop, the port's own: every frame within 1 LSB on >= 99% of its
    pixels, the JAX test's bar for its own two routes."""
    _, (tsd, tsd9, test, _) = models
    frames = _synthetic_frames(5, 64, 64)
    outs = {}
    for tag, lb in (("serial", 1), ("batched", 4)):
        ws = TKI.VideoWorkspace(str(tmp_path / tag), frames=frames,
                                size=(64, 64), keep_every=1, device="cpu")
        TKI.run(ws, tsd, tsd9, test, cfg=_cfg(
            TKI, kernel_size=5, stride=5, dilation=1, n_seed_frames=1,
            mode="warp_and_inpaint", level_batch=lb,
            denoising_strength=0.3, ddim_steps=6))
        outs[tag] = [ws.get_ai_frame(i) for i in range(ws.num_frames)]
    for i, (a, b) in enumerate(zip(outs["serial"], outs["batched"])):
        close = np.mean(np.abs(a.astype(np.int16) - b.astype(np.int16)) <= 1)
        assert close > 0.99, f"frame {i}: {close}"
