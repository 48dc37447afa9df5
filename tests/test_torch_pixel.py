"""Port parity: the pixel-inpaint pipeline — the image conversions, the
PNG writer and reader, ``generate_mask``, ``mix_propagated_ai_frame``,
and ``run`` end to end against the JAX ``pixel_inpaint.run`` — on the
CPU; and the pixel path's modules with cv2 made unimportable.

``run`` end to end: the tiny bundles of ``tests/test_pipeline.py`` (VAE
16 x (1, 2), UNet 16 x (1, 2), CLIP 32 x 1) and a tiny random RAFT
(2 iterations, 2 levels, radius 2, bf16 correlation storage) on the same
weights in both frameworks, the synthetic frames of
``tests/test_pipeline.py`` with key frames at 0 and 3. The port's noise
draws are replaced (``unittest.mock``) by the JAX program's noises,
rebuilt along its key splits. Gate: the same file names, and every
``converted_*.png`` at >= 40 dB PSNR of the JAX frame (peak 255).

``run_batched`` against the port's own ``run`` (every converted_ frame
within 1 LSB, as JAX's ``test_run_batched_matches_run`` holds it) at
frame batches 2 and 3, tail padding on and off, and against JAX's
``run_batched``; ``run_video`` against JAX's on an encoded clip (the 40
dB gate)."""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import flowconf as JFC
from sd_animation_optical_flow_tpu.models import raft as JR
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import pixel_inpaint as JPI
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu.utils import images as JIM
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import flowconf as TFC
from sd_animation_optical_flow_tpu_torch.models import raft as TR
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines import \
    pixel_inpaint as TPI
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from sd_animation_optical_flow_tpu_torch.utils import images as TIM
from test_pipeline import _synthetic_frames
from test_torch_inpaint import jax_noise
from torch_port_common import np_t, to_port

REPO = Path(__file__).resolve().parent.parent


def _psnr255(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ---------------------------------------------------------------------------
# images and PNG files
# ---------------------------------------------------------------------------

def test_image_conversions_match_jax(np_rng):
    """The BGR <-> model conversions: floats within 1e-6, uint8 equal (the
    port's bgr_f32_to_u8 floors after the clip, as the JAX one does)."""
    bgr = np_rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    m = TIM.bgr_u8_to_model(bgr, "cpu")
    assert np.abs(m.numpy() - np.asarray(JIM.bgr_u8_to_model(bgr))).max() \
        < 1e-6
    img = np_rng.uniform(-1.2, 1.2, (1, 6, 9, 3)).astype(np.float32)
    assert np.array_equal(TIM.model_to_bgr_u8(np_t(img)),
                          JIM.model_to_bgr_u8(img))
    assert np.array_equal(TIM.rgb_u8(np_t(img)), JIM.rgb_u8(jnp.asarray(img)))
    d = np_rng.uniform(-20, 280, (6, 9, 3)).astype(np.float32)
    assert np.abs(TIM.bgr_f32d_to_model(np_t(d)).numpy() - np.asarray(
        JIM.bgr_f32d_to_model(jnp.asarray(d)))).max() < 1e-6
    assert np.abs(TIM.model_to_bgr_f32d(np_t(img)).numpy() - np.asarray(
        JIM.model_to_bgr_f32d(jnp.asarray(img)))).max() < 1e-4
    assert np.array_equal(TIM.bgr_f32_to_u8(np_t(d)),
                          JIM.bgr_f32_to_u8(jnp.asarray(d)))


@pytest.mark.parametrize("shape", [(7, 11, 3), (7, 11), (1, 1, 3),
                                   (64, 96, 3)])
def test_png_round_trip_and_cv2_parity(np_rng, tmp_path, shape):
    """write_png -> read_png_bgr gives the pixels back (gray as 3 equal
    channels), and cv2.imread decodes the file to the same pixels."""
    img = np_rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "sub" / "a.png")
    TIM.write_png(path, img)
    back = TIM.read_png_bgr(path)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    assert back.shape == want.shape and np.array_equal(back, want)
    cv2 = pytest.importorskip("cv2")
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_COLOR), want)


def test_png_reader_takes_cv2_files(np_rng, tmp_path):
    """Files cv2 writes (libpng's adaptive row filters, gray and color)
    read to cv2's pixels; PngWriter writes behind and drains on close."""
    cv2 = pytest.importorskip("cv2")
    yy, xx = np.mgrid[:40, :56]
    smooth = np.stack([(xx * 4) % 256, (yy * 6) % 256, (xx + yy) % 256],
                      -1).astype(np.uint8)
    for i, img in enumerate([smooth, smooth[..., 1], np_rng.integers(
            0, 256, (40, 56, 3), dtype=np.uint8)]):
        path = str(tmp_path / f"cv{i}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
        assert np.array_equal(TIM.read_png_bgr(path),
                              cv2.imread(path, cv2.IMREAD_COLOR))
    with TIM.PngWriter() as w:
        for i in range(4):
            w.submit(str(tmp_path / f"w{i}.png"), smooth)
    for i in range(4):
        assert np.array_equal(TIM.read_png_bgr(str(tmp_path / f"w{i}.png")),
                              smooth)


def test_pixel_path_runs_without_cv2(tmp_path):
    """ellipse_kernel, the PNG writer and reader, dilate, the warp and the
    pipeline module import and run in a fresh interpreter with cv2 (and
    JAX) made unimportable."""
    code = (
        "import sys\n"
        "for n in ('cv2', 'jax', 'jaxlib', 'sd_animation_optical_flow_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import numpy as np, torch\n"
        "from sd_animation_optical_flow_tpu_torch.ops import filters, warp\n"
        "from sd_animation_optical_flow_tpu_torch.utils import images\n"
        "from sd_animation_optical_flow_tpu_torch.pipelines import "
        "pixel_inpaint\n"
        "k = filters.ellipse_kernel(7)\n"
        "assert k.sum() == 33\n"
        "img = np.arange(5 * 6 * 3, dtype=np.uint8).reshape(5, 6, 3)\n"
        f"p = {str(tmp_path / 'x.png')!r}\n"
        "images.write_png(p, img)\n"
        "assert (images.read_png_bgr(p) == img).all()\n"
        "m = filters.dilate(torch.zeros(9, 9), k)\n"
        "w, _ = warp.warp_mask_fused(torch.zeros(8, 8, 3), "
        "torch.zeros(8, 8, 2), torch.ones(8, 8), k)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# pipeline helpers
# ---------------------------------------------------------------------------

def test_generate_mask_and_mix_match_jax(np_rng):
    """generate_mask (threshold, dilation, log-confidence reset) and
    mix_propagated_ai_frame at weights 0, 0.3 and 1: equal."""
    conf = np_rng.uniform(0.7, 1.0, (30, 40)).astype(np.float32)
    conf[conf < 0.95] = np.where(np_rng.uniform(size=(conf < 0.95).sum())
                                 < 0.05, conf[conf < 0.95], 0.97)
    logc = np.log(conf)
    tm, tl = TPI.generate_mask(conf, logc, thres=0.95, dilate_size=5,
                               device="cpu")
    jm, jl = JPI.generate_mask(conf, logc, thres=0.95, dilate_size=5)
    assert tm.dtype == np.uint8 and np.array_equal(tm, jm)
    assert np.array_equal(tl, jl) and 0 < (tm > 0).mean() < 1
    raw = np_rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    warped = np_rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    for wt in (0.0, 0.3, 1.0):
        assert np.array_equal(
            TPI.mix_propagated_ai_frame(raw, warped, tm, wt),
            JPI.mix_propagated_ai_frame(raw, warped, jm, wt))


def test_prompt_and_unported_hooks():
    """The prompt falls back to the fixed prefix without a tagger (or an
    unavailable one) and takes the tagger's otherwise; run_batched's
    data parallelism (dp > 0) needs a process group of world size dp and
    raises without one (no fallback to one device)."""
    class Tagger:
        available = True

        def build_prompt(self, frame, extra):
            return "tagged," + extra
    assert TPI._prompt_for(None, None, "") == JPI._prompt_for(None, None, "")
    assert TPI._prompt_for(None, None, "x") == JPI._prompt_for(None, None,
                                                               "x")
    assert TPI._prompt_for(Tagger(), None, "y") == "tagged,y"
    Tagger.available = False
    assert TPI._prompt_for(Tagger(), None, "") == "masterpiece,best quality"
    assert TPI.NEGATIVE_PROMPT == JPI.NEGATIVE_PROMPT
    assert TPI.PixelInpaintConfig().__dict__.keys() - {
        "guidance_schedule_func"} == JPI.PixelInpaintConfig().__dict__.keys() \
        - {"guidance_schedule_func"}
    for k, v in TPI.PixelInpaintConfig().__dict__.items():
        if k != "guidance_schedule_func":
            assert v == getattr(JPI.PixelInpaintConfig(), k), k
    with pytest.raises(RuntimeError, match="process group"):
        TPI.run_batched(iter([]), "out", None,
                        SimpleNamespace(device=torch.device("cpu")), None,
                        cfg=TPI.PixelInpaintConfig(frame_batch=2, dp=2))


# ---------------------------------------------------------------------------
# run end to end
# ---------------------------------------------------------------------------

def _tiny_bundles(rng, in_channels):
    """The tiny bundle of tests/test_pipeline.py in both frameworks."""
    kv, ku, kc = jax.random.split(rng, 3)
    vcfg = JV.VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1)
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
def tiny():
    """The tiny bundles (4- and 9-channel) and a tiny random RAFT, the same
    weights in both frameworks: (JAX sd, sd9, estimator), (port sd, sd9,
    estimator)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    (jsd, tsd), (jsd9, tsd9) = _tiny_bundles(k1, 4), _tiny_bundles(k2, 9)
    rcfg = JR.RAFTConfig(iters=2, corr_levels=2, corr_radius=2)
    with numpy_init():
        rp = JR.raft_init(jax.random.PRNGKey(11), rcfg)
    jest = JFC.FlowConfidenceEstimator(rp, JFC.FlowConfidenceConfig(
        raft=rcfg))
    test = TFC.FlowConfidenceEstimator(
        to_port(rp), TFC.FlowConfidenceConfig(
            raft=TR.RAFTConfig(**rcfg.__dict__)), device="cpu")
    return (jsd, jsd9, jest), (tsd, tsd9, test)


def _jax_noises():
    """Patches that feed the port the JAX program's noises for seed 1234:
    img2img's posterior and forward noise (split 3, then the core's split
    3), the inpaint's along _inpaint_fused's splits (t_enc 3 of 10 DDIM
    steps; [1, ...] noises, which a batch shares as JAX's does)."""
    lat = (1, 32, 32, 4)
    k_enc, _, k_core = jax.random.split(jax.random.PRNGKey(1234), 3)
    enc_noise = np_t(jax.random.normal(k_enc, lat))
    fwd_noise = np_t(jax.random.normal(jax.random.split(k_core, 3)[0], lat))
    inpaint_noise = jax_noise(1234, lat, 3, 3, "ddim", tile_noise=False,
                              has_reference=True)
    core = TF._img2img_core

    def img2img_core(sd, img, ctx_c, ctx_u, enc, noise, **kwargs):
        return core(sd, img, ctx_c, ctx_u, enc_noise, fwd_noise, **kwargs)
    return (mock.patch.object(TF, "_img2img_core", img2img_core),
            mock.patch.object(TF, "draw_inpaint_noise",
                              lambda *a, **k: inpaint_noise))


def _converted_psnr(tdir, jdir, label):
    """The same file names in both directories; each converted_ frame's
    PSNR (printed) of the port's against JAX's."""
    import cv2
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    out = {}
    for name in names:
        ours = TIM.read_png_bgr(os.path.join(tdir, name))
        theirs = cv2.imread(os.path.join(jdir, name), cv2.IMREAD_COLOR)
        assert ours.shape == theirs.shape, name
        if name.startswith("converted_"):
            out[name] = _psnr255(ours, theirs)
            print(f"\n[{label}] {name} PSNR {out[name]:.1f} dB")
    return out


KW = dict(denoising_strength=0.3, ddim_steps=10)


def test_pixel_inpaint_run_matches_jax(tmp_path, tiny):
    (jsd, jsd9, jest), (tsd, tsd9, test) = tiny
    frames = _synthetic_frames(n=6)
    # key frames at 0 and at the scene cut: the non-key frames 1 and 4
    # take the flow queued by the key frame, 2 and 5 the flow queued by
    # the frame before them
    triples = [(f, i in (0, 3), i) for i, f in enumerate(frames)]
    jdir = JPI.run(iter(triples), str(tmp_path / "jax"), jsd, jsd9, jest,
                   cfg=JPI.PixelInpaintConfig(size=(64, 64), **KW))
    p1, p2 = _jax_noises()
    with p1, p2:
        tdir = TPI.run(iter(triples), str(tmp_path / "port"), tsd, tsd9,
                       test, cfg=TPI.PixelInpaintConfig(**KW))
    assert tdir.endswith("port_pixel_warp-tpu")
    psnr = _converted_psnr(tdir, jdir, "pixel run")
    assert len(psnr) == 6
    assert all(v >= 40.0 for v in psnr.values()), psnr
    # every non-key frame inpainted part of itself: its confidence map
    # has pixels on both sides of the 0.95 threshold
    for i in (1, 2, 4, 5):
        conf = TIM.read_png_bgr(os.path.join(
            tdir, f"pixel_confidence_{i:06d}.png"))[..., 0]
        assert (conf < 0.95 * 255).any() and (conf >= 0.95 * 255).any(), i


# ---------------------------------------------------------------------------
# run_batched and run_video
# ---------------------------------------------------------------------------

def _segment_triples():
    """10 synthetic frames, key frames at 0 and at the scene cut (5): two
    segments of four non-key frames each."""
    return [(f, i in (0, 5), i)
            for i, f in enumerate(_synthetic_frames(n=10))]


@pytest.fixture(scope="module")
def port_run(tiny, tmp_path_factory):
    """The port's sequential run over ``_segment_triples`` (vis written)."""
    _, (tsd, tsd9, test) = tiny
    return TPI.run(iter(_segment_triples()),
                   str(tmp_path_factory.mktemp("seq") / "clip"), tsd, tsd9,
                   test, cfg=TPI.PixelInpaintConfig(**KW))


@pytest.mark.parametrize("frame_batch,pad", [(2, True), (2, False),
                                             (3, True), (3, False)])
def test_run_batched_matches_port_run(tiny, port_run, tmp_path,
                                      frame_batch, pad):
    """run_batched writes run's files, every converted_ frame within 1
    LSB of run's: batches of 2 (two full batches a segment) and of 3 (a
    ragged tail of 1, padded or not)."""
    _, (tsd, tsd9, test) = tiny
    cfg = TPI.PixelInpaintConfig(frame_batch=frame_batch, pad_tail_batch=pad,
                                 **KW)
    bdir = TPI.run_batched(iter(_segment_triples()), str(tmp_path / "bat"),
                           tsd, tsd9, test, cfg=cfg)
    names = sorted(os.listdir(port_run))
    assert sorted(os.listdir(bdir)) == names and len(names) == 30
    for name in names:
        a = TIM.read_png_bgr(os.path.join(port_run, name)).astype(np.int16)
        b = TIM.read_png_bgr(os.path.join(bdir, name)).astype(np.int16)
        if name.startswith("converted_"):
            assert np.abs(a - b).max() <= 1, name
        else:
            assert a.shape == b.shape, name


def test_process_batch_matches_port_run(tiny, port_run, tmp_path):
    """The batch helpers without run_batched's pipeline: the first
    segment's four non-key frames through _dispatch_batch_flow and
    _process_batch (dispatch + finalize back to back), against the key
    frame's AI frame from run, write run's converted_ frames within 1
    LSB."""
    _, (tsd, tsd9, test) = tiny
    triples = _segment_triples()
    key = triples[0][0]
    key_ai = TIM.read_png_bgr(os.path.join(port_run, "converted_000000.png"))
    batch = [(f, i) for f, _, i in triples[1:5]]
    cfg = TPI.PixelInpaintConfig(**KW)
    flow_pair = TPI._dispatch_batch_flow(batch, key, test, flow_chunk=3)
    assert flow_pair[0].shape == (4, 64, 64, 2)
    TPI._process_batch(batch, flow_pair, str(tmp_path), key, key_ai, tsd9,
                       None, cfg)
    for _, i in batch:
        name = f"converted_{i:06d}.png"
        a = TIM.read_png_bgr(os.path.join(port_run, name)).astype(np.int16)
        b = TIM.read_png_bgr(str(tmp_path / name)).astype(np.int16)
        assert np.abs(a - b).max() <= 1, name
    assert len(os.listdir(tmp_path)) == 12         # converted, conf, vis


def test_run_batched_matches_jax(tiny, tmp_path):
    """The port's run_batched against JAX's on the same weights and
    noises, frame batch 3 (a padded ragged tail): the same files, every
    converted_ frame at >= 40 dB of JAX's."""
    (jsd, jsd9, jest), (tsd, tsd9, test) = tiny
    triples = _segment_triples()
    jdir = JPI.run_batched(iter(triples), str(tmp_path / "jax"), jsd, jsd9,
                           jest, cfg=JPI.PixelInpaintConfig(
                               size=(64, 64), frame_batch=3, **KW))
    p1, p2 = _jax_noises()
    with p1, p2:
        tdir = TPI.run_batched(iter(triples), str(tmp_path / "port"), tsd,
                               tsd9, test, cfg=TPI.PixelInpaintConfig(
                                   frame_batch=3, **KW))
    psnr = _converted_psnr(tdir, jdir, "pixel run_batched")
    assert len(psnr) == 10
    assert all(v >= 40.0 for v in psnr.values()), psnr


def test_run_video_matches_jax(tiny, tmp_path):
    """run_video on an encoded clip (12 synthetic frames, keep_every 3,
    key frames detected) against JAX's run_video: the same files, every
    converted_ frame at >= 40 dB of JAX's."""
    from test_video_io import _write_video
    (jsd, jsd9, jest), (tsd, tsd9, test) = tiny
    path = str(tmp_path / "clip.avi")
    if not _write_video(path, _synthetic_frames(12, 64, 64)):
        pytest.skip("no cv2 video encoder available")
    kw = dict(size=(64, 64), keep_every=3, **KW)
    jdir = JPI.run_video(path, str(tmp_path / "jax"), jsd, jsd9, jest,
                         cfg=JPI.PixelInpaintConfig(**kw))
    p1, p2 = _jax_noises()
    with p1, p2:
        tdir = TPI.run_video(path, str(tmp_path / "port"), tsd, tsd9, test,
                             cfg=TPI.PixelInpaintConfig(**kw))
    psnr = _converted_psnr(tdir, jdir, "pixel run_video")
    assert len(psnr) == 4
    assert all(v >= 40.0 for v in psnr.values()), psnr
