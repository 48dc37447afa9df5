"""Port parity: key-frame detection — ``ops/filters.canny`` against
``cv2.Canny`` (pixel for pixel), and ``pipelines/keyframes.py``
(``EdgeDetector``, ``array_frame_generator``, ``frame_generator``) against
the JAX module — on the CPU; and the video paths (key frames, tagger,
parity report, ``run_batched``) with cv2 made unimportable.

Every edge map is integer arithmetic, so the gate is equality. The area
resize of a frame to the configured size is f32 arithmetic rounded half
up, where cv2 works in fixed point: the resized frames are held within
1 LSB of cv2's."""

import ast
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.pipelines import keyframes as JK
from sd_animation_optical_flow_tpu_torch.ops.filters import canny
from sd_animation_optical_flow_tpu_torch.pipelines import keyframes as TK
from test_pipeline import _synthetic_frames

REPO = Path(__file__).resolve().parent.parent

# threshold pairs: in order, reversed, fractional, and low enough that
# hysteresis carries weak edges far from the strong ones
THRESHOLDS = [(20, 60), (60, 20), (5.7, 30.2), (1, 250)]


def _blurred_noise(rng, h, w, sigma, channels=None):
    shape = (h, w) if channels is None else (h, w, channels)
    base = rng.integers(0, 256, shape, dtype=np.uint8)
    return cv2.GaussianBlur(base, (0, 0), sigma)


def _lines(h=96, w=160):
    """One-pixel lines (horizontal, vertical, diagonal, a spiral) over a
    smooth ramp: long edges and thin ridges."""
    yy, xx = np.mgrid[:h, :w]
    img = (40 + 60 * xx / w + 30 * yy / h).astype(np.float64)
    img[h // 4, 5:w - 5] = 220
    img[5:h - 5, w // 3] = 15
    for t in range(min(h, w) - 10):
        img[5 + t, 5 + t] = 200
    ang = np.linspace(0, 6 * np.pi, 4000)
    r = 2 + 6 * ang
    cy = np.clip((h / 2 + r * np.sin(ang) * 0.9).astype(int), 0, h - 1)
    cx = np.clip((w / 2 + r * np.cos(ang) * 1.4).astype(int), 0, w - 1)
    img[cy, cx] = 250
    return np.clip(img, 0, 255).astype(np.uint8)


def _lum_case(name):
    rng = np.random.default_rng(3)
    if name == "lines":
        return _lines()
    if name == "synthetic":
        return _synthetic_frames(n=8)[2].max(-1)
    h, w, sigma = {"noise64": (64, 64, 1.5), "noise100x37": (100, 37, 2.0),
                   "noise512x768": (512, 768, 2.0)}[name]
    return _blurred_noise(rng, h, w, sigma)


@pytest.mark.parametrize("case", ["noise64", "noise100x37", "noise512x768",
                                  "synthetic", "lines"])
def test_canny_matches_cv2(case):
    """canny == cv2.Canny(lum, t1, t2) pixel for pixel, each threshold
    pair of THRESHOLDS (either order)."""
    lum = _lum_case(case)
    for t1, t2 in THRESHOLDS:
        want = cv2.Canny(lum, t1, t2)
        got = canny(torch.from_numpy(lum), t1, t2)
        assert got.dtype == torch.uint8
        diff = int((got.numpy() != want).sum())
        assert diff == 0, (case, t1, t2, diff)
        assert want.any() or t1 == 1, (case, t1, t2)


def _even_frame_two_middles():
    """A 64 x 64 BGR frame whose value channel's two middle values
    differ (np.median averages them: 100.5, where the lower middle gives
    other thresholds), with structure in both halves."""
    rng = np.random.default_rng(5)
    top = 40 + (_blurred_noise(rng, 32, 64, 2.0) // 4)
    bottom = 161 + (_blurred_noise(rng, 32, 64, 2.0) // 4)
    lum = np.concatenate([top, bottom]).astype(np.uint8)
    frame = np.stack([lum // 2, lum, lum // 3], -1).astype(np.uint8)
    v = np.sort(lum.ravel())
    assert v[v.size // 2 - 1] != v[v.size // 2]
    return frame


@pytest.mark.parametrize("case", ["noise64", "noise512x768", "synthetic",
                                  "two_middles"])
def test_edge_detector_matches_jax(case):
    """EdgeDetector (HSV value, median thresholds, canny, dilate by the
    resolution's square) == the JAX detector (cv2) on BGR frames."""
    rng = np.random.default_rng(7)
    frame = {"noise64": lambda: _blurred_noise(rng, 64, 64, 1.5, 3),
             "noise512x768": lambda: _blurred_noise(rng, 512, 768, 1.5, 3),
             "synthetic": lambda: _synthetic_frames(n=8)[5],
             "two_middles": _even_frame_two_middles}[case]()
    ours = TK.EdgeDetector("cpu")
    theirs = JK.EdgeDetector()
    got, want = ours(frame), theirs(frame)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())
    assert want.any()
    lum = torch.from_numpy(np.ascontiguousarray(frame.max(-1)))
    assert TK._median_u8(lum) == float(np.median(frame.max(-1)))


def _same_triples(ours, theirs, lsb):
    assert [(k, i) for _, k, i in ours] == [(k, i) for _, k, i in theirs]
    for (a, _, _), (b, _, _) in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(np.int16) - b).max() <= lsb


@pytest.mark.parametrize("case", ["synthetic", "synthetic_keep2",
                                  "resized"])
def test_array_frame_generator_matches_jax(case):
    """Key flags and indices equal to the JAX generator's: the synthetic
    frames (a scene cut) at keep_every 1 and 2, and the same scene at 96 x
    150 area-resized to 64 x 40 (frames within 1 LSB of cv2.resize)."""
    if case == "resized":
        frames = _synthetic_frames(9, 96, 150)
        kw = dict(size=(64, 40), keep_every=1, threshold=6.0)
    else:
        frames = _synthetic_frames()
        kw = dict(size=(64, 64), keep_every=1, threshold=24.0) \
            if case == "synthetic" else \
            dict(size=(64, 64), keep_every=2, threshold=40.0)
    ours = list(TK.array_frame_generator(frames, TK.FrameGenConfig(**kw),
                                         device="cpu"))
    theirs = list(JK.array_frame_generator(frames, JK.FrameGenConfig(**kw)))
    _same_triples(ours, theirs, lsb=1 if case == "resized" else 0)
    assert ours[0][1] and any(k for _, k, _ in ours[1:])
    assert not all(k for _, k, _ in ours)


def test_frame_generator_matches_jax(tmp_path):
    """frame_generator over an encoded clip (written as
    tests/test_video_io.py writes one; skipped without an encoder):
    JAX's key flags and indices, frames within 1 LSB (resized 64 x 64 ->
    48 x 40)."""
    from test_video_io import _write_video
    path = str(tmp_path / "clip.avi")
    if not _write_video(path, _synthetic_frames(12, 64, 64)):
        pytest.skip("no cv2 video encoder available")
    for kw in (dict(size=(64, 64), keep_every=3, threshold=24.0),
               dict(size=(48, 40), keep_every=1, threshold=8.5,
                    max_gap=10)):
        ours = list(TK.frame_generator(path, TK.FrameGenConfig(**kw),
                                       device="cpu"))
        theirs = list(JK.frame_generator(path, JK.FrameGenConfig(**kw)))
        assert len(ours) == 12 // kw["keep_every"]
        _same_triples(ours, theirs, lsb=1)


def test_helpers_match_jax():
    """mean_pixel_distance and estimated_kernel_size: the JAX values."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (30, 41), dtype=np.uint8)
    b = rng.integers(0, 256, (30, 41), dtype=np.uint8)
    assert TK.mean_pixel_distance(a, b) == JK.mean_pixel_distance(a, b)
    for w, h in ((768, 512), (64, 64), (1920, 1080), (5, 3)):
        assert TK.estimated_kernel_size(w, h) == \
            JK.estimated_kernel_size(w, h)


def test_cv2_is_imported_only_by_frame_generator():
    """cv2 is imported nowhere in the port but inside
    keyframes.frame_generator and the ``video_path=`` branch of
    keyframe_inpaint.VideoWorkspace.__init__ (both decode a video file),
    and the ``_cv2`` helpers of the host-side training data modules
    (training/degradation.py, training/flow_data.py, utils/flow_io.py),
    and neither the port nor the card scripts (chip_smoke.py,
    temporal_consistency_torch.py) import JAX."""
    files = sorted((REPO / "sd_animation_optical_flow_tpu_torch").rglob(
        "*.py")) + [REPO / "chip_smoke.py",
                    REPO / "temporal_consistency_torch.py"]
    cv2_at, jax_at = [], []
    for src in files:
        tree = ast.parse(src.read_text())
        funcs = [f for f in ast.walk(tree)
                 if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            inside = [f.name for f in funcs if node in ast.walk(f)]
            if "cv2" in tops:
                cv2_at.append((src.name, inside))
            if tops & {"jax", "jaxlib", "sd_animation_optical_flow_tpu"}:
                jax_at.append(src.name)
    assert cv2_at == [("keyframe_inpaint.py", ["__init__"]),
                      ("keyframes.py", ["frame_generator"]),
                      ("degradation.py", ["_cv2"]),
                      ("flow_data.py", ["_cv2"]),
                      ("flow_io.py", ["_cv2"])], cv2_at
    assert not jax_at, jax_at


def test_video_paths_run_without_cv2(tmp_path):
    """With cv2 (and JAX, onnxruntime) unimportable, in a fresh
    interpreter: array_frame_generator picks key frames, frame_generator
    raises ImportError when called, the tagger is unavailable and builds
    the fixed prompt, compare_dirs reports, and run_batched runs a
    segment on tiny random models."""
    code = f"""
import sys
for n in ('cv2', 'jax', 'jaxlib', 'onnxruntime',
          'sd_animation_optical_flow_tpu'):
    sys.modules[n] = None
import os
import numpy as np, torch
from sd_animation_optical_flow_tpu_torch.config import BundleSpec
from sd_animation_optical_flow_tpu_torch.models import clip, unet, vae
from sd_animation_optical_flow_tpu_torch.models.flowconf import (
    FlowConfidenceConfig, FlowConfidenceEstimator)
from sd_animation_optical_flow_tpu_torch.models.layers import Init
from sd_animation_optical_flow_tpu_torch.models.raft import (RAFTConfig,
                                                            raft_init)
from sd_animation_optical_flow_tpu_torch.pipelines import (keyframes,
                                                           pixel_inpaint,
                                                           tagger)
from sd_animation_optical_flow_tpu_torch.utils import parity
yy, xx = np.mgrid[:32, :48]
frames = []
for i in range(5):
    f = np.stack([(xx * 5) % 256, (yy * 7) % 256, (xx + yy) % 256], -1)
    f[8:20, 4 + 3 * i:16 + 3 * i] = 200
    frames.append(f.astype(np.uint8))
frames[3] = 255 - frames[3]
cfg = keyframes.FrameGenConfig(size=(48, 32), keep_every=1, threshold=8.0)
triples = list(keyframes.array_frame_generator(frames, cfg, device='cpu'))
assert triples[0][1] and [i for _, _, i in triples] == list(range(5))
try:
    next(keyframes.frame_generator('clip.avi', cfg, device='cpu'))
    raise SystemExit('frame_generator ran without cv2')
except ImportError:
    pass
t = tagger.Tagger('m.onnx', 'tags.csv', device='cpu')
assert not t.available and t.label_cv2_bgr(frames[0]) == {{}}
assert t.build_prompt(frames[0]) == tagger.PROMPT_PREFIX
spec = lambda c: BundleSpec(
    unet=unet.UNetConfig(in_channels=c, model_channels=16,
                         channel_mult=(1, 2), attention_resolutions=(1,),
                         num_heads=2, context_dim=32),
    vae=vae.VAEConfig(ch=16, ch_mult=(1, 2), num_res_blocks=1),
    clip=clip.CLIPTextConfig(vocab_size=1000, width=32, layers=1, heads=2))
sd = spec(4).build(torch.Generator().manual_seed(0), device='cpu')
sd9 = spec(9).build(torch.Generator().manual_seed(1), device='cpu')
rcfg = RAFTConfig(iters=1, corr_levels=2, corr_radius=2)
est = FlowConfidenceEstimator(
    raft_init(Init(torch.Generator().manual_seed(2)), rcfg),
    FlowConfidenceConfig(raft=rcfg), device='cpu')
triples = [(f, i == 0, i) for i, f in enumerate(frames)]
pcfg = pixel_inpaint.PixelInpaintConfig(frame_batch=3, ddim_steps=4,
                                        denoising_strength=0.5)
out = pixel_inpaint.run_batched(iter(triples), {str(tmp_path / 'c')!r},
                                sd, sd9, est, cfg=pcfg)
names = sorted(os.listdir(out))
assert len(names) == 15, names
rep = parity.compare_dirs(out, out)
# the key frame's confidence map is all 1 (of 255): no warped pixel,
# PSNR nan, as in JAX
assert rep['frames'] == 5 and [f['psnr'] for f in rep['per_frame'][1:]] \
    == [float('inf')] * 4, rep
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
