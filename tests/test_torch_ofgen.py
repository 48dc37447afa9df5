"""Port parity: the warp-as-guidance pipeline (``pipelines/ofgen.py``) —
``unsharp_ofgen``, ``make_guidance_schedule``, the map schedule's 8x
bicubic shrink to the latent, and ``run`` end to end — against the JAX
``pipelines/ofgen.py`` on the CPU.

``run``: the tiny 4-channel bundle of ``tests/test_torch_keyframe_run.py``
(a /8 latent, as SD's: 64 x 96 frames give an 8 x 12 latent, so the flow
magnitude's weight map shrinks 8x as a 512 x 768 frame's does) on shared
weights, three synthetic frames and one flow function for both (a
smooth field from 0 to 3 px, so part of each frame moves past the 1.5 px
threshold). The port's noise draws are replaced by the JAX program's.
Gate: the same files, every converted_ and wrapped_ frame at >= 40 dB
PSNR of JAX's (peak 255)."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.pipelines import facades as JF
from sd_animation_optical_flow_tpu.pipelines import ofgen as JOF
from sd_animation_optical_flow_tpu_torch.diffusion.ddim import \
    guidance_progress
from sd_animation_optical_flow_tpu_torch.pipelines import facades as TF
from sd_animation_optical_flow_tpu_torch.pipelines import ofgen as TOF
from sd_animation_optical_flow_tpu_torch.utils.images import read_png_bgr
from test_pipeline import _synthetic_frames
from test_torch_keyframe_run import _bundles, _jax_noises
from test_torch_pixel import _psnr255


@pytest.mark.parametrize("amount", [0.12, 0.3])
def test_unsharp_ofgen_matches_jax(np_rng, amount):
    """Equal bytes on noise and on a smooth frame, numpy in; a tensor
    stays on its device."""
    img = np_rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    smooth = cv2.GaussianBlur(img, (0, 0), 3.0)
    for frame in (img, smooth):
        want = JOF.unsharp_ofgen(frame, amount)
        got = TOF.unsharp_ofgen(frame, amount, device="cpu")
        assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    got_t = TOF.unsharp_ofgen(torch.from_numpy(smooth), amount)
    assert np.array_equal(got_t.numpy(), JOF.unsharp_ofgen(smooth, amount))


def test_make_guidance_schedule_matches_jax(np_rng):
    dist = np_rng.uniform(0, 3, (16, 24)).astype(np.float32)
    cfg_j, cfg_t = JOF.OfgenConfig(), TOF.OfgenConfig()
    assert cfg_j.__dict__ == cfg_t.__dict__
    sj, st = JOF.make_guidance_schedule(dist, cfg_j), \
        TOF.make_guidance_schedule(dist, cfg_t)
    for p in (0.0, 0.5, 0.79, 0.8, 0.95):
        assert st(p).dtype == np.float32
        assert np.array_equal(st(p), sj(p)), p
    assert st(0.5)[dist <= 1.5].min() == 0.6
    assert st(0.9)[dist > 1.5].max() == 0.1


def test_guidance_map_shrinks_8x_as_cv2_inter_cubic(np_rng):
    """A map schedule at 512 x 768 resized to the 64 x 96 latent (8x, h
    != w): the port's bicubic resize against JAX's strengths (cv2's
    INTER_CUBIC) within 1e-5, on a weight-map-like field (ofgen's
    0.6 / 0.1 blocks) and on smooth noise."""
    blocks = np.full((512, 768), 0.6, np.float32)
    blocks[100:260, 300:520] = 0.1
    smooth = cv2.GaussianBlur(np_rng.uniform(0, 1, (512, 768)).astype(
        np.float32), (0, 0), 6.0)
    for gmap in (blocks, smooth):
        sched = lambda p, g=gmap: g * (1.0 - 0.5 * p)
        want = JF._guidance_strength_array(sched, None, 3, 10,
                                           (1, 64, 96, 4))
        got = TF._guidance_strength_array(sched, None, 3, 10,
                                          (1, 64, 96, 4), "cpu")
        assert got.shape == (3, 1, 64, 96, 1)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
        for j, p in enumerate(guidance_progress(3, 10)):
            direct = cv2.resize(sched(p), (96, 64),
                                interpolation=cv2.INTER_CUBIC)
            assert np.abs(got[j, 0, ..., 0].numpy() - direct).max() < 1e-5


def _flow_calc(prev, cur):
    """A smooth forward flow from 0 px (left) to 3 px (right)."""
    h, w = prev.shape[:2]
    ramp = np.linspace(0.0, 3.0, w, dtype=np.float32)[None, :]
    return np.stack([np.broadcast_to(ramp, (h, w)),
                     np.broadcast_to(0.5 * ramp, (h, w))], -1)


def test_ofgen_run_matches_jax(tmp_path):
    jsd, tsd = _bundles(jax.random.PRNGKey(41), 4)
    frames = list(_synthetic_frames(3, 64, 96))
    kw = dict(denoising_strength=0.3, ddim_steps=8)
    jdir = JOF.run(frames, str(tmp_path / "jax"), jsd, _flow_calc, None,
                   JOF.OfgenConfig(**kw))
    with _jax_noises():
        tdir = TOF.run(frames, str(tmp_path / "port"), tsd, _flow_calc, None,
                       TOF.OfgenConfig(**kw))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert [n.split("_")[0] for n in names].count("wrapped") == 2
    assert [n.split("_")[0] for n in names].count("converted") == 3
    for name in names:
        ours = read_png_bgr(os.path.join(tdir, name))
        theirs = cv2.imread(os.path.join(jdir, name), cv2.IMREAD_COLOR)
        if name.startswith("raw_"):
            assert np.array_equal(ours, theirs), name
            continue
        psnr = _psnr255(ours, theirs)
        print(f"\n[ofgen run] {name} PSNR {psnr:.1f} dB")
        assert ours.shape == (64, 96, 3) and psnr >= 40.0, name
