"""Port parity: the warp and its image ops — ``resize`` cubic / lanczos4,
``remap`` (cubic, linear, nearest; float and uint8 images; 2-D and
3-channel), ``warp_frame``, ``warp_frame_latent``, ``warp_mask_fused``
(one frame and a batch, with and without the dilation),
``flow_travel_distance``, ``dilate``, ``unsharp`` and ``ellipse_kernel``
— against the JAX package on the CPU, and ``remap`` / ``dilate`` /
``ellipse_kernel`` against cv2 where cv2 is installed.

Tolerances: float outputs within 1e-5 of the output's scale (the same
f32 arithmetic summed in another order); uint8 outputs within one level
on at most 0.1% of the values (a sum that lands within rounding of .5
may round either way) and equal elsewhere; masks and structuring
elements exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.ops import filters as JFI
from sd_animation_optical_flow_tpu.ops import resize as JR
from sd_animation_optical_flow_tpu.ops import warp as JW
from sd_animation_optical_flow_tpu_torch.ops import filters as TFI
from sd_animation_optical_flow_tpu_torch.ops import resize as TR
from sd_animation_optical_flow_tpu_torch.ops import warp as TW
from torch_port_common import np_t, rel_err

H, W = 40, 56


def _u8_close(out, ref):
    """uint8 parity: equal but for one-level rounding flips on <= 0.1%."""
    d = np.abs(np.asarray(out, np.int32) - np.asarray(ref, np.int32))
    return d.max() <= 1 and (d > 0).mean() <= 1e-3


def _image(rng, h=H, w=W, c=3):
    """A smooth 0-255 image (so cv2's 1/32-px tables stay close)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    chans = [127 + 100 * np.sin(xx / (5 + 3 * k) + k)
             * np.cos(yy / (7 + 2 * k)) for k in range(c)]
    img = np.stack(chans, -1) + rng.normal(0, 4, (h, w, c))
    return np.clip(img, 0, 255).astype(np.float32)


def _flow(rng, h=H, w=W, scale=3.0):
    f = rng.uniform(-scale, scale, (h, w, 2)).astype(np.float32)
    return (0.5 * f + 0.5 * np.roll(f, 1, 0)).astype(np.float32)


@pytest.mark.parametrize("mode,src,dst", [
    ("cubic", (32, 48), (8, 12)), ("cubic", (8, 12), (64, 96)),
    ("cubic", (13, 17), (29, 11)), ("lanczos4", (32, 48), (12, 20)),
    ("lanczos4", (9, 14), (40, 33))])
def test_resize_cubic_lanczos_matches_jax(np_rng, mode, src, dst):
    x = np_rng.standard_normal((2,) + src + (4,)).astype(np.float32)
    ref = JR.resize(jnp.asarray(x), dst, mode)
    out = TR.resize(np_t(x), dst, mode)
    assert out.shape == ref.shape and rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("mode", ["cubic", "linear", "nearest"])
@pytest.mark.parametrize("kind", ["float", "uint8", "gray_float",
                                  "gray_uint8"])
def test_remap_matches_jax(np_rng, mode, kind):
    """Maps from a flow reaching past every border (windows partly and
    wholly outside the image)."""
    img = _image(np_rng, c=1 if kind.startswith("gray") else 3)
    if kind.startswith("gray"):
        img = img[..., 0]
    if kind.endswith("uint8"):
        img = np.round(img).astype(np.uint8)
    flow = _flow(np_rng, scale=6.0)
    mx = np.arange(W, dtype=np.float32)[None] + flow[..., 0] * 1.7
    my = np.arange(H, dtype=np.float32)[:, None] + flow[..., 1] * 1.7
    ref = np.asarray(JW.remap(jnp.asarray(img), jnp.asarray(mx),
                              jnp.asarray(my), mode=mode))
    out = TW.remap(torch.from_numpy(img), np_t(mx), np_t(my),
                   mode=mode).numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert (ref == 0).any()                      # reached past the border
    if ref.dtype == np.uint8:
        assert _u8_close(out, ref)
    else:
        assert rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_remap_cubic_matches_cv2(np_rng, dtype):
    """cv2.remap(INTER_CUBIC, BORDER_CONSTANT 0) on maps whose fractions
    are multiples of 1/32 px (cv2 quantizes to that grid): float images
    within 1e-3 of 255, uint8 within one level (cv2's fixed-point taps)."""
    cv2 = pytest.importorskip("cv2")
    img = _image(np_rng)
    if dtype == "uint8":
        img = np.round(img).astype(np.uint8)
    flow = np.round(_flow(np_rng, scale=5.0) * 32) / 32
    mx = (np.arange(W, dtype=np.float32)[None] + flow[..., 0]).astype(
        np.float32)
    my = (np.arange(H, dtype=np.float32)[:, None] + flow[..., 1]).astype(
        np.float32)
    ref = cv2.remap(img, mx, my, cv2.INTER_CUBIC,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    out = TW.remap(torch.from_numpy(img), np_t(mx), np_t(my)).numpy()
    if dtype == "uint8":
        d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1, d.max()
    else:
        assert np.abs(out - ref).max() < 1e-3 * 255


def test_warp_frame_and_latent_match_jax(np_rng):
    img = _image(np_rng)
    flow = _flow(np_rng)
    ref = JW.warp_frame(jnp.asarray(img), jnp.asarray(flow))
    out = TW.warp_frame(np_t(img), np_t(flow))
    assert rel_err(out, ref) < 1e-5
    lat = np_rng.standard_normal((H // 8, W // 8, 4)).astype(np.float32)
    ref = JW.warp_frame_latent(jnp.asarray(lat), jnp.asarray(flow))
    out = TW.warp_frame_latent(np_t(lat), np_t(flow))
    assert out.shape == (H // 8, W // 8, 4) and rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dilate_size", [None, 7])
def test_warp_mask_fused_matches_jax(np_rng, batched, dilate_size):
    """The warped frame within 1e-5 of the scale, the mask exactly."""
    ref_ai = _image(np_rng) * 1.2 - 20            # cubic overshoot clips
    n = 2 if batched else 1
    flow = np.stack([_flow(np_rng) for _ in range(n)])
    # 1% of the pixels under the threshold, the rest over it
    conf = np.where(np_rng.uniform(size=(n, H, W)) < 0.01,
                    np_rng.uniform(0.9, 0.95, (n, H, W)),
                    np_rng.uniform(0.95, 1.0, (n, H, W))).astype(np.float32)
    if not batched:
        flow, conf = flow[0], conf[0]
    kern = None if dilate_size is None else JFI.ellipse_kernel(dilate_size)
    jw, jm = JW.warp_mask_fused(jnp.asarray(ref_ai), jnp.asarray(flow),
                                jnp.asarray(conf), kern, conf_thres=0.95)
    tkern = None if dilate_size is None else TFI.ellipse_kernel(dilate_size)
    tw, tm = TW.warp_mask_fused(np_t(ref_ai), np_t(flow), np_t(conf), tkern,
                                conf_thres=0.95)
    assert tw.shape == jw.shape and rel_err(tw, jw) < 1e-5
    assert float(tw.min()) >= 0 and float(tw.max()) <= 255
    assert tm.dtype == torch.float32
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < float(tm.mean()) < 1


def test_flow_travel_distance_matches_jax(np_rng):
    flow = _flow(np_rng)
    conf = np_rng.uniform(0.8, 1.0, (H, W)).astype(np.float32)
    ref = JW.flow_travel_distance(jnp.asarray(flow), jnp.asarray(conf))
    out = TW.flow_travel_distance(np_t(flow), np_t(conf))
    assert rel_err(out, ref) < 1e-6


@pytest.mark.parametrize("size", [3, 7, 8])
@pytest.mark.parametrize("channels", [0, 3])
def test_dilate_matches_jax_and_cv2(np_rng, size, channels):
    """Max-dilation of a sparse mask (and a 3-channel float image) by the
    ellipse: equal to the JAX dilate and, on the mask, to cv2.dilate."""
    shape = (H, W) if channels == 0 else (H, W, channels)
    x = (np_rng.uniform(0, 1, shape) > 0.97).astype(np.float32) \
        * np_rng.uniform(0.5, 2.0, shape).astype(np.float32)
    kern = TFI.ellipse_kernel(size)
    out = TFI.dilate(np_t(x), kern).numpy()
    assert np.array_equal(out, np.asarray(JFI.dilate(jnp.asarray(x), kern)))
    try:
        import cv2
    except ImportError:
        return
    ref = cv2.dilate(x, kern.astype(np.uint8), borderType=cv2.BORDER_CONSTANT,
                     borderValue=0)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_unsharp_matches_jax(np_rng, kind):
    img = _image(np_rng)
    if kind == "uint8":
        img = np.round(img).astype(np.uint8)
    ref = np.asarray(JFI.unsharp(jnp.asarray(img)))
    out = TFI.unsharp(torch.from_numpy(img)).numpy()
    assert out.dtype == ref.dtype
    if kind == "uint8":
        assert _u8_close(out, ref)
    else:
        assert rel_err(out, ref) < 1e-5


def test_ellipse_kernel_matches_cv2():
    """Every size 1-31 equal to cv2.getStructuringElement(MORPH_ELLIPSE),
    and to the JAX package's (which calls cv2)."""
    cv2 = pytest.importorskip("cv2")
    for size in range(1, 32):
        ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
        out = TFI.ellipse_kernel(size)
        assert out.dtype == bool and np.array_equal(out, ref.astype(bool)), \
            size
        assert np.array_equal(out, JFI.ellipse_kernel(size))
    assert [int(TFI.ellipse_kernel(s).sum()) for s in (3, 5, 7, 9, 11, 15)] \
        == [5, 17, 33, 57, 89, 169]
