"""BSRGAN-style image degradation pipeline for super-res training data.

Counterpart of ``sd_animation_optical_flow_tpu/training/degradation.py``
(capabilities-parity with BSRGAN's ``degradation_bsrgan`` and
``degradation_bsrgan_variant``): a randomly shuffled chain of blur /
resize / Gaussian / Poisson / speckle / JPEG degradations producing
(low-quality, high-quality) training pairs.

Host-side data preparation (numpy + cv2): the card sees only the
resulting batches. The RNG is an explicit ``numpy.random.Generator``, so
workers are reproducible and independent; the same seed gives the JAX
package's arrays. cv2 is imported where it is used (the card's machine
has none): a degradation called without it raises ImportError.

Images are float32 RGB in [0, 1], HWC.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _cv2():
    import cv2
    return cv2


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def isotropic_gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """fspecial('gaussian') equivalent (bsrgan.py:186-198)."""
    r = (ksize - 1) / 2.0
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    k = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    k[k < np.finfo(k.dtype).eps * k.max()] = 0
    return (k / k.sum()).astype(np.float32)


def anisotropic_gaussian_kernel(ksize: int, theta: float,
                                l1: float, l2: float) -> np.ndarray:
    """Rotated anisotropic Gaussian (bsrgan.py:64-96 semantics):
    eigenvalues l1/l2 along a theta-rotated basis."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s], [s, c]])
    cov = rot @ np.diag([l1, l2]) @ rot.T
    icov = np.linalg.inv(cov)
    r = (ksize - 1) / 2.0
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    coords = np.stack([x, y], axis=-1)                       # [K,K,2]
    expo = np.einsum("hwi,ij,hwj->hw", coords, icov, coords)
    k = np.exp(-0.5 * expo)
    return (k / k.sum()).astype(np.float32)


def _conv_wrap(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Blur with wrap-around boundary (bsrgan.py blur(), :127-141 uses
    circular padding before filter2D)."""
    r = k.shape[0] // 2
    pad = np.pad(img, ((r, r), (r, r), (0, 0)), mode="wrap")
    out = _cv2().filter2D(pad, -1, k)
    return out[r:-r, r:-r]


# ---------------------------------------------------------------------------
# individual degradations (each takes/returns float32 [0,1] HWC RGB)
# ---------------------------------------------------------------------------

def add_blur(img, rng: np.random.Generator, sf: int = 4):
    """Random iso/anisotropic Gaussian blur (bsrgan.py:324-339)."""
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    if rng.random() < 0.5:
        l1 = wd2 * rng.random()
        l2 = wd2 * rng.random()
        k = anisotropic_gaussian_kernel(
            2 * rng.integers(2, 11) + 3, rng.random() * np.pi, l1, l2)
    else:
        k = isotropic_gaussian_kernel(
            2 * rng.integers(2, 11) + 3, wd * rng.random())
    return _conv_wrap(img, k)


_INTERPS = None


def _interps():
    global _INTERPS
    if _INTERPS is None:
        cv2 = _cv2()
        _INTERPS = [cv2.INTER_LINEAR, cv2.INTER_CUBIC, cv2.INTER_AREA]
    return _INTERPS


def add_resize(img, rng: np.random.Generator, sf: int = 4):
    """Random up/down/keep resize with random interpolation
    (bsrgan.py:342-360)."""
    u = rng.random()
    if u > 0.8:
        sf1 = 1.0 + rng.random() * 0.5          # up
    elif u < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1.0)        # down
    else:
        sf1 = 1.0
    h = max(int(sf1 * img.shape[0]), 1)
    w = max(int(sf1 * img.shape[1]), 1)
    out = _cv2().resize(img, (w, h),
                        interpolation=_interps()[rng.integers(0, 3)])
    return np.clip(out, 0.0, 1.0)


def add_gaussian_noise(img, rng: np.random.Generator,
                       noise_level1: int = 2, noise_level2: int = 25):
    """Gray / color / full-covariance Gaussian noise (bsrgan.py:372-386)."""
    level = rng.integers(noise_level1, noise_level2) / 255.0
    u = rng.random()
    if u > 0.6:          # per-channel color noise
        img = img + rng.normal(0, level, img.shape).astype(np.float32)
    elif u > 0.4:        # grayscale noise
        img = img + rng.normal(0, level, img.shape[:2] + (1,)
                               ).astype(np.float32)
    else:                # correlated channel noise
        a = rng.random((3, 3)).astype(np.float32)
        cov = (a.T @ a) * (level ** 2)
        noise = rng.multivariate_normal(np.zeros(3), cov,
                                        img.shape[:2]).astype(np.float32)
        img = img + noise
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img, rng: np.random.Generator):
    """Shot noise at a random exposure (bsrgan.py:407-418)."""
    vals = 10 ** (2 * rng.random() + 2.0)
    img = np.clip(img, 0.0, 1.0)
    noisy = rng.poisson(img * vals).astype(np.float32) / vals
    return np.clip(noisy, 0.0, 1.0)


def add_speckle_noise(img, rng: np.random.Generator,
                      noise_level1: int = 2, noise_level2: int = 25):
    """Multiplicative speckle (bsrgan.py:389-404)."""
    level = rng.integers(noise_level1, noise_level2) / 255.0
    img = np.clip(img, 0.0, 1.0)
    img = img + img * rng.normal(0, level, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img, rng: np.random.Generator,
                   quality_lo: int = 30, quality_hi: int = 95):
    """Round-trip through JPEG at a random quality (bsrgan.py:421-427)."""
    cv2 = _cv2()
    q = int(rng.integers(quality_lo, quality_hi))
    bgr = cv2.cvtColor((img * 255.0).round().astype(np.uint8),
                       cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)
    return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def add_sharpening(img, weight: float = 0.5, radius: int = 50,
                   threshold: int = 10):
    """USM sharpening with a soft mask (bsrgan.py:298-321)."""
    cv2 = _cv2()
    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1 - soft_mask) * img


# ---------------------------------------------------------------------------
# full pipelines
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DegradationConfig:
    sf: int = 4                 # super-res scale factor
    lq_patchsize: int = 72
    jpeg_prob: float = 0.9
    scale2_prob: float = 0.25


def random_crop_pair(lq, hq, rng: np.random.Generator, sf: int = 4,
                     lq_patchsize: int = 64):
    """Aligned random crop of an LQ/HQ pair (bsrgan.py:430-438)."""
    h, w = lq.shape[:2]
    y = int(rng.integers(0, max(h - lq_patchsize, 0) + 1))
    x = int(rng.integers(0, max(w - lq_patchsize, 0) + 1))
    lq = lq[y:y + lq_patchsize, x:x + lq_patchsize]
    hq = hq[y * sf:(y + lq_patchsize) * sf,
            x * sf:(x + lq_patchsize) * sf]
    return lq, hq


def degradation_bsrgan(img, rng: np.random.Generator | None = None,
                       cfg: DegradationConfig = DegradationConfig()):
    """Randomly-shuffled degradation chain -> (lq, hq) training pair
    (bsrgan.py:441-531). ``img`` float32 RGB [0,1], sides must be
    divisible by ``cfg.sf``."""
    cv2 = _cv2()
    rng = rng or np.random.default_rng()
    sf = cfg.sf
    h0, w0 = img.shape[:2]
    img = img[: (h0 // sf) * sf, : (w0 // sf) * sf]
    hq = img.copy()

    # optional early 2x downsample for sf=4 (bsrgan.py:462-468)
    if sf == 4 and rng.random() < cfg.scale2_prob:
        if rng.random() < 0.5:
            img = cv2.resize(img, (img.shape[1] // 2, img.shape[0] // 2),
                             interpolation=_interps()[rng.integers(0, 3)])
        else:
            img = img[::2, ::2]
        img = np.clip(img, 0.0, 1.0)
        sf_main = 2
    else:
        sf_main = sf

    # shuffled degradation order with the downsample step kept away from
    # the very front (the reference re-inserts it past index 2)
    order = list(rng.permutation(7))
    ds = order.index(2)
    if ds < 2:
        order.append(order.pop(ds))

    for step in order:
        if step == 0 or step == 1:
            img = add_blur(img, rng, sf=sf)
        elif step == 2:
            # the actual downsample to LQ resolution: random direct
            # resize or classical blur+subsample (bsrgan.py:487-508)
            if rng.random() < 0.75:
                sf1 = rng.uniform(1 / (2 * sf_main), 1 / sf_main)
                img = cv2.resize(
                    img, (int(sf1 * hq.shape[1]), int(sf1 * hq.shape[0])),
                    interpolation=_interps()[rng.integers(0, 3)])
            else:
                k = isotropic_gaussian_kernel(
                    2 * rng.integers(2, 11) + 3,
                    rng.uniform(0.1, 0.6 * sf_main))
                img = _conv_wrap(img, k)
                img = img[::sf_main, ::sf_main]
            img = np.clip(img, 0.0, 1.0)
        elif step == 3:
            img = add_resize(img, rng, sf=sf)
        elif step == 4:
            img = add_gaussian_noise(img, rng)
        elif step == 5:
            if rng.random() < 0.1:
                img = add_poisson_noise(img, rng)
            if rng.random() < 0.1:
                img = add_speckle_noise(img, rng)
        elif step == 6:
            if rng.random() < cfg.jpeg_prob:
                img = add_jpeg_noise(img, rng)

    # force exact LQ size, final JPEG (the reference always ends on JPEG)
    lq_h, lq_w = hq.shape[0] // sf, hq.shape[1] // sf
    img = cv2.resize(img, (lq_w, lq_h), interpolation=cv2.INTER_LINEAR)
    img = add_jpeg_noise(img, rng)
    lq, hq = random_crop_pair(img, hq, rng, sf,
                              min(cfg.lq_patchsize, lq_h, lq_w))
    return lq.astype(np.float32), hq.astype(np.float32)


def degradation_bsrgan_light(img, rng: np.random.Generator | None = None,
                             sf: int = 4, up: bool = False):
    """Lighter variant (bsrgan_light.py:533-630): blur -> downsample ->
    mild noise -> JPEG, no shuffle, returns a dict like the reference's
    ``degradation_bsrgan_variant`` ({'image': lq})."""
    cv2 = _cv2()
    rng = rng or np.random.default_rng()
    h0, w0 = img.shape[:2]
    img = img[: (h0 // sf) * sf, : (w0 // sf) * sf]
    if rng.random() < 0.5:
        img = add_blur(img, rng, sf=sf)
    img = cv2.resize(img, (img.shape[1] // sf, img.shape[0] // sf),
                     interpolation=_interps()[rng.integers(0, 3)])
    img = np.clip(img, 0.0, 1.0)
    if rng.random() < 0.5:
        img = add_gaussian_noise(img, rng, 1, 8)
    if rng.random() < 0.8:
        img = add_jpeg_noise(img, rng, 60, 95)
    if up:
        img = cv2.resize(img, (img.shape[1] * sf, img.shape[0] * sf),
                         interpolation=cv2.INTER_CUBIC)
    return {"image": img.astype(np.float32)}
