"""Image filters with cv2/PIL-parity semantics, on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/ops/filters.py``:
``gaussian_kernel_1d`` (cv2.getGaussianKernel), ``gaussian_blur`` (a
separable Gaussian with edge replicate, for the inpaint mask blur) and
``fill_masked`` with ``_blur_any_sigma`` (the no-reference fill of the
inpaint facade), ``ellipse_kernel`` (cv2's ``MORPH_ELLIPSE`` structuring
element, computed here: the port does not need cv2), ``dilate`` (max over
zero-padded shifts), ``canny`` (cv2.Canny's edge map, pixel for pixel,
of a grey or a colour image), ``bgr_to_gray_u8`` (cv2.cvtColor's
BGR2GRAY), ``laplacian_abs_u8`` (the keyframe pipeline's |cv2.Laplacian|
edge map), ``sobel_soft_edge`` (the ControlNet HED hint's cv2.Sobel
fallback) and ``unsharp``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .resize import resize


# (radius, repeats) of the fill's blur-and-composite passes, coarse to
# fine (the reference's fill_mask_input)
_FILL_SCHEDULE = ((256, 1), (64, 1), (16, 2), (4, 4), (2, 2), (0, 1))


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(sigma: float, ksize: int = 0) -> np.ndarray:
    """cv2.getGaussianKernel: ``ksize`` 0 derives the size from sigma
    (round(sigma * 3) * 2 + 1); sigma <= 0 derives sigma from ksize
    (0.3 * ((ksize - 1) / 2 - 1) + 0.8)."""
    if ksize <= 0:
        ksize = int(round(sigma * 3)) * 2 + 1
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _sep_filter(x, k, axis):
    """Separable 1D correlation along ``axis`` with edge replicate, summed
    tap by tap in the JAX package's order."""
    r = len(k) // 2
    n = x.shape[axis]
    idx = torch.arange(-r, n + r, device=x.device).clamp(0, n - 1)
    xp = x.index_select(axis, idx)
    kt = torch.from_numpy(k).to(x.device, x.dtype)
    out = 0
    for i in range(len(k)):
        out = out + kt[i] * xp.narrow(axis, i, n)
    return out


def gaussian_blur(x, sigma: float, ksize: int = 0):
    """A true separable Gaussian over the first two axes of a float x
    ([H, W] or [H, W, C]), ``ksize`` taps (0: from sigma, as
    :func:`gaussian_kernel_1d`). Like the JAX function it blurs axes 0
    and 1 of whatever it is given."""
    k = gaussian_kernel_1d(float(sigma), int(ksize))
    return _sep_filter(_sep_filter(x, k, 0), k, 1)


def ellipse_kernel(size: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (size, size)) as a bool
    array, by cv2's own rule: row i spans the columns c - dx .. c + dx,
    dx = round(c * sqrt(1 - (i - r)^2 / r^2)) (r = c = size // 2,
    rounded half to even); a 1 x 1 element is a single cell."""
    r = c = size // 2
    if r == 0:
        return np.ones((size, size), bool)
    k = np.zeros((size, size), bool)
    inv_r2 = 1.0 / (r * r)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        k[i, max(c - dx, 0):min(c + dx + 1, size)] = True
    return k


def dilate(x, kernel: np.ndarray):
    """Morphological max-dilation of x [H, W] (or [H, W, C]) by a boolean
    structuring element, zero padding: the maximum of x and its shifts
    by each of the element's cells (cv2.dilate parity)."""
    kernel = np.asarray(kernel, bool)
    h, w = x.shape[:2]
    ry, rx = kernel.shape[0] // 2, kernel.shape[1] // 2
    xp = torch.zeros((h + 2 * ry, w + 2 * rx) + tuple(x.shape[2:]),
                     dtype=x.dtype, device=x.device)
    xp[ry:ry + h, rx:rx + w] = x
    out = x
    for dy, dx in zip(*np.nonzero(kernel)):
        out = torch.maximum(out, xp[dy:dy + h, dx:dx + w])
    return out


# cv2's fixed-point direction test of the non-maximum suppression:
# round(tan(22.5 deg) * 2^15)
_TG22 = 13573
# hysteresis steps between two checks for its fixpoint (each check reads
# one flag back from the device)
_GROW_STEPS = 16


def _replicate_pad1(x):
    """x [H, W] padded by one pixel on each side, edge replicated."""
    h, w = x.shape
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


def _sobel3_replicate(x):
    """cv2.Canny's 3x3 Sobel (dx, dy) of an int32 [H, W] plane, edge
    replicated."""
    h, w = x.shape
    p = _replicate_pad1(x)
    dx = (p[:h, 2:] - p[:h, :w]) + 2 * (p[1:h + 1, 2:] - p[1:h + 1, :w]) \
        + (p[2:, 2:] - p[2:, :w])
    dy = (p[2:, :w] + 2 * p[2:, 1:w + 1] + p[2:, 2:]) \
        - (p[:h, :w] + 2 * p[:h, 1:w + 1] + p[:h, 2:])
    return dx, dy


def canny(img_u8, low: float, high: float):
    """cv2.Canny(img, low, high) with its defaults (aperture 3, the L1
    gradient) on a [H, W] or [H, W, C] uint8 tensor, on its device: the
    same edge map, uint8 {0, 255}, all in integer arithmetic.

    3x3 Sobel with edge replicate; magnitude |dx| + |dy|; on a
    multi-channel image each pixel takes the dx and dy of the channel
    with the largest magnitude (the first on a tie, as cv2 does);
    thresholds floor(min) and floor(max) of the pair, a pixel a
    candidate above the low one and strong above the high one (strict);
    non-maximum suppression by cv2's fixed-point direction test, its
    comparisons strict on one side (left / up) and >= on the other,
    strict on both diagonal neighbours, magnitudes outside the image 0;
    hysteresis grows the strong pixels over 8-connected candidates to its
    fixpoint."""
    lo, hi = (math.floor(t) for t in sorted((low, high)))
    planes = img_u8.to(torch.int32)
    if planes.dim() == 2:
        dx, dy = _sobel3_replicate(planes)
    else:
        dx, dy = _sobel3_replicate(planes[..., 0])
        for c in range(1, planes.shape[-1]):
            cdx, cdy = _sobel3_replicate(planes[..., c])
            better = cdx.abs() + cdy.abs() > dx.abs() + dy.abs()
            dx, dy = torch.where(better, cdx, dx), torch.where(better, cdy, dy)
    h, w = dx.shape
    ax, ay = dx.abs(), dy.abs()
    mag = ax + ay
    mp = torch.nn.functional.pad(mag, (1, 1, 1, 1))
    nb = lambda r, c: mp[r:r + h, c:c + w]        # neighbour at (r-1, c-1)
    y = ay << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    # signs of dx and dy differ: the gradient runs up-right / down-left
    anti = torch.bitwise_xor(dx, dy) < 0
    diag = torch.where(anti, (mag > nb(0, 2)) & (mag > nb(2, 0)),
                       (mag > nb(0, 0)) & (mag > nb(2, 2)))
    vert = torch.where(y > tg67x, (mag > nb(0, 1)) & (mag >= nb(2, 1)), diag)
    peak = torch.where(y < tg22x, (mag > nb(1, 0)) & (mag >= nb(1, 2)), vert)
    cand = peak & (mag > lo)
    edge = (cand & (mag > hi)).float()[None, None]
    candf = cand.float()[None, None]
    while True:
        before = edge
        for _ in range(_GROW_STEPS):
            edge = torch.nn.functional.max_pool2d(edge, 3, 1, 1) * candf
        if torch.equal(edge, before):
            break
    return (edge[0, 0] * 255).to(torch.uint8)


def bgr_to_gray_u8(img_u8):
    """cv2.cvtColor(img, COLOR_BGR2GRAY) of a [H, W, 3] uint8 tensor, in
    cv2's fixed point: (3735 B + 19235 G + 9798 R + 2^14) >> 15."""
    x = img_u8.to(torch.int32)
    y = 3735 * x[..., 0] + 19235 * x[..., 1] + 9798 * x[..., 2]
    return ((y + (1 << 14)) >> 15).to(torch.uint8)


def _reflect101_pad1(x):
    """x [H, W] (or [H, W, C]) padded by one pixel on each side, mirrored
    about the edge pixel (cv2's BORDER_REFLECT_101, its default
    border)."""
    h, w = x.shape[:2]
    rows = torch.arange(-1, h + 1, device=x.device).abs()
    rows = torch.where(rows > h - 1, 2 * (h - 1) - rows, rows)
    cols = torch.arange(-1, w + 1, device=x.device).abs()
    cols = torch.where(cols > w - 1, 2 * (w - 1) - cols, cols)
    return x.index_select(0, rows).index_select(1, cols)


def laplacian_abs_u8(img_u8):
    """The keyframe pipeline's edge map ``np.absolute(cv2.Laplacian(img,
    cv2.CV_64F)).astype(np.uint8)`` of a [H, W] or [H, W, C] uint8
    tensor, per channel, in integer arithmetic: the 3x3 aperture [[0, 1,
    0], [1, -4, 1], [0, 1, 0]] with cv2's default border (reflect 101).
    |Laplacian| reaches 1020, and numpy's float64 -> uint8 cast wraps it
    modulo 256; the integer is taken ``& 255`` here to the same bytes
    (torch's out-of-range float cast is undefined)."""
    h, w = img_u8.shape[:2]
    p = _reflect101_pad1(img_u8.to(torch.int32))
    lap = p[:h, 1:w + 1] + p[2:, 1:w + 1] + p[1:h + 1, :w] \
        + p[1:h + 1, 2:] - 4 * p[1:h + 1, 1:w + 1]
    return (lap.abs() & 255).to(torch.uint8)


def sobel_soft_edge(gray_u8):
    """The soft edge of the HED hint's fallback: cv2.Sobel(gray, CV_32F,
    1, 0) and (0, 1) with ksize 3 and the default border (reflect 101,
    not the edge replicate Canny uses), the f32 magnitude sqrt(gx^2 +
    gy^2), normalised as ``clip(mag / (max + 1e-6) * 255, 0, 255)``.
    [H, W] uint8 -> [H, W] float32 on its device."""
    h, w = gray_u8.shape
    p = _reflect101_pad1(gray_u8.to(torch.int32))
    gx = (p[:h, 2:] - p[:h, :w]) + 2 * (p[1:h + 1, 2:] - p[1:h + 1, :w]) \
        + (p[2:, 2:] - p[2:, :w])
    gy = (p[2:, :w] + 2 * p[2:, 1:w + 1] + p[2:, 2:]) \
        - (p[:h, :w] + 2 * p[:h, 1:w + 1] + p[:h, 2:])
    # the squares are exact in f32; the root is taken in f64 and rounded
    # once to f32, the correctly rounded f32 root numpy takes (torch's
    # vectorised f32 root on the CPU is not)
    mag = torch.sqrt((gx * gx + gy * gy).double()).float()
    return torch.clamp(mag / (mag.max() + 1e-6) * 255, 0, 255)


def unsharp(img):
    """The reference's unsharp mask: 1.3 img - 0.3 blur(img), blur the
    sigma-2 Gaussian (13 taps, edge replicate), in f32; an integer image
    rounds and clips back to its dtype."""
    xf = img.float()
    out = 1.3 * xf - 0.3 * gaussian_blur(xf, 2.0)
    if img.is_floating_point():
        return out.to(img.dtype)
    return torch.clamp(torch.round(out), 0, 255).to(img.dtype)


def _blur_any_sigma(x, sigma: float):
    """Gaussian blur at any sigma: sigma <= 12 is the exact separable
    kernel, larger ones go through an area downsample -> blur -> linear
    upsample pyramid (PIL's own GaussianBlur is a box-chain
    approximation, so approximate large-radius behaviour is the
    contract)."""
    if sigma <= 0:
        return x
    if sigma <= 12:
        return gaussian_blur(x, float(sigma))
    h, w = x.shape[-3], x.shape[-2]
    f = max(int(sigma // 8), 1)
    small = resize(x, (max(h // f, 1), max(w // f, 1)), "area")
    small = gaussian_blur(small, float(sigma) / f)
    return resize(small, (h, w), "linear")


def fill_masked(img, mask01):
    """Fill masked pixels with multi-radius Gaussian-blurred colors (the
    reference's ``fill_mask_input``): premultiplied-alpha blurs at radii
    256/64/16/4/2/0 alpha-composited coarse to fine.

    img [..., H, W, C]; mask01 [..., H, W] (1 = hole)."""
    a = (1.0 - torch.as_tensor(mask01, dtype=torch.float32,
                               device=img.device))[..., None]
    prem = img.float() * a
    mod_c = torch.zeros_like(prem)
    mod_a = torch.zeros_like(a)
    for radius, repeats in _FILL_SCHEDULE:
        bc = _blur_any_sigma(prem, radius)
        ba = _blur_any_sigma(a, radius)
        src_prem = bc / torch.clamp(ba, min=1e-6) * ba
        for _ in range(repeats):
            # src OVER dst, premultiplied (PIL alpha_composite)
            mod_c = src_prem + mod_c * (1.0 - ba)
            mod_a = ba + mod_a * (1.0 - ba)
    return (mod_c / torch.clamp(mod_a, min=1e-6)).to(img.dtype)
