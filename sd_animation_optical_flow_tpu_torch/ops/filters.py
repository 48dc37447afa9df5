"""Image filters with cv2/PIL-parity semantics, on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/ops/filters.py``:
``gaussian_kernel_1d`` (cv2.getGaussianKernel), ``gaussian_blur`` (a
separable Gaussian with edge replicate, for the inpaint mask blur) and
``fill_masked`` with ``_blur_any_sigma`` (the no-reference fill of the
inpaint facade). Morphology (``dilate``) and ``unsharp`` are not ported
yet (ROADMAP §1 item 4).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .resize import resize


# (radius, repeats) of the fill's blur-and-composite passes, coarse to
# fine (the reference's fill_mask_input)
_FILL_SCHEDULE = ((256, 1), (64, 1), (16, 2), (4, 4), (2, 2), (0, 1))


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel with ksize derived from sigma
    (round(sigma * 3) * 2 + 1)."""
    ksize = int(round(sigma * 3)) * 2 + 1
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


def gaussian_blur(x, sigma: float):
    """A true separable Gaussian over the first two axes of a float x
    ([H, W] or [H, W, C]). Like the JAX function it blurs axes 0 and 1
    of whatever it is given."""
    k = gaussian_kernel_1d(float(sigma))
    return _sep_filter(_sep_filter(x, k, 0), k, 1)


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
