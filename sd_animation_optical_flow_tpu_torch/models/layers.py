"""Core functional layers on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/models/layers.py``. Params
are nested dicts of tensors (the same tree the JAX package builds, in
torch layouts: conv weights OIHW, linear weights [out, in]).

Layout: activations are NHWC ([B, H, W, C]) at every public function, as
in the JAX package. Convolutions run on the channels_last view of the
same memory (``x.permute(0, 3, 1, 2)`` of an NHWC tensor IS a
channels_last NCHW tensor), so no relayout copy is made on the card.
Normalization statistics are f32 regardless of the activation dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers (torch's default Conv/Linear init: U(+-1/sqrt(fan_in)))
# ---------------------------------------------------------------------------

class Init:
    """Random-weight initializer: one ``torch.Generator`` drawn in call
    order, tensors made straight on ``device`` in ``dtype``."""

    def __init__(self, generator: torch.Generator, dtype=torch.float32,
                 device="cpu"):
        self.gen = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def uniform(self, shape, bound):
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return (u * (2.0 * bound) - bound).to(self.dtype)

    def normal(self, shape, scale=1.0):
        return (torch.randn(shape, generator=self.gen, device=self.device,
                            dtype=torch.float32) * scale).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)


def linear_init(init: Init, in_dim: int, out_dim: int, *, zero: bool = False,
                bias: bool = True):
    bound = 1.0 / math.sqrt(max(in_dim, 1))
    p = {"w": init.zeros((out_dim, in_dim)) if zero
         else init.uniform((out_dim, in_dim), bound)}
    if bias:
        p["b"] = init.zeros((out_dim,)) if zero \
            else init.uniform((out_dim,), bound)
    return p


def conv2d_init(init: Init, in_ch: int, out_ch: int, kernel, *,
                zero: bool = False, bias: bool = True):
    """``kernel``: an int, or (kh, kw) for a non-square kernel."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    shape = (out_ch, in_ch, kh, kw)
    bound = 1.0 / math.sqrt(max(in_ch * kh * kw, 1))
    p = {"w": init.zeros(shape) if zero else init.uniform(shape, bound)}
    if bias:
        p["b"] = init.zeros((out_ch,)) if zero \
            else init.uniform((out_ch,), bound)
    return p


def norm_init(init: Init, dim: int):
    return {"scale": init.ones((dim,)), "bias": init.zeros((dim,))}


# ---------------------------------------------------------------------------
# linear / conv
# ---------------------------------------------------------------------------

def linear(p, x):
    """``x @ w^T + b``; the bias is added after the product is rounded to
    x's dtype, as the JAX ``linear`` does."""
    y = x @ p["w"].to(x.dtype).t()
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _same_pad(n, k, stride, dilation):
    eff = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + eff - n, 0)
    return total // 2, total - total // 2


def conv2d(p, x, *, stride: int = 1, padding="SAME", dilation: int = 1):
    """2D convolution, NHWC in and out. ``padding`` may be 'SAME',
    'VALID', an int, or explicit ((top, bottom), (left, right))."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    if padding == "SAME":
        padding = (_same_pad(x.shape[1], kh, stride, dilation),
                   _same_pad(x.shape[2], kw, stride, dilation))
    elif padding == "VALID":
        padding = ((0, 0), (0, 0))
    elif isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)                    # channels_last view
    if pt == pb and pl == pr:
        y = F.conv2d(xc, w, stride=stride, padding=(pt, pl),
                     dilation=dilation)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), w, stride=stride,
                     dilation=dilation)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def group_norm(p, x, *, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channel (last) axis of an NHWC (or N...C)
    tensor; gcd(num_groups, C) groups, f32 statistics and affine, one
    rounding to x's dtype at the end."""
    c = x.shape[-1]
    g = math.gcd(num_groups, c)
    # torch's GroupNorm accumulates in f32 for bf16 input and rounds once
    # at the end, so the activation is not copied to f32 first
    y = F.group_norm(x.movedim(-1, 1), g, p["scale"].to(x.dtype),
                     p["bias"].to(x.dtype), eps)
    return y.movedim(1, -1)


def layer_norm(p, x, *, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def instance_norm(p, x, *, eps: float = 1e-5):
    """InstanceNorm2d over H, W per channel of an NHWC tensor (RAFT's
    feature encoder); f32 statistics, biased variance, an optional affine
    ``p``, one rounding to x's dtype."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(1, 2), keepdim=True,
                               unbiased=False)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if p is not None:
        xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def swish(x):
    return F.silu(x)


def gelu(x):
    """erf GELU, as the JAX package's ``gelu``."""
    return F.gelu(x)


def gelu_tanh(x):
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``, T5 v1.1's
    gated FF)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# timestep embedding
# ---------------------------------------------------------------------------

def timestep_embedding(t, dim: int, *, max_period: float = 10000.0,
                       dtype=torch.float32):
    """Sinusoidal timestep embedding, [cos|sin] order. t: [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def avg_pool2d(x, window: int = 2, stride: int | None = None):
    """Average pooling of an NHWC tensor over window x window patches,
    no padding (partial windows at the far edges are dropped)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1)


def nearest_upsample2x(x):
    """Nearest-neighbour 2x upsampling of an NHWC tensor (each pixel
    repeated into a 2x2 block)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def upsample2x_conv(p, x):
    """``conv2d(p, nearest_upsample2x(x))`` — the same sums the JAX
    package computes as four subpixel convolutions on the low-res input
    (it pre-adds weights; the results agree to rounding)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                      mode="nearest")
    return conv2d(p, y.permute(0, 2, 3, 1))
