"""Row-sharded NHWC layers: the sequence parallelism of ``unet_apply(sp=)``.

The JAX package shards the UNet's latent rows over a mesh axis with one
sharding constraint and leaves the rest to GSPMD (halo exchanges for the
convolutions, cross-shard reductions for the norms). Here every rank
holds a contiguous block of rows of each NHWC activation (rank r: rows
[r * h_local, (r + 1) * h_local)); the row-major token order then keeps
each rank's tokens contiguous, as ``ring_attention.ulysses_attention``
wants them. The layers that mix rows are made explicit:

* :func:`conv2d` exchanges halo rows with the neighbouring ranks
  (``batch_isend_irecv``): one row above and one below for a 3 x 3
  stride-1 convolution, the row above for the stride-2 down convolution
  (padding 1), none for a 1 x 1;
* :func:`group_norm` all-gathers each rank's per-group f32 means and
  variances and combines them (equal counts on every rank);
* :func:`upsample2x_conv` upsamples its own rows (nearest) and runs the
  halo convolution.

The time embedding, the cross-attention, the feed-forward tail and every
1 x 1 convolution are row-local and need nothing. Each function takes
``sp`` (a ``models.unet.SeqParallelConfig``) or None, which calls the
unsharded layer.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import layers as L
from .mesh import axis_group, gather_dim


def group_of(sp):
    """(process group, this rank's index, size) of ``sp``'s mesh axis."""
    return axis_group(sp.mesh, sp.axis)


def check_rows(sp, h: int, levels: int) -> None:
    """Every UNet level's row count (h at level 0, halved at each of the
    ``levels - 1`` down convolutions) must split evenly over the ranks:
    ValueError otherwise (GSPMD pads uneven rows; this port does not)."""
    n = group_of(sp)[2]
    step = n * 2 ** (levels - 1)
    if h % step:
        raise ValueError(f"latent rows {h} do not split over {n} ranks at "
                         f"every one of {levels} UNet levels (need a "
                         f"multiple of {step})")


def shard_rows(x, sp):
    """This rank's rows (axis 1) of a whole NHWC tensor."""
    _, rank, n = group_of(sp)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} rows do not split over {n} ranks")
    hl = x.shape[1] // n
    return x[:, rank * hl:(rank + 1) * hl]


def gather(x, sp, dim: int = 1):
    """The whole tensor from every rank's slice along ``dim`` (rows of an
    NHWC tensor, tokens of a [B, N, C] one), on every rank."""
    group, _, n = group_of(sp)
    return gather_dim(x, dim, group, n)


def halo_rows(x, sp, above: int, below: int):
    """``x`` (this rank's rows) with the previous rank's last ``above``
    rows on top and the next rank's first ``below`` rows underneath; the
    first and the last rank get zero rows there (the convolution's zero
    padding)."""
    group, rank, n = group_of(sp)
    hl = x.shape[1]
    if above > hl or below > hl:
        raise ValueError(f"a halo of {max(above, below)} rows exceeds the "
                         f"{hl} rows of a rank")
    top = x.new_zeros((x.shape[0], above) + x.shape[2:])
    bottom = x.new_zeros((x.shape[0], below) + x.shape[2:])
    peer = lambda r: dist.get_global_rank(group, r)
    ops = []
    if above and rank > 0:
        ops.append(dist.P2POp(dist.irecv, top, peer(rank - 1), group))
    if above and rank < n - 1:
        ops.append(dist.P2POp(dist.isend, x[:, hl - above:].contiguous(),
                              peer(rank + 1), group))
    if below and rank < n - 1:
        ops.append(dist.P2POp(dist.irecv, bottom, peer(rank + 1), group))
    if below and rank > 0:
        ops.append(dist.P2POp(dist.isend, x[:, :below].contiguous(),
                              peer(rank - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top, x, bottom], dim=1)


def conv2d(p, x, sp, *, stride: int = 1, padding="SAME"):
    """``layers.conv2d`` of the whole tensor, on this rank's rows: the
    halo rows the kernel window reaches across a rank boundary are
    exchanged first, then the convolution runs unpadded along H. With
    ``sp`` None: ``layers.conv2d``. ``padding`` 'SAME' or an int."""
    if sp is None:
        return L.conv2d(p, x, stride=stride, padding=padding)
    kh, kw = p["w"].shape[2], p["w"].shape[3]
    n = group_of(sp)[2]
    if padding == "SAME":
        (pt, pb), pw = (L._same_pad(x.shape[1] * n, kh, stride, 1),
                        L._same_pad(x.shape[2], kw, stride, 1))
    elif isinstance(padding, int):
        (pt, pb), pw = (padding, padding), (padding, padding)
    else:
        raise ValueError(f"row-sharded conv2d takes 'SAME' or an int "
                         f"padding, got {padding!r}")
    # output row o reads input rows stride * o - pt .. + kh - 1: a rank's
    # outputs need pt rows above its block and kh - stride - pt below
    below = kh - stride - pt
    if x.shape[1] % stride or below > pb:
        raise ValueError(f"rows {x.shape[1]} a rank do not tile a stride-"
                         f"{stride} {kh}-row convolution padded ({pt}, {pb})")
    xh = halo_rows(x, sp, pt, max(below, 0))
    if below < 0:
        xh = xh[:, :below]
    return L.conv2d(p, xh, stride=stride, padding=((0, 0), pw))


def upsample2x_conv(p, x, sp):
    """``layers.upsample2x_conv`` on this rank's rows (a rank's upsampled
    rows come from its own rows)."""
    if sp is None:
        return L.upsample2x_conv(p, x)
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                      mode="nearest")
    return conv2d(p, y.permute(0, 2, 3, 1), sp)


def group_norm(p, x, sp, *, num_groups: int = 32, eps: float = 1e-5):
    """``layers.group_norm`` of the whole tensor, on this rank's rows: the
    per-(sample, group) f32 mean and variance of each rank are
    all-gathered and combined (equal counts on every rank: the whole
    variance is the ranks' mean variance plus the variance of their
    means), then each rank normalises its rows; f32 statistics and
    affine, one rounding to x's dtype. With ``sp`` None:
    ``layers.group_norm``."""
    if sp is None:
        return L.group_norm(p, x, num_groups=num_groups, eps=eps)
    group, _, n = group_of(sp)
    b, h, w, c = x.shape
    g = math.gcd(num_groups, c)
    xf = x.float().reshape(b, h * w, g, c // g)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False)  # [b, g]
    stats = gather_dim(torch.stack([mean, var])[None], 0, group, n)
    means, variances = stats[:, 0], stats[:, 1]                 # [n, b, g]
    mean_all = means.mean(dim=0)
    var_all = variances.mean(dim=0) \
        + (means - mean_all).square().mean(dim=0)
    y = (xf - mean_all[:, None, :, None]) \
        * torch.rsqrt(var_all + eps)[:, None, :, None]
    y = y.reshape(b, h, w, c) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)
