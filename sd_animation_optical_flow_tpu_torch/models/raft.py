"""RAFT optical flow on torch tensors, NHWC.

Counterpart of ``sd_animation_optical_flow_tpu/models/raft.py``: the
instance-norm feature encoder and batch-norm context encoder (stride 8),
the all-pairs correlation pyramid with its (2r+1)^2 windowed lookup (or
the on-the-fly windowed correlation), the separable ConvGRU update
iterations and the convex 8x upsampling through a softmaxed 9-way mask;
the small variant (bottleneck encoders, one 3x3 ConvGRU, bilinear
upsampling) too. Parameters are the JAX package's tree (lists where it
has lists) in torch layouts, from ``utils/jax_params.py`` or
:func:`raft_init`. The iterations are a Python loop over shared weights
(the JAX package scans them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.correlation import (all_pairs_correlation, alt_correlation_xla,
                               build_pyramid, fmap_pyramid, lookup_pyramid)
from .layers import Init, conv2d, conv2d_init, instance_norm


@dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 20
    fnet_dim: int = 256
    alternate_corr: bool = False   # on-the-fly windowed corr (alt path)
    small: bool = False            # SmallEncoder / SmallUpdateBlock variant
    # storage dtype of the all-pairs pyramid; the product and the
    # bilinear stencil run in f32 either way. "float32" gives the
    # reference's corr numerics at twice the memory.
    corr_dtype: str = "bfloat16"

    @staticmethod
    def small_config(**kw) -> "RAFTConfig":
        """raft-small: hdim 96, cdim 64, 3 corr levels radius 3,
        bottleneck encoders, bilinear 8x upsampling."""
        base = dict(hidden_dim=96, context_dim=64, corr_levels=3,
                    corr_radius=3, fnet_dim=128, small=True)
        base.update(kw)
        return RAFTConfig(**base)

    @property
    def corr_planes(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def _bn_init(init: Init, ch):
    # inference-mode batch norm: running statistics from the checkpoint
    return {"scale": init.ones((ch,)), "bias": init.zeros((ch,)),
            "mean": init.zeros((ch,)), "var": init.ones((ch,))}


def _apply_norm(p, x, kind):
    if kind == "instance":
        return instance_norm(None, x)
    if kind == "batch":
        inv = torch.rsqrt(p["var"] + 1e-5)
        return ((x - p["mean"]) * inv * p["scale"] + p["bias"]).to(x.dtype)
    if kind == "none":
        return x
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _res_unit_init(init: Init, in_ch, out_ch, norm, stride):
    p = {"conv1": conv2d_init(init, in_ch, out_ch, 3),
         "conv2": conv2d_init(init, out_ch, out_ch, 3)}
    if norm == "batch":
        p["norm1"] = _bn_init(init, out_ch)
        p["norm2"] = _bn_init(init, out_ch)
    if stride != 1:
        p["down"] = conv2d_init(init, in_ch, out_ch, 1)
        if norm == "batch":
            p["norm3"] = _bn_init(init, out_ch)
    return p


def _res_unit(p, x, norm, stride):
    # explicit symmetric padding, as torch's Conv2d(3, padding=1): the
    # port's 'SAME' pads (0, 1) under stride 2, as XLA does
    y = F.relu(_apply_norm(p.get("norm1"),
                           conv2d(p["conv1"], x, stride=stride, padding=1),
                           norm))
    y = F.relu(_apply_norm(p.get("norm2"), conv2d(p["conv2"], y), norm))
    if "down" in p:
        x = _apply_norm(p.get("norm3"), conv2d(p["down"], x, stride=stride,
                                               padding=0), norm)
    return F.relu(x + y)


def encoder_init(init: Init, out_dim: int, norm: str):
    p = {"conv1": conv2d_init(init, 3, 64, 7)}
    if norm == "batch":
        p["norm1"] = _bn_init(init, 64)
    layers, in_ch = [], 64
    for dim, stride in ((64, 1), (96, 2), (128, 2)):
        layers.append([_res_unit_init(init, in_ch, dim, norm, stride),
                       _res_unit_init(init, dim, dim, norm, 1)])
        in_ch = dim
    p["layers"] = layers
    p["conv2"] = conv2d_init(init, 128, out_dim, 1)
    return p


def encoder_apply(p, x, norm: str):
    h = conv2d(p["conv1"], x, stride=2, padding=3)
    h = F.relu(_apply_norm(p.get("norm1"), h, norm))
    for (u1, u2), stride in zip(p["layers"], (1, 2, 2)):
        h = _res_unit(u1, h, norm, stride)
        h = _res_unit(u2, h, norm, 1)
    return conv2d(p["conv2"], h)


def _bottleneck_init(init: Init, in_ch, out_ch, stride):
    quarter = out_ch // 4
    p = {"conv1": conv2d_init(init, in_ch, quarter, 1),
         "conv2": conv2d_init(init, quarter, quarter, 3),
         "conv3": conv2d_init(init, quarter, out_ch, 1)}
    if stride != 1:
        p["down"] = conv2d_init(init, in_ch, out_ch, 1)
    return p


def _bottleneck(p, x, stride, norm="instance"):
    def n(v):
        return instance_norm(None, v) if norm == "instance" else v
    y = F.relu(n(conv2d(p["conv1"], x)))
    y = F.relu(n(conv2d(p["conv2"], y, stride=stride, padding=1)))
    y = F.relu(n(conv2d(p["conv3"], y)))
    if "down" in p:
        x = conv2d(p["down"], x, stride=stride, padding=0)
    return F.relu(x + y)


def small_encoder_init(init: Init, out_dim: int):
    p = {"conv1": conv2d_init(init, 3, 32, 7)}
    layers, in_ch = [], 32
    for dim, stride in ((32, 1), (64, 2), (96, 2)):
        layers.append([_bottleneck_init(init, in_ch, dim, stride),
                       _bottleneck_init(init, dim, dim, 1)])
        in_ch = dim
    p["layers"] = layers
    p["conv2"] = conv2d_init(init, 96, out_dim, 1)
    return p


def small_encoder_apply(p, x, norm: str = "instance"):
    h = conv2d(p["conv1"], x, stride=2, padding=3)
    if norm == "instance":
        h = instance_norm(None, h)
    h = F.relu(h)
    for (u1, u2), stride in zip(p["layers"], (1, 2, 2)):
        h = _bottleneck(u1, h, stride, norm)
        h = _bottleneck(u2, h, 1, norm)
    return conv2d(p["conv2"], h)


# ---------------------------------------------------------------------------
# update block
# ---------------------------------------------------------------------------

def motion_encoder_init(init: Init, corr_planes):
    return {"convc1": conv2d_init(init, corr_planes, 256, 1),
            "convc2": conv2d_init(init, 256, 192, 3),
            "convf1": conv2d_init(init, 2, 128, 7),
            "convf2": conv2d_init(init, 128, 64, 3),
            "conv": conv2d_init(init, 192 + 64, 128 - 2, 3)}


def motion_encoder(p, flow, corr):
    cor = F.relu(conv2d(p["convc1"], corr))
    cor = F.relu(conv2d(p["convc2"], cor))
    flo = F.relu(conv2d(p["convf1"], flow, padding=3))
    flo = F.relu(conv2d(p["convf2"], flo))
    out = F.relu(conv2d(p["conv"], torch.cat([cor, flo], -1)))
    return torch.cat([out, flow], -1)


def sep_conv_gru_init(init: Init, hidden, inp):
    hi = hidden + inp
    return {name: conv2d_init(init, hi, hidden, ks)
            for name, ks in [("convz1", (1, 5)), ("convr1", (1, 5)),
                             ("convq1", (1, 5)), ("convz2", (5, 1)),
                             ("convr2", (5, 1)), ("convq2", (5, 1))]}


def sep_conv_gru(p, h, x):
    for suffix in ("1", "2"):           # horizontal pass, then vertical
        hx = torch.cat([h, x], -1)
        z = torch.sigmoid(conv2d(p["convz" + suffix], hx))
        r = torch.sigmoid(conv2d(p["convr" + suffix], hx))
        q = torch.tanh(conv2d(p["convq" + suffix], torch.cat([r * h, x], -1)))
        h = (1 - z) * h + z * q
    return h


def update_block_init(init: Init, cfg: RAFTConfig):
    return {
        "encoder": motion_encoder_init(init, cfg.corr_planes),
        "gru": sep_conv_gru_init(init, cfg.hidden_dim, 128 + cfg.context_dim),
        "flow_head": {"conv1": conv2d_init(init, cfg.hidden_dim, 256, 3),
                      "conv2": conv2d_init(init, 256, 2, 3)},
        "mask": {"conv1": conv2d_init(init, 128, 256, 3),
                 "conv2": conv2d_init(init, 256, 64 * 9, 1)},
    }


def update_block(p, net, inp, corr, flow):
    motion = motion_encoder(p["encoder"], flow, corr)
    net = sep_conv_gru(p["gru"], net, torch.cat([inp, motion], -1))
    delta = conv2d(p["flow_head"]["conv2"],
                   F.relu(conv2d(p["flow_head"]["conv1"], net)))
    mask = 0.25 * conv2d(p["mask"]["conv2"],
                         F.relu(conv2d(p["mask"]["conv1"], net)))
    return net, mask, delta


def small_update_block_init(init: Init, cfg: RAFTConfig):
    gru_in = cfg.hidden_dim + 82 + cfg.context_dim
    return {
        "encoder": {"convc1": conv2d_init(init, cfg.corr_planes, 96, 1),
                    "convf1": conv2d_init(init, 2, 64, 7),
                    "convf2": conv2d_init(init, 64, 32, 3),
                    "conv": conv2d_init(init, 96 + 32, 80, 3)},
        "gru": {name: conv2d_init(init, gru_in, cfg.hidden_dim, 3)
                for name in ("convz", "convr", "convq")},
        "flow_head": {"conv1": conv2d_init(init, cfg.hidden_dim, 128, 3),
                      "conv2": conv2d_init(init, 128, 2, 3)},
    }


def small_update_block(p, net, inp, corr, flow):
    enc = p["encoder"]
    cor = F.relu(conv2d(enc["convc1"], corr))
    flo = F.relu(conv2d(enc["convf1"], flow, padding=3))
    flo = F.relu(conv2d(enc["convf2"], flo))
    out = F.relu(conv2d(enc["conv"], torch.cat([cor, flo], -1)))
    x = torch.cat([inp, out, flow], -1)              # motion: 82 channels
    hx = torch.cat([net, x], -1)
    z = torch.sigmoid(conv2d(p["gru"]["convz"], hx))
    r = torch.sigmoid(conv2d(p["gru"]["convr"], hx))
    q = torch.tanh(conv2d(p["gru"]["convq"], torch.cat([r * net, x], -1)))
    net = (1 - z) * net + z * q
    delta = conv2d(p["flow_head"]["conv2"],
                   F.relu(conv2d(p["flow_head"]["conv1"], net)))
    return net, None, delta


# ---------------------------------------------------------------------------
# upsampling
# ---------------------------------------------------------------------------

def upsample_flow_convex(flow, mask):
    """flow [N, H, W, 2] (1/8 res), mask [N, H, W, 576] -> [N, 8H, 8W, 2]:
    each output pixel a softmax-weighted sum of the 3x3 neighbourhood of
    8 * flow (zero padded), the mask's channels read as (9, 8, 8)."""
    n, h, w, _ = flow.shape
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    nbrs = torch.stack([fp[:, dy:dy + h, dx:dx + w, :]
                        for dy in range(3) for dx in range(3)], dim=3)
    m = torch.softmax(mask.reshape(n, h, w, 9, 8, 8).float(), dim=3)
    up = torch.einsum("nhwkij,nhwkc->nhwijc", m, nbrs.float()).to(flow.dtype)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(n, 8 * h, 8 * w, 2)


def upflow8(flow):
    """Bilinear 8x flow upsampling (half-pixel centres, edges clamped),
    used where no convex mask exists (the small variant)."""
    up = F.interpolate(flow.permute(0, 3, 1, 2), scale_factor=8,
                       mode="bilinear", align_corners=False)
    return 8.0 * up.permute(0, 2, 3, 1)


def coords_grid(n, h, w, device="cuda"):
    """[n, h, w, 2] pixel coordinates in (x, y) order."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(n, h, w, 2)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def raft_init(init: Init, cfg: RAFTConfig = RAFTConfig()):
    """Random RAFT parameters drawn from ``init`` (the JAX package's tree;
    trained weights come through ``utils/jax_params.py``)."""
    if cfg.small:
        return {"fnet": small_encoder_init(init, cfg.fnet_dim),
                "cnet": small_encoder_init(init, cfg.hidden_dim
                                           + cfg.context_dim),
                "update": small_update_block_init(init, cfg)}
    return {"fnet": encoder_init(init, cfg.fnet_dim, "instance"),
            "cnet": encoder_init(init, cfg.hidden_dim + cfg.context_dim,
                                 "batch"),
            "update": update_block_init(init, cfg)}


def raft_apply(params, cfg: RAFTConfig, image1, image2, *,
               iters: int | None = None, flow_init=None,
               all_iters: bool = False, with_features: bool = False):
    """image1 / image2 [N, H, W, 3] RGB in [0, 255] (H, W multiples of 8).

    Returns (flow_low [N, H/8, W/8, 2], flow_up [N, H, W, 2]). With
    ``all_iters`` both carry a leading iterations axis (every iteration's
    prediction, for the sequence loss); with ``with_features`` a third
    return is the final GRU hidden state [N, H/8, W/8, hidden] (the
    learned uncertainty head's input)."""
    iters = iters or cfg.iters
    img1 = 2.0 * (image1 / 255.0) - 1.0
    img2 = 2.0 * (image2 / 255.0) - 1.0

    both = torch.cat([img1, img2], 0)           # one batch for the encoder
    fmaps = small_encoder_apply(params["fnet"], both) if cfg.small \
        else encoder_apply(params["fnet"], both, "instance")
    fmap1, fmap2 = fmaps.float().chunk(2, dim=0)

    if cfg.alternate_corr:
        f2_pyr = fmap_pyramid(fmap2, cfg.corr_levels)
        corr_fn = lambda coords: alt_correlation_xla(
            fmap1, f2_pyr, coords, cfg.corr_radius)
    else:
        corr = all_pairs_correlation(fmap1, fmap2)
        pyramid = build_pyramid(corr.to(getattr(torch, cfg.corr_dtype)),
                                cfg.corr_levels)
        del corr
        corr_fn = lambda coords: lookup_pyramid(pyramid, coords,
                                                cfg.corr_radius)

    cnet = small_encoder_apply(params["cnet"], img1, norm="none") \
        if cfg.small else encoder_apply(params["cnet"], img1, "batch")
    net, inp = cnet.split([cfg.hidden_dim, cnet.shape[-1] - cfg.hidden_dim],
                          dim=-1)
    net = torch.tanh(net)
    inp = F.relu(inp)

    n, h8, w8 = fmap1.shape[:3]
    coords0 = coords_grid(n, h8, w8, device=fmap1.device)
    coords1 = coords0 if flow_init is None else coords0 + flow_init
    upd = small_update_block if cfg.small else update_block

    flows_low, up_masks = [], []
    for _ in range(iters):
        coords1 = coords1.detach()
        corr = corr_fn(coords1)
        net, up_mask, delta = upd(params["update"], net, inp, corr,
                                  coords1 - coords0)
        coords1 = coords1 + delta
        if all_iters:
            flows_low.append(coords1 - coords0)
            up_masks.append(up_mask)
    flow_low = coords1 - coords0
    if all_iters:
        if cfg.small:
            flows_up = [upflow8(f) for f in flows_low]
        else:
            flows_up = [upsample_flow_convex(f, m)
                        for f, m in zip(flows_low, up_masks)]
        out = (torch.stack(flows_low), torch.stack(flows_up))
    else:
        flow_up = upflow8(flow_low) if cfg.small \
            else upsample_flow_convex(flow_low, up_mask)
        out = (flow_low, flow_up)
    return out + (net,) if with_features else out


def pad_to_multiple(img, multiple: int = 8):
    """Replicate-pad H and W (axes -3, -2) at the bottom / right up to a
    multiple. Returns (padded, (orig_h, orig_w))."""
    h, w = img.shape[-3], img.shape[-2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph:
        rows = torch.arange(h + ph, device=img.device).clamp(max=h - 1)
        img = img.index_select(img.dim() - 3, rows)
    if pw:
        cols = torch.arange(w + pw, device=img.device).clamp(max=w - 1)
        img = img.index_select(img.dim() - 2, cols)
    return img, (h, w)


def forward_interpolate(flow):
    """Warm-start flow re-gridding on the host (numpy / scipy): scatter
    each pixel's flow to its forward-advected position and re-grid by
    nearest-neighbour interpolation over the scattered points.

    flow [H, W, 2] (array or CPU tensor) -> [H, W, 2] float32 numpy."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    gy, gx = np.mgrid[0:h, 0:w]
    dx, dy = flow[..., 0], flow[..., 1]
    x1 = (gx + dx).ravel()
    y1 = (gy + dy).ravel()
    keep = (x1 > 0) & (x1 < w) & (y1 > 0) & (y1 < h)
    fx = dx.ravel()[keep]
    fy = dy.ravel()[keep]
    x1, y1 = x1[keep], y1[keep]
    if x1.size == 0:
        return np.zeros_like(flow)
    from scipy import interpolate as _interp
    pts = np.stack([x1, y1], axis=-1)
    fx_g = _interp.griddata(pts, fx, (gx, gy), method="nearest")
    fy_g = _interp.griddata(pts, fy, (gx, gy), method="nearest")
    return np.stack([fx_g, fy_g], axis=-1).astype(np.float32)
