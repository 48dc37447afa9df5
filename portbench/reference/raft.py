"""Plain PyTorch RAFT (Teed & Deng, ECCV 2020: the full model, 4-level
all-pairs correlation pyramid of radius 4, 20 GRU iterations, convex 8x
upsampling) and the learned confidence head, NCHW in float32, read from
the committed ``.npz`` files (flat ``/``-keyed trees, convolutions in
HWIO). It imports nothing of the program.

One departure from princeton-vl's code, which the committed weights were
trained with: the correlation window's channels run y-offset major and
x-offset minor, and the x offset moves x (princeton-vl's
``meshgrid(dy, dx)`` adds its first component to x).

``flow_confidence(..., round_fn=fp8_round)`` is the control's flow:
every convolution's and matrix product's operands rounded by
``round_fn`` (float8 e4m3 with one scale per tensor, the step below the
configuration's bfloat16, as in the SD models' control).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

ITERS = 20
LEVELS = 4
RADIUS = 4
HIDDEN = 128
LEARNED_RADIUS = 1.0 / 3.0


def load_npz(path, device) -> dict:
    """{key: f32 tensor}, convolution kernels turned to OIHW."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = torch.from_numpy(np.asarray(data[k], np.float32))
            if a.ndim == 4:
                a = a.permute(3, 2, 0, 1).contiguous()
            out[k] = a.to(device)
    return out


def _conv(p, name, x, stride=1, padding=None):
    w = p[name + "/w"]
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    return F.conv2d(x, w, p[name + "/b"], stride=stride, padding=padding)


def _norm(p, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x, eps=1e-5)
    g = lambda s: p[f"{name}/{s}"][None, :, None, None]
    return (x - g("mean")) * torch.rsqrt(g("var") + 1e-5) * g("scale") \
        + g("bias")


def _res_unit(p, base, x, kind, stride):
    y = F.relu(_norm(p, base + "/norm1",
                     _conv(p, base + "/conv1", x, stride, 1), kind))
    y = F.relu(_norm(p, base + "/norm2", _conv(p, base + "/conv2", y), kind))
    if base + "/down/w" in p:
        x = _norm(p, base + "/norm3", _conv(p, base + "/down", x, stride, 0),
                  kind)
    return F.relu(x + y)


def encoder(p, base, x, kind):
    h = F.relu(_norm(p, base + "/norm1",
                     _conv(p, base + "/conv1", x, 2, 3), kind))
    for lvl, stride in enumerate((1, 2, 2)):
        h = _res_unit(p, f"{base}/layers/{lvl}/0", h, kind, stride)
        h = _res_unit(p, f"{base}/layers/{lvl}/1", h, kind, 1)
    return _conv(p, base + "/conv2", h)


def _lookup(pyramid, coords):
    """The (2r+1)^2 bilinear window around coords [B, 2, H, W] at every
    level -> [B, L*(2r+1)^2, H, W], zero outside the volume."""
    b, _, h, w = coords.shape
    r = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32,
                     device=coords.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    outs = []
    for lvl, vol in enumerate(pyramid):
        hl, wl = vol.shape[-2:]
        c = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, 2) / 2 ** lvl
        gx = c[..., 0] + dx.reshape(1, -1, 1)
        gy = c[..., 1] + dy.reshape(1, -1, 1)
        grid = torch.stack([2 * gx / (wl - 1) - 1, 2 * gy / (hl - 1) - 1], -1)
        taps = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)            # [BHW, 1, k, 1]
        outs.append(taps.reshape(b, h, w, -1))
    return torch.cat(outs, -1).permute(0, 3, 1, 2)


def _gru(p, h, x):
    for s in ("1", "2"):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_conv(p, "update/gru/convz" + s, hx))
        r = torch.sigmoid(_conv(p, "update/gru/convr" + s, hx))
        q = torch.tanh(_conv(p, "update/gru/convq" + s,
                             torch.cat([r * h, x], 1)))
        h = (1 - z) * h + z * q
    return h


def _upsample(flow, mask):
    n, _, h, w = flow.shape
    m = torch.softmax(mask.view(n, 1, 9, 8, 8, h, w), dim=2)
    nb = F.unfold(8 * flow, 3, padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (m * nb).sum(2)                                    # [n,2,8,8,h,w]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def raft(p, image1, image2):
    """image1 / image2 [B, 3, H, W] RGB 0..255 -> (flow_low [B, 2, H/8,
    W/8], flow [B, 2, H, W], GRU state [B, 128, H/8, W/8]): image1's
    pixels' displacement into image2."""
    img1 = 2 * (image1 / 255.0) - 1
    img2 = 2 * (image2 / 255.0) - 1
    f1, f2 = encoder(p, "fnet", torch.cat([img1, img2]), "instance").chunk(2)
    b, d, h, w = f1.shape
    corr = torch.bmm(f1.reshape(b, d, h * w).transpose(1, 2),
                     f2.reshape(b, d, h * w)) / math.sqrt(d)
    pyramid = [corr.reshape(b * h * w, 1, h, w)]
    for _ in range(LEVELS - 1):
        pyramid.append(F.avg_pool2d(pyramid[-1], 2))
    cnet = encoder(p, "cnet", img1, "batch")
    net, inp = torch.tanh(cnet[:, :HIDDEN]), F.relu(cnet[:, HIDDEN:])
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=f1.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=f1.device), indexing="ij")
    coords0 = torch.stack([xs, ys])[None].expand(b, 2, h, w)
    coords1 = coords0
    for _ in range(ITERS):
        corr_w = _lookup(pyramid, coords1)
        flow = coords1 - coords0
        cor = F.relu(_conv(p, "update/encoder/convc1", corr_w))
        cor = F.relu(_conv(p, "update/encoder/convc2", cor))
        flo = F.relu(_conv(p, "update/encoder/convf1", flow))
        flo = F.relu(_conv(p, "update/encoder/convf2", flo))
        motion = torch.cat([F.relu(_conv(p, "update/encoder/conv",
                                         torch.cat([cor, flo], 1))), flow], 1)
        net = _gru(p, net, torch.cat([inp, motion], 1))
        delta = _conv(p, "update/flow_head/conv2",
                      F.relu(_conv(p, "update/flow_head/conv1", net)))
        mask = 0.25 * _conv(p, "update/mask/conv2",
                            F.relu(_conv(p, "update/mask/conv1", net)))
        coords1 = coords1 + delta
    flow_low = coords1 - coords0
    return flow_low, _upsample(flow_low, mask), net


def learned_confidence(head, net, flow_low, out_hw):
    """The head's Laplace scale of the flow error, as P(|e_x| < R) P(|e_y|
    < R), R = 1/3 px, at full resolution: [B, H, W]."""
    x = torch.cat([net, flow_low * 0.125], 1)
    x = F.relu(_conv(head, "conv1", x))
    x = F.relu(_conv(head, "conv2", x))
    log_b = _conv(head, "out", x).clamp(-6.0, 6.0)
    log_b = F.interpolate(log_b, size=out_hw, mode="bilinear",
                          align_corners=False)[:, 0]
    pr = 1.0 - torch.exp(-LEARNED_RADIUS / torch.exp(log_b))
    return pr * pr


class Rounded(TorchFunctionMode):
    """Convolutions' and matrix products' tensor operands rounded by
    ``round_fn`` (and computed on in float32)."""

    OPS = (F.conv2d, torch.bmm, torch.matmul)

    def __init__(self, round_fn):
        super().__init__()
        self.round_fn = round_fn

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            r = lambda a: self.round_fn(a) if isinstance(
                a, torch.Tensor) and a.is_floating_point() else a
            args = tuple(r(a) for a in args)
            kwargs = {k: r(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def flow_confidence(p, head, src_rgb, tgt_rgb, round_fn=None):
    """The pipeline's flow and learned confidence of target frames against
    their source: (flow [B, 2, H, W] in target coordinates pointing at the
    source, confidence [B, H, W], 0 where the source lies outside). With
    ``round_fn`` the products' operands are rounded by it (the control)."""
    with (Rounded(round_fn) if round_fn is not None
          else contextlib.nullcontext()):
        flow_low, flow, net = raft(p, tgt_rgb, src_rgb)
        h, w = flow.shape[-2:]
        conf = learned_confidence(head, net, flow_low, (h, w))
    xs = torch.arange(w, device=flow.device, dtype=torch.float32)
    ys = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None]
    sx, sy = xs + flow[:, 0], ys + flow[:, 1]
    inb = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    return flow, torch.where(inb, conf, torch.zeros_like(conf))
