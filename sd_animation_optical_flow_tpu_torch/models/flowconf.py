"""Dense flow + per-pixel confidence on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/models/flowconf.py``. RAFT
estimates both directions of each frame pair in one batch, and the
confidence comes from forward-backward consistency with out-of-bounds
masking (``fb_confidence``: ~0.95 at ~1/3 px round-trip error), from a
learned uncertainty head over RAFT's final GRU state (``learned``: a
per-pixel Laplace scale b of the flow error, confidence (1 -
exp(-R/b))^2), or from the minimum of both (``min``).
``FlowConfidenceEstimator`` is the ``calc`` / ``calc_batch`` provider the
pipelines call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.warp import remap
from ..utils.profiling import annotate
from .layers import Init, conv2d, conv2d_init
from .raft import RAFTConfig, pad_to_multiple, raft_apply

# log-confidence of a pixel whose source lies outside the frame
OOB_LOG_CONF = -1e4


@dataclass(frozen=True)
class FlowConfidenceConfig:
    raft: RAFTConfig = RAFTConfig()
    # conf = exp(-e_fb^2 / (2 sigma^2)); sigma = 1.03 => conf(1/3 px) ~ 0.95
    fb_sigma: float = 1.03
    # relative slack: the tolerated error grows with the flow magnitude
    fb_alpha: float = 0.01
    # "fb" (forward-backward consistency), "learned" (the trained
    # uncertainty head) or "min" (both must pass); "learned" / "min"
    # need the head's parameters
    uncertainty: str = "fb"
    # learned confidence = P(|e_x| < R) P(|e_y| < R) under the predicted
    # Laplace scale; R = 1/3 px matches the fb calibration at ~0.95
    learned_radius: float = 1.0 / 3.0


# ---------------------------------------------------------------------------
# the learned uncertainty head
# ---------------------------------------------------------------------------

def uncertainty_head_init(init: Init, hidden_dim: int = 128):
    in_ch = hidden_dim + 2                    # GRU state + low-res flow
    return {"conv1": conv2d_init(init, in_ch, 128, 3),
            "conv2": conv2d_init(init, 128, 64, 3),
            "out": conv2d_init(init, 64, 1, 1)}


def uncertainty_head_apply(params, net, flow_low):
    """net [N, H/8, W/8, hidden], flow_low [N, H/8, W/8, 2] -> log_b
    [N, H/8, W/8], the log Laplace scale of the per-axis flow error in
    full-res pixels, clamped to [-6, 6]."""
    x = torch.cat([net, flow_low * 0.125], dim=-1)
    x = F.relu(conv2d(params["conv1"], x))
    x = F.relu(conv2d(params["conv2"], x))
    return torch.clamp(conv2d(params["out"], x)[..., 0], -6.0, 6.0)


def learned_confidence(log_b_low, out_hw, radius: float):
    """Upsample the 1/8-res log scale to ``out_hw`` (bilinear, half-pixel
    centres) and map it to (1 - exp(-R / b))^2 in (0, 1)."""
    log_b = F.interpolate(log_b_low[:, None], size=tuple(out_hw),
                          mode="bilinear", align_corners=False)[:, 0]
    p = 1.0 - torch.exp(-radius / torch.exp(log_b))
    return p * p


def _in_bounds(flow):
    """flow [..., H, W, 2] -> bool [..., H, W]: the source pixel x + flow
    lies inside the frame."""
    h, w = flow.shape[-3:-1]
    dev = flow.device
    sx = torch.arange(w, dtype=torch.float32, device=dev) + flow[..., 0]
    sy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        + flow[..., 1]
    return (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)


def _warp_field(field, flow):
    """Sample ``field`` [H, W, C] at x + flow (bilinear, zero border)."""
    h, w = flow.shape[:2]
    dev = flow.device
    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        + flow[..., 1]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        + flow[..., 0]
    return remap(field, gx, gy, mode="linear")


def fb_confidence(flow_fwd, flow_bwd, *, sigma: float, alpha: float):
    """Forward-backward consistency confidence of one frame.

    flow_fwd [H, W, 2]: target -> source; flow_bwd [H, W, 2]: source ->
    target. Round-trip error e(x) = |flow_fwd(x) + flow_bwd(x +
    flow_fwd(x))|. Returns (confidence, log_confidence); a pixel whose
    source lies outside the frame gets log-confidence -1e4."""
    bwd_at = _warp_field(flow_bwd, flow_fwd)
    rt = flow_fwd + bwd_at
    err2 = rt[..., 0] ** 2 + rt[..., 1] ** 2
    mag2 = (flow_fwd ** 2).sum(-1) + (bwd_at ** 2).sum(-1)
    log_conf = -err2 / (2.0 * sigma ** 2 + alpha * mag2)
    log_conf = torch.where(_in_bounds(flow_fwd), log_conf, OOB_LOG_CONF)
    return torch.exp(log_conf), log_conf


def _fb_batch(flow_fwd, flow_bwd, cfg: FlowConfidenceConfig):
    """fb_confidence over a batch of frames -> (conf, log_conf) [B, H, W]."""
    pairs = [fb_confidence(f, b, sigma=cfg.fb_sigma, alpha=cfg.fb_alpha)
             for f, b in zip(flow_fwd, flow_bwd)]
    return (torch.stack([c for c, _ in pairs]),
            torch.stack([lc for _, lc in pairs]))


def _need_head(head_params):
    if head_params is None:
        raise ValueError("uncertainty 'learned' / 'min' needs the trained "
                         "uncertainty head's parameters")


def _flow_conf_batch(params, cfg: FlowConfidenceConfig, src, tgt,
                     iters: int | None = None, head_params=None):
    """src / tgt [B, H, W, 3] RGB float 0-255 (H, W multiples of 8).

    Returns (flow [B, H, W, 2] in target coordinates, conf [B, H, W],
    log_conf). 'learned' runs RAFT one way (target -> source) and masks
    only out-of-bounds pixels; 'fb' and 'min' run one RAFT batch of 2B
    [tgt -> src | src -> tgt]."""
    b = src.shape[0]
    if cfg.uncertainty == "learned":
        _need_head(head_params)
        flow_low, flow_fwd, net = raft_apply(
            params, cfg.raft, tgt, src, iters=iters, with_features=True)
        log_b = uncertainty_head_apply(head_params, net, flow_low)
        conf_l = learned_confidence(log_b, flow_fwd.shape[1:3],
                                    cfg.learned_radius)
        inb = _in_bounds(flow_fwd)
        log_conf = torch.where(inb, torch.log(conf_l + 1e-30), OOB_LOG_CONF)
        return flow_fwd, torch.where(inb, conf_l, 0.0), log_conf
    img1 = torch.cat([tgt, src], dim=0)
    img2 = torch.cat([src, tgt], dim=0)
    want_feats = cfg.uncertainty != "fb"
    if want_feats:
        flow_low2, flow_up, net2 = raft_apply(
            params, cfg.raft, img1, img2, iters=iters, with_features=True)
    else:
        _, flow_up = raft_apply(params, cfg.raft, img1, img2, iters=iters)
    flow_fwd, flow_bwd = flow_up[:b], flow_up[b:]
    conf, log_conf = _fb_batch(flow_fwd, flow_bwd, cfg)
    if want_feats:
        _need_head(head_params)
        log_b = uncertainty_head_apply(head_params, net2[:b], flow_low2[:b])
        conf_l = learned_confidence(log_b, flow_fwd.shape[1:3],
                                    cfg.learned_radius)
        conf_new = torch.minimum(conf, conf_l)
        # keep the out-of-bounds sentinel of the fb pass
        oob = log_conf <= OOB_LOG_CONF
        log_conf = torch.where(oob, OOB_LOG_CONF,
                               torch.log(conf_new + 1e-30))
        conf = conf_new
    return flow_fwd, conf, log_conf


def _flow_conf_batch_bidir(params, cfg: FlowConfidenceConfig, src, tgt,
                           iters: int | None = None, head_params=None):
    """Both directions of each pair from one RAFT batch of 2B.

    Returns (flow_st [B, H, W, 2] in t coordinates, conf_st, flow_ts in s
    coordinates, conf_ts): the same as two ``_flow_conf_batch`` calls
    with the roles swapped (the encoders work per image). With
    'learned' / 'min' the head is applied to both directions; 'learned'
    zeroes only out-of-bounds pixels, as the one-way path does."""
    b = src.shape[0]
    img1 = torch.cat([tgt, src], dim=0)
    img2 = torch.cat([src, tgt], dim=0)
    want_feats = cfg.uncertainty != "fb"
    if want_feats:
        flow_low2, flow_up, net2 = raft_apply(
            params, cfg.raft, img1, img2, iters=iters, with_features=True)
    else:
        _, flow_up = raft_apply(params, cfg.raft, img1, img2, iters=iters)
    flow_fwd, flow_bwd = flow_up[:b], flow_up[b:]
    conf_st, _ = _fb_batch(flow_fwd, flow_bwd, cfg)
    conf_ts, _ = _fb_batch(flow_bwd, flow_fwd, cfg)
    if want_feats:
        _need_head(head_params)
        log_b = uncertainty_head_apply(head_params, net2, flow_low2)
        conf_l = learned_confidence(log_b, flow_fwd.shape[1:3],
                                    cfg.learned_radius)
        if cfg.uncertainty == "learned":
            conf_st = torch.where(_in_bounds(flow_fwd), conf_l[:b], 0.0)
            conf_ts = torch.where(_in_bounds(flow_bwd), conf_l[b:], 0.0)
        else:
            conf_st = torch.minimum(conf_st, conf_l[:b])
            conf_ts = torch.minimum(conf_ts, conf_l[b:])
    return flow_fwd, conf_st, flow_bwd, conf_ts


def _numpy(t, dtype=None):
    t = t if dtype is None else t.to(dtype)
    return t.cpu().numpy()


class FlowConfidenceEstimator:
    """``calc`` / ``calc_batch`` provider on ``device``. ``params`` (RAFT)
    and ``head_params`` (the uncertainty head, needed for 'learned' /
    'min') are port trees on that device; ``chunk``: pairs per RAFT call
    (0: the whole batch in one)."""

    def __init__(self, params, cfg: FlowConfidenceConfig =
                 FlowConfidenceConfig(), chunk: int = 0, head_params=None,
                 device="cuda"):
        self.params = params
        self.cfg = cfg
        self.head_params = head_params
        self.chunk = max(chunk, 0)
        self.device = torch.device(device)

    def _upload(self, frames):
        """[B, H, W, 3] frames (numpy or tensor, any dtype) -> f32 on the
        estimator's device, padded to a multiple of 8."""
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        # uploaded in the caller's dtype (uint8 frames are 4x lighter),
        # cast on the device
        return pad_to_multiple(frames.to(self.device).float(), 8)

    def calc(self, frame_src, frame_tgt):
        """frame_* [H, W, 3] RGB. Returns numpy (flow [H, W, 2], confidence
        [H, W], log_confidence): flow in target coordinates pointing at
        source pixels."""
        flow, conf, log_conf = self.calc_batch(frame_src[None],
                                               frame_tgt[None])
        return flow[0], conf[0], log_conf[0]

    def calc_batch(self, src, tgt):
        """src / tgt [B, H, W, 3] -> numpy (flow [B, H, W, 2], conf,
        log_conf)."""
        return tuple(_numpy(a) for a in self.calc_batch_device(src, tgt))

    def calc_batch_f16(self, src, tgt):
        """calc_batch's flow and confidence as float16 numpy, without the
        log-confidence."""
        flow, conf, _ = self.calc_batch_device(src, tgt)
        return _numpy(flow, torch.float16), _numpy(conf, torch.float16)

    def calc_batch_bidir_f16(self, src, tgt):
        """Both directions per pair from one RAFT batch: float16 numpy
        (flow_st, conf_st, flow_ts, conf_ts); flow_st lives in the tgt
        frame (pointing at src), flow_ts in the src frame."""
        src_p, (h, w) = self._upload(src)
        tgt_p, _ = self._upload(tgt)
        outs = _flow_conf_batch_bidir(self.params, self.cfg, src_p, tgt_p,
                                      head_params=self.head_params)
        return tuple(_numpy(a[:, :h, :w], torch.float16) for a in outs)

    def calc_batch_device(self, src, tgt):
        """(flow, conf, log_conf) as tensors on the device, queued without
        a host sync: the caller can queue the next frame's flow before it
        reads this one's."""
        with annotate("sdaof.flow.estimate"):
            src_p, (h, w) = self._upload(src)
            tgt_p, _ = self._upload(tgt)
            b = src_p.shape[0]
            step = self.chunk if 0 < self.chunk < b else b
            parts = [_flow_conf_batch(self.params, self.cfg,
                                      src_p[i:i + step], tgt_p[i:i + step],
                                      head_params=self.head_params)
                     for i in range(0, b, step)]
            return tuple(torch.cat([p[k] for p in parts])[:, :h, :w]
                         for k in range(3))
