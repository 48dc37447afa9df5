"""Model FLOPs of one evaluation of each network at the cell's shapes,
counted by ``torch.utils.flop_counter`` on the plain reference run on the
meta device (no memory, no arithmetic): matrix products, convolutions and
attention, 2 FLOP a multiply-add; elementwise work is not counted, as
model FLOPs never count it.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import raft as R
from ..reference.sd import build_modules


def _count(fn) -> int:
    with torch.device("meta"), FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _modules(cfg_json: str):
    return build_modules(json.loads(cfg_json), "meta")


@functools.lru_cache(maxsize=None)
def _unet(cfg_json, part, batch, h, w, ctx_len):
    m = _modules(cfg_json)[part]
    cin = m.input_blocks[0][0].in_channels
    cdim = json.loads(cfg_json)["unet"]["context_dim"]
    return _count(lambda: m(torch.empty(batch, cin, h, w),
                            torch.zeros(batch, dtype=torch.long),
                            torch.empty(batch, ctx_len, cdim)))


def unet(cfg: dict, part: str, batch: int, latent_hw, ctx_len: int = 231):
    """One evaluation of ``part`` ('unet' / 'unet9') at ``batch`` rows."""
    return _unet(json.dumps(cfg, sort_keys=True), part, batch, *latent_hw,
                 ctx_len)


@functools.lru_cache(maxsize=None)
def _vae(cfg_json, which, batch, h, w):
    vae = _modules(cfg_json)["vae"]
    if which == "encode":
        return _count(lambda: vae.encode(torch.empty(batch, 3, h, w),
                                         torch.empty(batch, 4, h // 8,
                                                     w // 8)))
    return _count(lambda: vae.decode(torch.empty(batch, 4, h // 8, w // 8)))


def vae_encode(cfg: dict, batch: int, image_hw):
    return _vae(json.dumps(cfg, sort_keys=True), "encode", batch, *image_hw)


def vae_decode(cfg: dict, batch: int, image_hw):
    return _vae(json.dumps(cfg, sort_keys=True), "decode", batch, *image_hw)


@functools.lru_cache(maxsize=None)
def flow_pair(raft_npz: str, head_npz: str, h: int, w: int) -> int:
    """RAFT (one direction, 20 iterations) and the confidence head on one
    pair of [h, w] frames."""
    def meta(path):
        with np.load(path) as data:
            out = {}
            for k in data.files:
                s = data[k].shape
                s = (s[3], s[2], s[0], s[1]) if len(s) == 4 else s
                out[k] = torch.empty(s, device="meta")
        return out
    p, head = meta(raft_npz), meta(head_npz)
    img = lambda: torch.empty(1, 3, h, w)
    return _count(lambda: R.flow_confidence(p, head, img(), img()))
