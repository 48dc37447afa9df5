"""Seeded video clips from a traffic file's parameters.

Every clip is a textured scene panning ``pan_px`` a frame to the left
with a textured rectangle (a quarter of each side) moving ``rect_px``
(x, y) a frame over it: seeded noise upsampled from grids 1/4 .. 1/32 of
the size and summed with falling weights, made on the device in bulk.
Key frames fall every ``key_every`` frames from each clip's first. The
same seed gives the same clips; every seed gives clips of the same sizes
and key pattern.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _texture(gen, h, w, device, octaves=(4, 8, 16, 32)):
    img = torch.zeros((1, 3, h, w), device=device)
    amp = 1.0
    for sc in octaves:
        grid = torch.randn((1, 3, max(h // sc, 2), max(w // sc, 2)),
                           generator=gen, device=device)
        img += amp * F.interpolate(grid, size=(h, w), mode="bilinear",
                                   align_corners=True)
        amp *= 0.7
    img = img[0].permute(1, 2, 0)
    img -= img.min()
    return img * (255.0 / img.max())


def make_clips(t: dict, seed: int, device):
    """``t['pool_clips']`` clips of ``t['clip_frames']`` BGR uint8 frames
    [n, H, W, 3] (numpy, the pipeline's input)."""
    h, w, n = t["height"], t["width"], t["clip_frames"]
    dx, dy = t["rect_px"]
    gen = torch.Generator(device).manual_seed(seed)
    clips = []
    for _ in range(t["pool_clips"]):
        bg = _texture(gen, h, w + t["pan_px"] * n, device)
        fg = _texture(gen, h // 4, w // 4, device)
        frames = []
        for k in range(n):
            f = bg[:, t["pan_px"] * k:t["pan_px"] * k + w].clone()
            y, x = h // 3 + dy * k, w // 3 + dx * k
            f[y:y + h // 4, x:x + w // 4] = fg
            frames.append(f)
        u8 = torch.stack(frames).round().clamp(0, 255).to(torch.uint8)
        clips.append(u8.flip(-1).cpu().numpy())
    return clips


def key_flags(t: dict):
    """Whether each frame of a clip is a key frame."""
    return [k % t["key_every"] == 0 for k in range(t["clip_frames"])]
