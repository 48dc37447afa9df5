"""Faults planted under the pixel pipeline's timed path, to show that the
check comes out not correct when the program goes wrong.

``plant(name, clip_frames)`` is a context manager that patches one of
the program's functions for its duration:

* ``state_unchanged``: every denoise returns its state unchanged;
* ``half_batch_mean``: half of every UNet batch left out, its rows the
  mean of the rows computed;
* ``half_batch_dup``: in each guidance half of a UNet batch of two rows
  or more, the second half of the rows takes the first half's output (a
  batch of 8 frames: frames 4-7 get frames 0-3's);
* ``frames_swapped``: the frames at positions 1 and 2 of every clip
  written under each other's names;
* ``answer_altered``: the top half of every written frame inverted.
"""

from __future__ import annotations

import contextlib
import importlib
import re
import threading
from unittest import mock

import torch

PKG = "sd_animation_optical_flow_tpu_torch"
TARGETS = {
    "state_unchanged": f"{PKG}.diffusion.multistep.multistep_decode",
    "half_batch_mean": f"{PKG}.models.unet.unet_apply",
    "half_batch_dup": f"{PKG}.models.unet.unet_apply",
    "frames_swapped": f"{PKG}.utils.images.write_png",
    "answer_altered": f"{PKG}.utils.images.write_png",
}
NAMES = tuple(TARGETS)


def _state_unchanged(real, clip_frames):
    def step(model_fn, coeffs, x, *a, **k):
        return x
    return step


def _half_batch_mean(real, clip_frames):
    def unet(*a, **k):
        out, kv = real(*a, **k)
        h = max(out.shape[0] // 2, 1)
        out = torch.cat([out[:h], out[:h].mean(0, keepdim=True).expand(
            out.shape[0] - h, *out.shape[1:])])
        return out, kv
    return unet


def _half_batch_dup(real, clip_frames):
    def unet(*a, **k):
        out, kv = real(*a, **k)
        b = out.shape[0] // 2           # rows per guidance half
        if b < 2:
            return out, kv
        halves = out.view(2, b, *out.shape[1:]).clone()
        h = b // 2
        halves[:, b - h:] = halves[:, :h]
        return halves.view(out.shape), kv
    return unet


def _frames_swapped(real, clip_frames):
    held, lock = {}, threading.Lock()

    def write(path, img):
        m = re.search(r"converted_(\d+)\.png$", path)
        pos = int(m.group(1)) % clip_frames if m else None
        if pos not in (1, 2):
            return real(path, img)
        base = int(m.group(1)) - pos
        with lock:
            held[pos, base] = (path, img)
            if (3 - pos, base) not in held:
                return None
            other_path, other = held.pop((3 - pos, base))
            held.pop((pos, base))
        real(path, other)
        return real(other_path, img)
    return write


def _answer_altered(real, clip_frames):
    def write(path, img):
        if "converted_" in path:
            img = img.copy()
            img[: img.shape[0] // 2] = 255 - img[: img.shape[0] // 2]
        return real(path, img)
    return write


FAULTS = {"state_unchanged": _state_unchanged,
          "half_batch_mean": _half_batch_mean,
          "half_batch_dup": _half_batch_dup,
          "frames_swapped": _frames_swapped,
          "answer_altered": _answer_altered}


@contextlib.contextmanager
def plant(name: str, clip_frames: int):
    """Patch the program with fault ``name`` while the block runs."""
    mod_name, attr = TARGETS[name].rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    fault = FAULTS[name](getattr(mod, attr), clip_frames)
    with mock.patch.object(mod, attr, fault):
        yield
