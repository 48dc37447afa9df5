"""Image-logging utilities: grids, text panels, denoise rows.

Counterpart of ``sd_animation_optical_flow_tpu/utils/logging_images.py``
(capabilities-parity with the reference's training observability:
``log_txt_as_img``, ``count_params``, ``log_images``' diffusion and
denoise-row grids through torchvision's ``make_grid``). Host-side numpy;
PIL is imported where the text panel needs it (the card's machine has
none). Logging is not a compute path.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from .tree import tree_leaves


def count_params(params, verbose: bool = False) -> int:
    """Total parameter count of a parameter tree (nested dicts / lists /
    tuples of tensors or arrays; ldm/util.py:43-48)."""
    total = sum(int(np.prod(x.shape))
                for x in tree_leaves(params)
                if hasattr(x, "shape"))
    if verbose:
        print(f"{total * 1e-6:.2f} M params.")
    return total


def make_grid(images: np.ndarray, nrow: int = 4,
              padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """[N, H, W, C] -> single [H', W', C] grid image (torchvision
    make_grid semantics, NHWC)."""
    n, h, w, c = images.shape
    ncol = min(nrow, n)
    nrows = math.ceil(n / ncol)
    grid = np.full((nrows * (h + padding) + padding,
                    ncol * (w + padding) + padding, c),
                   pad_value, images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def log_txt_as_img(wh, xc: Sequence[str], size: int = 10) -> np.ndarray:
    """Render a batch of captions as images [B, H, W, 3] in [-1, 1]
    (ldm/util.py:14-33)."""
    from PIL import Image, ImageDraw, ImageFont
    w, h = wh
    out = []
    for text in xc:
        img = Image.new("RGB", (w, h), color="white")
        draw = ImageDraw.Draw(img)
        try:
            font = ImageFont.truetype("DejaVuSans.ttf", size=size)
        except OSError:
            font = ImageFont.load_default()
        nc = max(int(40 * (w / 256)), 1)
        lines = "\n".join(text[s: s + nc]
                          for s in range(0, len(text), nc))
        try:
            draw.text((0, 0), lines, fill="black", font=font)
        except UnicodeEncodeError:
            pass  # the reference prints a warning and skips
        arr = np.asarray(img).astype(np.float32) / 127.5 - 1.0
        out.append(arr)
    return np.stack(out)


def denoise_row_grid(rows: List[np.ndarray], nrow: int | None = None
                     ) -> np.ndarray:
    """List of per-log-step decoded batches [B, H, W, C] -> one grid
    ordered (batch-major, step-minor) — the _get_denoise_row_from_list
    layout (ddpm.py:683-692)."""
    stacked = np.stack(rows)                     # [S, B, H, W, C]
    s, b = stacked.shape[:2]
    interleaved = stacked.transpose(1, 0, 2, 3, 4).reshape(
        s * b, *stacked.shape[2:])
    return make_grid(interleaved, nrow=s)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8 RGB."""
    return np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)
