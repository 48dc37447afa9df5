"""Host <-> device image conversions and PNG files.

Counterpart of ``sd_animation_optical_flow_tpu/utils/images.py``. The
pipelines keep the external contract (BGR uint8 frames in,
``converted_%06d.png`` out) while the device works in NHWC float [-1, 1]
RGB. PNGs are written and read with the standard library (``zlib``,
``struct``): 8-bit BGR (stored as RGB) and gray images, which
``cv2.imread`` decodes to the same pixels; the port needs no cv2.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def bgr_u8_to_model(img_bgr, device="cuda") -> torch.Tensor:
    """[H, W, 3] BGR uint8 -> [1, H, W, 3] RGB float32 in [-1, 1] on
    ``device`` (the uint8 bytes are uploaded, converted there)."""
    d = torch.as_tensor(np.ascontiguousarray(img_bgr), device=device)
    return (d.flip(-1).float() / 127.5 - 1.0)[None]


def model_to_bgr_u8(img) -> np.ndarray:
    """[1, H, W, 3] RGB [-1, 1] -> [H, W, 3] BGR uint8 (numpy)."""
    arr = img[0].float().cpu().numpy()
    arr = np.clip(arr * 127.5 + 127.5, 0, 255).astype(np.uint8)
    return arr[..., ::-1]


def rgb_u8(img) -> np.ndarray:
    """[1, H, W, 3] or [H, W, 3] RGB [-1, 1] -> RGB uint8 (numpy)."""
    arr = (img[0] if img.dim() == 4 else img).float().cpu().numpy()
    return np.clip(arr * 127.5 + 127.5, 0, 255).astype(np.uint8)


def bgr_f32d_to_model(img_bgr_d) -> torch.Tensor:
    """Device [H, W, 3] BGR float 0..255 -> [1, H, W, 3] RGB [-1, 1],
    on the same device."""
    return (img_bgr_d.flip(-1) / 127.5 - 1.0)[None]


def model_to_bgr_f32d(img) -> torch.Tensor:
    """Device [1, H, W, 3] RGB [-1, 1] -> [H, W, 3] BGR float 0..255,
    on the same device."""
    return torch.clamp(img[0].float() * 127.5 + 127.5, 0.0, 255.0).flip(-1)


def bgr_f32_to_u8(img_bgr_d) -> np.ndarray:
    """A device BGR float frame -> host uint8: clipped and floored on the
    device (numpy's astype(uint8) truncation for the clipped range), so
    only uint8 crosses to the host."""
    if img_bgr_d.dtype == torch.uint8:
        return img_bgr_d.cpu().numpy()
    u8 = torch.floor(torch.clamp(img_bgr_d, 0, 255)).to(torch.uint8)
    return u8.cpu().numpy()


def queue_host_copies(tensors):
    """Queue device -> host copies of ``tensors`` (a list) into pinned
    buffers on the current stream, behind the work that makes them, and
    record an event after them: waiting on that event waits for these
    copies alone, where a ``.cpu()`` on the stream would wait for
    everything queued there. Returns (host tensors, event); CPU tensors
    come back as they are, with None."""
    if all(t.device.type == "cpu" for t in tensors):
        return list(tensors), None
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    for host, t in zip(hosts, tensors):
        host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return hosts, ready


# ---------------------------------------------------------------------------
# PNG files
# ---------------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img_bgr: np.ndarray) -> bytes:
    """An 8-bit PNG of a [H, W] gray or [H, W, 3] BGR uint8 image (rows
    unfiltered, zlib level 1: the frames are written on the pipeline's
    clock)."""
    img = np.asarray(img_bgr)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected [H, W] or [H, W, 3] uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    pix = img if img.ndim == 2 else img[..., ::-1]          # BGR -> RGB
    rows = np.ascontiguousarray(pix).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_png(path: str, img_bgr: np.ndarray):
    """Write a [H, W] gray or [H, W, 3] BGR uint8 image as a PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = encode_png(img_bgr)
    with open(path, "wb") as f:
        f.write(data)


class PngWriter:
    """Write-behind PNG writer: encodes (zlib releases the GIL) and writes
    on worker threads, so PNG output overlaps device work. ``close()``
    drains the queue and re-raises the first worker error; close it (or
    use it as a context manager) before treating the output directory
    as complete."""

    def __init__(self, workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor
        self._ex = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix="pngw")
        self._futs = []

    def submit(self, path: str, img_bgr: np.ndarray):
        self._futs.append(self._ex.submit(write_png, path, img_bgr))

    def close(self):
        futs, self._futs = self._futs, []
        try:
            for f in futs:
                f.result()
        finally:
            self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = data[y, 0], data[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:     # Sub: a running sum per byte lane, mod 256
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
            cur = cur[:stride]
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = bytearray(stride)
            up = prev.tolist()
            for i, v in enumerate(line.tolist()):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    cur[i] = (v + ((a + up[i]) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (v + _paeth(a, up[i], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def read_png_bgr(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced PNG as [H, W, 3] BGR uint8 (gray,
    palette and alpha images converted as cv2.IMREAD_COLOR does)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if depth != 8 or interlace or channels is None:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are "
                         f"read (bit depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                    channels).reshape(h, w, channels)
    if color == 3:
        rgb = palette[pix[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(pix[..., :1], 3, axis=2)
    else:
        rgb = pix[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])
