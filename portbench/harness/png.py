"""Read an 8-bit RGB or gray PNG into a BGR (or gray) uint8 array, with
zlib and numpy: the frames a run wrote are judged as a user reads them."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"{path}: only 8-bit gray / RGB, not interlaced")
    bpp = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.int32)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        prev = out[y - 1] if y else np.zeros_like(line)
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros_like(line)
            for x in range(w * bpp):
                a = cur[x - bpp] if x >= bpp else 0
                c = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + prev[x]) // 2
                else:
                    pred = int(_paeth(np.int32(a), prev[x], np.int32(c)))
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
    img = out.astype(np.uint8).reshape(h, w, bpp)
    return img[..., ::-1].copy() if bpp == 3 else img[..., 0]
