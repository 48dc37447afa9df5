"""Flow file IO: Middlebury .flo, PFM, and KITTI 16-bit PNG.

Counterpart of ``sd_animation_optical_flow_tpu/utils/flow_io.py`` (parity
with RAFT's frame_utils: the same magic numbers, layouts and valid-mask
conventions). Host-side numpy. KITTI's 16-bit PNGs and the 8-bit images
of :func:`read_gen` go through cv2, imported where it is used (the card's
machine has none): ``utils/images.read_png_bgr`` stays the port's 8-bit
reader.
"""

from __future__ import annotations

import re

import numpy as np

FLO_MAGIC = 202021.25


def _cv2():
    import cv2
    return cv2


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)[0]
        if magic != FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, 1)[0])
        h = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, 2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray):
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([FLO_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.tofile(f)


def read_pfm(path: str):
    """-> (data, scale). Color or grayscale PFM, sign of scale = endian."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image, np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    if not color and not (image.ndim == 2
                          or (image.ndim == 3 and image.shape[2] == 1)):
        raise ValueError("PFM needs HxWx3 or HxW")
    endian = image.dtype.byteorder
    if endian == "<" or (endian == "=" and np.little_endian):
        scale = -scale
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{scale}\n".encode())
        np.flipud(image).tofile(f)


def read_flow_kitti(path: str):
    """KITTI png16: (flow [H,W,2], valid [H,W])."""
    cv2 = _cv2()
    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)   # BGR -> RGB channel order
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    valid = raw[:, :, 2]
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray):
    """``flow`` [H, W, 2] -> KITTI png16, every pixel valid."""
    cv2 = _cv2()
    flow = 64.0 * np.asarray(flow, np.float64) + 2 ** 15
    h, w = flow.shape[:2]
    out = np.concatenate([flow, np.ones((h, w, 1))], axis=-1)
    cv2.imwrite(path, out[..., ::-1].astype(np.uint16))


def read_gen(path: str):
    """Extension-dispatching reader (frame_utils.read_gen parity)."""
    ext = path.split(".")[-1].lower()
    if ext in ("png", "jpeg", "jpg", "ppm", "bmp"):
        return _cv2().imread(path)[:, :, ::-1]
    if ext == "flo":
        return read_flo(path)
    if ext == "pfm":
        data, _ = read_pfm(path)
        return data[:, :, :2] if data.ndim == 3 else data
    raise ValueError(f"unsupported extension: {ext}")
