"""Key-frame detection and frame generation, on torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/keyframes.py``:
per-frame Canny edges of the HSV value channel with median-adaptive
thresholds, dilated by a resolution-derived square, and a mean-pixel-
distance trigger whose threshold falls linearly with the gap since the
last key frame. The edge maps are computed on ``device`` by the port's
own ``canny`` and ``dilate`` (cv2's maps, pixel for pixel), so the
detector needs no cv2; only ``frame_generator`` decodes a video file
with it. As in JAX, the end of a video is detected (the reference's
``if ret is None`` never fires).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.filters import canny, dilate
from ..ops.resize import resize_u8
from ..utils.images import queue_host_copies

# array_frame_generator's gap at which the threshold reaches 0 (JAX's)
_ARRAY_MAX_GAP = 300


def mean_pixel_distance(left: np.ndarray, right: np.ndarray) -> float:
    """Mean |a-b| between two 2D uint8 images."""
    num = float(left.shape[0] * left.shape[1])
    return float(np.sum(np.abs(left.astype(np.int32)
                               - right.astype(np.int32))) / num)


def estimated_kernel_size(frame_width: int, frame_height: int) -> int:
    size = 4 + round(math.sqrt(frame_width * frame_height) / 192)
    return size + 1 if size % 2 == 0 else size


def _median_u8(lum) -> float:
    """np.median of a uint8 tensor from its 256-bin histogram: the mean of
    the two middle values when the count is even."""
    hist = torch.bincount(lum.flatten().long(), minlength=256).cpu().numpy()
    cum = np.cumsum(hist)
    n = int(cum[-1])
    upper = int(np.searchsorted(cum, n // 2, side="right"))
    if n % 2:
        return float(upper)
    lower = int(np.searchsorted(cum, n // 2 - 1, side="right"))
    return (lower + upper) / 2.0


class EdgeDetector:
    """Canny + dilate key-frame edge maps with adaptive thresholds, on
    ``device``.

    On the card the detector works on a stream of its own and reads its
    results back through an event, so a read waits for the detector
    alone, not for the denoise a pipeline has queued on the default
    stream."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._kernel: Optional[np.ndarray] = None
        self._stream = None

    def _context(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._stream)

    def _to_host(self, tensors):
        """numpy copies of device tensors, read back on the detector's
        stream through pinned buffers and an event."""
        hosts, ready = queue_host_copies(tensors)
        if ready is not None:
            ready.synchronize()
        return [h.numpy() for h in hosts]

    def _edges(self, frame_d):
        """The dilated edge map of a device BGR uint8 frame [H, W, 3]."""
        lum = frame_d.amax(-1)          # the HSV value channel
        if self._kernel is None:
            k = estimated_kernel_size(lum.shape[1], lum.shape[0])
            self._kernel = np.ones((k, k), bool)
        sigma = 1.0 / 3.0
        median = _median_u8(lum)
        low = int(max(0, (1.0 - sigma) * median))
        high = int(min(255, (1.0 + sigma) * median))
        return dilate(canny(lum, low, high), self._kernel)

    def resize_and_detect(self, frame_bgr: np.ndarray, size=None):
        """(frame, edge map) of a BGR uint8 frame [H, W, 3], as numpy.
        ``size`` (width, height): the frame is first area-resized to it
        when its size differs (cv2.resize INTER_AREA's pixels)."""
        with self._context():
            frame_d = torch.as_tensor(np.ascontiguousarray(frame_bgr),
                                      device=self.device)
            resized = size is not None and \
                tuple(frame_bgr.shape[1::-1]) != tuple(size)
            if resized:
                frame_d = resize_u8(frame_d, (size[1], size[0]), "area")
            edges = self._edges(frame_d)
            if resized:
                return tuple(self._to_host([frame_d, edges]))
            return frame_bgr, self._to_host([edges])[0]

    def __call__(self, frame_bgr: np.ndarray) -> np.ndarray:
        """The dilated edge map of a BGR uint8 frame [H, W, 3] (numpy)."""
        return self.resize_and_detect(frame_bgr)[1]


@dataclass
class FrameGenConfig:
    size: Tuple[int, int] = (512, 768)     # (width, height) cv2 order
    keep_every: int = 3
    threshold: float = 8.5
    min_gap: int = -1
    max_gap: int = -1


def _select_key_frames(frames, cfg: FrameGenConfig, max_gap: int, device):
    """(frame_bgr, is_key, index) over every ``keep_every``-th frame:
    resized to ``cfg.size``, a key frame where the edge maps' distance to
    the last key frame's passes the falling threshold. As in JAX the
    gap counts the skipped frames too, and the first key frame does not
    reset it."""
    detector = EdgeDetector(device)
    key_edges = None
    gap = 0
    ctr_valid = -1
    for i, frame in enumerate(frames):
        gap += 1
        if i % cfg.keep_every != 0:
            continue
        frame, edges = detector.resize_and_detect(frame, cfg.size)
        ctr_valid += 1
        if key_edges is None:
            key_edges = edges
            yield frame, True, ctr_valid
            continue
        delta = mean_pixel_distance(edges, key_edges)
        if cfg.threshold * (max_gap - gap) / max_gap < delta:
            key_edges = edges
            gap = 0
            yield frame, True, ctr_valid
        else:
            yield frame, False, ctr_valid


def frame_generator(video_file: str, cfg: FrameGenConfig = FrameGenConfig(),
                    device="cuda") -> Iterator[Tuple[np.ndarray, bool, int]]:
    """Yield (frame_bgr, is_key_frame, index) from a video file (the
    reference's frame_generator contract). Decoding needs cv2, imported
    here: where cv2 is missing this raises ImportError, and frames reach
    the pipeline through :func:`array_frame_generator`."""
    import cv2
    video = cv2.VideoCapture(video_file)
    fps = video.get(cv2.CAP_PROP_FPS) or 30.0
    # the reference also derives a min_gap from the fps and never reads it
    max_gap = int(300 * fps / 30) if cfg.max_gap == -1 else \
        int(max(10, cfg.max_gap) * fps / 30)

    def decoded():
        while True:
            ret, frame = video.read()
            if not ret:
                return
            yield frame
    try:
        yield from _select_key_frames(decoded(), cfg, max_gap, device)
    finally:
        video.release()


def array_frame_generator(frames, cfg: FrameGenConfig = FrameGenConfig(),
                          device="cuda"):
    """The same detector over an in-memory [N, H, W, 3] BGR uint8 array
    (or any iterable of frames), with the threshold's gap fixed at 300."""
    return _select_key_frames(frames, cfg, _ARRAY_MAX_GAP, device)
