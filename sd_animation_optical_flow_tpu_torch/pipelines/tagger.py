"""Booru tag prompting (a WD-1.4 tagger through ONNX), optional.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/tagger.py``: the
tagger builds each frame's positive prompt from its tags. onnxruntime is
imported only when a model is given; when the runtime or the model files
are missing the tagger is unavailable and the pipelines use the fixed
prompt prefix. The image preprocessing (pad to a white square, resize to
the model's input) runs in torch on ``device``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.resize import resize_u8

PROMPT_PREFIX = "masterpiece,best quality,"
NEGATIVE_PROMPT = "worst quality, low quality, normal quality"


class Tagger:
    """An ONNX tagger when one is available; otherwise ``available`` is
    False and no tags are produced."""

    def __init__(self, model_path: Optional[str] = None,
                 tags_path: Optional[str] = None,
                 threshold: float = 0.75, device="cuda"):
        self.threshold = threshold
        self.device = torch.device(device)
        self._session = None
        self._tags = None
        if model_path and tags_path:
            try:
                import csv
                import onnxruntime as ort
                self._session = ort.InferenceSession(
                    model_path, providers=["CPUExecutionProvider"])
                with open(tags_path) as f:
                    self._tags = [row["name"] for row in csv.DictReader(f)]
            except Exception:
                # no runtime, or a model or tag file it cannot read: the
                # pipelines go on with the fixed prompt, as in JAX
                self._session = None
                self._tags = None

    @classmethod
    def from_session(cls, session, tags, threshold: float = 0.75,
                     device="cuda"):
        """A Tagger around an existing ONNX-like session (any object with
        get_inputs() / run()), for callers that manage their own
        runtime."""
        t = cls(threshold=threshold, device=device)
        t._session = session
        t._tags = list(tags)
        return t

    @property
    def available(self) -> bool:
        return self._session is not None

    def _preprocess(self, img_bgr: np.ndarray) -> np.ndarray:
        """Pad to a white square, resize to the model's input (area when
        shrinking, cubic otherwise; cv2's uint8 values) -> float32
        [1, size, size, 3]."""
        size = self._session.get_inputs()[0].shape[1]
        h, w = img_bgr.shape[:2]
        side = max(h, w)
        canvas = torch.full((side, side, 3), 255, dtype=torch.uint8,
                            device=self.device)
        y0 = (side - h) // 2
        x0 = (side - w) // 2
        canvas[y0:y0 + h, x0:x0 + w] = torch.as_tensor(
            np.ascontiguousarray(img_bgr), device=self.device)
        out = resize_u8(canvas, (size, size),
                        "area" if side > size else "cubic")
        return out.float().cpu().numpy()[None]

    def label_cv2_bgr(self, img_bgr: np.ndarray) -> Dict[str, float]:
        """{tag: confidence} above the threshold; the model's first 4
        outputs are ratings and are skipped."""
        if not self.available:
            return {}
        inp = self._preprocess(img_bgr)
        name = self._session.get_inputs()[0].name
        probs = self._session.run(None, {name: inp})[0][0]
        out = {}
        for tag, p in zip(self._tags[4:], probs[4:]):
            if p > self.threshold:
                out[tag] = float(p)
        return out

    def build_prompt(self, img_bgr: np.ndarray, extra: str = "",
                     blacklist=()) -> str:
        """The positive prompt: prefix + tags joined with ',',
        underscores spaced."""
        tags = self.label_cv2_bgr(img_bgr)
        body = ",".join(t for t in tags if t not in set(blacklist))
        body = body.replace("_", " ")
        return PROMPT_PREFIX + (extra + "," if extra else "") + body
