"""Port parity: ``pipelines/tagger.py`` against the JAX module on the CPU —
the prompt from a stub ONNX session's tags, the preprocessing (white
square pad, then cv2's area / cubic resize; the port's within 1 LSB), and
the tagger without a runtime."""

import numpy as np
import pytest

from sd_animation_optical_flow_tpu.pipelines import pixel_inpaint as JPI
from sd_animation_optical_flow_tpu.pipelines import tagger as JT
from sd_animation_optical_flow_tpu_torch.pipelines import \
    pixel_inpaint as TPI
from sd_animation_optical_flow_tpu_torch.pipelines import tagger as TT

TAGS = ["general", "sensitive", "questionable", "explicit", "1girl",
        "long_hair", "smile", "blue_sky", "outdoors", "solo"]


class _Input:
    def __init__(self, size):
        self.name = "input_1:0"
        self.shape = [1, size, size, 3]


class StubSession:
    """An ONNX-like session: its input's size, and tag probabilities made
    from the mean of the image it is given (so the preprocessing reaches
    the output)."""

    def __init__(self, size):
        self.size = size
        self.seen = []

    def get_inputs(self):
        return [_Input(self.size)]

    def run(self, outputs, feeds):
        (x,) = feeds.values()
        self.seen.append(x)
        m = float(x.mean()) / 255.0
        probs = np.array([0.9, 0.1, 0.0, 0.0, 0.95, 0.8, 0.5 + m / 4,
                          0.76, 0.2, 0.74], np.float32)
        return [probs[None]]


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("size,hw", [(48, (30, 70)), (128, (30, 70)),
                                     (64, (64, 64)), (100, (200, 90))])
def test_preprocess_matches_jax(size, hw):
    """_preprocess: pad to a white square, then area (shrinking) or cubic
    (growing) to the model's input; float32 [1, size, size, 3] within 1
    LSB of JAX's (cv2's)."""
    img = _image(np.random.default_rng(sum(hw)), *hw)
    ours = TT.Tagger.from_session(StubSession(size), TAGS, device="cpu")
    theirs = JT.Tagger.from_session(StubSession(size), TAGS)
    a, b = ours._preprocess(img), theirs._preprocess(img)
    assert a.dtype == np.float32 and a.shape == b.shape == (1, size, size, 3)
    assert np.abs(a - b).max() <= 1.0


def test_build_prompt_matches_jax():
    """label_cv2_bgr and build_prompt (with extra text and a blacklist)
    equal JAX's on a stub session."""
    img = _image(np.random.default_rng(0), 40, 60)
    ours = TT.Tagger.from_session(StubSession(32), TAGS, threshold=0.75,
                                  device="cpu")
    theirs = JT.Tagger.from_session(StubSession(32), TAGS, threshold=0.75)
    assert ours.available and theirs.available
    assert ours.label_cv2_bgr(img) == theirs.label_cv2_bgr(img)
    for kw in ({}, {"extra": "watercolor"},
               {"extra": "x", "blacklist": ("long_hair",)}):
        assert ours.build_prompt(img, **kw) == theirs.build_prompt(img, **kw)
    assert ours.build_prompt(img).startswith(TT.PROMPT_PREFIX)
    assert "blue sky" in ours.build_prompt(img)


def test_tagger_without_runtime_or_model(tmp_path):
    """Without a runtime or its files the tagger is unavailable, as JAX's
    is: no tags, the bare prefix; the pipeline takes its fixed prompt and
    its negative prompt from the tagger module."""
    paths = (str(tmp_path / "model.onnx"), str(tmp_path / "tags.csv"))
    for ours, theirs in ((TT.Tagger(device="cpu"), JT.Tagger()),
                         (TT.Tagger(*paths, device="cpu"),
                          JT.Tagger(*paths))):
        assert not ours.available and not theirs.available
        img = _image(np.random.default_rng(1), 8, 8)
        assert ours.label_cv2_bgr(img) == {} == theirs.label_cv2_bgr(img)
        assert ours.build_prompt(img, "e") == theirs.build_prompt(img, "e")
    assert TT.PROMPT_PREFIX == JT.PROMPT_PREFIX
    assert TT.NEGATIVE_PROMPT == JT.NEGATIVE_PROMPT
    assert TPI.NEGATIVE_PROMPT is TT.NEGATIVE_PROMPT
    tagged = TT.Tagger.from_session(StubSession(16), TAGS, device="cpu")
    frame = _image(np.random.default_rng(2), 20, 20)
    assert TPI._prompt_for(tagged, frame, "y") == JPI._prompt_for(
        JT.Tagger.from_session(StubSession(16), TAGS), frame, "y")
