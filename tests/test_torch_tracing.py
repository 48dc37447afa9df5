"""The port's tracing: ``utils/profiling.annotate`` and the ``sdaof.*``
ranges that ``run_batched`` and the flow estimator open, on the CPU.

A tiny ``run_batched`` clip (the tiny bundles and RAFT of
``tests/test_torch_pixel.py``; 7 synthetic frames, key frames at 0 and
4, frame batch 2, the tail padded: batches [1, 2], [3, pad], [5, 6]) runs
once under a CPU ``torch.profiler`` profile and once without. Each range
comes the number of times its stage or wait runs, inside the stage that
holds it, and the clip's PNGs are byte for byte the same either way."""

import collections
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sd_animation_optical_flow_tpu_torch.pipelines import \
    pixel_inpaint as TPI
from sd_animation_optical_flow_tpu_torch.utils import profiling as TPR
from test_pipeline import _synthetic_frames
from test_torch_pixel import KW, tiny  # noqa: F401  (the fixture)

KEYS = (0, 4)

# (range, the innermost sdaof range around it) -> count in the clip
NESTING = {
    ("sdaof.pixel.key", None): 2,
    ("sdaof.pixel.flow", None): 3,
    ("sdaof.pixel.denoise", None): 2,
    ("sdaof.pixel.denoise", "sdaof.pixel.close"): 1,
    ("sdaof.pixel.finalize", None): 1,
    ("sdaof.pixel.finalize", "sdaof.pixel.close"): 2,
    ("sdaof.pixel.close", None): 1,
    ("sdaof.wait.upload", "sdaof.pixel.key"): 2,
    ("sdaof.wait.upload", "sdaof.pixel.flow"): 6,
    ("sdaof.wait.upload", "sdaof.pixel.denoise"): 3,
    ("sdaof.wait.key_readback", "sdaof.pixel.key"): 2,
    ("sdaof.wait.batch_readback", "sdaof.pixel.finalize"): 3,
    ("sdaof.wait.png", "sdaof.pixel.close"): 1,
    ("sdaof.flow.estimate", "sdaof.pixel.flow"): 3,
}
COUNTS = collections.Counter()
for (_name, _), _n in NESTING.items():
    COUNTS[_name] += _n


def _triples():
    return [(f, i in KEYS, i) for i, f in enumerate(_synthetic_frames(n=7))]


def _enclosing(ev):
    """The innermost ``sdaof.`` range around a profiler event, or None."""
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("sdaof."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.fixture(scope="module")
def clips(tiny, tmp_path_factory):  # noqa: F811
    """(the profiled clip's [(range, innermost sdaof range)], its output
    directory, the unprofiled clip's directory)."""
    _, (tsd, tsd9, test) = tiny
    cfg = TPI.PixelInpaintConfig(frame_batch=2, pad_tail_batch=True, **KW)
    tmp = tmp_path_factory.mktemp("tracing")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = TPI.run_batched(iter(_triples()), str(tmp / "traced"), tsd,
                                 tsd9, test, cfg=cfg)
    spans = [(e.name, _enclosing(e)) for e in prof.events()
             if e.name.startswith("sdaof.")]
    plain = TPI.run_batched(iter(_triples()), str(tmp / "plain"), tsd, tsd9,
                            test, cfg=cfg)
    return spans, traced, plain


def test_annotate_without_a_profile_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    a, b = TPI.annotate("sdaof.x"), TPR.annotate("sdaof.y")
    assert a is b is TPR.NULL_SPAN
    with a:
        with b:
            pass


def test_annotate_under_a_profile_records_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = TPR.annotate("sdaof.test")
        assert span is not TPR.NULL_SPAN
        with span:
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("sdaof.test") == 1


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_run_batched_range_count(clips, name):
    spans, _, _ = clips
    assert sum(n == name for n, _ in spans) == COUNTS[name]


def test_run_batched_ranges_nest_by_stage(clips):
    spans, _, _ = clips
    assert collections.Counter(spans) == collections.Counter(NESTING)


def test_run_batched_pngs_equal_with_and_without_a_profile(clips):
    _, traced, plain = clips
    names = sorted(os.listdir(plain))
    assert sorted(os.listdir(traced)) == names and len(names) == 21
    for name in names:
        with open(os.path.join(traced, name), "rb") as f, \
                open(os.path.join(plain, name), "rb") as g:
            assert f.read() == g.read(), name
