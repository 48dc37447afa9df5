"""Port parity: the keyframe pipeline's parts — ``FrameIndices``,
``VideoWorkspace`` (frames, the K/V store, the frame pipe) and its
on-disk contract in both directions, ``FlowCache``, ``keyframe_conv``,
``expand_mask``, ``greedy_warp_merge``, ``_warp_merge_morph`` and
``fused_flow_warp_merge`` — against the JAX
``pipelines/keyframe_inpaint.py`` on the CPU; the port's ``FramePipe``;
and the pipeline's modules with cv2 and JAX made unimportable.

Exact: ``FrameIndices``, ``keyframe_conv``'s choices (both fed the same
flow fields), ``expand_mask`` (on frames whose |Laplacian| reaches past
255, where the uint8 cast wraps), and ``greedy_warp_merge`` /
``_warp_merge_morph`` on the same flow fields (half-pixel flows, whose
cubic warps are exact in f32 in any summation order), padded duplicate
references included. The ``FlowCache`` matrices of the tiny random RAFT
(2 iterations, 2 levels, radius 2) agree within one f16 step (1e-6 px
next to 0, where the f16 steps are finer than the f32 fields'
agreement); the fused
prep with that RAFT meets the JAX test's bars against JAX's (merged
within 4 LSB on >= 99% of pixels, covered >= 99% equal)."""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import flowconf as JFC
from sd_animation_optical_flow_tpu.models import raft as JR
from sd_animation_optical_flow_tpu.models.layers import numpy_init
from sd_animation_optical_flow_tpu.pipelines import keyframe_inpaint as JKI
from sd_animation_optical_flow_tpu_torch.models import flowconf as TFC
from sd_animation_optical_flow_tpu_torch.models import raft as TR
from sd_animation_optical_flow_tpu_torch.native import framepipe as TFP
from sd_animation_optical_flow_tpu_torch.pipelines import \
    keyframe_inpaint as TKI
from test_pipeline import _synthetic_frames
from torch_port_common import to_port

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def raft_pair():
    """The tiny random RAFT (fb confidence) in both frameworks."""
    rcfg = JR.RAFTConfig(iters=2, corr_levels=2, corr_radius=2)
    with numpy_init():
        rp = JR.raft_init(jax.random.PRNGKey(11), rcfg)
    jest = JFC.FlowConfidenceEstimator(rp, JFC.FlowConfidenceConfig(
        raft=rcfg))
    test = TFC.FlowConfidenceEstimator(
        to_port(rp), TFC.FlowConfidenceConfig(
            raft=TR.RAFTConfig(**rcfg.__dict__)), device="cpu")
    return jest, test


def _workspaces(tmp_path, frames, size, keep_every=1):
    """A JAX and a port workspace over the same frames."""
    jws = JKI.VideoWorkspace(str(tmp_path / "jax"), frames=frames, size=size,
                             keep_every=keep_every)
    tws = TKI.VideoWorkspace(str(tmp_path / "port"), frames=frames,
                             size=size, keep_every=keep_every, device="cpu")
    return jws, tws


def _wait_reads(pipe, n, timeout=20.0):
    """Wait until the pipe's read-ahead thread has read n frames."""
    deadline = time.time() + timeout
    while pipe.stats()["reads"] < n and time.time() < deadline:
        time.sleep(0.01)
    assert pipe.stats()["reads"] >= n


def _f16_step_close(a, b):
    """|a - b| within one float16 step of b's magnitude, or within 1e-6
    where b is near 0 (the f32 fields' own agreement, which the f16
    steps there are finer than)."""
    step = np.maximum(np.abs(b), 2.0 ** -14) * 2.0 ** -10
    return bool(np.all(np.abs(a - b) <= np.maximum(step * 1.0001, 1e-6)))


# ---------------------------------------------------------------------------
# index sets, workspace, frame pipe
# ---------------------------------------------------------------------------

def test_frame_indices_match_jax():
    ops = []
    for mod in (JKI, TKI):
        fi = mod.FrameIndices([5, 1, 3, 3, 9, 12])
        fi.add(7)
        fi.add(mod.FrameIndices([2]))
        fi.remove(mod.FrameIndices([3, 12]))
        wins = [w.indices for w in mod.FrameIndices.from_n(23).conv_indices(
            6, 4, 2)]
        adj = [mod.FrameIndices([0, 10, 20, 30, 40]).adjacent_frames(
            q, n).indices for q in (-3, 11, 26, 44) for n in (1, 2, 3, 6)]
        ops.append((fi.indices, len(fi), list(fi), wins, adj))
    assert ops[0] == ops[1]
    assert ops[1][0] == [1, 2, 5, 7, 9] and ops[1][3][0] == [0, 2, 4]


def test_video_workspace_frames_and_resume_match_jax(tmp_path):
    """frames= at a size that needs a resize (area, cv2's pixels), every
    2nd frame kept; AI frames; resume from the extracted set."""
    frames = _synthetic_frames(6, 64, 96)
    jws, tws = _workspaces(tmp_path, frames, (48, 32), keep_every=2)
    assert tws.num_frames == jws.num_frames == 3
    assert tws.size_hw == (32, 48) and tws.fps == jws.fps
    for i in range(3):
        assert np.array_equal(tws.get_raw_frame(i), jws.get_raw_frame(i))
    with pytest.raises(IndexError):
        tws.get_raw_frame(3)
    assert tws.get_ai_frame(1) is None and not tws.generated(1)
    ai = np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8)
    tws.put_ai_frame(1, ai)
    assert tws.generated(1) and np.array_equal(tws.get_ai_frame(1), ai)
    again = TKI.VideoWorkspace(str(tmp_path / "port"), size=(48, 32),
                               device="cpu")
    assert again.num_frames == 3
    assert np.array_equal(again.get_raw_frame(2), jws.get_raw_frame(2))
    with pytest.raises(ValueError, match="frames or video_path"):
        TKI.VideoWorkspace(str(tmp_path / "empty"), device="cpu")


def test_video_workspace_reads_through_the_frame_pipe(tmp_path):
    """get_raw_frame fills raw-cache/ on a miss; later reads hit the
    pipe's read-ahead cache."""
    frames = _synthetic_frames(6, 32, 32)
    tws = TKI.VideoWorkspace(str(tmp_path / "ws"), frames=frames,
                             size=(32, 32), keep_every=1, device="cpu")
    first = [tws.get_raw_frame(i) for i in range(6)]
    pipe = tws._frame_pipe
    pipe.flush()
    assert sorted(os.listdir(tmp_path / "ws" / "raw-cache")) == \
        [f"{i:05d}.raw" for i in range(6)]
    assert pipe.stats()["writes"] == 6
    tws.get_raw_frame(0)            # moves the read-ahead window to 0
    _wait_reads(pipe, 6)
    hits = pipe.stats()["cache_hits"]
    for i in range(6):
        assert np.array_equal(tws.get_raw_frame(i), first[i])
        assert np.array_equal(first[i], frames[i])
    assert pipe.stats()["cache_hits"] == hits + 6
    tws.close()
    with pytest.raises(ValueError, match="closed"):
        tws.get_raw_frame(0)


def test_kv_store_round_trip_matches_jax(tmp_path, np_rng):
    """put_kv writes f16; get_kv gives bf16 on the workspace's device,
    equal to JAX's get_kv of the same file."""
    frames = _synthetic_frames(2, 16, 16)
    jws, tws = _workspaces(tmp_path, frames, (16, 16))
    kv = tuple((torch.from_numpy(np_rng.standard_normal((1, n, c)).astype(
        np.float32) * 3), torch.from_numpy(np_rng.standard_normal(
            (1, n, c)).astype(np.float32)))
        for n, c in ((64, 8), (16, 16), (4, 32)))
    tws.put_kv(1, kv)
    data = np.load(os.path.join(tmp_path, "port", "crossattn", "00001.npz"))
    assert sorted(data.files) == sorted(f"{a}{i}" for a in "kv"
                                        for i in range(3))
    for i, (k, v) in enumerate(kv):
        assert data[f"k{i}"].dtype == np.float16
        assert np.array_equal(data[f"k{i}"], k.numpy().astype(np.float16))
        assert np.array_equal(data[f"v{i}"], v.numpy().astype(np.float16))
    back = tws.get_kv(1)
    os.replace(os.path.join(tmp_path, "port", "crossattn", "00001.npz"),
               os.path.join(tmp_path, "jax", "crossattn", "00001.npz"))
    ref = jws.get_kv(1)
    assert tws.get_kv(1) is None
    for (k, v), (rk, rv) in zip(back, ref):
        assert k.dtype == torch.bfloat16 and k.device.type == "cpu"
        assert np.array_equal(k.float().numpy(), np.asarray(rk, np.float32))
        assert np.array_equal(v.float().numpy(), np.asarray(rv, np.float32))
    jws.remove_kv(1)
    tws.remove_kv(1)
    assert jws.get_kv(1) is None


def test_workspace_written_by_jax_resumes_in_the_port(tmp_path, raft_pair):
    """A JAX workspace (raw PNGs, flow .npy, K/V npz, AI frames, a level's
    choices) read by the port: the same frames, flow entries, K/V and
    keyframe_conv choices."""
    jest, test = raft_pair
    frames = _synthetic_frames(4, 32, 32)
    ws_dir = str(tmp_path / "ws")
    jws = JKI.VideoWorkspace(ws_dir, frames=frames, size=(32, 32),
                             keep_every=1)
    jfc = JKI.FlowCache(jest, ws_dir, batch_size=4)
    jfc.calculate_pairwise(jws, JKI.FrameIndices([0, 1, 2]))
    jws.put_ai_frame(2, frames[3])
    jws.put_kv(2, ((jnp.full((1, 8, 4), 1.5), jnp.zeros((1, 8, 4))),))
    chosen = JKI.keyframe_conv(jfc, os.path.join(ws_dir, "d01"), jws,
                               JKI.FrameIndices(range(4)), 2, 2, 1)

    tws = TKI.VideoWorkspace(ws_dir, size=(32, 32), device="cpu")
    assert tws.num_frames == 4
    for i in range(4):
        assert np.array_equal(tws.get_raw_frame(i), frames[i])
    assert np.array_equal(tws.get_ai_frame(2), frames[3])
    kv = tws.get_kv(2)
    assert kv[0][0].dtype == torch.bfloat16 and float(kv[0][0][0, 0, 0]) \
        == 1.5
    tfc = TKI.FlowCache(test, ws_dir, batch_size=4)
    assert tfc.cached_pair == jfc.cached_pair and len(tfc.cached_pair) == 8
    assert np.array_equal(tfc.calculate_pairwise(tws, TKI.FrameIndices(
        [0, 1, 2])), jfc.calculate_pairwise(jws, JKI.FrameIndices([0, 1,
                                                                  2])))
    again = TKI.keyframe_conv(tfc, os.path.join(ws_dir, "d01"), tws,
                              TKI.FrameIndices(range(4)), 2, 2, 1)
    assert again.indices == chosen.indices


def test_workspace_written_by_the_port_resumes_in_jax(tmp_path, raft_pair):
    """The reverse: a port workspace read by the JAX package."""
    jest, test = raft_pair
    frames = _synthetic_frames(4, 32, 32)
    ws_dir = str(tmp_path / "ws")
    tws = TKI.VideoWorkspace(ws_dir, frames=frames, size=(32, 32),
                             keep_every=1, device="cpu")
    tfc = TKI.FlowCache(test, ws_dir, batch_size=4)
    mat = tfc.calculate_multiple_to_one(tws, TKI.FrameIndices([0, 1, 3]), 2)
    tws.put_ai_frame(1, frames[0])
    tws.put_kv(1, ((torch.full((1, 8, 4), -2.25), torch.ones((1, 8, 4))),))

    jws = JKI.VideoWorkspace(ws_dir, size=(32, 32))
    assert jws.num_frames == 4
    for i in range(4):
        assert np.array_equal(jws.get_raw_frame(i), frames[i])
    assert np.array_equal(jws.get_ai_frame(1), frames[0])
    kv = jws.get_kv(1)
    assert np.asarray(kv[0][0], np.float32)[0, 0, 0] == -2.25
    jfc = JKI.FlowCache(jest, ws_dir, batch_size=4)
    assert jfc.cached_pair == {(0, 2), (1, 2), (3, 2)}
    assert np.array_equal(jfc.calculate_multiple_to_one(
        jws, JKI.FrameIndices([0, 1, 3]), 2), mat)


def test_frame_pipe_round_trip_and_prefetch(tmp_path):
    """The port's FramePipe: built into build/native/ (named by the
    source's hash), frames put then read back after a flush, each window
    of a sequential scan served from the read-ahead cache, and a missing
    frame raises."""
    assert TFP.build() == TFP.library_path()
    assert TFP.library_path().parent == REPO / "build" / "native"
    shape = (16, 16, 3)
    n = 32
    with TFP.FramePipe(str(tmp_path / "frames"), n, shape, prefetch=8) as fp:
        frames = [np.full(shape, i, np.uint8) for i in range(n)]
        for i, f in enumerate(frames):
            fp.put(i, f)
        fp.flush()
        assert fp.stats()["writes"] == n
        out = []
        for start in range(0, n, 8):
            fp.get(start)           # moves the read-ahead window
            _wait_reads(fp, start + 8)
            hits = fp.stats()["cache_hits"]
            out += [int(fp.get(i)[0, 0, 0]) for i in range(start, start + 8)]
            assert fp.stats()["cache_hits"] == hits + 8
        assert out == list(range(n))
        with pytest.raises(ValueError, match="pipe of"):
            fp.put(0, np.zeros((4, 4, 3), np.uint8))
    with TFP.FramePipe(str(tmp_path / "none"), 3, (4, 4, 3)) as fp:
        with pytest.raises(FileNotFoundError):
            fp.get(1)
    with pytest.raises(ValueError, match="closed"):
        fp.get(0)


def test_frame_pipe_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ cannot compile raises with the compiler's output."""
    bad = tmp_path / "frameloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TFP, "SRC", bad)
    monkeypatch.setattr(TFP, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TFP.build()


def test_keyframe_modules_run_without_cv2(tmp_path):
    """keyframe_inpaint, ofgen and the frame pipe import and run in a
    fresh interpreter with cv2, JAX and the JAX package made
    unimportable: a workspace from frames= at a size that needs a
    resize, expand_mask and a FramePipe round trip."""
    code = (
        "import sys\n"
        "for n in ('cv2', 'jax', 'jaxlib', 'sd_animation_optical_flow_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import numpy as np, torch\n"
        "from sd_animation_optical_flow_tpu_torch.pipelines import "
        "keyframe_inpaint as K, ofgen\n"
        "from sd_animation_optical_flow_tpu_torch.native.framepipe import "
        "FramePipe\n"
        "frames = np.random.default_rng(0).integers(0, 256, (3, 32, 48, 3), "
        "dtype=np.uint8)\n"
        f"ws = K.VideoWorkspace({str(tmp_path / 'ws')!r}, frames=frames, "
        "size=(24, 16), keep_every=1, device='cpu')\n"
        "f = ws.get_raw_frame(2)\n"
        "assert f.shape == (16, 24, 3)\n"
        "m = K.expand_mask(np.zeros((16, 24), np.uint8), f, device='cpu')\n"
        "assert m.dtype == torch.uint8 and m.shape == (16, 24)\n"
        f"with FramePipe({str(tmp_path / 'fp')!r}, 2, (4, 4, 3)) as p:\n"
        "    p.put(1, np.full((4, 4, 3), 7, np.uint8))\n"
        "    p.flush()\n"
        "    assert (p.get(1) == 7).all()\n"
        "assert ofgen.unsharp_ofgen(f, device='cpu').shape == f.shape\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# flow cache and keyframe_conv
# ---------------------------------------------------------------------------

def test_flow_cache_matrices_match_jax(tmp_path, raft_pair):
    """Pairwise (bidir, one RAFT batch per unordered pair) and
    multiple-to-one (one way) matrices of the tiny RAFT: within one f16
    step of JAX's; the diagonal is zero flow at confidence 1."""
    jest, test = raft_pair
    frames = _synthetic_frames(4, 32, 32)
    jws, tws = _workspaces(tmp_path, frames, (32, 32))
    calls = []

    class Counting:
        device = test.device

        def calc_batch_bidir_f16(self, src, tgt):
            calls.append(len(src))
            return test.calc_batch_bidir_f16(src, tgt)

    jfc = JKI.FlowCache(jest, str(tmp_path / "jax"), batch_size=4)
    tfc = TKI.FlowCache(Counting(), str(tmp_path / "port"), batch_size=4)
    idx = [0, 1, 3]
    jm = jfc.calculate_pairwise(jws, JKI.FrameIndices(idx))
    tm = tfc.calculate_pairwise(tws, TKI.FrameIndices(idx))
    assert calls == [3] and len(tfc.cached_pair) == 6
    assert tm.shape == (3, 3, 32, 32, 3) and _f16_step_close(tm, jm)
    assert (tm[1, 1, ..., :2] == 0).all() and (tm[1, 1, ..., 2] == 1).all()
    assert 0.0 < (tm[..., 2] > 0.5).mean() < 1.0
    jfc2 = JKI.FlowCache(jest, str(tmp_path / "jax"), batch_size=2)
    tfc2 = TKI.FlowCache(test, str(tmp_path / "port"), batch_size=2)
    jfc2.purge()
    tfc2.purge()
    jmo = jfc2.calculate_multiple_to_one(jws, JKI.FrameIndices([0, 2, 3]), 1)
    tmo = tfc2.calculate_multiple_to_one(tws, TKI.FrameIndices([0, 2, 3]), 1)
    assert tmo.shape == (3, 1, 32, 32, 3) and _f16_step_close(tmo, jmo)
    assert tfc2.cached_pair == {(0, 1), (2, 1), (3, 1)}
    tfc2.purge()
    assert not tfc2.cached_pair and not os.listdir(tmp_path / "port" / "flow")


def test_flow_cache_halves_its_batch_only_on_out_of_memory(tmp_path):
    """An estimator that runs out of device memory above one pair: the
    cache retries at half the batch down to 1 pair and fills; any other
    error propagates at once."""
    frames = _synthetic_frames(3, 16, 16)
    tws = TKI.VideoWorkspace(str(tmp_path / "ws"), frames=frames,
                             size=(16, 16), keep_every=1, device="cpu")
    sizes = []

    class Tight:
        def calc_batch_f16(self, src, tgt):
            sizes.append(len(src))
            if len(src) > 1:
                raise torch.cuda.OutOfMemoryError("out of memory")
            z = np.zeros(src.shape[:3], np.float16)
            return np.stack([z, z], -1), z + 1

    fc = TKI.FlowCache(Tight(), str(tmp_path / "ws"), batch_size=4)
    fc.calculate_multiple_to_one(tws, TKI.FrameIndices([0, 2]), 1)
    assert sizes == [2, 1, 1] and fc.batch_size == 1
    assert fc.cached_pair == {(0, 1), (2, 1)}

    class Broken:
        def calc_batch_f16(self, src, tgt):
            sizes.append(len(src))
            raise RuntimeError("kernel launch failed")

    sizes.clear()
    fc = TKI.FlowCache(Broken(), str(tmp_path / "ws2"), batch_size=4)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fc.calculate_multiple_to_one(tws, TKI.FrameIndices([0, 2]), 1)
    assert sizes == [2] and fc.batch_size == 4


class _SceneFlow:
    """A deterministic stand-in estimator (numpy in, f16 numpy out) whose
    confidence depends on both frames' content, so keyframe_conv has
    distinct totals to choose from; both packages' caches call it."""

    def calc_batch_bidir_f16(self, src, tgt):
        s = src.astype(np.float32) / 255.0
        t = tgt.astype(np.float32) / 255.0
        conf_st = np.exp(-4.0 * np.abs(s - t).mean(-1))
        conf_ts = np.exp(-3.0 * np.abs(t - s).max(-1))
        flow = np.stack([s[..., 0] - t[..., 1], t[..., 2]], -1)
        return (flow.astype(np.float16), conf_st.astype(np.float16),
                (-flow).astype(np.float16), conf_ts.astype(np.float16))


@pytest.mark.parametrize("kernel,stride,dilation", [(3, 3, 1), (4, 2, 2),
                                                    (6, 6, 1)])
def test_keyframe_conv_choices_match_jax(tmp_path, kernel, stride,
                                         dilation):
    frames = np.random.default_rng(kernel).integers(0, 256, (9, 16, 16, 3),
                                                    dtype=np.uint8)
    jws, tws = _workspaces(tmp_path, frames, (16, 16))
    jfc = JKI.FlowCache(_SceneFlow(), str(tmp_path / "jax"))
    tfc = TKI.FlowCache(_SceneFlow(), str(tmp_path / "port"))
    got = TKI.keyframe_conv(tfc, str(tmp_path / "port" / "d01"), tws,
                            TKI.FrameIndices(range(9)), kernel, stride,
                            dilation)
    want = JKI.keyframe_conv(jfc, str(tmp_path / "jax" / "d01"), jws,
                             JKI.FrameIndices(range(9)), kernel, stride,
                             dilation)
    assert got.indices == want.indices and len(got) >= 2
    assert sorted(os.listdir(tmp_path / "port" / "d01")) == \
        sorted(os.listdir(tmp_path / "jax" / "d01"))
    for f in got:
        assert np.array_equal(TKI.read_png_bgr(str(
            tmp_path / "port" / "d01" / f"{f:05d}.png")), frames[f])
    # resumed from the level's directory
    assert TKI.keyframe_conv(tfc, str(tmp_path / "port" / "d01"), tws,
                             TKI.FrameIndices(range(9)), 1, 1,
                             1).indices == got.indices


# ---------------------------------------------------------------------------
# masks and the merge
# ---------------------------------------------------------------------------

def _edgy_frame(rng, h, w):
    """A smooth gradient with a few hard-edged blocks and isolated
    saturated pixels: |Laplacian| from 0 to past 255, edges on part of
    the frame only."""
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 3) % 256, (yy * 2 + xx) % 256,
                    np.full((h, w), 120)], -1).astype(np.int32)
    for _ in range(3):
        y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
        img[y:y + 5, x:x + 5] = rng.integers(0, 256, 3)
    ys, xs = rng.integers(1, h - 1, 6), rng.integers(1, w - 1, 6)
    img[ys, xs] = 255
    img[ys[:3], xs[:3] + 1 - 2 * (xs[:3] > w // 2)] = 0
    return img.astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_mask_matches_jax(seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    img = _edgy_frame(rng, 40, 56)
    lap = np.absolute(cv2.Laplacian(img, cv2.CV_64F))
    assert lap.max() >= 256                  # the uint8 cast wraps
    mask = np.zeros((40, 56), np.uint8)
    mask[5:12, 30:44] = 255
    want = JKI.expand_mask(mask, img)
    got = TKI.expand_mask(mask, img, device="cpu")
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert 0.1 < (want > 0).mean() < 0.9
    # tensors in: computed on the mask's device
    got_t = TKI.expand_mask(torch.from_numpy(mask), torch.from_numpy(img))
    assert np.array_equal(got_t.numpy(), want)


def _merge_case(rng, n, h=24, w=32):
    """n references: AI frames, half-pixel flows reaching past the border,
    confidences around the threshold (reference 1's field left empty
    above the middle)."""
    ai = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    flow = (rng.integers(-12, 13, (n, h, w, 2)) / 2.0).astype(np.float32)
    conf = rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32)
    if n > 1:
        conf[1, : h // 2] = 0.1
    tgt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return ai, flow, conf, tgt


@pytest.mark.parametrize("expand", ["dilate", "none"])
@pytest.mark.parametrize("n,pad", [(1, 0), (3, 0), (2, 2)])
def test_greedy_merge_and_morph_match_jax(tmp_path, expand, n, pad):
    """greedy_warp_merge (host) and _warp_merge_morph (device) of the port
    equal JAX's and each other on the same flow fields; padded duplicate
    references change nothing."""
    rng = np.random.default_rng(10 * n + pad)
    ai, flow, conf, tgt = _merge_case(rng, n)
    frames = np.stack([tgt] * (n + 1))
    jws, tws = _workspaces(tmp_path, frames, (32, 24))
    refs = list(range(1, n + 1))
    for r in refs:
        jws.put_ai_frame(r, ai[r - 1])
        tws.put_ai_frame(r, ai[r - 1])
    flow_mat = np.concatenate([flow, conf[..., None]], -1)[:, None]
    jm, jc = JKI.greedy_warp_merge(jws, JKI.FrameIndices(refs), flow_mat,
                                   thres=0.5)
    tm, tc = TKI.greedy_warp_merge(tws, TKI.FrameIndices(refs), flow_mat,
                                   thres=0.5)
    assert np.array_equal(tm, jm) and np.array_equal(tc, jc)
    assert 0 < (tc > 0).mean() < 1

    pad_to = lambda a: np.concatenate([a] + [a[-1:]] * pad, 0)
    args = [pad_to(flow), pad_to(conf), pad_to(ai)]
    want = JKI._warp_merge_morph(*(jnp.asarray(a) for a in args),
                                 jnp.asarray(tgt), thres=0.5, expand=expand)
    got = TKI._warp_merge_morph(*(torch.from_numpy(a) for a in args),
                                torch.from_numpy(tgt), thres=0.5,
                                expand=expand)
    for name, g, wv in zip(("merged", "covered", "mask2"), got, want):
        assert g.dtype == torch.uint8, name
        assert np.array_equal(g.numpy(), np.asarray(wv)), name
    assert np.array_equal(got[0].numpy(), tm)
    assert np.array_equal(got[1].numpy(), tc)
    for g, wv in zip(got[3:], want[3:]):
        assert np.abs(g.numpy() - np.asarray(wv)).max() < 1e-6
    if expand == "none":
        assert np.array_equal(got[2].numpy(), 255 - tc)
    with pytest.raises(ValueError, match="expand"):
        TKI._warp_merge_morph(*(torch.from_numpy(a) for a in args),
                              torch.from_numpy(tgt), thres=0.5,
                              expand="edges")


def test_fused_prep_matches_jax(tmp_path, raft_pair):
    """fused_flow_warp_merge with the tiny RAFT against JAX's, two
    references padded to 3: merged within 4 LSB on >= 99% of pixels and
    covered >= 99% equal (the JAX test's bars against its host path);
    expand 'none' returns the raw uncovered mask."""
    jest, test = raft_pair
    rng = np.random.default_rng(3)
    frames = np.ascontiguousarray(rng.integers(0, 255, (3, 40, 48, 3),
                                               np.uint8))
    jws, tws = _workspaces(tmp_path, frames, (48, 40))
    for ws in (jws, tws):
        for r in (0, 2):
            ws.put_ai_frame(r, frames[2 - r])
    for expand in ("dilate", "none"):
        want = JKI.fused_flow_warp_merge(jest, jws, [0, 2], 1, thres=0.5,
                                         expand=expand, n_pad=3)
        got = TKI.fused_flow_warp_merge(test, tws, [0, 2], 1, thres=0.5,
                                        expand=expand, n_pad=3)
        diff = np.abs(got[0].numpy().astype(np.int16)
                      - np.asarray(want[0]).astype(np.int16))
        assert np.mean(diff <= 4) > 0.99, np.mean(diff <= 4)
        assert np.mean(got[1].numpy() == np.asarray(want[1])) > 0.99
        assert np.mean(got[2].numpy() == np.asarray(want[2])) > 0.99
        assert 0 < (got[1].numpy() > 0).mean() < 1
        assert np.abs(got[4].numpy() - np.asarray(want[4])).max() < 1e-6
    assert np.array_equal(got[2].numpy(), 255 - got[1].numpy())
    with pytest.raises(ValueError, match="not generated"):
        TKI.fused_flow_warp_merge(test, tws, [1], 2, thres=0.5,
                                  expand="none")
