"""Hierarchical keyframe pipeline (the reference's third orchestrator), on
torch tensors.

Counterpart of ``sd_animation_optical_flow_tpu/pipelines/keyframe_inpaint.py``:

* ``VideoWorkspace``: the resumable on-disk workspace (``raw-frames/``,
  ``ai-frames/``, ``flow/``, ``crossattn/`` K/V stores, ``seed/``,
  ``raw-cache/``), the same files as the JAX workspace's, so either
  package resumes the other's. Raw frames are read through the native
  frame pipe (``native/framepipe.py``); PNGs are written and read without
  cv2, which only the ``video_path=`` branch imports.
* ``FrameIndices``: sorted index sets, sliding ``conv_indices`` windows
  and nearest-reference ``adjacent_frames``.
* ``FlowCache``: batched pairwise flow + confidence with an f16 ``.npy``
  cache; ``keyframe_conv`` keeps the best-connected frame of each window.
* The four generation modes: the warp + greedy merge + inpaint
  (``warp_and_inpaint``), the same with the references' K/V injected
  (``warp_and_inpaint_crossattn``, the canonical mode), the
  [target | references] strip (``self_attn``) and both (``both``); the
  seed frames as one 'mutual' strip.
* ``run``: shrink the clip with ``keyframe_conv`` level by level down to
  the seed frames, seed them, then back-fill each level from the nearest
  generated frames, serially (the reference's loop) or ``level_batch``
  frames a call (``_backfill_level_batched``).

The per-frame back-fill prep (``_fused_prep_impl``: RAFT flow and
confidence of every reference, the cubic warp of their AI frames, the
greedy merge and the mask morphology) runs on the flow estimator's device
and hands the merged frame, its model-space image and the mask to the
inpaint there. One deliberate difference from JAX: ``FlowCache`` halves
its batch and retries only on ``torch.cuda.OutOfMemoryError``, and
re-raises anything else.
"""

from __future__ import annotations

import gc
import glob
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.controlnet import ControlSpec, canny_hint, hed_hint
from ..models.flowconf import _flow_conf_batch
from ..models.raft import pad_to_multiple
from ..models.unet import StripConfig
from ..ops.filters import (bgr_to_gray_u8, dilate, ellipse_kernel,
                           laplacian_abs_u8)
from ..ops.resize import resize_u8
from ..ops.warp import warp_frame
from ..utils.images import (bgr_u8_to_model, model_to_bgr_u8,
                            queue_host_copies, read_png_bgr, write_png)
from . import facades as F
from .keyframes import EdgeDetector, mean_pixel_distance
from .tagger import NEGATIVE_PROMPT, Tagger

log = logging.getLogger(__name__)


def _tensor(img, device):
    """An array (numpy or tensor) as a tensor on ``device``."""
    if torch.is_tensor(img):
        return img.to(device)
    return torch.as_tensor(np.ascontiguousarray(img), device=device)


def _to_model(img_bgr_u8):
    """Device BGR uint8 [..., H, W, 3] -> RGB float32 in [-1, 1]."""
    return img_bgr_u8.flip(-1).float() / 127.5 - 1.0


# ---------------------------------------------------------------------------
# workspace
# ---------------------------------------------------------------------------

class VideoWorkspace:
    """Resumable on-disk workspace. ``frames`` (BGR uint8, every
    ``keep_every``-th kept) or ``video_path`` (decoded by cv2) fill
    ``raw-frames/`` at ``size`` (width, height; resized as cv2's
    INTER_AREA); with neither, an extracted workspace is resumed.
    ``device``: where K/V stores load (``get_kv``), frames resize and
    the key-frame detector runs."""

    def __init__(self, workspace_dir: str, frames=None,
                 video_path: Optional[str] = None,
                 size: Tuple[int, int] = (512, 768), keep_every: int = 3,
                 max_len_sec: int = -1, fps: float = 30.0, device="cuda"):
        self.workspace_dir = workspace_dir
        self.size = size
        self.device = torch.device(device)
        for sub in ("raw-frames", "ai-frames", "flow", "crossattn", "seed"):
            os.makedirs(os.path.join(workspace_dir, sub), exist_ok=True)
        self.fps = fps / keep_every

        existing = sorted(glob.glob(
            os.path.join(workspace_dir, "raw-frames", "*.png")))
        if existing and frames is None and video_path is None:
            self.num_frames = len(existing)
            return

        if video_path is not None:
            import cv2
            video = cv2.VideoCapture(video_path)
            self.fps = (video.get(cv2.CAP_PROP_FPS) or 30.0) / keep_every
            target = 1e18 if max_len_sec == -1 else self.fps * max_len_sec
            ctr, valid = -1, -1
            while True:
                ctr += 1
                ret, frame = video.read()
                if not ret:
                    break
                if ctr % keep_every != 0:
                    continue
                valid += 1
                if not os.path.exists(self._raw(valid)):
                    write_png(self._raw(valid), self._fit(frame))
                if valid >= target:
                    break
            video.release()
            self.num_frames = valid + 1
        elif frames is not None:
            kept = frames[::keep_every]
            for i, frame in enumerate(kept):
                write_png(self._raw(i), self._fit(frame))
            self.num_frames = len(kept)
        else:
            raise ValueError(f"{workspace_dir} holds no extracted frames: "
                             "give frames or video_path")

    def _fit(self, frame):
        """The frame at ``size``, area-resized where it differs."""
        if tuple(frame.shape[1::-1]) == tuple(self.size):
            return frame
        return resize_u8(_tensor(frame, self.device),
                         (self.size[1], self.size[0]), "area").cpu().numpy()

    @property
    def size_hw(self):
        return (self.size[1], self.size[0])

    def _raw(self, n):
        return os.path.join(self.workspace_dir, "raw-frames", f"{n:05d}.png")

    def _ai(self, n):
        return os.path.join(self.workspace_dir, "ai-frames", f"{n:05d}.png")

    @property
    def _frame_pipe(self):
        """The native decoded-frame cache (``native/frameloader.cpp``): raw
        uint8 blobs behind a read-ahead and a write-behind thread, so
        repeated raw-frame reads (the key-frame scan, flow pairs, each
        level's back-fill) skip the PNG decode. PNGs stay the resumable
        contract; the blobs fill lazily on a miss."""
        if not hasattr(self, "_pipe"):
            from ..native.framepipe import FramePipe
            self._pipe = FramePipe(
                os.path.join(self.workspace_dir, "raw-cache"),
                self.num_frames, self.size_hw + (3,))
        return self._pipe

    def close(self):
        """Stop the frame pipe's threads (its queued writes drain first)."""
        if hasattr(self, "_pipe"):
            self._pipe.close()

    def get_raw_frame(self, n):
        if not 0 <= n < self.num_frames:
            raise IndexError(f"frame {n} of {self.num_frames}")
        pipe = self._frame_pipe
        try:
            return pipe.get(n)
        except FileNotFoundError:
            frame = read_png_bgr(self._raw(n))
            if frame.shape == pipe.shape:
                pipe.put(n, frame)
            return frame

    def get_ai_frame(self, n):
        return read_png_bgr(self._ai(n)) if os.path.exists(self._ai(n)) \
            else None

    def generated(self, n) -> bool:
        return os.path.exists(self._ai(n))

    def put_ai_frame(self, n, frame):
        write_png(self._ai(n), frame)

    # K/V store: f16 npz of the (k, v) tuple, keys k{i} / v{i}
    def _kv(self, n):
        return os.path.join(self.workspace_dir, "crossattn", f"{n:05d}.npz")

    def put_kv(self, n, kv_hist):
        """Store a kv_hist as f16: cast on its device, then one queued
        device -> host copy of the whole tree and one wait."""
        flat = [t.to(torch.float16) for kv in kv_hist for t in kv]
        hosts, ready = queue_host_copies(flat)
        if ready is not None:
            ready.synchronize()
        arrays = {}
        for i in range(len(kv_hist)):
            arrays[f"k{i}"] = hosts[2 * i].numpy()
            arrays[f"v{i}"] = hosts[2 * i + 1].numpy()
        np.savez(self._kv(n), **arrays)

    def get_kv(self, n):
        """The stored kv_hist as bf16 on ``device`` (the UNet attends in
        bf16), or None."""
        if not os.path.exists(self._kv(n)):
            return None
        data = np.load(self._kv(n))
        load = lambda a: torch.from_numpy(a).to(self.device).to(
            torch.bfloat16)
        return tuple((load(data[f"k{i}"]), load(data[f"v{i}"]))
                     for i in range(len(data.files) // 2))

    def remove_kv(self, n):
        if os.path.exists(self._kv(n)):
            os.remove(self._kv(n))

    def key_frames(self, th: float = 48.0, max_gap: int = 300):
        """Level-0 key-frame scan over the extracted frames: yields
        (frame, index) of each key frame."""
        detector = EdgeDetector(self.device)
        key_edges = None
        gap = 0
        for i in range(self.num_frames):
            gap += 1
            frame = self.get_raw_frame(i)
            if key_edges is None:
                key_edges = detector(frame)
                yield frame, i
                continue
            edges = detector(frame)
            if th * (max_gap - gap) / max_gap < mean_pixel_distance(
                    edges, key_edges):
                key_edges = edges
                gap = 0
                yield frame, i


# ---------------------------------------------------------------------------
# frame index sets
# ---------------------------------------------------------------------------

class FrameIndices:
    """Sorted frame index set."""

    def __init__(self, indices=()):
        self.indices: List[int] = sorted(set(int(i) for i in indices))

    @staticmethod
    def from_n(n: int) -> "FrameIndices":
        return FrameIndices(range(n))

    def conv_indices(self, kernel_size: int = 17, stride: int = 8,
                     dilation: int = 1):
        idx = 0
        while idx < len(self.indices):
            window = self.indices[idx: idx + kernel_size]
            yield FrameIndices(window[::dilation])
            idx += stride

    def remove(self, other: "FrameIndices"):
        self.indices = sorted(set(self.indices) - set(other.indices))

    def add(self, other):
        extra = {other} if isinstance(other, int) else set(other.indices)
        self.indices = sorted(set(self.indices) | extra)

    def adjacent_frames(self, idx: int, n: int) -> "FrameIndices":
        """The n-window of indices with minimal total distance to idx."""
        if len(self) <= n:
            return self
        best, best_dist = None, None
        for i in range(0, len(self) - n):
            cand = self.indices[i: i + n]
            dist = int(np.sum(np.abs(np.asarray(cand) - idx)))
            if best_dist is None or dist < best_dist:
                best, best_dist = cand, dist
        return FrameIndices(best)

    def __len__(self):
        return len(self.indices)

    def __iter__(self):
        return iter(self.indices)


# ---------------------------------------------------------------------------
# flow cache
# ---------------------------------------------------------------------------

class FlowCache:
    """Batched pairwise flow + confidence with an ``.npy`` cache. Entry per
    (s, t): f16 [H, W, 3] = (flow_x, flow_y, confidence) in the target
    frame t's coordinates."""

    def __init__(self, estimator, workspace_dir: str, batch_size: int = 8):
        self.estimator = estimator
        self.batch_size = batch_size
        self.pair_dir = os.path.join(workspace_dir, "flow")
        os.makedirs(self.pair_dir, exist_ok=True)
        self.cached_pair = set()
        for f in glob.glob(os.path.join(self.pair_dir, "*.npy")):
            s, t = os.path.basename(f).split(".")[0].split("-")
            self.cached_pair.add((int(s), int(t)))

    def purge(self):
        self.cached_pair = set()
        for f in glob.glob(os.path.join(self.pair_dir, "*.npy")):
            os.remove(f)

    def _path(self, s, t):
        return os.path.join(self.pair_dir, f"{s:05d}-{t:05d}.npy")

    def _load(self, s, t):
        return np.load(self._path(s, t)).astype(np.float32)

    def _compute_pairs(self, video: VideoWorkspace, pairs,
                       store_reverse: bool = True):
        # fb confidence runs RAFT both ways a pair, so one batch yields
        # (s, t) and (t, s) (calc_batch_bidir_f16): the pairwise phase
        # dedupes to unordered pairs and stores both entries. The
        # multiple-to-one phase (store_reverse False) reads only (s,
        # target) and leaves the reverse fields on the device.
        bidir = store_reverse and hasattr(self.estimator,
                                          "calc_batch_bidir_f16")
        if bidir:
            seen, canon = set(), []
            for s, t in pairs:
                key = (min(s, t), max(s, t))
                if key in seen:
                    continue
                seen.add(key)
                canon.append((s, t))
            pairs = canon
        start = 0
        while start < len(pairs):
            batch = pairs[start: start + self.batch_size]
            src = np.stack([video.get_raw_frame(s)[..., ::-1]
                            for s, _ in batch])
            tgt = np.stack([video.get_raw_frame(t)[..., ::-1]
                            for _, t in batch])
            # uint8 stacks go up (the estimator casts on the device);
            # the fields come back as f16
            try:
                if bidir:
                    flow, conf, rflow, rconf = \
                        self.estimator.calc_batch_bidir_f16(src, tgt)
                elif hasattr(self.estimator, "calc_batch_f16"):
                    flow, conf = self.estimator.calc_batch_f16(src, tgt)
                else:
                    flow, conf, _ = self.estimator.calc_batch(src, tgt)
            except torch.cuda.OutOfMemoryError:
                # a batch of RAFT pairs holds 2B images' correlation
                # volumes: halve it and retry; any other error is raised
                if len(batch) == 1:
                    raise
                self.batch_size = max(1, len(batch) // 2)
                log.warning("flow batch of %d pairs ran out of device "
                            "memory; retrying at %d", len(batch),
                            self.batch_size)
                gc.collect()
                torch.cuda.empty_cache()
                continue
            start += len(batch)
            for i, (s, t) in enumerate(batch):
                entry = np.concatenate([flow[i], conf[i][..., None]],
                                       axis=-1, dtype=np.float16)
                np.save(self._path(s, t), entry)
                self.cached_pair.add((s, t))
                if bidir:
                    rentry = np.concatenate([rflow[i], rconf[i][..., None]],
                                            axis=-1, dtype=np.float16)
                    np.save(self._path(t, s), rentry)
                    self.cached_pair.add((t, s))

    def calculate_single(self, video, s, t) -> np.ndarray:
        if s == t:
            e = np.zeros((*video.size_hw, 3), np.float32)
            e[..., 2] = 1.0
            return e
        if (s, t) not in self.cached_pair:
            self._compute_pairs(video, [(s, t)])
        return self._load(s, t)

    def calculate_multiple_to_one(self, video, source_indices: FrameIndices,
                                  target_index: int) -> np.ndarray:
        """-> [N_source, 1, H, W, 3]."""
        todo = [(s, target_index) for s in source_indices
                if s != target_index and (s, target_index) not in
                self.cached_pair]
        if todo:
            self._compute_pairs(video, todo, store_reverse=False)
        n = len(source_indices)
        ret = np.zeros((n, 1, *video.size_hw, 3), np.float32)
        for i, s in enumerate(source_indices):
            ret[i, 0] = self.calculate_single(video, s, target_index)
        return ret

    def calculate_pairwise(self, video, indices: FrameIndices) -> np.ndarray:
        """-> [N, N, H, W, 3]."""
        todo = [(s, t) for s in indices for t in indices
                if s != t and (s, t) not in self.cached_pair]
        if todo:
            self._compute_pairs(video, todo)
        n = len(indices)
        ret = np.zeros((n, n, *video.size_hw, 3), np.float32)
        for i, s in enumerate(indices):
            for j, t in enumerate(indices):
                ret[i, j] = self.calculate_single(video, s, t)
        return ret


def keyframe_conv(flow_cache: FlowCache, workspace: str,
                  video: VideoWorkspace, frames: FrameIndices,
                  kernel_size: int = 17, stride: int = 8,
                  dilation: int = 2) -> FrameIndices:
    """Per sliding window keep the best-connected frame: the argmax over
    sources of the total pairwise confidence. Resumable through the
    level's directory of chosen frames."""
    if os.path.exists(workspace):
        files = glob.glob(os.path.join(workspace, "*.png"))
        if files:
            return FrameIndices(int(os.path.basename(f).split(".")[0])
                                for f in files)
    os.makedirs(workspace, exist_ok=True)
    ret = set()
    for local in frames.conv_indices(kernel_size, stride, dilation):
        mat = flow_cache.calculate_pairwise(video, local)
        totals = mat[..., 2].sum(axis=(1, 2, 3))   # [N_source]
        ret.add(local.indices[int(np.argmax(totals))])
    for idx in ret:
        write_png(os.path.join(workspace, f"{idx:05d}.png"),
                  video.get_raw_frame(idx))
    return FrameIndices(ret)


# ---------------------------------------------------------------------------
# generation helpers
# ---------------------------------------------------------------------------

def expand_mask(mask_u8, ori_image, device="cuda"):
    """Widen the inpaint mask along strong edges: the grey of the
    per-channel |Laplacian| (``ops.filters.laplacian_abs_u8``, cv2's
    bytes) above 20, dilated by the ellipse-7, OR'd in. mask_u8 [H, W]
    and ori_image [H, W, 3] BGR uint8 (numpy or tensors); computed on the
    mask's device when it is a tensor, else on ``device``. Returns the
    uint8 tensor there."""
    dev = mask_u8.device if torch.is_tensor(mask_u8) else torch.device(device)
    lap = laplacian_abs_u8(_tensor(ori_image, dev))
    edges = (bgr_to_gray_u8(lap) > 20).to(torch.uint8) * 255
    return torch.bitwise_or(_tensor(mask_u8, dev),
                            dilate(edges, ellipse_kernel(7)))


def greedy_warp_merge(video: VideoWorkspace, reference_frames: FrameIndices,
                      flow_mat: np.ndarray, thres: float = 0.5):
    """Greedy multi-reference warp-merge on the host: repeatedly pick the
    reference with the largest remaining confidence mass, warp its AI
    frame (``ops.warp.warp_frame`` on the workspace's device), paste its
    confident pixels, subtract the covered region.

    Returns (merged_frame_bgr, covered_mask_u8 [255 = confident/warped]).
    """
    fm = flow_mat.copy()
    fm[..., 2] = (fm[..., 2] > thres).astype(np.float32)
    h, w = fm.shape[2:4]
    mask = np.zeros((h, w), np.uint8)
    merged = None
    for _ in range(len(reference_frames)):
        totals = fm[..., 2].sum(axis=(1, 2, 3))
        rel = int(np.argmax(totals))
        ref_idx = reference_frames.indices[rel]
        ai = video.get_ai_frame(ref_idx)
        if ai is None:
            raise ValueError(f"reference {ref_idx} not generated yet")
        warped = warp_frame(_tensor(ai, video.device).float(),
                            _tensor(fm[rel, 0, :, :, :2], video.device))
        warped = np.clip(warped.cpu().numpy(), 0, 255).astype(np.uint8)
        conf = fm[rel, 0, :, :, 2]
        cur_mask = (conf * 255).astype(np.uint8)
        mask = np.bitwise_or(mask, cur_mask)
        if merged is None:
            merged = warped.copy()
        else:
            m = (cur_mask / 255).astype(np.uint8)[:, :, None]
            merged = (merged * (1 - m) + warped * m).astype(np.uint8)
        fm[:, 0, :, :, 2] = np.clip(fm[:, 0, :, :, 2] - conf[None], 0, 1)
    return merged, mask


def _fused_prep_impl(params, head_params, cfg, src_bgr, tgt_bgr, ai_bgr,
                     *, thres: float, expand: str):
    """The per-frame back-fill prep on one device, with no host round
    trip: RAFT flow + confidence for all references, the cubic warp of
    their AI frames, the greedy confidence-mass merge and the inpaint
    mask's morphology.

    src_bgr [N, H, W, 3] uint8 raw reference frames, tgt_bgr [H, W, 3]
    uint8 raw target frame, ai_bgr [N, H, W, 3] uint8 generated reference
    frames, all on the estimator's device. ``expand``: 'dilate' applies
    the ellipse-7 dilation to the mask (warp_and_inpaint mode); 'none'
    returns the raw uncovered mask (crossattn mode, whose edge expansion
    ``expand_mask`` follows).

    Returns (merged_bgr u8 [H, W, 3], covered u8 [H, W], mask2 u8 [H, W],
    img_model f32 [H, W, 3] RGB [-1, 1], ref_model f32 [H, W, 3]); merged
    and covered equal ``greedy_warp_merge`` fed the same flow fields, and
    padded duplicate references are no-ops (their confidence mass is
    subtracted by the first pick)."""
    src = src_bgr.flip(-1).float()
    tgt = tgt_bgr.flip(-1).float()[None].expand_as(src)
    src_p, (h, w) = pad_to_multiple(src, 8)
    tgt_p, _ = pad_to_multiple(tgt, 8)
    flow, conf, _ = _flow_conf_batch(params, cfg, src_p, tgt_p,
                                     head_params=head_params)
    return _warp_merge_morph(flow[:, :h, :w], conf[:, :h, :w], ai_bgr,
                             tgt_bgr, thres=thres, expand=expand)


def _warp_merge_morph(flow, conf, ai_bgr, tgt_bgr, *, thres: float,
                      expand: str):
    """The warp + greedy merge + morphology half of the fused prep (tests
    drive it with given flow fields): flow [N, H, W, 2], conf [N, H, W],
    ai_bgr [N, H, W, 3] uint8, tgt_bgr [H, W, 3] uint8, one device. Each
    pick's argmax stays on the device (no host read per reference)."""
    if expand not in ("dilate", "none"):
        raise ValueError(f"expand must be 'dilate' or 'none', got {expand!r}")
    h, w = flow.shape[1:3]
    # cubic warp of each reference's AI frame into target coordinates,
    # clipped and truncated to uint8 as greedy_warp_merge does
    warped = torch.stack([warp_frame(a.float(), f)
                          for a, f in zip(ai_bgr, flow)])
    warped_u8 = warped.clamp(0.0, 255.0).to(torch.uint8)
    fmc = (conf > thres).float()                    # binary mass field
    merged = None
    mask = torch.zeros((h, w), dtype=torch.bool, device=flow.device)
    for _ in range(ai_bgr.shape[0]):
        rel = fmc.sum(dim=(1, 2)).argmax().reshape(1)
        confk = fmc.index_select(0, rel)[0]         # [H, W] in {0, 1}
        cur = confk > 0.5
        wk = warped_u8.index_select(0, rel)[0]
        # the first pick pastes wholesale; later picks paste only their
        # confident pixels
        merged = wk if merged is None else torch.where(cur[..., None], wk,
                                                       merged)
        mask = mask | cur
        fmc = (fmc - confk[None]).clamp(0.0, 1.0)
    covered = mask.to(torch.uint8) * 255
    mask2 = (~mask).to(torch.uint8) * 255
    if expand == "dilate":
        mask2 = dilate(mask2, ellipse_kernel(7))
    return merged, covered, mask2, _to_model(merged), _to_model(tgt_bgr)


def fused_flow_warp_merge(est, video: VideoWorkspace,
                          ref_idxs: Sequence[int], idx: int, *,
                          thres: float, expand: str, n_pad: int = 0):
    """Upload the (padded) reference frames, their AI frames and the target
    as uint8 to the estimator's device and run :func:`_fused_prep_impl`
    there. ``n_pad``: pad the reference set to this count by repeating
    the last reference (padded duplicates do not change the merge)."""
    idxs = list(ref_idxs)
    if n_pad > len(idxs):
        idxs = idxs + [idxs[-1]] * (n_pad - len(idxs))
    ais = []
    for s in idxs:
        ai = video.get_ai_frame(s)
        if ai is None:
            raise ValueError(f"reference {s} not generated yet")
        ais.append(ai)
    dev = est.device
    src = np.stack([video.get_raw_frame(s) for s in idxs])
    return _fused_prep_impl(
        est.params, est.head_params, est.cfg, _tensor(src, dev),
        _tensor(video.get_raw_frame(idx), dev), _tensor(np.stack(ais), dev),
        thres=float(thres), expand=expand)


def _default_controls(control_bundle, condition_bgr, latent_batch=2,
                      device="cuda"):
    """HED 0.7 (the whole denoise) + Canny 0.3 (progress 0..0.9) on the
    original frame, hints built on ``device``. control_bundle: None or
    (params, cfg, hed_fn)."""
    if control_bundle is None:
        return ()
    params, cfg, hed_fn = control_bundle
    return (
        ControlSpec(params, cfg, hed_hint(condition_bgr, hed_fn,
                                          batch=latent_batch, device=device),
                    weight=0.7, guidance_start=0.0, guidance_end=1.0),
        ControlSpec(params, cfg, canny_hint(condition_bgr, 100, 200,
                                            batch=latent_batch,
                                            device=device),
                    weight=0.3, guidance_start=0.0, guidance_end=0.9),
    )


def concat_ref_kv(kv_hists: Sequence) -> Optional[tuple]:
    """Concatenate several stored K/V tuples along the token axis, layer
    by layer (None entries are skipped; None if nothing is left)."""
    kv_hists = [kv for kv in kv_hists if kv is not None]
    if not kv_hists:
        return None
    return tuple((torch.cat([kv[i][0] for kv in kv_hists], dim=1),
                  torch.cat([kv[i][1] for kv in kv_hists], dim=1))
                 for i in range(len(kv_hists[0])))


# ---------------------------------------------------------------------------
# pipeline config + modes
# ---------------------------------------------------------------------------

@dataclass
class KeyframeInpaintConfig:
    size: Tuple[int, int] = (512, 768)
    keep_every: int = 3
    max_len_sec: int = 30
    kernel_size: int = 30
    stride: int = 15
    dilation: int = 2
    n_seed_frames: int = 1
    num_ref_for_generation: int = 1
    denoising_strength: float = 0.8
    conf_thres: float = 0.95        # the reference dispatcher's default
    mode_thres: float = 0.5         # the generation modes' default
    ddim_steps: int = 50
    mask_blur: int = 4
    seed: int = 1234
    prompt_extra: str = ""
    mode: str = "warp_and_inpaint_crossattn"
    # pairs a RAFT batch of the flow cache (the reference batches 16;
    # FlowCache halves it where a batch runs out of device memory)
    flow_batch: int = 8
    use_reference_kv: bool = True
    # the warp modes' per-frame prep (flow + warp + greedy merge + mask
    # morphology) on the device in one call; False takes the staged path
    # (the flow cache, then the merge on the host)
    fused_prep: bool = True
    # >1: back-fill each level in chunks of this many frames a call
    # (frames of a level depend only on the previous level). Level-0 K/V
    # chaining then runs per chunk: the previous chunk's last frame's K/V
    # is injected into every frame of the next. 1: the reference's
    # serial loop
    level_batch: int = 1
    # sequence parallelism of the strips (ROADMAP §1 item 8, not ported:
    # a value other than None reaches the facades, which raise)
    sp: Optional[object] = None
    guidance_schedule_func = staticmethod(lambda p: 1.0)


def _prompt(tagger, frame_bgr, extra):
    if tagger is not None and tagger.available:
        return tagger.build_prompt(frame_bgr, extra)
    return "masterpiece,best quality," + extra if extra else \
        "masterpiece,best quality"


def _warp_prep(video: VideoWorkspace, refs: FrameIndices, idx: int,
               original, flow_cache: FlowCache, cfg: KeyframeInpaintConfig,
               *, expand: str, device):
    """The warp modes' per-frame prep, fused (on the estimator's device)
    or staged (the flow cache, then ``greedy_warp_merge``). ``expand``:
    'none' (the raw uncovered mask), 'dilate' (ellipse-7) or 'edges'
    (``expand_mask``, the crossattn mode). Returns device tensors
    (merged BGR u8 [H, W, 3], covered u8 [H, W], mask u8 [H, W], merged
    and original in model space [H, W, 3])."""
    if cfg.fused_prep:
        merged, covered, mask2, img, ref = fused_flow_warp_merge(
            flow_cache.estimator, video, refs, idx, thres=cfg.mode_thres,
            expand="dilate" if expand == "dilate" else "none",
            n_pad=cfg.num_ref_for_generation)
    else:
        flow_mat = flow_cache.calculate_multiple_to_one(video, refs, idx)
        merged, covered = greedy_warp_merge(video, refs, flow_mat,
                                            cfg.mode_thres)
        merged, covered = _tensor(merged, device), _tensor(covered, device)
        mask2 = 255 - covered                   # inpaint the UNcovered
        if expand == "dilate":
            mask2 = dilate(mask2, ellipse_kernel(7))
        img, ref = _to_model(merged), _to_model(_tensor(original, device))
    if expand == "edges":
        mask2 = expand_mask(255 - covered, original)
    return merged, covered, mask2, img, ref


def generate_with_refs(sd_inpaint, tagger, video: VideoWorkspace,
                       frame_idx: int, reference_frames: FrameIndices,
                       flow_cache: FlowCache, cfg: KeyframeInpaintConfig,
                       control_bundle=None, reference_kv=None,
                       level: int = 0, workspace: str = ""):
    """One back-fill frame in ``cfg.mode``. Returns (frame_bgr, kv_hist)."""
    original = video.get_raw_frame(frame_idx)
    prompt = _prompt(tagger, original, cfg.prompt_extra)
    mode = cfg.mode
    dev = sd_inpaint.device

    if mode in ("warp_and_inpaint", "warp_and_inpaint_crossattn"):
        crossattn = mode == "warp_and_inpaint_crossattn"
        merged, _, mask2, img, ref = _warp_prep(
            video, reference_frames, frame_idx, original, flow_cache, cfg,
            expand="edges" if crossattn else "dilate", device=dev)
        ref_kv = concat_ref_kv(reference_kv) \
            if (reference_kv and crossattn) else None
        # K/V capture (one more UNet pass and a store a frame) pays off
        # only where a later frame injects it: crossattn with
        # use_reference_kv
        want_kv = cfg.use_reference_kv and crossattn
        out, _, _, kv = F.img2img_inpaint(
            sd_inpaint, image=img[None], c_text=prompt,
            uc_text=NEGATIVE_PROMPT,
            denoising_strength=cfg.denoising_strength,
            ddim_steps=cfg.ddim_steps, reference_img=ref[None],
            mask=mask2.float() / 255.0, mask_blur=cfg.mask_blur,
            guidance_schedule_func=cfg.guidance_schedule_func,
            seed=cfg.seed, reference_kv=ref_kv, capture_kv=want_kv,
            control_specs=_default_controls(control_bundle, original,
                                            device=dev),
            want_init_decoded=False)
        frame = model_to_bgr_u8(out)
        if workspace:
            vis_dir = os.path.join(workspace, "render_vis", f"u{level:02d}")
            vis = np.concatenate([original, merged.cpu().numpy(), frame],
                                 axis=1)
            write_png(os.path.join(vis_dir, f"{frame_idx:05d}.png"), vis)
        return frame, kv

    if mode in ("self_attn", "both"):
        # the width-concatenated strip [target | references]; only the
        # first tile is inpainted
        h, w = video.size_hw
        n_ref = len(reference_frames)
        if mode == "self_attn":
            first_tile = original
            covered = np.zeros((h, w), np.uint8)
        else:
            merged, covered, _, _, _ = _warp_prep(
                video, reference_frames, frame_idx, original, flow_cache,
                cfg, expand="none", device=dev)
            first_tile, covered = merged.cpu().numpy(), covered.cpu().numpy()
        strip = np.zeros((h, w * (n_ref + 1), 3), np.uint8)
        strip[:, :w] = first_tile
        for i, idx in enumerate(reference_frames):
            ai = video.get_ai_frame(idx)
            if ai is None:
                raise ValueError(f"reference {idx} not generated yet")
            strip[:, (i + 1) * w: (i + 2) * w] = ai
        mask = np.zeros((h, w * (n_ref + 1)), np.uint8)
        mask[:, :w] = 255 - covered if mode == "both" else 255
        strip_d = bgr_u8_to_model(strip, dev)
        out, _, _, kv = F.img2img_inpaint(
            sd_inpaint, image=strip_d, c_text=prompt,
            uc_text=NEGATIVE_PROMPT,
            denoising_strength=cfg.denoising_strength,
            ddim_steps=cfg.ddim_steps,
            reference_img=strip_d,              # identity composite
            mask=_tensor(mask, dev).float() / 255.0, mask_blur=cfg.mask_blur,
            guidance_schedule_func=cfg.guidance_schedule_func,
            seed=cfg.seed, capture_kv=cfg.use_reference_kv,
            control_specs=_default_controls(control_bundle, strip,
                                            device=dev),
            # the MFR band bias: the target tile is attracted to the
            # spatially corresponding reference pixels at every
            # self-attention
            strip=StripConfig(n_tiles=n_ref + 1, mode="target"),
            sp=cfg.sp, want_init_decoded=False)
        frame = model_to_bgr_u8(out)[:, :w]
        return frame, kv

    raise ValueError(f"unknown generation mode {mode!r}")


def _backfill_level_batched(sd_inpaint, tagger, video: VideoWorkspace,
                            cur: FrameIndices, generated: FrameIndices,
                            flow_cache: FlowCache,
                            cfg: KeyframeInpaintConfig, level: int,
                            workspace: str):
    """Back-fill one level in chunks of ``cfg.level_batch`` frames a call.

    Every frame of a level depends only on the previous level's frames,
    so a chunk's frames denoise as one batch, each injecting its own
    references' K/V (a per-frame reference_kv batch). The level-0 chain
    differs from the serial loop's: there the frame just before is
    injected; here every frame of a chunk injects the previous chunk's
    last frame.
    """
    crossattn = cfg.mode.endswith("crossattn")
    want_kv = cfg.use_reference_kv and crossattn
    vis_dir = os.path.join(workspace, "render_vis", f"u{level:02d}")
    os.makedirs(vis_dir, exist_ok=True)
    idxs = list(cur.indices)
    prev_chunk_last = -1
    eff_batch = cfg.level_batch
    dev = sd_inpaint.device
    if want_kv:
        # K/V-injecting chunks are capped at 2 frames of 512x768, scaled
        # by the pixel area (smaller frames batch more); the level-0
        # chain, and so the frames, depend on the chunks
        area = cfg.size[0] * cfg.size[1]
        eff_batch = max(1, min(eff_batch,
                               int(2 * (512 * 768) / max(area, 1))))
    for start in range(0, len(idxs), eff_batch):
        chunk = idxs[start:start + eff_batch]
        imgs, ref_imgs, masks, prompts, ref_kvs = [], [], [], [], []
        originals, mergeds = [], []
        for idx in chunk:
            refs = generated.adjacent_frames(idx,
                                             cfg.num_ref_for_generation)
            original = video.get_raw_frame(idx)
            merged, _, mask2, img, ref = _warp_prep(
                video, refs, idx, original, flow_cache, cfg,
                expand="edges" if crossattn else "dilate", device=dev)
            imgs.append(img)
            ref_imgs.append(ref)
            masks.append(mask2.float() / 255.0)
            prompts.append(_prompt(tagger, original, cfg.prompt_extra))
            originals.append(original)
            mergeds.append(merged)
            if want_kv:
                kv_list = [video.get_kv(r) for r in refs]
                if prev_chunk_last != -1 and level == 0:
                    kv_list.append(video.get_kv(prev_chunk_last))
                ref_kvs.append(concat_ref_kv(kv_list))

        # one batch shape per (batch, K/V width): group the chunk's frames
        # by injected K/V token width (they differ only at level
        # transitions and the level-0 chain's start) and pad each group
        # to eff_batch by repeating its last frame; the noise is drawn
        # once and tiled, so padded slots do not change real outputs
        groups: dict = {}
        for pos in range(len(chunk)):
            wk = (None if not want_kv or ref_kvs[pos] is None
                  else ref_kvs[pos][0][0].shape[1])
            groups.setdefault(wk, []).append(pos)

        for wk, poss in groups.items():
            reps = poss + [poss[-1]] * (eff_batch - len(poss))
            stacked_kv = None
            if wk is not None:
                stacked_kv = tuple(
                    (torch.cat([ref_kvs[p][i][0] for p in reps]),
                     torch.cat([ref_kvs[p][i][1] for p in reps]))
                    for i in range(len(ref_kvs[poss[0]])))
            out = F.img2img_inpaint_batch(
                sd_inpaint, torch.stack([imgs[p] for p in reps]),
                [prompts[p] for p in reps], NEGATIVE_PROMPT,
                torch.stack([masks[p] for p in reps]),
                torch.stack([ref_imgs[p] for p in reps]),
                denoising_strength=cfg.denoising_strength,
                ddim_steps=cfg.ddim_steps, mask_blur=cfg.mask_blur,
                guidance_schedule_func=cfg.guidance_schedule_func,
                seed=cfg.seed, reference_kv=stacked_kv,
                capture_kv=want_kv)
            out, kv_batch = out if want_kv else (out, None)
            kv_frames = F.split_kv_batch(kv_batch, len(reps))
            host = out.float().cpu()        # one copy for the chunk

            for j, pos in enumerate(poss):
                idx = chunk[pos]
                frame = model_to_bgr_u8(host[j:j + 1])
                video.put_ai_frame(idx, frame)
                vis = np.concatenate([originals[pos],
                                      mergeds[pos].cpu().numpy(), frame],
                                     axis=1)
                write_png(os.path.join(vis_dir, f"{idx:05d}.png"), vis)
                if kv_frames[j] is not None and (
                        level > 0 or pos == len(chunk) - 1):
                    # at level 0 only the chunk's last K/V seeds the
                    # next chunk (the serial loop keeps one frame's K/V
                    # on disk)
                    video.put_kv(idx, kv_frames[j])
        if level == 0:
            if prev_chunk_last != -1:
                video.remove_kv(prev_chunk_last)
            prev_chunk_last = chunk[-1]


def generate_seed_frames(sd, tagger, video: VideoWorkspace,
                         seed_indices: FrameIndices,
                         cfg: KeyframeInpaintConfig, control_bundle=None):
    """Render all seed frames jointly as one wide strip img2img; the
    prompt from the first seed frame. Returns (frames, kv_hist)."""
    frames = [video.get_raw_frame(i) for i in seed_indices]
    strip = np.concatenate(frames, axis=1)
    prompt = _prompt(tagger, frames[0], cfg.prompt_extra)
    out, kv = F.img2img(
        sd, bgr_u8_to_model(strip, sd.device), prompt, NEGATIVE_PROMPT,
        cfg.denoising_strength, cfg.ddim_steps, seed=cfg.seed,
        capture_kv=cfg.use_reference_kv,
        control_specs=_default_controls(control_bundle, strip,
                                        device=sd.device),
        # joint seed strips: every tile is a target, and the mutual band
        # attraction keeps the seeds coherent
        strip=StripConfig(n_tiles=len(seed_indices), mode="mutual")
        if len(seed_indices) > 1 else None,
        sp=cfg.sp)
    strip_bgr = model_to_bgr_u8(out)
    return np.split(strip_bgr, len(seed_indices), axis=1), kv


# ---------------------------------------------------------------------------
# main loop
# ---------------------------------------------------------------------------

def run(video: VideoWorkspace, sd, sd_inpaint, flow_estimator,
        tagger: Optional[Tagger] = None,
        cfg: KeyframeInpaintConfig = KeyframeInpaintConfig(),
        control_bundle=None):
    """Level pyramid -> seed strip -> back-fill. ``sd`` renders the seed
    strip, ``sd_inpaint`` (the 9-channel model) the back-fill;
    ``control_bundle``: None or (ControlNet params, cfg, hed_fn), which
    sends every level through the serial loop. Returns the workspace
    directory."""
    workspace = video.workspace_dir
    os.makedirs(os.path.join(workspace, "render_vis"), exist_ok=True)
    flow_cache = FlowCache(flow_estimator, workspace, cfg.flow_batch)

    level = 0
    frame_indices = FrameIndices.from_n(video.num_frames)
    history: List[FrameIndices] = [FrameIndices.from_n(video.num_frames)]
    while len(frame_indices) > cfg.n_seed_frames:
        level += 1
        frame_indices = keyframe_conv(
            flow_cache, os.path.join(workspace, f"d{level:02d}"), video,
            frame_indices, cfg.kernel_size, cfg.stride, cfg.dilation)
        history.append(frame_indices)
    flow_cache.purge()
    frame_indices.add(0)

    seed_frames, seed_kv = generate_seed_frames(sd, tagger, video,
                                                frame_indices, cfg,
                                                control_bundle)
    for i, idx in enumerate(frame_indices):
        write_png(os.path.join(workspace, "seed", f"{idx:05d}.png"),
                  seed_frames[i])
        video.put_ai_frame(idx, seed_frames[i])
        if cfg.use_reference_kv and seed_kv is not None:
            video.put_kv(idx, seed_kv)

    generated = history.pop()
    while history:
        level -= 1
        cur = history.pop()
        cur.remove(generated)
        if (cfg.level_batch > 1 and control_bundle is None
                and cfg.mode in ("warp_and_inpaint",
                                 "warp_and_inpaint_crossattn")):
            _backfill_level_batched(sd_inpaint, tagger, video, cur,
                                    generated, flow_cache, cfg,
                                    max(level, 0), workspace)
            generated.add(cur)
            continue
        last_idx = -1
        for idx in cur.indices:
            refs = generated.adjacent_frames(idx, cfg.num_ref_for_generation)
            ref_kv = None
            if cfg.use_reference_kv:
                ref_kv = [video.get_kv(r) for r in refs]
                if last_idx != -1 and level == 0:
                    ref_kv.append(video.get_kv(last_idx))
            os.makedirs(os.path.join(workspace, "render_vis",
                                     f"u{max(level, 0):02d}"), exist_ok=True)
            frame, kv = generate_with_refs(
                sd_inpaint, tagger, video, idx, refs, flow_cache, cfg,
                control_bundle=control_bundle, reference_kv=ref_kv,
                level=max(level, 0), workspace=workspace)
            video.put_ai_frame(idx, frame)
            if cfg.use_reference_kv and kv is not None:
                video.put_kv(idx, kv)
            if last_idx != -1 and level == 0:
                video.remove_kv(last_idx)   # bound the on-disk K/V
            last_idx = idx
        generated.add(cur)
    flow_cache.purge()
    return workspace
