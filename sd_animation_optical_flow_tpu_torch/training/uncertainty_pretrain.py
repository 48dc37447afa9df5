"""Pretrain RAFT + the learned uncertainty decoder on synthetic scenes.

Counterpart of ``sd_animation_optical_flow_tpu/training/
uncertainty_pretrain.py``:

  stage 1  train RAFT (``flow_train.flow_train_step``) on the synthetic
           suite, from scratch or resumed from a checkpoint;
  stage 2  freeze RAFT, train the head by Laplace NLL (+ the
           disocclusion BCE) (``uncertainty_train_step``);
  evaluate the held-out EPE (``eval_epe``) and mask quality
           (``evaluate_masks``: occlusion recall / false-mask rate at the
           pipelines' thresholds and a rank AUROC, for fb / learned / min
           confidence).

Scenes are rendered on ``device`` (``synthetic_flow``) ahead of the step:
on the card by a worker thread on its own CUDA stream, whose batches the
step's stream waits for by event.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..models import flowconf as FC
from ..models import raft as RF
from ..models.layers import Init
from ..utils.tree import tree_map
from . import flow_train as FT
from . import synthetic_flow as SF


def _log(msg: str, log: Optional[Callable[[str], None]]):
    if log is not None:
        log(msg)


class _Prefetcher:
    """Iterator over ``steps`` batches (``synthetic_flow.synthetic_batch``'s
    tuple) rendered ahead by ``workers`` threads, one batch a task (its
    scenes rendered together). ``wait_s`` accumulates the host seconds
    the consumer spent blocked on batches that were not ready yet."""

    def __init__(self, seed, steps, batch, h, w, depth, workers, device):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        # a batch is about a thousand small launches: on the card one
        # thread keeps ahead of a step, more only contend for the GIL
        workers = workers or (1 if self.cuda else min(8, os.cpu_count() or 4))
        # per-scene generators spawned from one SeedSequence: the stream is
        # the same for any worker count or completion order
        self.children = np.random.SeedSequence(seed).spawn(steps * batch)
        self.steps, self.batch, self.h, self.w = steps, batch, h, w
        self.local = threading.local()
        self.ex = ThreadPoolExecutor(max_workers=workers)
        self.futs = [self.ex.submit(self._render, i)
                     for i in range(min(depth, steps))]
        self.nxt = len(self.futs)
        self.wait_s = 0.0

    def _render(self, i):
        draws = [SF._draw(np.random.default_rng(c), self.h, self.w)
                 for c in self.children[i * self.batch:(i + 1) * self.batch]]
        if not self.cuda:
            return SF._render(draws, self.h, self.w, self.dev), None
        if not hasattr(self.local, "stream"):
            self.local.stream = torch.cuda.Stream(self.dev)
        with torch.cuda.stream(self.local.stream):
            batch = SF._render(draws, self.h, self.w, self.dev)
            done = torch.cuda.Event()
            done.record()
        return batch, done

    def __iter__(self):
        try:
            for _ in range(self.steps):
                t0 = time.perf_counter()
                batch, done = self.futs.pop(0).result()
                self.wait_s += time.perf_counter() - t0
                if self.nxt < self.steps:
                    self.futs.append(self.ex.submit(self._render, self.nxt))
                    self.nxt += 1
                if self.cuda:
                    main = torch.cuda.current_stream(self.dev)
                    main.wait_event(done)
                    for t in batch:         # freed only after main's reads
                        t.record_stream(main)
                yield batch
        finally:
            for f in self.futs:
                f.cancel()
            self.ex.shutdown(wait=True)


def _batch_prefetcher(seed: int, steps: int, batch: int, h: int, w: int,
                      depth: int = 4, workers: int = 0, device="cuda"):
    """Scene batches rendered ahead of the train loop: an iterator of
    ``steps`` tuples (img1, img2, flow, valid, occluded, disoccluded) on
    ``device``, the scenes JAX's prefetcher renders for ``seed`` whatever
    ``workers`` is (0: one thread on the card, up to 8 on the CPU);
    ``depth`` batches are in flight. Its ``wait_s`` is the time the loop
    waited for scenes."""
    return _Prefetcher(seed, steps, batch, h, w, depth, workers, device)


def _progress(kind, step, loss, extra, t0, batches):
    el = time.perf_counter() - t0
    wait = batches.wait_s / max(el, 1e-9)
    return (f"{kind} step {step}: loss {float(loss):.3f} {extra} "
            f"({el:.0f}s, waited for scenes {wait:.3f} of it)")


def train_raft_synthetic(cfg: RF.RAFTConfig, *, steps: int = 600,
                         batch: int = 4, h: int = 128, w: int = 192,
                         iters: int = 8, lr: float = 2e-4, seed: int = 0,
                         init_params=None,
                         log: Optional[Callable[[str], None]] = None,
                         device="cuda"):
    """Stage 1: RAFT from a seeded random init (or resumed from
    ``init_params``) on the synthetic suite. Returns (params, final
    metrics dict incl. 'epe')."""
    params = init_params if init_params is not None else RF.raft_init(
        Init(torch.Generator(device).manual_seed(seed), device=device), cfg)
    state = FT.init_flow_train_state(params, FT.make_flow_optimizer(lr=lr))
    metrics = {}
    t0 = time.perf_counter()
    batches = _batch_prefetcher(seed, steps, batch, h, w, device=device)
    for step, (im1, im2, gt, valid, _, _) in enumerate(batches):
        state, loss, metrics = FT.flow_train_step(
            state, cfg, im1, im2, gt, valid, iters=iters)
        if log is not None and (step % 50 == 0 or step == steps - 1):
            _log(_progress("raft", step, loss,
                           f"epe {float(metrics['epe']):.3f}", t0, batches),
                 log)
    return (_frozen(state.params),
            {k: float(v) for k, v in metrics.items()})


def train_head_synthetic(raft_params, cfg: RF.RAFTConfig, *,
                         steps: int = 400, batch: int = 4, h: int = 128,
                         w: int = 192, iters: int = 8, lr: float = 1e-3,
                         seed: int = 1, bce_weight: float = 0.3,
                         log: Optional[Callable[[str], None]] = None,
                         device="cuda"):
    """Stage 2: the uncertainty head by NLL (+ disocclusion-BCE
    sharpening, see ``flow_train.uncertainty_train_step``) against the
    frozen RAFT. Returns (head_params, final metrics incl.
    'err_scale_corr')."""
    head = FC.uncertainty_head_init(
        Init(torch.Generator(device).manual_seed(seed), device=device),
        hidden_dim=cfg.hidden_dim)
    state = FT.init_flow_train_state(head, FT.make_flow_optimizer(lr=lr))
    metrics = {}
    t0 = time.perf_counter()
    batches = _batch_prefetcher(seed, steps, batch, h, w, device=device)
    for step, (im1, im2, gt, valid, _, dis) in enumerate(batches):
        state, loss, metrics = FT.uncertainty_train_step(
            state, raft_params, cfg, im1, im2, gt, valid, iters=iters,
            disoccluded=dis, bce_weight=bce_weight)
        if log is not None and (step % 50 == 0 or step == steps - 1):
            _log(_progress("head", step, loss,
                           f"corr {float(metrics['err_scale_corr']):.3f}",
                           t0, batches), log)
    return (_frozen(state.params),
            {k: float(v) for k, v in metrics.items()})


def _frozen(params):
    return tree_map(lambda p: p.detach(), params)


@torch.no_grad()
def eval_epe(raft_params, cfg: RF.RAFTConfig, *, n_scenes: int = 8,
             h: int = 128, w: int = 192, iters: int | None = None,
             seed: int = 999, device="cuda") -> float:
    """End-point error on a FIXED held-out scene set (training batches are
    fresh random scenes, so their per-batch metric is far too noisy to
    compare checkpoints on)."""
    im1, im2, gt, valid, _, _ = SF.synthetic_batch(
        np.random.default_rng(seed), n_scenes, h, w, device=device)
    tot, cnt = 0.0, 0.0
    for i in range(0, n_scenes, 4):
        _, flow_up = RF.raft_apply(raft_params, cfg, im1[i:i + 4],
                                   im2[i:i + 4], iters=iters)
        epe = (flow_up - gt[i:i + 4]).pow(2).sum(-1).sqrt()
        keep = valid[i:i + 4] > 0
        tot += float(epe[keep].sum())
        cnt += float(keep.sum())
    return tot / max(cnt, 1.0)


@torch.no_grad()
def evaluate_masks(raft_params, head_params, raft_cfg: RF.RAFTConfig, *,
                   n_scenes: int = 16, h: int = 128, w: int = 192,
                   thresholds: tuple = (0.5, 0.9, 0.95), seed: int = 12345,
                   margin: int = 12, device="cuda") -> dict:
    """Held-out mask quality per confidence mode.

    Runs each estimator mode (fb / learned / min) the way the pipelines
    do (``calc_batch(src, tgt)``, target-grid confidence) and scores the
    ``conf < thres`` inpaint mask against the true disocclusion mask:
    recall = share of disoccluded pixels caught, false_rate = share of
    verifiable pixels wrongly masked, with the frame's border ring
    (``margin`` px) left out. Each mode also reports a threshold-free
    AUROC of (1 - conf) as a disocclusion score (rank based, on up to
    20000 pixels of each class drawn with a fixed seed)."""
    src, tgt, _, _, _, dis = SF.synthetic_batch(
        np.random.default_rng(seed), n_scenes, h, w, device=device)
    dis = dis.cpu().numpy()
    inner = np.zeros((h, w), bool)
    inner[margin:-margin, margin:-margin] = True
    occ = dis & inner[None]
    good = (~dis) & inner[None]

    def auroc(score_pos, score_neg):
        # rank-based AUROC (Mann-Whitney), subsampled for memory
        if len(score_pos) == 0 or len(score_neg) == 0:
            return float("nan")  # degenerate split: no score is defined
        rs = np.random.default_rng(0)
        pos = rs.choice(score_pos, min(len(score_pos), 20000),
                        replace=False)
        neg = rs.choice(score_neg, min(len(score_neg), 20000),
                        replace=False)
        from scipy.stats import rankdata
        ranks = rankdata(np.concatenate([pos, neg]))
        rp = ranks[:len(pos)].sum()
        return float((rp - len(pos) * (len(pos) + 1) / 2)
                     / (len(pos) * len(neg)))

    out = {}
    for mode in ("fb", "learned", "min"):
        cfg = FC.FlowConfidenceConfig(raft=raft_cfg, uncertainty=mode)
        est = FC.FlowConfidenceEstimator(
            raft_params, cfg,
            head_params=None if mode == "fb" else head_params, device=device)
        confs = [est.calc_batch_device(src[i:i + 1], tgt[i:i + 1])[1][0]
                 for i in range(n_scenes)]    # one pair per call: eval only
        conf = torch.stack(confs).float().cpu().numpy()
        r = {"auroc": auroc(1.0 - conf[occ], 1.0 - conf[good])}
        for t in thresholds:
            mask = conf < t
            r[f"recall@{t}"] = float(mask[occ].mean())
            r[f"false_rate@{t}"] = float(mask[good].mean())
        out[mode] = r
    return out
