"""Optical-flow training data layer: augmentors + dataset catalog.

Counterpart of ``sd_animation_optical_flow_tpu/training/flow_data.py``
(capabilities-parity with RAFT's FlowAugmentor / SparseFlowAugmentor,
FlowDataset, MpiSintel, FlyingChairs, FlyingThings3D, KITTI, HD1K and
fetch_dataloader): host-side numpy / cv2 with an explicit
``np.random.Generator`` per worker, no torch DataLoader;
:func:`make_batch_iterator` yields fixed-shape NHWC float32 numpy batches
(``torch.from_numpy`` then the device). Photometric jitter is implemented
directly (brightness / contrast / saturation / hue in HSV) instead of
torchvision's ColorJitter. cv2 is imported where it is used (the card's
machine has none; the port's flow training renders synthetic scenes,
``training/synthetic_flow.py``), with its threading off
(``setNumThreads(0)``), as RAFT's augmentor sets it.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass, field
from glob import glob
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.flow_io import read_flow_kitti, read_gen


def _cv2():
    import cv2
    cv2.setNumThreads(0)   # RAFT's augmentor pins this too
    return cv2


# ---------------------------------------------------------------------------
# photometric jitter (torchvision ColorJitter semantics, numpy/cv2)
# ---------------------------------------------------------------------------

def color_jitter(img: np.ndarray, rng: np.random.Generator, *,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.5 / 3.14
                 ) -> np.ndarray:
    """uint8 RGB jitter with factors drawn like torchvision's
    ColorJitter (uniform in [max(0, 1-x), 1+x]; hue in [-h, h] turns)."""
    img = img.astype(np.float32)
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    # apply in a random order, as torchvision does
    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0:
            img = img * b
        elif op == 1:
            mean = img.mean()
            img = (img - mean) * c + mean
        elif op == 2:
            gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
            img = (img - gray[..., None]) * s + gray[..., None]
        elif op == 3 and abs(h) > 1e-8:
            cv2 = _cv2()
            hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                               cv2.COLOR_RGB2HSV)
            hsv = hsv.astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(h * 180)) % 180
            img = cv2.cvtColor(hsv.astype(np.uint8),
                               cv2.COLOR_HSV2RGB).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# augmentors
# ---------------------------------------------------------------------------

@dataclass
class FlowAugmentor:
    """Dense-flow augmentation (augmentor.py:15-124): photometric jitter
    (symmetric or per-image), occlusion eraser on img2, random
    scale/stretch, h/v flips, fixed-size crop."""
    crop_size: Tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    spatial_aug_prob: float = 0.8
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5

    # -- photometric --------------------------------------------------
    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return color_jitter(img1, rng), color_jitter(img2, rng)
        stack = np.concatenate([img1, img2], axis=0)
        stack = color_jitter(stack, rng)
        return np.split(stack, 2, axis=0)

    def eraser_transform(self, img1, img2, rng, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(int(rng.integers(1, 3))):
                x0 = int(rng.integers(0, wd))
                y0 = int(rng.integers(0, ht))
                dx = int(rng.integers(bounds[0], bounds[1]))
                dy = int(rng.integers(bounds[0], bounds[1]))
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    # -- spatial ------------------------------------------------------
    def _sample_scales(self, ht, wd, rng):
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        return max(sx, min_scale), max(sy, min_scale)

    def spatial_transform(self, img1, img2, flow, rng):
        cv2 = _cv2()
        ht, wd = img1.shape[:2]
        sx, sy = self._sample_scales(ht, wd, rng)
        if rng.random() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow = cv2.resize(flow, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow = flow * [sx, sy]
        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]
        y0 = int(rng.integers(0, img1.shape[0] - self.crop_size[0] + 1))
        x0 = int(rng.integers(0, img1.shape[1] - self.crop_size[1] + 1))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow, rng=None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


@dataclass
class SparseFlowAugmentor(FlowAugmentor):
    """KITTI-style sparse variant (augmentor.py:127-246): flow maps with
    a validity mask, nearest-neighbor-preserving sparse resize, no
    v-flip, margin-shifted crops."""
    do_flip: bool = True
    v_flip_prob: float = 0.0
    min_scale: float = -0.2
    max_scale: float = 0.5

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
        ht, wd = flow.shape[:2]
        coords = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack(coords, axis=-1).astype(np.float32)
        coords = coords.reshape(-1, 2)[valid.reshape(-1) >= 1]
        flow_pts = flow.reshape(-1, 2)[valid.reshape(-1) >= 1]
        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords = coords * [fx, fy]
        flow_pts = flow_pts * [fx, fy]
        xx = np.round(coords[:, 0]).astype(np.int32)
        yy = np.round(coords[:, 1]).astype(np.int32)
        keep = (xx >= 0) & (xx < wd1) & (yy >= 0) & (yy < ht1)
        flow_img = np.zeros((ht1, wd1, 2), np.float32)
        valid_img = np.zeros((ht1, wd1), np.int32)
        flow_img[yy[keep], xx[keep]] = flow_pts[keep]
        valid_img[yy[keep], xx[keep]] = 1
        return flow_img, valid_img

    def spatial_transform_sparse(self, img1, img2, flow, valid, rng):
        cv2 = _cv2()
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        sx = max(scale, min_scale)
        sy = max(scale, min_scale)
        if rng.random() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=sx, fy=sy,
                              interpolation=cv2.INTER_LINEAR)
            flow, valid = self.resize_sparse_flow_map(flow, valid, sx, sy)
        if self.do_flip and rng.random() < self.h_flip_prob:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]
        margin_y, margin_x = 20, 50
        y0 = int(rng.integers(0, img1.shape[0] - self.crop_size[0] + margin_y))
        x0 = int(rng.integers(0, img1.shape[1] - self.crop_size[1] + margin_x))
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid, rng=None):
        rng = rng or np.random.default_rng()
        img1, img2 = self.color_transform(img1, img2, rng)
        img1, img2 = self.eraser_transform(img1, img2, rng)
        img1, img2, flow, valid = self.spatial_transform_sparse(
            img1, img2, flow, valid, rng)
        return tuple(np.ascontiguousarray(a)
                     for a in (img1, img2, flow, valid))


# ---------------------------------------------------------------------------
# dataset catalog
# ---------------------------------------------------------------------------

@dataclass
class FlowDataset:
    """Index of (image1, image2, flow) sample paths + lazy loading
    (datasets.py:18-100 semantics without the torch Dataset base).

    ``sparse`` datasets return (img1, img2, flow, valid); dense ones
    derive valid = |flow| < 1000 (datasets.py:84-88).
    """
    image_list: List[Tuple[str, str]] = field(default_factory=list)
    flow_list: List[str] = field(default_factory=list)
    sparse: bool = False
    augmentor: Optional[FlowAugmentor] = None

    def __len__(self):
        return len(self.image_list)

    def __getitem__(self, index):
        index = index % len(self.image_list)
        valid = None
        if self.sparse:
            flow, valid = read_flow_kitti(self.flow_list[index])
        else:
            flow = np.asarray(read_gen(self.flow_list[index]), np.float32)
        img1 = np.asarray(read_gen(self.image_list[index][0]), np.uint8)
        img2 = np.asarray(read_gen(self.image_list[index][1]), np.uint8)
        if img1.ndim == 2:                      # grayscale -> 3ch
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1, img2 = img1[..., :3], img2[..., :3]
        flow = np.asarray(flow, np.float32)
        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(
                    img1, img2, flow, valid)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        return (img1.astype(np.float32), img2.astype(np.float32),
                flow, valid.astype(np.float32))


def _pairs(frames: Sequence[str]) -> List[Tuple[str, str]]:
    return [(frames[i], frames[i + 1]) for i in range(len(frames) - 1)]


def mpi_sintel(root: str, split: str = "training", dstype: str = "clean",
               aug_params: Optional[dict] = None) -> FlowDataset:
    """datasets.py:102-119: consecutive frames per scene + .flo files."""
    ds = FlowDataset(augmentor=_make_aug(aug_params, sparse=False))
    image_root = osp.join(root, split, dstype)
    flow_root = osp.join(root, split, "flow")
    for scene in sorted(glob(osp.join(image_root, "*"))):
        frames = sorted(glob(osp.join(scene, "*.png")))
        ds.image_list += _pairs(frames)
        if split != "test":
            ds.flow_list += sorted(glob(osp.join(
                flow_root, osp.basename(scene), "*.flo")))
    return ds


def flying_chairs(root: str, split: str = "train",
                  aug_params: Optional[dict] = None,
                  split_file: Optional[str] = None) -> FlowDataset:
    """datasets.py:121-135: ppm pairs + .flo, train/val via split ids."""
    ds = FlowDataset(augmentor=_make_aug(aug_params, sparse=False))
    images = sorted(glob(osp.join(root, "*.ppm")))
    flows = sorted(glob(osp.join(root, "*.flo")))
    assert len(images) // 2 == len(flows)
    if split_file is not None and osp.exists(split_file):
        split_ids = np.loadtxt(split_file, dtype=np.int32)
    else:
        split_ids = np.ones((len(flows),), np.int32)   # all train
    want = 1 if split == "train" else 2
    for i, fl in enumerate(flows):
        if split_ids[i] == want:
            ds.flow_list.append(fl)
            ds.image_list.append((images[2 * i], images[2 * i + 1]))
    return ds


def flying_things(root: str, dstype: str = "frames_cleanpass",
                  aug_params: Optional[dict] = None) -> FlowDataset:
    """datasets.py:137-159: TRAIN split, both flow directions."""
    ds = FlowDataset(augmentor=_make_aug(aug_params, sparse=False))
    for cam in ("left",):
        for direction in ("into_future", "into_past"):
            image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
            image_dirs = [osp.join(d, cam) for d in image_dirs]
            flow_dirs = sorted(glob(osp.join(root, "optical_flow",
                                             "TRAIN/*/*")))
            flow_dirs = [osp.join(d, direction, cam) for d in flow_dirs]
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(glob(osp.join(idir, "*.png")))
                flows = sorted(glob(osp.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        ds.image_list.append((images[i], images[i + 1]))
                        ds.flow_list.append(flows[i])
                    else:
                        ds.image_list.append((images[i + 1], images[i]))
                        ds.flow_list.append(flows[i + 1])
    return ds


def kitti(root: str, split: str = "training",
          aug_params: Optional[dict] = None) -> FlowDataset:
    """datasets.py:161-178: png16 sparse flow."""
    ds = FlowDataset(sparse=True, augmentor=_make_aug(aug_params, True))
    root = osp.join(root, split)
    images1 = sorted(glob(osp.join(root, "image_2/*_10.png")))
    images2 = sorted(glob(osp.join(root, "image_2/*_11.png")))
    ds.image_list = list(zip(images1, images2))
    if split == "training":
        ds.flow_list = sorted(glob(osp.join(root, "flow_occ/*_10.png")))
    return ds


def hd1k(root: str, aug_params: Optional[dict] = None) -> FlowDataset:
    """datasets.py:180-197: png16 sparse flow, sequential pairs."""
    ds = FlowDataset(sparse=True, augmentor=_make_aug(aug_params, True))
    seq_ix = 0
    while True:
        flows = sorted(glob(osp.join(root, "hd1k_flow_gt",
                                     "flow_occ/%06d_*.png" % seq_ix)))
        images = sorted(glob(osp.join(root, "hd1k_input",
                                      "image_2/%06d_*.png" % seq_ix)))
        if not flows:
            break
        ds.flow_list += flows[:-1] if len(flows) > 1 else flows
        ds.image_list += _pairs(images)
        seq_ix += 1
    return ds


def _make_aug(aug_params: Optional[dict], sparse: bool):
    if aug_params is None:
        return None
    cls = SparseFlowAugmentor if sparse else FlowAugmentor
    return cls(**aug_params)


# ---------------------------------------------------------------------------
# batching (the fetch_dataloader analog, datasets.py:199-235)
# ---------------------------------------------------------------------------

def concat_datasets(datasets: Sequence[FlowDataset],
                    repeats: Sequence[int] | None = None) -> FlowDataset:
    """The reference scales dataset mix by integer multiplication
    (100*sintel + things + 200*kitti + ...); same idea, explicit."""
    out = FlowDataset(sparse=all(d.sparse for d in datasets))
    repeats = repeats or [1] * len(datasets)
    for d, r in zip(datasets, repeats):
        out.image_list += d.image_list * r
        out.flow_list += d.flow_list * r
    # mixing sparse+dense loses augmentors; per-sample augment instead
    out.augmentor = datasets[0].augmentor if len(
        {id(d.augmentor) for d in datasets}) == 1 else datasets[0].augmentor
    return out


def make_batch_iterator(ds: FlowDataset, batch_size: int, *,
                        seed: int = 0, shuffle: bool = True,
                        drop_last: bool = True
                        ) -> Iterator[dict]:
    """Yield dict batches of stacked float32 arrays:
    {'image1': [B,H,W,3] 0..255, 'image2': ..., 'flow': [B,H,W,2],
    'valid': [B,H,W]} — NHWC, static shapes (crop-size augmentor
    required for stacking heterogeneous datasets)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(ds))
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size and drop_last:
                continue
            samples = [ds[j] for j in idx]
            yield {
                "image1": np.stack([s[0] for s in samples]),
                "image2": np.stack([s[1] for s in samples]),
                "flow": np.stack([s[2] for s in samples]),
                "valid": np.stack([s[3] for s in samples]),
            }
