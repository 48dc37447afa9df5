"""Port parity: the host-side training data modules — ``utils/flow_io.py``,
``training/flow_data.py`` and ``training/degradation.py`` — against the
JAX package's on the same inputs, made from a seed, with equal
``np.random.Generator`` seeds on both sides. Both are numpy / cv2 code,
so every array must be equal (no tolerance): a file written by one side
is read by the other, and an augmentation or degradation chain draws the
same numbers in the same order."""

import numpy as np
import pytest
from PIL import Image

from sd_animation_optical_flow_tpu.training import degradation as JDG
from sd_animation_optical_flow_tpu.training import flow_data as JFD
from sd_animation_optical_flow_tpu.utils import flow_io as JIO
from sd_animation_optical_flow_tpu_torch.training import degradation as TDG
from sd_animation_optical_flow_tpu_torch.training import flow_data as TFD
from sd_animation_optical_flow_tpu_torch.utils import flow_io as TIO


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _flow(rng, h, w):
    return rng.uniform(-8, 8, (h, w, 2)).astype(np.float32)


def _equal(a, b):
    """Nested tuples / dicts / arrays, equal element for element."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# flow_io: each side reads what the other wrote
# ---------------------------------------------------------------------------

def _flo_data(rng):
    return _flow(rng, 12, 17)


def _pfm_data(rng):
    return rng.standard_normal((9, 14, 3)).astype(np.float32)


def _kitti_data(rng):
    # KITTI stores 64 * flow + 2^15 as uint16: whole 64ths survive
    return np.round(_flow(rng, 10, 15) * 64) / 64


FORMATS = {
    "flo": (_flo_data, "write_flo", lambda io, p: io.read_flo(p)),
    "pfm": (_pfm_data, "write_pfm", lambda io, p: io.read_pfm(p)),
    "kitti": (_kitti_data, "write_flow_kitti",
              lambda io, p: io.read_flow_kitti(p)),
    "read_gen_flo": (_flo_data, "write_flo", lambda io, p: io.read_gen(p)),
}
EXT = {"flo": "flo", "pfm": "pfm", "kitti": "png", "read_gen_flo": "flo"}


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_flow_io_round_trips_across(tmp_path, fmt, writer, reader):
    make, write, read = FORMATS[fmt]
    io = {"port": TIO, "jax": JIO}
    data = make(np.random.default_rng(len(fmt)))
    path = str(tmp_path / f"f.{EXT[fmt]}")
    getattr(io[writer], write)(path, data)
    got = read(io[reader], path)
    _equal(got, read(io[writer], path))
    back = got[0] if isinstance(got, tuple) else got
    np.testing.assert_array_equal(np.asarray(back)[..., :data.shape[-1]],
                                  data)


def test_read_gen_images_and_refusals(tmp_path):
    rng = np.random.default_rng(4)
    img = _img(rng, 11, 13)
    Image.fromarray(img).save(tmp_path / "a.png")
    _equal(TIO.read_gen(str(tmp_path / "a.png")), img)
    _equal(TIO.read_gen(str(tmp_path / "a.png")),
           JIO.read_gen(str(tmp_path / "a.png")))
    with pytest.raises(ValueError, match="extension"):
        TIO.read_gen(str(tmp_path / "a.xyz"))
    (tmp_path / "bad.flo").write_bytes(np.float32(1.0).tobytes() * 4)
    with pytest.raises(ValueError, match="magic"):
        TIO.read_flo(str(tmp_path / "bad.flo"))


# ---------------------------------------------------------------------------
# flow_data: jitter, augmentors, the dataset catalog, batching
# ---------------------------------------------------------------------------

AUG = dict(crop_size=(32, 48))


def _pair(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    return _img(rng, h, w), _img(rng, h, w), _flow(rng, h, w)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("which", ["jitter", "dense", "sparse"])
def test_augmentors_match_jax(which, seed):
    """The same draws from equal generators: ``color_jitter`` (every op
    order comes up over the seeds), ``FlowAugmentor`` and
    ``SparseFlowAugmentor`` (a random validity mask) on the same pair."""
    img1, img2, flow = _pair(seed)
    valid = (np.random.default_rng(seed + 9).random(flow.shape[:2])
             > 0.3).astype(np.float32)
    outs = []
    for FD in (TFD, JFD):
        rng = np.random.default_rng(100 + seed)
        if which == "jitter":
            outs.append(FD.color_jitter(img1, rng))
        elif which == "dense":
            outs.append(FD.FlowAugmentor(**AUG)(img1, img2, flow, rng))
        else:
            outs.append(FD.SparseFlowAugmentor(**AUG)(img1, img2, flow,
                                                      valid, rng))
    _equal(*outs)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Synthetic FlyingChairs, KITTI and Sintel trees (the layouts of
    ``tests/test_flow_data.py`` and RAFT's catalog)."""
    root = tmp_path_factory.mktemp("flow_trees")
    rng = np.random.default_rng(0)
    chairs = root / "chairs"
    chairs.mkdir()
    for i in range(4):
        Image.fromarray(_img(rng, 64, 96)).save(chairs / f"{i:05d}_img1.ppm")
        Image.fromarray(_img(rng, 64, 96)).save(chairs / f"{i:05d}_img2.ppm")
        JIO.write_flo(str(chairs / f"{i:05d}_flow.flo"), _flow(rng, 64, 96))
    kitti = root / "KITTI" / "training"
    (kitti / "image_2").mkdir(parents=True)
    (kitti / "flow_occ").mkdir()
    for i in range(2):
        for f in (10, 11):
            Image.fromarray(_img(rng, 40, 60)).save(
                kitti / "image_2" / f"{i:06d}_{f}.png")
        JIO.write_flow_kitti(str(kitti / "flow_occ" / f"{i:06d}_10.png"),
                             _flow(rng, 40, 60))
    for scene in ("alley", "bamboo"):
        img_dir = root / "sintel" / "training" / "clean" / scene
        flo_dir = root / "sintel" / "training" / "flow" / scene
        img_dir.mkdir(parents=True)
        flo_dir.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(_img(rng, 24, 40)).save(
                img_dir / f"frame_{i:04d}.png")
            if i < 2:
                JIO.write_flo(str(flo_dir / f"frame_{i:04d}.flo"),
                              _flow(rng, 24, 40))
    return {"chairs": (str(chairs),), "kitti": (str(root / "KITTI"),),
            "sintel": (str(root / "sintel"),)}


CATALOG = {"chairs": "flying_chairs", "kitti": "kitti",
           "sintel": "mpi_sintel"}


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_datasets_match_jax(trees, name):
    """The index (paths, sparse flag) and every sample, unaugmented."""
    ds = [getattr(FD, CATALOG[name])(*trees[name]) for FD in (TFD, JFD)]
    assert len(ds[0]) == len(ds[1]) > 0
    assert ds[0].image_list == ds[1].image_list
    assert ds[0].flow_list == ds[1].flow_list
    assert ds[0].sparse == ds[1].sparse
    for i in range(len(ds[0])):
        _equal(ds[0][i], ds[1][i])


def test_batches_and_mixes_match_jax(trees):
    """``make_batch_iterator``'s first batches (seeded shuffle) on an
    augmenting Chairs dataset whose augmentor both sides replace by one
    with a fixed generator, and ``concat_datasets``' index."""
    batches = []
    for FD in (TFD, JFD):
        ds = FD.flying_chairs(*trees["chairs"], aug_params=AUG)
        aug, rng = ds.augmentor, np.random.default_rng(5)
        ds.augmentor = lambda a, b, f: aug(a, b, f, rng)
        it = FD.make_batch_iterator(ds, batch_size=2, seed=3)
        batches.append([next(it) for _ in range(3)])
        mix = FD.concat_datasets([ds, FD.kitti(*trees["kitti"])],
                                 repeats=[2, 1])
        batches[-1].append((mix.image_list, mix.flow_list, mix.sparse))
    assert batches[0][0]["image1"].shape == (2, 32, 48, 3)
    _equal(*batches)


# ---------------------------------------------------------------------------
# degradation
# ---------------------------------------------------------------------------

def _hq(seed, h=96, w=96):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


DEGRADE = {
    "bsrgan_sf4": lambda DG, img, rng: DG.degradation_bsrgan(
        img, rng, DG.DegradationConfig(sf=4, lq_patchsize=16)),
    "bsrgan_sf2": lambda DG, img, rng: DG.degradation_bsrgan(
        img, rng, DG.DegradationConfig(sf=2, lq_patchsize=16)),
    "light": lambda DG, img, rng: DG.degradation_bsrgan_light(img, rng),
    "light_up": lambda DG, img, rng: DG.degradation_bsrgan_light(
        img, rng, up=True),
    "blur": lambda DG, img, rng: DG.add_blur(img, rng),
    "resize": lambda DG, img, rng: DG.add_resize(img, rng),
    "gaussian": lambda DG, img, rng: DG.add_gaussian_noise(img, rng),
    "poisson": lambda DG, img, rng: DG.add_poisson_noise(img, rng),
    "speckle": lambda DG, img, rng: DG.add_speckle_noise(img, rng),
    "jpeg": lambda DG, img, rng: DG.add_jpeg_noise(img, rng),
    "sharpen": lambda DG, img, rng: DG.add_sharpening(img),
    "crop": lambda DG, img, rng: DG.random_crop_pair(
        img[::4, ::4], img, rng, 4, 8),
    "kernels": lambda DG, img, rng: (
        DG.isotropic_gaussian_kernel(11, 2.0),
        DG.anisotropic_gaussian_kernel(15, 0.7, 9.0, 1.0)),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", sorted(DEGRADE))
def test_degradations_match_jax(name, seed):
    """The same image and generator seed: equal arrays (the pipelines'
    shuffled chains, each degradation, the crop and the kernels)."""
    img = _hq(seed, 64, 64) if name.startswith("light") else _hq(seed)
    outs = [DEGRADE[name](DG, img, np.random.default_rng(10 + seed))
            for DG in (TDG, JDG)]
    _equal(*outs)
