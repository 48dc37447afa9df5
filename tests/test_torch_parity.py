"""Port parity: ``utils/parity.py`` (the warped-region PSNR of the 40 dB
gate) against the JAX module on the CPU, on directories the test writes:
the same report, with the port reading every file without cv2."""

import json
import os

import cv2
import numpy as np
import pytest

from sd_animation_optical_flow_tpu.utils import parity as JP
from sd_animation_optical_flow_tpu_torch.utils import images as TIM
from sd_animation_optical_flow_tpu_torch.utils import parity as TP


def test_psnr_matches_jax(np_rng):
    """psnr with and without a mask, an empty mask (nan) and identical
    images (inf)."""
    a = np_rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    b = np.clip(a + np_rng.normal(0, 4, a.shape), 0, 255).astype(np.uint8)
    mask = np_rng.uniform(size=a.shape) < 0.3
    for m in (None, mask):
        assert TP.psnr(a, b, m) == JP.psnr(a, b, m)
    assert np.isnan(TP.psnr(a, b, np.zeros(a.shape, bool)))
    assert TP.psnr(a, a) == float("inf") == JP.psnr(a, a)


def test_gray_matches_cv2_imread(np_rng, tmp_path):
    """A colour PNG read as gray: cv2.imread(IMREAD_GRAYSCALE)'s values
    (libpng's fixed-point conversion); a gray PNG's own values."""
    color = np_rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    gray = np_rng.integers(0, 256, (40, 50), dtype=np.uint8)
    for img in (color, gray):
        path = str(tmp_path / "c.png")
        cv2.imwrite(path, img)
        assert np.array_equal(TP._gray(TIM.read_png_bgr(path)),
                              cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _write_dirs(root, rng):
    """ours/ and ref/ as a pipeline run and its reference would leave
    them: frames 0-4 in both, 5 only in ours; frame 0 identical, 1-2
    noisy inside and outside the warped region, 3 of another shape in
    ref, 4 unreadable in ref; gray confidence maps (frame 2's written as
    colour, frame 1's missing) and cv2- and port-written files."""
    ours, ref = root / "ours", root / "ref"
    ours.mkdir()
    ref.mkdir()
    for i in range(6):
        img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        TIM.write_png(str(ours / f"converted_{i:06d}.png"), img)
        if i == 5:
            continue
        if i == 3:
            other = rng.integers(0, 256, (16, 32, 3), dtype=np.uint8)
            cv2.imwrite(str(ref / f"converted_{i:06d}.png"), other)
        elif i == 4:
            (ref / f"converted_{i:06d}.png").write_bytes(b"not a png")
        else:
            noisy = img if i == 0 else np.clip(
                img + rng.normal(0, 3 * i, img.shape), 0, 255
            ).astype(np.uint8)
            cv2.imwrite(str(ref / f"converted_{i:06d}.png"), noisy)
        conf = rng.integers(200, 256, (24, 32), dtype=np.uint8)
        if i == 2:
            cv2.imwrite(str(ours / f"pixel_confidence_{i:06d}.png"),
                        np.stack([conf, conf // 2 + 120, conf], -1))
        elif i != 1:
            TIM.write_png(str(ours / f"pixel_confidence_{i:06d}.png"), conf)
    return str(ours), str(ref)


@pytest.mark.parametrize("conf_thres", [242, 230])
def test_compare_dirs_matches_jax(np_rng, tmp_path, conf_thres):
    """compare_dirs' report equals JAX's: pairs, per-frame PSNR and
    warped share, the unreadable and mismatched frames, the mean, the
    min and the gate."""
    ours, ref = _write_dirs(tmp_path, np_rng)
    assert [p.index for p in TP.collect_pairs(ours, ref)] == \
        [p.index for p in JP.collect_pairs(ours, ref)] == [0, 1, 2, 3, 4]
    got = TP.compare_dirs(ours, ref, conf_thres=conf_thres)
    want = JP.compare_dirs(ours, ref, conf_thres=conf_thres)
    assert got == want
    assert got["per_frame"][3]["psnr"] is None and \
        got["per_frame"][4]["psnr"] is None and not got["gate_40db"]
    assert got["per_frame"][0]["psnr"] == float("inf")


def test_main_prints_the_report(np_rng, tmp_path, capsys):
    """The command line prints compare_dirs' report as JSON."""
    ours, ref = _write_dirs(tmp_path, np_rng)
    TP.main([ours, ref, "--conf-thres", "230"])
    printed = json.loads(capsys.readouterr().out)
    want = TP.compare_dirs(ours, ref, conf_thres=230)
    assert printed == json.loads(json.dumps(want))
    assert os.path.basename(ours) == "ours"
