"""Port: the CLI's ``--dp`` and ``--sp`` on world-2 gloo ranks against
the world-1 runs of the same argv, on the CPU.

The ranks are spawned processes (``tests/torch_parallel_ranks.py``,
``cli_runs``) on a process group the harness initialised, which the CLI
takes as it would take torchrun's; they run while this process makes the
world-1 runs. ``pixel-inpaint --frame-batch 4 --dp 2`` (rank 0 writes)
and ``keyframe-inpaint --sp 2`` (every rank in a workspace of its own)
on the tiny checkpoints of ``tests/torch_ckpt_common.py``: the same
files as the run without the flag, every converted_ / AI frame at >= 40
dB of it (a call's batch, and with sp the row halos, change the CPU's
f32 rounding, so the files need not be byte-equal).
"""

import os

import numpy as np
import pytest

import torch_port_common  # noqa: F401  (torch on two threads)
from sd_animation_optical_flow_tpu_torch import cli
from sd_animation_optical_flow_tpu_torch.utils.images import read_png_bgr
from torch_ckpt_common import write_tiny_files
from torch_parallel_ranks import Ranks, _files


def _argvs(tiny):
    common = ["-i", tiny["video"], "--spec", tiny["spec"],
              "--inpaint-spec", tiny["spec9"], "--ckpt", tiny["ckpt"],
              "--inpaint-ckpt", tiny["ckpt9"], "--raft-ckpt", tiny["raft"],
              "--width", "64", "--height", "64", "--ddim-steps", "6",
              "--flow-iters", "2", "--device", "cpu"]
    return {"pixel": ["pixel-inpaint", *common, "--keep-every", "3",
                      "--denoising-strength", "0.3", "--frame-batch", "4"],
            "keyframe": ["keyframe-inpaint", *common, "--keep-every", "2",
                         "--kernel-size", "6", "--stride", "6",
                         "--denoising-strength", "0.3", "--level-batch",
                         "1", "--mode", "warp_and_inpaint"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_ranks")
    tiny = write_tiny_files(tmp / "tiny")
    if tiny["video"] is None:
        pytest.skip("no cv2 video encoder available")
    argv = _argvs(tiny)
    ranks = Ranks(2, tmp / "w2", ["cli_runs"],
                  {"cli": {**argv, "dir": str(tmp / "ranks")}})
    one = {"pixel": _files(cli.main(argv["pixel"]
                                    + ["-o", str(tmp / "one/pixel")]))}
    cli.main(argv["keyframe"] + ["-o", str(tmp / "one/kf")])
    one["keyframe"] = _files(str(tmp / "one/kf/ai-frames"))
    return ranks.results()["cli_runs"], one


def _psnr_files(got, want, prefix):
    """The same names; PSNR (peak 255) of each ``prefix`` file."""
    assert got is not None and sorted(got) == sorted(want)
    out = {}
    for name in want:
        if name.startswith(prefix):
            a, b = (read_png_bgr_bytes(x) for x in (got[name], want[name]))
            mse = np.mean((a.astype(np.float64) - b) ** 2)
            out[name] = np.inf if mse == 0 else 10 * np.log10(255 ** 2
                                                              / mse)
    return out


def read_png_bgr_bytes(data):
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".png") as f:
        f.write(data)
        f.flush()
        return read_png_bgr(f.name)


def test_cli_dp_writes_the_world_one_files(runs):
    ranks, one = runs
    assert ranks[1]["pixel"] is None          # rank 0 alone writes
    psnr = _psnr_files(ranks[0]["pixel"], one["pixel"], "converted_")
    assert len(psnr) == 4
    assert all(v >= 40.0 for v in psnr.values()), psnr


def test_cli_sp_matches_the_world_one_run(runs):
    ranks, one = runs
    for r in (0, 1):
        psnr = _psnr_files(ranks[r]["keyframe"], one["keyframe"], "")
        assert len(psnr) == 6
        assert all(v >= 40.0 for v in psnr.values()), (r, psnr)
