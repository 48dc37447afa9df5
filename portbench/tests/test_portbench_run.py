"""The harness end to end at a tiny size on the CPU (the program's and
the reference's f32 paths), the control and each planted fault of
``harness/faults.py`` coming out as not correct, the no-card exit and
the JAX check by whole top-level name."""

import json
import subprocess
import sys
from unittest import mock

import pytest
import torch

from portbench import run as RUN
from portbench.drivers.pixel import Driver
from portbench.harness import faults as FAULTS
from portbench.harness.manifest import ROOT
from portbench.tests.tiny import tiny_cell

SEED = 4_000_000_123


def _run(tmp_path, seed=SEED):
    cell = tiny_cell()
    drv = Driver(cell, seed, "cpu", tmp_path)
    drv.setup()
    rec = drv.window(0.0, trace=True)
    rec.extra.update(setup_s=1.0, memory_peak_bytes=1)
    drv.release()
    checks = drv.check()
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 1}
    return RUN.result_line(cell, rec, checks, True, dev), checks


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    torch.set_num_threads(4)
    return _run(tmp_path_factory.mktemp("sound"))


def test_tiny_run_is_correct_and_parses(sound):
    res, checks = sound
    line = json.loads(json.dumps(res))
    assert line["correct"] is True, checks
    assert line["attempted"] == 5 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"key_rms", "inpaint_rms", "flow_epe",
                                   "conf_mae"}


def test_control_is_not_correct(tmp_path):
    drv = Driver(tiny_cell(), SEED + 1, "cpu", tmp_path)
    checks = drv.control()
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("name,rows", [
    ("pixel-pan16-b8", list(range(15)) + [-1]),
    ("pixel-cuts4-b8", sum(([j, j + 1, j + 2] + [-1] * 5
                            for j in range(0, 12, 3)), [])),
])
def test_flow_pairs_map_to_their_frames(tmp_path, name, rows):
    """The kept flows' rows: run_batched's pairs in call order, padded
    pairs dropped."""
    from portbench.harness.manifest import load_cell
    from portbench.harness.traffic import key_flags
    cell = load_cell(name)
    drv = Driver(cell, SEED, "cpu", tmp_path)
    drv.flags = key_flags(cell.traffic)
    assert drv.pair_rows() == rows


@pytest.mark.parametrize("fault", FAULTS.NAMES)
def test_fault_is_not_correct(tmp_path, fault):
    with FAULTS.plant(fault, tiny_cell().traffic["clip_frames"]):
        res, checks = _run(tmp_path, SEED + 2)
    assert res["correct"] is False, checks


def test_no_card_exits_nonzero_without_a_result():
    out = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                          "--workload", "pixel-pan16-b8", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names():
    fake = {"sd_animation_optical_flow_tpu_torch.ops": object(),
            "jaxtyping": object()}
    with mock.patch.dict(sys.modules, fake):
        assert RUN.forbidden_modules() == [] or \
            set(RUN.forbidden_modules()) <= set(RUN.FORBIDDEN)
        assert "sd_animation_optical_flow_tpu" not in RUN.forbidden_modules()
    with mock.patch.dict(sys.modules, {"sd_animation_optical_flow_tpu.x":
                                       object()}):
        assert "sd_animation_optical_flow_tpu" in RUN.forbidden_modules()


def test_run_imports_no_jax():
    """Everything a run imports, in a fresh process: no JAX module, by
    whole top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.run as R\n"
        "from portbench.harness.manifest import load_cell, metric_reader\n"
        "import json\n"
        "man = json.load(open(%r))\n"
        "for w in man['workloads']:\n"
        "    c = load_cell(w['name']); c.driver()\n"
        "    [metric_reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "import portbench.readings\n"
        "from sd_animation_optical_flow_tpu_torch.pipelines import "
        "pixel_inpaint\n"
        "from sd_animation_optical_flow_tpu_torch import config\n"
        "from sd_animation_optical_flow_tpu_torch.utils import jax_params\n"
        "print(json.dumps(R.forbidden_modules()))\n"
        % (str(ROOT), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
