"""Port parity: specs, checkpoint-built bundles and the CLI
(``config.py``, ``cli.py``) against the JAX package on the CPU.

* ``load_spec`` equals JAX's field by field for ``configs/sd15.yaml``,
  ``configs/sd15_inpaint9.yaml`` and a YAML in the reference's OmegaConf
  schema; ``BundleSpec.build(state_dict=)`` gives the JAX bundle's trees
  bit for bit in float32 and prints the same missing-key line.
* The parser: the same subcommands, flags and defaults as JAX's, plus
  ``--device``; the defaults equal the library's; ``--sampler`` is
  checked at the parser.
* Each subcommand, with its library calls replaced by mocks in both
  CLIs, hands the same config fields and arguments to the same library
  functions for the same argv.
* End to end on tiny reference-named checkpoints (``tests/torch_ckpt_
  common.py``): ``pixel-inpaint`` on an encoded clip writes the JAX CLI's
  files, every ``converted_*.png`` at >= 40 dB of JAX's (the port fed
  the JAX program's noises, as ``tests/test_torch_pixel.py`` does);
  ``port`` writes JAX's npz files, equal key by key; and, in a
  subprocess where cv2, PIL, yaml, safetensors, transformers, jax and the
  JAX package cannot be imported, ``--help`` and ``txt2img --device
  cpu`` on a ``.ckpt``.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu import cli as JCLI
from sd_animation_optical_flow_tpu import config as JC
from sd_animation_optical_flow_tpu_torch import cli as TCLI
from sd_animation_optical_flow_tpu_torch import config as TC
from sd_animation_optical_flow_tpu_torch.utils import images as TIM
from test_torch_pixel import _converted_psnr, _jax_noises
from test_torch_port_weights import _from_jax, assert_tree_equal
from torch_ckpt_common import write_tiny_files

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# specs and bundles
# ---------------------------------------------------------------------------

REFERENCE_YAML = """
model:
  target: guided_ldm.GuidedLDM
  params:
    linear_start: 0.00085
    linear_end: 0.012
    timesteps: 1000
    scale_factor: 0.18215
    conditioning_key: hybrid
    unet_config:
      target: ldm.modules.diffusionmodules.openaimodel.UNetModel
      params:
        in_channels: 9
        out_channels: 4
        model_channels: 320
        attention_resolutions: [4, 2, 1]
        num_res_blocks: 2
        channel_mult: [1, 2, 4, 4]
        num_heads: 8
        context_dim: 768
    first_stage_config:
      target: ldm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ddconfig: {ch: 128, ch_mult: [1, 2, 4, 4], num_res_blocks: 2,
                   z_channels: 4, in_channels: 3, out_ch: 3}
    cond_stage_config:
      target: ldm.modules.encoders.modules.FrozenCLIPEmbedder
"""


@pytest.mark.parametrize("name", ["sd15.yaml", "sd15_inpaint9.yaml",
                                  "reference"])
def test_load_spec_matches_jax(name, tmp_path):
    if name == "reference":
        path = tmp_path / "ref.yaml"
        path.write_text(REFERENCE_YAML)
    else:
        path = Path(TC.CONFIG_DIR) / name
        assert path.exists()
    want = dataclasses.asdict(JC.load_spec(str(path)))
    got = TC.load_spec(str(path))
    assert dataclasses.asdict(got) == want
    # tuples, as the builtins hold them
    assert got.unet.attention_resolutions == (4, 2, 1)
    builtin = TC.SD15 if name == "sd15.yaml" else TC.SD15_INPAINT9
    assert got == builtin


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny specs and checkpoints, a RAFT checkpoint and an encoded
    12-frame clip (``torch_ckpt_common.write_tiny_files``)."""
    paths = write_tiny_files(tmp_path_factory.mktemp("tiny"))
    if paths["video"] is None:
        pytest.skip("no cv2 video encoder available")
    return paths


def test_build_from_state_dict_matches_jax(tiny, capsys):
    """The tiny spec built from its checkpoint, with two keys dropped:
    JAX's UNet / VAE / CLIP trees bit for bit (None for the missing
    conv weight) and JAX's missing-key line."""
    from sd_animation_optical_flow_tpu_torch.utils.port_weights import \
        load_state_dict
    sd = {k: v.float().numpy() for k, v in load_state_dict(tiny["ckpt"])
          .items() if v.is_floating_point()}
    del sd["first_stage_model.decoder.conv_in.weight"]
    del sd["model.diffusion_model.out.2.bias"]
    jb = JC.load_spec(tiny["spec"]).build(state_dict=sd)
    jline = capsys.readouterr().out
    tb = TC.load_spec(tiny["spec"]).build(state_dict=sd, device="cpu")
    tline = capsys.readouterr().out
    assert tline == jline and "2 keys missing" in tline
    for name in ("unet_params", "vae_params", "clip_params"):
        assert_tree_equal(_from_jax(getattr(jb, name)), getattr(tb, name))
    assert tb.vae_params["decoder"]["conv_in"]["w"] is None
    assert tb.vae_cfg == TC.load_spec(tiny["spec"]).vae


def test_create_model_from_ckpt(tiny):
    """create_model(path, ckpt_path=) in bf16: the checkpoint's float16
    values through float32 to bfloat16, on the asked device."""
    from sd_animation_optical_flow_tpu_torch.utils.port_weights import \
        load_state_dict
    b = TC.create_model(tiny["spec9"], tiny["ckpt9"], dtype=torch.bfloat16,
                        device="cpu")
    assert b.unet_cfg.in_channels == 9 and b.device.type == "cpu"
    w = b.unet_params["input_blocks"][0]["conv"]["w"]
    raw = load_state_dict(tiny["ckpt9"])[
        "model.diffusion_model.input_blocks.0.0.weight"]
    assert w.dtype == torch.bfloat16 and w.shape == (32, 9, 3, 3)
    assert torch.equal(w, raw.float().to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _jax_parser():
    """The JAX CLI's parser, caught at its parse_args."""
    box = {}

    def grab(self, *a, **k):
        box["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            JCLI.main([])
    return box["parser"]


def _subparsers(parser):
    (act,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return act.choices


def _flags(sub):
    """{dest: (option strings, default, required, nargs, const, choices,
    type, action class)} of a subcommand's parser."""
    return {a.dest: (tuple(a.option_strings), a.default, a.required,
                     a.nargs, a.const, a.choices, a.type, type(a).__name__)
            for a in sub._actions if a.dest != "help"}


SUBCOMMANDS = ["pixel-inpaint", "verify-parity", "ofgen", "keyframe-inpaint",
               "depth2img", "upscale", "txt2img", "port",
               "train-uncertainty"]


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_parser_matches_jax_plus_device(cmd):
    jsubs, tsubs = _subparsers(_jax_parser()), _subparsers(
        TCLI.build_parser())
    assert sorted(tsubs) == sorted(jsubs) == sorted(SUBCOMMANDS)
    want, got = _flags(jsubs[cmd]), _flags(tsubs[cmd])
    device = got.pop("device")
    assert device[:2] == (("--device",), "cuda")
    if "sampler" in want:
        # the port checks --sampler at the parser
        assert want["sampler"][6] is None and got["sampler"][6] is not None
        want["sampler"] = want["sampler"][:6]
        got["sampler"] = got["sampler"][:6]
    assert got == want
    assert jsubs[cmd].get_default("fn").__name__ \
        == tsubs[cmd].get_default("fn").__name__


def test_cli_defaults_match_library_defaults():
    """The CLI's flow and pipeline defaults equal the port's dataclass
    defaults, as JAX's test_cli_defaults_match_library_defaults holds its
    own."""
    from sd_animation_optical_flow_tpu_torch.models.flowconf import \
        FlowConfidenceConfig
    from sd_animation_optical_flow_tpu_torch.models.raft import RAFTConfig
    from sd_animation_optical_flow_tpu_torch.pipelines import \
        pixel_inpaint as PI
    from sd_animation_optical_flow_tpu_torch.pipelines.keyframe_inpaint \
        import KeyframeInpaintConfig

    args = TCLI.build_parser().parse_args(["pixel-inpaint", "-i", "in.mp4",
                                           "-o", "out"])
    assert RAFTConfig().corr_dtype == args.flow_corr_dtype == "bfloat16"
    assert FlowConfidenceConfig().uncertainty == args.flow_uncertainty
    assert RAFTConfig().iters == args.flow_iters
    assert KeyframeInpaintConfig().flow_batch == 8
    cfg, lib = TCLI.pixel_inpaint_config(args), PI.PixelInpaintConfig()
    for f in ("keep_every", "key_frame_thres", "denoising_strength",
              "confidence_thres", "propagated_pixel_weight", "ddim_steps",
              "seed", "prompt_extra", "frame_batch", "sampler",
              "cfg_interval", "deepcache_interval", "dp"):
        assert getattr(cfg, f) == getattr(lib, f), f
    assert cfg.size == (512, 768)


@pytest.mark.parametrize("sampler,ok", [("ddim", True), ("dpmpp", True),
                                        ("dpmpp:10", True), ("dpm", False),
                                        ("dpmpp:0", False),
                                        ("dpmpp:x", False)])
def test_sampler_checked_at_the_parser(sampler, ok, capsys):
    argv = ["pixel-inpaint", "-i", "a", "-o", "b", "--sampler", sampler]
    if ok:
        assert TCLI.build_parser().parse_args(argv).sampler == sampler
    else:
        with pytest.raises(SystemExit) as e:
            TCLI.build_parser().parse_args(argv)
        assert e.value.code == 2
        assert "unknown sampler" in capsys.readouterr().err


def test_dp_requires_frame_batch_before_any_model():
    with mock.patch.object(TCLI, "_build_models") as build:
        with pytest.raises(SystemExit):
            TCLI.main(["pixel-inpaint", "-i", "a", "-o", "b", "--dp", "2",
                       "--device", "cpu"])
        build.assert_not_called()
    with pytest.raises(SystemExit, match="torchrun"):
        TCLI.main(["pixel-inpaint", "-i", "a", "-o", "b", "--dp", "2",
                   "--frame-batch", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# each subcommand's library calls, mocked in both CLIs
# ---------------------------------------------------------------------------

class _Obj(SimpleNamespace):
    """A stand-in object, compared by its label."""


def _stand_ins():
    b = lambda label: _Obj(label=label, device=torch.device("cpu"),
                           unet_params=_Obj(label=label + ".unet"),
                           vae_params=_Obj(label=label + ".vae"),
                           clip_params=_Obj(label=label + ".clip"))
    return {
        "_build_models": (b("sd"), b("sd9"), _Obj(label="est"),
                          _Obj(label="tagger")),
        "config.create_model": b("bundle"),
        "pipelines.pixel_inpaint.run_video": "out_dir",
        "pipelines.pixel_inpaint.run_batched": "out_dir",
        "pipelines.keyframes.frame_generator": _Obj(label="frames"),
        "pipelines.keyframe_inpaint.VideoWorkspace": _Obj(label="ws"),
        "pipelines.keyframe_inpaint.run": "ws_dir",
        "pipelines.ofgen.run": "of_dir",
        "pipelines.specializations.img2img_depth2img": (
            _Obj(label="image"), None),
        "pipelines.specializations.upscale": (_Obj(label="image"), [7]),
        "pipelines.facades.txt2img": _Obj(label="image"),
        "models.depth.dpt_init": {"w": np.zeros(1, np.float32)},
        "utils.images.read_png_bgr": _Obj(label="png"),
        "utils.images.bgr_u8_to_model": _Obj(label="model_img"),
        "utils.images.model_to_bgr_u8": _Obj(label="bgr"),
        "utils.images.write_png": None,
        "utils.parity.compare_dirs": {"gate_40db": True},
        "training.uncertainty_pretrain.train_raft_synthetic": (
            {"w": np.zeros(2, np.float32)}, {"epe": 0.5}),
        "training.uncertainty_pretrain.eval_epe": 0.25,
        "training.uncertainty_pretrain.train_head_synthetic": (
            {"w": np.zeros(2, np.float32)}, {"err_scale_corr": 0.3}),
        "training.uncertainty_pretrain.evaluate_masks": {
            "fb": {"auroc": 0.5, "recall@0.5": 0.1,
                   "false_rate@0.5": 0.2}},
    }


# the save function of each CLI's checkpoint format
_SAVE = {"jax": "utils.checkpoint.save_pytree",
         "port": "utils.checkpoint.save_npz_tree"}


def _norm(x):
    """A call argument as plain data: dataclasses as their fields (the
    live 'sp' and the schedule callable left out), dtypes by name,
    stand-ins by label, arrays by shape."""
    if isinstance(x, _Obj):
        return x.label
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _norm(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if f.name not in ("sp", "guidance_schedule_func")}
    if isinstance(x, torch.dtype):
        return str(x).rsplit(".", 1)[-1]
    if any(x is d for d in (jnp.float32, jnp.bfloat16)):
        return jnp.dtype(x).name
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return ("array", tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (str, int, float, bool, type(None))):
        return x
    return type(x).__name__


def _calls(cli, pkg, which, argv):
    """Run ``cli.main(argv)`` with the library stand-ins patched into
    ``pkg``; returns {target: [normalised (args, kwargs), ...]} (the
    port's ``device`` keyword left out)."""
    import importlib
    stand = _stand_ins()
    targets = {k: v for k, v in stand.items() if k != "_build_models"}
    targets[_SAVE[which]] = None
    mocks, patches = {}, [mock.patch.object(
        cli, "_build_models", return_value=stand["_build_models"])]
    for target, ret in targets.items():
        mod, attr = target.rsplit(".", 1)
        m = mock.MagicMock(return_value=ret)
        mocks["save" if target == _SAVE[which] else target] = m
        patches.append(mock.patch.object(
            importlib.import_module(f"{pkg}.{mod}"), attr, m))
    for p in patches:
        p.start()
    try:
        cli.main(argv)
    finally:
        for p in patches:
            p.stop()
    out = {}
    for name, m in mocks.items():
        if m.call_args_list and not name.startswith("utils.images"):
            out[name] = [_norm_call(name, c) for c in m.call_args_list]
    return out


def _norm_call(name, call):
    args, kwargs = list(call.args), dict(call.kwargs)
    kwargs.pop("device", None)
    if name == "save" and "dtype" in kwargs:
        # the port's writer casts the float leaves, JAX casts the tree
        dtype = kwargs.pop("dtype")
        args[1] = {k: v.astype(dtype) for k, v in args[1].items()}
    return _norm(args), _norm(kwargs)


def _argvs(tmp):
    common = ["-i", "in.mp4", "-o", str(tmp / "out"), "--ckpt", "a.ckpt",
              "--width", "64", "--height", "96", "--ddim-steps", "7",
              "--denoising-strength", "0.3", "--seed", "5",
              "--prompt-extra", "1girl", "--keep-every", "2"]
    single = ["-i", "in.png", "-o", str(tmp / "o.png"), "--ckpt", "a.ckpt",
              "--prompt", "a fox", "--negative-prompt", "blurry",
              "--ddim-steps", "4", "--seed", "9", "--bf16"]
    return {
        "pixel-inpaint": ["pixel-inpaint", *common, "--frame-batch", "2",
                          "--sampler", "dpmpp:4", "--cfg-interval", "2",
                          "--key-frame-thres", "20",
                          "--propagated-pixel-weight", "0.5"],
        "verify-parity": ["verify-parity", *common, "--ref-frames", "ref",
                          "--conf-thres", "200", "--deepcache-interval",
                          "3"],
        "ofgen": ["ofgen", *common],
        "keyframe-inpaint": ["keyframe-inpaint", *common, "--kernel-size",
                             "6", "--stride", "3", "--num-refs", "2",
                             "--level-batch", "2", "--mode", "both",
                             "--flow-batch", "4", "--max-len-sec", "5"],
        "depth2img": ["depth2img", *single, "--denoising-strength", "0.6"],
        "upscale": ["upscale", *single, "--noise-level", "20"],
        "txt2img": ["txt2img", "-o", str(tmp / "t.png"), "--ckpt", "a.ckpt",
                    "--height", "64", "--width", "96", "--cfg-scale", "5",
                    "--prompt", "a fox", "--ddim-steps", "3"],
        "port": ["port", "--spec", "sd15-inpaint9", "--ckpt", "a.ckpt",
                 "-o", str(tmp / "ported"), "--bf16"],
        "train-uncertainty": ["train-uncertainty", "-o", str(tmp / "tu"),
                              "--raft-steps", "3", "--head-steps", "2",
                              "--batch", "2", "--size", "64x96",
                              "--train-iters", "2", "--lr", "1e-4",
                              "--head-lr", "2e-3", "--bce-weight", "0.1",
                              "--seed", "3", "--eval-scenes", "4"],
    }


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_subcommand_calls_match_jax(cmd, tmp_path):
    argv = _argvs(tmp_path)[cmd]
    if cmd == "verify-parity":
        argv += ["--ours", str(tmp_path / "ours")]
    want = _calls(JCLI, "sd_animation_optical_flow_tpu", "jax", argv)
    got = _calls(TCLI, "sd_animation_optical_flow_tpu_torch", "port",
                 argv + ["--device", "cpu"])
    assert want, cmd
    # depth2img's DPT is drawn from a PRNGKey in JAX, a Generator here
    for calls in (want, got):
        calls.pop("models.depth.dpt_init", None)
    assert got == want


# ---------------------------------------------------------------------------
# end to end on tiny checkpoints
# ---------------------------------------------------------------------------

def _pixel_argv(tiny, out):
    return ["pixel-inpaint", "-i", tiny["video"], "-o", out,
            "--spec", tiny["spec"], "--inpaint-spec", tiny["spec9"],
            "--ckpt", tiny["ckpt"], "--inpaint-ckpt", tiny["ckpt9"],
            "--raft-ckpt", tiny["raft"], "--width", "64", "--height", "64",
            "--keep-every", "3", "--ddim-steps", "10",
            "--denoising-strength", "0.3", "--flow-iters", "2"]


def test_cli_pixel_inpaint_matches_jax_cli(tiny, tmp_path):
    """The same argv through both CLIs (the port's with --device cpu and
    the JAX program's noises): the same files, every converted_ frame at
    >= 40 dB of JAX's."""
    JCLI.main(_pixel_argv(tiny, str(tmp_path / "jax")))
    p1, p2 = _jax_noises()
    with p1, p2:
        tdir = TCLI.main(_pixel_argv(tiny, str(tmp_path / "port"))
                         + ["--device", "cpu"])
    assert tdir == str(tmp_path / "port") + "_pixel_warp-tpu"
    psnr = _converted_psnr(tdir, str(tmp_path / "jax_pixel_warp-tpu"),
                           "cli pixel-inpaint")
    assert len(psnr) == 4
    assert all(v >= 40.0 for v in psnr.values()), psnr


def test_cli_port_writes_jax_npz(tiny, tmp_path):
    """``port`` with --raft-ckpt: unet / vae / clip / raft npz files equal
    to the JAX CLI's, key by key and bit for bit; the JAX package's
    load_pytree reads the port's files into its bundle's structure."""
    from sd_animation_optical_flow_tpu.utils.checkpoint import load_pytree
    argv = ["port", "--spec", tiny["spec"], "--ckpt", tiny["ckpt"],
            "--raft-ckpt", tiny["raft"], "-o"]
    JCLI.main(argv + [str(tmp_path / "jax")])
    TCLI.main(argv + [str(tmp_path / "port"), "--device", "cpu"])
    for name in ("unet", "vae", "clip", "raft"):
        with np.load(tmp_path / "jax" / f"{name}.npz") as j, \
                np.load(tmp_path / "port" / f"{name}.npz") as t:
            assert sorted(t.files) == sorted(j.files), name
            for k in j.files:
                assert t[k].dtype == j[k].dtype, (name, k)
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    like = JC.create_model(tiny["spec"], tiny["ckpt"]).unet_params
    load_pytree(str(tmp_path / "port" / "unet.npz"), like)


_BLOCKED = ("cv2", "PIL", "yaml", "safetensors", "transformers", "jax",
            "jaxlib", "sd_animation_optical_flow_tpu")

_RUNNER = """
import sys
from unittest import mock
BLOCKED = {blocked!r}


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is blocked")
        return None


sys.meta_path.insert(0, Block())
from sd_animation_optical_flow_tpu_torch import cli, config as C
from sd_animation_optical_flow_tpu_torch.models.clip import CLIPTextConfig
from sd_animation_optical_flow_tpu_torch.models.unet import UNetConfig
from sd_animation_optical_flow_tpu_torch.models.vae import VAEConfig
spec = C.BundleSpec(unet=UNetConfig(**{unet!r}), vae=VAEConfig(**{vae!r}),
                    clip=CLIPTextConfig(**{clip!r}))
argv = sys.argv[1:]
if argv[0] == "--help":
    cli.main(argv)
with mock.patch.object(C, "SD15", spec):
    cli.main(argv)
assert not set(BLOCKED) & set(m.split(".")[0] for m in sys.modules)
"""


def test_cli_runs_without_cv2_yaml_and_jax(tiny, tmp_path):
    """The card's machine has no cv2, PIL, PyYAML, safetensors,
    transformers or JAX: with them unimportable, ``--help`` and
    ``txt2img --device cpu`` on a .ckpt (the builtin 'sd15' narrowed to
    the tiny spec) run, and the PNG reads back at the asked size."""
    from torch_ckpt_common import TINY_CLIP, TINY_UNET, TINY_VAE
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v
                     for k, v in d.items()}
    script = tmp_path / "runner.py"
    script.write_text(_RUNNER.format(blocked=_BLOCKED, unet=tup(TINY_UNET),
                                     vae=tup(TINY_VAE), clip=tup(TINY_CLIP)))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(script), "--help"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "pixel-inpaint" in out.stdout and "txt2img" in out.stdout
    png = tmp_path / "x.png"
    out = subprocess.run(
        [sys.executable, str(script), "txt2img", "--ckpt", tiny["ckpt"],
         "--device", "cpu", "--height", "64", "--width", "96",
         "--ddim-steps", "2", "-o", str(png)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"[cli] wrote {png}" in out.stdout
    img = TIM.read_png_bgr(str(png))
    assert img.shape == (64, 96, 3) and img.std() > 0
