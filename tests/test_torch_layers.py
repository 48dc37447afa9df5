"""Port parity: layers, schedule, weights bridge, tokenizer, and the
port's import boundary (no JAX, nothing of the JAX package).

Each test feeds the same numpy inputs to the JAX function and its torch
counterpart on the CPU in f32. Tolerance: 1e-5 relative to the output's
largest magnitude unless stated (f32 rounding of different but
equivalent summation orders)."""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.diffusion import schedule as JS
from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import layers as JL
from sd_animation_optical_flow_tpu.pipelines.tokenizer import \
    PromptTokenizer as JTok
from sd_animation_optical_flow_tpu_torch.diffusion import schedule as TS
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import layers as TL
from sd_animation_optical_flow_tpu_torch.pipelines.tokenizer import \
    PromptTokenizer as TTok
from torch_port_common import (jax_models, np_t, rel_err, to_port,
                               torch_configs)

TOL = 1e-5
PORT = pathlib.Path(__file__).resolve().parent.parent / \
    "sd_animation_optical_flow_tpu_torch"


def _conv_params(rng, kh, cin, cout):
    w = rng.standard_normal((kh, kh, cin, cout)).astype(np.float32) * 0.2
    b = rng.standard_normal((cout,)).astype(np.float32) * 0.1
    return {"w": w, "b": b}


@pytest.mark.parametrize("kh,stride,padding", [
    (3, 1, "SAME"), (1, 1, "SAME"), (3, 2, 1), (3, 2, ((0, 1), (0, 1))),
    (3, 1, "VALID"), (3, 2, "SAME")])
def test_conv2d(np_rng, kh, stride, padding):
    p = _conv_params(np_rng, kh, 6, 5)
    x = np_rng.standard_normal((2, 9, 10, 6)).astype(np.float32)
    ref = JL.conv2d(p, jnp.asarray(x), stride=stride, padding=padding)
    out = TL.conv2d(to_port(p), np_t(x), stride=stride, padding=padding)
    assert out.shape == ref.shape
    assert rel_err(out, ref) < TOL


@pytest.mark.parametrize("c,eps", [(64, 1e-5), (48, 1e-6), (24, 1e-5)])
def test_group_norm(np_rng, c, eps):
    # 48 and 24 channels: gcd(32, C) groups (small test configs)
    p = {"scale": np_rng.standard_normal(c).astype(np.float32),
         "bias": np_rng.standard_normal(c).astype(np.float32)}
    x = (np_rng.standard_normal((2, 5, 7, c)) * 3 + 1).astype(np.float32)
    ref = JL.group_norm(p, jnp.asarray(x), eps=eps)
    out = TL.group_norm(to_port(p), np_t(x), eps=eps)
    assert rel_err(out, ref) < TOL


def test_layer_norm_linear_swish(np_rng):
    c = 24
    ln = {"scale": np_rng.standard_normal(c).astype(np.float32),
          "bias": np_rng.standard_normal(c).astype(np.float32)}
    lin = {"w": np_rng.standard_normal((c, 40)).astype(np.float32),
           "b": np_rng.standard_normal(40).astype(np.float32)}
    x = np_rng.standard_normal((3, 11, c)).astype(np.float32) * 2
    xj, xt = jnp.asarray(x), np_t(x)
    assert rel_err(TL.layer_norm(to_port(ln), xt),
                   JL.layer_norm(ln, xj)) < TOL
    assert rel_err(TL.linear(to_port(lin), xt), JL.linear(lin, xj)) < TOL
    assert rel_err(TL.swish(xt), JL.swish(xj)) < TOL
    assert rel_err(TL.gelu(xt), JL.gelu(xj)) < TOL


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 401, 999], np.int32)
    ref = JL.timestep_embedding(jnp.asarray(t), dim)
    out = TL.timestep_embedding(torch.from_numpy(t), dim)
    assert out.shape == ref.shape
    # cos/sin of arguments up to ~999: one f32 ulp of the argument
    # (6e-5 at 999) bounds the agreement
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_upsample2x_conv(np_rng):
    # JAX computes it as four subpixel convs with pre-added weights; the
    # port as nearest-upsample then conv: equal sums, f32 rounding apart
    p = _conv_params(np_rng, 3, 6, 4)
    x = np_rng.standard_normal((2, 5, 6, 6)).astype(np.float32)
    ref = JL.upsample2x_conv(p, jnp.asarray(x))
    out = TL.upsample2x_conv(to_port(p), np_t(x))
    assert out.shape == ref.shape == (2, 10, 12, 4)
    assert rel_err(out, ref) < TOL


def test_linear_schedule_and_ddim_params():
    js, ts = JS.make_linear_schedule(), TS.make_linear_schedule()
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for steps, eta in ((50, 0.0), (20, 0.5)):
        jd, td = JS.make_ddim_params(js, steps, eta), \
            TS.make_ddim_params(ts, steps, eta)
        for name in ("timesteps", "alphas", "alphas_prev",
                     "sqrt_one_minus_alphas", "sigmas"):
            np.testing.assert_allclose(getattr(td, name).numpy(),
                                       np.asarray(getattr(jd, name)),
                                       rtol=1e-6, atol=1e-7)


def test_bridge_matches_port_init_structure():
    """The bridged JAX trees and the port's own init have the same keys
    and shapes (the port's random init builds what the bridge converts)."""
    from sd_animation_optical_flow_tpu_torch.models import unet as TU
    from sd_animation_optical_flow_tpu_torch.models import vae as TV
    _, jparams = jax_models()
    ucfg, vcfg, ccfg = torch_configs()
    init = TL.Init(torch.Generator().manual_seed(0))
    mine = (TU.unet_init(init, ucfg), TV.vae_init(init, vcfg),
            TCL.clip_text_init(init, ccfg))

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{path}/{k}").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{path}[{i}]").items()}
        return {path: tuple(tree.shape)}

    for jp, tp in zip(jparams, mine):
        assert shapes(to_port(jp)) == shapes(tp)


def test_chunk_token_ids_and_tokenizer():
    ids = list(range(1, 200))
    np.testing.assert_array_equal(TCL.chunk_token_ids(ids),
                                  JCL.chunk_token_ids(ids))
    text = "masterpiece, best_quality, 1girl, (watercolor:1.2) fox!"
    # the hash fallback (no local CLIP BPE files), as on the card
    jt, tt = JTok(hf_name_or_path=None), TTok(hf_name_or_path=None)
    assert not tt.exact and not jt.exact
    assert tt.raw_ids(text) == jt.raw_ids(text)
    np.testing.assert_array_equal(tt.chunked(text), jt.chunked(text))


def test_port_imports_no_jax():
    """No module of the port imports jax or the JAX package."""
    banned = ("jax", "jaxlib", "sd_animation_optical_flow_tpu")
    offenders = []
    for src in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{src.name}: {n}" for n in names
                          if n.split(".")[0] in banned]
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    """Importing every port module works with jax and the JAX package
    made unimportable (a fresh interpreter)."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'sd_animation_optical_flow_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import importlib, pathlib\n"
        f"root = pathlib.Path({str(PORT.parent)!r})\n"
        "for f in sorted((root / 'sd_animation_optical_flow_tpu_torch')"
        ".rglob('*.py')):\n"
        "    mod = '.'.join(f.relative_to(root).with_suffix('').parts)\n"
        "    importlib.import_module(mod.removesuffix('.__init__'))\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT.parent, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
