"""Port parity: checkpoint porting (``utils/port_weights.py``) against the
JAX ``utils/port_weights.py`` on the CPU.

Every port function on a reference-named state dict gives, bit for bit
in float32, the tree ``jax_params.params_from_jax`` makes from the JAX
function's result, and the same ``missing`` list. The dicts come from the
torch modules of ``tests/torch_sd_ref.py`` (UNet, VAE; two configs each,
so the output-block and reversed-decoder walks meet upsamplers behind
transformers and three levels), the HF models of ``transformers`` (CLIP,
OpenCLIP, T5; skipped only where it is missing), ControlNet's keys
around the UNet's, ``tests/test_port_weights.py``'s RAFT dict of the
committed artifact, and the VAE's keys with a codebook (VQ). The port's
UNet, VAE and CLIP forwards on the ported trees match the torch modules
at the tolerances of ``tests/test_port_weights.py``. Also: torch tensors
(bf16 included) as inputs, the bf16 cast, channels_last conv weights,
``fit_tensor`` / ``fit_state_dict`` against JAX's, and the port's
safetensors reader against ``safetensors.safe_open``.
"""

import os

import numpy as np
import pytest
import torch

from sd_animation_optical_flow_tpu.models import clip as JCL
from sd_animation_optical_flow_tpu.models import text_encoders as JTE
from sd_animation_optical_flow_tpu.models import unet as JU
from sd_animation_optical_flow_tpu.models import vae as JV
from sd_animation_optical_flow_tpu.models import vq as JVQ
from sd_animation_optical_flow_tpu.utils import port_weights as JPW
from sd_animation_optical_flow_tpu_torch.models import clip as TCL
from sd_animation_optical_flow_tpu_torch.models import text_encoders as TTE
from sd_animation_optical_flow_tpu_torch.models import unet as TU
from sd_animation_optical_flow_tpu_torch.models import vae as TV
from sd_animation_optical_flow_tpu_torch.models import vq as TVQ
from sd_animation_optical_flow_tpu_torch.utils import port_weights as TPW
from sd_animation_optical_flow_tpu_torch.utils.jax_params import (
    _unflatten, params_from_jax)
from test_port_weights import make_raft_state_dict
from torch_ckpt_common import clip_text_state_dict
import torch_port_common  # noqa: F401  (torch on two threads)
from torch_sd_ref import TorchUNet, TorchVAEDecoder, TorchVAEEncoder

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _from_jax(tree, key=None):
    """params_from_jax on the CPU, with the None leaves of missing keys
    kept None."""
    if isinstance(tree, dict):
        return {k: _from_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_jax(v) for v in tree]
    if tree is None:
        return None
    return params_from_jax({key: tree}, device="cpu")[key]


def assert_tree_equal(want, got, path=""):
    """Same structure; every leaf of the same dtype and shape, bit equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and want.keys() == got.keys(), \
            (path, sorted(want), sorted(got))
        for k in want:
            assert_tree_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_tree_equal(a, b, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (path, got.dtype, want.dtype, got.shape, want.shape)
        assert torch.equal(got, want), path


def _port_both(name, sd, *args, **kw):
    """(JAX result through params_from_jax, JAX missing), (port result,
    port missing) of the port function ``name``."""
    jp, jm = getattr(JPW, name)(sd, *args, **kw)
    tp, tm = getattr(TPW, name)(sd, *[_torch_cfg(a) for a in args],
                                device="cpu", **kw)
    return (_from_jax(jp), jm), (tp, tm)


_CFGS = {JU.UNetConfig: TU.UNetConfig, JV.VAEConfig: TV.VAEConfig,
         JCL.CLIPTextConfig: TCL.CLIPTextConfig,
         JTE.T5Config: TTE.T5Config,
         JTE.OpenCLIPTextConfig: TTE.OpenCLIPTextConfig}


def _torch_cfg(cfg):
    """The port's config of the same fields as a JAX config."""
    if isinstance(cfg, JVQ.VQConfig):
        return TVQ.VQConfig(**{**cfg.__dict__,
                               "backbone": _torch_cfg(cfg.backbone)})
    for j, t in _CFGS.items():
        if isinstance(cfg, j):
            return t(**cfg.__dict__)
    return cfg


def _check(name, sd, *args, **kw):
    (want, jm), (got, tm) = _port_both(name, sd, *args, **kw)
    assert tm == jm
    assert_tree_equal(want, got)
    return got, tm


# ---------------------------------------------------------------------------
# UNet, VAE, CLIP: bit-equal trees and the torch modules' forwards
# ---------------------------------------------------------------------------

UNET_CASES = {
    "two_levels": dict(model_channels=32, channel_mult=(1, 2),
                       attention_resolutions=(1,), num_heads=4,
                       context_dim=64),
    # three levels, one res block each: the upsamplers sit behind
    # transformers on the coarser levels and alone at the finest
    "three_levels": dict(model_channels=32, channel_mult=(1, 2, 2),
                         attention_resolutions=(2, 4), num_heads=2,
                         context_dim=32, num_res_blocks=1),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_port_unet_matches_jax_and_torch(case):
    kw = UNET_CASES[case]
    torch.manual_seed(0)
    tmodel = TorchUNet(**kw).eval()
    sd = _np({"model.diffusion_model." + k: v
              for k, v in tmodel.state_dict().items()})
    cfg = JU.UNetConfig(**kw)
    params, missing = _check("port_unet", sd, cfg)
    assert not missing

    x = np.random.default_rng(0).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    t = np.asarray([3, 500])
    ctx = np.random.default_rng(1).standard_normal(
        (2, 7, kw["context_dim"])).astype(np.float32)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(t), torch.from_numpy(ctx))
        out, _ = TU.unet_apply(params, _torch_cfg(cfg), torch.from_numpy(x),
                               torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=2e-3, atol=2e-4)


VAE_CASES = {"two_levels": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1),
             "three_levels": dict(ch=32, ch_mult=(1, 2, 2),
                                  num_res_blocks=2)}


def _vae_modules(kw, seed=1):
    torch.manual_seed(seed)
    enc = TorchVAEEncoder(**kw).eval()
    dec = TorchVAEDecoder(**kw).eval()
    quant, post = torch.nn.Conv2d(8, 8, 1), torch.nn.Conv2d(4, 4, 1)
    sd = {}
    for prefix, mod in (("encoder.", enc), ("decoder.", dec),
                        ("quant_conv.", quant), ("post_quant_conv.", post)):
        sd.update({"first_stage_model." + prefix + k: v
                   for k, v in mod.state_dict().items()})
    return (enc, dec, quant, post), _np(sd)


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_port_vae_matches_jax_and_torch(case):
    kw = VAE_CASES[case]
    (enc, dec, quant, post), sd = _vae_modules(kw)
    cfg = JV.VAEConfig(**kw)
    params, missing = _check("port_vae", sd, cfg)
    assert not missing

    f = 2 ** (len(kw["ch_mult"]) - 1)
    x = np.random.default_rng(2).standard_normal((1, 16, 16, 3)).astype(
        np.float32)
    z = np.random.default_rng(3).standard_normal(
        (1, 16 // f, 16 // f, 4)).astype(np.float32)
    tcfg = _torch_cfg(cfg)
    with torch.no_grad():
        moments = quant(enc(torch.from_numpy(x).permute(0, 3, 1, 2)))
        mean_ref = moments.chunk(2, dim=1)[0].permute(0, 2, 3, 1)
        mean, _ = TV.encode_moments(params, tcfg, torch.from_numpy(x))
        img_ref = dec(post(torch.from_numpy(z).permute(0, 3, 1, 2)))
        img = TV.decode(params, tcfg, torch.from_numpy(z) * tcfg.scale_factor)
    np.testing.assert_allclose(mean.numpy(), mean_ref.numpy(), rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(img.numpy(),
                               img_ref.permute(0, 2, 3, 1).numpy(),
                               rtol=2e-3, atol=2e-4)


def test_port_clip_text_matches_jax_and_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=1000, hidden_size=64, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=77)
    torch.manual_seed(2)
    hf = transformers.CLIPTextModel(hf_cfg).eval()
    sd = _np(hf.state_dict())
    cfg = JCL.CLIPTextConfig(vocab_size=1000, width=64, layers=2, heads=4)
    params, missing = _check("port_clip_text", sd, cfg, prefix="text_model.")
    assert not missing

    ids = np.random.default_rng(4).integers(0, 1000, (2, 77))
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids)).last_hidden_state
        out = TCL.clip_text_apply(params, _torch_cfg(cfg),
                                  torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_port_clip_text_ldm_prefix_and_bf16():
    """The ldm prefix (the default), torch tensors in bfloat16 as input,
    and a bfloat16 tree out: the JAX tree cast to bf16 (params_from_jax's
    dtype), from JAX's port of the same values widened to float32."""
    sd_t = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in clip_text_state_dict(32, 2).items()}
    sd_np = {k: v.float().numpy() for k, v in sd_t.items()}
    cfg = JCL.CLIPTextConfig(vocab_size=49408, width=32, layers=2, heads=2)
    jp, jm = JPW.port_clip_text(sd_np, cfg)
    tp, tm = TPW.port_clip_text(sd_t, _torch_cfg(cfg), dtype=torch.bfloat16,
                                device="cpu")
    assert tm == jm == []
    assert_tree_equal(params_from_jax(jp, dtype=torch.bfloat16,
                                      device="cpu"), tp)


# ---------------------------------------------------------------------------
# ControlNet, RAFT, VQ, T5, OpenCLIP
# ---------------------------------------------------------------------------

def _controlnet_state_dict(kw):
    """ControlNet's keys: the UNet's time embedding, input and middle
    blocks (TorchUNet's), a 1x1 zero conv per input block and the middle
    one, and the hint encoder's eight convs."""
    torch.manual_seed(5)
    unet = TorchUNet(**kw)
    sd = {k: v for k, v in unet.state_dict().items()
          if k.split(".")[0] in ("time_embed", "input_blocks",
                                 "middle_block")}
    g = torch.Generator().manual_seed(6)
    rand = lambda *s: torch.randn(s, generator=g) * 0.05
    n_in = 1 + max(int(k.split(".")[1]) for k in sd
                   if k.startswith("input_blocks."))
    for i in range(n_in):
        # the block's output channels: its last conv's or its resblock's
        w = [v for k, v in sd.items()
             if k.startswith(f"input_blocks.{i}.") and v.ndim == 4][-1]
        c = w.shape[0]
        sd[f"zero_convs.{i}.0.weight"] = rand(c, c, 1, 1)
        sd[f"zero_convs.{i}.0.bias"] = rand(c)
    c = sd["middle_block.2.out_layers.3.weight"].shape[0]
    sd["middle_block_out.0.weight"] = rand(c, c, 1, 1)
    sd["middle_block_out.0.bias"] = rand(c)
    hint = [(3, 16), (16, 16), (16, 32), (32, 32), (32, 96), (96, 96),
            (96, 256), (256, kw["model_channels"])]
    for j, (cin, cout) in zip((0, 2, 4, 6, 8, 10, 12, 14), hint):
        sd[f"input_hint_block.{j}.weight"] = rand(cout, cin, 3, 3)
        sd[f"input_hint_block.{j}.bias"] = rand(cout)
    return _np(sd)


@pytest.mark.parametrize("prefixed", [True, False])
def test_port_controlnet_matches_jax(prefixed):
    kw = UNET_CASES["two_levels"]
    sd = _controlnet_state_dict(kw)
    if prefixed:
        sd = {"control_model." + k: v for k, v in sd.items()}
    params, missing = _check("port_controlnet", sd, JU.UNetConfig(**kw))
    assert not missing
    assert len(params["zero_convs"]) == len(params["input_blocks"])


@pytest.mark.parametrize("prefixed", [True, False])
def test_port_raft_matches_jax(prefixed):
    with np.load(os.path.join(ARTIFACTS, "raft_synth.npz")) as data:
        tree = _unflatten({k: data[k] for k in data.files})
    sd = make_raft_state_dict(tree)
    if not prefixed:
        sd = {k[len("module."):]: v for k, v in sd.items()}
    params, missing = _check("port_raft", sd)
    assert not missing
    # the artifact's own tree, widened to float32
    assert_tree_equal(_from_jax(tree), params)


def test_port_vq_matches_jax():
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    torch.manual_seed(7)
    enc = TorchVAEEncoder(**kw, z_channels=3, double_z=False)
    dec = TorchVAEDecoder(**kw, z_channels=3)
    sd = {}
    for prefix, mod in (("encoder.", enc), ("decoder.", dec),
                        ("quant_conv.", torch.nn.Conv2d(3, 3, 1)),
                        ("post_quant_conv.", torch.nn.Conv2d(3, 3, 1))):
        sd.update({"first_stage_model." + prefix + k: v
                   for k, v in mod.state_dict().items()})
    sd["first_stage_model.quantize.embedding.weight"] = torch.randn(16, 3)
    bb = JV.VAEConfig(**kw, z_channels=3, embed_dim=3, double_z=False,
                      scale_factor=1.0)
    cfg = JVQ.VQConfig(backbone=bb, n_embed=16, embed_dim=3)
    params, missing = _check("port_vq", _np(sd), cfg)
    assert not missing and params["quantize"]["embedding"].shape == (16, 3)


def test_port_t5_encoder_matches_jax_and_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16,
        feed_forward_proj="gated-gelu", dropout_rate=0.0,
        is_encoder_decoder=False, use_cache=False)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(hf_cfg).eval()
    cfg = JTE.T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, heads=4,
                       layers=2, rel_buckets=8, rel_max_distance=16)
    params, _ = _check("port_t5_encoder", _np(hf.state_dict()), cfg)
    ids = torch.tensor([[3, 7, 12, 25, 1, 0, 0, 0]])
    attn = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0]])
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=attn).last_hidden_state
        out = TTE.t5_encoder_apply(params, _torch_cfg(cfg), ids, attn)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_port_openclip_text_matches_jax_and_transformers():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=12, hidden_act="gelu")
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(hf_cfg).eval()
    cfg = JTE.OpenCLIPTextConfig(vocab_size=64, max_position=12, width=32,
                                 layers=3, heads=4, penultimate=True)
    params, _ = _check("port_openclip_text", _np(hf.state_dict()), cfg)
    ids = torch.tensor([[5, 9, 13, 2, 1, 0, 7, 3, 11, 4, 6, 8]])
    with torch.no_grad():
        hs = hf(input_ids=ids, output_hidden_states=True).hidden_states
        ref = hf.text_model.final_layer_norm(hs[-2])
        out = TTE.openclip_text_apply(params, _torch_cfg(cfg), ids)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# missing keys, tensors as input, layouts
# ---------------------------------------------------------------------------

def test_missing_keys_match_jax():
    """Keys dropped from a UNet dict (a conv weight, a bias, a linear
    weight, a whole skip conv): the same missing list in read order, None
    leaves where JAX has them, no bias entry where JAX leaves it out."""
    kw = UNET_CASES["two_levels"]
    torch.manual_seed(0)
    sd = _np({"model.diffusion_model." + k: v
              for k, v in TorchUNet(**kw).state_dict().items()})
    pre = "model.diffusion_model."
    for key in ("input_blocks.1.0.in_layers.2.weight",
                "output_blocks.0.0.out_layers.3.bias",
                "middle_block.1.transformer_blocks.0.attn2.to_k.weight",
                "output_blocks.2.0.skip_connection.weight",
                "output_blocks.2.0.skip_connection.bias"):
        del sd[pre + key]
    params, missing = _check("port_unet", sd, JU.UNetConfig(**kw))
    assert missing == [pre + k for k in (
        "input_blocks.1.0.in_layers.2.weight",
        "middle_block.1.transformer_blocks.0.attn2.to_k.weight",
        "output_blocks.0.0.out_layers.3.bias")]
    assert params["input_blocks"][1]["res"]["in_conv"]["w"] is None
    assert "b" not in params["output_blocks"][0]["res"]["out_conv"]
    assert "skip" not in params["output_blocks"][2]["res"]


def test_tensor_inputs_and_layouts():
    """A dict of torch tensors ports as its numpy twin does; float16 and
    bfloat16 entries go through float32; 4-D weights are channels_last
    and no leaf shares memory with the state dict."""
    (_, _, _, _), sd_np = _vae_modules(VAE_CASES["two_levels"])
    cfg = TV.VAEConfig(**VAE_CASES["two_levels"])
    base, _ = TPW.port_vae(sd_np, cfg, device="cpu")
    sd_t = {k: torch.from_numpy(v) for k, v in sd_np.items()}
    from_t, _ = TPW.port_vae(sd_t, cfg, device="cpu")
    assert_tree_equal(base, from_t)
    w = from_t["encoder"]["conv_in"]["w"]
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert w.data_ptr() != sd_t["first_stage_model.encoder.conv_in.weight"
                                ].data_ptr()
    attn_q = from_t["encoder"]["mid"]["attn_1"]["q"]["w"]
    assert attn_q.shape == (64, 64, 1, 1)
    for half in (torch.float16, torch.bfloat16):
        low = {k: v.to(half) for k, v in sd_t.items()}
        got, _ = TPW.port_vae(low, cfg, dtype=torch.bfloat16, device="cpu")
        want, _ = TPW.port_vae({k: v.float() for k, v in low.items()}, cfg,
                               dtype=torch.bfloat16, device="cpu")
        assert_tree_equal(want, got)
        assert got["decoder"]["conv_in"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# fit_tensor / fit_state_dict
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old_shape,new_shape", [
    ((4,), (9,)),
    ((320, 4, 3, 3), (320, 9, 3, 3)),       # 4ch -> 9ch inpaint conv
    ((8, 6), (12, 10)),
    ((5, 7, 2), (5, 7, 2)),                  # identity
])
def test_fit_tensor_matches_jax(old_shape, new_shape):
    old = np.random.RandomState(0).randn(*old_shape).astype(np.float32)
    want = JPW.fit_tensor(old, new_shape)
    got = TPW.fit_tensor(old, new_shape)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_t = TPW.fit_tensor(torch.from_numpy(old), new_shape)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_fit_state_dict_matches_jax():
    sd = {"a": np.arange(4.0), "b": np.ones((2, 3, 1, 1)), "c": np.ones(2)}
    shapes = {"a": (6,), "b": (2, 5, 1, 1), "d": (3,)}
    want = JPW.fit_state_dict(sd, shapes)
    got = TPW.fit_state_dict(sd, shapes)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got_t = TPW.fit_state_dict({k: torch.from_numpy(v) for k, v in
                                sd.items()}, shapes)
    for k in want:
        np.testing.assert_array_equal(got_t[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# files: the safetensors reader and load_state_dict
# ---------------------------------------------------------------------------

def test_safetensors_reader_matches_safe_open(tmp_path):
    safetensors = pytest.importorskip("safetensors")
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "i64": torch.arange(6).reshape(2, 3),
               "u8": torch.arange(5, dtype=torch.uint8),
               "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "w.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = TPW.read_safetensors(path)
    assert got.keys() == tensors.keys()
    with safetensors.safe_open(path, framework="pt") as f:
        for k in f.keys():
            want = f.get_tensor(k)
            assert got[k].dtype == want.dtype and torch.equal(got[k], want)
    assert TPW.load_state_dict(path).keys() == tensors.keys()
    # JAX's loader reads through numpy, which holds no bfloat16
    del tensors["bf16"]
    save_file(tensors, path)
    want = JPW.load_state_dict(path)
    got = TPW.load_state_dict(path)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_load_state_dict_matches_jax(tmp_path):
    """A Lightning-style .ckpt (nested state_dict, a non-tensor entry,
    float16 storage) and a flat .pt: the same keys and values as JAX's
    loader, as CPU tensors; a missing file raises FileNotFoundError."""
    g = torch.Generator().manual_seed(1)
    sd = {"a.weight": torch.randn(4, 3, generator=g).half(),
          "b.bias": torch.randn(3, generator=g),
          "ids": torch.arange(3)}
    for name, obj in (("x.ckpt", {"state_dict": {**sd, "step": 3},
                                  "epoch": 1}),
                      ("y.pt", sd)):
        path = str(tmp_path / name)
        torch.save(obj, path)
        want = JPW.load_state_dict(path)
        got = TPW.load_state_dict(path)
        assert got.keys() == want.keys() == sd.keys()
        for k in sd:
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(FileNotFoundError):
        TPW.load_state_dict(str(tmp_path / "absent.ckpt"))
