"""Checkpoint porting: reference-named torch state dicts -> the port's
param trees.

Counterpart of ``sd_animation_optical_flow_tpu/utils/port_weights.py``:
the same public names, the same key walks (CompVis/ldm UNet, VAE and
CLIP; ControlNet; RAFT; the VQ first stage; HF T5 and OpenCLIP text
towers) and the same ``(params, missing)`` results. The tree a port
function returns is the one ``utils/jax_params.params_from_jax`` makes
from the JAX function's result. The port keeps the torch layouts (OIHW
convs, [out, in] linears), so an entry needs only its new name and a
cast, where the JAX package transposes.

Each leaf is converted on its own, straight onto ``device``: moved there
in the checkpoint's storage dtype, widened to float32 and cast to
``dtype`` (JAX's ``_f32`` then ``cast_tree``), and 4-D conv weights laid
out channels_last (``config._channels_last``). A float16 checkpoint of
2 GB thus never needs a whole float32 copy on the host. Every leaf is a
fresh tensor: nothing aliases the state dict.

State dicts are dicts of numpy arrays or torch tensors (bfloat16 ones
included, which numpy cannot hold). ``load_state_dict`` reads ``.ckpt``
/ ``.pt`` files through ``torch.load`` and ``.safetensors`` files
through :func:`read_safetensors`, this module's own reader of the
format.

A key absent from the state dict is recorded in ``missing`` and its leaf
is None (``strict=False`` loading, as in the reference); a missing bias
is left out of its dict, as JAX leaves it out.
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from ..models.clip import CLIPTextConfig
from ..models.unet import UNetConfig
from ..models.vae import VAEConfig

StateDict = Dict[str, object]

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
              "U16": torch.uint16, "U32": torch.uint32,
              "U64": torch.uint64}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}} (``__metadata__`` ignored), then the tensors' raw
    little-endian bytes."""
    out = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {name} has dtype "
                                 f"{info['dtype']}, which is not read")
            dtype = _ST_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            size = torch.Size(shape).numel() * dtype.itemsize
            if end - begin != size:
                raise ValueError(f"{path}: {name} holds {end - begin} "
                                 f"bytes, its shape {shape} needs {size}")
            if size == 0:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            buf = bytearray(size)
            f.seek(base + begin)
            if f.readinto(buf) != size:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def load_state_dict(path: str) -> StateDict:
    """Load a ``.safetensors`` file (through :func:`read_safetensors`) or
    a torch ``.ckpt`` / ``.pt`` into {name: CPU tensor}, unwrapping a
    nested 'state_dict' and dropping non-tensor entries. ``torch.load``
    runs with ``weights_only=False``, as real ldm checkpoints pickle
    Lightning state; a zip-format file is memory-mapped, so its tensors
    are read from the page cache as they are converted."""
    if path.endswith(".safetensors") or path.endswith(".safetensor"):
        return read_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=False,
                    mmap=zipfile.is_zipfile(path))
    sd = sd.get("state_dict", sd)
    return {k: v.detach() for k, v in sd.items() if hasattr(v, "detach")}


def _as_tensor(a) -> torch.Tensor:
    """A numpy array or tensor as a tensor, without a copy where it can."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    return torch.from_numpy(np.ascontiguousarray(a))


def _leaf(a, dtype, device) -> torch.Tensor:
    """One checkpoint entry -> a fresh tensor on ``device``: float entries
    through float32 to ``dtype``, 4-D ones channels_last."""
    src = _as_tensor(a).to(device)
    fmt = torch.channels_last if src.ndim == 4 else torch.contiguous_format
    if not src.is_floating_point():
        return torch.empty(src.shape, dtype=src.dtype, device=device,
                           memory_format=fmt).copy_(src)
    out = torch.empty(src.shape, dtype=dtype, device=device,
                      memory_format=fmt)
    return out.copy_(src.float())


class _Reader:
    """Prefix-scoped reader that records missing keys and converts each
    entry it reads."""

    def __init__(self, sd: StateDict, prefix: str, dtype, device):
        self.sd = sd
        self.prefix = prefix
        self.dtype = dtype
        self.device = torch.device(device)
        self.missing: list = []

    def __call__(self, name: str):
        key = self.prefix + name
        if key not in self.sd:
            self.missing.append(key)
            return None
        return self.sd[key]

    def has(self, name: str) -> bool:
        return self.prefix + name in self.sd

    def tensor(self, name: str) -> Optional[torch.Tensor]:
        a = self(name)
        return None if a is None else _leaf(a, self.dtype, self.device)

    def conv(self, name: str) -> dict:
        p = {"w": self.tensor(name + ".weight")}
        b = self.tensor(name + ".bias")
        if b is not None:
            p["b"] = b
        return p

    def linear(self, name: str, bias: bool = True) -> dict:
        p = {"w": self.tensor(name + ".weight")}
        if bias:
            b = self.tensor(name + ".bias")
            if b is not None:
                p["b"] = b
        return p

    def norm(self, name: str) -> dict:
        return {"scale": self.tensor(name + ".weight"),
                "bias": self.tensor(name + ".bias")}


# ---------------------------------------------------------------------------
# UNet (model.diffusion_model.*)
# ---------------------------------------------------------------------------

def _port_resblock(r: _Reader, base: str) -> dict:
    p = {
        "in_norm": r.norm(f"{base}.in_layers.0"),
        "in_conv": r.conv(f"{base}.in_layers.2"),
        "emb_lin": r.linear(f"{base}.emb_layers.1"),
        "out_norm": r.norm(f"{base}.out_layers.0"),
        "out_conv": r.conv(f"{base}.out_layers.3"),
    }
    if r.has(f"{base}.skip_connection.weight"):
        p["skip"] = r.conv(f"{base}.skip_connection")
    return p


def _port_attn(r: _Reader, base: str) -> dict:
    return {"to_q": r.linear(f"{base}.to_q", bias=False),
            "to_k": r.linear(f"{base}.to_k", bias=False),
            "to_v": r.linear(f"{base}.to_v", bias=False),
            "to_out": r.linear(f"{base}.to_out.0")}


def _port_transformer(r: _Reader, base: str, depth: int) -> dict:
    p = {
        "norm": r.norm(f"{base}.norm"),
        "proj_in": r.conv(f"{base}.proj_in"),
        "proj_out": r.conv(f"{base}.proj_out"),
        "blocks": [],
    }
    for d in range(depth):
        tb = f"{base}.transformer_blocks.{d}"
        p["blocks"].append({
            "norm1": r.norm(f"{tb}.norm1"),
            "attn1": _port_attn(r, f"{tb}.attn1"),
            "norm2": r.norm(f"{tb}.norm2"),
            "attn2": _port_attn(r, f"{tb}.attn2"),
            "norm3": r.norm(f"{tb}.norm3"),
            # value rows, then gate rows: the order GEGLU splits them in
            "ff_proj": r.linear(f"{tb}.ff.net.0.proj"),
            "ff_out": r.linear(f"{tb}.ff.net.2"),
        })
    return p


def _port_encoder_side(r: _Reader, cfg: UNetConfig, params: dict,
                       zero_convs: Optional[list] = None) -> int:
    """The time embedding, input blocks and middle block shared by the
    UNet and ControlNet (with ControlNet's ``zero_convs`` when given).
    Returns the downsampling factor reached."""
    params["time_embed"] = [r.linear("time_embed.0"),
                            r.linear("time_embed.2")]
    input_blocks = [{"conv": r.conv("input_blocks.0.0")}]
    if zero_convs is not None:
        zero_convs.append(r.conv("zero_convs.0.0"))
    idx, ds = 1, 1
    for lvl in range(len(cfg.channel_mult)):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _port_resblock(r, f"input_blocks.{idx}.0")}
            if ds in cfg.attention_resolutions:
                blk["transformer"] = _port_transformer(
                    r, f"input_blocks.{idx}.1", cfg.transformer_depth)
            input_blocks.append(blk)
            if zero_convs is not None:
                zero_convs.append(r.conv(f"zero_convs.{idx}.0"))
            idx += 1
        if lvl != len(cfg.channel_mult) - 1:
            input_blocks.append({"down": r.conv(f"input_blocks.{idx}.0.op")})
            if zero_convs is not None:
                zero_convs.append(r.conv(f"zero_convs.{idx}.0"))
            idx += 1
            ds *= 2
    params["input_blocks"] = input_blocks
    if zero_convs is not None:
        params["zero_convs"] = zero_convs
    params["middle"] = {
        "res1": _port_resblock(r, "middle_block.0"),
        "transformer": _port_transformer(r, "middle_block.1",
                                         cfg.transformer_depth),
        "res2": _port_resblock(r, "middle_block.2"),
    }
    return ds


def port_unet(sd: StateDict, cfg: UNetConfig = UNetConfig(),
              prefix: str = "model.diffusion_model.", *,
              dtype=torch.float32, device="cuda") -> tuple:
    """Returns (params, missing_keys)."""
    r = _Reader(sd, prefix, dtype, device)
    params: dict = {}
    ds = _port_encoder_side(r, cfg, params)

    # output blocks run the levels coarsest first, num_res_blocks + 1
    # blocks each; the last block of every level but the finest upsamples
    output_blocks = []
    levels = [lvl for lvl in reversed(range(len(cfg.channel_mult)))
              for _ in range(cfg.num_res_blocks + 1)]
    for i, lvl in enumerate(levels):
        blk = {"res": _port_resblock(r, f"output_blocks.{i}.0")}
        sub = 1
        if ds in cfg.attention_resolutions:
            blk["transformer"] = _port_transformer(
                r, f"output_blocks.{i}.{sub}", cfg.transformer_depth)
            sub += 1
        if lvl != 0 and i % (cfg.num_res_blocks + 1) == cfg.num_res_blocks:
            blk["up"] = r.conv(f"output_blocks.{i}.{sub}.conv")
            ds //= 2
        output_blocks.append(blk)
    params["output_blocks"] = output_blocks
    params["out"] = {"norm": r.norm("out.0"), "conv": r.conv("out.2")}
    return params, r.missing


# ---------------------------------------------------------------------------
# VAE (first_stage_model.*)
# ---------------------------------------------------------------------------

def _port_vae_res(r: _Reader, base: str) -> dict:
    p = {
        "norm1": r.norm(f"{base}.norm1"),
        "conv1": r.conv(f"{base}.conv1"),
        "norm2": r.norm(f"{base}.norm2"),
        "conv2": r.conv(f"{base}.conv2"),
    }
    if r.has(f"{base}.nin_shortcut.weight"):
        p["nin_shortcut"] = r.conv(f"{base}.nin_shortcut")
    return p


def _port_vae_mid(r: _Reader, base: str) -> dict:
    # the attention's 1x1 q / k / v / proj_out convs stay [C, C, 1, 1]
    return {
        "block_1": _port_vae_res(r, f"{base}.block_1"),
        "attn_1": {"norm": r.norm(f"{base}.attn_1.norm"),
                   "q": r.conv(f"{base}.attn_1.q"),
                   "k": r.conv(f"{base}.attn_1.k"),
                   "v": r.conv(f"{base}.attn_1.v"),
                   "proj_out": r.conv(f"{base}.attn_1.proj_out")},
        "block_2": _port_vae_res(r, f"{base}.block_2"),
    }


def port_vae(sd: StateDict, cfg: VAEConfig = VAEConfig(),
             prefix: str = "first_stage_model.", *, dtype=torch.float32,
             device="cuda") -> tuple:
    r = _Reader(sd, prefix, dtype, device)
    n_lvl = len(cfg.ch_mult)

    enc: dict = {"conv_in": r.conv("encoder.conv_in"), "down": []}
    for lvl in range(n_lvl):
        lp = {"blocks": [
            _port_vae_res(r, f"encoder.down.{lvl}.block.{b}")
            for b in range(cfg.num_res_blocks)]}
        if lvl != n_lvl - 1:
            lp["downsample"] = r.conv(f"encoder.down.{lvl}.downsample.conv")
        enc["down"].append(lp)
    enc["mid"] = _port_vae_mid(r, "encoder.mid")
    enc["norm_out"] = r.norm("encoder.norm_out")
    enc["conv_out"] = r.conv("encoder.conv_out")

    dec: dict = {"conv_in": r.conv("decoder.conv_in"),
                 "mid": _port_vae_mid(r, "decoder.mid")}
    # the tree holds the decoder's levels coarsest first; the checkpoint
    # names them by level index (finest = 0)
    ups = []
    for lvl in reversed(range(n_lvl)):
        lp = {"blocks": [
            _port_vae_res(r, f"decoder.up.{lvl}.block.{b}")
            for b in range(cfg.num_res_blocks + 1)]}
        if lvl != 0:
            lp["upsample"] = r.conv(f"decoder.up.{lvl}.upsample.conv")
        ups.append(lp)
    dec["up"] = ups
    dec["norm_out"] = r.norm("decoder.norm_out")
    dec["conv_out"] = r.conv("decoder.conv_out")

    params = {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": r.conv("quant_conv"),
        "post_quant_conv": r.conv("post_quant_conv"),
    }
    return params, r.missing


# ---------------------------------------------------------------------------
# CLIP text encoder (cond_stage_model.transformer.text_model.*) and the
# OpenCLIP-style tower (HF CLIPTextModel naming)
# ---------------------------------------------------------------------------

def _port_clip_layers(r: _Reader, layers: int) -> list:
    out = []
    for i in range(layers):
        base = f"encoder.layers.{i}"
        out.append({
            "ln1": r.norm(f"{base}.layer_norm1"),
            "q": r.linear(f"{base}.self_attn.q_proj"),
            "k": r.linear(f"{base}.self_attn.k_proj"),
            "v": r.linear(f"{base}.self_attn.v_proj"),
            "attn_out": r.linear(f"{base}.self_attn.out_proj"),
            "ln2": r.norm(f"{base}.layer_norm2"),
            "mlp_in": r.linear(f"{base}.mlp.fc1"),
            "mlp_out": r.linear(f"{base}.mlp.fc2"),
        })
    return out


def port_clip_text(sd: StateDict, cfg: CLIPTextConfig = CLIPTextConfig(),
                   prefix: str = "cond_stage_model.transformer.text_model.",
                   *, dtype=torch.float32, device="cuda") -> tuple:
    r = _Reader(sd, prefix, dtype, device)
    params: dict = {
        "token_embedding": r.tensor("embeddings.token_embedding.weight"),
        "position_embedding": r.tensor(
            "embeddings.position_embedding.weight"),
        "final_ln": r.norm("final_layer_norm"),
    }
    params["layers"] = _port_clip_layers(r, cfg.layers)
    return params, r.missing


def port_openclip_text(sd: StateDict, cfg=None,
                       prefix: str = "text_model.", *, dtype=torch.float32,
                       device="cuda") -> tuple:
    """An HF-CLIP-layout text tower -> ``models/text_encoders.
    openclip_text_apply`` params (the SD-2.x FrozenOpenCLIPEmbedder
    surface; the penultimate mode is an apply-time flag)."""
    from ..models.text_encoders import OpenCLIPTextConfig
    cfg = cfg or OpenCLIPTextConfig()
    r = _Reader(sd, prefix, dtype, device)
    p = {
        "token_embedding": r.tensor("embeddings.token_embedding.weight"),
        "position_embedding": r.tensor(
            "embeddings.position_embedding.weight"),
        "ln_final": r.norm("final_layer_norm"),
    }
    p["layers"] = _port_clip_layers(r, cfg.layers)
    return p, r.missing


# ---------------------------------------------------------------------------
# ControlNet (control_model.*, or a dict with that prefix stripped)
# ---------------------------------------------------------------------------

def port_controlnet(sd: StateDict, cfg: UNetConfig = UNetConfig(),
                    prefix: str = "control_model.", *, dtype=torch.float32,
                    device="cuda") -> tuple:
    if not any(k.startswith(prefix) for k in sd):
        prefix = ""
    r = _Reader(sd, prefix, dtype, device)
    params: dict = {}
    _port_encoder_side(r, cfg, params, zero_convs=[])
    params["middle_out"] = r.conv("middle_block_out.0")
    params["hint"] = [r.conv(f"input_hint_block.{j}")
                      for j in (0, 2, 4, 6, 8, 10, 12)]
    params["hint_out"] = r.conv("input_hint_block.14")
    return params, r.missing


# ---------------------------------------------------------------------------
# RAFT (raft-things.pth: 'module.'-prefixed DataParallel keys, or without)
# ---------------------------------------------------------------------------

def _port_raft_bn(r: _Reader, base: str) -> dict:
    return {"scale": r.tensor(f"{base}.weight"),
            "bias": r.tensor(f"{base}.bias"),
            "mean": r.tensor(f"{base}.running_mean"),
            "var": r.tensor(f"{base}.running_var")}


def _port_raft_unit(r: _Reader, base: str, norm: str, stride: int) -> dict:
    p = {"conv1": r.conv(f"{base}.conv1"), "conv2": r.conv(f"{base}.conv2")}
    if norm == "batch":
        p["norm1"] = _port_raft_bn(r, f"{base}.norm1")
        p["norm2"] = _port_raft_bn(r, f"{base}.norm2")
    if stride != 1:
        p["down"] = r.conv(f"{base}.downsample.0")
        if norm == "batch":
            p["norm3"] = _port_raft_bn(r, f"{base}.downsample.1")
    return p


def _port_raft_encoder(r: _Reader, base: str, norm: str) -> dict:
    p = {"conv1": r.conv(f"{base}.conv1")}
    if norm == "batch":
        p["norm1"] = _port_raft_bn(r, f"{base}.norm1")
    p["layers"] = [[_port_raft_unit(r, f"{base}.layer{li}.0", norm, stride),
                    _port_raft_unit(r, f"{base}.layer{li}.1", norm, 1)]
                   for li, stride in ((1, 1), (2, 2), (3, 2))]
    p["conv2"] = r.conv(f"{base}.conv2")
    return p


def port_raft(sd: StateDict, prefix: str = "module.", *,
              dtype=torch.float32, device="cuda") -> tuple:
    if not any(k.startswith(prefix) for k in sd):
        prefix = ""
    r = _Reader(sd, prefix, dtype, device)
    params = {
        "fnet": _port_raft_encoder(r, "fnet", "instance"),
        "cnet": _port_raft_encoder(r, "cnet", "batch"),
        "update": {
            "encoder": {n: r.conv(f"update_block.encoder.{n}")
                        for n in ("convc1", "convc2", "convf1", "convf2",
                                  "conv")},
            "gru": {n: r.conv(f"update_block.gru.{n}")
                    for n in ("convz1", "convr1", "convq1",
                              "convz2", "convr2", "convq2")},
            "flow_head": {"conv1": r.conv("update_block.flow_head.conv1"),
                          "conv2": r.conv("update_block.flow_head.conv2")},
            "mask": {"conv1": r.conv("update_block.mask.0"),
                     "conv2": r.conv("update_block.mask.2")},
        },
    }
    return params, r.missing


# ---------------------------------------------------------------------------
# VQ first stage (first_stage_model.* with quantize.embedding)
# ---------------------------------------------------------------------------

def port_vq(sd: StateDict, cfg=None, prefix: str = "first_stage_model.", *,
            dtype=torch.float32, device="cuda") -> tuple:
    """A VQModel first stage: the KL layout (``cfg.backbone`` drives the
    walk) plus ``quantize.embedding.weight``."""
    from ..models.vq import VQConfig
    cfg = cfg or VQConfig()
    params, missing = port_vae(sd, cfg.backbone, prefix, dtype=dtype,
                               device=device)
    r = _Reader(sd, prefix, dtype, device)
    params["quantize"] = {"embedding": r.tensor("quantize.embedding.weight")}
    return params, missing + r.missing


# ---------------------------------------------------------------------------
# T5 encoder (HF t5-v1_1 naming; FrozenT5Embedder checkpoints)
# ---------------------------------------------------------------------------

def port_t5_encoder(sd: StateDict, cfg=None, prefix: str = "", *,
                    dtype=torch.float32, device="cuda") -> tuple:
    """An HF T5EncoderModel state dict -> ``models/text_encoders.
    t5_encoder_apply`` params (``cfg.layers`` drives the walk)."""
    from ..models.text_encoders import T5Config
    cfg = cfg or T5Config()
    r = _Reader(sd, prefix, dtype, device)
    p = {
        "token_embedding": r.tensor("shared.weight"),
        "rel_bias": r.tensor("encoder.block.0.layer.0.SelfAttention."
                             "relative_attention_bias.weight"),
        "final_norm": r.tensor("encoder.final_layer_norm.weight"),
        "layers": [],
    }
    for i in range(cfg.layers):
        base = f"encoder.block.{i}"
        attn = f"{base}.layer.0.SelfAttention"
        ff = f"{base}.layer.1.DenseReluDense"
        p["layers"].append({
            "norm1": r.tensor(f"{base}.layer.0.layer_norm.weight"),
            "q": r.linear(f"{attn}.q", bias=False),
            "k": r.linear(f"{attn}.k", bias=False),
            "v": r.linear(f"{attn}.v", bias=False),
            "o": r.linear(f"{attn}.o", bias=False),
            "norm2": r.tensor(f"{base}.layer.1.layer_norm.weight"),
            "wi0": r.linear(f"{ff}.wi_0", bias=False),
            "wi1": r.linear(f"{ff}.wi_1", bias=False),
            "wo": r.linear(f"{ff}.wo", bias=False),
        })
    return p, r.missing


# ---------------------------------------------------------------------------
# make_it_fit: cyclic-tiling shape adaptation of old checkpoints
# ---------------------------------------------------------------------------

def fit_tensor(old, new_shape: tuple):
    """Adapt one checkpoint entry (numpy array or tensor; the result is
    of the same kind) to ``new_shape`` by cyclic tiling of the first two
    axes, with the input axis renormalised by its use, as the reference's
    ``make_it_fit`` does (e.g. a 4-channel UNet input conv into a
    9-channel inpainting UNet).

    Rank 1: out[i] = old[i % o0].
    Rank >= 2 (trailing axes must match): out[i, j] = old[i % o0, j % o1],
    then each column j is divided by 1 + #{j' < new1 : j' % o1 == j % o1}
    (the reference seeds its use counter at ones)."""
    is_tensor = isinstance(old, torch.Tensor)
    new_shape = tuple(new_shape)
    if tuple(old.shape) == new_shape:
        return old if is_tensor else np.asarray(old)
    t = old if is_tensor else torch.from_numpy(np.ascontiguousarray(old))
    assert t.dim() == len(new_shape), (t.shape, new_shape)
    if len(new_shape) > 2:
        assert new_shape[2:] == tuple(t.shape[2:]), (t.shape, new_shape)
    rows = torch.arange(new_shape[0], device=t.device) % t.shape[0]
    if len(new_shape) == 1:
        new = t[rows]
    else:
        cols = torch.arange(new_shape[1], device=t.device) % t.shape[1]
        n_used = torch.ones(t.shape[1], dtype=t.dtype, device=t.device)
        n_used.index_add_(0, cols, torch.ones_like(cols, dtype=t.dtype))
        new = t[rows][:, cols] / n_used[cols].reshape(
            (1, -1) + (1,) * (len(new_shape) - 2))
    return new if is_tensor else new.numpy()


def fit_state_dict(sd: StateDict, target_shapes: Dict[str, tuple],
                   verbose: bool = False) -> StateDict:
    """``fit_tensor`` on every entry whose target shape differs (the
    make_it_fit pass over named parameters); entries absent from
    ``target_shapes`` pass through unchanged."""
    out = {}
    for k, v in sd.items():
        tgt = target_shapes.get(k)
        if tgt is not None and tuple(v.shape) != tuple(tgt):
            if verbose:
                print(f"fit_state_dict: {k} {tuple(v.shape)} -> {tgt}")
            out[k] = fit_tensor(v, tgt)
        else:
            out[k] = v
    return out
