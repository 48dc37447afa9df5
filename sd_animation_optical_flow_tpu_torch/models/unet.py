"""SD-1.5 UNet on torch tensors — the main route.

Counterpart of ``sd_animation_optical_flow_tpu/models/unet.py``: 320 base
channels, mult (1,2,4,4), 2 res blocks per level, spatial transformers
at downsample factors 1/2/4, 8 heads, context dim 768, and the CFG stem
dedup (``context_pair``). NHWC activations at the public functions;
attention in the [B, N, H, D] layout of ``ops/attention.py``.

Ported: ``unet_init``, ``unet_apply`` with and without ``context_pair``,
cross-frame K/V injection (``ref_kv``), MFR strips (``strip``),
materialized attention biases (``attn_biases``, e.g. the banded
multi-frame bias of ``ops/attention.banded_strip_bias``), ControlNet
residuals (``control``), DeepCache's partial forward
(``unet_apply_deepcache``, ``deepcache_feat_shape``) and class / adm
conditioning (``num_classes``, ``y``: a ``label_emb`` row added to the
time embedding, e.g. the upscaler's noise level) and sequence
parallelism (``sp``: the latent's rows sharded over a mesh axis, the
layers that mix rows from ``parallel/spatial.py``, every self-attention
through ``parallel/ring_attention.ulysses_attention``) and tensor
parallelism (``tp``: the transformer blocks' heads and GEGLU columns
split over a mesh axis, ``parallel/sharding.py``'s layout, the
collectives of ``parallel/tensor.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops._cuda import records_grad
from ..ops.attention import attention, attention_injected, strip_attention
from ..ops.ffn import (geglu_ff_fused, geglu_ff_plain, linear_ln_fused,
                      linear_ln_plain)
from ..parallel import spatial as S
from ..parallel.mesh import axis_group
from ..parallel.ring_attention import ulysses_attention
from ..parallel.tensor import copy_to_tp, reduce_from_tp
from .layers import (Init, conv2d, conv2d_init, group_norm, layer_norm,
                     linear, linear_init, norm_init, swish,
                     timestep_embedding, upsample2x_conv)

# SD-1.5 has 16 spatial transformers: 6 encoder, 1 middle, 9 decoder.
NUM_KV_LAYERS = 16


@dataclass(frozen=True)
class StripConfig:
    """Multi-frame-rendering strip self-attention: the latent is a
    width-concatenated strip of ``n_tiles`` frames, and every
    self-attention adds a Gaussian band attraction between
    spatially-corresponding pixels of different tiles.

    mode 'target': tile 0 (the denoised target) is attracted to the
      reference tiles.
    mode 'mutual': all distinct tile pairs attract (seed strips where
      every tile is denoised jointly)."""
    n_tiles: int
    mode: str = "target"


@dataclass(frozen=True)
class SeqParallelConfig:
    """Sequence parallelism over the ranks of ``mesh``'s ``axis``: the
    latent's H (row) axis is sharded over them (row-major tokens, so each
    rank's token range is contiguous), the convolutions exchange halo
    rows and the GroupNorms reduce their statistics across ranks
    (``parallel/spatial.py``), and every self-attention runs Ulysses-style
    (one all-to-all to a head sharding, full-sequence attention on the
    rank's heads, all-to-all back), which composes with the MFR strip
    bias since each rank sees the whole sequence. Needs num_heads and
    every level's row count divisible by the axis size.

    ``mesh``: a ``torch.distributed`` DeviceMesh (``parallel.mesh.
    make_mesh``); every rank of the axis calls the same function with the
    same whole inputs. The axis defaults to "dp", the axis ``make_mesh``
    builds and the JAX CLI shards strips over (the JAX dataclass defaults
    to a name its own mesh does not have)."""
    mesh: DeviceMesh
    axis: str = "dp"

    def __post_init__(self):
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"SeqParallelConfig.mesh must be a torch "
                            f"DeviceMesh, got {type(self.mesh).__name__}")


@dataclass(frozen=True)
class TensorParallelConfig:
    """Tensor parallelism over the ranks of ``mesh``'s 'tp' axis (Megatron
    style, the layout of ``parallel/sharding.py``): each rank holds the
    local tree of ``shard_params`` (``num_heads / tp`` heads and ``4 *
    dim / tp`` GEGLU columns of every transformer block) and the whole
    inputs. The column-split projections (q / k / v, GEGLU up) take the
    LayerNorm's output, or the context, through ``copy_to_tp``; the
    row-split ones (``to_out``, ``ff_out``) give partial sums, reduced
    by ``reduce_from_tp``, after which the whole bias and the residual
    are added once. Convolutions, norms and the time embedding run whole
    on every rank.

    ``mesh``: a ``torch.distributed`` DeviceMesh (``parallel.mesh.
    make_mesh``, whose 'tp' axis ``shard_params`` splits over)."""
    mesh: DeviceMesh

    def __post_init__(self):
        if not isinstance(self.mesh, DeviceMesh):
            raise TypeError(f"TensorParallelConfig.mesh must be a torch "
                            f"DeviceMesh, got {type(self.mesh).__name__}")


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (4, 2, 1)
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    num_classes: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


# ---------------------------------------------------------------------------
# sub-block init
# ---------------------------------------------------------------------------

def _resblock_init(init: Init, in_ch, out_ch, emb_dim):
    p = {
        "in_norm": norm_init(init, in_ch),
        "in_conv": conv2d_init(init, in_ch, out_ch, 3),
        "emb_lin": linear_init(init, emb_dim, out_ch),
        "out_norm": norm_init(init, out_ch),
        "out_conv": conv2d_init(init, out_ch, out_ch, 3, zero=True),
    }
    if in_ch != out_ch:
        p["skip"] = conv2d_init(init, in_ch, out_ch, 1)
    return p


def _resblock(p, x, emb, sp=None):
    h = swish(S.group_norm(p["in_norm"], x, sp))
    h = S.conv2d(p["in_conv"], h, sp)
    h = h + linear(p["emb_lin"], swish(emb))[:, None, None, :]
    h = swish(S.group_norm(p["out_norm"], h, sp))
    h = S.conv2d(p["out_conv"], h, sp)
    if "skip" in p:
        x = conv2d(p["skip"], x)
    return x + h


def _attn_proj_init(init: Init, dim, context_dim, inner):
    return {
        "to_q": linear_init(init, dim, inner, bias=False),
        "to_k": linear_init(init, context_dim, inner, bias=False),
        "to_v": linear_init(init, context_dim, inner, bias=False),
        "to_out": linear_init(init, inner, dim),
    }


def _transformer_block_init(init: Init, dim, context_dim):
    return {
        "norm1": norm_init(init, dim),
        "attn1": _attn_proj_init(init, dim, dim, dim),
        "norm2": norm_init(init, dim),
        "attn2": _attn_proj_init(init, dim, context_dim, dim),
        "norm3": norm_init(init, dim),
        "ff_proj": linear_init(init, dim, dim * 8),   # GEGLU
        "ff_out": linear_init(init, dim * 4, dim),
    }


def _spatial_transformer_init(init: Init, ch, context_dim, depth):
    return {
        "norm": norm_init(init, ch),
        "proj_in": conv2d_init(init, ch, ch, 1),
        "blocks": [_transformer_block_init(init, ch, context_dim)
                   for _ in range(depth)],
        "proj_out": conv2d_init(init, ch, ch, 1, zero=True),
    }


# ---------------------------------------------------------------------------
# attention forward
# ---------------------------------------------------------------------------

def _heads(x, n_heads):
    b, n, c = x.shape
    return x.reshape(b, n, n_heads, c // n_heads)


def _merge_heads(x):
    b, n, h, d = x.shape
    return x.reshape(b, n, h * d)


def _fused_route(x, *weights, dout=None, dff=None) -> bool:
    """Gate for the LN-prologue projection (#3, give its ``dout``) and
    GEGLU (#4, give its ``dff``) kernels: the JAX gates minus their TPU
    test (bf16, feature dim <= 640, at least 4096 rows), and the shapes
    the kernels take: #3 din and dout multiples of 16, #4 din and dff
    multiples of 64. Tensor parallelism gives local shapes they may not
    take (SD's 320 channels over 8 ranks: a QKV of 120 columns, a GEGLU
    of 160). Other shapes take the plain chain, as JAX leaves them to
    XLA; on the CPU the routed call computes its plain version too.

    Neither kernel has a backward, in JAX as here: where a gradient is
    recorded through x or the block's ``weights`` (training), the gate
    is closed and the plain chain runs, as the JAX package's working
    training path runs where its bf16 gate is off."""
    if records_grad(x, *weights):
        return False
    din = x.shape[-1]
    n_rows = x.shape[0] * x.shape[1] if x.ndim == 3 else x.shape[0]
    if dout is not None and (din % 16 or dout % 16):
        return False
    if dff is not None and (din % 64 or dff % 64):
        return False
    return din <= 640 and n_rows >= 4096 and x.dtype == torch.bfloat16


def _ln_proj(x, w, pre_ln, tp=None):
    """``LN(x) @ w^T``: kernel #3 on its gate, else the plain chain. Under
    ``tp`` (the 'tp' process group; w holds this rank's columns) the
    normalised x enters through ``copy_to_tp``, so the LayerNorm's and
    x's gradients sum every rank's columns; the fused route runs only
    where no gradient is recorded, and there the collective is the
    identity."""
    if _fused_route(x, w, *pre_ln.values(), dout=w.shape[0]):
        return linear_ln_fused(x, w, pre_ln["scale"], pre_ln["bias"])
    if tp is None:
        return linear_ln_plain(x, w, pre_ln["scale"], pre_ln["bias"])
    xn = copy_to_tp(layer_norm(pre_ln, x, eps=1e-5), tp)
    return xn @ w.to(x.dtype).t()


def _out_proj(p, h, tp=None):
    """``to_out``: under ``tp`` h holds this rank's heads and w its input
    columns; the partial products are reduced over 'tp' and the whole
    bias is added once after, as ``linear`` adds it after the product."""
    if tp is None:
        return linear(p, h)
    y = reduce_from_tp(h @ p["w"].to(h.dtype).t(), tp)
    return y + p["b"].to(h.dtype)


def _self_attention(p, x, n_heads, pre_ln, ref_kv=None, bias=None,
                    strip=None, hw=None, sp=None, tp=None):
    """Self-attention with the block's norm1 folded into one fused
    [C, 3C] QKV projection; returns (out, (k, v)) with k/v [B, N, C]
    (views of the projection, post-projection, pre-head-split).

    ``strip``: the MFR strip route (``hw`` is the latent's (h, w_strip),
    h the whole latent's rows under ``sp``).
    ``sp``: x holds this rank's tokens; the attention runs through
    :func:`ulysses_attention` (the strip attention as its ``attn_fn``).
    ``ref_kv`` = (rk, rv) [Br, Nr, C], the JAX package's three injection
    cases: Br equal to x's batch replaces K/V wholesale; under the CFG
    batch (Br 1 or B // 2) the cond half attends to the reference K/V
    and the uncond half to its own, key-masked past its own count
    (:func:`attention_injected`).
    ``bias``: an additive attention bias broadcast to [B, H, Nq, Nk]
    (Nk the reference's tokens under ``ref_kv``), taken by the router's
    plain route as in JAX. Under the CFG injection the uncond rows' key
    mask (0 / -1e9) joins it and the sum goes to the same route, as the
    JAX package composes them.
    ``tp``: the 'tp' process group; the block holds this rank's
    ``n_heads`` heads, and the captured k / v are their columns."""
    wqkv = torch.cat([p["to_q"]["w"], p["to_k"]["w"], p["to_v"]["w"]],
                     dim=0).to(x.dtype)
    q, k, v = _ln_proj(x, wqkv, pre_ln, tp).chunk(3, dim=-1)
    captured = (k, v)
    heads = lambda t: _heads(t, n_heads)
    if sp is not None:
        attn_fn = None
        if strip is not None and strip.n_tiles > 1:
            attn_fn = lambda qh, kh, vh: strip_attention(
                qh, kh, vh, h=hw[0], w_strip=hw[1], n_tiles=strip.n_tiles,
                mode=strip.mode)
        out = ulysses_attention(heads(q), heads(k), heads(v), sp.mesh,
                                seq_axis=sp.axis, attn_fn=attn_fn)
        return linear(p["to_out"], _merge_heads(out)), captured
    if strip is not None and strip.n_tiles > 1:
        if ref_kv is not None or bias is not None:
            raise ValueError("strip MFR attention does not compose with "
                             "ref_kv or attn_biases")
        out = strip_attention(heads(q), heads(k), heads(v), h=hw[0],
                              w_strip=hw[1], n_tiles=strip.n_tiles,
                              mode=strip.mode)
        return linear(p["to_out"], _merge_heads(out)), captured
    if ref_kv is not None:
        rk, rv = (t.to(x.dtype) for t in ref_kv)
        b = x.shape[0]
        if rk.shape[0] == b:
            k, v = rk, rv
        else:
            if rk.shape[0] not in (1, b // 2) or b % 2:
                raise ValueError(f"reference K/V batch {rk.shape[0]} fits "
                                 f"neither batch {b} nor its CFG half")
            # [own | reference] rows: the reference K/V for both halves,
            # then the uncond half's own K/V over its first tokens. The
            # JAX package fills the uncond rows past n_own with tiled
            # copies of the own K/V (its TPU kernel's block grid wanted
            # them); neither kernel #6 nor the plain version reads a key
            # there, so the reference's (finite) values stay instead
            nref, n = rk.shape[1], k.shape[1]
            kv = []
            for own, ref in ((k, rk), (v, rv)):
                both = ref.expand(b // 2, -1, -1).repeat(2, 1, 1)
                both[: b // 2, :n] = own[: b // 2, :nref]
                kv.append(both)
            k, v = kv
            if bias is None:
                out = attention_injected(heads(q), heads(k), heads(v),
                                         n_own=n, n_uncond=b // 2)
                return linear(p["to_out"], _merge_heads(out)), captured
            mask = torch.zeros((b, nref), device=x.device)
            mask[: b // 2, n:] = -1e9
            bias = bias + mask[:, None, None, :]
    out = attention(heads(q), heads(k), heads(v), bias=bias)
    return _out_proj(p["to_out"], _merge_heads(out), tp), captured


def _cross_attention(p, x, context, n_heads, pre_ln, tp=None):
    # LN2 feeds only the Q projection (K/V come from the context, which
    # under tp enters this rank's columns through copy_to_tp too)
    q = _ln_proj(x, p["to_q"]["w"], pre_ln, tp)
    wkv = torch.cat([p["to_k"]["w"], p["to_v"]["w"]], dim=0).to(x.dtype)
    context = context.to(x.dtype)
    if tp is not None:
        context = copy_to_tp(context, tp)
    k, v = (context @ wkv.t()).chunk(2, dim=-1)
    out = attention(_heads(q, n_heads), _heads(k, n_heads),
                    _heads(v, n_heads))
    return _out_proj(p["to_out"], _merge_heads(out), tp)


def _ff_tail(p, x, tp=None):
    """The transformer-block tail ``x + FF(LN3(x))``: the fused GEGLU
    kernel (LN prologue, residual epilogue) on the JAX package's gate,
    else the plain composition.

    Under ``tp`` (the 'tp' process group; ``ff_proj`` holds this rank's
    paired value and gate rows, ``ff_out`` its input columns) each rank's
    product is a partial sum: the kernel runs with ``residual=False`` and
    a zero bias (the plain chain likewise, on ``copy_to_tp`` of the
    normalised x), the partial sums are reduced over 'tp', and then
    ``ff_out``'s bias and the residual x are added once, on every rank."""
    w1, b1 = p["ff_proj"]["w"], p["ff_proj"]["b"]
    w2, b2 = p["ff_out"]["w"], p["ff_out"]["b"]
    ln = p["norm3"]
    fused = _fused_route(x, w1, b1, w2, b2, *ln.values(), dff=w2.shape[1])
    if tp is None:
        ff = geglu_ff_fused if fused else geglu_ff_plain
        return ff(x, w1, b1, w2, b2, ln["scale"], ln["bias"], residual=True)
    zero = torch.zeros_like(b2, dtype=x.dtype)
    if fused:
        part = geglu_ff_fused(x, w1, b1, w2, zero, ln["scale"], ln["bias"],
                              residual=False)
    else:
        xn = copy_to_tp(layer_norm(ln, x, eps=1e-5), tp)
        part = geglu_ff_plain(xn, w1, b1, w2, zero)
    return x + (reduce_from_tp(part, tp) + b2.to(x.dtype))


def _spatial_transformer(p, x, context, n_heads, ref_kv=None,
                         attn_bias=None, strip=None, cfg_pair=None, sp=None,
                         tp=None):
    """Returns (out, kv_list) — one (k, v) per depth block.
    ``attn_bias``: the additive bias of every self-attention (see
    :func:`_self_attention`). ``sp``: x holds this rank's rows. ``tp``:
    the 'tp' process group; ``n_heads`` is this rank's head count.

    ``cfg_pair=(ctx_u, ctx_c)``: CFG stem dedup — ``x`` arrives at HALF
    the CFG batch, the self-attention runs once on it, and the batch
    doubles at the cross-attention where the two contexts first differ.
    Returns a full-batch output."""
    b, h, w, c = x.shape
    res = x
    x = S.group_norm(p["norm"], x, sp, eps=1e-6)
    x = conv2d(p["proj_in"], x)
    x = x.reshape(b, h * w, c)
    kvs = []
    expand = cfg_pair is not None
    h_all = h if sp is None else h * S.group_of(sp)[2]
    for blk in p["blocks"]:
        a1, kv = _self_attention(blk["attn1"], x, n_heads, blk["norm1"],
                                 ref_kv=ref_kv, bias=attn_bias, strip=strip,
                                 hw=(h_all, w), sp=sp, tp=tp)
        x = x + a1
        kvs.append(kv)
        if expand:
            x = torch.cat([x, x], dim=0)
            context = torch.cat([cfg_pair[0], cfg_pair[1]],
                                dim=0).to(x.dtype)
            res = torch.cat([res, res], dim=0)
            b = x.shape[0]
            expand = False
        x = x + _cross_attention(blk["attn2"], x, context, n_heads,
                                 blk["norm2"], tp)
        x = _ff_tail(blk, x, tp)
    x = x.reshape(b, h, w, c)
    x = conv2d(p["proj_out"], x)
    return x + res, kvs


# ---------------------------------------------------------------------------
# UNet init / apply
# ---------------------------------------------------------------------------

def unet_init(init: Init, cfg: UNetConfig = UNetConfig()):
    mc = cfg.model_channels
    ted = cfg.time_embed_dim
    p: dict = {"time_embed": [linear_init(init, mc, ted),
                              linear_init(init, ted, ted)]}
    if cfg.num_classes is not None:
        # N(0, 1), torch's nn.Embedding default
        p["label_emb"] = init.normal((cfg.num_classes, ted))
    input_blocks: list = [{"conv": conv2d_init(init, cfg.in_channels, mc, 3)}]
    ch = mc
    input_chans = [mc]
    ds = 1
    for lvl, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _resblock_init(init, ch, mult * mc, ted)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk["transformer"] = _spatial_transformer_init(
                    init, ch, cfg.context_dim, cfg.transformer_depth)
            input_blocks.append(blk)
            input_chans.append(ch)
        if lvl != len(cfg.channel_mult) - 1:
            input_blocks.append({"down": conv2d_init(init, ch, ch, 3)})
            input_chans.append(ch)
            ds *= 2
    p["input_blocks"] = input_blocks
    p["middle"] = {
        "res1": _resblock_init(init, ch, ch, ted),
        "transformer": _spatial_transformer_init(
            init, ch, cfg.context_dim, cfg.transformer_depth),
        "res2": _resblock_init(init, ch, ch, ted),
    }
    output_blocks = []
    for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            skip_ch = input_chans.pop()
            blk = {"res": _resblock_init(init, ch + skip_ch, mult * mc, ted)}
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                blk["transformer"] = _spatial_transformer_init(
                    init, ch, cfg.context_dim, cfg.transformer_depth)
            if lvl != 0 and i == cfg.num_res_blocks:
                blk["up"] = conv2d_init(init, ch, ch, 3)
                ds //= 2
            output_blocks.append(blk)
    p["output_blocks"] = output_blocks
    p["out"] = {"norm": norm_init(init, ch),
                "conv": conv2d_init(init, ch, cfg.out_channels, 3,
                                    zero=True)}
    return p


def unet_apply(params, cfg: UNetConfig, x, timesteps, context,
               ref_kv: Optional[Tuple] = None,
               control: Optional[Tuple] = None,
               attn_biases: Optional[dict] = None,
               y: Optional[torch.Tensor] = None,
               strip: Optional[StripConfig] = None,
               sp: Optional[SeqParallelConfig] = None,
               context_pair: Optional[Tuple] = None,
               capture_kv: bool = True,
               tp: Optional[TensorParallelConfig] = None):
    """Forward pass.

    Args:
      x: [B, H, W, in_channels] latents (9 channels for the inpainting
        UNet: latent, mask, masked-image latent).
      timesteps: [B] diffusion timesteps.
      context: [B, L, context_dim] text conditioning.
      ref_kv: None, or a 16-tuple (capture order) of None / (k, v) pairs,
        k and v [Br, Nr, C], injected into the self-attentions (see
        ``_self_attention`` for the batch cases).
      attn_biases: optional {layer_idx: bias} additive self-attention
        biases (capture order, as ``ref_kv``), each broadcast to [B, H,
        Nq, Nk] at its layer, e.g. ``banded_strip_bias(h, w, n)[None,
        None]`` for queries of one frame against ``ref_kv`` of n frames.
        Biased attention takes the router's plain route, as in JAX.
      strip: optional StripConfig — x is a width-concatenated strip and
        every self-attention adds the MFR band bias.
      context_pair: optional (ctx_u, ctx_c) — CFG stem dedup. ``x`` and
        ``timesteps`` arrive at HALF the CFG batch; the stem (input conv,
        first resblock, first self-attention) runs once and the batch
        doubles at the first cross-attention. Output batch is 2B
        ([uncond|cond]); ``context`` is ignored. Composes with ``strip``
        (a positional bias, the same for both halves), not with
        ``ref_kv`` or ``attn_biases``.
      control: None, or a 13-tuple of ControlNet residuals (NHWC, the
        full CFG batch): 0..11 are added to the encoder skips, consumed
        last-to-first, 12 to the middle block's output. With
        ``context_pair`` they are added on the decoder side, after the
        batch has doubled, so the stem dedup composes with them.
      y: [B] int class labels (adm conditioning, e.g. the upscaler's
        noise level); required iff ``cfg.num_classes`` is set (ValueError
        otherwise, either way). Not with ``context_pair``.
      sp: optional SeqParallelConfig — every rank of its mesh axis passes
        the same whole inputs; each slices its rows of x (and of the
        ControlNet residuals), runs the blocks on them and all-gathers
        the output rows once, so the call takes and returns whole
        latents, as the JAX function does under GSPMD. Composes with
        ``strip``, ``control`` and ``y``; not with ``ref_kv``,
        ``attn_biases`` or ``context_pair`` (ValueError). Needs
        ``num_heads`` and the row count of every level divisible by the
        axis size (ValueError).
      capture_kv: under ``sp``, whether kv_hist is wanted: its K/V are
        gathered to whole tokens (two all-gathers a layer) only then, and
        kv_hist is None otherwise. Without ``sp`` the pairs are views of
        the projections and are always returned.
      tp: optional TensorParallelConfig — ``params`` is this rank's local
        tree (``parallel.sharding.shard_params``) and every rank of the
        mesh axis passes the same whole inputs and gets the whole output.
        The captured K/V hold this rank's heads' columns. The collectives
        run whenever ``tp`` is given, at an axis of size 1 too. Composes
        with ``context_pair``, ``strip``, ``control`` and ``y``; not with
        ``sp``, ``ref_kv`` or ``attn_biases`` (ValueError). Needs
        ``num_heads`` divisible by the axis size, and so every level's
        GEGLU width (ValueError); GSPMD pads instead.

    Returns:
      (out [B, H, W, out_channels], kv_hist tuple of per-layer (k, v)).
    """
    if context_pair is not None and (ref_kv is not None
                                     or attn_biases is not None
                                     or y is not None):
        raise ValueError("context_pair (CFG stem dedup) does not compose "
                         "with ref_kv, attn_biases or y")
    if tp is not None and sp is not None:
        raise ValueError("tensor parallelism (tp) does not compose with "
                         "sequence parallelism (sp)")
    if sp is not None:
        if not isinstance(sp, SeqParallelConfig):
            raise TypeError(f"sp must be a SeqParallelConfig, got "
                            f"{type(sp).__name__}")
        if ref_kv is not None or attn_biases is not None \
                or context_pair is not None:
            raise ValueError("sequence parallelism (sp) does not compose "
                             "with ref_kv, attn_biases or context_pair")
        n = S.group_of(sp)[2]
        if cfg.num_heads % n:
            raise ValueError(f"{cfg.num_heads} heads do not divide over "
                             f"{n} sequence-parallel ranks")
        S.check_rows(sp, x.shape[1], len(cfg.channel_mult))
        x = S.shard_rows(x, sp)
        if control is not None:
            control = tuple(S.shard_rows(c, sp) for c in control)
    tp_group = None
    nh = cfg.num_heads
    if tp is not None:
        if not isinstance(tp, TensorParallelConfig):
            raise TypeError(f"tp must be a TensorParallelConfig, got "
                            f"{type(tp).__name__}")
        if ref_kv is not None or attn_biases is not None:
            raise ValueError("tensor parallelism (tp) does not compose with "
                             "ref_kv or attn_biases")
        tp_group, _, n = axis_group(tp.mesh, "tp")
        # every level's channels split into whole heads, so the GEGLU
        # width (4 x channels) divides over the ranks where the heads do
        if nh % n:
            raise ValueError(f"{nh} heads do not divide over {n} "
                             f"tensor-parallel ranks")
        nh //= n
    if (cfg.num_classes is None) != (y is None):
        raise ValueError("class labels y are required iff the UNet is "
                         f"class-conditional (num_classes "
                         f"{cfg.num_classes}, y given: {y is not None})")
    t_emb = timestep_embedding(timesteps, cfg.model_channels, dtype=x.dtype)
    emb = linear(params["time_embed"][1],
                 swish(linear(params["time_embed"][0], t_emb)))
    if y is not None:
        emb = emb + params["label_emb"][
            torch.as_tensor(y, device=emb.device).long()].to(emb.dtype)

    half = context_pair is not None
    ctx = None if half else context
    kv_hist: list = []
    hs = []
    layer = 0       # spatial transformers so far: ref_kv's index

    def tfm(p, h):
        nonlocal half, emb, ctx, hs, layer
        layer += 1
        if not half:
            rkv = ref_kv[layer - 1] if ref_kv is not None else None
            bias = attn_biases.get(layer - 1) if attn_biases else None
            h, kvs = _spatial_transformer(p, h, ctx, nh, ref_kv=rkv,
                                          attn_bias=bias, strip=strip, sp=sp,
                                          tp=tp_group)
            kv_hist.extend(kvs)
            return h
        h, kvs = _spatial_transformer(p, h, None, nh, strip=strip,
                                      cfg_pair=context_pair, tp=tp_group)
        kv_hist.extend(kvs)
        half = False
        emb = torch.cat([emb, emb], dim=0)
        ctx = torch.cat([context_pair[0], context_pair[1]],
                        dim=0).to(h.dtype)
        # skips recorded before the expansion double here
        hs = [torch.cat([s, s], dim=0) for s in hs]
        return h

    h = x
    for blk in params["input_blocks"]:
        if "conv" in blk:
            h = S.conv2d(blk["conv"], h, sp)
        elif "down" in blk:
            h = S.conv2d(blk["down"], h, sp, stride=2, padding=1)
        else:
            h = _resblock(blk["res"], h, emb, sp)
            if "transformer" in blk:
                h = tfm(blk["transformer"], h)
        hs.append(h)

    h = _resblock(params["middle"]["res1"], h, emb, sp)
    h = tfm(params["middle"]["transformer"], h)
    h = _resblock(params["middle"]["res2"], h, emb, sp)
    if control is not None:
        h = h + control[-1].to(h.dtype)     # the middle residual is last

    for i, blk in enumerate(params["output_blocks"]):
        skip = hs.pop()
        if control is not None:
            # the encoder residuals, consumed last-to-first
            skip = skip + control[len(control) - 2 - i].to(h.dtype)
        h = torch.cat([h, skip], dim=-1)
        h = _resblock(blk["res"], h, emb, sp)
        if "transformer" in blk:
            h = tfm(blk["transformer"], h)
        if "up" in blk:
            h = S.upsample2x_conv(blk["up"], h, sp)

    h = swish(S.group_norm(params["out"]["norm"], h, sp))
    out = S.conv2d(params["out"]["conv"], h, sp)
    if sp is None:
        return out, tuple(kv_hist)
    kv_hist = tuple(
        tuple(S.gather(torch.stack(kv), sp, dim=2).unbind(0))
        for kv in kv_hist) if capture_kv else None
    return S.gather(out, sp), kv_hist


def unet_apply_deepcache(params, cfg: UNetConfig, x, timesteps, context,
                         *, deep_cache=None):
    """DeepCache's partial forward (training-free step acceleration).

    The deep segment (the levels below the first, the middle block and
    their decoder blocks) changes slowly across adjacent denoise steps.
    Without ``deep_cache`` the whole net runs and the feature entering
    the shallowest decoder stage is returned beside the output; with
    ``deep_cache=<that feature>`` the deep segment is skipped: only the
    shallow encoder blocks (for their skips) and the shallow decoder
    blocks run; the shallow part is the whole first level (its
    num_res_blocks + 1 input blocks). Plain cross-attention conditioning only: no K/V injection,
    ControlNet or stem dedup (the batch is the full CFG batch).

    Returns (out, deep_feat): the captured feature, or ``deep_cache``
    passed through."""
    if len(cfg.channel_mult) < 2:
        raise ValueError("DeepCache needs at least two UNet levels")
    cb = cfg.num_res_blocks + 1
    nh = cfg.num_heads
    t_emb = timestep_embedding(timesteps, cfg.model_channels, dtype=x.dtype)
    emb = linear(params["time_embed"][1],
                 swish(linear(params["time_embed"][0], t_emb)))

    def run_block(blk, h):
        if "conv" in blk:
            return conv2d(blk["conv"], h)
        if "down" in blk:
            return conv2d(blk["down"], h, stride=2, padding=1)
        h = _resblock(blk["res"], h, emb)
        if "transformer" in blk:
            h, _ = _spatial_transformer(blk["transformer"], h, context, nh)
        return h

    def run_decoder(blocks, h, hs):
        for blk in blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = _resblock(blk["res"], h, emb)
            if "transformer" in blk:
                h, _ = _spatial_transformer(blk["transformer"], h, context,
                                            nh)
            if "up" in blk:
                h = upsample2x_conv(blk["up"], h)
        return h

    hs = []
    h = x
    for blk in params["input_blocks"][:cb]:
        h = run_block(blk, h)
        hs.append(h)
    out_blocks = params["output_blocks"]
    if deep_cache is None:
        for blk in params["input_blocks"][cb:]:
            h = run_block(blk, h)
            hs.append(h)
        h = _resblock(params["middle"]["res1"], h, emb)
        h, _ = _spatial_transformer(params["middle"]["transformer"], h,
                                    context, nh)
        h = _resblock(params["middle"]["res2"], h, emb)
        h = run_decoder(out_blocks[:len(out_blocks) - cb], h, hs)
        deep_feat = h
    else:
        deep_feat = deep_cache
        h = deep_cache.to(x.dtype)
    # the tail consumes exactly the shallow skips
    h = run_decoder(out_blocks[-cb:], h, hs)
    h = swish(group_norm(params["out"]["norm"], h))
    return conv2d(params["out"]["conv"], h), deep_feat


def deepcache_feat_shape(cfg: UNetConfig, batch: int, h: int, w: int):
    """Shape of :func:`unet_apply_deepcache`'s cached feature at latent
    resolution (h, w): the upsampled second-level decoder output."""
    return (batch, h, w, cfg.model_channels * cfg.channel_mult[1])
