"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: these skip where there is no NVIDIA card (a CUDA kernel
has no CPU or interpret mode; the CPU tests hold the plain versions to
the JAX package instead). On a machine with a card, and without JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest

Shapes are small but cover the kernels' edges: ragged query and key
tiles (for the Hopper forward of #1 and #7: Nq off its 192-row units,
Nk = 1, below a key tile, a tile exactly and one key either side, 231),
head dims from 8 to 128 that are not all a multiple of 16 (zero-padded
tiles), strided and misaligned q/k/v views, single-head views whose
neighbouring columns are NaN (no read past D); for the wide kernel (#2,
d > 128) d padded to each of its four widths, Nq off its 64-row blocks,
Nk off its key tiles and below one, B * H > 1, the router's 160-wide
route and its refusal under a gradient; for the keymask kernel n_own = Nk, n_own off
the 64- and 128-key tiles, n_uncond = 0, B / 2 and B, units past the first
and the injected inpaint's L0 at full size, and at DP = 160 (32-key
tiles) Nq off the 192-row unit and off 128 rows, d 136 and 152, the
fused-QKV strides and the injected inpaint's L2 (``KEYMASK_CASES``); for
the LN projection (#3)
M, din and dout off its row block, k panel and column tiles, both of its
column-tile widths and a split with uneven halves; for the MFR kernel
ragged N, 3 and 4 tiles, both modes and key tiles outside the band, the
table and the per-pair bias, at d <= 128 and at DP = 160 (N off 128 and
192 rows, d 136, 152 and 160, the 4-tile strip's L2) (``MFR_CASES``); for the
banded kernel (``BANDED_CASES``, weight 0 and 0.7) the three UNet
levels' frame geometries, frames whose h * w is not a multiple of the
key tile (tiles straddling a frame boundary), base = -inf, d 136 and 152
(DP = 160), Nq off the 192-row unit, 4 frames, radius 0, 3, 9 (past the
table) and past max(h, w) (every pair in band), w off a multiple of 8
(the per-pair bias) and q a slice of the fused QKV projection, two calls
bitwise equal; for the
forward with statistics and the two backward kernels (#7-#9) ragged
query and key tiles, Nq and Nk off the backward's 128- and 192-row work
units and its 32- and 64-row streamed tiles, one key, d from 8 to 128,
NaN columns past d, two calls bitwise equal, and the fused-QKV slices
(directly and under autograd). Every wrapper whose kernel has no backward refuses inputs
that record a gradient.
Tolerance: max |kernel - plain| <= 2e-2 * max |plain|,
with no floor (a few bf16 ulps of the largest output; both sides round
bf16 products accumulated in f32)."""

import pytest
import torch

from sd_animation_optical_flow_tpu_torch.ops import attention as TA
from sd_animation_optical_flow_tpu_torch.ops import ffn as TF

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.Generator("cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(dtype)


def _check(out, ref):
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= TOL * scale


# the Hopper kernel's edges: Nq below, one past and not a multiple of its
# 192 query rows (and exactly two units), Nk = 1, below one key tile (128
# keys for d <= 48, 64 above), one tile exactly and one key either side,
# the 3 x 77 prompt (231), and d from 8 to 128 (d padded to a multiple
# of 16 in shared memory)
TPV_CASES = [(2, 300, 231, 3, 40), (1, 130, 257, 2, 80), (1, 77, 64, 2, 128),
             (1, 50, 90, 2, 24), (1, 200, 1, 2, 8), (2, 129, 128, 2, 16),
             (1, 257, 127, 1, 64), (1, 140, 129, 2, 40), (1, 100, 63, 2, 80),
             (1, 70, 65, 1, 128), (2, 64, 231, 2, 40), (1, 131, 231, 2, 80),
             (1, 90, 129, 2, 80), (1, 193, 127, 2, 40), (1, 384, 64, 1, 64),
             (2, 400, 231, 2, 80)]


@pytest.mark.parametrize("b,nq,nk,h,d", TPV_CASES + [(1, 33, 40, 1, 512)])
def test_flash_attention_tpv_kernel(gen, b, nq, nk, h, d):
    q = _randn(gen, b, nq, h, d)
    k = _randn(gen, b, nk, h, d)
    v = _randn(gen, b, nk, h, d)
    n0 = TA.flash_attention_tpv.launches
    _check(TA.flash_attention_tpv(q, k, v), TA.xla_attention(q, k, v))
    assert TA.flash_attention_tpv.launches == n0 + 1


@pytest.mark.parametrize("offset", [0, 1])
def test_flash_attention_tpv_strided_qkv(gen, offset):
    """q/k/v as column slices of one fused projection: offset 0 keeps
    16-byte rows and goes in without a copy, offset 1 breaks them and
    takes the wrapper's contiguous copy."""
    qkv = _randn(gen, 2, 200, offset + 3 * 320)[..., offset:]
    q, k, v = (t.reshape(2, 200, 8, 40) for t in qkv.chunk(3, dim=-1))
    _check(TA.flash_attention_tpv(q, k, v), TA.xla_attention(q, k, v))


@pytest.mark.parametrize("fwd,d", [("tpv", 40), ("stats", 40), ("wide", 512),
                                   ("wide", 136), ("bwd", 40), ("bwd", 128),
                                   ("banded", 40), ("banded", 152)])
def test_attention_reads_no_column_past_d(gen, fwd, d):
    """A single-head q/k/v view [..., :d] of [B, N, 2 d] tensors whose
    columns d.. are NaN (the next head of a fused projection): the
    kernels read no column past D, so out (and lse, and the backward's
    dQ, dK, dV, with dO such a view too) stay finite and match the plain
    version on the clean columns. d = 136 leaves the wide kernel's second
    d-half 7 of its 10 chunks; the banded kernel takes one 10 x 20 frame
    of queries against two frames of keys (d = 152: DP 160)."""
    def view(n):
        t = _randn(gen, 2, n, 2 * d)
        t[..., d:] = float("nan")
        return t[..., :d].unsqueeze(2)
    q, k, v = view(200), view(400 if fwd == "banded" else 231), \
        view(400 if fwd == "banded" else 231)
    clean = [t.contiguous() for t in (q, k, v)]
    if fwd == "banded":
        kw = dict(h=10, w=20, weight=0.7)
        _check(TA.flash_attention_banded(q, k, v, **kw),
               TA.flash_attention_banded_plain(*clean, **kw))
    elif fwd == "tpv":
        _check(TA.flash_attention_tpv(q, k, v), TA.xla_attention(*clean))
    elif fwd == "wide":
        _check(TA.flash_attention(q, k, v), TA.xla_attention(*clean))
    elif fwd == "bwd":
        do = view(200)
        clean.append(do.contiguous())
        out, lse = TA.flash_fwd_stats_plain(*clean[:3])
        dvec = TA.flash_dvec(out, clean[3])
        _check(TA.flash_bwd_dq(q, k, v, do, lse, dvec),
               TA._bwd_dq_plain(*clean, lse, dvec))
        for got, ref in zip(TA.flash_bwd_dkv(q, k, v, do, lse, dvec),
                            TA._bwd_dkv_plain(*clean, lse, dvec)):
            _check(got, ref)
    else:
        out, lse = TA.flash_fwd_stats(q, k, v)
        ref_out, ref_lse = TA.flash_fwd_stats_plain(*clean)
        _check(out, ref_out)
        _check(lse, ref_lse)


# the wide kernel's edges: d padded to DP = 160, 256, 384, 512 (halves of
# 80, 128, 192, 256; d = 136 and 264 leave the second half partly
# padded), Nq off its 64-row blocks and its clusters of 2 or 4 blocks,
# Nk off its key tiles (32 keys above d = 256, 64 below; and below one
# tile, and 1), B * H > 1
WIDE_CASES = [(1, 70, 100, 1, 512), (1, 70, 100, 1, 160),
              (1, 130, 257, 1, 512), (1, 64, 40, 1, 512), (1, 200, 1, 1, 512),
              (1, 100, 64, 1, 136), (1, 77, 129, 2, 264), (1, 50, 90, 2, 256),
              (1, 96, 65, 3, 392), (2, 300, 231, 1, 512),
              (2, 257, 191, 8, 160), (1, 129, 63, 2, 168)]


@pytest.mark.parametrize("b,nq,nk,h,d", WIDE_CASES)
def test_flash_attention_wide_kernel(gen, b, nq, nk, h, d):
    q = _randn(gen, b, nq, h, d)
    k = _randn(gen, b, nk, h, d)
    v = _randn(gen, b, nk, h, d)
    n0 = TA.flash_attention.launches
    _check(TA.flash_attention(q, k, v), TA.xla_attention(q, k, v))
    assert TA.flash_attention.launches == n0 + 1


def test_attention_routes_wide_heads_to_the_wide_kernel(gen):
    """Past the self-attention gate (Nq, Nk >= 1536) a 160-wide head goes
    to flash_attention's kernel; under a gradient the route raises, as
    the JAX flash_attention has no VJP."""
    q, k, v = (_randn(gen, 1, 1536, 2, 160) for _ in range(3))
    n0 = TA.flash_attention.launches
    _check(TA.attention(q, k, v), TA.xla_attention(q, k, v))
    assert TA.flash_attention.launches == n0 + 1
    q = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        TA.attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        TA.flash_attention(q, k, v)
    assert TA.flash_attention.launches == n0 + 1


# the Hopper kernel's edges (128-row blocks, 160-column tiles up to din
# 384 and 64-column tiles above, the column tiles split across blocks,
# 64-column k panels): M off the row block (37, 100, 4000), dout below
# one tile (48) and off the tile (176), din off the 64-column panel (208),
# the UNet's L0 and L1 projections (din 320 -> 960, 320; 640 -> 1920,
# 640), at full size too (more than one wave of blocks), and 19 tiles
# over two splits (6144 x 640 -> 1216: 10 and 9 tiles); two calls
# bitwise equal (no atomics)
@pytest.mark.parametrize("m,din,dout", [
    (100, 320, 960), (64, 640, 640), (37, 64, 48), (4000, 320, 960),
    (300, 640, 1920), (200, 208, 176), (12288, 320, 960),
    (6144, 640, 1920), (6144, 640, 1216)])
def test_linear_ln_kernel(gen, m, din, dout):
    x = _randn(gen, m, din)
    w = _randn(gen, dout, din, scale=din ** -0.5)
    g = 1 + 0.1 * torch.randn(din, generator=gen, device="cuda")
    bta = 0.1 * torch.randn(din, generator=gen, device="cuda")
    n0 = TF.linear_ln_fused.launches
    out = TF.linear_ln_fused(x, w, g, bta)
    _check(out, TF.linear_ln_plain(x, w, g, bta, 1e-5))
    assert torch.equal(out, TF.linear_ln_fused(x, w, g, bta))
    assert TF.linear_ln_fused.launches == n0 + 2


# the two Hopper kernels' edges (128-row blocks; the up kernel's 64-wide
# dff tiles split across blocks, the down kernel's 160 / 128 / 64 output
# columns a block): M off the row block (100, 45, 4000), the UNet's L0
# and L1 widths (din 320 / dff 1280, din 640 / dff 2560: 160 columns),
# din 128 (128 columns), 64 and 192 (64 columns), with and without LN and
# the residual, 13 dff tiles (a split that cannot divide them evenly), and
# the L0 / L1 tails at full size (more than one wave of blocks); two calls
# bitwise equal (no atomics)
@pytest.mark.parametrize("m,din,dff,ln,residual", [
    (100, 320, 1280, True, True), (45, 640, 2560, True, True),
    (64, 64, 256, False, False), (100, 192, 768, False, True),
    (100, 128, 512, True, False), (4000, 320, 832, True, True),
    (12288, 320, 1280, True, True), (6144, 640, 2560, True, True)])
def test_geglu_kernel(gen, m, din, dff, ln, residual):
    x = _randn(gen, m, din)
    w1 = _randn(gen, 2 * dff, din, scale=din ** -0.5)
    b1 = _randn(gen, 2 * dff, scale=0.1)
    w2 = _randn(gen, din, dff, scale=dff ** -0.5)
    b2 = _randn(gen, din, scale=0.1)
    g = 1 + 0.1 * torch.randn(din, generator=gen, device="cuda") \
        if ln else None
    bta = 0.1 * torch.randn(din, generator=gen, device="cuda") \
        if ln else None
    out = TF.geglu_ff_fused(x, w1, b1, w2, b2, g, bta, residual=residual)
    _check(out, TF.geglu_ff_plain(x, w1, b1, w2, b2, g, bta, 1e-5, residual))
    assert torch.equal(out, TF.geglu_ff_fused(x, w1, b1, w2, b2, g, bta,
                                              residual=residual))


# attention_sm90_kernel's keymask mode: three consumers, 192-row units,
# 128-key tiles at d <= 48, 64 up to d = 128, 32 at d 136-160; q, k and v
# apart, or slices of the fused projections as the UNet passes them; two
# calls bitwise equal, each one launch at the padded head width
KEYMASK_CASES = [
    (2, 200, 400, 2, 40, 200, 1, False),       # the CFG batch, one reference
    (2, 100, 300, 2, 80, 300, 1, False),       # n_own = Nk: nothing masked
    (2, 130, 390, 3, 40, 130, 1, False),       # n_own not a multiple of 64
    (4, 96, 200, 2, 24, 96, 2, False),         # n_uncond = B / 2, ragged Nk
    (2, 64, 100, 1, 40, 30, 2, False),         # every row masked
    (2, 96, 200, 2, 160, 96, 1, False),        # SD-1.5's L2 head width
    (2, 70, 130, 1, 152, 70, 1, False),        # d padded up to 160
    (2, 200, 400, 2, 40, 150, 1, False),       # n_own off the 128-key tile
    (2, 100, 300, 2, 80, 100, 1, False),       # n_own off the 64-key tile
    (2, 96, 200, 2, 40, 50, 0, False),         # n_uncond = 0: nothing masked
    (3, 80, 160, 2, 64, 70, 3, False),         # n_uncond = B: every row masked
    (2, 450, 500, 2, 40, 260, 1, False),       # 3 units, the last ragged
    (2, 6144, 12288, 8, 40, 6144, 1, False),   # the injected inpaint's L0
    # DP = 160: Nq off 128 rows, n_own off the 32- and 64-key tiles,
    # ragged Nk; Nq off 192 and 128 with n_uncond = B and B * H = 6; d 136
    # and 152 padded to 160, Nk one key past two tiles and below one; the
    # injected inpaint's L2 at a 1024x1536 frame; then the same on the
    # fused strides
    (2, 130, 300, 2, 160, 100, 1, False),
    (2, 200, 390, 3, 160, 200, 2, False),
    (3, 257, 129, 2, 136, 65, 3, False),
    (2, 64, 63, 4, 152, 63, 1, False),
    (2, 1536, 3072, 8, 160, 1536, 1, False),
    (2, 200, 390, 2, 160, 130, 1, True),
    (2, 130, 200, 3, 152, 70, 2, True),
    (2, 1536, 3072, 8, 160, 1536, 1, True)]


@pytest.mark.parametrize("b,nq,nk,h,d,n_own,n_uncond,fused", KEYMASK_CASES)
def test_flash_attention_keymask_kernel(gen, b, nq, nk, h, d, n_own,
                                        n_uncond, fused):
    if fused:   # q a slice of the QKV projection, k / v of one [B, Nk, 2 H D]
        q = _randn(gen, b, nq, 3 * h * d)[..., :h * d].reshape(b, nq, h, d)
        k, v = (t.reshape(b, nk, h, d) for t in
                _randn(gen, b, nk, 2 * h * d).chunk(2, dim=-1))
    else:
        q = _randn(gen, b, nq, h, d)
        k = _randn(gen, b, nk, h, d)
        v = _randn(gen, b, nk, h, d)
    dp = -(-d // 16) * 16
    n0 = TA.flash_attention_keymask.launches
    n0_dp = TA.flash_attention_keymask.launches_by_dp.get(dp, 0)
    out = TA.flash_attention_keymask(q, k, v, n_own=n_own, n_uncond=n_uncond)
    again = TA.flash_attention_keymask(q, k, v, n_own=n_own,
                                       n_uncond=n_uncond)
    _check(out, TA.attention_injected_plain(q, k, v, n_own=n_own,
                                            n_uncond=n_uncond))
    assert torch.equal(out, again)
    assert TA.flash_attention_keymask.launches == n0 + 2
    assert TA.flash_attention_keymask.launches_by_dp[dp] == n0_dp + 2


# the MFR kernel's edges: ragged N and N below one 192-row unit, 3 and 4
# tiles, both modes, key tiles outside the band, units straddling strip
# rows (w_strip = 80, 100), `target` with a warpgroup wholly outside tile
# 0 (w_strip = 192: rows 128-191 of a unit are tile 1), radius 0, a radius
# clamped to the table's widest (100 -> 7) and one past the table (10),
# fused-QKV column slices, the 512x768 strips' L0 / L1 shapes at B = 2,
# H = 8; w_tile a multiple of 8 with radius <= 7 takes the table, the
# rest (w_tile 5, 7, 12, 13, 25, 50; radius 10) the per-pair branch;
# attention_sm90_kernel's MFR mode, 32-key tiles at d 136-160: N off 128
# (130) and off 192 and 128 (200), d 136 and 152, both modes with the
# table and per pair, and the 4-tile seed strip's L2 (16 x 96 tokens) at
# B = 2, H = 8
MFR_CASES = [
    (1, 5, 7, 2, 2, 40, "target", 6, False),    # ragged N = 70
    (2, 5, 7, 2, 2, 40, "mutual", 6, False),
    (1, 6, 8, 3, 2, 80, "target", 6, False),    # 3 tiles
    (2, 6, 8, 3, 1, 80, "mutual", 6, False),
    (1, 16, 12, 2, 2, 40, "mutual", 2, False),  # key tiles outside the band
    (1, 4, 6, 4, 2, 160, "mutual", 6, False),   # SD-1.5's L2 head width, 4 tiles
    (2, 5, 7, 2, 1, 160, "target", 6, False),
    (1, 4, 50, 2, 2, 40, "mutual", 6, False),   # units straddle strip rows
    (2, 6, 40, 2, 2, 80, "target", 6, False),
    (1, 5, 40, 2, 2, 40, "mutual", 6, False),
    (1, 4, 96, 2, 2, 40, "target", 6, False),   # warpgroup 2 outside tile 0
    (1, 8, 16, 2, 2, 40, "mutual", 0, False),   # radius 0
    (1, 8, 12, 2, 2, 40, "target", 0, False),
    (1, 6, 8, 2, 2, 64, "target", 100, False),  # clamped to 7, the table's widest
    (1, 16, 12, 2, 2, 80, "mutual", 10, False),  # past the table: per pair
    (1, 4, 5, 2, 2, 16, "mutual", 6, False),    # N = 40
    (2, 16, 48, 2, 8, 40, "mutual", 6, True),   # fused-QKV slices
    (1, 8, 24, 3, 4, 128, "target", 6, True),
    (2, 64, 96, 2, 8, 40, "mutual", 6, True),   # strip L0, 512x768
    (2, 64, 96, 2, 8, 40, "target", 6, True),
    (2, 32, 48, 2, 8, 80, "mutual", 6, True),   # strip L1
    (1, 5, 13, 2, 3, 160, "mutual", 6, False),  # N = 130, per pair
    (2, 4, 25, 2, 2, 152, "target", 10, True),  # N = 200, per pair
    (1, 6, 16, 3, 2, 136, "mutual", 7, False),  # the table
    (1, 8, 24, 2, 2, 160, "target", 10, False),  # past the table
    (2, 16, 24, 4, 8, 160, "mutual", 6, True),  # strip L2, 4 tiles
    (2, 16, 24, 4, 8, 160, "target", 6, True)]


@pytest.mark.parametrize("b,hh,w_tile,n_tiles,heads,d,mode,radius,fused",
                         MFR_CASES)
def test_flash_attention_mfr_kernel(gen, b, hh, w_tile, n_tiles, heads, d,
                                    mode, radius, fused):
    """Against xla_attention with mfr_strip_bias, one head at a time (the
    L0 strip's f32 scores take 9.7 GB for all heads); two calls bitwise
    equal (each block writes only its own rows)."""
    n = hh * n_tiles * w_tile
    if fused:
        q, k, v = (t.reshape(b, n, heads, d) for t in
                   _randn(gen, b, n, 3 * heads * d).chunk(3, dim=-1))
    else:
        q, k, v = (_randn(gen, b, n, heads, d) for _ in range(3))
    kw = dict(h=hh, w_tile=w_tile, n_tiles=n_tiles, mode=mode, radius=radius)
    n0 = TA.flash_attention_mfr.launches
    out = TA.flash_attention_mfr(q, k, v, **kw)
    again = TA.flash_attention_mfr(q, k, v, **kw)
    bias = TA.mfr_strip_bias(hh, w_tile, n_tiles, radius=radius, mode=mode,
                             device="cuda")[None, None]
    ref = torch.cat([TA.xla_attention(q[:, :, i:i + 1], k[:, :, i:i + 1],
                                      v[:, :, i:i + 1], bias=bias)
                     for i in range(heads)], dim=2)
    _check(out, ref)
    assert torch.equal(out, again)
    assert TA.flash_attention_mfr.launches == n0 + 2


# attention_sm90_kernel's banded mode: 192-row units, 128-key tiles at
# d <= 48, 64 up to d = 112, 32 at 128-160; the table where w % 8 == 0 and
# the radius (clamped to max(h, w) - 1) is at most 8, else per pair
BANDED_CASES = [
    (1, 64, 96, 2, 1, 40, -1000.0, 8, False),    # SD-1.5's L0 frame at 512x768
    (1, 32, 48, 2, 2, 80, -1000.0, 8, False),    # L1
    (2, 16, 24, 2, 2, 160, -1000.0, 8, False),   # L2, the widest head
    (1, 3, 5, 3, 2, 40, -1000.0, 8, False),      # h*w = 15: tiles span frames
    (2, 9, 11, 2, 1, 24, -30.0, 8, False),       # h*w = 99: a tile straddles
    (1, 64, 96, 2, 1, 40, -float("inf"), 8, False),  # first tiles out of band
    (2, 9, 15, 2, 2, 136, -1000.0, 8, False),    # d 136, Nq = 135 < 192, per pair
    (1, 10, 24, 2, 3, 152, -float("inf"), 8, False),  # d 152, Nq = 240
    (2, 13, 16, 4, 2, 64, -1000.0, 8, False),    # 4 frames, Nq = 208
    (1, 12, 16, 2, 2, 40, -1000.0, 0, False),    # radius 0
    (1, 12, 16, 2, 2, 80, -1000.0, 3, False),    # radius 3
    (1, 20, 32, 2, 2, 40, -1000.0, 9, False),    # past the table: per pair
    (1, 24, 40, 2, 1, 128, -1000.0, 9, False),
    (1, 6, 8, 2, 2, 40, -float("inf"), 100, False),  # every pair in band (table)
    (1, 7, 9, 3, 2, 152, -1000.0, 9, False),     # every pair in band (per pair)
    (2, 32, 48, 2, 8, 80, -1000.0, 8, True),     # L1, q a fused-QKV slice
    (2, 16, 24, 2, 8, 160, -1000.0, 8, True)]    # L2, q a fused-QKV slice


@pytest.mark.parametrize("weight", [0.0, 0.7])
@pytest.mark.parametrize("b,hh,ww,n,heads,d,base,radius,fused", BANDED_CASES)
def test_flash_attention_banded_kernel(gen, weight, b, hh, ww, n, heads, d,
                                       base, radius, fused):
    """Against the plain version; two calls bitwise equal (each block
    writes only its own rows), each one launch at the padded head
    width."""
    nq = hh * ww
    if fused:   # q a slice of the QKV projection, k / v the joined frames
        q = _randn(gen, b, nq, 3 * heads * d)[..., :heads * d].reshape(
            b, nq, heads, d)
    else:
        q = _randn(gen, b, nq, heads, d)
    k, v = (_randn(gen, b, n * nq, heads, d) for _ in range(2))
    kw = dict(h=hh, w=ww, weight=weight, base=base, radius=radius)
    dp = -(-d // 16) * 16
    n0 = TA.flash_attention_banded.launches
    n0_dp = TA.flash_attention_banded.launches_by_dp.get(dp, 0)
    out = TA.flash_attention_banded(q, k, v, **kw)
    again = TA.flash_attention_banded(q, k, v, **kw)
    _check(out, TA.flash_attention_banded_plain(q, k, v, **kw))
    assert torch.equal(out, again)
    assert TA.flash_attention_banded.launches == n0 + 2
    assert TA.flash_attention_banded.launches_by_dp[dp] == n0_dp + 2


@pytest.mark.parametrize("d", [40, 80, 160])
def test_routers_launch_the_kernels_past_the_gate(gen, d):
    """At Nq >= 1536 the injection and strip routers launch their kernels
    at each SD-1.5 head width; the card never runs their plain versions
    there."""
    q, k, v = (_randn(gen, 2, 1536, 1, d) for _ in range(3))
    n0 = TA.flash_attention_keymask.launches
    _check(TA.attention_injected(q, k, v, n_own=768, n_uncond=1),
           TA.attention_injected_plain(q, k, v, n_own=768, n_uncond=1))
    assert TA.flash_attention_keymask.launches == n0 + 1
    n0 = TA.flash_attention_mfr.launches
    _check(TA.strip_attention(q, k, v, h=16, w_strip=96, n_tiles=4),
           TA.strip_attention_plain(q, k, v, h=16, w_strip=96, n_tiles=4))
    assert TA.flash_attention_mfr.launches == n0 + 1


def test_kernels_refuse_what_they_do_not_take(gen):
    x = _randn(gen, 64, 40)                 # din not a multiple of 16
    with pytest.raises(RuntimeError, match="CUDA error"):
        TF.linear_ln_fused(x, _randn(gen, 48, 40), torch.ones(40, device="cuda"),
                           torch.zeros(40, device="cuda"))
    xf = x.float()
    with pytest.raises(TypeError):
        TF.geglu_ff_fused(xf, xf.new_zeros(2 * 64, 40), xf.new_zeros(128),
                          xf.new_zeros(40, 64), xf.new_zeros(40))
    q = _randn(gen, 1, 64, 2, 40)
    with pytest.raises(TypeError):
        TA.flash_attention_tpv(q.float(), q.float(), q.float())
    q = _randn(gen, 1, 64, 2, 20)            # d not a multiple of 8
    with pytest.raises(ValueError):
        TA.flash_attention_tpv(q, q, q)
    q = _randn(gen, 1, 64, 1, 520)           # d > 512
    with pytest.raises(ValueError):
        TA.flash_attention(q, q, q)
    q = _randn(gen, 2, 64, 1, 168)           # d > 160
    with pytest.raises(ValueError):
        TA.flash_attention_keymask(q, q, q, n_own=32, n_uncond=1)
    with pytest.raises(ValueError):
        TA.flash_attention_mfr(q, q, q, h=4, w_tile=8, n_tiles=2)
    q = _randn(gen, 1, 64, 2, 40)            # 64 tokens != 4 * 2 * 10
    with pytest.raises(ValueError):
        TA.flash_attention_mfr(q, q, q, h=4, w_tile=10, n_tiles=2)
    with pytest.raises(TypeError):
        TA.flash_attention_banded(q.float(), q.float(), q.float(), h=8, w=8)
    with pytest.raises(ValueError):          # 64 tokens, not one 4x8 frame
        TA.flash_attention_banded(q, q, q, h=4, w=8)
    q = _randn(gen, 1, 32, 2, 168)           # d > 160
    with pytest.raises(ValueError):
        TA.flash_attention_banded(q, q, q, h=4, w=8)


# ---------------------------------------------------------------------------
# kernels #7-#9: the differentiable attention of training
# ---------------------------------------------------------------------------

# the backward's edges: the Hopper kernels' work units are 64 * NC own
# rows (128 or 192) and their streamed tiles 32 or 64 rows, so Nq and Nk
# fall below, on and one either side of both (191, 193, 385), B * H > 1,
# and d from 8 to 128 (40 and 80 padded to 48 and 80 in shared memory)
BWD_CASES = [(2, 300, 231, 3, 40), (1, 130, 257, 2, 80), (1, 77, 64, 2, 128),
             (1, 50, 90, 2, 24), (2, 64, 64, 1, 16), (2, 129, 129, 2, 40),
             (1, 257, 127, 1, 64), (1, 100, 63, 2, 80), (1, 70, 65, 1, 128),
             (1, 193, 127, 2, 40), (1, 191, 193, 2, 40), (2, 385, 191, 2, 80),
             (1, 193, 385, 3, 48), (2, 100, 150, 2, 8), (1, 129, 200, 2, 128),
             (2, 192, 128, 2, 80)]


# Nk = 1 for the forward only: there dK = dQ = 0 exactly, and the plain
# backward's rounding noise is no scale to hold a kernel to
@pytest.mark.parametrize("b,nq,nk,h,d", BWD_CASES + [(1, 200, 1, 2, 8)])
def test_flash_fwd_stats_kernel(gen, b, nq, nk, h, d):
    q = _randn(gen, b, nq, h, d)
    k = _randn(gen, b, nk, h, d)
    v = _randn(gen, b, nk, h, d)
    n0 = TA.flash_fwd_stats.launches
    out, lse = TA.flash_fwd_stats(q, k, v)
    ref_out, ref_lse = TA.flash_fwd_stats_plain(q, k, v)
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    _check(out, ref_out)
    _check(lse, ref_lse)
    assert TA.flash_fwd_stats.launches == n0 + 1


def _bwd_inputs(gen, b, nq, nk, h, d):
    q = _randn(gen, b, nq, h, d)
    k = _randn(gen, b, nk, h, d)
    v = _randn(gen, b, nk, h, d)
    do = _randn(gen, b, nq, h, d)
    out, lse = TA.flash_fwd_stats_plain(q, k, v)
    return q, k, v, do, lse, TA.flash_dvec(out, do)


@pytest.mark.parametrize("b,nq,nk,h,d", BWD_CASES)
def test_flash_bwd_kernels(gen, b, nq, nk, h, d):
    """#8 and #9 on the plain forward's residuals: ragged query and key
    tiles, d padded up to a multiple of 16, the widest head (128)."""
    q, k, v, do, lse, dvec = _bwd_inputs(gen, b, nq, nk, h, d)
    n8, n9 = TA.flash_bwd_dkv.launches, TA.flash_bwd_dq.launches
    dk, dv = TA.flash_bwd_dkv(q, k, v, do, lse, dvec)
    dq = TA.flash_bwd_dq(q, k, v, do, lse, dvec)
    rdk, rdv = TA._bwd_dkv_plain(q, k, v, do, lse, dvec)
    rdq = TA._bwd_dq_plain(q, k, v, do, lse, dvec)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.shape == ref.shape and got.is_contiguous()
        _check(got, ref)
    assert (TA.flash_bwd_dkv.launches, TA.flash_bwd_dq.launches) == \
        (n8 + 1, n9 + 1)


@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 193, 1, 2, 40),
                                         (2, 70, 1, 1, 128)])
def test_flash_bwd_kernels_one_key(gen, b, nq, nk, h, d):
    """One key: P = 1, so dS = dP - D = 0 and dQ = dK = 0 exactly (both
    sides give rounding noise there, held to dV's absolute tolerance);
    dV is the sum of dO over the queries."""
    q, k, v, do, lse, dvec = _bwd_inputs(gen, b, nq, nk, h, d)
    dk, dv = TA.flash_bwd_dkv(q, k, v, do, lse, dvec)
    dq = TA.flash_bwd_dq(q, k, v, do, lse, dvec)
    _, rdv = TA._bwd_dkv_plain(q, k, v, do, lse, dvec)
    _check(dv, rdv)
    limit = TOL * rdv.float().abs().max().item()
    for zero in (dq, dk):
        assert torch.isfinite(zero).all()
        assert zero.float().abs().max().item() <= limit


def test_flash_bwd_kernels_are_deterministic(gen):
    """No atomics: every block writes only its own rows, so two calls
    give bitwise-identical dQ, dK and dV (several work units a block)."""
    args = _bwd_inputs(gen, 2, 1536, 1536, 8, 80)
    first = (TA.flash_bwd_dq(*args), *TA.flash_bwd_dkv(*args))
    second = (TA.flash_bwd_dq(*args), *TA.flash_bwd_dkv(*args))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("offset", [0, 1])
def test_flash_bwd_kernels_strided_qkv(gen, offset):
    """The backward on q/k/v column slices of one fused projection (the
    training step's layout): offset 0 goes in without a copy, offset 1
    takes the wrapper's contiguous copy."""
    qkv = _randn(gen, 2, 200, offset + 3 * 320)[..., offset:]
    q, k, v = (t.reshape(2, 200, 8, 40) for t in qkv.chunk(3, dim=-1))
    do = _randn(gen, 2, 200, 8, 40)
    out, lse = TA.flash_fwd_stats_plain(q, k, v)
    dvec = TA.flash_dvec(out, do)
    dk, dv = TA.flash_bwd_dkv(q, k, v, do, lse, dvec)
    rdk, rdv = TA._bwd_dkv_plain(q, k, v, do, lse, dvec)
    _check(TA.flash_bwd_dq(q, k, v, do, lse, dvec),
           TA._bwd_dq_plain(q, k, v, do, lse, dvec))
    _check(dk, rdk)
    _check(dv, rdv)


def test_flash_attention_diff_grads_on_card(gen):
    """q/k/v as column slices of one fused projection that requires grad:
    the kernel wrapper without a backward refuses it, flash_attention_diff
    gives the plain backward's gradients."""
    qkv = _randn(gen, 2, 200, 3 * 80).requires_grad_()
    q, k, v = (t.reshape(2, 200, 2, 40) for t in qkv.chunk(3, dim=-1))
    with pytest.raises(RuntimeError, match="no backward"):
        TA.flash_attention_tpv(q, k, v)
    do = _randn(gen, 2, 200, 2, 40)
    out = TA.flash_attention_diff(q, k, v)
    (grad,) = torch.autograd.grad(out, qkv, do)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    ref_out, lse = TA.flash_fwd_stats_plain(qd, kd, vd)
    _check(out.detach(), ref_out)
    ref = torch.cat([g.reshape(2, 200, 80) for g in TA.flash_bwd_plain(
        qd, kd, vd, out.detach(), lse, do)], dim=-1)
    for got, want in zip(grad.chunk(3, dim=-1), ref.chunk(3, dim=-1)):
        _check(got, want)


def test_wrappers_without_backward_refuse_a_gradient(gen):
    """No kernel output reaches autograd without a grad_fn: each wrapper
    whose kernel has no backward raises where a gradient would be
    recorded, and launches under torch.no_grad()."""
    q = _randn(gen, 2, 1536, 1, 40).requires_grad_()
    stats = [torch.zeros(2, 1536, device="cuda")] * 2     # lse, dvec
    wide = _randn(gen, 1, 64, 1, 160).requires_grad_()
    x = _randn(gen, 64, 320).requires_grad_()
    w1 = _randn(gen, 2560, 320)
    w2 = _randn(gen, 320, 1280)
    b1, b2 = _randn(gen, 2560), _randn(gen, 320)
    calls = [lambda: TA.flash_attention_tpv(q, q, q),
             lambda: TA.flash_attention(wide, wide, wide),
             lambda: TA.flash_attention_keymask(q, q, q, n_own=768,
                                                n_uncond=1),
             lambda: TA.flash_attention_mfr(q, q, q, h=16, w_tile=48,
                                            n_tiles=2),
             lambda: TA.flash_attention_banded(q, q, q, h=32, w=48),
             lambda: TA.flash_fwd_stats(q, q, q),
             lambda: TA.flash_bwd_dq(q, q, q, q, *stats),
             lambda: TF.linear_ln_fused(x, _randn(gen, 960, 320),
                                        torch.ones(320, device="cuda"),
                                        torch.zeros(320, device="cuda")),
             lambda: TF.geglu_ff_fused(x, w1, b1, w2, b2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert torch.isfinite(call()[0]).all()
