#!/usr/bin/env python3
"""Where the time of the Hopper kernels goes, on one NVIDIA card: the
attention forwards #1 / #7, #5, #6 and #10 (``csrc/attention_sm90.cu``) and
#2 (``csrc/attention_wide_sm90.cu``), the backward pair #8 / #9
(``csrc/attention_bwd_sm90.cu``), the GEGLU tail #4 and the LN-prologue
projection #3 (``csrc/ffn_sm90.cu``):

    python3 sm90_probe.py [--shape self_l0|self_l1|cross_l0|cross_l1]
    python3 sm90_probe.py --shape strip_l0|strip_l1|strip_l2 [--mode mutual|target]
    python3 sm90_probe.py --shape inject_l0|inject_l1|inject_l2
    python3 sm90_probe.py --shape banded_l0|banded_l1|banded_l2 [--weight 0|0.7]
    python3 sm90_probe.py --kernel wide [--shape vae_mid|vae_mid2|l2]
    python3 sm90_probe.py --kernel bwd [--shape self_l0|self_l1]
    python3 sm90_probe.py --kernel geglu [--shape l0|l1]
    python3 sm90_probe.py --kernel linear_ln [--shape qkv_l0|q_l0|qkv_l1|q_l1|qkv_l0_2f]

Builds copies of the kernel's source with one part of the work left out
(``-DSM90_SKIP=<bits>`` / ``-DWIDE_SKIP=<bits>``, the kernel's
``SKIP_*`` parts), each into its own library under ``build/probe/``
(git-ignored), and times each against the unchanged kernel and SDPA on
the same inputs (CUDA events, interleaved rounds, the median of each).
Every copy but ``no_turns`` and the ``cluster_*`` ones computes wrong
results; they only time what remains. For ``attention_sm90.cu``:

* ``no_exp``: p = s * scale - m, no ex2 (the special-function units idle);
* ``no_loads``: the producer loads the first ring of K/V tiles of each
  unit only, so later tiles reuse them (no device-memory / L2 traffic
  past the ring);
* ``no_pv``: no p v products (q k^T and the softmax only);
* ``no_softmax``: neither the exponentials nor the max and sums (q k^T,
  packing and p v);
* ``no_stores``: no output stores to device memory (the bf16 staging in
  shared memory stays);
* ``no_turns``: the consumer warpgroups issue their products without
  taking turns (this one computes the right result);
* ``no_bias`` (the strip and banded shapes only): the MFR or banded mode
  without its bias (no band test, no table reads, no base), so its time
  against the full kernel's is what the bias costs.

The strip shapes run the kernel's MFR mode (#10: the 2-tile strips of a
512x768 frame, 64 x 192 latent tokens at L0, 32 x 96 at L1; the 4-tile
seed strip's L2, 16 x 96 tokens of d = 160) through a shim that exports
its C++ launcher as ``sdaof_attention_mfr``, against SDPA with the
materialized bf16 bias. The inject shapes run its keymask mode (#6: the
injected inpaint's CFG pair, q [2, 6144, 8, 40] against 12288 keys of
which the uncond row sees the first 6144 at L0, q [2, 1536, 8, 80]
against 3072 at L1, q [2, 1536, 8, 160] against 3072 at L2 of a
1024x1536 frame) through a shim that exports its launcher as
``sdaof_attention_keymask``, against SDPA with the boolean key mask.
The banded shapes run its banded mode (#5: one 512x768 frame's queries
against two frames' keys, q [2, 6144, 8, 40] against 12288 keys at L0,
q [2, 1536, 8, 80] against 3072 at L1, q [2, 384, 8, 160] against 768 at
L2; radius 8, base -1000, ``--weight`` in band) through a shim that
exports its launcher as ``sdaof_attention_banded``, against SDPA with
the materialized bf16 bias, in the copies ``full``, ``no_bias``,
``no_loads`` and ``no_exp``. The ptxas lines (registers, spills) of the
instantiation each shape runs are printed first.

For ``attention_wide_sm90.cu`` (the shapes: the VAE mid-block attention
of one frame and of two, and the UNet's 160-wide L2 heads at 1536
tokens):

* ``no_loads``: K/V loads of the first ring only, as above;
* ``no_qk`` / ``no_pv`` / ``no_products``: without the q k^T products,
  the p v products, or both;
* ``no_xch``: no exchange of the partial scores (no named barriers);
* ``no_softmax`` / ``no_exp``: as above;
* ``products_only``: no loads past the ring, no exchange, no softmax;
* ``cluster_1`` / ``cluster_2`` / ``cluster_4``: the kernel with clusters
  of that many CTAs sharing each K/V tile (it picks 4 at d > 256, else 2;
  these compute the right result).

For ``attention_bwd_sm90.cu`` (``-DBWD_SKIP``; the training step's
self-attention shapes; each copy times #8 (dK, dV) and #9 (dQ) against
SDPA's backward on the same inputs, the statistics from a plain f32
forward):

* ``no_exp``: P = S * scale - lse, no ex2;
* ``no_loads``: the streamed tiles of the first ring only, as above;
* ``no_scores``: no S / dP products;
* ``no_grads``: no dV / dK / dQ products;
* ``no_chain``: no elementwise chain (neither P nor dS: the score
  accumulators are packed as they are);
* ``no_turns``: the consumers issue without taking turns (right result);
* ``dkv_nc3_bs32``, ``dkv_nc3_bs32_r160``: #8 with three consumers
  (``-DBWD_NC8=3``: 192-key units of 32-query tiles) at 152 registers a
  consumer thread, or at 160 with ``-DBWD_REGS3=160``, which leaves the
  producer 32; these compute the right result. The ptxas lines of any
  copy that spills or serialises its wgmma are printed first.

For ``ffn_sm90.cu`` (``-DGEGLU_SKIP``; the UNet's transformer tails, x
[12288, 320], dff 1280 at L0 and x [6144, 640], dff 2560 at L1 of a
2-frame batch, with LN and the residual; each copy times the up kernel,
the down kernel on the full copy's a, and the pair as the port calls it,
against the library chain and its two halves, and the pair run over row
chunks of 4096 rows, whose a stays in the 50 MB L2 between the two
launches):

* ``no_prologue``: the up kernel neither loads x nor normalises it;
* ``no_epilogue``: neither kernel's epilogue (no GEGLU, bias, residual or
  stores);
* ``no_loads``: the ring stages of the first ring of k chunks only, as
  above.

The ptxas lines of both kernels (registers, spills) of every copy are
printed first.

For ``linear_ln_sm90_kernel`` in ``ffn_sm90.cu`` (the same
``-DGEGLU_SKIP`` bits; the UNet's LN1 -> QKV and LN2 -> Q projections, x
[12288, 320] at L0 of the CFG pair and x [6144, 640] at L1 of a 2-frame
batch, dout 3 din or din, and the QKV projection at L0 of a 2-frame
batch, x [24576, 320]; each copy against the library's ``layer_norm`` +
``matmul`` and the library's ``matmul`` alone):

* ``no_prologue``: no x load and no LN (the products read whatever the
  xn tile holds);
* ``no_epilogue``: no stores;
* ``no_loads``: the W stages of the first ring only, as above;
* ``splits_<s>``: the full copy with the column tiles split across s
  blocks a row block (s = 1 up to 6 tiles; these compute the right
  result), through a shim that launches the kernel at a given split
  count, so that the port's choice (``full``) can be read against each.

The ptxas lines of the kernel's instantiations of every copy are printed
first.

Nothing of the port uses these copies.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import math
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sd_animation_optical_flow_tpu_torch.ops import _cuda

ROOT = Path(__file__).resolve().parent
PROBE_DIR = ROOT / "build" / "probe"
CHUNK = 4096    # rows of a chunk of the chunked GEGLU pair (a: 10.5 MB at L0)
# per kernel: its source, the defines of each variant, and its shapes
# (B, Nq, Nk, H, D)
KERNELS = {
    # attention_sm90.cu's SM90_SKIP bits: SKIP_EXP = 1, SKIP_LOADS = 2,
    # SKIP_PV = 4, SKIP_SOFTMAX = 8, SKIP_STORES = 16, SKIP_TURNS = 32,
    # SKIP_BIAS = 64 (the MFR mode's epilogue)
    "sm90": ("attention_sm90.cu",
             {name: [f"SM90_SKIP={bits}"] for name, bits in {
                 "full": 0, "no_exp": 1, "no_loads": 2, "no_pv": 4, "no_softmax": 8,
                 "no_stores": 16, "no_turns": 32, "no_bias": 64}.items()},
             {"self_l0": (2, 6144, 6144, 8, 40), "self_l1": (2, 1536, 1536, 8, 80),
              "cross_l0": (2, 6144, 231, 8, 40), "cross_l1": (2, 1536, 231, 8, 80),
              "strip_l0": (2, 12288, 12288, 8, 40), "strip_l1": (2, 3072, 3072, 8, 80),
              "strip_l2": (2, 1536, 1536, 8, 160),
              "inject_l0": (2, 6144, 12288, 8, 40), "inject_l1": (2, 1536, 3072, 8, 80),
              "inject_l2": (2, 1536, 3072, 8, 160),
              "banded_l0": (2, 6144, 12288, 8, 40), "banded_l1": (2, 1536, 3072, 8, 80),
              "banded_l2": (2, 384, 768, 8, 160)}),
    # attention_wide_sm90.cu's WIDE_SKIP bits: SKIP_LOADS = 1, SKIP_QK = 2,
    # SKIP_PV = 4, SKIP_XCH = 8, SKIP_SOFTMAX = 16, SKIP_EXP = 32; and
    # WIDE_CLUSTER, the CTAs of a cluster
    "wide": ("attention_wide_sm90.cu",
             {name: [f"WIDE_SKIP={bits}"] for name, bits in {
                 "full": 0, "no_loads": 1, "no_qk": 2, "no_pv": 4, "no_products": 6,
                 "no_xch": 8, "no_softmax": 16, "no_exp": 32, "products_only": 25}.items()}
             | {f"cluster_{n}": [f"WIDE_CLUSTER={n}"] for n in (1, 2, 4)},
             {"vae_mid": (1, 6144, 6144, 1, 512), "vae_mid2": (2, 6144, 6144, 1, 512),
              "l2": (2, 1536, 1536, 8, 160)}),
    # attention_bwd_sm90.cu's BWD_SKIP bits: SKIP_EXP = 1, SKIP_LOADS = 2,
    # SKIP_SCORES = 4, SKIP_GRADS = 8, SKIP_CHAIN = 16, SKIP_TURNS = 32;
    # and BWD_NC8 = 3 (#8 with three consumers) at BWD_REGS3 registers
    "bwd": ("attention_bwd_sm90.cu",
            {name: [f"BWD_SKIP={bits}"] for name, bits in {
                "full": 0, "no_exp": 1, "no_loads": 2, "no_scores": 4, "no_grads": 8,
                "no_chain": 16, "no_turns": 32}.items()}
            | {"dkv_nc3_bs32": ["BWD_NC8=3"],
               "dkv_nc3_bs32_r160": ["BWD_NC8=3", "BWD_REGS3=160"]},
            {"self_l0": (2, 6144, 6144, 8, 40), "self_l1": (2, 1536, 1536, 8, 80)}),
    # ffn_sm90.cu's GEGLU_SKIP bits: SKIP_PROLOGUE = 1, SKIP_EPILOGUE = 2,
    # SKIP_LOADS = 4; the shapes (M, din, dff)
    "geglu": ("ffn_sm90.cu",
              {name: [f"GEGLU_SKIP={bits}"] for name, bits in {
                  "full": 0, "no_prologue": 1, "no_epilogue": 2, "no_loads": 4}.items()},
              {"l0": (12288, 320, 1280), "l1": (6144, 640, 2560)}),
    # the same bits for linear_ln_sm90_kernel; the shapes (M, din, dout)
    "linear_ln": ("ffn_sm90.cu",
                  {name: [f"GEGLU_SKIP={bits}"] for name, bits in {
                      "full": 0, "no_prologue": 1, "no_epilogue": 2, "no_loads": 4}.items()},
                  {"qkv_l0": (12288, 320, 960), "q_l0": (12288, 320, 320),
                   "qkv_l1": (6144, 640, 1920), "q_l1": (6144, 640, 640),
                   "qkv_l0_2f": (24576, 320, 960)}),
}
# the strip shapes' geometry (h, w_tile, n_tiles)
STRIPS = {"strip_l0": (64, 96, 2), "strip_l1": (32, 48, 2), "strip_l2": (16, 24, 4)}
# the inject shapes' key mask (n_own, n_uncond): the CFG pair's uncond row
# sees its own frame's keys, the first half
INJECT = {"inject_l0": (6144, 1), "inject_l1": (1536, 1), "inject_l2": (1536, 1)}
# the banded shapes' frame (h, w): one frame of queries, two of keys
BANDED = {"banded_l0": (64, 96), "banded_l1": (32, 48), "banded_l2": (16, 24)}
BANDED_COPIES = ("full", "no_bias", "no_loads", "no_exp")
# the MFR launcher of attention_sm90.cu has C++ linkage: a shim exports
# it under the name and arguments of sdaof_attention_mfr
SM90_SHIM = """
#include <cuda_runtime.h>
cudaError_t launch_attention_sm90_mfr(const void*, const void*, const void*, void*, int, int, int,
                                      int, long long, long long, long long, long long, long long,
                                      long long, long long, long long, long long, float, int, int,
                                      int, int, float, float, int, cudaStream_t);
extern "C" int sdaof_attention_mfr(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Nq, int Nk, int D, long long qsb, long long qsn,
                                   long long qsh, long long ksb, long long ksn, long long ksh,
                                   long long vsb, long long vsn, long long vsh,
                                   float scale_log2, int w_strip, int w_tile, int radius,
                                   int target_only, float bias_log2, float inv_sigma,
                                   int device, void* stream) {
  (void)Nk;
  return launch_attention_sm90_mfr(q, k, v, o, B, H, Nq, D, qsb, qsn, qsh, ksb, ksn, ksh, vsb,
                                   vsn, vsh, scale_log2, w_strip, w_tile, radius, target_only,
                                   bias_log2, inv_sigma, device,
                                   static_cast<cudaStream_t>(stream));
}
cudaError_t launch_attention_sm90_keymask(const void*, const void*, const void*, void*, int, int,
                                          int, int, int, long long, long long, long long,
                                          long long, long long, long long, long long, long long,
                                          long long, float, int, int, int, cudaStream_t);
extern "C" int sdaof_attention_keymask(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Nq, int Nk, int D, long long qsb,
                                       long long qsn, long long qsh, long long ksb,
                                       long long ksn, long long ksh, long long vsb,
                                       long long vsn, long long vsh, float scale_log2,
                                       int n_own, int n_uncond, int device, void* stream) {
  return launch_attention_sm90_keymask(q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                                       vsb, vsn, vsh, scale_log2, n_own, n_uncond, device,
                                       static_cast<cudaStream_t>(stream));
}
cudaError_t launch_attention_sm90_banded(const void*, const void*, const void*, void*, int, int,
                                         int, int, int, long long, long long, long long,
                                         long long, long long, long long, long long, long long,
                                         long long, float, int, int, int, float, float, float, int,
                                         cudaStream_t);
extern "C" int sdaof_attention_banded(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Nq, int Nk, int D, long long qsb,
                                      long long qsn, long long qsh, long long ksb, long long ksn,
                                      long long ksh, long long vsb, long long vsn, long long vsh,
                                      float scale_log2, int fh, int fw, int radius,
                                      float bias_log2, float base_log2, float inv_sigma,
                                      int device, void* stream) {
  return launch_attention_sm90_banded(q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                                      vsb, vsn, vsh, scale_log2, fh, fw, radius, bias_log2,
                                      base_log2, inv_sigma, device,
                                      static_cast<cudaStream_t>(stream));
}
"""
# the wide kernel's launcher has C++ linkage: a shim exports it under the
# name and arguments of sdaof_attention
WIDE_SHIM = """
#include <cuda_runtime.h>
cudaError_t launch_attention_wide_sm90(const void*, const void*, const void*, void*, int, int,
                                       int, int, int, long long, long long, long long,
                                       long long, long long, long long, long long, long long,
                                       long long, float, int, cudaStream_t);
extern "C" int sdaof_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Nq, int Nk, int D, long long qsb, long long qsn,
                               long long qsh, long long ksb, long long ksn, long long ksh,
                               long long vsb, long long vsn, long long vsh, float scale_log2,
                               int device, void* stream) {
  return launch_attention_wide_sm90(q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                                    vsb, vsn, vsh, scale_log2, device,
                                    static_cast<cudaStream_t>(stream));
}
"""

# the GEGLU kernels' launchers have C++ linkage: a shim exports them
GEGLU_SHIM = """
#include <cuda_runtime.h>
cudaError_t launch_geglu_up_sm90(const void*, const void*, const void*, const void*, const void*,
                                 void*, int, int, int, float, int, cudaStream_t);
cudaError_t launch_geglu_down_sm90(const void*, const void*, const void*, const void*, void*, int,
                                   int, int, int, int, cudaStream_t);
extern "C" int sdaof_geglu_up(const void* x, const void* lns, const void* lnb, const void* w1,
                              const void* b1, void* a, int M, int din, int dff, float eps,
                              int device, void* stream) {
  return launch_geglu_up_sm90(x, lns, lnb, w1, b1, a, M, din, dff, eps, device,
                              static_cast<cudaStream_t>(stream));
}
extern "C" int sdaof_geglu_down(const void* a, const void* w2, const void* b2, const void* x,
                                void* y, int M, int din, int dff, int residual, int device,
                                void* stream) {
  return launch_geglu_down_sm90(a, w2, b2, x, y, M, din, dff, residual, device,
                                static_cast<cudaStream_t>(stream));
}
"""

# linear_ln_sm90_kernel at a given split count: a shim that includes
# ffn_sm90.cu (its one translation unit) and exports a launcher taking the
# splits that sdaof_linear_ln chooses
LINEAR_LN_SHIM = """
#include "ffn_sm90.cu"
extern "C" int sdaof_linear_ln_splits(const void* x, const void* lns, const void* lnb,
                                      const void* w, void* y, int M, int din, int dout, float eps,
                                      int splits, int device, void* stream) {
  Card* c;
  cudaError_t err = card(device, c);
  if (err != cudaSuccess) return err;
  const LnArgs p{static_cast<const float*>(lns), static_cast<const float*>(lnb), M, din, dout,
                 splits, 0, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln_fit(din, LN_BNS[0]) >= 4) return launch_ln_bn<LN_BNS[0]>(x, w, y, p, c, 4, st);
  return launch_ln_bn<LN_BNS[1]>(x, w, y, p, c, 5, st);
}
"""


def in_band_share(h: int, w_tile: int, n_tiles: int, radius: int, target: bool,
                  bk: int) -> float:
    """The share of (warpgroup, key tile) pairs of one head that take the
    MFR bias pass, by the kernel's test (``StripBias::init``): key tiles
    holding keys of the strip rows within ``radius`` of the warpgroup's
    64 query rows; none for a warpgroup without a tile-0 row in
    ``target`` mode. 192-row units, ``bk`` keys a tile."""
    w_strip = n_tiles * w_tile
    n = h * w_strip
    nt = -(-n // bk)
    taken = total = 0
    for wg_row in range(0, -(-n // 192) * 192, 64):
        total += nt
        last = min(wg_row + 63, n - 1)
        ylo, yhi = wg_row // w_strip, last // w_strip
        if wg_row >= n or (target and yhi == ylo and wg_row - ylo * w_strip >= w_tile):
            continue
        tlo = max(ylo - radius, 0) * w_strip // bk
        thi = (min((yhi + radius + 1) * w_strip, n) - 1) // bk
        taken += thi - tlo + 1
    return taken / total


def banded_in_band_share(h: int, w: int, frames: int, radius: int, bk: int) -> float:
    """The share of (warpgroup, key tile) pairs of one head that work per
    pair in the banded mode, by the kernel's test (``BandBias::apply``):
    tiles straddling a frame's end or holding keys of the frame rows
    within ``radius`` of the warpgroup's 64 query rows. 192-row units."""
    hw = h * w
    taken = total = 0
    for wg_row in range(0, hw, 64):
        ylo, yhi = wg_row // w, min(wg_row + 63, hw - 1) // w
        klo, khi = max(ylo - radius, 0) * w, min(yhi + radius + 1, h) * w
        for t in range(-(-frames * hw // bk)):
            k0 = t * bk % hw
            total += 1
            taken += not (k0 + bk <= hw and (k0 + bk <= klo or k0 >= khi))
    return taken / total


def build(kernel: str, name: str) -> Path:
    """One copy's library, named by a hash of its sources and defines (a
    copy already built from the same ones is reused)."""
    source, variants, _ = KERNELS[kernel]
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(_cuda.CSRC / source)]
    shims = {"wide": WIDE_SHIM, "sm90": SM90_SHIM, "geglu": GEGLU_SHIM,
             "linear_ln": LINEAR_LN_SHIM}
    if kernel in shims:
        shim = PROBE_DIR / f"{kernel}_shim.cu"
        shim.write_text(shims[kernel])
        sources.append(str(shim))
    h = hashlib.sha256(" ".join([*_cuda.NVCC_FLAGS, *variants[name]]).encode())
    for src in [*sources, *map(str, sorted(_cuda.CSRC.glob("*.cuh")))]:
        h.update(Path(src).read_bytes())
    if kernel == "linear_ln":   # the shim includes the source
        sources = sources[1:]
    so = PROBE_DIR / f"{kernel}_{name}_{h.hexdigest()[:12]}.so"
    if so.exists() and so.with_suffix(".log").exists():
        return so
    out = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                          str(_cuda.CSRC), *(f"-D{d}" for d in variants[name]), "-shared",
                          *sources, "-o", str(so)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc {name}:\n{out.stdout}{out.stderr}")
    so.with_suffix(".log").write_text(out.stdout + out.stderr)
    return so


def _mean_ms(run, iters):
    """Mean ms of ``iters`` calls after two warm-up calls (CUDA events)."""
    for _ in range(2):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_bwd(libs, shape, args, card, label) -> int:
    """#8 and #9 of each copy of attention_bwd_sm90.cu, and SDPA's
    backward, on fused-QKV slices, interleaved in rounds (as ``main``)."""
    for name, so in libs.items():   # spills and serialised wgmma, if any
        for line in so.with_suffix(".log").read_text().splitlines():
            if ("spill" in line and " 0 bytes spill stores" not in line) \
                    or "wgmma" in line.lower():
                print(f"[ptxas] {name}: {line.strip()}")
    b, nq, nk, h, d = shape
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (t.reshape(b, nq, h, d) for t in torch.randn(
        (b, nq, 3 * h * d), generator=gen, device="cuda").to(torch.bfloat16).chunk(3, -1))
    do = torch.randn((b, nq, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    # the forward's statistics in f32, one head at a time: lse in base 2
    # of the scaled scores, D = rowsum(dO * O)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    lse = torch.empty((b, h, nq), device="cuda")
    dvec = torch.empty((b, h, nq), device="cuda")
    for i in range(h):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, i].float(), k[:, :, i].float()) * scale_log2
        lse[:, i] = torch.logsumexp(s * math.log(2), -1) / math.log(2)
        o = torch.softmax(s * math.log(2), -1) @ v[:, :, i].float()
        dvec[:, i] = (o.to(torch.bfloat16).float() * do[:, :, i].float()).sum(-1)
        del s, o
    lse, dvec = lse.reshape(b * h, nq), dvec.reshape(b * h, nq)
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=torch.bfloat16, device="cuda")
                  for n in (nq, nk, nk))
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dvec.data_ptr())
    runs = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        for entry, outs in (("sdaof_attention_bwd_dkv", (dk, dv)),
                            ("sdaof_attention_bwd_dq", (dq,))):
            fn = getattr(lib, entry)
            fn.argtypes = _cuda._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            ptrs = [t.data_ptr() for t in outs]
            runs[(name, entry[-3:].lstrip("_"))] = (lambda fn=fn, ptrs=ptrs: fn(
                *head, *ptrs, b, h, nq, nk, d, *strides, scale_log2, dev, stream))
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    runs[("sdpa", "bwd")] = lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                                       retain_graph=True)
    outs = {}
    for key, run in runs.items():
        if key[0] != "sdpa":
            err = run()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{key}: CUDA error {err}")
            outs[key] = [t.float().clone() for t in ((dk, dv) if key[1] == "dkv" else (dq,))]
    times = {key: [] for key in runs}
    for _ in range(args.rounds):
        for key, run in runs.items():
            times[key].append(_mean_ms(run, args.iters))
    print(f"[probe] {card}; bwd {label} q [{b},{nq},{h},{d}] kv {nk}; median of "
          f"{args.rounds} rounds of {args.iters} calls")
    ms = {key: statistics.median(ts) for key, ts in times.items()}
    for key in runs:
        full = ms[("full", key[1])] if key[0] != "sdpa" else ms[key]
        diff = "" if key not in outs else ", max |out - full's| " + " ".join(
            f"{(o - f).abs().max().item():.3e}" for o, f in zip(outs[key], outs[("full", key[1])]))
        print(f"[probe] {key[0]:13s} {key[1]:3s} {ms[key]:.4f} ms ({ms[key] / full:.2f} of "
              f"full){diff}")
    for name in libs:
        pair = ms[(name, "dkv")] + ms[(name, "dq")]
        print(f"[probe] {name:13s} pair {pair:.4f} ms ({pair / ms[('sdpa', 'bwd')]:.2f} of "
              f"SDPA's backward)")
    return 0


def probe_geglu(libs, shape, args, card, label) -> int:
    """The up and down kernels of each copy of ffn_sm90.cu apart and as a
    pair, against the library chain, interleaved in rounds (as ``main``);
    and the pair over row chunks of ``CHUNK`` rows."""
    for name, so in libs.items():   # both kernels' registers and spills
        kern = ""
        for line in so.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                bn = re.search(r"ILi(\d+)E", line)
                kern = f"down<{bn.group(1)}>" if bn else "up"
            elif kern and ("registers" in line or "spill" in line or "wgmma" in line.lower()):
                print(f"[ptxas] {name:11s} {kern:9s} {line.strip()}")
    m, din, dff = shape
    F = torch.nn.functional
    gen = torch.Generator("cuda").manual_seed(0)
    bf = lambda *sh, scale=1.0: (torch.randn(sh, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)
    x = bf(m, din)
    w1, b1 = bf(2 * dff, din, scale=din ** -0.5), bf(2 * dff, scale=din ** -0.5)
    w2, b2 = bf(din, dff, scale=dff ** -0.5), bf(din, scale=dff ** -0.5)
    lns = 1.0 + 0.1 * torch.randn(din, generator=gen, device="cuda")
    lnb = 0.1 * torch.randn(din, generator=gen, device="cuda")
    a = torch.empty((m, dff), dtype=torch.bfloat16, device="cuda")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    ptr = lambda t, row=0: t.data_ptr() + row * t.stride(0) * t.element_size()
    entries = {"sdaof_geglu": _cuda._SIGNATURES["sdaof_geglu"],
               "sdaof_geglu_up": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
               "sdaof_geglu_down": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}
    runs = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fn = {}
        for entry, argtypes in entries.items():
            fn[entry] = getattr(lib, entry)
            fn[entry].argtypes = argtypes
            fn[entry].restype = ctypes.c_int

        def up(fn=fn, r0=0, rows=m):
            return fn["sdaof_geglu_up"](ptr(x, r0), lns.data_ptr(), lnb.data_ptr(), w1.data_ptr(),
                                        b1.data_ptr(), ptr(a, r0), rows, din, dff, 1e-5, dev,
                                        stream)

        def down(fn=fn, r0=0, rows=m):
            return fn["sdaof_geglu_down"](ptr(a, r0), w2.data_ptr(), b2.data_ptr(), ptr(x, r0),
                                          ptr(y, r0), rows, din, dff, 1, dev, stream)

        def chunked(up=up, down=down):
            for r0 in range(0, m, CHUNK):
                rows = min(CHUNK, m - r0)
                err = up(r0=r0, rows=rows) or down(r0=r0, rows=rows)
                if err:
                    return err
            return 0

        runs[(name, "up")] = up
        runs[(name, "down")] = down
        runs[(name, "pair")] = lambda fn=fn: fn["sdaof_geglu"](
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), a.data_ptr(), y.data_ptr(), m, din, dff, 1e-5, 1, dev,
            stream)
        runs[(name, "chunked")] = chunked

    def lib_up():
        hh, g = F.linear(F.layer_norm(x, (din,), lns.to(x.dtype), lnb.to(x.dtype)), w1,
                         b1).chunk(2, -1)
        return hh * F.gelu(g)

    a_lib = lib_up()
    runs[("library", "up")] = lib_up
    runs[("library", "down")] = lambda: x + F.linear(a_lib, w2, b2)
    runs[("library", "pair")] = lambda: x + F.linear(lib_up(), w2, b2)
    outs = {}
    for name in libs:
        for part in ("pair", "chunked"):
            y.zero_()
            err = runs[(name, part)]()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name} {part}: CUDA error {err}")
            outs[(name, part)] = y.float().clone()
    ref = runs[("library", "pair")]().float()
    times = {key: [] for key in runs}
    for _ in range(args.rounds):
        for key, run in runs.items():
            times[key].append(_mean_ms(run, args.iters))
    flops = 6.0 * m * din * dff
    print(f"[probe] {card}; geglu {label} x [{m},{din}] dff {dff}, LN + residual; median of "
          f"{args.rounds} rounds of {args.iters} calls; bf16 bound "
          f"{1e3 * flops / 989e12:.4f} ms (up {1e3 * 4 * m * din * dff / 989e12:.4f}, down "
          f"{1e3 * 2 * m * din * dff / 989e12:.4f})")
    ms = {key: statistics.median(ts) for key, ts in times.items()}
    for key in runs:
        full = ms[("full", key[1])]
        diff = ""
        if key in outs:
            diff = f", max |out - library's| {(outs[key] - ref).abs().max().item():.3e}"
        print(f"[probe] {key[0]:11s} {key[1]:7s} {ms[key]:.4f} ms ({ms[key] / full:.2f} of "
              f"full's, {ms[key] / ms[('library', key[1] if key[1] != 'chunked' else 'pair')]:.2f}"
              f" of the library's){diff}")
    return 0


def print_ptxas(libs, match: str) -> None:
    """Registers and spills of each copy's kernel instantiations whose
    mangled name holds ``match``, and any serialised wgmma."""
    for name, so in libs.items():
        fn = ""
        for line in so.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            elif match in fn and ("registers" in line or "spill" in line):
                inst = re.search(r"kernelI(L\w+?)EE", fn)
                print(f"[ptxas] {name:11s} {inst.group(1) if inst else fn[-40:]:14s} "
                      f"{line.strip()}")
            elif "wgmma" in line.lower() and "serializ" in line.lower():
                print(f"[ptxas] {name:11s} {line.strip()}")


def probe_linear_ln(libs, shape, args, card, label) -> int:
    """Each copy of linear_ln_sm90_kernel against the library's layer_norm
    + matmul and its matmul alone, interleaved in rounds (as ``main``)."""
    print_ptxas(libs, "linear_ln_sm90_kernel")
    m, din, dout = shape
    F = torch.nn.functional
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((dout, din), generator=gen, device="cuda") * din ** -0.5).to(torch.bfloat16)
    lns = 1.0 + 0.1 * torch.randn(din, generator=gen, device="cuda")
    lnb = 0.1 * torch.randn(din, generator=gen, device="cuda")
    y = torch.empty((m, dout), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    dev = torch.cuda.current_device()
    runs = {}
    for name, so in libs.items():
        fn = getattr(ctypes.CDLL(str(so)), "sdaof_linear_ln")
        fn.argtypes = _cuda._SIGNATURES["sdaof_linear_ln"]
        fn.restype = ctypes.c_int
        runs[name] = lambda fn=fn: fn(x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
                                      y.data_ptr(), m, din, dout, 1e-5, dev, stream)
    at = getattr(ctypes.CDLL(str(libs["full"])), "sdaof_linear_ln_splits")
    at.argtypes = [*_cuda._SIGNATURES["sdaof_linear_ln"][:9], ctypes.c_int,
                   *_cuda._SIGNATURES["sdaof_linear_ln"][9:]]
    at.restype = ctypes.c_int
    bn = 160 if din <= 384 else 64   # the kernel's column tile (LN_BNS)
    nt, sms = -(-dout // bn), torch.cuda.get_device_properties(dev).multi_processor_count
    for s in range(1, min(nt, 6) + 1):
        runs[f"splits_{s}"] = lambda s=s: at(x.data_ptr(), lns.data_ptr(), lnb.data_ptr(),
                                             w.data_ptr(), y.data_ptr(), m, din, dout, 1e-5, s,
                                             dev, stream)
    xn = F.layer_norm(x, (din,), lns.to(x.dtype), lnb.to(x.dtype))
    runs["library"] = lambda: F.layer_norm(x, (din,), lns.to(x.dtype), lnb.to(x.dtype)) @ w.t()
    runs["lib_matmul"] = lambda: xn @ w.t()
    ref = runs["library"]().float()
    outs = {}
    for name in [*libs, *(k for k in runs if k.startswith("splits_"))]:
        y.zero_()
        err = runs[name]()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        outs[name] = y.float().clone()
    times = {key: [] for key in runs}
    for _ in range(args.rounds):
        for key, run in runs.items():
            times[key].append(_mean_ms(run, args.iters))
    flops, nbytes = 2.0 * m * din * dout, 2.0 * (m * din + dout * din + m * dout)
    print(f"[probe] {card}; linear_ln {label} x [{m},{din}] w [{dout},{din}]; median of "
          f"{args.rounds} rounds of {args.iters} calls; bound "
          f"{1e3 * max(flops / 989e12, nbytes / 3.35e12):.4f} ms; W read from L2 "
          f"{-(-m // 128) * dout * din * 2 / 1e6:.1f} MB (once a 128-row block)")
    ms = {key: statistics.median(ts) for key, ts in times.items()}
    rbs = -(-m // 128)
    for key in runs:
        diff = "" if key not in outs else \
            f", max |out - library's| {(outs[key] - ref).abs().max().item():.3e}"
        grid = "" if not key.startswith("splits_") else \
            (lambda s: f" [{rbs * s} blocks, {-(-rbs * s // sms)} waves, "
                       f"{-(-nt // s)} tiles of {bn} a block]")(int(key[7:]))
        print(f"[probe] {key:11s} {ms[key]:.4f} ms ({ms[key] / ms['full']:.2f} of full's, "
              f"{ms[key] / ms['library']:.2f} of the library's){diff}{grid}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=list(KERNELS), default="sm90")
    ap.add_argument("--shape", default=None,
                    help="one of the kernel's shapes (default: its first)")
    ap.add_argument("--nq", type=int, default=None,
                    help="query tokens in place of the shape's")
    ap.add_argument("--mode", choices=["mutual", "target"], default="mutual",
                    help="the strip shapes' tile rule")
    ap.add_argument("--weight", type=float, default=0.0,
                    help="the banded shapes' in-band weight")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sm90_probe: no CUDA device")
        return 2
    _, variants, shapes = KERNELS[args.kernel]
    shape = args.shape or next(iter(shapes))
    if shape not in shapes:
        ap.error(f"--shape: one of {sorted(shapes)} for --kernel {args.kernel}")
    strip, banded = STRIPS.get(shape), BANDED.get(shape)
    if banded:
        variants = {n: v for n, v in variants.items() if n in BANDED_COPIES}
    elif not strip:   # the bias exists on the strips and banded shapes only
        variants = {n: v for n, v in variants.items() if n != "no_bias"}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda v: build(args.kernel, v), variants)))
    if args.kernel == "bwd":
        return probe_bwd(libs, shapes[shape], args, card, shape)
    if args.kernel == "geglu":
        return probe_geglu(libs, shapes[shape], args, card, shape)
    if args.kernel == "linear_ln":
        return probe_linear_ln(libs, shapes[shape], args, card, shape)
    inject = INJECT.get(shape)
    if args.kernel == "sm90":   # the instantiation this shape runs
        dp = -(-shapes[shape][4] // 16) * 16
        mode = 1 if inject else 2 if strip else 4 if banded else 0
        print_ptxas(libs, f"attention_sm90_kernelILi{dp}ELi{mode}E")
    entry = ("sdaof_attention_mfr" if strip else "sdaof_attention_keymask" if inject
             else "sdaof_attention_banded" if banded
             else "sdaof_attention_fwd_stats") if args.kernel == "sm90" else "sdaof_attention"
    fns = {}
    for name, so in libs.items():
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn

    b, nq, nk, h, d = shapes[shape]
    self_attn = nq == nk
    nq = args.nq or nq
    gen = torch.Generator("cuda").manual_seed(0)
    mk = lambda n, parts: torch.randn((b, n, parts * h * d), generator=gen,
                                      device="cuda").to(torch.bfloat16)
    if self_attn:       # fused-QKV slices, as the UNet's self-attention
        nk = nq
        q, k, v = (t.reshape(b, nq, h, d) for t in mk(nq, 3).chunk(3, -1))
    else:
        q = mk(nq, 1).reshape(b, nq, h, d)
        k, v = (t.reshape(b, nk, h, d) for t in mk(nk, 2).chunk(2, -1))
    out = torch.empty((b, nq, h, d), dtype=torch.bfloat16, device="cuda")
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    lse = [None] if args.kernel == "sm90" and not (strip or inject or banded) else []
    mfr, mask = [], None
    if inject:  # the key mask, as flash_attention_keymask passes it
        n_own, n_unc = inject
        mfr = [n_own, n_unc]
        mask = torch.ones((b, 1, 1, nk), dtype=torch.bool, device="cuda")
        mask[:n_unc, ..., n_own:] = False
        shape = f"{shape} (n_own {n_own}, n_uncond {n_unc})"
    if strip:   # the strip geometry and bias, as flash_attention_mfr passes them
        from sd_animation_optical_flow_tpu_torch.ops import attention as A
        hh, w_tile, n_tiles = strip
        if nq != hh * n_tiles * w_tile:
            ap.error("--nq: the strip shapes keep their token count")
        mfr = [n_tiles * w_tile, w_tile, A.MFR_RADIUS, int(args.mode == "target"),
               A.MFR_WEIGHT * math.log2(math.e), 1.0 / A.mfr_sigma(hh)]
        mask = A.mfr_strip_bias(hh, w_tile, n_tiles, mode=args.mode, device="cuda").to(
            torch.bfloat16)[None, None]
        bk = 128 if d <= 48 else 64 if d <= 128 else 32
        share = in_band_share(hh, w_tile, n_tiles, A.MFR_RADIUS, args.mode == "target", bk)
        shape = f"{shape} {args.mode} (bias pass on {share:.3f} of the warpgroups' key tiles)"
    if banded:  # the frame and bias, as flash_attention_banded passes them
        from sd_animation_optical_flow_tpu_torch.ops import attention as A
        hh, ww = banded
        if nq != hh * ww:
            ap.error("--nq: the banded shapes keep their token count")
        log2e = math.log2(math.e)
        mfr = [hh, ww, 8, args.weight * log2e, -1000.0 * log2e, 1.0 / 1.6]
        mask = A.banded_strip_bias(hh, ww, nk // nq, weight=args.weight, dtype=torch.bfloat16,
                                   device="cuda")[None, None]
        bk = 128 if d <= 48 else 64 if d <= 112 else 32
        share = banded_in_band_share(hh, ww, nk // nq, 8, bk)
        shape = (f"{shape} weight {args.weight:g} (per-pair pass on {share:.3f} of the "
                 "warpgroups' key tiles)")

    def call(fn):
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), *lse, b, h, nq, nk, d, *strides,
                          scale_log2, *mfr, torch.cuda.current_device(), stream)

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    runs = {name: call(fn) for name, fn in fns.items()}
    runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask)
    outs = {}
    for name, run in runs.items():
        if name != "sdpa":
            run()
            torch.cuda.synchronize()
            outs[name] = out.float().clone()
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, run in runs.items():
            for _ in range(2):
                run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                err = run()
                if name != "sdpa" and err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / args.iters)
    print(f"[probe] {card}; {args.kernel} {shape} q [{b},{nq},{h},{d}] kv {nk}; "
          f"median of {args.rounds} rounds of {args.iters} calls")
    full = statistics.median(times["full"])
    for name, ts in times.items():
        ms = statistics.median(ts)
        diff = "" if name not in outs else \
            f", max |out - full's| {(outs[name] - outs['full']).abs().max().item():.3e}"
        print(f"[probe] {name:11s} {ms:.4f} ms ({ms / full:.2f} of full){diff}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
