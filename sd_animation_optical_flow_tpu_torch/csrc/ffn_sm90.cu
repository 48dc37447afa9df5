// The transformer block's two fused LayerNorm GEMMs for Hopper (sm_90a):
// the GEGLU tail (#4) as two wgmma GEMMs on one skeleton, and the
// LN-prologue projection (#3) on the same skeleton. Plain C interface for
// ctypes (ops/_cuda.py builds and loads this file).
//
// Replaces the Pallas TPU kernels of sd_animation_optical_flow_tpu/ops/
// ffn.py: _geglu_kernel / _geglu_kernel_ln (geglu_ff_fused) and
// _linear_ln_kernel (linear_ln_fused). For x [M, din] the GEGLU tail is
//
//   xn = bf16(LN(x))                  (f32 mean, then var = mean((x -
//                                      mean)^2), affine in f32; or xn = x)
//   h  = bf16(bf16(xn @ W1a^T) + b1a),  g = bf16(bf16(xn @ W1b^T) + b1b)
//   a  = bf16(h * gelu_erf(g))        (the GELU in f32)
//   y  = bf16(bf16(a @ W2^T) + b2)    [+ x]
//
// with the port's weights [out, in]: w1 [2 dff, din] (value rows, then gate
// rows), w2 [din, dff]. Every operand is K-major, the plain wgmma case. The
// TPU kernel rounds a to bf16 before W2 and keeps the second product's f32
// sum in VMEM scratch across the dff grid axis. Here a goes through device
// memory between two kernels instead, which gives each product the same
// operands; only the order of the f32 sums changes, as with any tiling:
//
//   geglu_up_sm90_kernel    xn -> a [M, dff] (the LN prologue, W1, the GEGLU)
//   geglu_down_sm90_kernel  a  -> y [M, din] (W2, the bias and residual)
//
// One in-register accumulator a product then holds 64 x 128 (up) or
// 64 x BN (down, BN <= 160) f32 a consumer warpgroup, where one fused kernel
// would carry 64 x din across the whole dff loop (320 registers a thread at
// din 640).
//
// Both kernels: a block of 128 rows (two consumer warpgroups of 64 rows)
// and a producer warpgroup whose one thread streams 64-wide k chunks of
// the streamed operands with TMA, without multicast, through a ring of as
// many shared-memory stages as fit (up to 8): a box of 8 columns x the
// tile's rows lands as a column of core matrices of the no-swizzle layout
// of sm90.cuh (tile_offset), so a stage is 8 boxes an operand, completing
// on the stage's "full" mbarrier; the consumers release a stage on its
// "empty" barrier once the wgmma that read it has completed. Each
// consumer stages its output tile in shared memory (row-major) and one
// thread stores it with a TMA copy, whole rows at a time.
//
// * Up: a block owns 128 rows of x and a range of the dff / 64 column
//   tiles; the tiles are split across blocks so the grid fills the card's
//   SMs (at the UNet's L0, x [12288, 320], 96 row blocks would leave 36 of
//   132 SMs idle). Each consumer warpgroup loads its 64 rows of x into a
//   resident xn tile and normalises them in place (each split recomputes
//   the LN of its rows: deterministic, and din x 128 against the tiles'
//   din x 128 x 128 products). A ring stage stacks 64 value rows of W1 and
//   the 64 matching gate rows (128 x 64 k), so one m64n128k16 chain gives
//   h and g together: value column 8j + 2t and gate column 8(j + 8) + 2t
//   sit in the same thread, and the GEGLU runs wholly in registers.
//   Shared memory: the 128 x din xn tile, two 8 KB output tiles and 16 KB
//   stages: at din 640, 160 + 16 + 3 x 16 = 224 KB of the 227 KB a block
//   may hold, so the row block stays 128 at every din, with 3 stages at
//   din 640 and 8 at din 320 (4 stages run as fast as 8).
// * Down: a block owns 128 rows and BN output columns (160, 128 or 64:
//   the widest that divides din); a stage holds the 128 x 64 tile of a
//   and the BN x 64 tile of W2 (the dff axis is K). The producer loads
//   the block's tile of x into the output tiles first; the epilogue adds
//   b2 and that raw x in place. Rows of a and x past M come zero-filled
//   from the TMA boxes.
//
// What bounds it on the H100: 3 x 2 x M x din x dff operations (30.2 GFLOP
// at L0, 0.031 ms at the bf16 peak) against x, the weights and y (18 MB).
// The split adds a written and read back (2 x 31.5 MB at L0, under 0.02 ms
// of HBM time where none of it stays in the 50 MB L2). In this design the
// loads set the pace: the no-swizzle layout makes every box row 16 bytes,
// and the rings fill at ~1.5 TB/s from L2 (sm90_probe.py --kernel geglu:
// without the loads past its first ring the down kernel takes 0.46 of its
// time at L0). Whole 128-byte rows need the swizzled layouts.
//
// The LN-prologue projection, linear_ln_sm90_kernel<BN>: y [M, dout] =
// bf16(xn @ W^T), xn = bf16(LN(x)) as above, W [dout, din], no bias; the
// UNet's LN1 -> QKV (dout 3 din) and LN2 -> Q (dout din) projections.
//
// * The up kernel's skeleton without the GEGLU: 128-row blocks, two
//   consumer warpgroups of 64 rows, one producer thread. It first loads
//   the block's x by TMA into the resident xn tile (rows past M and
//   columns past din zero-filled), then streams W's BN x 64 k chunks
//   through the ring; each consumer normalises its 64 rows in place while
//   the first stages land, then runs one m64nBNk16 chain a column tile.
// * 128-byte-swizzled operands: the x and W boxes are whole 128-byte
//   rows (64 bf16 of k) under TMA's SWIZZLE_128B, which is the layout of
//   wgmma's layout type 1 (gmma_desc_sw128), and the LN reads and writes
//   xn at the same swizzled offsets (a conflict-free 16-byte chunk a
//   thread, 8 threads on the 8 rows of an atom). A box then moves 128
//   bytes a row where #4's no-swizzle 8-column boxes move 16.
// * BN = 160 (it divides the UNet's 320, 640, 960 and 1920) where 4 ring
//   stages fit beside the 128 x din xn tile and the two output tiles (din
//   up to 384), else 64 (at din 640: the 160 KB xn tile, two 8 KB output
//   tiles and 6 stages of 8 KB). Column tiles past dout read zero-filled
//   W rows, and the stores clip them.
// * Grid: the column tiles are split across blocks by the up kernel's
//   rule (choose_splits), each split recomputing the LN of its rows
//   (deterministic), with a block's LN and fixed costs weighed as the
//   products of LN_COLS = 600 output columns. sm90_probe.py --kernel
//   linear_ln times each split count on the H100: at x [12288, 320] and
//   [24576, 320] a block costs ~3-4 tiles of 160 columns (480-690) beyond
//   its tiles, and any weight from 480 columns up picks the fastest
//   measured split at every UNet shape: one block a row block at L0 (QKV
//   of the CFG pair: 6 tiles of 160 on 96 SMs; of a 2-frame batch: 2
//   waves of 6, 0.94x the time of 3 waves of 3), two at L1 (48 row
//   blocks, 64-column tiles: 96 blocks; a one-tile weight would take
//   five splits, 1.10x the time).
// * Epilogue: each consumer rounds its tile to bf16 into a shared-memory
//   tile of 32-column panels (64-byte rows under TMA's SWIZZLE_64B, so the
//   stores of a warp's 8 rows hit distinct banks) and one thread stores
//   the panels with TMA, which clips rows past M and columns past dout.
// * What bounds it: 2 M din dout operations (7.5 GFLOP for QKV at L0,
//   0.0076 ms at the bf16 peak) against x, W and y (32 MB, 0.0096 ms), so
//   the bytes; each row block reads all of W from L2 (59 MB at L0).
//   sm90_probe.py --kernel linear_ln on the H100 reads QKV L0 at ~2.5x
//   that bound, and the parts in series rather than the loads: without
//   the loads past the first ring it takes 0.99 of its time, without the
//   prologue 0.72 (0.57 at L1, where the LN of 640-wide rows is done in
//   each of two splits), without the epilogue's stores 0.57. On #4's
//   no-swizzle tiles and 8-column boxes it took 1.5-2.0x the time.
//
// No atomics: two calls give bitwise-equal outputs.

#include <math.h>

#include "sm90.cuh"

namespace {

// sm90_probe.py --kernel geglu times copies of these kernels built with
// parts of the work left out, the bits of GEGLU_SKIP (0, nothing left out,
// in the port): the up kernel's x load and LN, both kernels' epilogues
// (no stores), the loads past the first ring of stages
#ifndef GEGLU_SKIP
#define GEGLU_SKIP 0
#endif
constexpr int SKIP_PROLOGUE = 1, SKIP_EPILOGUE = 2, SKIP_LOADS = 4;
__host__ __device__ constexpr bool skip(int part) { return (GEGLU_SKIP & part) != 0; }

constexpr int WG_THREADS = 128;                // a warpgroup
constexpr int NC = 2;                          // consumer warpgroups
constexpr int BM = 64 * NC;                    // rows of a block
constexpr int THREADS = (NC + 1) * WG_THREADS; // the producer last
constexpr int KC = 64;                         // k of a ring stage: 8 16-byte chunks
constexpr int FT = 64;                         // dff columns of an up tile
constexpr int MAX_STAGES = 8;                  // ring depth: as many stages as fit
constexpr int MAX_DIN = 640;
constexpr uint32_t SMEM_MAX = 232448;          // a block's shared memory
// mbarriers first: the ring's "full" at FULL, "empty" at EMPTY (8 each),
// the down kernel's x tile at XFULL
constexpr uint32_t FULL = 0, EMPTY = 64, XFULL = 128, BARS = 256;

// the up kernel's shared memory: the barriers, the xn tile, each consumer
// warpgroup's 64 x FT output tile (row-major, the TMA store's box), the ring
constexpr uint32_t UP_OUT = 64 * FT * 2, UP_STAGE = 2 * FT * KC * 2;
__host__ __device__ constexpr uint32_t up_ring(int din) {
  return BARS + BM * din * 2 + NC * UP_OUT;
}
// the down kernel's: the barriers, each consumer's 64 x BN tile of x, then
// y (row-major, the TMA boxes), the ring (a tile, then w2 tile a stage)
constexpr uint32_t DOWN_A = BM * KC * 2;
__host__ __device__ constexpr uint32_t down_out(int bn) { return 64 * bn * 2; }
__host__ __device__ constexpr uint32_t down_ring(int bn) { return BARS + NC * down_out(bn); }
__host__ __device__ constexpr uint32_t down_stage(int bn) { return DOWN_A + bn * KC * 2; }
// stages that fit beside `ring` bytes of a block's shared memory
__host__ __device__ constexpr int fit(uint32_t ring, uint32_t stage) {
  return (SMEM_MAX - ring) / stage < MAX_STAGES ? (SMEM_MAX - ring) / stage : MAX_STAGES;
}

static_assert(fit(up_ring(MAX_DIN), UP_STAGE) >= 3 && fit(down_ring(160), down_stage(160)) >= 4,
              "shared memory of one block");

struct UpMaps {  // TMA maps of w1 (8-column boxes of 64 value rows and 64
                 // gate rows) and a (64 x FT boxes)
  CUtensorMap w1, a;
};

struct UpArgs {
  const bf16* x;
  const float* lns;  // null: no LayerNorm
  const float* lnb;
  const bf16* b1;
  int M, din, dff, splits, stages;
  float eps;
};

struct DownMaps {  // TMA maps of a (8-column boxes of 128 rows), w2 (of BN
                  // rows), x and y (BN x 64 boxes)
  CUtensorMap a, w2, x, y;
};

struct DownArgs {
  const bf16* b2;
  int M, din, dff, residual, stages;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint4 lds128(uint32_t at) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t at, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(at) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t at, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a slot of the ring and the phase of its barriers, stepped use by use
struct Slot {
  int s = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// the barriers: `stages` "full" (the producer's arrival with the stage's
// TMA bytes), as many "empty" (one release a consumer warp), and XFULL
__device__ __forceinline__ void init_ring(uint32_t sm, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm + FULL + 8 * s, 1);
      mbar_init(sm + EMPTY + 8 * s, 4 * NC);
    }
    mbar_init(sm + XFULL, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// the producer's turn at use `use` of slot sl: wait until the consumers
// have released the slot's previous use, then arm its "full" barrier with
// the bytes the copies will bring (none for the probe's skipped loads);
// returns whether to copy
__device__ __forceinline__ bool begin_stage(uint32_t sm, const Slot& sl, int use, int stages,
                                            uint32_t bytes) {
  if (use >= stages) mbar_wait(sm + EMPTY + 8 * sl.s, sl.phase ^ 1);
  const bool copy = !(skip(SKIP_LOADS) && use >= stages);
  mbar_arrive_expect_tx(sm + FULL + 8 * sl.s, copy ? bytes : 0);
  return copy;
}

// the GELU of the TPU kernel (erf form) in f32
__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// LayerNorm of 64 rows [row0, row0 + 64) of the xn tile in place: 4 lanes
// a row (lane % 8 the row of a group of 8, lane / 8 every fourth 16-byte
// chunk), f32 statistics, the affine in f32, rounded to bf16; offset(row,
// chunk) is the tile's layout
template <class Offset>
__device__ void ln_rows(uint32_t xn, int row0, int din, const float* lns, const float* lnb,
                        float eps, int tid, Offset offset) {
  const int warp = tid >> 5, lane = tid & 31, nch = din / 8;
  const int cp = lane >> 3;
  for (int grp = warp; grp < 8; grp += 4) {
    const int row = row0 + 8 * grp + (lane & 7);
    float f[8], sum = 0.f;
    for (int c = cp; c < nch; c += 4) {
      unpack8(lds128(xn + offset(row, c)), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += f[i];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    const float mean = sum / din;
    float sq = 0.f;
    for (int c = cp; c < nch; c += 4) {
      unpack8(lds128(xn + offset(row, c)), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dx = f[i] - mean;
        sq = fmaf(dx, dx, sq);
      }
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 8);
    sq += __shfl_xor_sync(0xffffffffu, sq, 16);
    const float rstd = rsqrtf(sq / din + eps);
    for (int c = cp; c < nch; c += 4) {
      const uint32_t at = xn + offset(row, c);
      unpack8(lds128(at), f);
      const float4 s0 = *reinterpret_cast<const float4*>(lns + 8 * c);
      const float4 s1 = *reinterpret_cast<const float4*>(lns + 8 * c + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(lnb + 8 * c);
      const float4 b1 = *reinterpret_cast<const float4*>(lnb + 8 * c + 4);
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (f[i] - mean) * rstd * s[i] + b[i];
      sts128(at, make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                            pack_bf16(o[6], o[7])));
    }
  }
}

// the GEGLU of one up tile of this warpgroup (64 rows from row0, dff
// columns from f0): value column 8j + 2tq (+1) in acc[4j ..], its gate in
// acc[4(j + 8) ..], rows g and g + 8 of the warp; a = bf16(h * gelu(g))
// staged in ob (row-major) and stored by one TMA copy, which clips rows
// past M. ob is reused once the previous tile's copy has read it.
__device__ __forceinline__ void geglu_store(const float (&acc)[FT], const UpMaps& maps,
                                            const UpArgs& p, uint32_t ob, int f0, int row0,
                                            int wg, int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  if (tid == 0) bulk_wait_read<0>();
  named_bar_sync(1 + wg, WG_THREADS);
#pragma unroll
  for (int j = 0; j < FT / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 ba = load_pair(p.b1 + f0 + col), bg = load_pair(p.b1 + p.dff + f0 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* hv = acc + 4 * j + 2 * half;
      const float* gv = acc + 4 * (j + FT / 8) + 2 * half;
      const float h0 = bf16_round(bf16_round(hv[0]) + ba.x);
      const float h1 = bf16_round(bf16_round(hv[1]) + ba.y);
      const float g0 = bf16_round(bf16_round(gv[0]) + bg.x);
      const float g1 = bf16_round(bf16_round(gv[1]) + bg.y);
      sts32(ob + ((16 * warp + g + 8 * half) * FT + col) * 2,
            pack_bf16(h0 * gelu_erf(g0), h1 * gelu_erf(g1)));
    }
  }
  fence_proxy_async();  // the staged tile before the TMA copy reads it
  named_bar_sync(1 + wg, WG_THREADS);
  if (tid == 0) {
    tma_store_2d(&maps.a, ob, f0, row0);
    bulk_commit();
  }
}

// a = bf16(h * gelu(g)) for rows [m0, m0 + 128) and dff columns [t FT,
// (t + 1) FT) of each of the block's tiles t in [t0, t1)
__global__ void __launch_bounds__(THREADS, 1)
    geglu_up_sm90_kernel(const __grid_constant__ UpMaps maps, const UpArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int rbs = (p.M + BM - 1) / BM, nt = p.dff / FT, nk = p.din / KC;
  const int m0 = (blockIdx.x % rbs) * BM, split = blockIdx.x / rbs;
  const int t0 = split * nt / p.splits, t1 = (split + 1) * nt / p.splits;
  const uint32_t xn = sm + BARS, ring = sm + up_ring(p.din);
  init_ring(sm, p.stages);

  if (wg == NC) {  // the producer, one thread: k chunk kc of tile t, a box of
                   // each 16-byte column of the value rows, then the gate rows
    if (tid == 0) {
      Slot sl;
      for (int t = t0, use = 0; t < t1; ++t)
        for (int kc = 0; kc < nk; ++kc, ++use, sl.next(p.stages))
          if (begin_stage(sm, sl, use, p.stages, UP_STAGE))
            for (int c = 0; c < KC / 8; ++c)
              tma_load_3d(ring + sl.s * UP_STAGE + c * 2 * FT * 16, &maps.w1, sm + FULL + 8 * sl.s,
                          kc * KC + 8 * c, t * FT, 0);
    }
    return;
  }

  // a consumer warpgroup: rows [m0 + 64 wg, m0 + 64 wg + 64), raw, then
  // normalised in place
  const int lane = tid & 31;
  if (!skip(SKIP_PROLOGUE)) {
    const bf16* xr = p.x + static_cast<long long>(m0 + 64 * wg) * p.din;
    const int valid = p.M - m0 - 64 * wg, nch = p.din / 8;
    // element e: row 8 (q / nch) + e % 8, chunk q % nch (q = e / 8): 8
    // neighbouring threads on the 8 rows of a core, a warp on 4
    // neighbouring chunks of each
    for (int e = tid; e < 64 * nch; e += WG_THREADS) {
      const int q = e >> 3, r = (q / nch) * 8 + (e & 7), c = q % nch;
      const bool ok = r < valid;
      cp_async16(xn + tile_offset(64 * wg + r, c, BM),
                 ok ? xr + static_cast<long long>(r) * p.din + c * 8 : p.x, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1 + wg, WG_THREADS);
    if (p.lns != nullptr) {
      ln_rows(xn, 64 * wg, p.din, p.lns, p.lnb, p.eps, tid,
              [](int r, int c) { return tile_offset(r, c, BM); });
      named_bar_sync(1 + wg, WG_THREADS);
    }
  }
  fence_proxy_async();  // xn's generic-proxy writes before wgmma reads them
  named_bar_sync(1 + wg, WG_THREADS);

  // each tile's k chunks through the ring, then its GEGLU. (Issuing the
  // next tile's first chunks into a second accumulator before the
  // epilogue makes ptxas serialise every wgmma: the epilogue reads
  // accumulator registers while a wgmma pipeline is open.)
  const uint32_t xa = xn + tile_offset(64 * wg, 0, BM);
  float acc[FT];  // m64n128: 64 value columns, then their 64 gate columns
  Slot sl, prev;
  for (int t = t0; t < t1; ++t) {
    for (int kc = 0; kc < nk; ++kc, prev = sl, sl.next(p.stages)) {
      mbar_wait(sm + FULL + 8 * sl.s, sl.phase);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        Wgmma<2 * FT>::ss(acc, gmma_desc(xa + (kc * KC / 16 + kk) * 2 * BM * 16, BM * 16, 128),
                          gmma_desc(ring + sl.s * UP_STAGE + kk * 2 * 2 * FT * 16, 2 * FT * 16,
                                    128),
                          kc > 0 || kk > 0);
      wgmma_commit();
      if (kc > 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        fence_operands(acc);
        if (lane == 0) mbar_arrive(sm + EMPTY + 8 * prev.s);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(sm + EMPTY + 8 * prev.s);
    if (!skip(SKIP_EPILOGUE))
      geglu_store(acc, maps, p, xn + BM * p.din * 2 + wg * UP_OUT, t * FT, m0 + 64 * wg, wg, tid);
  }
  if (tid == 0) bulk_wait<0>();  // the last store is done before the block exits
}

// y = bf16(bf16(a @ w2^T) + b2) [+ x] for rows [m0, m0 + 128) and columns
// [n0, n0 + BN)
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    geglu_down_sm90_kernel(const __grid_constant__ DownMaps maps, const DownArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int rbs = (p.M + BM - 1) / BM, nk = p.dff / KC;
  const int m0 = (blockIdx.x % rbs) * BM, n0 = (blockIdx.x / rbs) * BN;
  constexpr uint32_t STAGE = down_stage(BN);
  const uint32_t ring = sm + down_ring(BN), ob = sm + BARS + wg * down_out(BN);
  init_ring(sm, p.stages);

  if (wg == NC) {  // the producer, one thread: k chunk kc of a's rows, then of
                   // w2's, a box of each 16-byte column
    if (tid == 0) {
      if (p.residual) {  // each consumer's 64 x BN tile of x, for the epilogue
        mbar_arrive_expect_tx(sm + XFULL, NC * down_out(BN));
        for (int c = 0; c < NC; ++c)
          tma_load_2d(sm + BARS + c * down_out(BN), &maps.x, sm + XFULL, n0, m0 + 64 * c);
      }
      Slot sl;
      for (int kc = 0; kc < nk; ++kc, sl.next(p.stages))
        if (begin_stage(sm, sl, kc, p.stages, STAGE)) {
          const uint32_t st = ring + sl.s * STAGE;
          for (int c = 0; c < KC / 8; ++c) {
            tma_load_2d(st + c * BM * 16, &maps.a, sm + FULL + 8 * sl.s, kc * KC + 8 * c, m0);
            tma_load_2d(st + DOWN_A + c * BN * 16, &maps.w2, sm + FULL + 8 * sl.s,
                        kc * KC + 8 * c, n0);
          }
        }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  float acc[BN / 2];
  Slot sl, prev;
  for (int kc = 0; kc < nk; ++kc, prev = sl, sl.next(p.stages)) {
    const uint32_t st = ring + sl.s * STAGE;
    mbar_wait(sm + FULL + 8 * sl.s, sl.phase);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      Wgmma<BN>::ss(acc,
                    gmma_desc(st + tile_offset(64 * wg, 0, BM) + kk * 2 * BM * 16, BM * 16, 128),
                    gmma_desc(st + DOWN_A + kk * 2 * BN * 16, BN * 16, 128), kc > 0 || kk > 0);
    wgmma_commit();
    if (kc > 0) {  // the previous stage's products are done: release it
      wgmma_wait<1>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(sm + EMPTY + 8 * prev.s);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (lane == 0) mbar_arrive(sm + EMPTY + 8 * prev.s);
  if (skip(SKIP_EPILOGUE)) return;
  // y = bf16(bf16(acc) + b2) [+ x] over this warpgroup's tile of x in
  // place, then one TMA copy (which clips rows past M)
  if (p.residual) mbar_wait(sm + XFULL, 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    const float2 bias = load_pair(p.b2 + n0 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t at = ob + ((16 * warp + g + 8 * half) * BN + col) * 2;
      float o0 = bf16_round(bf16_round(acc[4 * j + 2 * half]) + bias.x);
      float o1 = bf16_round(bf16_round(acc[4 * j + 2 * half + 1]) + bias.y);
      if (p.residual) {
        const float2 xv = unpack2(lds32(at));
        o0 += xv.x;
        o1 += xv.y;
      }
      sts32(at, pack_bf16(o0, o1));
    }
  }
  fence_proxy_async();  // the staged tile before the TMA copy reads it
  named_bar_sync(1 + wg, WG_THREADS);
  if (tid == 0) {
    tma_store_2d(&maps.y, ob, n0, m0 + 64 * wg);
    bulk_commit();
    bulk_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// #3: y = bf16(LN(x) @ w^T), linear_ln_sm90_kernel<BN>
// ---------------------------------------------------------------------------

constexpr int LN_BNS[] = {160, 64};     // column tiles: the first where 4 stages fit
constexpr int LN_COLS = 600;            // a block's LN and fixed costs, in output columns
constexpr int OUT_PANEL = 32;           // columns of an output box (64-byte rows)
constexpr uint32_t LN_SLACK = 1024;     // the dynamic base, rounded up to 1024 bytes

struct LnMaps {  // TMA maps of x (BM-row boxes), w (BN-row boxes) and y
                 // (32 x 64 boxes, SWIZZLE_64B)
  CUtensorMap x, w, y;
};

struct LnArgs {
  const float* lns;
  const float* lnb;
  int M, din, dout, splits, stages;
  float eps;
};

// the kernel's shared memory from its 1024-byte aligned base: the xn tile
// (din padded to 64-column panels), each consumer's 64 x BN output tile,
// the ring of BN x 64 W stages, the mbarriers
__host__ __device__ constexpr uint32_t ln_xn(int din) { return BM * ((din + KC - 1) / KC) * KC * 2; }
__host__ __device__ constexpr uint32_t ln_out(int bn) { return 64 * bn * 2; }
__host__ __device__ constexpr uint32_t ln_stage(int bn) { return bn * KC * 2; }
__host__ __device__ constexpr uint32_t ln_ring(int din, int bn) { return ln_xn(din) + NC * ln_out(bn); }
__host__ __device__ constexpr int ln_fit(int din, int bn) {
  return fit(ln_ring(din, bn) + LN_SLACK + BARS, ln_stage(bn));
}
__host__ __device__ constexpr uint32_t ln_smem(int din, int bn, int stages) {
  return LN_SLACK + ln_ring(din, bn) + stages * ln_stage(bn) + BARS;
}

static_assert(ln_fit(384, LN_BNS[0]) >= 4 && ln_fit(MAX_DIN, LN_BNS[1]) >= 4,
              "shared memory of one block");

// the descriptor of k16 step ks of rows [row0, row0 + 64 or BN) of a
// K-major 128-byte-swizzled tile of `rows` rows
__device__ __forceinline__ uint64_t ln_desc(uint32_t tile, int row0, int ks, int rows) {
  return gmma_desc_sw128(tile + swizzled_offset(row0, 2 * ks, rows));
}

// y tile of this warpgroup (64 rows from row0, BN columns from n0) in
// bf16: staged in 32-column panels of 64-byte rows, 16-byte chunk c of row
// r at chunk c ^ (r / 2 % 4) (TMA's SWIZZLE_64B), then one TMA copy a
// panel; the copies clip rows past M and columns past dout. ob is reused
// once the previous tile's copies have read it.
template <int BN>
__device__ __forceinline__ void ln_store(const float (&acc)[BN / 2], const LnMaps& maps,
                                         uint32_t ob, int n0, int row0, const LnArgs& p, int wg,
                                         int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  if (tid == 0) bulk_wait_read<0>();
  named_bar_sync(1 + wg, WG_THREADS);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      sts32(ob + (j >> 2) * 64 * 64 + r * 64 + (((j & 3) ^ ((r >> 1) & 3)) << 4) + 4 * tq,
            pack_bf16(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]));
    }
  fence_proxy_async();  // the staged tile before the TMA copies read it
  named_bar_sync(1 + wg, WG_THREADS);
  if (tid == 0 && row0 < p.M) {
    for (int c = 0; c < BN / OUT_PANEL && n0 + c * OUT_PANEL < p.dout; ++c)
      tma_store_2d(&maps.y, ob + c * 64 * OUT_PANEL * 2, n0 + c * OUT_PANEL, row0);
    bulk_commit();
  }
}

// y = bf16(LN(x) @ w^T) for rows [m0, m0 + 128) and the column tiles t in
// [t0, t1) of BN columns each
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    linear_ln_sm90_kernel(const __grid_constant__ LnMaps maps, const LnArgs p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sm = (smem_u32(smem) + LN_SLACK - 1) & ~(LN_SLACK - 1);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int rbs = (p.M + BM - 1) / BM, nt = (p.dout + BN - 1) / BN, nk = (p.din + KC - 1) / KC;
  const int m0 = (blockIdx.x % rbs) * BM, split = blockIdx.x / rbs;
  const int t0 = split * nt / p.splits, t1 = (split + 1) * nt / p.splits;
  constexpr uint32_t STAGE = ln_stage(BN);
  const uint32_t xn = sm, ring = sm + ln_ring(p.din, BN);
  const uint32_t bars = ring + p.stages * STAGE;  // FULL, EMPTY, XFULL as in init_ring
  init_ring(bars, p.stages);

  if (wg == NC) {  // the producer, one thread: the block's x, then W's k
                   // chunk kc of each tile t
    if (tid == 0) {
      if (!skip(SKIP_PROLOGUE)) {
        mbar_arrive_expect_tx(bars + XFULL, ln_xn(p.din));
        for (int kc = 0; kc < nk; ++kc)  // 64-column panel kc of the block's rows
          tma_load_2d(xn + swizzled_offset(0, 8 * kc, BM), &maps.x, bars + XFULL, kc * KC, m0);
      }
      Slot sl;
      for (int t = t0, use = 0; t < t1; ++t)
        for (int kc = 0; kc < nk; ++kc, ++use, sl.next(p.stages))
          if (begin_stage(bars, sl, use, p.stages, STAGE))
            tma_load_2d(ring + sl.s * STAGE, &maps.w, bars + FULL + 8 * sl.s, kc * KC, t * BN);
    }
    return;
  }

  // a consumer warpgroup: rows [m0 + 64 wg, m0 + 64 wg + 64), normalised
  // in place (chunks past din stay zero)
  const int lane = tid & 31;
  if (!skip(SKIP_PROLOGUE)) {
    mbar_wait(bars + XFULL, 0);
    ln_rows(xn, 64 * wg, p.din, p.lns, p.lnb, p.eps, tid,
            [](int r, int c) { return swizzled_offset(r, c, BM); });
  }
  fence_proxy_async();  // xn's generic-proxy writes before wgmma reads them
  named_bar_sync(1 + wg, WG_THREADS);

  float acc[BN / 2];
  Slot sl, prev;
  for (int t = t0; t < t1; ++t) {
    for (int kc = 0; kc < nk; ++kc, prev = sl, sl.next(p.stages)) {
      const uint32_t st = ring + sl.s * STAGE;
      mbar_wait(bars + FULL + 8 * sl.s, sl.phase);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        Wgmma<BN>::ss(acc, ln_desc(xn, 64 * wg, kc * KC / 16 + kk, BM), ln_desc(st, 0, kk, BN),
                      kc > 0 || kk > 0);
      wgmma_commit();
      if (kc > 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        fence_operands(acc);
        if (lane == 0) mbar_arrive(bars + EMPTY + 8 * prev.s);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(bars + EMPTY + 8 * prev.s);
    if (!skip(SKIP_EPILOGUE))
      ln_store<BN>(acc, maps, sm + ln_xn(p.din) + wg * ln_out(BN), t * BN, m0 + 64 * wg, p, wg,
                   tid);
  }
  if (tid == 0) bulk_wait<0>();  // the last stores are done before the block exits
}

// per card: the SM count, and which kernels opted in to their shared
// memory (bit 0 the up kernel, bit 1 + i the down kernel's DOWN_BNS[i],
// bit 4 + i linear_ln_sm90_kernel's LN_BNS[i])
struct Card {
  int sms = 0;
  unsigned opted = 0;
};
Card cards[32];
constexpr int DOWN_BNS[] = {160, 128, 64};

cudaError_t card(int device, Card*& c) {
  if (device < 0 || device >= 32) return cudaErrorInvalidDevice;
  c = &cards[device];
  return c->sms ? cudaSuccess
                : cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, device);
}

cudaError_t opt_in(Card* c, const void* fn, int bit, uint32_t smem) {
  if (c->opted >> bit & 1u) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) c->opted |= 1u << bit;
  return err;
}

// a TMA map of bf16 rows of `cols` elements (contiguous rows; `blocks`
// blocks of `rows` rows, `block_stride` elements apart, where blocks > 1)
// in boxes of box_cols columns x box_rows rows [x blocks], no swizzle
// unless asked: with 8 columns, a 16-byte chunk of each row, which lands
// as a column of core matrices of the no-swizzle wgmma layout; rows and
// columns past the data are zero-filled on a load and not written on a
// store
cudaError_t encode_boxes(CUtensorMap* map, const void* ptr, int cols, int rows, int box_cols,
                         int box_rows, int blocks = 1, long long block_stride = 0,
                         CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t size[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(blocks)};
  cuuint64_t stride[2] = {static_cast<cuuint64_t>(cols) * 2,
                          static_cast<cuuint64_t>(block_stride) * 2};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                       static_cast<cuuint32_t>(blocks)};
  cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, blocks > 1 ? 3 : 2,
                            const_cast<void*>(ptr), size, stride, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the number of blocks that share a row block's nt column tiles (one
// block an SM): the least waves x (a block's tiles x tile_cost + ln_cost),
// ln_cost the weight of the LN prologue that each split repeats
int choose_splits(int rbs, int nt, int sms, int tile_cost, int ln_cost) {
  int splits = 1;
  long long best = -1;
  for (int s = 1; s <= nt; ++s) {
    const long long waves = (static_cast<long long>(rbs) * s + sms - 1) / sms;
    const long long cost = waves * ((nt + s - 1) / s * static_cast<long long>(tile_cost) + ln_cost);
    if (best < 0 || cost < best) {
      best = cost;
      splits = s;
    }
  }
  return splits;
}

template <int BN>
cudaError_t launch_down_bn(const void* a, const void* w2, const void* x, void* y, DownArgs p,
                           Card* c, int bit, cudaStream_t st) {
  cudaError_t err =
      opt_in(c, reinterpret_cast<const void*>(geglu_down_sm90_kernel<BN>), bit, SMEM_MAX);
  DownMaps maps;
  if (err == cudaSuccess) err = encode_boxes(&maps.a, a, p.dff, p.M, 8, BM);
  if (err == cudaSuccess) err = encode_boxes(&maps.w2, w2, p.dff, p.din, 8, BN);
  if (err == cudaSuccess) err = encode_boxes(&maps.x, x, p.din, p.M, BN, 64);
  if (err == cudaSuccess) err = encode_boxes(&maps.y, y, p.din, p.M, BN, 64);
  if (err != cudaSuccess) return err;
  p.stages = fit(down_ring(BN), down_stage(BN));
  const int rbs = (p.M + BM - 1) / BM;
  const uint32_t smem = down_ring(BN) + p.stages * down_stage(BN);
  geglu_down_sm90_kernel<BN><<<rbs * (p.din / BN), THREADS, smem, st>>>(maps, p);
  return cudaGetLastError();
}

// linear_ln_sm90_kernel<BN> on p.splits blocks a row block
template <int BN>
cudaError_t launch_ln_bn(const void* x, const void* w, void* y, LnArgs p, Card* c, int bit,
                         cudaStream_t st) {
  cudaError_t err =
      opt_in(c, reinterpret_cast<const void*>(linear_ln_sm90_kernel<BN>), bit, SMEM_MAX);
  constexpr CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  LnMaps maps;
  if (err == cudaSuccess) err = encode_boxes(&maps.x, x, p.din, p.M, KC, BM, 1, 0, SW128);
  if (err == cudaSuccess) err = encode_boxes(&maps.w, w, p.din, p.dout, KC, BN, 1, 0, SW128);
  if (err == cudaSuccess)
    err = encode_boxes(&maps.y, y, p.dout, p.M, OUT_PANEL, 64, 1, 0, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  const int rbs = (p.M + BM - 1) / BM;
  if (p.splits < 1 || static_cast<long long>(rbs) * p.splits >= (1LL << 31))
    return cudaErrorInvalidValue;
  p.stages = ln_fit(p.din, BN);
  linear_ln_sm90_kernel<BN>
      <<<rbs * p.splits, THREADS, ln_smem(p.din, BN, p.stages), st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

// The up kernel: a [M, dff] = bf16(h * gelu(g)) of [LN](x) (lns == lnb ==
// null: no LayerNorm). din a multiple of 64 up to 640, dff a multiple of
// 64, 16-byte aligned bases. The dff tiles are split across blocks so that
// the grid's waves (one block an SM) times the tiles of a block (plus one
// for the prologue) is least.
cudaError_t launch_geglu_up_sm90(const void* x, const void* lns, const void* lnb, const void* w1,
                                 const void* b1, void* a, int M, int din, int dff, float eps,
                                 int device, cudaStream_t st) {
  Card* c;
  cudaError_t err = card(device, c);
  if (err == cudaSuccess)  // the most any call asks for, once
    err = opt_in(c, reinterpret_cast<const void*>(geglu_up_sm90_kernel), 0, SMEM_MAX);
  UpMaps maps;  // w1 as dff value rows, then dff gate rows
  if (err == cudaSuccess)
    err = encode_boxes(&maps.w1, w1, din, dff, 8, FT, 2, static_cast<long long>(dff) * din);
  if (err == cudaSuccess) err = encode_boxes(&maps.a, a, dff, M, FT, 64);
  if (err != cudaSuccess) return err;
  const int rbs = (M + BM - 1) / BM, splits = choose_splits(rbs, dff / FT, c->sms, 1, 1);
  if (static_cast<long long>(rbs) * splits >= (1LL << 31)) return cudaErrorInvalidValue;
  const UpArgs p{static_cast<const bf16*>(x), static_cast<const float*>(lns),
                 static_cast<const float*>(lnb), static_cast<const bf16*>(b1), M, din, dff,
                 splits, fit(up_ring(din), UP_STAGE), eps};
  geglu_up_sm90_kernel<<<rbs * splits, THREADS, up_ring(din) + p.stages * UP_STAGE, st>>>(maps, p);
  return cudaGetLastError();
}

// The down kernel: y [M, din] = bf16(bf16(a @ w2^T) + b2) [+ x], in column
// blocks of BN, the widest of 160, 128, 64 that divides din (at the UNet's
// L1, 160 runs as fast as 128 and 1.46x faster than 64, whose extra blocks
// reread a).
cudaError_t launch_geglu_down_sm90(const void* a, const void* w2, const void* b2, const void* x,
                                   void* y, int M, int din, int dff, int residual, int device,
                                   cudaStream_t st) {
  Card* c;
  const cudaError_t err = card(device, c);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(M + BM - 1) / BM * (din / 64) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const DownArgs p{static_cast<const bf16*>(b2), M, din, dff, residual != 0, 0};
  if (din % DOWN_BNS[0] == 0) return launch_down_bn<DOWN_BNS[0]>(a, w2, x, y, p, c, 1, st);
  if (din % DOWN_BNS[1] == 0) return launch_down_bn<DOWN_BNS[1]>(a, w2, x, y, p, c, 2, st);
  return launch_down_bn<DOWN_BNS[2]>(a, w2, x, y, p, c, 3, st);
}

// [x +] FF([LN](x)) through the two kernels on one stream: the up kernel
// writes a [M, dff] (bf16 scratch the caller allocates), the down kernel
// reads it. lns == lnb == NULL: no LayerNorm prologue. All tensors bf16
// except lns / lnb (f32); din a multiple of 64 up to 640, dff a multiple
// of 64; 16-byte aligned bases. Returns a cudaError_t code.
extern "C" int sdaof_geglu(const void* x, const void* lns, const void* lnb, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* a, void* y,
                           int M, int din, int dff, float eps, int residual, int device,
                           void* stream) {
  if (din % 64 != 0 || din < 64 || din > MAX_DIN || dff % FT != 0 || dff < FT || M < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(a) |
       reinterpret_cast<uintptr_t>(y)) & 15)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_geglu_up_sm90(x, lns, lnb, w1, b1, a, M, din, dff, eps, device, st);
  if (err != cudaSuccess) return err;
  return launch_geglu_down_sm90(a, w2, b2, x, y, M, din, dff, residual, device, st);
}

// #3: y [M, dout] = bf16(LN(x) @ w^T) through linear_ln_sm90_kernel<BN>
// for bf16 x [M, din], w [dout, din] and f32 lns / lnb; BN = 160 where 4
// ring stages fit beside the xn tile, else 64, and the column tiles split
// across blocks with a block's LN weighed as LN_COLS columns (the
// header's readings). din a multiple of 16 up to 640 (the last 64-column
// panel zero-filled past din), dout a multiple of 16; 16-byte aligned
// bases. Returns a cudaError_t code.
extern "C" int sdaof_linear_ln(const void* x, const void* lns, const void* lnb, const void* w,
                               void* y, int M, int din, int dout, float eps, int device,
                               void* stream) {
  if (din % 16 != 0 || din < 16 || din > MAX_DIN || dout % 16 != 0 || dout < 16 || M < 1 ||
      lns == nullptr || lnb == nullptr)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(lns) |
       reinterpret_cast<uintptr_t>(lnb) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) & 15)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  Card* c;
  if (err == cudaSuccess) err = card(device, c);
  if (err != cudaSuccess) return err;
  const int bn = ln_fit(din, LN_BNS[0]) >= 4 ? LN_BNS[0] : LN_BNS[1];
  const int splits = choose_splits((M + BM - 1) / BM, (dout + bn - 1) / bn, c->sms, bn, LN_COLS);
  const LnArgs p{static_cast<const float*>(lns), static_cast<const float*>(lnb), M, din, dout,
                 splits, 0, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == LN_BNS[0]) return launch_ln_bn<LN_BNS[0]>(x, w, y, p, c, 4, st);
  return launch_ln_bn<LN_BNS[1]>(x, w, y, p, c, 5, st);
}
