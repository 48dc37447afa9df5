// Flash-attention backward for Hopper (sm_90a): dK / dV and dQ as one
// wgmma skeleton with two epilogues. Plain C interface for ctypes
// (ops/_cuda.py builds and loads this file).
//
// The backward of out = softmax(s) v with s = scale * q k^T, for bf16 q
// [B, Nq, H, D], k/v [B, Nk, H, D] (D a multiple of 8 up to 128; any
// strides along B, N, H that are multiples of 8; unit stride along D),
// the cotangent dO (shaped as q), and two f32 [B*H, Nq] rows from the
// forward side: lse (base-2 log-sum-exp of the scores in the log2 domain,
// written by attention_sm90_kernel, csrc/attention_sm90.cu) and
// D = rowsum(dO * O). Scores are recomputed, never stored:
// P = exp2(scale_log2 * q.k - lse), dP = dO v^T, dS = P * (dP - D); then
// dV = P^T dO, dK = scale * dS^T q, dQ = scale * dS k. Gradients come
// back contiguous [B, N, H, D] in bf16. It replaces two Pallas TPU
// kernels of sd_animation_optical_flow_tpu/ops/attention.py (launched by
// _flash_bwd, the custom VJP of flash_attention_diff), keeping their
// split, so no block writes another's rows: no atomics, and every
// gradient is bitwise deterministic.
//
//   _flash_bwd_dkv_kernel -> attention_bwd_dkv_sm90_kernel (KIND_DKV): a
//     work unit is 64 * NC keys of one (b, h); the queries stream.
//   _flash_bwd_dq_kernel -> attention_bwd_dq_sm90_kernel (KIND_DQ): a work
//     unit is 64 * NC queries; the keys stream.
//
// What bounds them on the H100: 8 (dK / dV) and 6 (dQ) * B*H*Nq*Nk*D
// operations, 0.195 / 0.147 ms at the bf16 peak at SD's self-attention
// (self L0: 2 x 8 heads, 6144 tokens, d = 40), and each recomputes one
// exp2 per (query, key) pair: 6.0e8 exponentials, 0.155 ms on the
// special-function units. So, as in the forward, the design overlaps the
// elementwise chain with the tensor-core products:
//
// * Persistent blocks, one per SM, of NC consumer warpgroups and a
//   producer warpgroup. The producer loads each unit's own rows (K and V
//   for dK / dV; q and dO for dQ) into one of OWN_SLOTS slots and streams
//   the other axis through a ring of STAGES stages with 16-byte cp.async
//   and "full" / "empty" mbarriers, as attention_sm90.cu does: BS rows of
//   q and dO a stage, with the tile's lse and D rows (4-byte cp.async;
//   the columns past Nq get lse = +inf and D = 0, so P = 0 there exactly)
//   for dK / dV; BS rows of k and v for dQ. Up to 5 stages: a stage stays
//   held until the gradient products of its tile finish, one tile behind
//   the scores; on an H100 (700 W) 5 ran 2-7% faster than 4, and 6 or 8
//   no faster than 5.
//   Each consumer owns 64 of the unit's rows. The registers go to the
//   consumers (setmaxnreg).
// * dK / dV, per streamed tile: S^T = K q^T and dP^T = V dO^T, two wgmma
//   m64nBSk16 with A (the own rows) and B (the tile) from shared memory,
//   K-major; in f32 registers P^T = exp2(S^T scale_log2 - lse[col]) and
//   dS^T = P^T (dP^T - D[col]), the statistics per column, read from the
//   stage; then dV += P^T dO and dK += dS^T q, two wgmma m64nDPk16 with A
//   the score accumulators packed to bf16 pairs (the forward's
//   p-from-registers: P never touches shared memory) and B the same q /
//   dO tile read MN-major.
// * dQ, per streamed tile: S = q k^T and dP = dO v^T; P and dS with the
//   row statistics in registers, keys past Nk masked to P = 0 (on the
//   last tile only, a block-uniform branch: zero k rows would give
//   exp2(-lse) there); dQ += dS k, k read MN-major.
// * One layout, two readings: every tile is kept in the no-swizzle
//   core-matrix layout of sm90.cuh (tile_offset), which serves as the
//   K-major operand of a score product and the MN-major operand of a
//   gradient product from one copy.
// * Overlap: tile t's score products are issued together with tile
//   t-1's gradient products; the warpgroup waits for the score products
//   only, and runs tile t's elementwise chain while the gradient products
//   run; the consumer warpgroups take turns to issue (as in
//   attention_sm90.cu), so one's chain runs while the others' products do.
// * Epilogue: dK and dQ times scale = scale_log2 * ln2; bf16 staged
//   through the warpgroup's own rows of the slot and written as 16-byte
//   row chunks; rows past N and columns past D are never written. d is
//   padded to DP, a multiple of 16: the padded chunks of every tile are
//   zeroed once at the start and never loaded, so a fused-QKV slice's
//   neighbouring columns are never read.
//
// Registers (f32 a consumer thread, before addresses): dK / dV at BS = 64
// hold S^T, dP^T (32 each), dK, dV (DP / 2 each), packed P^T, dS^T (16
// each): 144 at DP = 48, 176 at DP = 80; dQ holds S, dP, dQ and packed
// dS: 104 / 120. NC and BS are chosen per kind and DP (Cfg below), with
// 56 registers left to the producer.

#include <math.h>

#include "sm90.cuh"

namespace {

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* dvec;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, Nq, Nk, D;
  long long qsb, qsn, qsh;
  long long ksb, ksn, ksh;
  long long vsb, vsn, vsh;
  long long osb, osn, osh;  // dO
  float scale_log2;         // softmax scale * log2(e)
};

constexpr int KIND_DKV = 0, KIND_DQ = 1;
constexpr int WG_THREADS = 128;      // a warpgroup
constexpr int PRODUCER = WG_THREADS;  // the producer warpgroup
constexpr int OWN_SLOTS = 2;         // own-row slots: the unit loaded ahead + 1
constexpr int SMEM_LIMIT = 232448;   // shared memory of one block
constexpr int MAX_STAGES = 5;        // the ring's stages, fewer where they do not fit
constexpr float LN2 = 0.69314718055994531f;

// sm90_probe.py --kernel bwd times copies of these kernels built with
// parts of the work left out, the bits of BWD_SKIP (0, nothing left out,
// in the port), and with three consumers for dK / dV (BWD_NC8 = 3, 0: the
// choice of Cfg) at BWD_REGS3 registers a consumer thread
#ifndef BWD_SKIP
#define BWD_SKIP 0
#endif
#ifndef BWD_NC8
#define BWD_NC8 0
#endif
#ifndef BWD_REGS3
#define BWD_REGS3 152  // a consumer thread's registers with three consumers
#endif
constexpr int SKIP_EXP = 1, SKIP_LOADS = 2, SKIP_SCORES = 4, SKIP_GRADS = 8, SKIP_CHAIN = 16,
              SKIP_TURNS = 32;
__host__ __device__ constexpr bool skip(int part) { return (BWD_SKIP & part) != 0; }

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// per kind and DP (head dim padded to a multiple of 16): NC consumer
// warpgroups (64 * NC own rows a unit), BS streamed rows a stage, the
// register split, and the shared-memory map
template <int KIND, int DP>
struct Cfg {
  static constexpr bool DKV = KIND == KIND_DKV;
  static constexpr int NC = DKV ? (BWD_NC8 ? BWD_NC8 : 2) : (DP <= 80 ? 3 : 2);
  // #8 holds four accumulators a tile: 32-query tiles past DP = 80 or with
  // three consumers keep them in registers
  static constexpr int BS = DKV && (DP > 80 || NC == 3) ? 32 : 64;
  static constexpr int ROWS = 64 * NC;  // own rows a unit
  static constexpr int THREADS = NC * WG_THREADS + PRODUCER;
  static constexpr int CONSUMER_REGS = NC == 3 ? BWD_REGS3 : 224;  // a thread, after the hand-over
  static constexpr int PRODUCER_REGS = NC == 3 ? (65536 - 384 * BWD_REGS3) / 128 : 56;
  static_assert(PRODUCER_REGS * PRODUCER + CONSUMER_REGS * NC * WG_THREADS <= 65536, "registers");
  static constexpr uint32_t OWN_TILE = ROWS * DP * 2;  // one of the two own tensors
  static constexpr uint32_t OWN_BYTES = 2 * OWN_TILE;
  static constexpr uint32_t TILE = BS * DP * 2;        // one of the two streamed tensors
  static constexpr uint32_t STAGE_BYTES = 2 * TILE + (DKV ? 8 * BS : 0);  // + lse, D
  static constexpr uint32_t RING = OWN_SLOTS * OWN_BYTES;
  static constexpr int BARRIERS = 8 * (2 * MAX_STAGES + 2 * OWN_SLOTS);
  static constexpr int SCHED_BAR = 1 + NC;  // named barriers of the turns (1 .. NC: the epilogues)
  static constexpr int STAGES =
      cmin(MAX_STAGES, static_cast<int>((SMEM_LIMIT - RING - BARRIERS) / STAGE_BYTES));
  static_assert(STAGES >= 2, "shared memory of one block");
  static constexpr uint32_t FULL = RING + STAGES * STAGE_BYTES;  // mbarriers
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES;
  static constexpr uint32_t OFULL = EMPTY + 8 * STAGES;
  static constexpr uint32_t OEMPTY = OFULL + 8 * OWN_SLOTS;
  static constexpr uint32_t SMEM = OEMPTY + 8 * OWN_SLOTS;
  static_assert(SMEM <= SMEM_LIMIT, "shared memory of one block");
  static_assert(BS == 32 || BS == 64 || BS == 128, "a score product's width");
};

// a [B, N, H, D] operand: base and strides
struct View {
  const bf16* p;
  long long sb, sn, sh;
  __device__ const bf16* at(int b, int h) const { return p + b * sb + h * sh; }
};

// the two own and the two streamed tensors of a kind, and the lengths of
// their axes
template <int KIND>
struct Roles {
  View own0, own1, str0, str1;
  int n_own, n_str;
  __device__ explicit Roles(const BwdArgs& a) {
    const View q{a.q, a.qsb, a.qsn, a.qsh}, k{a.k, a.ksb, a.ksn, a.ksh},
        v{a.v, a.vsb, a.vsn, a.vsh}, o{a.dout, a.osb, a.osn, a.osh};
    if (KIND == KIND_DKV) {
      own0 = k, own1 = v, str0 = q, str1 = o, n_own = a.Nk, n_str = a.Nq;
    } else {
      own0 = q, own1 = o, str0 = k, str1 = v, n_own = a.Nq, n_str = a.Nk;
    }
  }
};

// work unit u: ROWS own rows of one (batch, head)
struct Unit {
  int bh, r0;
  __device__ Unit(int u, int nblk, int rows) : bh(u / nblk), r0((u % nblk) * rows) {}
};

// 4-byte cp.async (the statistics rows, 4-byte aligned only)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// zero 16-byte chunks [ch, DP / 8) of a tile of `rows` rows (contiguous
// in the chunk-major layout)
__device__ __forceinline__ void zero_pad(uint32_t tile, int rows, int ch, int dp8, int threads) {
  for (uint32_t off = ch * rows * 16 + threadIdx.x * 16; off < static_cast<uint32_t>(dp8 * rows * 16);
       off += threads * 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(tile + off), "r"(0) : "memory");
}

// the producer warpgroup: per work unit its own rows into one of
// OWN_SLOTS slots, then the streamed tiles through the ring (and, for
// dK / dV, each tile's lse and D rows); it runs ahead of the consumers by
// up to STAGES tiles and OWN_SLOTS - 1 units' own rows
template <int KIND, int DP>
__device__ __forceinline__ void produce(const BwdArgs& a, int units, int nblk, int nt, uint32_t sm,
                                        int tid) {
  using C = Cfg<KIND, DP>;
  constexpr int BS = C::BS, ROWS = C::ROWS;
  constexpr int NE = (BS * DP / 8 + PRODUCER - 1) / PRODUCER;  // copies per tile
  const Roles<KIND> ro(a);
  const int ch = a.D / 8, rq = 8 * ch;  // 16-byte chunks of a row, of a row group
  // a thread's copies of a streamed tile are elements e = tid + i *
  // PRODUCER: row group e / rq, w = e % rq, row 8 (e / rq) + w % 8, chunk
  // w / 8, so 8 neighbouring threads store the 8 rows of one core matrix
  // (no bank conflicts); (e / rq, e % rq) step by (PRODUCER / rq,
  // PRODUCER % rq) with a carry, in a loop left rolled
  const int g0 = tid / rq, w0 = tid % rq, dg = PRODUCER / rq, dw = PRODUCER % rq;
  int tl = 0;  // tiles loaded so far
  // each load is one cp.async group with its "full" barrier, signalled
  // once it has landed (wait, fence the copies before wgmma, arrive); up
  // to three groups in flight, all signalled before blocking on a slot
  // the consumers still hold (attention_sm90.cu's scheme)
  uint32_t p0 = 0, p1 = 0;
  auto signal = [&](uint32_t bar) {
    cp_async_commit();
    if (p0) {
      cp_async_wait<2>();
      fence_proxy_async();
      mbar_arrive(p0);
    }
    p0 = p1;
    p1 = bar;
  };
  auto acquire = [&](uint32_t bar, uint32_t parity) {
    if (mbar_test(bar, parity)) return;
    cp_async_wait<0>();
    fence_proxy_async();
    if (p0) mbar_arrive(p0);
    if (p1) mbar_arrive(p1);
    p0 = p1 = 0;
    mbar_wait(bar, parity);
  };
  for (int li = 0, u = blockIdx.x; u < units; ++li, u += gridDim.x) {
    const Unit un(u, nblk, ROWS);
    const int b = un.bh / a.H, h = un.bh % a.H, slot = li % OWN_SLOTS;
    const bf16* x0 = ro.own0.at(b, h);
    const bf16* x1 = ro.own1.at(b, h);
    const bf16* y0 = ro.str0.at(b, h);
    const bf16* y1 = ro.str1.at(b, h);
    if (li >= OWN_SLOTS) acquire(sm + C::OEMPTY + 8 * slot, ((li / OWN_SLOTS) - 1) & 1);
    const uint32_t xs = sm + slot * C::OWN_BYTES;
    for (int e = tid; e < ROWS * ch; e += PRODUCER) {
      const int gq = e / rq, w = e - gq * rq;
      const int r = gq * 8 + (w & 7), c = w >> 3;
      const bool ok = un.r0 + r < ro.n_own;
      const uint32_t off = tile_offset(r, c, ROWS);
      cp_async16(xs + off, ok ? x0 + (un.r0 + r) * ro.own0.sn + c * 8 : x0, ok ? 16 : 0);
      cp_async16(xs + C::OWN_TILE + off, ok ? x1 + (un.r0 + r) * ro.own1.sn + c * 8 : x1, ok ? 16 : 0);
    }
    signal(sm + C::OFULL + 8 * slot);
    const float* lse = a.lse + static_cast<long long>(un.bh) * a.Nq;
    const float* dvec = a.dvec + static_cast<long long>(un.bh) * a.Nq;
    for (int t = 0; t < nt; ++t, ++tl) {
      const int s = tl % C::STAGES;
      if (tl >= C::STAGES) acquire(sm + C::EMPTY + 8 * s, ((tl / C::STAGES) - 1) & 1);
      const uint32_t st = sm + C::RING + s * C::STAGE_BYTES;
      const int n0 = t * BS, nvalid = ro.n_str - n0;
      if (!(skip(SKIP_LOADS) && t >= C::STAGES)) {
        const bf16* t0 = y0 + static_cast<long long>(n0) * ro.str0.sn;
        const bf16* t1 = y1 + static_cast<long long>(n0) * ro.str1.sn;
        int gq = g0, w = w0;
#pragma unroll 1
        for (int i = 0; i < NE; ++i) {
          if (gq < BS / 8) {
            const int r = gq * 8 + (w & 7), c = w >> 3;
            const bool ok = r < nvalid;
            const uint32_t off = tile_offset(r, c, BS);
            cp_async16(st + off, ok ? t0 + r * ro.str0.sn + c * 8 : y0, ok ? 16 : 0);
            cp_async16(st + C::TILE + off, ok ? t1 + r * ro.str1.sn + c * 8 : y1, ok ? 16 : 0);
          }
          gq += dg;
          w += dw;
          if (w >= rq) {
            w -= rq;
            ++gq;
          }
        }
        if (KIND == KIND_DKV) {
          // the tile's lse, then its D; past Nq lse = +inf (P = exp2(-inf)
          // = 0) and D = 0, a zero fill would give P = exp2(s) there
          for (int i = tid; i < 2 * BS; i += PRODUCER) {
            const int c = i % BS;
            const bool is_d = i >= BS;
            const uint32_t dst = st + 2 * C::TILE + 4 * i;
            if (c < nvalid)
              cp_async4(dst, (is_d ? dvec : lse) + n0 + c);
            else
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(dst), "f"(is_d ? 0.f : INFINITY)
                           : "memory");
          }
        }
      }
      signal(sm + C::FULL + 8 * s);
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  if (p0) mbar_arrive(p0);
  if (p1) mbar_arrive(p1);
}

// P and dS of one score tile in place (s -> P, dp -> dS), in the
// accumulator layout: statistics per column (dK / dV: this thread's
// columns 8j + 2t, 8j + 2t + 1, read from the stage) or per row (dQ: this
// thread's rows g, g + 8, in registers; keys >= nvalid masked)
template <int BS, bool PER_COLUMN>
__device__ __forceinline__ void chain(float (&s)[BS / 2], float (&dp)[BS / 2], float scale_log2,
                                      int tq, uint32_t stats, const float (&lse)[2],
                                      const float (&dv)[2], int nvalid) {
  if (skip(SKIP_CHAIN)) return;
  const auto ex = [](float x) { return skip(SKIP_EXP) ? x : fast_exp2(x); };
#pragma unroll
  for (int j = 0; j < BS / 8; ++j) {
    float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;  // the statistics of this thread's 4 scores of block j
    if (PER_COLUMN) {
      const float2 l = lds2(stats + 4 * (8 * j + 2 * tq));
      const float2 d = lds2(stats + 4 * BS + 4 * (8 * j + 2 * tq));
      l0 = l.x, l1 = l.y, d0 = d.x, d1 = d.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float l = PER_COLUMN ? (i & 1 ? l1 : l0) : lse[i >> 1];
      const float d = PER_COLUMN ? (i & 1 ? d1 : d0) : dv[i >> 1];
      float p = ex(fmaf(s[4 * j + i], scale_log2, -l));
      if (!PER_COLUMN && nvalid < BS && 8 * j + 2 * tq + (i & 1) >= nvalid) p = 0.f;
      s[4 * j + i] = p;
      dp[4 * j + i] = p * (dp[4 * j + i] - d);
    }
  }
}

// a consumer warpgroup on work unit `un` (its li-th): own rows [r0 + 64
// wg, r0 + 64 wg + 64); the unit's tiles are the ring's T0 .. T0 + nt - 1
template <int KIND, int DP>
__device__ __forceinline__ void consume(const BwdArgs& a, const Unit& un, int li, bool last,
                                        int T0, int nt, uint32_t sm, int wg, int tid) {
  using C = Cfg<KIND, DP>;
  constexpr bool DKV = C::DKV;
  constexpr int BS = C::BS, ROWS = C::ROWS;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int slot = li % OWN_SLOTS;
  // own operands: K, V (dK / dV) or q, dO (dQ); this warpgroup's rows
  const uint32_t xs = sm + slot * C::OWN_BYTES;
  const uint32_t xa = xs + tile_offset(64 * wg, 0, ROWS), xb = xa + C::OWN_TILE;
  auto stage = [&](int t) { return sm + C::RING + ((T0 + t) % C::STAGES) * C::STAGE_BYTES; };
  // S (or S^T) = own0 str0^T and dP (dP^T) = own1 str1^T, both K-major
  auto scores = [&](float(&s)[BS / 2], float(&dp)[BS / 2], uint32_t st) {
    if (skip(SKIP_SCORES)) return;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      Wgmma<BS>::ss(s, gmma_desc(xa + kk * 2 * ROWS * 16, ROWS * 16, 128),
                    gmma_desc(st + kk * 2 * BS * 16, BS * 16, 128), kk > 0);
      Wgmma<BS>::ss(dp, gmma_desc(xb + kk * 2 * ROWS * 16, ROWS * 16, 128),
                    gmma_desc(st + C::TILE + kk * 2 * BS * 16, BS * 16, 128), kk > 0);
    }
  };
  // acc0 += A0 B0 (and acc1 += A1 B1), B a streamed tile read MN-major:
  // dV += P^T dO, dK += dS^T q; or dQ += dS k
  auto grads = [&](float(&acc0)[DP / 2], const uint32_t(&a0)[BS / 16][4], uint32_t b0,
                   float(&acc1)[DP / 2], const uint32_t(&a1)[BS / 16][4], uint32_t b1) {
    if (skip(SKIP_GRADS)) return;
#pragma unroll
    for (int j = 0; j < BS / 16; ++j) {
      Wgmma<DP>::rs_bt(acc0, a0[j], gmma_desc(b0 + j * 256, 128, BS * 16));
      if (DKV) Wgmma<DP>::rs_bt(acc1, a1[j], gmma_desc(b1 + j * 256, 128, BS * 16));
    }
  };
  auto wait_full = [&](int t) {
    mbar_wait(sm + C::FULL + 8 * ((T0 + t) % C::STAGES), ((T0 + t) / C::STAGES) & 1);
  };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(sm + C::EMPTY + 8 * ((T0 + t) % C::STAGES));
  };
  // the consumers take turns, in a ring, to issue their products (as in
  // attention_sm90.cu): wait for this warpgroup's turn, then hand it on
  // (the last consumer opens at the kernel's start and skips its very
  // last hand-over, so every arrival meets a wait)
  auto turn = [&]() {
    if (!skip(SKIP_TURNS)) named_bar_sync(C::SCHED_BAR + wg, 2 * WG_THREADS);
  };
  auto pass = [&](bool final_batch) {
    if (!skip(SKIP_TURNS) && !(final_batch && last && wg == C::NC - 1))
      named_bar_arrive(C::SCHED_BAR + (wg + 1) % C::NC, 2 * WG_THREADS);
  };

  // row statistics of this thread's rows (dQ): padded rows get P = 0
  const int r0 = 64 * wg + 16 * warp + g;  // unit-local rows r0, r0 + 8
  float lse[2] = {0.f, 0.f}, dvr[2] = {0.f, 0.f};
  if (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = un.r0 + r0 + 8 * r;
      const long long at = static_cast<long long>(un.bh) * a.Nq + row;
      lse[r] = row < a.Nq ? a.lse[at] : INFINITY;
      dvr[r] = row < a.Nq ? a.dvec[at] : 0.f;
    }
  }
  const int n_str = DKV ? a.Nq : a.Nk;
  auto elementwise = [&](float(&s)[BS / 2], float(&dp)[BS / 2], int t) {
    chain<BS, DKV>(s, dp, a.scale_log2, tq, stage(t) + 2 * C::TILE, lse, dvr,
                   min(BS, n_str - t * BS));
  };

  // dK / dV: acc0 = dV (A = P^T, B = dO), acc1 = dK (A = dS^T, B = q);
  // dQ: acc0 = dQ (A = dS, B = k), acc1 and p unused
  float s[BS / 2], dp[BS / 2], acc0[DP / 2], acc1[DP / 2];
  uint32_t p[BS / 16][4], ds[BS / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc0[i] = acc1[i] = 0.f;
  auto issue_grads = [&](int t) {
    const uint32_t st = stage(t);
    if (DKV)
      grads(acc0, p, st + C::TILE, acc1, ds, st);
    else
      grads(acc0, ds, st, acc1, ds, st);
  };
  auto fence_accs = [&]() {
    fence_operands(acc0);
    if (DKV) fence_operands(acc1);
    fence_operands(ds);
    if (DKV) fence_operands(p);
  };
  auto pack = [&]() {
    if (DKV) pack_p<BS>(p, s);
    pack_p<BS>(ds, dp);
  };

  mbar_wait(sm + C::OFULL + 8 * slot, (li / OWN_SLOTS) & 1);
  wait_full(0);
  turn();
  wgmma_fence();
  scores(s, dp, stage(0));
  wgmma_commit();
  pass(false);
  wgmma_wait<0>();
  fence_operands(s);
  fence_operands(dp);
  elementwise(s, dp, 0);
  pack();
  for (int t = 1; t < nt; ++t) {
    wait_full(t);
    fence_accs();
    turn();
    wgmma_fence();
    scores(s, dp, stage(t));
    wgmma_commit();
    issue_grads(t - 1);
    wgmma_commit();
    pass(false);
    wgmma_wait<1>();  // the score products of tile t done, tile t - 1's gradients running
    fence_operands(s);
    fence_operands(dp);
    elementwise(s, dp, t);
    wgmma_wait<0>();
    fence_accs();
    release(t - 1);
    pack();
  }
  fence_accs();
  turn();
  wgmma_fence();
  issue_grads(nt - 1);
  wgmma_commit();
  pass(true);
  wgmma_wait<0>();
  fence_accs();
  release(nt - 1);

  // stage the bf16 gradients over this warpgroup's own rows (its last
  // products have completed; the padded chunks stay zero), then write
  // 16-byte chunks of whole rows and hand the slot back to the producer:
  // dK / dV: dV over V's rows, dK (scaled) over K's; dQ (scaled) over q's
  const int ch = a.D / 8, b = un.bh / a.H, h = un.bh % a.H;
  const float scale = a.scale_log2 * LN2;
  auto put = [&](uint32_t x, const float(&acc)[DP / 2], float f) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (j >= ch) break;
      const uint32_t at = x + tile_offset(r0, j, ROWS) + 4 * tq;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(acc[4 * j] * f, acc[4 * j + 1] * f))
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 128),
                   "r"(pack_bf16(acc[4 * j + 2] * f, acc[4 * j + 3] * f))
                   : "memory");
    }
  };
  if (DKV) {
    put(xs, acc1, scale);
    put(xs + C::OWN_TILE, acc0, 1.f);
  } else {
    put(xs, acc0, scale);
  }
  named_bar_sync(1 + wg, WG_THREADS);
  const int n_own = DKV ? a.Nk : a.Nq;
  const int c = tid % ch, rstep = WG_THREADS / ch;  // a thread's chunk; rows a pass
  if (tid < rstep * ch)
    for (int r = tid / ch; r < 64; r += rstep) {
      const int row = un.r0 + 64 * wg + r;
      if (row >= n_own) break;
      const long long at = ((static_cast<long long>(b) * n_own + row) * a.H + h) * a.D + c * 8;
      const uint32_t off = tile_offset(64 * wg + r, c, ROWS);
#pragma unroll
      for (int x = 0; x < (DKV ? 2 : 1); ++x) {
        uint4 val;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                     : "r"(xs + x * C::OWN_TILE + off)
                     : "memory");
        bf16* out = DKV ? (x ? a.dv : a.dk) : a.dq;
        *reinterpret_cast<uint4*>(out + at) = val;
      }
    }
  __syncwarp();
  if (lane == 0) mbar_arrive(sm + C::OEMPTY + 8 * slot);
}

// persistent: block i takes work units i, i + gridDim.x, ... of the
// B * H * ceil(N_own / ROWS) units (neighbouring blocks share a head's
// streamed rows in L2)
template <int KIND, int DP>
__device__ __forceinline__ void attention_bwd_sm90(const BwdArgs& a, int B) {
  using C = Cfg<KIND, DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int n_own = KIND == KIND_DKV ? a.Nk : a.Nq, n_str = KIND == KIND_DKV ? a.Nq : a.Nk;
  const int nblk = (n_own + C::ROWS - 1) / C::ROWS, units = B * a.H * nblk;
  const int nt = (n_str + C::BS - 1) / C::BS;

  // zero the padded chunks once (no load writes them), then the barriers
  const int ch = a.D / 8;
  for (int s = 0; s < OWN_SLOTS; ++s)
    for (int x = 0; x < 2; ++x)
      zero_pad(sm + s * C::OWN_BYTES + x * C::OWN_TILE, C::ROWS, ch, DP / 8, C::THREADS);
  for (int s = 0; s < C::STAGES; ++s)
    for (int x = 0; x < 2; ++x)
      zero_pad(sm + C::RING + s * C::STAGE_BYTES + x * C::TILE, C::BS, ch, DP / 8, C::THREADS);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(sm + C::FULL + 8 * s, PRODUCER);  // one arrival a producer thread
      mbar_init(sm + C::EMPTY + 8 * s, 4 * C::NC);  // one release a consumer warp
    }
    for (int s = 0; s < OWN_SLOTS; ++s) {
      mbar_init(sm + C::OFULL + 8 * s, PRODUCER);
      mbar_init(sm + C::OEMPTY + 8 * s, 4 * C::NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // one branch a role to the kernel's end, so ptxas can hold each to its
  // setmaxnreg count
  if (wg == C::NC) {  // the producer, after the consumers' warpgroups
    setmaxnreg_dec<C::PRODUCER_REGS>();
    produce<KIND, DP>(a, units, nblk, nt, sm, tid);
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    if (!skip(SKIP_TURNS) && wg == C::NC - 1)
      named_bar_arrive(C::SCHED_BAR, 2 * WG_THREADS);  // consumer 0 first
    for (int li = 0, u = blockIdx.x; u < units; ++li, u += gridDim.x)
      consume<KIND, DP>(a, Unit(u, nblk, C::ROWS), li, u + gridDim.x >= units, li * nt, nt, sm,
                        wg, tid);
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg<KIND_DKV, DP>::THREADS, 1)
    attention_bwd_dkv_sm90_kernel(BwdArgs a, int B) {
  attention_bwd_sm90<KIND_DKV, DP>(a, B);
}

template <int DP>
__global__ void __launch_bounds__(Cfg<KIND_DQ, DP>::THREADS, 1)
    attention_bwd_dq_sm90_kernel(BwdArgs a, int B) {
  attention_bwd_sm90<KIND_DQ, DP>(a, B);
}

template <int KIND, int DP>
cudaError_t launch_dp(const BwdArgs& a, int B, int device, cudaStream_t st) {
  using C = Cfg<KIND, DP>;
  const void* kernel = KIND == KIND_DKV
                           ? reinterpret_cast<const void*>(attention_bwd_dkv_sm90_kernel<DP>)
                           : reinterpret_cast<const void*>(attention_bwd_dq_sm90_kernel<DP>);
  // the opt-in above 48 KB and the SM count, once per card
  static unsigned opted = 0;
  static int sms[32];
  if (device >= 32 || !(opted >> device & 1u)) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device >= 32) return cudaErrorInvalidDevice;
    sms[device] = n;
    opted |= 1u << device;
  }
  const int n_own = KIND == KIND_DKV ? a.Nk : a.Nq;
  const long long units = static_cast<long long>(B) * a.H * ((n_own + C::ROWS - 1) / C::ROWS);
  if (units >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(units < sms[device] ? units : sms[device]);
  if (KIND == KIND_DKV)
    attention_bwd_dkv_sm90_kernel<DP><<<grid, C::THREADS, C::SMEM, st>>>(a, B);
  else
    attention_bwd_dq_sm90_kernel<DP><<<grid, C::THREADS, C::SMEM, st>>>(a, B);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_bwd(const BwdArgs& a, int B, int device, cudaStream_t st) {
  switch ((a.D + 15) / 16) {
    case 1: return launch_dp<KIND, 16>(a, B, device, st);
    case 2: return launch_dp<KIND, 32>(a, B, device, st);
    case 3: return launch_dp<KIND, 48>(a, B, device, st);
    case 4: return launch_dp<KIND, 64>(a, B, device, st);
    case 5: return launch_dp<KIND, 80>(a, B, device, st);
    case 6: return launch_dp<KIND, 96>(a, B, device, st);
    case 7: return launch_dp<KIND, 112>(a, B, device, st);
    default: return launch_dp<KIND, 128>(a, B, device, st);
  }
}

// 16-byte tile loads and stores: D % 8 == 0 up to 128, 16-byte aligned
// bases, strides that are multiples of 8 elements
bool bwd_ok(const BwdArgs& a, int B) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
                         reinterpret_cast<uintptr_t>(a.dq) | reinterpret_cast<uintptr_t>(a.dk) |
                         reinterpret_cast<uintptr_t>(a.dv);
  const long long strides = a.qsb | a.qsn | a.qsh | a.ksb | a.ksn | a.ksh | a.vsb | a.vsn |
                            a.vsh | a.osb | a.osn | a.osh;
  return a.D >= 8 && a.D <= 128 && a.D % 8 == 0 && (ptrs & 15) == 0 && (strides & 7) == 0 &&
         B >= 1 && a.H >= 1 && a.Nq >= 1 && a.Nk >= 1;
}

BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dvec, int H, int Nq, int Nk, int D,
                      long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                      long long ksh, long long vsb, long long vsn, long long vsh, long long osb,
                      long long osn, long long osh, float scale_log2) {
  return BwdArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, dvec,
                 nullptr, nullptr, nullptr, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
                 osb, osn, osh, scale_log2};
}

}  // namespace

// dK, dV (bf16, contiguous [B, Nk, H, D]) of the attention backward.
// Returns a cudaError_t code (0 = ok).
extern "C" int sdaof_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* dvec,
                                       void* dk, void* dv, int B, int H, int Nq, int Nk, int D,
                                       long long qsb, long long qsn, long long qsh,
                                       long long ksb, long long ksn, long long ksh,
                                       long long vsb, long long vsn, long long vsh,
                                       long long osb, long long osn, long long osh,
                                       float scale_log2, int device, void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, dvec, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                            vsb, vsn, vsh, osb, osn, osh, scale_log2);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  if (!bwd_ok(a, B)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd<KIND_DKV>(a, B, device, static_cast<cudaStream_t>(stream));
}

// dQ (bf16, contiguous [B, Nq, H, D]) of the attention backward.
extern "C" int sdaof_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* dvec,
                                      void* dq, int B, int H, int Nq, int Nk, int D,
                                      long long qsb, long long qsn, long long qsh, long long ksb,
                                      long long ksn, long long ksh, long long vsb, long long vsn,
                                      long long vsh, long long osb, long long osn, long long osh,
                                      float scale_log2, int device, void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, dvec, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                            vsb, vsn, vsh, osb, osn, osh, scale_log2);
  a.dq = static_cast<bf16*>(dq);
  if (!bwd_ok(a, B)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd<KIND_DQ>(a, B, device, static_cast<cudaStream_t>(stream));
}
