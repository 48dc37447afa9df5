// Flash-attention forward for Hopper (sm_90a): wgmma, a cp.async K/V
// ring fed by a producer warpgroup, and the softmax of one key tile
// overlapped with the p v product of the one before. Plain C interface
// for ctypes (ops/_cuda.py builds and loads this file).
//
// attention_sm90_kernel computes out = softmax(q k^T * scale) v for bf16
// q [B, Nq, H, D] and k/v [B, Nk, H, D] (D a multiple of 8 up to 128, up
// to 160 in the keymask, MFR and banded modes below; any strides along B, N, H
// that are multiples of 8 elements; unit stride along D), writing a
// contiguous [B, Nq, H, D] out, and, where lse is
// given, each query row's base-2 log-sum-exp m + log2(l) of the scaled
// scores (f32 [B*H, Nq]) for the backward (csrc/attention_bwd_sm90.cu). It
// replaces five Pallas TPU kernels of sd_animation_optical_flow_tpu/ops/
// attention.py, whose Python wrappers keep their names and counters:
//
//   _flash_kernel_tpv (flash_attention_tpv: the UNet self-attention at
//     >= 1536 tokens, d = 40 / 80, and the short-K prompt
//     cross-attention; sdaof_attention with wide = 0, d <= 128)
//   _flash_kernel_tpv_stats (_flash_fwd_stats: the forward of
//     flash_attention_diff under a gradient; sdaof_attention_fwd_stats).
//     The TPU kernel is max-free and returns the denominator l; with a
//     tracked max the LSE is the statistic that stays finite.
//   _flash_mfr_kernel (flash_attention_mfr, via strip_attention: the MFR
//     strip self-attention, every d up to 160; sdaof_attention_mfr in
//     attention.cu routes here) -> attention_sm90_kernel<DP, MODE_MFR,
//     NC>, the same kernel with an epilogue on the score tile (below).
//   _flash_keymask_kernel_tpv (flash_attention_keymask, via
//     attention_injected: the CFG K/V injection, every d up to 160;
//     sdaof_attention_keymask in attention.cu routes here) ->
//     attention_sm90_kernel<DP, MODE_KEYMASK, NC>: the batch rows b <
//     n_uncond (the uncond half) see
//     keys < n_own only. A unit of such a row walks min(Nk, n_own) keys
//     instead of Nk, its last tile masked and its loads past that bound
//     zero-filled exactly as the ragged last tile of Nk is, so the uncond
//     rows never read a key past n_own (the TPU kernel masks the same
//     scores to -1e30 and still streams them). The producer and the
//     consumers index the ring by a running count of the tiles of the
//     units they walk, in the same order. At the injected inpaint's L0
//     (2 x 8 heads, 6144 queries, 12288 keys, n_own 6144, one uncond row)
//     the 512 units take 48 or 96 key tiles; round-robin over 132 blocks
//     the busiest block walks 288 tiles against a mean of 279 (an order
//     of the units heaviest first gives the same 288).
//   _flash_banded_kernel (flash_attention_banded: one frame's queries
//     against n frames' keys joined along the token axis, with the
//     banded cross-frame bias; on no pipeline path; sdaof_attention_banded
//     in attention.cu routes every d up to 160 here) ->
//     attention_sm90_kernel<DP, MODE_BANDED, NC>: Nq = h * w, Nk a whole
//     number of frames, every unit walking all Nk keys; the bias below.
//
// What bounds it on the H100: at SD's self-attention (self L0: 2 x 8
// heads, 6144 tokens, d = 40) the tensor-core work takes 0.098 ms at the
// bf16 peak, but softmax needs one exp2 per (query, key) pair, and the
// special-function units give 16 a clock per SM: 6.0e8 exponentials take
// 0.155 ms at 3.9e12 / s. At d = 40 the exponentials, not the matrix
// products, are the floor, so the design overlaps the two:
//
// * Persistent blocks, one per SM, of NC consumer warpgroups and a
//   producer warpgroup, walk the work units (BQ = 64 NC query rows of one
//   batch row and head). The producer loads each unit's Q into one of
//   QSLOTS slots and streams the K/V tiles of BK keys (128 for d <= 48,
//   else 64) into a ring of STAGES shared-memory stages with 16-byte
//   cp.async; each load is a cp.async group whose "full" mbarrier the
//   producer arrives on (after a proxy fence) once it has landed, up to
//   three groups in flight, and the consumers' release arrives on the
//   stage's "empty" one. Each consumer owns 64 of the unit's rows. The
//   next unit's Q and first tiles load while this unit computes and
//   stores, which is what the short-K cross-attention (2 to 4 key tiles
//   a unit) needs: there a unit's latency, not its math, sets the time,
//   so the units are few and wide. 192 rows make the UNet's 1536-token
//   level 128 units, one wave on the H100's 132 SMs (128 rows made 192
//   units, two on 60 SMs), and its 6144-token level 4 units a block
//   instead of 6. 512 threads start with 128 registers each; the
//   producer drops to 56 (setmaxnreg) and the consumers take 152: a
//   consumer holds s (BK / 2 f32), p (BK / 4 bf16 pairs) and o (DP / 2
//   f32), 120 of them at d = 48, BK = 128, and at 128 ptxas spills and
//   serialises the wgmma. NC, the consumer count, is a template
//   argument (CONSUMERS, 3, at every DP). At d 136-160 (DP = 160,
//   SD-1.5's third UNet level) o alone takes 80 registers; three
//   consumers fit there on 32-key tiles (4 stages of 20 KB beside 2 x 60
//   KB of Q slots: 200 KB), so the 1536-token level is one wave of 128
//   units; in the MFR mode the consumers take 160 registers and leave
//   the producer 32 (at 152 its band state spills 8 bytes). Two
//   consumers on 64-key tiles (128-row units, 1.45 waves, K/V read from
//   L2 half as often again) took 1.47-1.77x the time at the L2 shapes on
//   the H100, held by their loads.
// * q k^T: wgmma m64nBKk16, A = Q and B = K both from shared memory,
//   K-major (K's natural [key, d] rows), DP / 16 k-steps. d is padded to
//   DP, a multiple of 16: the padded 16-byte chunks of every tile are
//   zeroed once at the start and never written by a load, which reads
//   only chunks < D / 8, so the neighbouring head's or tensor's columns
//   of a fused-QKV slice (columns D.. of the row) are never read.
// * softmax in f32 on the accumulator in registers: running max from
//   -1e30 (the TPU kernels' floor; a fully masked first tile cannot give
//   exp2(-inf - -inf)), p = exp2(s * scale_log2 - m) as one FMA and one
//   ex2; the ragged last key tile (Nk = 231 for the 3 x 77 prompt) is
//   masked only on that tile, a block-uniform branch. Its rows past Nk
//   are zero-filled by the load (cp.async with source size 0), so v is 0
//   there and p is exactly 0.
// * p v: wgmma m64nDPk16 with A = p from registers (the score
//   accumulator packed to bf16 pairs is the A fragment: p never touches
//   shared memory) and B = V from shared memory, MN-major (the
//   descriptor's transpose bit).
// * Overlap: tile t's q k^T and tile t-1's p v are issued together;
//   the warpgroup waits for q k^T only and computes tile t's softmax while
//   p v runs on the tensor cores; the consumer warpgroups interleave on
//   the SM, so one's exponentials also overlap the others' products.
//   The producer runs up to STAGES tiles and QSLOTS - 1 units' Q ahead.
//   The consumers take turns, in a ring, to issue their products
//   (FlashAttention-3's ping-pong, one named barrier each), so one's
//   softmax runs while the others' products do, even where all wait on
//   the same tiles.
// * Epilogue: O / l to bf16 staged through the warpgroup's own Q rows of
//   shared memory, then written as 16-byte row chunks; the Q slot then
//   goes back to the producer (its "empty" mbarrier).
// * The MFR strip bias (MODE_MFR): softmax over keys of q k^T * scale +
//   weight * exp(-dist / sigma) on pairs of distinct tiles (`mutual`) or
//   from tile-0 queries to other tiles (`target`), inside a Chebyshev
//   radius; 0 elsewhere. Token i of the width-concatenated strip sits at
//   row i / w_strip, tile (i % w_strip) / w_tile, column i % w_tile. The
//   bias is added to s after q k^T and before the softmax, divided by
//   scale_log2, so the softmax's one FMA and its max stay as they are.
//   It is sparse (at the 512x768 strip's L0, 169 of 12288 keys of a
//   query), so the work goes only where it can be nonzero: a key tile
//   holding no key within the radius of the warpgroup's 64 query rows'
//   strip rows gets nothing (a warpgroup-uniform test on the tile index
//   against a range taken once a unit; at L0 ~20% of the tiles are in
//   band), nor does a warpgroup whose rows all lie outside tile 0 in
//   `target` mode. In band, where w_tile is a multiple of 8 (every 8-key
//   column block then lies in one strip row and tile, so its row and
//   tile tests are taken once a row) and the radius is at most 7, the
//   bias comes from a 16 x 16 f32 table in shared memory indexed by (dy +
//   radius, dx + radius), each clamped to 15 (zero entries past 2
//   radius), filled once a block with the plain version's f32 formula:
//   no sqrt or exp per pair. Any other strip or radius (after the host
//   clamps the radius to max(h, w_tile) - 1, which gives the same bias)
//   computes each pair's bias as the plain version does. No integer
//   division per score: a thread's key coordinates start from the tile's
//   first key (divided out once a tile in band) and step by its column
//   offsets, wrapping at w_tile and w_strip; the query rows' are divided
//   out once a unit.
// * The banded bias (MODE_BANDED): query i sits at (i / w, i % w) of
//   its frame, key j at the same split of j % (h * w); a pair gains
//   weight * exp(-dist / sigma) inside the |dy|, |dx| <= radius band (0
//   at weight 0) and base outside (-1000 by default, or -inf), added to
//   s before the softmax and divided by scale_log2 as the MFR bias is.
//   With a finite base every key counts, so no tile is skipped, as the
//   TPU kernel skips none. A key tile that lies in one frame and holds
//   no row within the radius of the warpgroup's 64 query rows' frame
//   rows adds base to every score (a warpgroup-uniform test of the
//   tile's first frame-local key against a key range taken once a unit;
//   of the 512 x 768 frame's two-frame check shapes' tiles 26% are in
//   band at L0, 51% at L1, 89% at L2). The other tiles, those
//   straddling a frame's end among them, work per pair: where w is a
//   multiple of 8 (each 8-key column block then lies in one frame row)
//   and the radius is at most 8 (the TPU kernel's default), from an 18
//   x 18 f32 table in shared memory indexed by (dy + radius, dx +
//   radius), each clamped to 17, whose entries past 2 radius (the
//   sentinel row and column among them) hold base; else from the
//   formula per pair, on the special-function unit (rsqrt, ex2) and
//   without a branch. The banded mode at DP <= 48 (128-key tiles) takes
//   160 / 32 registers, as a bias mode at DP = 160 does. The host
//   clamps the radius to max(h, w) - 1, which gives the same bias. A
//   key tile's first frame-local key steps on by BK a tile and wraps at
//   the frame's end; a thread's keys step from it by its column
//   offsets, wrapping at w and at h * w; the query rows' coordinates
//   are divided out once a unit. base = -inf gives -inf scores, never
//   NaN: the running max starts at -1e30, and no 0 * base or base -
//   base is formed (every row has its own position of frame 0 in band).
//
// Shared memory uses the no-swizzle core-matrix layout of sm90.cuh
// (tile_offset): one layout serves as the K-major operand (Q, K) and the
// MN-major one (V), and the 16-byte loads store without bank conflicts.

#include <math.h>

#include "sm90.cuh"

namespace {

struct Sm90Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // may be null
  int H, Nq, Nk, D;
  long long qsb, qsn, qsh;
  long long ksb, ksn, ksh;
  long long vsb, vsn, vsh;
  float scale_log2;  // softmax scale * log2(e): scores live in the log2 domain
  // the MFR strip bias (attention_sm90_kernel<DP, MODE_MFR> only): strip and
  // tile width in tokens, tiles a strip row, Chebyshev radius (clamped
  // to max(h, w_tile) - 1), tile rule (1: tile-0 queries to the other
  // tiles; 0: every pair of distinct tiles), weight * log2(e), 1 / sigma
  int w_strip, w_tile, n_tiles, radius, target_only;
  float bias_log2, inv_sigma;
  // the CFG key mask (attention_sm90_kernel<DP, MODE_KEYMASK> only): batch
  // rows < n_uncond attend to keys < n_own only
  int n_own, n_uncond;
  // the banded bias (attention_sm90_kernel<DP, MODE_BANDED> only; with
  // radius, bias_log2 and inv_sigma above): frame height and width in
  // tokens, the out-of-band bias * log2(e)
  int fh, fw;
  float base_log2;
};

// the kernel's modes: plain, with the per-row key bound of the CFG key
// mask, with the MFR strip bias, with the banded cross-frame bias
enum { MODE_PLAIN = 0, MODE_KEYMASK = 1, MODE_MFR = 2, MODE_BANDED = 4 };

constexpr int WG_THREADS = 128;         // a warpgroup
constexpr int PRODUCER = WG_THREADS;    // the producer warpgroup
constexpr float MAX_FLOOR = -1e30f;     // the running max's start

// sm90_probe.py times copies of this kernel built with parts of the work
// left out, the bits of SM90_SKIP (0, nothing left out, in the port)
#ifndef SM90_SKIP
#define SM90_SKIP 0
#endif

// consumer warpgroups of every instantiation (at DP = 160 on 32-key tiles)
constexpr int CONSUMERS = 3;
constexpr int SKIP_EXP = 1, SKIP_LOADS = 2, SKIP_PV = 4, SKIP_SOFTMAX = 8, SKIP_STORES = 16,
              SKIP_TURNS = 32, SKIP_BIAS = 64;
__host__ __device__ constexpr bool skip(int part) { return (SM90_SKIP & part) != 0; }

// the MFR bias table: BIAS_SIDE x BIAS_SIDE f32, indexed by (dy + radius,
// dx + radius) each clamped to BIAS_SIDE - 1; entries past 2 radius are 0
constexpr int BIAS_SIDE = 16, BIAS_MAX_R = (BIAS_SIDE - 2) / 2;
// the banded table: BAND_SIDE x BAND_SIDE f32, indexed the same way;
// entries past 2 radius hold base, the last row and column always. Two
// more floats follow it: BAND_SCALE, weight * log2(e) / scale_log2, and
// BAND_DECAY, log2(e) / sigma (the per-pair formula's factors)
constexpr int BAND_SIDE = 18, BAND_MAX_R = (BAND_SIDE - 2) / 2;
constexpr int BAND_BASE = BAND_SIDE * BAND_SIDE - 1, BAND_SCALE = BAND_BASE + 1,
              BAND_DECAY = BAND_BASE + 2;

// fill a side x side bias table, the block's threads together: entry (uy,
// ux) is scale * exp(-dist / sigma) at (dy, dx) = (uy, ux) - radius where
// uy, ux <= 2 radius (the plain versions' f32 formula), else `outside`
__device__ __forceinline__ void fill_band_table(float* tab, int side, int radius, float scale,
                                                float outside, float inv_sigma, int threads) {
  for (int i = threadIdx.x; i < side * side; i += threads) {
    const int uy = i / side, ux = i % side, dy = uy - radius, dx = ux - radius;
    tab[i] = uy <= 2 * radius && ux <= 2 * radius
                 ? scale * expf(-sqrtf(static_cast<float>(dy * dy + dx * dx)) * inv_sigma)
                 : outside;
  }
}

// the shape of an instantiation: DP the head dim padded to a multiple of
// 16, NC consumer warpgroups of 64 query rows each
template <int DP, int MODE, int NC>
struct Tiles {
  static constexpr int BQ = 64 * NC;  // query rows per work unit
  static constexpr int THREADS = NC * WG_THREADS + PRODUCER;
  // a thread's registers after the hand-over, within what the launch
  // gives the block: 65536 / THREADS a thread in steps of 8 (128 of 512
  // threads). Three consumers take 152 and leave the producer 56; at DP
  // = 160 a bias mode's band state beside o (80 a thread) spills at 152
  // (the MFR mode 8 bytes), and so does the banded mode's per-pair bias
  // beside 128-key score tiles (DP <= 48: 8 bytes at 48), so there they
  // take all but 32 (which cost the other modes' loads ~4% at DP = 160)
  static constexpr bool BIASED = MODE == MODE_MFR || MODE == MODE_BANDED;
  static constexpr bool WIDE_BIAS = BIASED && (DP > 128 || (MODE == MODE_BANDED && DP <= 48));
  static constexpr int PRODUCER_REGS = WIDE_BIAS ? 32 : 56;
  static constexpr int CONSUMER_REGS = WIDE_BIAS ? 160 : 152;
  static_assert(PRODUCER_REGS * PRODUCER + CONSUMER_REGS * NC * WG_THREADS <=
                    65536 / THREADS / 8 * 8 * THREADS,
                "registers");
  static constexpr int SCHED_BAR = 1 + NC;  // named barriers of the turns (1 .. NC: the epilogues)
  // keys per tile; three consumers' registers hold o beside 32-key
  // score tiles only, in a bias mode at DP = 128 and in any at DP = 160
  static constexpr int BK = DP <= 48 ? 128 : DP > 128 || (BIASED && DP > 112) ? 32 : 64;
  // K/V ring depth; Q slots (the units loaded ahead + 1)
  static constexpr int STAGES = 4;
  static constexpr int QSLOTS = 2;
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;   // one Q slot
  static constexpr uint32_t KV_BYTES = BK * DP * 2;  // one of K, V
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr uint32_t RING = QSLOTS * Q_BYTES;
  static constexpr uint32_t FULL = RING + STAGES * STAGE_BYTES;  // mbarriers
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES;
  static constexpr uint32_t QFULL = EMPTY + 8 * STAGES;
  static constexpr uint32_t QEMPTY = QFULL + 8 * QSLOTS;
  static constexpr uint32_t SMEM = QEMPTY + 8 * QSLOTS;
  static constexpr uint32_t MFR_SMEM = SMEM + BIAS_SIDE * BIAS_SIDE * 4;  // the bias table
  static constexpr uint32_t BAND_SMEM = SMEM + (BAND_DECAY + 1) * 4;
  static_assert(BAND_SMEM <= 232448, "shared memory of one block");
};

// work unit u of a block: bq query rows of one (batch, head)
struct Unit {
  int bh, q0;
  __device__ Unit(int u, int nqt, int bq) : bh(u / nqt), q0((u % nqt) * bq) {}
};

// the keys a unit attends to: all Nk, or in MODE_KEYMASK for the uncond
// batch rows (b < n_uncond) the first min(Nk, n_own); its key tiles are
// the first (keys + BK - 1) / BK, the last masked past `keys`
template <int MODE>
__device__ __forceinline__ int unit_keys(const Sm90Args& a, const Unit& un) {
  return MODE == MODE_KEYMASK && un.bh / a.H < a.n_uncond ? min(a.Nk, a.n_own) : a.Nk;
}

// zero 16-byte chunks [ch, DP / 8) of a tile of `rows` rows (contiguous
// in the chunk-major layout), the block's `threads` threads together
__device__ __forceinline__ void zero_pad(uint32_t tile, int rows, int ch, int dp8, int threads) {
  for (uint32_t off = ch * rows * 16 + threadIdx.x * 16; off < static_cast<uint32_t>(dp8 * rows * 16);
       off += threads * 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(tile + off), "r"(0) : "memory");
}

// the producer warpgroup: per work unit its Q into one of QSLOTS slots, then
// its K/V tiles through the ring; it runs ahead of the consumers by up to
// STAGES tiles and QSLOTS - 1 units' Q, so the next units' loads overlap this
// unit's math and epilogue
template <int DP, int MODE, int NC>
__device__ __forceinline__ void produce(const Sm90Args& a, int units, int nqt, uint32_t sm,
                                        int tid) {
  using T = Tiles<DP, MODE, NC>;
  constexpr int BK = T::BK, BQ = T::BQ, STAGES = T::STAGES, QSLOTS = T::QSLOTS;
  constexpr int NE = (BK * DP / 8 + PRODUCER - 1) / PRODUCER;  // copies per tile
  const int ch = a.D / 8, rq = 8 * ch;  // 16-byte chunks of a row, of a row group
  // a thread's copies of a K/V tile are elements e = tid + i * PRODUCER:
  // row group e / rq, w = e % rq, row 8 (e / rq) + w % 8, chunk w / 8, so
  // 8 neighbouring threads store the 8 rows of one core matrix (no bank
  // conflicts) and a warp reads 4 neighbouring chunks of each of 8 rows;
  // (e / rq, e % rq) step by (PRODUCER / rq, PRODUCER % rq) with a carry,
  // in a loop left rolled: unrolled, its addresses spill at 56 registers
  const int g0 = tid / rq, w0 = tid % rq, dg = PRODUCER / rq, dw = PRODUCER % rq;
  int tl = 0;  // tiles loaded so far
  // Each Q or K/V load is one cp.async group with its "full" barrier,
  // signalled once it has landed: wait for it, fence (cp.async writes
  // through the generic proxy, wgmma reads through the async one), then
  // arrive; the consumers' waits stay free of fences. Up to three groups
  // stay in flight (p0, p1: the older two, not yet signalled); before
  // blocking on a slot the consumers still hold, every group in flight is
  // signalled, so the consumers never wait on loads the producer sits on.
  uint32_t p0 = 0, p1 = 0;
  auto signal = [&](uint32_t bar) {
    cp_async_commit();
    if (p0) {
      cp_async_wait<2>();
      fence_proxy_async();  // copies before wgmma
      mbar_arrive(p0);
    }
    p0 = p1;
    p1 = bar;
  };
  auto acquire = [&](uint32_t bar, uint32_t parity) {
    if (mbar_test(bar, parity)) return;
    cp_async_wait<0>();
    fence_proxy_async();  // copies before wgmma
    if (p0) mbar_arrive(p0);
    if (p1) mbar_arrive(p1);
    p0 = p1 = 0;
    mbar_wait(bar, parity);
  };
  for (int li = 0, u = blockIdx.x; u < units; ++li, u += gridDim.x) {
    const Unit un(u, nqt, BQ);
    const int b = un.bh / a.H, h = un.bh % a.H, slot = li % QSLOTS;
    const int nk = unit_keys<MODE>(a, un), nt = (nk + BK - 1) / BK;
    const bf16* q = a.q + b * a.qsb + h * a.qsh;
    const bf16* k = a.k + b * a.ksb + h * a.ksh;
    const bf16* v = a.v + b * a.vsb + h * a.vsh;
    if (li >= QSLOTS) acquire(sm + T::QEMPTY + 8 * slot, ((li / QSLOTS) - 1) & 1);
    const uint32_t qs = sm + slot * T::Q_BYTES;
    for (int e = tid; e < BQ * ch; e += PRODUCER) {
      const int gq = e / (8 * ch), w = e - gq * 8 * ch;
      const int r = gq * 8 + (w & 7), c = w >> 3;
      const bool ok = un.q0 + r < a.Nq;
      cp_async16(qs + tile_offset(r, c, BQ), ok ? q + (un.q0 + r) * a.qsn + c * 8 : q, ok ? 16 : 0);
    }
    signal(sm + T::QFULL + 8 * slot);
    for (int t = 0; t < nt; ++t, ++tl) {
      const int s = tl % STAGES;
      if (tl >= STAGES) acquire(sm + T::EMPTY + 8 * s, ((tl / STAGES) - 1) & 1);
      const uint32_t ks = sm + T::RING + s * T::STAGE_BYTES, vs = ks + T::KV_BYTES;
      const int nvalid = nk - t * BK;
      const bf16* kt = k + static_cast<long long>(t) * BK * a.ksn;
      const bf16* vt = v + static_cast<long long>(t) * BK * a.vsn;
      int gq = g0, w = w0;
#pragma unroll 1
      for (int i = 0; i < NE; ++i) {
        if (gq < BK / 8 && !(skip(SKIP_LOADS) && t >= STAGES)) {
          const int r = gq * 8 + (w & 7), c = w >> 3;
          const bool ok = r < nvalid;
          const uint32_t off = tile_offset(r, c, BK);
          cp_async16(ks + off, ok ? kt + r * a.ksn + c * 8 : k, ok ? 16 : 0);
          cp_async16(vs + off, ok ? vt + r * a.vsn + c * 8 : v, ok ? 16 : 0);
        }
        gq += dg;
        w += dw;
        if (w >= rq) {
          w -= rq;
          ++gq;
        }
      }
      signal(sm + T::FULL + 8 * s);
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();  // copies before wgmma
  if (p0) mbar_arrive(p0);
  if (p1) mbar_arrive(p1);
}

// the online softmax of sm90.cuh, with the probe's parts left out
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int nvalid, float scale_log2,
                                             int tq, float& m0, float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  if (skip(SKIP_SOFTMAX)) {
    al0 = al1 = 1.f;
    return;
  }
  online_softmax<BK, !skip(SKIP_EXP)>(s, nvalid, scale_log2, tq, m0, m1, l0, l1, al0, al1);
}

// a token's place in a width-concatenated strip (row y, tile t, column x
// in the tile), moved along the strip without a division
struct StripPos {
  int y, t, x;
  __device__ __forceinline__ StripPos(int i, const Sm90Args& a) {
    y = i / a.w_strip;
    const int rem = i - y * a.w_strip;
    t = rem / a.w_tile;
    x = rem - t * a.w_tile;
  }
  // n tokens on; short steps against a tile run the loop once or not
  __device__ __forceinline__ void advance(int n, const Sm90Args& a) {
    x += n;
    while (x >= a.w_tile) {
      x -= a.w_tile;
      if (++t == a.n_tiles) {
        t = 0;
        ++y;
      }
    }
  }
};

// the MFR bias of one consumer thread on one work unit: its two query
// rows' strip coordinates (rows g and g + 8 of its warp) and the key
// tiles that hold keys within the radius of its warpgroup's strip rows
struct StripBias {
  uint32_t qy[2], qx[2];  // row, column + radius: dy + radius = qy - ky (unsigned, out of band wraps high)
  int qt[2];              // keys of this tile get no bias from the row
  int tlo, thi;           // key tiles [tlo, thi] may be in band (tlo > thi: none)

  // row: the thread's first query row; wg_row: its warpgroup's first
  template <int BK>
  __device__ __forceinline__ void init(const Sm90Args& a, int row, int wg_row) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const StripPos p(row + 8 * r, a);
      // target: a row outside tile 0 lies out of every band
      qy[r] = a.target_only && p.t != 0 ? 0x80000000u : static_cast<uint32_t>(p.y + a.radius);
      qx[r] = static_cast<uint32_t>(p.x + a.radius);
      qt[r] = a.target_only ? 0 : p.t;
    }
    const int last = min(wg_row + 63, a.Nq - 1), ylo = wg_row / a.w_strip, yhi = last / a.w_strip;
    // the keys of strip rows [ylo - radius, yhi + radius]; target: only a
    // warpgroup holding a tile-0 row (the start of a strip row, or its
    // first row's column under w_tile) gets any bias
    tlo = max(ylo - a.radius, 0) * a.w_strip / BK;
    thi = static_cast<int>(
        min(static_cast<long long>(yhi + a.radius + 1) * a.w_strip, static_cast<long long>(a.Nq)) - 1) / BK;
    if (wg_row >= a.Nq || (a.target_only && yhi == ylo && wg_row - ylo * a.w_strip >= a.w_tile))
      tlo = 1 << 30;
  }

  // add the bias of key tile `tile` to the scores s of the two rows (keys
  // past Nk get some, and the softmax masks them)
  template <int BK>
  __device__ __forceinline__ void apply(float (&s)[BK / 2], const Sm90Args& a, int tile, int tq,
                                        const float* tab) const {
    if (skip(SKIP_BIAS) || tile < tlo || tile > thi) return;
    StripPos key(tile * BK, a);
    if (a.radius <= BIAS_MAX_R && a.w_tile % 8 == 0) {
      // each 8-key column block lies in one strip row and tile: its row
      // and tile tests are taken once for a row; the table row 15 is 0
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t row =
              key.t == qt[r] ? BIAS_SIDE - 1u : min(qy[r] - key.y, BIAS_SIDE - 1u);
          const uint32_t ux = qx[r] - key.x - 2 * tq;  // + radius - the key's column
          s[4 * j + 2 * r] += tab[row * BIAS_SIDE + min(ux, BIAS_SIDE - 1u)];
          s[4 * j + 2 * r + 1] += tab[row * BIAS_SIDE + min(ux - 1, BIAS_SIDE - 1u)];
        }
        key.advance(8, a);
      }
      return;
    }
    // any strip, any radius: each pair's bias, a key at a time
    const uint32_t span = 2 * a.radius;
    const float scale = a.bias_log2 / a.scale_log2;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      StripPos p = key;  // key 8 j + 2 tq + c of the tile
      p.advance(2 * tq + c, a);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t uy = qy[r] - p.y, ux = qx[r] - p.x;
          if (p.t != qt[r] && uy <= span && ux <= span) {
            const int dy = static_cast<int>(uy) - a.radius, dx = static_cast<int>(ux) - a.radius;
            s[4 * j + 2 * r + c] +=
                scale * expf(-sqrtf(static_cast<float>(dy * dy + dx * dx)) * a.inv_sigma);
          }
        }
        p.advance(8, a);
      }
    }
  }
};

// a key's place in its frame (row y, column x of frame-local key j),
// moved along the keys without a division: it wraps at the frame width
// and at the frame's end, where the next frame's first key sits at (0, 0)
struct FramePos {
  int y, x;
  __device__ __forceinline__ FramePos(int j, const Sm90Args& a) {
    y = j / a.fw;
    x = j - y * a.fw;
  }
  // n keys on; steps shorter than a frame row run the loop once or not
  __device__ __forceinline__ void advance(int n, const Sm90Args& a) {
    x += n;
    while (x >= a.fw) {
      x -= a.fw;
      if (++y == a.fh) y = 0;
    }
  }
};

// the banded bias of one consumer thread on one work unit: its two query
// rows' frame coordinates (rows g and g + 8 of its warp), the frame-local
// keys whose rows lie within the radius of its warpgroup's frame rows, and
// the first frame-local key of the unit's next key tile (apply takes the
// tiles in order, so no tile divides its index)
struct BandBias {
  uint32_t qy[2], qx[2];  // row, column + radius: dy + radius = qy - ky (unsigned, out of band wraps high)
  int klo, khi;           // frame-local keys [klo, khi) may be in band
  int j0;                 // the next tile's first key, frame-local

  // row: the thread's first query row; wg_row: its warpgroup's first
  __device__ __forceinline__ void init(const Sm90Args& a, int row, int wg_row) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = (row + 8 * r) / a.fw;
      qy[r] = static_cast<uint32_t>(y + a.radius);
      qx[r] = static_cast<uint32_t>(row + 8 * r - y * a.fw + a.radius);
    }
    // the keys of frame rows [ylo - radius, yhi + radius] (a warpgroup
    // past Nq gets some range: its rows are never stored)
    const int ylo = wg_row / a.fw, yhi = min(wg_row + 63, a.Nq - 1) / a.fw;
    klo = max(ylo - a.radius, 0) * a.fw;
    khi = min(yhi + a.radius + 1, a.fh) * a.fw;
    j0 = 0;
  }

  // add the bias of the unit's next key tile to the scores s of the two
  // rows (keys past Nk get some, and the softmax masks them); tab is the
  // table, base and the formula's factors (in the scores' domain)
  template <int BK>
  __device__ __forceinline__ void apply(float (&s)[BK / 2], const Sm90Args& a, int tq,
                                        const float* tab) {
    const int k0 = j0, hw = a.Nq;  // Nq = h * w: one frame
    j0 += BK;
    if (j0 >= hw) j0 %= hw;
    if (skip(SKIP_BIAS)) return;
    if (k0 + BK <= hw && (k0 + BK <= klo || k0 >= khi)) {
      // in one frame, no row within the radius: base on every score
      const float base = tab[BAND_BASE];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += base;
      return;
    }
    FramePos key(k0, a);
    if (a.radius <= BAND_MAX_R && a.fw % 8 == 0) {
      // each 8-key column block lies in one frame row (w and h * w are
      // multiples of 8): its row is taken once for a row of the thread
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t row = min(qy[r] - key.y, BAND_SIDE - 1u);
          const uint32_t ux = qx[r] - key.x - 2 * tq;  // + radius - the key's column
          s[4 * j + 2 * r] += tab[row * BAND_SIDE + min(ux, BAND_SIDE - 1u)];
          s[4 * j + 2 * r + 1] += tab[row * BAND_SIDE + min(ux - 1, BAND_SIDE - 1u)];
        }
        key.advance(8, a);
      }
      return;
    }
    // any frame, any radius: each pair's bias, a key at a time, without a
    // branch and on the special-function unit (rsqrt, ex2): the IEEE sqrt,
    // exp and division call slow paths, and those calls and the branches
    // spilled the score tile; dist = d2 / sqrt(d2), 0 at d2 = 0
    const uint32_t span = 2 * a.radius;
    const float scale = tab[BAND_SCALE], decay = tab[BAND_DECAY], base = tab[BAND_BASE];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      FramePos p = key;  // key 8 j + 2 tq + c of the tile
      p.advance(2 * tq + c, a);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t uy = qy[r] - p.y, ux = qx[r] - p.x;
          const int dy = static_cast<int>(uy) - a.radius, dx = static_cast<int>(ux) - a.radius;
          const float d2 = static_cast<float>(dy * dy + dx * dx);
          const float v = scale * fast_exp2(-d2 * rsqrtf(fmaxf(d2, 1.f)) * decay);
          s[4 * j + 2 * r + c] += max(uy, ux) <= span ? v : base;
        }
        p.advance(8, a);
      }
    }
  }
};

// a consumer warpgroup on work unit `un` (its li-th; `last`: the block's
// last): query rows [q0 + 64 wg, q0 + 64 wg + 64) against its nk keys;
// the unit's tiles are the ring's T0 .. T0 + nt - 1 (the tiles of the
// block's earlier units come first); MFR, banded: tab is the bias table
template <int DP, int MODE, int NC>
__device__ __forceinline__ void consume(const Sm90Args& a, const Unit& un, int li, bool last,
                                        int T0, int nt, int nk, uint32_t sm, int wg, int tid,
                                        const float* tab) {
  using T = Tiles<DP, MODE, NC>;
  constexpr int BK = T::BK, BQ = T::BQ, STAGES = T::STAGES, QSLOTS = T::QSLOTS;
  constexpr int SCHED_BAR = T::SCHED_BAR;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int slot = li % QSLOTS;
  const uint32_t qs = sm + slot * T::Q_BYTES, qa = qs + tile_offset(64 * wg, 0, BQ);
  auto stage = [&](int t) { return sm + T::RING + ((T0 + t) % STAGES) * T::STAGE_BYTES; };
  auto qk = [&](float(&s)[BK / 2], uint32_t ks) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::ss(s, gmma_desc(qa + kk * 2 * BQ * 16, BQ * 16, 128),
                    gmma_desc(ks + kk * 2 * BK * 16, BK * 16, 128), kk > 0);
  };
  auto pv = [&](float(&o)[DP / 2], const uint32_t(&p)[BK / 16][4], uint32_t vs) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      if (!skip(SKIP_PV)) Wgmma<DP>::rs_bt(o, p[j], gmma_desc(vs + j * 256, 128, BK * 16));
  };
  auto wait_full = [&](int t) {
    mbar_wait(sm + T::FULL + 8 * ((T0 + t) % STAGES), ((T0 + t) / STAGES) & 1);
  };
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(sm + T::EMPTY + 8 * ((T0 + t) % STAGES));
  };
  // ping-pong: wait for this warpgroup's turn to issue, then hand the
  // turn to the next in the ring (the last consumer opens, at the
  // kernel's start, and skips its very last hand-over, so every arrival
  // meets a wait)
  auto turn = [&]() {
    if (!skip(SKIP_TURNS)) named_bar_sync(SCHED_BAR + wg, 2 * WG_THREADS);
  };
  auto pass = [&](bool final_batch) {
    if (!skip(SKIP_TURNS) && !(final_batch && last && wg == NC - 1))
      named_bar_arrive(SCHED_BAR + (wg + 1) % NC, 2 * WG_THREADS);
  };

  float s[BK / 2], o[DP / 2];
  uint32_t p[BK / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = MAX_FLOOR, m1 = MAX_FLOOR, l0 = 0.f, l1 = 0.f, al0, al1;
  // MFR, banded: the bias of each key tile, added to s before its softmax
  StripBias sb{};
  BandBias bb{};
  if constexpr (MODE == MODE_MFR) sb.init<BK>(a, un.q0 + 64 * wg + 16 * warp + g, un.q0 + 64 * wg);
  if constexpr (MODE == MODE_BANDED) bb.init(a, un.q0 + 64 * wg + 16 * warp + g, un.q0 + 64 * wg);
  auto add_bias = [&](int t) {
    if constexpr (MODE == MODE_MFR) sb.apply<BK>(s, a, t, tq, tab);
    if constexpr (MODE == MODE_BANDED) bb.apply<BK>(s, a, tq, tab);
  };

  mbar_wait(sm + T::QFULL + 8 * slot, (li / QSLOTS) & 1);
  wait_full(0);
  turn();
  wgmma_fence();
  qk(s, stage(0));
  wgmma_commit();
  pass(false);
  wgmma_wait<0>();
  fence_operands(s);
  add_bias(0);
  softmax_tile<BK>(s, min(BK, nk), a.scale_log2, tq, m0, m1, l0, l1, al0, al1);
  pack_p<BK>(p, s);
  for (int t = 1; t < nt; ++t) {
    wait_full(t);
    fence_operands(o);
    fence_operands(p);
    turn();
    wgmma_fence();
    qk(s, stage(t));
    wgmma_commit();
    pv(o, p, stage(t - 1) + T::KV_BYTES);
    wgmma_commit();
    pass(false);
    wgmma_wait<1>();  // q k^T of tile t done, p v of tile t - 1 running
    fence_operands(s);
    add_bias(t);
    softmax_tile<BK>(s, min(BK, nk - t * BK), a.scale_log2, tq, m0, m1, l0, l1, al0, al1);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(p);
    release(t - 1);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    pack_p<BK>(p, s);
  }
  fence_operands(o);
  fence_operands(p);
  turn();
  wgmma_fence();
  pv(o, p, stage(nt - 1) + T::KV_BYTES);
  wgmma_commit();
  pass(true);
  wgmma_wait<0>();
  fence_operands(o);
  release(nt - 1);

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const int r0 = 64 * wg + 16 * warp + g;  // unit-local rows r0, r0 + 8
  if (a.lse != nullptr && tq == 0) {
    float* lse = a.lse + static_cast<long long>(un.bh) * a.Nq + un.q0;
    if (un.q0 + r0 < a.Nq) lse[r0] = m0 + log2f(l0);
    if (un.q0 + r0 + 8 < a.Nq) lse[r0 + 8] = m1 + log2f(l1);
  }
  // stage O / l in bf16 over this warpgroup's own Q rows (its last q k^T
  // has completed; the padded chunks stay zero), then write 16-byte
  // chunks of whole rows and hand the Q slot back to the producer
  const int ch = a.D / 8, b = un.bh / a.H, h = un.bh % a.H;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (j >= ch) break;
    const uint32_t at = qs + tile_offset(r0, j, BQ) + 4 * tq;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 128),
                 "r"(pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1))
                 : "memory");
  }
  named_bar_sync(1 + wg, WG_THREADS);
  const int c = tid % ch, rstep = WG_THREADS / ch;  // a thread's chunk; rows a pass
  if (tid < rstep * ch && !skip(SKIP_STORES))
    for (int r = tid / ch; r < 64; r += rstep) {
      const int row = un.q0 + 64 * wg + r;
      if (row >= a.Nq) break;
      uint4 val;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(qs + tile_offset(64 * wg + r, c, BQ))
                   : "memory");
      *reinterpret_cast<uint4*>(a.o + ((static_cast<long long>(b) * a.Nq + row) * a.H + h) * a.D +
                                c * 8) = val;
    }
  __syncwarp();
  if (lane == 0) mbar_arrive(sm + T::QEMPTY + 8 * slot);
}

// persistent: block i takes work units i, i + gridDim.x, ... of the
// B * H * ceil(Nq / BQ) units (neighbouring blocks share a head's K/V in
// L2); MODE_MFR: with the strip bias; MODE_KEYMASK: the uncond batch rows'
// units walk min(Nk, n_own) keys, the others Nk; MODE_BANDED: with the
// banded bias
template <int DP, int MODE, int NC>
__global__ void __launch_bounds__(Tiles<DP, MODE, NC>::THREADS, 1)
    attention_sm90_kernel(Sm90Args a, int B) {
  using T = Tiles<DP, MODE, NC>;
  constexpr int BQ = T::BQ, STAGES = T::STAGES, QSLOTS = T::QSLOTS, THREADS = T::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int nqt = (a.Nq + BQ - 1) / BQ, units = B * a.H * nqt;

  // zero the padded chunks once (no load writes them), then the barriers
  const int ch = a.D / 8;
  for (int s = 0; s < QSLOTS; ++s) zero_pad(sm + s * T::Q_BYTES, BQ, ch, DP / 8, THREADS);
  for (int s = 0; s < STAGES; ++s) {
    zero_pad(sm + T::RING + s * T::STAGE_BYTES, T::BK, ch, DP / 8, THREADS);
    zero_pad(sm + T::RING + s * T::STAGE_BYTES + T::KV_BYTES, T::BK, ch, DP / 8, THREADS);
  }
  fence_proxy_async();
  // MFR: the bias table, weight * exp(-dist / sigma) times log2(e) /
  // scale_log2 (the scores' domain), 0 out of band; banded: the same, base
  // (in that domain) out of band, a radius past the table's filling it as
  // its widest (apply then reads only its last entry, base), and after it
  // the per-pair formula's factors
  float* tab = reinterpret_cast<float*>(smem + T::SMEM);
  if constexpr (MODE == MODE_MFR)
    fill_band_table(tab, BIAS_SIDE, a.radius, a.bias_log2 / a.scale_log2, 0.f, a.inv_sigma,
                    THREADS);
  if constexpr (MODE == MODE_BANDED) {
    fill_band_table(tab, BAND_SIDE, min(a.radius, BAND_MAX_R), a.bias_log2 / a.scale_log2,
                    a.base_log2 / a.scale_log2, a.inv_sigma, THREADS);
    if (threadIdx.x == 0) {
      tab[BAND_SCALE] = a.bias_log2 / a.scale_log2;
      tab[BAND_DECAY] = a.inv_sigma * 1.44269504f;  // log2(e) / sigma
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm + T::FULL + 8 * s, PRODUCER);  // one arrival a producer thread
      mbar_init(sm + T::EMPTY + 8 * s, 4 * NC);   // one release a consumer warp
    }
    for (int s = 0; s < QSLOTS; ++s) {
      mbar_init(sm + T::QFULL + 8 * s, PRODUCER);
      mbar_init(sm + T::QEMPTY + 8 * s, 4 * NC);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // one branch a role to the kernel's end, so ptxas can hold each to its
  // setmaxnreg count
  if (wg == NC) {  // the producer, after the consumers' warpgroups
    setmaxnreg_dec<T::PRODUCER_REGS>();
    produce<DP, MODE, NC>(a, units, nqt, sm, tid);
  } else {
    setmaxnreg_inc<T::CONSUMER_REGS>();
    if (!skip(SKIP_TURNS) && wg == NC - 1)
      named_bar_arrive(T::SCHED_BAR, 2 * WG_THREADS);  // consumer 0 first
    for (int li = 0, T0 = 0, u = blockIdx.x; u < units; ++li, u += gridDim.x) {
      const Unit un(u, nqt, BQ);
      const int nk = unit_keys<MODE>(a, un), nt = (nk + T::BK - 1) / T::BK;
      consume<DP, MODE, NC>(a, un, li, u + gridDim.x >= units, T0, nt, nk, sm, wg, tid, tab);
      T0 += nt;
    }
  }
}

template <int DP, int MODE>
cudaError_t launch_dp(const Sm90Args& a, int B, int device, cudaStream_t st) {
  constexpr int NC = CONSUMERS;
  using T = Tiles<DP, MODE, NC>;
  constexpr uint32_t smem =
      MODE == MODE_MFR ? T::MFR_SMEM : MODE == MODE_BANDED ? T::BAND_SMEM : T::SMEM;
  // the opt-in above 48 KB and the SM count, once per card
  static unsigned opted = 0;
  static int sms[32];
  if (device >= 32 || !(opted >> device & 1u)) {
    cudaError_t err =
        cudaFuncSetAttribute(reinterpret_cast<const void*>(attention_sm90_kernel<DP, MODE, NC>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device >= 32) return cudaErrorInvalidDevice;
    sms[device] = n;
    opted |= 1u << device;
  }
  const long long units = static_cast<long long>(B) * a.H * ((a.Nq + T::BQ - 1) / T::BQ);
  if (units >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(units < sms[device] ? units : sms[device]);
  attention_sm90_kernel<DP, MODE, NC><<<grid, T::THREADS, smem, st>>>(a, B);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Sm90Args& a, int B, int device, cudaStream_t st) {
  switch ((a.D + 15) / 16) {
    case 1: return launch_dp<16, MODE>(a, B, device, st);
    case 2: return launch_dp<32, MODE>(a, B, device, st);
    case 3: return launch_dp<48, MODE>(a, B, device, st);
    case 4: return launch_dp<64, MODE>(a, B, device, st);
    case 5: return launch_dp<80, MODE>(a, B, device, st);
    case 6: return launch_dp<96, MODE>(a, B, device, st);
    case 7: return launch_dp<112, MODE>(a, B, device, st);
    case 8: return launch_dp<128, MODE>(a, B, device, st);
    default:  // SD-1.5's third UNet level: the keymask, MFR and banded modes only
      if constexpr (MODE == MODE_PLAIN)
        return cudaErrorInvalidValue;  // attention_wide_sm90_kernel's heads
      else
        return launch_dp<160, MODE>(a, B, device, st);
  }
}

// the checks and arguments both launchers share
cudaError_t make_args(Sm90Args& a, const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Nq, int Nk, int D, long long qsb,
                      long long qsn, long long qsh, long long ksb, long long ksn, long long ksh,
                      long long vsb, long long vsn, long long vsh, float scale_log2) {
  if (D < 8 || D > 160 || D % 8 || B < 1 || H < 1 || Nq < 1 || Nk < 1)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if ((ptrs & 15) || ((qsb | qsn | qsh | ksb | ksn | ksh | vsb | vsn | vsh) & 7))
    return cudaErrorMisalignedAddress;
  a = {static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
       static_cast<bf16*>(o), lse, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
       scale_log2};
  return cudaSuccess;
}

}  // namespace

// Launch attention_sm90_kernel (bf16, D a multiple of 8 up to 128, 16-byte
// aligned bases, strides multiples of 8 elements); lse may be null. Used
// by sdaof_attention (csrc/attention.cu) and sdaof_attention_fwd_stats.
cudaError_t launch_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int B, int H, int Nq, int Nk, int D, long long qsb,
                                  long long qsn, long long qsh, long long ksb, long long ksn,
                                  long long ksh, long long vsb, long long vsn, long long vsh,
                                  float scale_log2, int device, cudaStream_t st) {
  Sm90Args a;
  const cudaError_t err = make_args(a, q, k, v, o, lse, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn,
                                    ksh, vsb, vsn, vsh, scale_log2);
  return err != cudaSuccess ? err : launch<MODE_PLAIN>(a, B, device, st);
}

// Launch the MFR strip self-attention, attention_sm90_kernel<DP, MODE_MFR,
// NC> (as launch_attention_sm90, with N = Nq = Nk = h * w_strip and
// w_strip = n_tiles * w_tile): scores of in-band pairs of distinct tiles
// (all, or from tile-0 queries with target_only) gain bias_log2 *
// exp(-dist * inv_sigma) in the log2 domain. Used by sdaof_attention_mfr
// (csrc/attention.cu).
cudaError_t launch_attention_sm90_mfr(const void* q, const void* k, const void* v, void* o, int B,
                                      int H, int N, int D, long long qsb, long long qsn,
                                      long long qsh, long long ksb, long long ksn, long long ksh,
                                      long long vsb, long long vsn, long long vsh,
                                      float scale_log2, int w_strip, int w_tile, int radius,
                                      int target_only, float bias_log2, float inv_sigma,
                                      int device, cudaStream_t st) {
  if (w_tile < 1 || w_strip < w_tile || w_strip % w_tile || N % w_strip || radius < 0)
    return cudaErrorInvalidValue;
  Sm90Args a;
  const cudaError_t err = make_args(a, q, k, v, o, nullptr, B, H, N, N, D, qsb, qsn, qsh, ksb,
                                    ksn, ksh, vsb, vsn, vsh, scale_log2);
  if (err != cudaSuccess) return err;
  a.w_strip = w_strip;
  a.w_tile = w_tile;
  a.n_tiles = w_strip / w_tile;
  // every pair has |dy| <= h - 1 and |dx| <= w_tile - 1, so a wider
  // radius gives the same bias as this one
  const int widest = (N / w_strip > w_tile ? N / w_strip : w_tile) - 1;
  a.radius = radius < widest ? radius : widest;
  a.target_only = target_only != 0;
  a.bias_log2 = bias_log2;
  a.inv_sigma = inv_sigma;
  return launch<MODE_MFR>(a, B, device, st);
}

// Launch the CFG K/V-injection attention, attention_sm90_kernel<DP,
// MODE_KEYMASK, NC> (as launch_attention_sm90, without lse): batch rows <
// n_uncond attend to keys < n_own only (n_own >= 1), the others to all
// Nk. Used by sdaof_attention_keymask (csrc/attention.cu).
cudaError_t launch_attention_sm90_keymask(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Nq, int Nk, int D, long long qsb,
                                          long long qsn, long long qsh, long long ksb,
                                          long long ksn, long long ksh, long long vsb,
                                          long long vsn, long long vsh, float scale_log2,
                                          int n_own, int n_uncond, int device, cudaStream_t st) {
  if (n_own < 1 || n_uncond < 0) return cudaErrorInvalidValue;
  Sm90Args a;
  const cudaError_t err = make_args(a, q, k, v, o, nullptr, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb,
                                    ksn, ksh, vsb, vsn, vsh, scale_log2);
  if (err != cudaSuccess) return err;
  a.n_own = n_own;
  a.n_uncond = n_uncond;
  return launch<MODE_KEYMASK>(a, B, device, st);
}

// Launch the banded multi-frame attention, attention_sm90_kernel<DP,
// MODE_BANDED, NC> (as launch_attention_sm90, without lse; Nq = fh * fw,
// Nk a whole number of frames): key j sits at frame-local position j %
// (fh * fw); in-band pairs (|dy|, |dx| <= radius) gain bias_log2 *
// exp(-dist * inv_sigma) (nothing when bias_log2 = 0), the others
// base_log2 (which may be -inf), in the log2 domain. Used by
// sdaof_attention_banded (csrc/attention.cu).
cudaError_t launch_attention_sm90_banded(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int Nq, int Nk, int D, long long qsb,
                                         long long qsn, long long qsh, long long ksb,
                                         long long ksn, long long ksh, long long vsb,
                                         long long vsn, long long vsh, float scale_log2, int fh,
                                         int fw, int radius, float bias_log2, float base_log2,
                                         float inv_sigma, int device, cudaStream_t st) {
  if (fh < 1 || fw < 1 || Nq != fh * fw || Nk % Nq || radius < 0) return cudaErrorInvalidValue;
  Sm90Args a;
  const cudaError_t err = make_args(a, q, k, v, o, nullptr, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb,
                                    ksn, ksh, vsb, vsn, vsh, scale_log2);
  if (err != cudaSuccess) return err;
  a.fh = fh;
  a.fw = fw;
  // every pair has |dy| <= fh - 1 and |dx| <= fw - 1, so a wider radius
  // gives the same bias as this one
  const int widest = (fh > fw ? fh : fw) - 1;
  a.radius = radius < widest ? radius : widest;
  a.bias_log2 = bias_log2;
  a.base_log2 = base_log2;
  a.inv_sigma = inv_sigma;
  return launch<MODE_BANDED>(a, B, device, st);
}

// Attention with statistics (bf16, D a multiple of 8 up to 128): out as
// sdaof_attention with wide = 0, and lse [B*H, Nq] f32, each query row's
// base-2 log-sum-exp of the scores scaled by scale_log2.
extern "C" int sdaof_attention_fwd_stats(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int B, int H, int Nq, int Nk, int D,
                                         long long qsb, long long qsn, long long qsh,
                                         long long ksb, long long ksn, long long ksh,
                                         long long vsb, long long vsn, long long vsh,
                                         float scale_log2, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_attention_sm90(q, k, v, o, lse, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                               vsb, vsn, vsh, scale_log2, device, static_cast<cudaStream_t>(stream));
}
