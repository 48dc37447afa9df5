// Wide-head flash-attention forward for Hopper (sm_90a): wgmma, the
// output columns split across two consumer warpgroups, and a TMA K/V ring
// shared by the CTAs of a cluster (multicast). Plain C++ interface
// (launch_attention_wide_sm90); sdaof_attention in csrc/attention.cu
// routes every d > 128 call here (ops/_cuda.py builds and loads both).
//
// attention_wide_sm90_kernel computes out = softmax(q k^T * scale) v for
// bf16 q [B, Nq, H, D] and k/v [B, Nk, H, D] (D a multiple of 8 from 136
// to 512; any strides along B, N, H that are multiples of 8 elements;
// unit stride along D), writing a contiguous [B, Nq, H, D] out, softmax
// in f32 with a tracked running max from -1e30. It replaces the Pallas
// TPU kernel _flash_kernel of sd_animation_optical_flow_tpu/ops/
// attention.py (flash_attention: the VAE mid-block attention, one head,
// d = 512, [B, 6144, 1, 512] at 512x768; also the UNet's 160-wide heads
// at >= 1536 tokens, its third level on a 1024x1536 frame).
//
// What bounds it on the H100: at the VAE shape the two products take
// 4 N^2 d = 77.3 GFLOP, 0.078 ms at the bf16 peak, against 0.0097 ms of
// exponentials and 0.0075 ms of device memory; but every block streams
// all of K and V, so the traffic from L2 (12.6 MB a block) is the wall
// first. The constraints that fix the design:
//
// * Registers cap the query rows. A 64-row output at d = 512 in f32 is
//   128 KB, half an SM's register file, and one warpgroup cannot hold it
//   (256 registers a thread). So a block holds BQ = 64 query rows of one
//   (b, h), and its NC = 2 consumer warpgroups each own half of d: the
//   output columns [c DP / 2, (c + 1) DP / 2), 64 x 256 f32 at d = 512,
//   128 registers a thread. 384 threads start at 168 registers; the
//   producer warpgroup drops to 40 (setmaxnreg) and the consumers take
//   232. 64-row blocks make 96 blocks at the VAE shape (B H = 1), 73% of
//   the 132 SMs; a key split would need a combine pass.
// * K/V traffic. 96 blocks reading 12.6 MB each move 1.2 GB from L2;
//   with 16-byte cp.async loads that took 0.69 ms, the loads alone. So a
//   cluster of CL neighbouring query tiles (4 at d > 256, 2 below) shares
//   every K/V tile: each CTA's producer copies 1 / CL of the tile's boxes
//   with TMA, multicast into every CTA of the cluster, and a slot is
//   reused only once every CTA's consumers have released it (their
//   release arrives on each CTA's "empty" barrier). Each cluster also
//   starts its key loop at its own tile, so the clusters do not read the
//   same lines at once.
// * Shared memory (227 KB). Q_c (32 KB at d = 512) stays resident. Each
//   key tile is split by d-half into slots K_c, V_c that fill and free
//   independently: consumer c reads only Q_c, K_c and V_c. BK = 32 keys a
//   tile at d > 256 (64 below) lets the ring hold STAGES >= 2 tiles: at
//   d = 512, 64 KB of Q, two stages of 4 x 16 KB slots and 2 x 8 KB of
//   score exchange, 208 KB.
// * Layout: every tile is a row of TMA boxes of 16 columns (32 bytes, one
//   k16 step) x its rows, 32-byte swizzled, so a box reads whole 32-byte
//   sectors and the wgmma descriptors take the same bytes as K-major Q
//   and K and MN-major V (sm90.cuh gmma_desc_sw32). Rows past Nq / Nk
//   and columns past D are zero-filled by the copy, which reads nothing
//   past D (the columns of a fused-QKV slice beyond it); boxes wholly
//   past D are zeroed once and never copied.
//
// Per key tile t, each consumer c:
// * q k^T over its d-half: wgmma m64nBKk16, A = Q_c and B = K_c from
//   shared memory, DP / 32 k-steps: the partial scores.
// * Exchange: it writes its 64 x BK f32 partial to shared memory, meets
//   the other consumer's warp of the same rows at a named barrier (64
//   threads; thread i of one holds the same score elements as thread i
//   of the other), and adds the other's partial. Both then hold the same
//   S (f32 addition commutes) and run the same tracked-max softmax in
//   registers, so a row's statistics do not depend on which consumer
//   computed them. A second named barrier per warp pair (arrive after the
//   read, wait before the next write) frees the partial's buffer.
// * p v: wgmma m64n(DP / 2)k16 with A = p from registers (the score
//   accumulator packed to bf16 pairs) and B = V_c from shared memory.
// * Overlap: tile t's q k^T and tile t-1's p v are issued together (V's
//   wait after q k^T's issue); the warpgroup waits for q k^T only, so the
//   exchange and tile t's softmax run while p v runs on the tensor cores.
// * Epilogue: O / l in bf16 staged over the consumer's own Q_c bytes, then
//   written as 16-byte chunks of whole rows.
//
// d pads to DP, a multiple of 32 so that each half is a whole number of
// boxes: DP = 160 (d 136..160, halves of 80), 256, 384 and 512.

#include "sm90.cuh"

namespace {

struct WideArgs {
  bf16* o;
  int H, Nq, Nk, D;
  // dims (1..3) of the tensor maps of q and of k / v that hold the token,
  // the head and the batch index, packed 2 bits each
  int qdims, kdims;
  float scale_log2;  // softmax scale * log2(e): scores live in the log2 domain
};

struct WideMaps {  // TMA tensor maps of q (64-row boxes), k and v (BK-row boxes)
  CUtensorMap q, k, v;
};

constexpr int NC = 2;                          // consumer warpgroups, one a d-half
constexpr int WG_THREADS = 128;                // a warpgroup
constexpr int THREADS = (NC + 1) * WG_THREADS;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // a thread, after the hand-over
static_assert(PRODUCER_REGS * WG_THREADS + CONSUMER_REGS * NC * WG_THREADS <= 65536, "registers");
constexpr int BQ = 64;                         // query rows of a block
constexpr int BOX = 16;                        // columns of a TMA box: 32 bytes, one k16 step
constexpr float MAX_FLOOR = -1e30f;            // the running max's start
// named barriers (0 is __syncthreads): per consumer warp w the exchange
// (XCH_BAR + w) and, per consumer c, "the other has read c's partial"
// (READ_BAR + 4 c + w); the epilogue of consumer c (EPI_BAR + c)
constexpr int XCH_BAR = 1, READ_BAR = 5, EPI_BAR = 13;
constexpr int PAIR = 64;                       // threads of a warp pair
constexpr uint32_t SMEM_MAX = 232448;          // shared memory of one block

// sm90_probe.py --kernel wide times copies of this kernel built with parts
// of the work left out, the bits of WIDE_SKIP (0, nothing left out, in
// the port), or with clusters of WIDE_CLUSTER CTAs (0: the sizes below)
#ifndef WIDE_SKIP
#define WIDE_SKIP 0
#endif
#ifndef WIDE_CLUSTER
#define WIDE_CLUSTER 0
#endif
constexpr int SKIP_LOADS = 1, SKIP_QK = 2, SKIP_PV = 4, SKIP_XCH = 8, SKIP_SOFTMAX = 16,
              SKIP_EXP = 32;
__host__ __device__ constexpr bool skip(int part) { return (WIDE_SKIP & part) != 0; }

template <int DP>  // head dim padded to a multiple of 32
struct WideTiles {
  static constexpr int HD = DP / 2;                      // a consumer's half of d
  static constexpr int BK = DP > 256 ? 32 : 64;          // keys of a tile: two stages fit
  // CTAs of a cluster, each K/V tile loaded once for all of them: 4 where
  // K/V traffic bounds the kernel (d > 256); 2 at d = 160, where
  // clusters of 4 fill the SMs worse than they save (sm90_probe.py's
  // cluster variants set WIDE_CLUSTER)
  static constexpr int CL = WIDE_CLUSTER ? WIDE_CLUSTER : DP > 256 ? 4 : 2;
  static constexpr uint32_t QH = BQ * HD * 2;            // Q_c
  static constexpr uint32_t SLOT = BK * HD * 2;          // K_c or V_c of one key tile
  static constexpr uint32_t XCH_BYTES = BQ * BK * 4;     // one consumer's partial scores
  static constexpr uint32_t STAGE = 2 * NC * (SLOT + 16);  // slots and their full / empty
  static constexpr int STAGES = static_cast<int>(
      (SMEM_MAX - NC * QH - NC * XCH_BYTES - 8 * NC) / STAGE);  // ring depth, in key tiles
  static constexpr uint32_t RING = NC * QH;              // slot (s, kind, c), kind 0 K, 1 V
  static constexpr uint32_t XCH = RING + STAGES * 2 * NC * SLOT;
  static constexpr uint32_t FULL = XCH + NC * XCH_BYTES;  // mbarriers, one a slot
  static constexpr uint32_t EMPTY = FULL + 8 * STAGES * 2 * NC;
  static constexpr uint32_t QFULL = EMPTY + 8 * STAGES * 2 * NC;  // one a Q half
  static constexpr uint32_t SMEM = QFULL + 8 * NC;
  static_assert(HD % BOX == 0 && HD <= 256, "a half is a multiple of 16, at most 256");
  static_assert(QH % 256 == 0 && SLOT % 256 == 0, "tiles on the swizzle's 256-byte period");
  static_assert(STAGES >= 2 && SMEM <= SMEM_MAX, "shared memory of one block");
  // index of slot (stage s, kind, consumer c): its bytes at RING + i SLOT,
  // its barriers at FULL / EMPTY + 8 i
  __device__ static int slot(int s, int kind, int c) { return (2 * s + kind) * NC + c; }
};

// boxes of half c that hold data (>= 1 for 128 < D <= DP): box j holds
// columns [c DP / 2 + 16 j, + 16), zero-filled past D by the copy
template <int DP>
__device__ __forceinline__ int half_boxes(int D, int c) {
  return min(DP / 2 / BOX, (D - c * (DP / 2) + BOX - 1) / BOX);
}

// the key tile a cluster of cl CTAs takes t-th: each cluster starts at
// its own tile, so the clusters do not all read the same K/V lines at once
__device__ __forceinline__ int key_tile(int t, int nt, int cl) {
  return (t + static_cast<int>(blockIdx.x) / cl * 7) % nt;
}

// the coordinates (dims 1..3) of token n, head h, batch row b in a tensor
// map whose dims `dims` encodes
__device__ __forceinline__ void box_coords(int dims, int n, int h, int b, int& x1, int& x2,
                                           int& x3) {
  const int dn = dims & 3, dh = (dims >> 2) & 3;
  x1 = dn == 1 ? n : dh == 1 ? h : b;
  x2 = dn == 2 ? n : dh == 2 ? h : b;
  x3 = dn == 3 ? n : dh == 3 ? h : b;
}

// the producer warpgroup's warp c (< NC), one thread: Q_c once, then K_c
// and V_c of every key tile through the ring, this CTA's share of each
// tile's boxes multicast to every CTA of the cluster
template <int DP>
__device__ __forceinline__ void produce(const WideMaps& maps, const WideArgs& a, int b, int h,
                                        int q0, int nt, uint32_t sm, int c) {
  using T = WideTiles<DP>;
  constexpr int BK = T::BK;
  const int nb = half_boxes<DP>(a.D, c), col = c * T::HD;
  const int rank = static_cast<int>(cluster_rank());
  int x1, x2, x3;
  box_coords(a.qdims, q0, h, b, x1, x2, x3);
  const uint32_t qfull = sm + T::QFULL + 8 * c;
  mbar_arrive_expect_tx(qfull, nb * BQ * BOX * 2);
  for (int j = 0; j < nb; ++j)
    tma_load_4d(sm + c * T::QH + j * BQ * BOX * 2, &maps.q, qfull, col + BOX * j, x1, x2, x3);
  for (int t = 0; t < nt; ++t) {
    const int s = t % T::STAGES;
    const uint32_t parity = ((t / T::STAGES) - 1) & 1;
    box_coords(a.kdims, key_tile(t, nt, T::CL) * BK, h, b, x1, x2, x3);
    const bool copy = !(skip(SKIP_LOADS) && t >= T::STAGES);  // the probe: the first ring only
#pragma unroll
    for (int kind = 0; kind < 2; ++kind) {
      const int i = T::slot(s, kind, c);
      const uint32_t full = sm + T::FULL + 8 * i, dst = sm + T::RING + i * T::SLOT;
      // every CTA's consumers have released the slot (this CTA's copies
      // land in all of them)
      if (t >= T::STAGES) mbar_wait(sm + T::EMPTY + 8 * i, parity);
      mbar_arrive_expect_tx(full, copy ? nb * BK * BOX * 2 : 0);
      if (copy)
        for (int j = rank; j < nb; j += T::CL)
          tma_load_4d_multicast(dst + j * BK * BOX * 2, kind ? &maps.v : &maps.k, full,
                                col + BOX * j, x1, x2, x3, (1 << T::CL) - 1);
    }
  }
}

// consumer warpgroup c: query rows [q0, q0 + 64), output columns of half c
template <int DP>
__device__ __forceinline__ void consume(const WideArgs& a, int b, int h, int q0, int nt,
                                        uint32_t sm, int c, int tid) {
  using T = WideTiles<DP>;
  constexpr int HD = T::HD, BK = T::BK;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const uint32_t qs = sm + c * T::QH;
  // this thread's float4 slots of the partial scores, its own and the
  // other consumer's same thread's
  const uint32_t mine = sm + T::XCH + c * T::XCH_BYTES + 16 * tid;
  const uint32_t theirs = sm + T::XCH + (1 - c) * T::XCH_BYTES + 16 * tid;
  // tile t's slot of kind 0 (K) or 1 (V), and the phase parity of its use
  auto slot = [&](int t, int kind) { return T::slot(t % T::STAGES, kind, c); };
  auto parity = [&](int t) { return static_cast<uint32_t>((t / T::STAGES) & 1); };

  // q k^T: Q_c and K_c are K-major, one 32-byte-swizzled box a k16 step
  auto qk = [&](float(&s)[BK / 2], int t) {
    const uint32_t ks = sm + T::RING + slot(t, 0) * T::SLOT;
#pragma unroll
    for (int kk = 0; kk < HD / BOX; ++kk)
      if (!skip(SKIP_QK))
        Wgmma<BK>::ss(s, gmma_desc_sw32(qs + kk * BQ * BOX * 2, 16, 256),
                      gmma_desc_sw32(ks + kk * BK * BOX * 2, 16, 256), kk > 0);
  };
  // p v: V_c is MN-major, its 16-column boxes BK * 32 bytes apart
  auto pv = [&](float(&o)[HD / 2], const uint32_t(&p)[BK / 16][4], int t) {
    const uint32_t vs = sm + T::RING + slot(t, 1) * T::SLOT;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      if (!skip(SKIP_PV)) Wgmma<HD>::rs_bt(o, p[j], gmma_desc_sw32(vs + j * 512, BK * BOX * 2, 256));
  };
  auto wait_full = [&](int t, int kind) { mbar_wait(sm + T::FULL + 8 * slot(t, kind), parity(t)); };
  // the slot is free once every CTA of the cluster has read it
  auto release = [&](int t, int kind) {
    if (lane < T::CL) mbar_arrive_cluster(sm + T::EMPTY + 8 * slot(t, kind), lane);
  };
  // partial scores of tile t -> the full scores, in both consumers
  auto exchange = [&](float(&s)[BK / 2], int t) {
    if (skip(SKIP_XCH)) return;
    if (t > 0) named_bar_sync(READ_BAR + 4 * c + warp, PAIR);  // the other read tile t-1's
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(mine + i * WG_THREADS * 16),
                   "f"(s[4 * i]), "f"(s[4 * i + 1]), "f"(s[4 * i + 2]), "f"(s[4 * i + 3])
                   : "memory");
    named_bar_sync(XCH_BAR + warp, PAIR);
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      float x0, x1, x2, x3;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3)
                   : "r"(theirs + i * WG_THREADS * 16)
                   : "memory");
      s[4 * i] += x0;
      s[4 * i + 1] += x1;
      s[4 * i + 2] += x2;
      s[4 * i + 3] += x3;
    }
    if (t + 1 < nt) named_bar_arrive(READ_BAR + 4 * (1 - c) + warp, PAIR);
  };

  float s[BK / 2], o[HD / 2];
  uint32_t p[BK / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;  // the probe's copies without q k^T read it
  float m0 = MAX_FLOOR, m1 = MAX_FLOOR, l0 = 0.f, l1 = 0.f, al0, al1;
  // the online softmax of sm90.cuh over key tile key_tile(t), with the
  // probe's parts left out
  auto softmax = [&](int t) {
    if (skip(SKIP_SOFTMAX)) {
      al0 = al1 = 1.f;
      return;
    }
    online_softmax<BK, !skip(SKIP_EXP)>(s, min(BK, a.Nk - key_tile(t, nt, T::CL) * BK), a.scale_log2,
                                        tq, m0, m1, l0, l1, al0, al1);
  };

  mbar_wait(sm + T::QFULL + 8 * c, 0);
  wait_full(0, 0);
  wgmma_fence();
  qk(s, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
  release(0, 0);
  exchange(s, 0);
  softmax(0);
  pack_p<BK>(p, s);
  for (int t = 1; t < nt; ++t) {
    wait_full(t, 0);
    fence_operands(o);
    fence_operands(p);
    wgmma_fence();
    qk(s, t);
    wgmma_commit();
    wait_full(t - 1, 1);  // V of tile t - 1 may land while q k^T runs
    pv(o, p, t - 1);
    wgmma_commit();
    wgmma_wait<1>();  // q k^T of tile t done, p v of tile t - 1 running
    fence_operands(s);
    release(t, 0);
    exchange(s, t);
    softmax(t);
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(p);
    release(t - 1, 1);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }
    pack_p<BK>(p, s);
  }
  wait_full(nt - 1, 1);
  fence_operands(o);
  fence_operands(p);
  wgmma_fence();
  pv(o, p, nt - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  // stage O / l in bf16 over this consumer's own Q_c bytes, in the
  // no-swizzle core-matrix layout of sm90.cuh (its last q k^T has
  // completed, and no one else reads them), then write 16-byte chunks of
  // whole rows: 8 neighbouring threads on the 8 rows of a core matrix
  const int ch = min(HD / 8, a.D / 8 - c * (HD / 8)), r0 = 16 * warp + g;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (j >= ch) break;
    const uint32_t at = qs + tile_offset(r0, j, BQ) + 4 * tq;
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0))
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + 128),
                 "r"(pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1))
                 : "memory");
  }
  named_bar_sync(EPI_BAR + c, WG_THREADS);
  const int rq = 8 * ch;
  bf16* out = a.o + (static_cast<long long>(b) * a.Nq * a.H + h) * a.D + c * HD;
  for (int e = tid; e < BQ * ch; e += WG_THREADS) {
    const int gq = e / rq, w = e - gq * rq, r = gq * 8 + (w & 7), j = w >> 3;
    if (q0 + r >= a.Nq) continue;
    uint4 val;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(qs + tile_offset(r, j, BQ))
                 : "memory");
    *reinterpret_cast<uint4*>(out + static_cast<long long>(q0 + r) * a.H * a.D + j * 8) = val;
  }
}

// one block per (64 query rows, b * H + h), blockIdx.x the query tile;
// clusters of CL neighbouring query tiles of one head share K/V
template <int DP>
__global__ void __launch_bounds__(THREADS, 1) attention_wide_sm90_kernel(const __grid_constant__ WideMaps maps, const WideArgs a) {
  using T = WideTiles<DP>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int q0 = blockIdx.x * BQ, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int nt = (a.Nk + T::BK - 1) / T::BK;

  // zero the boxes that no copy writes (columns past D of the padded
  // halves) once, in Q_c and in every K_c / V_c slot
  for (int c = 0; c < NC; ++c) {
    const int nb = half_boxes<DP>(a.D, c);
    for (uint32_t off = nb * BQ * BOX * 2 + threadIdx.x * 16; off < T::QH; off += THREADS * 16)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(sm + c * T::QH + off), "r"(0)
                   : "memory");
    for (int s = 0; s < 2 * T::STAGES; ++s)
      for (uint32_t off = nb * T::BK * BOX * 2 + threadIdx.x * 16; off < T::SLOT;
           off += THREADS * 16)
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                         sm + T::RING + (s * NC + c) * T::SLOT + off),
                     "r"(0)
                     : "memory");
  }
  fence_proxy_async();  // the zeros before wgmma's reads
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES * 2 * NC; ++i) {
      mbar_init(sm + T::FULL + 8 * i, 1);        // the producer's arrival (+ the bytes)
      mbar_init(sm + T::EMPTY + 8 * i, 4 * T::CL);  // a release a consumer warp of each CTA
    }
    for (int c = 0; c < NC; ++c) mbar_init(sm + T::QFULL + 8 * c, 1);
    mbar_init_fence();
  }
  cluster_sync();  // every CTA's barriers ready before any copy or release reaches them

  // one branch a role, so ptxas can hold each to its setmaxnreg count
  if (wg == NC) {  // the producer, after the consumers' warpgroups
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid % 32 == 0 && tid / 32 < NC) produce<DP>(maps, a, b, h, q0, nt, sm, tid / 32);
    __syncwarp();
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<DP>(a, b, h, q0, nt, sm, wg, tid);
  }
  cluster_sync();  // no CTA exits while another's copies or releases may reach it
}

// a 4-d map of bf16 [B, N, H, D] (strides sb, sn, sh in elements, unit
// stride along D): dim 0 the columns, then N, H, B in order of stride
// (size-1 dims last), boxes of 16 columns x `rows` tokens, 32-byte
// swizzle, zero fill out of bounds; *dims gets where N, H, B went
cudaError_t encode_map(CUtensorMap* map, int* dims, const void* ptr, int B, int N, int H, int D,
                       long long sb, long long sn, long long sh, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Dim {
    int size;
    long long stride;
    int which;  // 0 N, 1 H, 2 B
  } d[3] = {{N, sn, 0}, {H, sh, 1}, {B, sb, 2}};
  auto before = [](const Dim& x, const Dim& y) {
    return (x.size == 1) != (y.size == 1) ? y.size == 1 : x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  cuuint64_t size[4] = {static_cast<cuuint64_t>(D), 0, 0, 0}, stride[3];
  cuuint32_t box[4] = {BOX, 1, 1, 1}, elem[4] = {1, 1, 1, 1};
  long long prev = 1, prev_size = D;  // in elements
  *dims = 0;
  for (int i = 0; i < 3; ++i) {
    // a size-1 dim is never stepped: give it the stride that keeps the
    // map's strides rising
    const long long st = d[i].size == 1 ? prev * prev_size : d[i].stride;
    size[i + 1] = static_cast<cuuint64_t>(d[i].size);
    stride[i] = static_cast<cuuint64_t>(st) * 2;
    if (d[i].which == 0) box[i + 1] = rows;
    *dims |= (i + 1) << (2 * d[i].which);
    prev = st;
    prev_size = d[i].size;
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), size,
                            stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, WideArgs a, int B,
                      long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                      long long ksh, long long vsb, long long vsn, long long vsh, int device,
                      cudaStream_t st) {
  using T = WideTiles<DP>;
  static unsigned opted = 0;  // the opt-in above 48 KB, once per card
  if (device >= 32) return cudaErrorInvalidDevice;
  if (!(opted >> device & 1u)) {
    const cudaError_t err =
        cudaFuncSetAttribute(reinterpret_cast<const void*>(attention_wide_sm90_kernel<DP>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    opted |= 1u << device;
  }
  WideMaps maps;
  int vdims = 0;
  cudaError_t err = encode_map(&maps.q, &a.qdims, q, B, a.Nq, a.H, a.D, qsb, qsn, qsh, BQ);
  if (err == cudaSuccess)
    err = encode_map(&maps.k, &a.kdims, k, B, a.Nk, a.H, a.D, ksb, ksn, ksh, T::BK);
  if (err == cudaSuccess)
    err = encode_map(&maps.v, &vdims, v, B, a.Nk, a.H, a.D, vsb, vsn, vsh, T::BK);
  if (err != cudaSuccess) return err;
  if (vdims != a.kdims) return cudaErrorInvalidValue;  // k and v share the box coordinates
  const int nqt = (a.Nq + BQ - 1) / BQ;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nqt + T::CL - 1) / T::CL * T::CL, B * a.H);  // whole clusters
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = T::CL;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, attention_wide_sm90_kernel<DP>, maps, a);
}

}  // namespace

// Launch attention_wide_sm90_kernel (bf16, D a multiple of 8 from 136 to
// 512, 16-byte aligned bases, strides multiples of 8 elements). Used by
// sdaof_attention (csrc/attention.cu) for every D > 128.
cudaError_t launch_attention_wide_sm90(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Nq, int Nk, int D, long long qsb,
                                       long long qsn, long long qsh, long long ksb, long long ksn,
                                       long long ksh, long long vsb, long long vsn, long long vsh,
                                       float scale_log2, int device, cudaStream_t st) {
  if (D <= 128 || D > 512 || D % 8 || B < 1 || H < 1 || Nq < 1 || Nk < 1 ||
      static_cast<long long>(B) * H > 65535)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if ((ptrs & 15) || ((qsb | qsn | qsh | ksb | ksn | ksh | vsb | vsn | vsh) & 7))
    return cudaErrorMisalignedAddress;
  const WideArgs a = {static_cast<bf16*>(o), H, Nq, Nk, D, 0, 0, scale_log2};
  const auto go = [&](auto launch) {
    return launch(q, k, v, a, B, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, device, st);
  };
  if (D <= 160) return go(launch_dp<160>);
  if (D <= 256) return go(launch_dp<256>);
  if (D <= 384) return go(launch_dp<384>);
  return go(launch_dp<512>);
}
