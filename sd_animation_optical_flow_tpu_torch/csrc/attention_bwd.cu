// Flash-attention backward kernels for Hopper (sm_90a), plain C interface
// for ctypes (ops/_cuda.py builds and loads this file).
//
// The backward of out = softmax(s) v with s = scale * q k^T, for bf16 q
// [B, Nq, H, D], k/v [B, Nk, H, D] (D a multiple of 8 up to 128; any
// strides along B, N, H that are multiples of 8; unit stride along D),
// the cotangent dO (shaped as q), and two f32 [B*H, Nq] rows from the
// forward side: lse (base-2 log-sum-exp of the scores in the log2 domain,
// written by attn_mma_kernel<DP, MODE_STATS>) and D = rowsum(dO * O).
// Scores are recomputed, never stored: P = exp2(scale_log2 * q.k - lse),
// dP = dO v^T, dS = P * (dP - D); then dV = P^T dO, dK = scale * dS^T q,
// dQ = scale * dS k. Gradients come back contiguous [B, N, H, D] in bf16.
//
// Replaces two Pallas TPU kernels of sd_animation_optical_flow_tpu/ops/
// attention.py (launched by _flash_bwd, the custom VJP of
// flash_attention_diff), keeping their split, so no block writes another's
// rows: no atomics, and dQ is deterministic.
//
//   _flash_bwd_dkv_kernel -> attn_bwd_dkv_kernel: a block per (b*h, 64
//     keys), a warp per 16 keys. The warp holds its K and V rows as mma A
//     fragments for the whole loop over 64-query tiles of q and dO
//     (through shared memory). Per 16 queries it computes S^T = K q^T and
//     dP^T = V dO^T (mma.sync m16n8k16, bf16 in, f32 out), P^T and dS^T in
//     registers, and reuses those accumulator fragments, rounded to bf16,
//     as the A operands of dV += P^T dO and dK += dS^T q (f32
//     accumulators in registers). Padded query rows get lse = +inf, so
//     their P is exactly 0.
//   _flash_bwd_dq_kernel -> attn_bwd_dq_kernel: a block per (b*h, 64
//     queries), a warp per 16 queries holding its q and dO rows as A
//     fragments; loops over 64-key tiles of k and v, computes S and dP,
//     dS (keys past Nk masked to P = 0: zero-padded keys would give
//     exp2(-lse) there), and dQ += dS k.
//
// The TPU kernels keep P and dS in f32 for the gradient products; here
// they are rounded to bf16 as mma operands (f32 accumulation), about three
// significant digits per term, random in sign, so the sums over thousands
// of rows keep the relative error of one rounding.
//
// What bounds them on this card: 8 (dK/dV) and 6 (dQ) * B*H*Nq*Nk*D
// operations on ~O(N*D) bytes, so the tensor cores. Like the forward,
// these use mma.sync without pipelined tile loads (no cp.async / TMA, no
// wgmma) and sit well above that bound; wgmma + TMA is the next step.

#include <math.h>

#include "mma.cuh"

namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* dvec;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Nq, Nk;
  long long qsb, qsn, qsh;
  long long ksb, ksn, ksh;
  long long vsb, vsn, vsh;
  long long osb, osn, osh;  // dO
  float scale_log2;         // softmax scale * log2(e)
};

constexpr int BW_WARPS = 4;
constexpr int BW_ROWS = 16 * BW_WARPS;  // rows of the block's own axis
constexpr int BW_TILE = 64;             // rows of the streamed axis per tile
constexpr float LN2 = 0.69314718055994531f;
static_assert(BW_ROWS == BW_TILE, "the own rows are staged in the tile buffers");

__device__ __forceinline__ void zero(float (&c)[4]) { c[0] = c[1] = c[2] = c[3] = 0.f; }

// bf16 A fragment of a 16 x 16 block from two 16 x 8 accumulator tiles
// (the columns become the contraction index)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows [row0, row0 + 16) of this warp, 8-wide column tiles, scaled, into
// a contiguous [B, N, H, D] bf16 output
template <int DN>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DN][4], float scale,
                                           int b, int h, int H, int N, int D, int row0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = n * 8 + 2 * t + c;
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row < N)
          out[((static_cast<long long>(b) * N + row) * H + h) * D + d] =
              __float2bfloat16(acc[n][2 * r + c] * scale);
      }
    }
}

// ---------------------------------------------------------------------------
// attn_bwd_dkv_kernel (kernel #8)
// ---------------------------------------------------------------------------

template <int DP>  // DP: head dim padded to a multiple of 16
__global__ void __launch_bounds__(32 * BW_WARPS) attn_bwd_dkv_kernel(BwdArgs a, int D) {
  constexpr int LD = DP + 8;  // tile row stride: conflict-free ldmatrix
  constexpr int KS = DP / 16;
  constexpr int DN = DP / 8;
  __shared__ __align__(16) bf16 xs[BW_TILE * LD];  // K, then q tiles
  __shared__ __align__(16) bf16 ys[BW_TILE * LD];  // V, then dO tiles
  __shared__ float lse_s[BW_TILE], d_s[BW_TILE];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int k0 = blockIdx.x * BW_ROWS, r0 = warp * 16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.osb + h * a.osh;
  const float* lse = a.lse + static_cast<long long>(blockIdx.y) * a.Nq;
  const float* dvec = a.dvec + static_cast<long long>(blockIdx.y) * a.Nq;

  load_rows(xs, LD, k + k0 * a.ksn, a.ksn, BW_ROWS, a.Nk - k0, D, DP);
  load_rows(ys, LD, v + k0 * a.vsn, a.vsn, BW_ROWS, a.Nk - k0, D, DP);
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    ldsm_a(ka[s], xs, LD, r0, s * 16, lane);
    ldsm_a(va[s], ys, LD, r0, s * 16, lane);
  }

  float dk[DN][4], dv[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    zero(dk[n]);
    zero(dv[n]);
  }

  for (int q0 = 0; q0 < a.Nq; q0 += BW_TILE) {
    const int nvalid = min(BW_TILE, a.Nq - q0);
    __syncthreads();  // fragments taken / previous tile consumed
    load_rows(xs, LD, q + q0 * a.qsn, a.qsn, BW_TILE, nvalid, D, DP);
    load_rows(ys, LD, dout + q0 * a.osn, a.osn, BW_TILE, nvalid, D, DP);
    if (threadIdx.x < BW_TILE) {
      const int i = threadIdx.x;
      lse_s[i] = i < nvalid ? lse[q0 + i] : INFINITY;  // P = exp2(-inf) = 0
      d_s[i] = i < nvalid ? dvec[q0 + i] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < BW_TILE / 16; ++j) {  // 16 queries at a time
      if (j * 16 >= nvalid) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        zero(s[n]);
        zero(dp[n]);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qb[2], ob[2];
          ldsm_b(qb, xs, LD, j * 16 + n * 8, kk * 16, lane);
          mma_bf16(s[n], ka[kk], qb[0], qb[1]);
          ldsm_b(ob, ys, LD, j * 16 + n * 8, kk * 16, lane);
          mma_bf16(dp[n], va[kk], ob[0], ob[1]);
        }
      }
      // rows: this thread's keys; columns: queries j*16 + n*8 + 2t + (i&1)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = j * 16 + n * 8 + 2 * t + (i & 1);
          const float p = exp2f(s[n][i] * a.scale_log2 - lse_s[col]);
          dp[n][i] = p * (dp[n][i] - d_s[col]);
          s[n][i] = p;
        }
      uint32_t pa[4], dsa[4];
      acc_to_a(pa, s[0], s[1]);
      acc_to_a(dsa, dp[0], dp[1]);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        uint32_t bb[2];
        ldsm_bt(bb, ys, LD, j * 16, n * 8, lane);  // dO [queries][d]
        mma_bf16(dv[n], pa, bb[0], bb[1]);
        ldsm_bt(bb, xs, LD, j * 16, n * 8, lane);  // q [queries][d]
        mma_bf16(dk[n], dsa, bb[0], bb[1]);
      }
    }
  }

  // dK = scale * dS^T q, scale = scale_log2 * ln2; rows past Nk are not
  // written
  store_rows<DN>(static_cast<bf16*>(a.dk), dk, a.scale_log2 * LN2, b, h, a.H, a.Nk, D,
                 k0 + r0, lane);
  store_rows<DN>(static_cast<bf16*>(a.dv), dv, 1.f, b, h, a.H, a.Nk, D, k0 + r0, lane);
}

// ---------------------------------------------------------------------------
// attn_bwd_dq_kernel (kernel #9)
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(32 * BW_WARPS) attn_bwd_dq_kernel(BwdArgs a, int D) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;
  constexpr int DN = DP / 8;
  __shared__ __align__(16) bf16 xs[BW_TILE * LD];  // q, then K tiles
  __shared__ __align__(16) bf16 ys[BW_TILE * LD];  // dO, then V tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BW_ROWS, r0 = warp * 16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.osb + h * a.osh;

  load_rows(xs, LD, q + q0 * a.qsn, a.qsn, BW_ROWS, a.Nq - q0, D, DP);
  load_rows(ys, LD, dout + q0 * a.osn, a.osn, BW_ROWS, a.Nq - q0, D, DP);
  __syncthreads();
  uint32_t qa[KS][4], oa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    ldsm_a(qa[s], xs, LD, r0, s * 16, lane);
    ldsm_a(oa[s], ys, LD, r0, s * 16, lane);
  }
  // statistics of this thread's two query rows; padded rows get P = 0
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    const long long at = static_cast<long long>(blockIdx.y) * a.Nq + row;
    lse_r[r] = row < a.Nq ? a.lse[at] : INFINITY;
    d_r[r] = row < a.Nq ? a.dvec[at] : 0.f;
  }

  float dq[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) zero(dq[n]);

  for (int k0 = 0; k0 < a.Nk; k0 += BW_TILE) {
    const int nvalid = min(BW_TILE, a.Nk - k0);
    __syncthreads();  // fragments taken / previous tile consumed
    load_rows(xs, LD, k + k0 * a.ksn, a.ksn, BW_TILE, nvalid, D, DP);
    load_rows(ys, LD, v + k0 * a.vsn, a.vsn, BW_TILE, nvalid, D, DP);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < BW_TILE / 16; ++j) {  // 16 keys at a time
      if (j * 16 >= nvalid) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        zero(s[n]);
        zero(dp[n]);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[2], vb[2];
          ldsm_b(kb, xs, LD, j * 16 + n * 8, kk * 16, lane);
          mma_bf16(s[n], qa[kk], kb[0], kb[1]);
          ldsm_b(vb, ys, LD, j * 16 + n * 8, kk * 16, lane);
          mma_bf16(dp[n], oa[kk], vb[0], vb[1]);
        }
      }
      // rows: this thread's queries g, g + 8; columns: keys
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = j * 16 + n * 8 + 2 * t + (i & 1);
          const int r = i >> 1;
          const float p = key < nvalid ? exp2f(s[n][i] * a.scale_log2 - lse_r[r]) : 0.f;
          dp[n][i] = p * (dp[n][i] - d_r[r]);
        }
      uint32_t dsa[4];
      acc_to_a(dsa, dp[0], dp[1]);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        uint32_t kb[2];
        ldsm_bt(kb, xs, LD, j * 16, n * 8, lane);  // k [keys][d]
        mma_bf16(dq[n], dsa, kb[0], kb[1]);
      }
    }
  }

  store_rows<DN>(static_cast<bf16*>(a.dq), dq, a.scale_log2 * LN2, b, h, a.H, a.Nq, D, q0 + r0,
                 lane);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <bool DKV>
cudaError_t launch_bwd(const BwdArgs& a, int D, cudaStream_t st) {
  const dim3 grid(((DKV ? a.Nk : a.Nq) + BW_ROWS - 1) / BW_ROWS, a.B * a.H);
  const int threads = 32 * BW_WARPS;
  switch ((D + 15) / 16) {
#define SDAOF_BWD_CASE(NK)                                                 \
  case NK:                                                                 \
    if (DKV)                                                               \
      attn_bwd_dkv_kernel<16 * NK><<<grid, threads, 0, st>>>(a, D);        \
    else                                                                   \
      attn_bwd_dq_kernel<16 * NK><<<grid, threads, 0, st>>>(a, D);         \
    return cudaGetLastError();
    SDAOF_BWD_CASE(1)
    SDAOF_BWD_CASE(2)
    SDAOF_BWD_CASE(3)
    SDAOF_BWD_CASE(4)
    SDAOF_BWD_CASE(5)
    SDAOF_BWD_CASE(6)
    SDAOF_BWD_CASE(7)
    SDAOF_BWD_CASE(8)
#undef SDAOF_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dvec, int B, int H, int Nq, int Nk,
                      long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                      long long ksh, long long vsb, long long vsn, long long vsh, long long osb,
                      long long osn, long long osh, float scale_log2) {
  BwdArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.dvec = dvec;
  a.B = B;
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.qsb = qsb;
  a.qsn = qsn;
  a.qsh = qsh;
  a.ksb = ksb;
  a.ksn = ksn;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vsn = vsn;
  a.vsh = vsh;
  a.osb = osb;
  a.osn = osn;
  a.osh = osh;
  a.scale_log2 = scale_log2;
  return a;
}

// 16-byte tile loads: D % 8 == 0, 16-byte aligned bases, strides that are
// multiples of 8 elements
bool bwd_ok(const BwdArgs& a, int D) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  const long long strides = a.qsb | a.qsn | a.qsh | a.ksb | a.ksn | a.ksh | a.vsb | a.vsn |
                            a.vsh | a.osb | a.osn | a.osh;
  return D >= 1 && D <= 128 && D % 8 == 0 && (ptrs & 15) == 0 && (strides & 7) == 0 &&
         a.Nq >= 1 && a.Nk >= 1;
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
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, dvec, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn, ksh,
                            vsb, vsn, vsh, osb, osn, osh, scale_log2);
  a.dk = dk;
  a.dv = dv;
  if (!bwd_ok(a, D)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd<true>(a, D, static_cast<cudaStream_t>(stream));
}

// dQ (bf16, contiguous [B, Nq, H, D]) of the attention backward.
extern "C" int sdaof_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* dvec,
                                      void* dq, int B, int H, int Nq, int Nk, int D,
                                      long long qsb, long long qsn, long long qsh, long long ksb,
                                      long long ksn, long long ksh, long long vsb, long long vsn,
                                      long long vsh, long long osb, long long osn, long long osh,
                                      float scale_log2, int device, void* stream) {
  BwdArgs a = make_bwd_args(q, k, v, dout, lse, dvec, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn, ksh,
                            vsb, vsn, vsh, osb, osn, osh, scale_log2);
  a.dq = dq;
  if (!bwd_ok(a, D)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd<false>(a, D, static_cast<cudaStream_t>(stream));
}
