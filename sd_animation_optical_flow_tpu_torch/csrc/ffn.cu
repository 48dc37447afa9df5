// LayerNorm-prologue projection and fused GEGLU feed-forward for Hopper
// (sm_90a), plain C interface for ctypes (ops/_cuda.py).
//
// Replaces two Pallas TPU kernels of sd_animation_optical_flow_tpu/ops/ffn.py:
//
//   linear_ln_kernel <- _linear_ln_kernel (linear_ln_fused): y = LN(x) @ W^T,
//                       the UNet LN1 -> QKV and LN2 -> Q projections.
//   geglu_kernel     <- _geglu_kernel / _geglu_kernel_ln (geglu_ff_fused):
//                       [LN3] -> x@W1 -> h * gelu_erf(gate) -> @W2 -> +b2
//                       [-> + x], the transformer-block tail.
//
// Both: one block owns a 32-row tile of x for its whole life. It
// normalises the tile ONCE into shared memory (f32 mean, then
// var = mean((x - mean)^2), affine in f32, rounded to bf16 as the TPU
// kernel does) and runs its products on the tensor cores (mma.sync
// m16n8k16 with ldmatrix fragment loads, bf16 in, f32 accumulate). The TPU
// kernel keeps the whole weight in VMEM; here weight tiles are staged
// through shared memory with 16-byte loads: linear_ln walks 64-column
// chunks of W, geglu walks the dff axis in 64-wide chunks (W1 in 64x64
// sub-tiles, the matching W2 columns whole). The GEGLU's [rows, dff]
// intermediates never leave the block, and the dff loop accumulates the
// second product in registers (8 warps each own 1/4 of the output
// columns of one 16-row half), so no reduction crosses blocks.
//
// Rounding points follow the TPU kernel: h and g round to bf16 before
// their bias adds, h * gelu(g) rounds to bf16 before W2, the output is
// bf16(acc) + b2, then + x.
//
// What bounds them on this card: at the UNet's shapes (12288 x 320 rows,
// dout 960 / dff 1280) the products make both compute-bound in
// principle; without double-buffered (cp.async / TMA) weight tiles or
// wgmma they stay latency-bound well above that bound.

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BN = 64;        // output columns (linear_ln) / dff chunk (geglu)
constexpr int KC = 64;        // k chunk of the staged W1 sub-tiles (geglu)
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_DIN = 640;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ __forceinline__ size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// rows [m0, m0 + BM) of x -> xn (bf16, row stride ldx). With lns == nullptr
// the rows are copied as they are; rows past M are zero.
__device__ void norm_rows(const bf16* x, const float* lns, const float* lnb, int M, int din,
                          int m0, float eps, bf16* xn, int ldx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    bf16* dst = xn + r * ldx;
    if (row >= M) {
      for (int c = lane; c < din; c += 32) dst[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* src = x + static_cast<long long>(row) * din;
    if (lns == nullptr) {
      for (int c = lane; c < din; c += 32) dst[c] = src[c];
      continue;
    }
    float sum = 0.f;
    for (int c = lane; c < din; c += 32) sum += __bfloat162float(src[c]);
    const float mean = warp_sum(sum) / din;
    float sq = 0.f;
    for (int c = lane; c < din; c += 32) {
      const float dx = __bfloat162float(src[c]) - mean;
      sq = fmaf(dx, dx, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) / din + eps);
    for (int c = lane; c < din; c += 32) {
      const float xf = (__bfloat162float(src[c]) - mean) * rstd;
      dst[c] = __float2bfloat16(xf * lns[c] + lnb[c]);
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

size_t linear_ln_smem(int din) {
  return align128(sizeof(bf16) * BM * (din + 8)) + sizeof(bf16) * BN * (din + 8);
}

// y [M, dout] = bf16(LN(x) [M, din] @ w^T), w [dout, din]. Warp (wr, wc)
// computes rows 16 wr.., columns 16 wc.. of each 64-column chunk.
__global__ void __launch_bounds__(THREADS)
    linear_ln_kernel(const bf16* x, const float* lns, const float* lnb, const bf16* w,
                     bf16* y, int M, int din, int dout, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = din + 8;
  bf16* xn = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + align128(sizeof(bf16) * BM * ld));
  const int m0 = blockIdx.x * BM;
  norm_rows(x, lns, lnb, M, din, m0, eps, xn, ld);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  for (int n0 = 0; n0 < dout; n0 += BN) {
    __syncthreads();  // xn ready / previous chunk consumed
    load_rows(ws, ld, w + static_cast<long long>(n0) * din, din, BN, dout - n0, din,
                    din);
    __syncthreads();
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < din; kk += 16) {
      uint32_t a[4];
      ldsm_a(a, xn, ld, 16 * wr, kk, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[2];
        ldsm_b(b, ws, ld, 16 * wc + 8 * j, kk, lane);
        mma_bf16(c[j], a, b[0], b[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + 16 * wc + 8 * j + 2 * t;
      if (col >= dout) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + 16 * wr + g + 8 * half;
        if (row < M)
          store_pair(y + static_cast<long long>(row) * dout + col, c[j][2 * half],
                     c[j][2 * half + 1]);
      }
    }
  }
}

size_t geglu_smem(int din) {
  return align128(sizeof(bf16) * BM * (din + 8))         // xn
         + align128(sizeof(bf16) * 2 * BN * (KC + 8))    // W1 h|g sub-tiles
         + align128(sizeof(bf16) * BM * (BN + 8))        // h * gelu(g)
         + sizeof(bf16) * din * (BN + 8);                // W2 columns
}

// y [M, DIN] = [x +] (bf16(hg @ w2^T) + b2), hg = bf16(h * gelu(g)),
// h|g = bf16(xn @ w1^T) + b1, xn = [LN](x). w1 [2*dff, DIN] (value rows
// then gate rows), w2 [DIN, dff]. NTO = DIN / 32: each warp (wr, wc) owns
// rows 16 wr.. and NTO 8-wide output column tiles from 8 * NTO * wc.
template <int NTO>
__global__ void __launch_bounds__(THREADS)
    geglu_kernel(const bf16* x, const float* lns, const float* lnb, const bf16* w1,
                 const bf16* b1, const bf16* w2, const bf16* b2, bf16* y, int M, int dff,
                 float eps, int residual) {
  constexpr int DIN = 32 * NTO;
  constexpr int LDX = DIN + 8, LDW = KC + 8, LDH = BN + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* xn = reinterpret_cast<bf16*>(p);
  p += align128(sizeof(bf16) * BM * LDX);
  bf16* w1s = reinterpret_cast<bf16*>(p);  // [2 * BN][LDW]: h rows, then g rows
  p += align128(sizeof(bf16) * 2 * BN * LDW);
  bf16* hg = reinterpret_cast<bf16*>(p);  // [BM][LDH]
  p += align128(sizeof(bf16) * BM * LDH);
  bf16* w2s = reinterpret_cast<bf16*>(p);  // [DIN][LDH]

  const int m0 = blockIdx.x * BM;
  norm_rows(x, lns, lnb, M, DIN, m0, eps, xn, LDX);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  float acc[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int f0 = 0; f0 < dff; f0 += BN) {
    // h and g for rows 16 wr.., chunk columns 16 wc..
    float hc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float gc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < DIN; k0 += KC) {
      __syncthreads();  // xn ready / previous tiles consumed
      load_rows(w1s, LDW, w1 + static_cast<long long>(f0) * DIN + k0, DIN, BN, BN, KC,
                      KC);
      load_rows(w1s + BN * LDW, LDW, w1 + static_cast<long long>(dff + f0) * DIN + k0,
                      DIN, BN, BN, KC, KC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[4];
        ldsm_a(a, xn, LDX, 16 * wr, k0 + kk, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[2];
          ldsm_b(b, w1s, LDW, 16 * wc + 8 * j, kk, lane);
          mma_bf16(hc[j], a, b[0], b[1]);
          ldsm_b(b, w1s + BN * LDW, LDW, 16 * wc + 8 * j, kk, lane);
          mma_bf16(gc[j], a, b[0], b[1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * wr + g + (i >= 2 ? 8 : 0);
        const int c = 16 * wc + 8 * j + 2 * t + (i & 1);
        const float h = bf16_round(bf16_round(hc[j][i]) + __bfloat162float(b1[f0 + c]));
        const float gg =
            bf16_round(bf16_round(gc[j][i]) + __bfloat162float(b1[dff + f0 + c]));
        const float gelu = 0.5f * gg * (1.f + erff(gg * 0.70710678118654752f));
        hg[r * LDH + c] = __float2bfloat16(h * gelu);
      }
    load_rows(w2s, LDH, w2 + f0, dff, DIN, DIN, BN, BN);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      uint32_t a[4];
      ldsm_a(a, hg, LDH, 16 * wr, kk, lane);
#pragma unroll
      for (int n = 0; n < NTO; ++n) {
        uint32_t b[2];
        ldsm_b(b, w2s, LDH, 8 * (NTO * wc + n), kk, lane);
        mma_bf16(acc[n], a, b[0], b[1]);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = 8 * (NTO * wc + n) + 2 * t;
    const float bias0 = __bfloat162float(b2[col]), bias1 = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 16 * wr + g + 8 * half;
      if (row >= M) continue;
      const long long idx = static_cast<long long>(row) * DIN + col;
      float o0 = bf16_round(bf16_round(acc[n][2 * half]) + bias0);
      float o1 = bf16_round(bf16_round(acc[n][2 * half + 1]) + bias1);
      if (residual) {
        o0 += __bfloat162float(x[idx]);
        o1 += __bfloat162float(x[idx + 1]);
      }
      store_pair(y + idx, o0, o1);
    }
  }
}

cudaError_t opt_in_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int NTO>
cudaError_t launch_geglu(const bf16* x, const float* lns, const float* lnb, const bf16* w1,
                         const bf16* b1, const bf16* w2, const bf16* b2, bf16* y, int M,
                         int dff, float eps, int residual, cudaStream_t st) {
  const size_t smem = geglu_smem(32 * NTO);
  const cudaError_t err = opt_in_smem(reinterpret_cast<const void*>(geglu_kernel<NTO>), smem);
  if (err != cudaSuccess) return err;
  geglu_kernel<NTO><<<(M + BM - 1) / BM, THREADS, smem, st>>>(x, lns, lnb, w1, b1, w2, b2, y,
                                                               M, dff, eps, residual);
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 (weights 16-byte aligned) except lns/lnb (f32).
// Returns a cudaError_t code.
extern "C" int sdaof_linear_ln(const void* x, const void* lns, const void* lnb,
                               const void* w, void* y, int M, int din, int dout, float eps,
                               int device, void* stream) {
  if (din % 16 != 0 || din > MAX_DIN || dout % 16 != 0 || M < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = linear_ln_smem(din);
  err = opt_in_smem(reinterpret_cast<const void*>(linear_ln_kernel), smem);
  if (err != cudaSuccess) return err;
  linear_ln_kernel<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const bf16*>(w), static_cast<bf16*>(y), M,
      din, dout, eps);
  return cudaGetLastError();
}

// lns == lnb == NULL: no LayerNorm prologue. din a multiple of 64 up to
// 640, dff a multiple of 64.
extern "C" int sdaof_geglu(const void* x, const void* lns, const void* lnb, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* y, int M,
                           int din, int dff, float eps, int residual, int device,
                           void* stream) {
  if (din % 64 != 0 || din > MAX_DIN || dff % BN != 0 || M < 1) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* s = static_cast<const float*>(lns);
  const float* bb = static_cast<const float*>(lnb);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* b1b = static_cast<const bf16*>(b1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* b2b = static_cast<const bf16*>(b2);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (din / 64) {
#define SDAOF_GEGLU_CASE(K)                                                            \
  case K:                                                                              \
    return launch_geglu<2 * K>(xb, s, bb, w1b, b1b, w2b, b2b, yb, M, dff, eps, residual, \
                               st);
    SDAOF_GEGLU_CASE(1)
    SDAOF_GEGLU_CASE(2)
    SDAOF_GEGLU_CASE(3)
    SDAOF_GEGLU_CASE(4)
    SDAOF_GEGLU_CASE(5)
    SDAOF_GEGLU_CASE(6)
    SDAOF_GEGLU_CASE(7)
    SDAOF_GEGLU_CASE(8)
    SDAOF_GEGLU_CASE(9)
    SDAOF_GEGLU_CASE(10)
#undef SDAOF_GEGLU_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
