// LayerNorm-prologue projection for Hopper (sm_90a), plain C interface
// for ctypes (ops/_cuda.py).
//
// Replaces the Pallas TPU kernel _linear_ln_kernel of
// sd_animation_optical_flow_tpu/ops/ffn.py (linear_ln_fused):
//
//   linear_ln_kernel: y = LN(x) @ W^T, the UNet LN1 -> QKV and LN2 -> Q
//                     projections.
//
// (The GEGLU tail, the same file's other TPU kernel, is ffn_sm90.cu.)
//
// One block owns a 32-row tile of x for its whole life. It normalises the
// tile ONCE into shared memory (f32 mean, then var = mean((x - mean)^2),
// affine in f32, rounded to bf16 as the TPU kernel does) and runs its
// products on the tensor cores (mma.sync m16n8k16 with ldmatrix fragment
// loads, bf16 in, f32 accumulate). The TPU kernel keeps the whole weight
// in VMEM; here 64-column chunks of W are staged through shared memory
// with 16-byte loads.
//
// What bounds it on this card: at the UNet's shapes (12288 x 320 rows,
// dout 960) the product makes it compute-bound in principle; without
// double-buffered (cp.async / TMA) weight tiles or wgmma it stays
// latency-bound well above that bound.

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int BM = 32;        // rows per block
constexpr int BN = 64;        // output columns a chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_DIN = 640;

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

cudaError_t opt_in_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
