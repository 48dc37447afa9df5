// Shared device helpers of the port's tensor-core kernels: warp
// reductions, 16-byte tile loads into shared memory, and mma.sync
// m16n8k16 with ldmatrix fragment loads (attention.cu), bf16 packing. Header-only; every
// helper is __device__ __forceinline__ and lives in an anonymous
// namespace per translation unit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// tile loads (bf16): rows [0, rows) of src (row stride `stride` elements)
// into shared memory, zero past `nvalid` rows and past column D (up to DP)
// ---------------------------------------------------------------------------

// 16-byte loads: the callers guarantee D % 8 == 0, stride % 8 == 0 and a
// 16-byte aligned src
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, long long stride,
                                          int rows, int nvalid, int D, int DP) {
  const int cpr = DP / 8;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr, c = (e - r * cpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid && c < D) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (bf16 -> f32). Fragment layout (g = lane / 4,
// t = lane % 4): A holds rows g and g + 8 at columns 2t, 2t+1 and 2t+8,
// 2t+9; B holds k 2t, 2t+1 and 2t+8, 2t+9 of column g; C holds rows g
// (c0, c1) and g + 8 (c2, c3) at columns 2t, 2t+1.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: each 8x8 bf16 matrix is 8 row addresses (16-byte aligned) of
// one lane group; the result lands in the mma fragment layout above.
// A fragment of rows [row, row + 16), columns [col, col + 16) (x4)
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* base, int ld, int row,
                                       int col, int lane) {
  const bf16* p = base + (row + (lane & 15)) * ld + col + (lane >> 4) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// B fragment from a row-major [n][k] tile (k^T of q k^T): rows
// [n0, n0 + 8), columns [k0, k0 + 16) (x2)
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[2], const bf16* base, int ld, int n0,
                                       int k0, int lane) {
  const bf16* p = base + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_u32(p)));
}

// B fragment from a row-major [k][n] tile (v of p v), transposed on load:
// rows [k0, k0 + 16), columns [n0, n0 + 8) (x2.trans)
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[2], const bf16* base, int ld, int k0,
                                        int n0, int lane) {
  const bf16* p = base + (k0 + (lane & 15)) * ld + n0;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_u32(p)));
}

}  // namespace
