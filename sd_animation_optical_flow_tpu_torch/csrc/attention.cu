// The older mma.sync attention kernel (sm_90a), the entry points of every
// attention forward, and their plain C interface for ctypes (ops/_cuda.py
// builds and loads this file).
//
// Routing: sdaof_attention sends d <= 128 to attention_sm90_kernel
// (csrc/attention_sm90.cu) and wider heads to attention_wide_sm90_kernel
// (csrc/attention_wide_sm90.cu); sdaof_attention_keymask (the CFG K/V
// injection) and sdaof_attention_mfr (the MFR strips) send every d up to
// 160 to attention_sm90_kernel's keymask and MFR modes (three consumer
// warpgroups at every d, 32-key tiles at d = 160). This file keeps one
// kernel, for the banded mode only: attn_mma_kernel<DP, MODE_BANDED>. It
// replaces this Pallas TPU kernel of sd_animation_optical_flow_tpu/ops/
// attention.py (the Python wrapper keeps its name and counter):
//
//   _flash_banded_kernel (flash_attention_banded: one frame's queries
//     against n frames' keys joined along the token axis, banded
//     cross-frame bias; on no pipeline path)
//     -> attn_mma_kernel<DP, MODE_BANDED>: out = softmax(q k^T / sqrt(d)
//     + bias) v for bf16 q [B, Nq, H, D] and k/v [B, Nk, H, D] (D a
//     multiple of 8, up to 160; any strides along B, N, H that are
//     multiples of 8; unit stride along D; 16-byte tile loads), writing a
//     contiguous [B, Nq, H, D] output. Query i sits at (i / w, i % w) and
//     key j at the same split of j % (h * w), both computed in registers
//     from the indices (the TPU kernel reads precomputed qpos / kpos
//     coordinate rows). Every key gets a bias: weight * exp(-dist /
//     sigma) inside the |dy|, |dx| <= radius band (0 when weight = 0) and
//     base outside, in the log2 domain. A key tile that lies in one frame,
//     with all its rows out of the band of the block's query rows, adds
//     base uniformly (a block-uniform test); the other tiles, those
//     straddling a frame boundary among them, evaluate it per element. No
//     tile is skipped: with a finite base every key counts.
//
// Design: a warp per 16 query rows; q k^T and p v both on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate), d zero-padded to a
// multiple of 16 in shared memory. The score tile's accumulator
// fragments are, rounded to bf16, the A fragments of the p v product, so
// p never leaves registers. Softmax in f32 with a TRACKED running max
// (online softmax), from a finite floor (-1e30, as the TPU kernel's), not
// -inf: a row whose first key tile scores all -inf (base = -inf) would
// otherwise rescale by exp2(-inf - -inf) = NaN. One block per (b*h,
// query tile), a loop over key tiles inside the block in place of the
// TPU's sequential grid axis; the ragged last key tile is masked to -inf.
//
// What bounds it on this card: at SD shapes attention is compute-bound
// (4*N^2*D operations on ~4*N*D*2 bytes, and one exp2 per score on the
// special-function units). This kernel uses mma.sync without pipelining
// the tile loads (no cp.async ring, no wgmma), so it sits several times
// above those bounds; the bias mode of attention_sm90_kernel (the MFR
// mode's skeleton, at every DP) is its next step.

#include <math.h>

#include "mma.cuh"

namespace {

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Nq, Nk;
  long long qsb, qsn, qsh;
  long long ksb, ksn, ksh;
  long long vsb, vsn, vsh;
  float scale_log2;  // softmax scale * log2(e): scores live in the log2 domain
  // frame height and width, band radius, in-band weight * log2(e), 1 /
  // sigma, and the out-of-band bias * log2(e)
  int fh, fw, radius;
  float bias_log2, inv_sigma, base_log2;
};

// the kernel's one mode (attention_sm90_kernel's modes are 0-2)
enum { MODE_BANDED = 4 };

constexpr float MAX_FLOOR = -1e30f;  // the running max's start

// ---------------------------------------------------------------------------
// attn_mma_kernel: bf16, D up to 160, the banded mode
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 4;
constexpr int MMA_BQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MMA_BK = 64;              // keys per shared-memory tile

template <int DP, int MODE>  // DP: head dim padded to a multiple of 16
__global__ void __launch_bounds__(32 * MMA_WARPS) attn_mma_kernel(AttnArgs a, int D) {
  constexpr int LD = DP + 8;       // tile row stride: conflict-free ldmatrix
  constexpr int KS = DP / 16;      // k-steps of q k^T
  constexpr int NT = MMA_BK / 8;   // 8-key column tiles of a score tile
  constexpr int DN = DP / 8;       // 8-wide column tiles of the output
  static_assert(MMA_BQ == MMA_BK, "q is staged in the k tile");
  static_assert(MODE == MODE_BANDED, "the banded mode only");
  __shared__ __align__(16) bf16 ks[MMA_BK * LD];  // also stages q
  __shared__ __align__(16) bf16 vs[MMA_BK * LD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * MMA_BQ, r0 = warp * 16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + h * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vsb + h * a.vsh;

  load_rows(ks, LD, q + q0 * a.qsn, a.qsn, MMA_BQ, a.Nq - q0, D, DP);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) ldsm_a(qa[s], ks, LD, r0, s * 16, lane);

  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = MAX_FLOOR, m1 = MAX_FLOOR;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

  // frame coordinates of this thread's two query rows, and the frame rows
  // the block's queries span
  int qy[2], qx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + r0 + g + 8 * r;
    qy[r] = i / a.fw;
    qx[r] = i - qy[r] * a.fw;
  }
  const int yq_lo = q0 / a.fw, yq_hi = (min(q0 + MMA_BQ, a.Nq) - 1) / a.fw;

  for (int k0 = 0; k0 < a.Nk; k0 += MMA_BK) {
    const int nvalid = min(MMA_BK, a.Nk - k0);
    __syncthreads();  // q fragments taken / previous tile consumed
    load_rows(ks, LD, k + k0 * a.ksn, a.ksn, MMA_BK, nvalid, D, DP);
    load_rows(vs, LD, v + k0 * a.vsn, a.vsn, MMA_BK, nvalid, D, DP);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[2];
        ldsm_b(kb, ks, LD, n * 8, kk * 16, lane);
        mma_bf16(s[n], qa[kk], kb[0], kb[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] *= a.scale_log2;  // into the log2 domain
    // the banded bias, in the log2 domain
    const int hw = a.fh * a.fw;
    const int j0 = k0 % hw;  // frame-local index of the tile's first key
    const int yk_lo = j0 / a.fw, yk_hi = (j0 + nvalid - 1) / a.fw;
    if (j0 + nvalid <= hw && (yk_hi < yq_lo - a.radius || yk_lo > yq_hi + a.radius)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] += a.base_log2;
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jl = (k0 + n * 8 + 2 * t + c) % hw;
          const int ky = jl / a.fw, kx = jl - ky * a.fw;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int dy = qy[r] - ky, dx = qx[r] - kx;
            if (abs(dy) > a.radius || abs(dx) > a.radius)
              s[n][2 * r + c] += a.base_log2;
            else if (a.bias_log2 != 0.f)
              s[n][2 * r + c] +=
                  a.bias_log2 * expf(-sqrtf(static_cast<float>(dy * dy + dx * dx)) * a.inv_sigma);
          }
        }
    }
    // mask the ragged tile (nvalid >= 1), running max from the floor
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n * 8 + 2 * t + (i & 1);
        if (key >= nvalid) s[n][i] = -INFINITY;
        if (i < 2)
          mx0 = fmaxf(mx0, s[n][i]);
        else
          mx1 = fmaxf(mx1, s[n][i]);
      }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        uint32_t vb[2];
        ldsm_bt(vb, vs, LD, j * 16, n * 8, lane);
        mma_bf16(o[n], pa, vb[0], vb[1]);
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* out = static_cast<bf16*>(a.o);
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int d = n * 8 + 2 * t + c;
      if (d >= D) continue;
      if (row0 < a.Nq)
        out[((static_cast<long long>(b) * a.Nq + row0) * a.H + h) * D + d] =
            __float2bfloat16(o[n][c] * inv0);
      if (row1 < a.Nq)
        out[((static_cast<long long>(b) * a.Nq + row1) * a.H + h) * D + d] =
            __float2bfloat16(o[n][2 + c] * inv1);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// the banded mode at every DP
cudaError_t launch_banded(const AttnArgs& a, int D, cudaStream_t st) {
  const dim3 grid((a.Nq + MMA_BQ - 1) / MMA_BQ, a.B * a.H);
  const int threads = 32 * MMA_WARPS;
  switch ((D + 15) / 16) {
#define SDAOF_MMA_CASE(NK)                                            \
  case NK:                                                            \
    attn_mma_kernel<16 * NK, MODE_BANDED><<<grid, threads, 0, st>>>(a, D); \
    return cudaGetLastError();
    SDAOF_MMA_CASE(1)
    SDAOF_MMA_CASE(2)
    SDAOF_MMA_CASE(3)
    SDAOF_MMA_CASE(4)
    SDAOF_MMA_CASE(5)
    SDAOF_MMA_CASE(6)
    SDAOF_MMA_CASE(7)
    SDAOF_MMA_CASE(8)
#undef SDAOF_MMA_CASE
    case 9:
    case 10:
      // SD-1.5's 160-wide heads of the third UNet level
      attn_mma_kernel<160, MODE_BANDED><<<grid, threads, 0, st>>>(a, D);
      return cudaGetLastError();
    default:
      return cudaErrorInvalidValue;
  }
}

// the 16-byte tile loads need D % 8 == 0, 16-byte aligned bases and
// strides that are multiples of 8 elements
bool aligned(const AttnArgs& a, int D) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const long long strides = a.qsb | a.qsn | a.qsh | a.ksb | a.ksn | a.ksh | a.vsb | a.vsn | a.vsh;
  return D % 8 == 0 && (ptrs & 15) == 0 && (strides & 7) == 0;
}

AttnArgs make_args(const void* q, const void* k, const void* v, void* o, int B, int H, int Nq,
                   int Nk, long long qsb, long long qsn, long long qsh, long long ksb,
                   long long ksn, long long ksh, long long vsb, long long vsn, long long vsh,
                   float scale_log2) {
  AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
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
  a.scale_log2 = scale_log2;
  return a;
}

}  // namespace

// csrc/attention_sm90.cu, csrc/attention_wide_sm90.cu
cudaError_t launch_attention_sm90_keymask(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int Nq, int Nk, int D, long long qsb,
                                          long long qsn, long long qsh, long long ksb,
                                          long long ksn, long long ksh, long long vsb,
                                          long long vsn, long long vsh, float scale_log2,
                                          int n_own, int n_uncond, int device, cudaStream_t st);
cudaError_t launch_attention_sm90_mfr(const void* q, const void* k, const void* v, void* o, int B,
                                      int H, int N, int D, long long qsb, long long qsn,
                                      long long qsh, long long ksb, long long ksn, long long ksh,
                                      long long vsb, long long vsn, long long vsh,
                                      float scale_log2, int w_strip, int w_tile, int radius,
                                      int target_only, float bias_log2, float inv_sigma,
                                      int device, cudaStream_t st);
cudaError_t launch_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                  float* lse, int B, int H, int Nq, int Nk, int D, long long qsb,
                                  long long qsn, long long qsh, long long ksb, long long ksn,
                                  long long ksh, long long vsb, long long vsn, long long vsh,
                                  float scale_log2, int device, cudaStream_t st);
cudaError_t launch_attention_wide_sm90(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Nq, int Nk, int D, long long qsb,
                                       long long qsn, long long qsh, long long ksb, long long ksn,
                                       long long ksh, long long vsb, long long vsn, long long vsh,
                                       float scale_log2, int device, cudaStream_t st);

// bf16 only, D a multiple of 8 up to 512: attention_sm90_kernel for
// d <= 128 (csrc/attention_sm90.cu), attention_wide_sm90_kernel above
// (csrc/attention_wide_sm90.cu). Refuses unaligned inputs. Returns a
// cudaError_t code (0 = ok).
extern "C" int sdaof_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Nq, int Nk, int D, long long qsb, long long qsn,
                               long long qsh, long long ksb, long long ksn, long long ksh,
                               long long vsb, long long vsn, long long vsh, float scale_log2,
                               int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128)
    return launch_attention_sm90(q, k, v, o, nullptr, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn,
                                 ksh, vsb, vsn, vsh, scale_log2, device, st);
  return launch_attention_wide_sm90(q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                                    vsb, vsn, vsh, scale_log2, device, st);
}

// The CFG K/V-injection attention (bf16, D a multiple of 8 up to 160):
// batch rows < n_uncond attend to keys < n_own only (1 <= n_own), on
// attention_sm90_kernel<DP, MODE_KEYMASK, NC> (csrc/attention_sm90.cu).
extern "C" int sdaof_attention_keymask(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int Nq, int Nk, int D, long long qsb,
                                       long long qsn, long long qsh, long long ksb,
                                       long long ksn, long long ksh, long long vsb,
                                       long long vsn, long long vsh, float scale_log2,
                                       int n_own, int n_uncond, int device, void* stream) {
  if (D < 1 || D > 160 || Nq < 1 || Nk < 1 || n_own < 1 || n_uncond < 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_attention_sm90_keymask(q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                                       vsb, vsn, vsh, scale_log2, n_own, n_uncond, device,
                                       static_cast<cudaStream_t>(stream));
}

// MFR strip self-attention (bf16, D a multiple of 8 up to 160, Nq = Nk =
// h * w_strip, w_strip = n_tiles * w_tile): scores of in-band pairs of
// distinct tiles gain bias_log2 * exp(-dist * inv_sigma), on
// attention_sm90_kernel<DP, MODE_MFR, NC> (csrc/attention_sm90.cu).
extern "C" int sdaof_attention_mfr(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int Nq, int Nk, int D, long long qsb, long long qsn,
                                   long long qsh, long long ksb, long long ksn, long long ksh,
                                   long long vsb, long long vsn, long long vsh,
                                   float scale_log2, int w_strip, int w_tile, int radius,
                                   int target_only, float bias_log2, float inv_sigma,
                                   int device, void* stream) {
  if (D < 1 || D > 160 || Nq < 1 || Nk != Nq || w_tile < 1 || w_strip < w_tile ||
      w_strip % w_tile != 0 || Nq % w_strip != 0 || radius < 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_attention_sm90_mfr(q, k, v, o, B, H, Nq, D, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn,
                                   vsh, scale_log2, w_strip, w_tile, radius, target_only, bias_log2,
                                   inv_sigma, device, static_cast<cudaStream_t>(stream));
}

// Banded multi-frame attention (bf16, D a multiple of 8 up to 160, Nq =
// fh * fw, Nk a whole number of frames): key j sits at frame-local
// position j % (fh * fw); in-band pairs (|dy|, |dx| <= radius) gain
// bias_log2 * exp(-dist * inv_sigma) (nothing when bias_log2 = 0), the
// others base_log2 (which may be -inf).
extern "C" int sdaof_attention_banded(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Nq, int Nk, int D, long long qsb,
                                      long long qsn, long long qsh, long long ksb, long long ksn,
                                      long long ksh, long long vsb, long long vsn, long long vsh,
                                      float scale_log2, int fh, int fw, int radius,
                                      float bias_log2, float base_log2, float inv_sigma,
                                      int device, void* stream) {
  if (D < 1 || D > 160 || fh < 1 || fw < 1 || Nq != fh * fw || Nk < Nq || Nk % Nq != 0 ||
      radius < 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  AttnArgs a = make_args(q, k, v, o, B, H, Nq, Nk, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh,
                         scale_log2);
  a.fh = fh;
  a.fw = fw;
  a.radius = radius;
  a.bias_log2 = bias_log2;
  a.base_log2 = base_log2;
  a.inv_sigma = inv_sigma;
  if (!aligned(a, D)) return cudaErrorMisalignedAddress;
  return launch_banded(a, D, static_cast<cudaStream_t>(stream));
}

extern "C" const char* sdaof_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
