// The entry points of every attention forward, their plain C interface
// for ctypes (ops/_cuda.py builds and loads this file), and
// sdaof_error_string. No kernel lives here: each entry point checks its
// arguments and calls the launcher of a Hopper kernel.
//
// Routing: sdaof_attention sends d <= 128 to attention_sm90_kernel
// (csrc/attention_sm90.cu) and wider heads to attention_wide_sm90_kernel
// (csrc/attention_wide_sm90.cu); sdaof_attention_keymask (the CFG K/V
// injection), sdaof_attention_mfr (the MFR strips) and
// sdaof_attention_banded (the banded multi-frame attention) send every d
// up to 160 to attention_sm90_kernel's keymask, MFR and banded modes
// (three consumer warpgroups at every d, 32-key tiles at d = 160).

#include <cuda_runtime.h>

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
cudaError_t launch_attention_sm90_banded(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int Nq, int Nk, int D, long long qsb,
                                         long long qsn, long long qsh, long long ksb,
                                         long long ksn, long long ksh, long long vsb,
                                         long long vsn, long long vsh, float scale_log2, int fh,
                                         int fw, int radius, float bias_log2, float base_log2,
                                         float inv_sigma, int device, cudaStream_t st);
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
// others base_log2 (which may be -inf), on attention_sm90_kernel<DP,
// MODE_BANDED, NC> (csrc/attention_sm90.cu).
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
  return launch_attention_sm90_banded(q, k, v, o, B, H, Nq, Nk, D, qsb, qsn, qsh, ksb, ksn, ksh,
                                      vsb, vsn, vsh, scale_log2, fh, fw, radius, bias_log2,
                                      base_log2, inv_sigma, device,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* sdaof_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
