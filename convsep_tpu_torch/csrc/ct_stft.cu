// Fused forward STFT: W/2 front padding, framing, window and half-spectrum
// FFT, with the Nyquist bin as a row of its own, for Hopper (sm_90a).
//
// Replaces convsep_tpu/dsp/pallas/ct_stft_kernel.py::stft_ct_pallas (_kernel
// and the XLA-side Nyquist dots of _impl). For every track n and frame f,
// with x the signal front-padded by nfft / 2 zeros (and zeros past its end):
//
//   X_f[k] = sum_t win[t] x[f hop + t] e^{-2 pi i k t / nfft}
//   re[n, f, k], im[n, f, k] = X_f[k]        k < nfft / 2 (natural order)
//   ny[n, f]                 = X_f[nfft / 2] (real: its imaginary part is 0)
//
// What bounds it on the H100: device-memory bytes. Per 30 s track
// (1 474 560 samples, nfft 4096, hop 1024) it reads 5.9 MB of signal and
// writes 23.6 MB of spectra, 8.8 us at 3.35 TB/s; the FFT's 1.8e8
// operations are 2.7 us at 67 TFLOP/s in float32.
//
// Design: the TPU kernel split n = 128 a + b into 128-lane matmuls with
// block-diagonal stage matrices and identity-dot transposes for Mosaic; what
// it computes is kept, not how. The FFT core of fft_common.cuh, shared with
// stft_dft.cu: a block loads the signal span of its 2 G frames once with
// 16-byte loads (front padding by guards), each of its G groups of nfft / 16
// threads runs a register-resident Stockham FFT of two real frames (log16
// passes, an exchange through shared memory between them, each behind a
// barrier of that group alone) with twiddles from a float32 quarter table
// made once on the host and held in shared memory, and splits them into
// bins 0 .. nfft/2 - 1 in natural order,
// written coalesced, and the Nyquist bin to ny. At 4096 points a group is
// 256 threads and a block two groups (four frames): one track is 361 blocks
// (fft_plan.stft_plan). So no pass waits on a block-wide barrier, no frame
// pair waits on another, no store scatters to bit-reversed slots, and no
// block computes twiddles.
//
// ct_stft_level_kernel takes the reference's largest size, 16 384 points,
// past the core's 8192: one direct 16 384-point transform a pair of frames
// on the core's level (fft_common.cuh::stft_level_block: two 8192-point
// runs of the core and a radix-2 stage on one 512-thread block, 191 488
// bytes of tables and exchange), the points win x_a + i win x_b read from
// global memory as the level asks for them, split as stft_block splits
// them. At hop 4096, one 30 s track (362 frames, 181 blocks) its bound is
// bytes: 5.9 MB of signal and 23.7 MB of spectra, 8.8 us.
//
// ct_stft_cluster_kernel, the design it replaced and that only
// stft_ct_cluster_pallas reaches now: Bluestein's chirp-z over a
// thread-block cluster of 4 blocks (M 32 768, fft_common.cuh::
// stft_cluster_block, stft_dft.cu's cluster kernel with these output
// rows), one cluster a pair of frames: two transforms of twice the points
// where the level runs one.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

using namespace fft_common;

// re / im rows (B nf, nfft / 2) below Nyquist, and ny (B nf)
struct HalfRows {
  float* re;
  float* im;
  float* ny;
  int half;
  __device__ __forceinline__ void operator()(long long row, bool has_b, int k, float2 a,
                                             float2 b) const {
    if (k == half) {  // A[N/2] = Re Z[N/2], B[N/2] = Im Z[N/2]: both real
      ny[row] = a.x;
      if (has_b) ny[row + 1] = b.x;
      return;
    }
    const long long o = row * half + k;
    re[o] = a.x;
    im[o] = a.y;
    if (has_b) {
      re[o + half] = b.x;
      im[o + half] = b.y;
    }
  }
};

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads) ct_stft_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    float* __restrict__ re, float* __restrict__ im, float* __restrict__ ny, int L, int hop,
    int nf) {
  stft_block<LOG2N>(x, win, tw, L, 1 << LOG2N, hop, nf,
                    HalfRows{re, im, ny, (1 << LOG2N) / 2});
}

template <int LOG2N>
cudaError_t launch(const float* x, const float* win, const float2* tw, float* re, float* im,
                   float* ny, int B, int L, int hop, int nf, int ffts, cudaStream_t stream) {
  const size_t smem = smem_bytes(LOG2N, 1 << LOG2N, hop, ffts);
  cudaError_t err = cudaFuncSetAttribute(ct_stft_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((nf + 2 * ffts - 1) / (2 * ffts));
  ct_stft_kernel<LOG2N><<<(unsigned)blocks, ffts * fft_threads(LOG2N), smem, stream>>>(
      x, win, tw, re, im, ny, L, hop, nf);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kMaxThreads) ct_stft_cluster_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ chat, float* __restrict__ re,
    float* __restrict__ im, float* __restrict__ ny, int L, int nfft, int hop, int nf) {
  extern __shared__ float4 smem4[];
  stft_cluster_block<kMaxLog2, 4>(smem4, x, win, tw, chirp, chat, L, nfft, hop, nf, nfft,
                                  HalfRows{re, im, ny, nfft / 2});
}

__global__ void __launch_bounds__(kMaxThreads) ct_stft_level_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    float* __restrict__ re, float* __restrict__ im, float* __restrict__ ny, int L, int hop,
    int nf) {
  extern __shared__ float4 smem4[];
  stft_level_block<false>(smem4, x, win, tw, L, 1 << kLevelLog2, hop, nf,
                          HalfRows{re, im, ny, 1 << kMaxLog2});
}

}  // namespace

// nfft = window, a power of two in [2^11, 2^13]; `ffts` complex FFTs (2 ffts
// frames) per block, from fft_plan.stft_plan.
extern "C" int ct_stft_launch(const void* x, const void* win, const void* tw, void* re,
                              void* im, void* ny, int B, int L, int nfft, int hop, int nf,
                              int ffts, void* stream) {
  const int log2n = plan_log2(nfft);
  if (B < 1 || L < 1 || nf < 1 || hop < 1 || log2n < 11 || ffts < 1 || ffts > 8 ||
      ffts * fft_threads(log2n) > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(win);
  const auto* t = static_cast<const float2*>(tw);
  auto* r = static_cast<float*>(re);
  auto* i = static_cast<float*>(im);
  auto* n = static_cast<float*>(ny);
  auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 11: return (int)launch<11>(xs, w, t, r, i, n, B, L, hop, nf, ffts, s);
    case 12: return (int)launch<12>(xs, w, t, r, i, n, B, L, hop, nf, ffts, s);
    default: return (int)launch<13>(xs, w, t, r, i, n, B, L, hop, nf, ffts, s);
  }
}

// nfft = window, even, past the core's 8192 up to 16 384 (Bluestein's M 32
// 768: a cluster of 4 blocks of 512 threads a pair of frames); tw the
// M-point quarter table (fft_plan.twiddles), chirp (nfft) and chat (M) from
// fft_plan.bluestein_tables.
extern "C" int ct_stft_cluster_launch(const void* x, const void* win, const void* tw,
                                      const void* chirp, const void* chat, void* re, void* im,
                                      void* ny, int B, int L, int nfft, int hop, int nf,
                                      void* stream) {
  if (B < 1 || L < 1 || nf < 1 || hop < 1 || nfft % 2 != 0 || nfft <= (1 << kMaxLog2) ||
      bluestein_log2(nfft) != kMaxLog2 + 2)
    return (int)cudaErrorInvalidValue;
  return (int)launch_clusters<4>(
      ct_stft_cluster_kernel, (long long)B * ((nf + 1) / 2), cluster_smem_bytes(kMaxLog2, 0),
      static_cast<cudaStream_t>(stream), nullptr, static_cast<const float*>(x),
      static_cast<const float*>(win), static_cast<const float2*>(tw),
      static_cast<const float2*>(chirp), static_cast<const float2*>(chat),
      static_cast<float*>(re), static_cast<float*>(im), static_cast<float*>(ny), L, nfft, hop,
      nf);
}

// nfft = window = 16 384: one 16 384-point transform a pair of frames on
// the level (fft_common.cuh::stft_level_block), one 512-thread block a pair;
// tw the 16 384-point quarter table (fft_plan.twiddles).
extern "C" int ct_stft_level_launch(const void* x, const void* win, const void* tw, void* re,
                                    void* im, void* ny, int B, int L, int nfft, int hop, int nf,
                                    void* stream) {
  if (B < 1 || L < 1 || nf < 1 || hop < 1 || nfft != 1 << kLevelLog2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bluestein_smem_bytes(kLevelLog2, nfft, hop, 1);
  cudaError_t err = cudaFuncSetAttribute(ct_stft_level_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ct_stft_level_kernel<<<(unsigned)((long long)B * ((nf + 1) / 2)), kMaxThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win),
      static_cast<const float2*>(tw), static_cast<float*>(re), static_cast<float*>(im),
      static_cast<float*>(ny), L, hop, nf);
  return (int)cudaGetLastError();
}
