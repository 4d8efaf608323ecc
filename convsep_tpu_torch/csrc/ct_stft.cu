// Fused forward STFT: W/2 front padding, framing, window and half-spectrum
// DFT, with the Nyquist bin as a row of its own, for Hopper (sm_90a).
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
// writes 23.6 MB of spectra; the FFT's ~1.1e8 operations are far below that.
//
// Design, and how it differs from the TPU kernel. The TPU kernel split
// n = 128 a + b into 128-lane matmuls with block-diagonal stage matrices and
// identity-dot transposes for Mosaic; what it computes is kept, not how:
// * one block per (run of R frames, track); it loads the frames' span of the
//   signal, (R - 1) hop + nfft samples, into shared memory once, so
//   overlapping frames share it, and applies the front padding there;
// * two real frames ride one complex radix-2 FFT (z = a + i b, the FFT of
//   istft_common.cuh with the forward twiddles); A[k] = (Z[k] + conj(Z[-k]))/2
//   and B[k] = (Z[k] - conj(Z[-k]))/2i split them again;
// * bins 0 .. nfft/2 - 1 are written in natural order, the Nyquist bin to ny.

#include <cuda_runtime.h>
#include <stdint.h>

#include "istft_common.cuh"

namespace {

using namespace istft_common;

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) ct_stft_kernel(
    const float* __restrict__ x, const float* __restrict__ win, float* __restrict__ re,
    float* __restrict__ im, float* __restrict__ ny, int L, int nfft, int log2n, int hop,
    int nf, int frames_per_block) {
  extern __shared__ float2 smem2[];
  const int half = nfft / 2;
  float2* tw = smem2;                                   // half
  float2* buf = tw + half;                              // nfft
  float* span = reinterpret_cast<float*>(buf + nfft);   // (R - 1) hop + nfft
  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int f0 = blockIdx.x * frames_per_block;
  const int nfr = min(frames_per_block, nf - f0);
  const int span_len = (nfr - 1) * hop + nfft;
  // signal index of span[0]: padded position f0 hop, less the front padding
  const long long s0 = (long long)f0 * hop - half;
  const float* xs = x + (long long)n * L;

  init_twiddles(tw, half, nfft, tid, kThreads, -1.f);
  for (int i = tid; i < span_len; i += kThreads) {
    const long long s = s0 + i;
    span[i] = (s >= 0 && s < L) ? xs[s] : 0.f;
  }
  __syncthreads();
  for (int r = 0; r < nfr; r += 2) {
    const bool has1 = r + 1 < nfr;
    const float* a = span + r * hop;
    const float* b = a + hop;
    // windowed frames r (real part) and r + 1 (imaginary part), stored at
    // bit-reversed slots for the decimation-in-time FFT
    for (int t = tid; t < nfft; t += kThreads) {
      const float wv = win[t];
      buf[bin_slot<true>(t, log2n)] = make_float2(a[t] * wv, has1 ? b[t] * wv : 0.f);
    }
    __syncthreads();
    fft_stages(buf, tw, nfft, log2n, tid, kThreads);
    const long long oa = ((long long)n * nf + f0 + r) * half;
    const long long ob = oa + half;
    for (int k = tid; k < half; k += kThreads) {
      const float2 z = buf[k];
      const float2 w = buf[(nfft - k) & (nfft - 1)];
      re[oa + k] = 0.5f * (z.x + w.x);
      im[oa + k] = 0.5f * (z.y - w.y);
      if (has1) {
        re[ob + k] = 0.5f * (z.y + w.y);
        im[ob + k] = 0.5f * (w.x - z.x);
      }
    }
    if (tid == 0) {
      const float2 z = buf[half];  // A[N/2] = Re Z[N/2], B[N/2] = Im Z[N/2]
      const long long o = (long long)n * nf + f0 + r;
      ny[o] = z.x;
      if (has1) ny[o + 1] = z.y;
    }
    __syncthreads();  // buf is read before the next pair overwrites it
  }
}

}  // namespace

extern "C" int ct_stft_launch(const void* x, const void* win, void* re, void* im, void* ny,
                              int B, int L, int nfft, int hop, int nf, int frames_per_block,
                              void* stream) {
  const int log2n = pow2_log(nfft);
  if (B < 1 || L < 1 || nf < 1 || hop < 1 || log2n < 1 || frames_per_block < 2 ||
      frames_per_block % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(nfft / 2) * sizeof(float2) + (size_t)nfft * sizeof(float2) +
                      (size_t)((frames_per_block - 1) * hop + nfft) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(ct_stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nf + frames_per_block - 1) / frames_per_block, B);
  ct_stft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(win), static_cast<float*>(re),
      static_cast<float*>(im), static_cast<float*>(ny), L, nfft, log2n, hop, nf,
      frames_per_block);
  return (int)cudaGetLastError();
}
