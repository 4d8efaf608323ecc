// Shared device code of the inverse-STFT kernels (wiener_istft.cu, istft.cu).
//
// A block inverse-transforms frames one complex FFT at a time in shared
// memory: two real frames A, B (hermitian half-spectra) ride one transform
// as Z = A + iB, whose inverse is a + ib, so the real part is frame A and
// the imaginary part frame B. Power-of-two sizes take an iterative radix-2
// FFT (bins stored at bit-reversed slots, natural-order output); other even
// sizes a direct O(nfft) sum per output sample from the same spectrum.
// irfft ignores the imaginary parts of the DC and Nyquist bins.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace istft_common {

// log2(nfft) when nfft is a power of two, else 0 (the direct sum)
inline int pow2_log(int nfft) {
  int lg = 0;
  while ((1 << lg) < nfft) ++lg;
  return (1 << lg) == nfft ? lg : 0;
}

// twiddles tw[j] = e^{+2 pi i j / nfft}, j < tw_len, from double precision
// (tw_len is nfft / 2 for the FFT, nfft for the direct sum)
__device__ __forceinline__ void init_twiddles(float2* tw, int tw_len, int nfft, int tid,
                                              int nthreads) {
  for (int j = tid; j < tw_len; j += nthreads) {
    double s, c;
    sincospi(2.0 * (double)j / (double)nfft, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
}

template <bool kPow2>
__device__ __forceinline__ int bin_slot(int k, int log2n) {
  return kPow2 ? (int)(__brev((unsigned)k) >> (32 - log2n)) : k;
}

// Store bin k (0 <= k <= nfft/2) of Z = A + iB and its mirror nfft - k,
// given A = ar + i ai and B = br + i bi at bin k.
template <bool kPow2>
__device__ __forceinline__ void pack_pair(float2* buf, int k, int nfft, int log2n, float ar,
                                          float ai, float br, float bi) {
  const int half = nfft / 2;
  if (k == 0 || k == half) {
    ai = 0.f;
    bi = 0.f;
  }
  buf[bin_slot<kPow2>(k, log2n)] = make_float2(ar - bi, ai + br);
  if (k != 0 && k != half) buf[bin_slot<kPow2>(nfft - k, log2n)] = make_float2(ar + bi, br - ai);
}

// Iterative radix-2 decimation in time, in place over buf. Every
// thread of the block must call it; each stage ends in __syncthreads. No
// stages when log2n is 0 (the direct sum reads buf as it is).
__device__ __forceinline__ void fft_stages(float2* buf, const float2* tw, int nfft, int log2n,
                                           int tid, int nthreads) {
  const int half = nfft / 2;
  for (int lg = 1; lg <= log2n; ++lg) {
    const int hl = 1 << (lg - 1);
    const int tw_stride = nfft >> lg;
    for (int b = tid; b < half; b += nthreads) {
      const int j = b & (hl - 1);
      const int i0 = ((b >> (lg - 1)) << lg) + j;
      const int i1 = i0 + hl;
      const float2 w = tw[j * tw_stride];
      const float2 u = buf[i0];
      const float2 v = buf[i1];
      const float tr = v.x * w.x - v.y * w.y;
      const float ti = v.x * w.y + v.y * w.x;
      buf[i0] = make_float2(u.x + tr, u.y + ti);
      buf[i1] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
}

// Sample t of the inverse transform (unscaled): buf[t] after fft_stages,
// or z = sum_k buf[k] e^{+2 pi i k t / N} for the direct sum.
template <bool kPow2>
__device__ __forceinline__ float2 inverse_sample(const float2* buf, const float2* tw, int nfft,
                                                 int t) {
  if (kPow2) return buf[t];
  float2 z = make_float2(0.f, 0.f);
  int idx = 0;
  for (int k = 0; k < nfft; ++k) {
    const float2 w = tw[idx];
    const float2 u = buf[k];
    z.x += u.x * w.x - u.y * w.y;
    z.y += u.x * w.y + u.y * w.x;
    idx += t;
    if (idx >= nfft) idx -= nfft;
  }
  return z;
}

// out[o] = v as float32, or as PCM16: round to nearest even, clipped
__device__ __forceinline__ void store_sample(void* out, int out_int16, long long o, float v) {
  if (out_int16) {
    const float qv = fminf(fmaxf(rintf(v * 32768.f), -32768.f), 32767.f);
    static_cast<int16_t*>(out)[o] = (int16_t)qv;
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

}  // namespace istft_common
