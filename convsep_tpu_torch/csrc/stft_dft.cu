// Fused framing + windowed dense DFT (the STFT), for Hopper (sm_90a).
//
// Replaces convsep_tpu/dsp/pallas/stft_kernel.py::stft_pallas (_kernel). For
// signal b, frame f and bin c:
//
//   re[b, f, c] = sum_n x[b, f * hop + n - W / 2] * cosw[n, c]
//   im[b, f, c] = sum_n x[b, f * hop + n - W / 2] * sinw[n, c]
//
// with cosw / sinw the (W, bins) window-folded DFT matrices (sinw carries the
// minus sign) and x read as zero outside [0, L): that is the W / 2 front pad
// and the tail pad of stft_matmul's framing, applied by the guard instead of
// a padded copy.
//
// What bounds it on the H100: arithmetic. The dsd100 training step takes the
// STFT of 32 mixtures and 128 stems of 14 336 samples (nf 30, W 1024, bins
// 513): 4 * 160 * 30 * 1024 * 513 = 10.1 GFLOP, here in float32 on the CUDA
// cores (no TF32). The signals (9 MB) and the matrices (4.2 MB) stay in L2.
//
// Design: as on the TPU, frames are never written to device memory. Sample
// n = i * hop + h of frame f lies in hop row f + i, column h, so a tile of TF
// frames reads hop rows [f0, f0 + TF + k - 1), k = W / hop. A block owns TF
// frames x TB bins of one signal. It walks the hop columns in chunks of HC:
// it stages that column chunk of its TF + k - 1 hop rows in shared memory,
// then for each row offset i stages the HC x TB tiles of cosw and sinw (rows
// i * hop + h) and every thread accumulates 2 frames x 4 bins of re and of
// im in registers. Frames past nf and bins past `bins` are computed from
// zeros and never stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTF = 32;  // frames per block: 16 thread rows of 2
constexpr int kTB = 64;  // bins per block: 16 thread columns of 4
constexpr int kHC = 32;  // hop columns per chunk

__global__ void __launch_bounds__(kThreads) stft_dft_kernel(
    const float* __restrict__ x, const float* __restrict__ cosw,
    const float* __restrict__ sinw, float* __restrict__ re, float* __restrict__ im,
    int L, int W, int hop, int nf, int bins) {
  extern __shared__ float4 smem4[];
  const int k = W / hop;
  const int rows = kTF + k - 1;
  float* sig_s = reinterpret_cast<float*>(smem4);  // rows x kHC
  float* cos_s = sig_s + rows * kHC;               // kHC x kTB
  float* sin_s = cos_s + kHC * kTB;                // kHC x kTB
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // bins c0 + 4 tx + [0, 4)
  const int ty = tid / 16;  // frames f0 + 2 ty + [0, 2)
  const int c0 = blockIdx.x * kTB;
  const int f0 = blockIdx.y * kTF;
  const int b = blockIdx.z;
  const int front = W / 2;
  const float* xb = x + (long long)b * L;

  float acc_re[2][4], acc_im[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_re[r][q] = acc_im[r][q] = 0.f;

  for (int h0 = 0; h0 < hop; h0 += kHC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int p = tid; p < rows * kHC; p += kThreads) {
      const int rr = p / kHC;
      const int h = h0 + (p - rr * kHC);
      const long long j = (long long)(f0 + rr) * hop + h - front;  // index into x
      sig_s[p] = (h < hop && j >= 0 && j < L) ? __ldg(xb + j) : 0.f;
    }
    for (int i = 0; i < k; ++i) {
      __syncthreads();  // sig_s is complete; the previous tiles' readers are done
      for (int q = tid; q < kHC * kTB; q += kThreads) {
        const int hh = q / kTB;
        const int c = c0 + (q - hh * kTB);
        const bool ok = h0 + hh < hop && c < bins;
        const long long off = (long long)(i * hop + h0 + hh) * bins + c;
        cos_s[q] = ok ? __ldg(cosw + off) : 0.f;
        sin_s[q] = ok ? __ldg(sinw + off) : 0.f;
      }
      __syncthreads();
      const float* s0 = sig_s + (2 * ty + i) * kHC;  // hop row of frame 2 ty, offset i
      const float4* cs = reinterpret_cast<const float4*>(cos_s) + tx;
      const float4* sn = reinterpret_cast<const float4*>(sin_s) + tx;
#pragma unroll 8
      for (int hh = 0; hh < kHC; ++hh) {
        const float a[2] = {s0[hh], s0[kHC + hh]};
        const float4 cv = cs[hh * (kTB / 4)];
        const float4 sv = sn[hh * (kTB / 4)];
        const float c[4] = {cv.x, cv.y, cv.z, cv.w};
        const float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc_re[r][q] = fmaf(a[r], c[q], acc_re[r][q]);
            acc_im[r][q] = fmaf(a[r], s[q], acc_im[r][q]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = f0 + 2 * ty + r;
    if (f >= nf) continue;
    const long long o = ((long long)b * nf + f) * bins;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + 4 * tx + q;
      if (c >= bins) continue;
      re[o + c] = acc_re[r][q];
      im[o + c] = acc_im[r][q];
    }
  }
}

}  // namespace

extern "C" int stft_dft_launch(const void* x, const void* cosw, const void* sinw, void* re,
                               void* im, int B, int L, int W, int hop, int nf, int bins,
                               void* stream) {
  if (B < 1 || L < 1 || W < 2 || hop < 1 || W % hop != 0 || nf < 1 || bins < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(kTF + W / hop - 1) * kHC + 2 * kHC * kTB);
  cudaError_t err = cudaFuncSetAttribute(
      stft_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((bins + kTB - 1) / kTB, (nf + kTF - 1) / kTF, B);
  stft_dft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cosw),
      static_cast<const float*>(sinw), static_cast<float*>(re), static_cast<float*>(im), L, W,
      hop, nf, bins);
  return (int)cudaGetLastError();
}
