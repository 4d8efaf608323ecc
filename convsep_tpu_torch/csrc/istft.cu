// Windowed inverse STFT + overlap-add + window-power normalization, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels that compute the same function:
// convsep_tpu/dsp/pallas/ct_istft_kernel.py::istft_ct_pallas (_kernel, a
// 128-lane factored matmul, nfft == win, optional PCM16 epilogue) and
// convsep_tpu/dsp/pallas/istft_kernel.py::istft_pallas (_kernel and
// _kernel_big, a dense matmul with a spill output, nfft >= win, float32).
// For every signal n of re/im (N, nf, nfft/2 + 1):
//
//   frame[f]  = irfft(re[n, f] + i im[n, f])[:win] * window / nfft
//   out[n]    = OLA(frame, hop) * inv_norm, win/2 front trim, length
//               samples, float32 or PCM16 (rintf + clip)
//
// What bounds it on the H100: device-memory bytes. Each spectrum is read
// once (8 bytes per bin) and each sample written once; the transforms are
// about 2.5 nfft log2(nfft) flops per frame, two orders of magnitude below
// what the card's float32 rate would need to matter.
//
// Design, and how it differs from the TPU kernels:
// * The TPU kernels walked frame blocks in order and carried (or spilled)
//   the overlap-add tail from one block to the next. Blocks here run in no
//   order, so overlap-add is a gather: block (r, n) owns hop rows
//   [j0, j0 + R) of signal n and transforms every frame that touches them,
//   i.e. the win/hop - 1 frames before j0 as well. The recomputed share is
//   (win/hop - 1) / R of the transforms; the sum is deterministic, with no
//   atomics.
// * The inverse DFT is the radix-2 FFT in shared memory of wiener_istft.cu
//   (istft_common.cuh) for power-of-two nfft, a direct sum for other even
//   nfft. Without a mask to apply, consecutive frames f and f + 1 share one
//   complex transform (Z = A + iB). Their windowed samples land on the
//   same hop rows one hop apart, so a thread adds sample u of frame f and
//   sample u - hop of frame f + 1 into position u of the pair: one write
//   per position, no race.
// Shared memory: twiddles (nfft/2 float2; nfft for the direct sum) + the
// spectrum buffer (nfft float2) + the accumulator (R * hop floats); the
// wrapper picks R to fit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "istft_common.cuh"

namespace {

using namespace istft_common;

constexpr int kThreads = 512;

template <bool kPow2>
__global__ void __launch_bounds__(kThreads) istft_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    void* __restrict__ out, int out_int16, int nf, int nfft, int log2n, int tw_len, int win,
    int hop, int length, int rows_per_block) {
  extern __shared__ float2 smem2[];
  const int half = nfft / 2;
  const int bins = half + 1;
  const int k_ratio = win / hop;
  float2* tw = smem2;                                  // tw_len
  float2* buf = tw + tw_len;                           // nfft
  float* acc = reinterpret_cast<float*>(buf + nfft);   // R * hop

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int j0 = blockIdx.x * rows_per_block;
  const int total_rows = nf + k_ratio - 1;
  const int rows = min(rows_per_block, total_rows - j0);
  const long long track = (long long)n * nf * bins;

  init_twiddles(tw, tw_len, nfft, tid, kThreads);
  for (int i = tid; i < rows_per_block * hop; i += kThreads) acc[i] = 0.f;

  const int f_lo = max(0, j0 - k_ratio + 1);
  const int f_hi = min(nf - 1, j0 + rows - 1);
  for (int f = f_lo; f <= f_hi; f += 2) {
    const bool has1 = f + 1 <= f_hi;
    const long long fa = track + (long long)f * bins;
    const long long fb = fa + bins;
    __syncthreads();  // the previous pair's readers of buf are done
    for (int k = tid; k <= half; k += kThreads) {
      const float ar = re[fa + k], ai = im[fa + k];
      const float br = has1 ? re[fb + k] : 0.f;
      const float bi = has1 ? im[fb + k] : 0.f;
      pack_pair<kPow2>(buf, k, nfft, log2n, ar, ai, br, bi);
    }
    __syncthreads();
    fft_stages(buf, tw, nfft, log2n, tid, kThreads);
    // position u of the pair is sample f * hop + u of the signal: sample u
    // of frame f (real part) plus sample u - hop of frame f + 1 (imaginary)
    const int span = win + (has1 ? hop : 0);
    for (int u = tid; u < span; u += kThreads) {
      const int row = f + u / hop - j0;
      if (row < 0 || row >= rows) continue;
      float v = 0.f;
      if (u < win) v = inverse_sample<kPow2>(buf, tw, nfft, u).x * win_over_n[u];
      if (has1 && u >= hop) v += inverse_sample<kPow2>(buf, tw, nfft, u - hop).y * win_over_n[u - hop];
      acc[row * hop + u % hop] += v;
    }
  }
  __syncthreads();
  // epilogue: window-power normalization, win/2 front trim, optional PCM16
  const long long front = win / 2;
  for (int i = tid; i < rows * hop; i += kThreads) {
    const long long nabs = (long long)j0 * hop + i;
    const long long tpos = nabs - front;
    if (tpos < 0 || tpos >= length) continue;
    store_sample(out, out_int16, (long long)n * length + tpos, acc[i] * inv_norm[nabs]);
  }
}

}  // namespace

extern "C" int istft_launch(const void* re, const void* im, const void* win_over_n,
                            const void* inv_norm, void* out, int out_int16, int nt, int nf,
                            int nfft, int win, int hop, int length, int rows_per_block,
                            void* stream) {
  if (nfft < 2 || nfft % 2 != 0 || win < 1 || win > nfft || hop < 1 || win % hop != 0 ||
      nt < 1 || nf < 1 || rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  const int log2n = pow2_log(nfft);  // 0: not a power of two, the direct sum
  const int tw_len = log2n ? nfft / 2 : nfft;
  const int total_rows = nf + win / hop - 1;
  const int nblk = (total_rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)tw_len * sizeof(float2) + (size_t)nfft * sizeof(float2) +
                      (size_t)rows_per_block * hop * sizeof(float);
  auto kern = log2n ? istft_kernel<true> : istft_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nblk, nt);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(win_over_n), static_cast<const float*>(inv_norm), out,
      out_int16, nf, nfft, log2n, tw_len, win, hop, length, rows_per_block);
  return (int)cudaGetLastError();
}
