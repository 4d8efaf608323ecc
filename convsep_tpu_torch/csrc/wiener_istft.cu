// Fused Wiener mask + inverse STFT + overlap-add, for Hopper (sm_90a).
//
// Replaces convsep_tpu/dsp/pallas/ct_istft_kernel.py::istft_ct_pallas_wiener
// (_wiener_kernel). For every track n and source s:
//
//   mask_s[f, k] = relu(y_s)^p / (sum_j relu(y_j)^p + eps)   p in {1, 2},
//                  ratio in float32; conserve_last adds eps to the last
//                  source's numerator so the masks sum to exactly 1
//   frame_s[f]   = irfft(mask_s * (re + i im))[:N] * window / N
//   stem_s       = OLA(frame_s, hop) * inv_norm, W/2 front trim,
//                  optional PCM16 epilogue (rintf + clip)
//
// What bounds it on the H100: device-memory reads of y (S rows per frame,
// f32 or bf16) and of the mixture re/im. The point of the kernel is that
// the masked spectra mask*re, mask*im never reach device memory: each
// frame's mask, complex product and inverse FFT live in shared memory.
//
// Design, and how it differs from the TPU kernel:
// * The TPU walked frame blocks in order and carried the overlap-add spill
//   from one grid step to the next. Blocks here run in no order, so
//   overlap-add is a gather: block (r, n) owns hop rows [j0, j0 + R) of
//   track n and computes every frame that touches them, i.e. the k - 1
//   frames before j0 as well (k = nfft / hop). The recomputed share is
//   (k - 1) / R of the work; the result is deterministic, with no atomics.
// * The inverse DFT is a radix-2 complex FFT in shared memory when nfft is a
//   power of two (every preset), not the TPU's 128-lane matmul
//   factorization; any other even nfft takes a direct O(nfft^2) sum per
//   output sample from the same shared spectrum (correct, not fast). Two
//   sources share one complex transform: Z = A + iB with A, B hermitian
//   gives a + ib, so the real part is source s0's frame and the imaginary
//   part source s1's.
// * All S sources are handled by one block, so each frame's y, re and im are
//   read once from device memory for the denominator and again (from L2)
//   for the numerators.
// Shared memory: twiddles (N/2 float2; N for the direct sum) + the
// spectrum buffer (N float2) + the
// per-bin denominator (N/2+1 floats) + the accumulator (S * R * hop floats);
// the wrapper picks R to fit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float load_y(const void* y, int bf16, long long idx) {
  if (bf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(y)[idx]);
  return static_cast<const float*>(y)[idx];
}

__device__ __forceinline__ float relu_pow(float v, int p2) {
  v = v > 0.f ? v : 0.f;
  return p2 ? v * v : v;
}

// kPow2: nfft is a power of two (radix-2 FFT); else the direct sum.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads) wiener_istft_kernel(
    const void* __restrict__ y, int y_bf16,
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    void* __restrict__ out, int out_int16,
    int S, int nf, int nfft, int log2n, int tw_len, int hop, int length, int rows_per_block,
    int p2, float eps, int conserve_last) {
  extern __shared__ float2 smem2[];
  const int half = nfft / 2;
  const int bins = half + 1;
  const int k_ratio = nfft / hop;
  float2* tw = smem2;                                    // tw_len
  float2* buf = tw + tw_len;                             // nfft
  float* den = reinterpret_cast<float*>(buf + nfft);     // bins
  float* acc = den + bins;                               // S * R * hop

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int j0 = blockIdx.x * rows_per_block;
  const int total_rows = nf + k_ratio - 1;
  const int rows = min(rows_per_block, total_rows - j0);
  const long long y_track = (long long)n * S * nf * bins;
  const long long y_src = (long long)nf * bins;

  // inverse twiddles e^{+2 pi i j / N}, from double precision
  for (int j = tid; j < tw_len; j += kThreads) {
    double s, c;
    sincospi(2.0 * (double)j / (double)nfft, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
  for (int i = tid; i < S * rows_per_block * hop; i += kThreads) acc[i] = 0.f;

  const int f_lo = max(0, j0 - k_ratio + 1);
  const int f_hi = min(nf - 1, j0 + rows - 1);
  for (int f = f_lo; f <= f_hi; ++f) {
    const long long mix = ((long long)n * nf + f) * bins;
    const long long yf = y_track + (long long)f * bins;
    __syncthreads();  // previous frame's readers of den / buf are done
    for (int k = tid; k < bins; k += kThreads) {
      float d = 0.f;
      for (int s = 0; s < S; ++s) d += relu_pow(load_y(y, y_bf16, yf + s * y_src + k), p2);
      den[k] = d + eps;
    }
    __syncthreads();
    for (int s0 = 0; s0 < S; s0 += 2) {
      const int s1 = s0 + 1;
      const bool has1 = s1 < S;
      // masked spectra of s0 (A) and s1 (B), hermitian-extended into
      // Z = A + iB, stored at bit-reversed positions for the FFT
      for (int k = tid; k <= half; k += kThreads) {
        const float mr = re[mix + k];
        const float mi = im[mix + k];
        const float dk = den[k];
        float ya = relu_pow(load_y(y, y_bf16, yf + s0 * y_src + k), p2);
        if (conserve_last && s0 == S - 1) ya += eps;
        const float ma = ya / dk;
        float ar = ma * mr, ai = ma * mi, br = 0.f, bi = 0.f;
        if (has1) {
          float yb = relu_pow(load_y(y, y_bf16, yf + s1 * y_src + k), p2);
          if (conserve_last && s1 == S - 1) yb += eps;
          const float mb = yb / dk;
          br = mb * mr;
          bi = mb * mi;
        }
        if (k == 0 || k == half) {  // irfft ignores DC / Nyquist imaginary parts
          ai = 0.f;
          bi = 0.f;
        }
        const int k0 = kPow2 ? __brev(k) >> (32 - log2n) : k;
        buf[k0] = make_float2(ar - bi, ai + br);
        if (k != 0 && k != half) {
          const int k1 = kPow2 ? __brev(nfft - k) >> (32 - log2n) : nfft - k;
          buf[k1] = make_float2(ar + bi, br - ai);
        }
      }
      __syncthreads();
      // iterative radix-2 decimation-in-time, +i sign, natural-order output
      // (no stages when log2n is 0: the direct sum reads buf as it is)
      for (int lg = 1; lg <= log2n; ++lg) {
        const int hl = 1 << (lg - 1);
        const int tw_stride = nfft >> lg;
        for (int b = tid; b < half; b += kThreads) {
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
      // windowed overlap-add into the owned hop rows: sample t of frame f
      // lands on hop row f + t / hop
      for (int t = tid; t < nfft; t += kThreads) {
        const int row = f + t / hop - j0;
        if (row >= 0 && row < rows) {
          const float wv = win_over_n[t];
          float2 z;
          if (kPow2) {
            z = buf[t];
          } else {  // z = sum_k buf[k] e^{+2 pi i k t / N}
            z = make_float2(0.f, 0.f);
            int idx = 0;
            for (int k = 0; k < nfft; ++k) {
              const float2 w = tw[idx];
              const float2 u = buf[k];
              z.x += u.x * w.x - u.y * w.y;
              z.y += u.x * w.y + u.y * w.x;
              idx += t;
              if (idx >= nfft) idx -= nfft;
            }
          }
          const int off = row * hop + t % hop;
          acc[s0 * rows_per_block * hop + off] += z.x * wv;
          if (has1) acc[s1 * rows_per_block * hop + off] += z.y * wv;
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // epilogue: window-power normalization, W/2 front trim, optional PCM16
  const long long front = nfft / 2;
  for (int i = tid; i < S * rows * hop; i += kThreads) {
    const int s = i / (rows * hop);
    const int rem = i - s * rows * hop;
    const int r = rem / hop;
    const int q = rem - r * hop;
    const long long nabs = (long long)(j0 + r) * hop + q;
    const long long tpos = nabs - front;
    if (tpos < 0 || tpos >= length) continue;
    const float v = acc[(s * rows_per_block + r) * hop + q] * inv_norm[nabs];
    const long long o = ((long long)n * S + s) * length + tpos;
    if (out_int16) {
      const float qv = fminf(fmaxf(rintf(v * 32768.f), -32768.f), 32767.f);
      static_cast<int16_t*>(out)[o] = (int16_t)qv;
    } else {
      static_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int wiener_istft_launch(
    const void* y, int y_bf16, const void* re, const void* im,
    const void* win_over_n, const void* inv_norm, void* out, int out_int16,
    int nt, int S, int nf, int nfft, int hop, int length, int rows_per_block,
    int p2, float eps, int conserve_last, void* stream) {
  if (nfft < 2 || nfft % 2 != 0 || hop < 1 || nfft % hop != 0)
    return (int)cudaErrorInvalidValue;
  int log2n = 0;
  while ((1 << log2n) < nfft) ++log2n;
  const int half = nfft / 2;
  if ((1 << log2n) != nfft) log2n = 0;  // not a power of two: direct sum
  const int tw_len = log2n ? half : nfft;
  const int bins = half + 1;
  const int total_rows = nf + nfft / hop - 1;
  const int nblk = (total_rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)tw_len * sizeof(float2) + (size_t)nfft * sizeof(float2) +
                      (size_t)bins * sizeof(float) +
                      (size_t)S * rows_per_block * hop * sizeof(float);
  auto kern = log2n ? wiener_istft_kernel<true> : wiener_istft_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nblk, nt);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, y_bf16, static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(win_over_n), static_cast<const float*>(inv_norm),
      out, out_int16, S, nf, nfft, log2n, tw_len, hop, length, rows_per_block, p2, eps,
      conserve_last);
  return (int)cudaGetLastError();
}
