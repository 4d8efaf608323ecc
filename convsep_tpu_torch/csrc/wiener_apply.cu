// Generalized Wiener mask x mixture spectrum, for Hopper (sm_90a).
//
// Replaces convsep_tpu/dsp/pallas/wiener_kernel.py::wiener_apply_pallas
// (_kernel). For y (S, F, B) source magnitudes (float32 or bfloat16) and the
// mixture's re, im (F, B):
//
//   d        = ((relu(y_0)^p + relu(y_1)^p) + ...) + eps     float32
//   est_s    = (relu(y_s)^p / d) * (re, im)                  (S, F, B) x 2
//
// What bounds it on the H100: device-memory bytes (S y values and re, im in,
// 2 S values out per bin; a handful of flops each). One thread per bin, so
// neighbouring threads touch neighbouring addresses; the S masks never
// reach device memory.
//
// Every operation is rounded on its own (__fadd_rn etc.: nvcc would
// otherwise contract into FMAs), in the order the plain version
// (dsp/cuda/wiener_kernel.py::wiener_apply_plain) takes, so the two agree
// bit for bit for p in {1, 2}; another p goes through powf.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float relu_pow(const void* y, int bf16, long long idx, int pmode,
                                          float p) {
  float v = bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(y)[idx])
                 : static_cast<const float*>(y)[idx];
  v = v > 0.f ? v : 0.f;
  if (pmode == 1) return __fmul_rn(v, v);
  if (pmode == 2) return powf(v, p);
  return v;
}

__global__ void __launch_bounds__(kThreads) wiener_apply_kernel(
    const void* __restrict__ y, int y_bf16, const float* __restrict__ re,
    const float* __restrict__ im, float* __restrict__ out_re, float* __restrict__ out_im,
    int S, long long n, int pmode, float p, float eps) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float d = relu_pow(y, y_bf16, i, pmode, p);
    for (int s = 1; s < S; ++s) d = __fadd_rn(d, relu_pow(y, y_bf16, s * n + i, pmode, p));
    d = __fadd_rn(d, eps);
    const float mr = re[i];
    const float mi = im[i];
    for (int s = 0; s < S; ++s) {
      const float m = __fdiv_rn(relu_pow(y, y_bf16, s * n + i, pmode, p), d);
      out_re[s * n + i] = __fmul_rn(m, mr);
      out_im[s * n + i] = __fmul_rn(m, mi);
    }
  }
}

}  // namespace

// pmode: 0 for p = 1, 1 for p = 2, 2 for any other p (powf)
extern "C" int wiener_apply_launch(const void* y, int y_bf16, const void* re, const void* im,
                                   void* out_re, void* out_im, int S, long long n, int pmode,
                                   float p, float eps, void* stream) {
  if (S < 1 || n < 1 || pmode < 0 || pmode > 2) return (int)cudaErrorInvalidValue;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < (1LL << 30) ? want : (1LL << 30));
  wiener_apply_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_bf16, static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<float*>(out_re), static_cast<float*>(out_im), S, n, pmode, p, eps);
  return (int)cudaGetLastError();
}
