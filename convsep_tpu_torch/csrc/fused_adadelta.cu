// One-pass Lasagne adadelta update of one float32 parameter leaf, with the
// leaf's gradient square-sum, for Hopper (sm_90a).
//
// Replaces convsep_tpu/train/fused_optim.py::fused_adadelta_apply (_kernel).
// For every element, in place, in the reference's operation order
// (train/optim.py):
//
//   a = rho * a + (1 - rho) * g * g
//   u = g * sqrt(d + eps) / sqrt(a + eps)
//   d = rho * d + (1 - rho) * u * u
//   p = p - lr * u
//
// Every operation rounds on its own (__fmul_rn and friends, which nvcc never
// contracts into an FMA; IEEE square root and division), as PyTorch's
// elementwise operations round them, so p, a and d equal the plain version's
// bit for bit. (1 - rho) arrives from the host as its own float, as the
// plain version's Python scalar does.
//
// What bounds it on the H100: device memory. Per element it reads p, g, a, d
// and writes p, a, d, 28 bytes; the dsd100 leaves (fc_expand 66.4 M and fc
// 16.6 M elements) move 2.3 GB a step, about 0.7 ms at 3.35 TB/s. The plain
// version runs about a dozen elementwise passes, each reading and writing
// whole leaves.
//
// Design: a grid-stride loop over float4 (when all four pointers are 16-byte
// aligned) with a scalar tail. The square-sum accumulates in double per
// thread and is reduced in a fixed order: warp shuffles, then the block's
// warps into one partial per block, then a second one-block launch sums the
// partials in a fixed order. The block count depends on n only, so the sum
// is deterministic: no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // the wrapper's partial buffer holds this many

struct Hyper {
  float lr, rho, omr, eps;  // omr = 1 - rho, rounded from the host's double
};

__device__ __forceinline__ void update(float& p, float g, float& a, float& d, const Hyper& h) {
  const float a2 = __fadd_rn(__fmul_rn(h.rho, a), __fmul_rn(__fmul_rn(h.omr, g), g));
  const float u =
      __fdiv_rn(__fmul_rn(g, __fsqrt_rn(__fadd_rn(d, h.eps))), __fsqrt_rn(__fadd_rn(a2, h.eps)));
  d = __fadd_rn(__fmul_rn(h.rho, d), __fmul_rn(__fmul_rn(h.omr, u), u));
  a = a2;
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

__device__ __forceinline__ double block_sum(double v, double* warp_s) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) warp_s[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t += warp_s[w];
  return t;  // meaningful in thread 0 only
}

__global__ void __launch_bounds__(kThreads) adadelta_kernel(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ a,
    float* __restrict__ d, long long n, int vec, Hyper h, double* __restrict__ partial) {
  __shared__ double warp_s[kThreads / 32];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  double sq = 0.0;
  long long done = 0;
  if (vec) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* a4 = reinterpret_cast<float4*>(a);
    float4* d4 = reinterpret_cast<float4*>(d);
    const long long n4 = n / 4;
    for (long long i = i0; i < n4; i += stride) {
      float4 pv = p4[i], av = a4[i], dv = d4[i];
      const float4 gv = __ldg(g4 + i);
      update(pv.x, gv.x, av.x, dv.x, h);
      update(pv.y, gv.y, av.y, dv.y, h);
      update(pv.z, gv.z, av.z, dv.z, h);
      update(pv.w, gv.w, av.w, dv.w, h);
      sq = fma((double)gv.x, (double)gv.x, sq);
      sq = fma((double)gv.y, (double)gv.y, sq);
      sq = fma((double)gv.z, (double)gv.z, sq);
      sq = fma((double)gv.w, (double)gv.w, sq);
      p4[i] = pv;
      a4[i] = av;
      d4[i] = dv;
    }
    done = n4 * 4;
  }
  for (long long i = done + i0; i < n; i += stride) {
    float pv = p[i], av = a[i], dv = d[i];
    const float gv = __ldg(g + i);
    update(pv, gv, av, dv, h);
    sq = fma((double)gv, (double)gv, sq);
    p[i] = pv;
    a[i] = av;
    d[i] = dv;
  }
  const double t = block_sum(sq, warp_s);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

__global__ void __launch_bounds__(kThreads) sum_partials_kernel(
    const double* __restrict__ partial, int count, float* __restrict__ out) {
  __shared__ double warp_s[kThreads / 32];
  double v = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) v += partial[i];
  const double t = block_sum(v, warp_s);
  if (threadIdx.x == 0) out[0] = (float)t;
}

}  // namespace

extern "C" int fused_adadelta_launch(void* p, const void* g, void* a, void* d, long long n,
                                     float lr, float rho, float one_minus_rho, float eps,
                                     void* partial, void* sq, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<unsigned long long>(p) |
                     reinterpret_cast<unsigned long long>(g) |
                     reinterpret_cast<unsigned long long>(a) |
                     reinterpret_cast<unsigned long long>(d)) & 15ull) == 0;
  const long long want = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adadelta_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<float*>(p), static_cast<const float*>(g), static_cast<float*>(a),
      static_cast<float*>(d), n, (int)vec, Hyper{lr, rho, one_minus_rho, eps},
      static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kThreads, 0, s>>>(static_cast<const double*>(partial), blocks,
                                             static_cast<float*>(sq));
  return (int)cudaGetLastError();
}
