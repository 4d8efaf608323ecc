// A host stand-in for <cuda_runtime.h>: just enough of CUDA for the device
// code of convsep_tpu_torch/csrc/fft_common.cuh to compile with g++ and run
// on CPU threads, one std::thread per CUDA thread, one barrier a block
// (__syncthreads). __syncwarp is not emulated, so only code that
// synchronizes whole blocks runs here (the mixed-radix split, forward and
// inverse, and Bluestein at kBlockSync). Used by tests/test_torch_fft_host.py.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(x)
#define __restrict__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
typedef int cudaError_t;
constexpr int cudaSuccess = 0;

// Run fn as a grid of `blocks` blocks of `threads` threads, a block at a time.
inline void emulate(int blocks, int threads, const std::function<void()>& fn) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> bar(threads);
    block_barrier = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        fn();
      });
    for (auto& t : ts) t.join();
  }
}
