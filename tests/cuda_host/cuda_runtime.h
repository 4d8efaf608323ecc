// A host stand-in for <cuda_runtime.h>: just enough of CUDA for the device
// code of convsep_tpu_torch/csrc/fft_common.cuh to compile with g++ and run
// on CPU threads, one std::thread per CUDA thread, one barrier a block
// (__syncthreads). __syncwarp is not emulated, so only code that
// synchronizes whole blocks runs here (the mixed-radix split, forward and
// inverse, Bluestein at kBlockSync, and the cluster's blocks). A cluster's
// blocks run at once (emulate_cluster), each with its own shared memory,
// cluster_sync a barrier of all their threads and peer() the address in
// another block's shared memory. Used by tests/test_torch_fft_host.py.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <deque>
#include <functional>
#include <limits>
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
inline thread_local std::barrier<>* block_barrier = nullptr;
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
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, b, t] {
        block_barrier = &bar;
        blockIdx.x = b;
        threadIdx.x = t;
        fn();
      });
    for (auto& t : ts) t.join();
  }
}

// ---- clusters ---------------------------------------------------------------

inline std::barrier<>* cluster_barrier = nullptr;
inline std::vector<std::vector<float4>>* cluster_smem = nullptr;  // a block's each
inline thread_local float4* block_smem = nullptr;                 // this thread's block's

inline void cluster_sync() { cluster_barrier->arrive_and_wait(); }

// p (in this block's shared memory) at the same offset in block `rank`'s
template <class T>
inline T* peer(T* p, int rank) {
  const auto off = reinterpret_cast<const char*>(p) - reinterpret_cast<const char*>(block_smem);
  return reinterpret_cast<T*>(reinterpret_cast<char*>((*cluster_smem)[rank].data()) + off);
}

// Run fn as `clusters` clusters of c blocks of `threads` threads, a cluster
// at a time, its blocks at once: block r of cluster q is blockIdx.x = q c +
// r, with `smem_bytes` of shared memory of its own (filled with NaN: a read
// of what no thread wrote shows in the output), which fn reaches through
// block_smem.
inline void emulate_cluster(int clusters, int c, int threads, size_t smem_bytes,
                            const std::function<void()>& fn) {
  blockDim.x = threads;
  const float nan = std::numeric_limits<float>::quiet_NaN();
  for (int q = 0; q < clusters; ++q) {
    std::vector<std::vector<float4>> smem(c, std::vector<float4>((smem_bytes + 15) / 16,
                                                                 float4{nan, nan, nan, nan}));
    std::deque<std::barrier<>> bars;
    for (int r = 0; r < c; ++r) bars.emplace_back(threads);
    std::barrier<> all(c * threads);
    cluster_barrier = &all;
    cluster_smem = &smem;
    std::vector<std::thread> ts;
    for (int r = 0; r < c; ++r)
      for (int t = 0; t < threads; ++t)
        ts.emplace_back([&, q, r, t] {
          block_barrier = &bars[r];
          block_smem = smem[r].data();
          blockIdx.x = q * c + r;
          threadIdx.x = t;
          fn();
        });
    for (auto& t : ts) t.join();
  }
}
