// The Wiener+iSTFT's mixed-radix split instances, for Hopper (sm_90a):
// wiener_split_kernel<LOG2P, M> for every nfft = M 2^LOG2P (M 3, 5, 9, 15,
// 2^LOG2P >= 16, nfft <= 8192) on wiener_common.cuh::wiener_split_block.
// wiener_istft.cu's header says what the kernel computes, what bounds it and
// how it is built; its wiener_istft_launch routes these sizes here. A
// translation unit of its own, so that nvcc builds its 27 instances beside
// wiener_istft.cu's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wiener_common.cuh"

namespace {

using namespace wiener;

template <int LOG2P, int M>
__global__ void __launch_bounds__(kMaxThreads) wiener_split_kernel(
    Args a, const float2* __restrict__ tw_n, int rounds) {
  extern __shared__ float4 smem4[];
  wiener_split_block<LOG2P, M>(smem4, a, tw_n, rounds);
}

template <int LOG2P, int M>
cudaError_t launch_instance(const Args& a, const float2* tw_n, unsigned blocks, int groups,
                            int rounds, cudaStream_t stream) {
  const size_t smem = wiener_split_smem_bytes(LOG2P, M, a.hop, groups);
  cudaError_t err = cudaFuncSetAttribute(wiener_split_kernel<LOG2P, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wiener_split_kernel<LOG2P, M><<<blocks, groups * M * fft_threads(LOG2P), smem, stream>>>(
      a, tw_n, rounds);
  return cudaGetLastError();
}

// The split's instances: every 2^a (16 <= 2^a, m 2^a <= 8192) for each m.
template <int M, int LOG2P = kMinLog2>
cudaError_t dispatch(int log2p, const Args& a, const float2* tw_n, unsigned blocks, int groups,
                     int rounds, cudaStream_t stream) {
  if constexpr ((M << LOG2P) > (1 << kMaxLog2)) {
    return cudaErrorInvalidValue;
  } else {
    if (log2p == LOG2P) return launch_instance<LOG2P, M>(a, tw_n, blocks, groups, rounds, stream);
    return dispatch<M, LOG2P + 1>(log2p, a, tw_n, blocks, groups, rounds, stream);
  }
}

}  // namespace

namespace wiener {

// nfft = m 2^log2p (fft_common::split_sizes); a.tw the 2^log2p-point quarter
// table, tw_n the nfft-point one; blocks, groups of m 2^log2p / 16 threads
// and rounds as wiener_istft_launch computes them.
cudaError_t launch_split(int m, int log2p, const Args& a, const float2* tw_n, unsigned blocks,
                         int groups, int rounds, cudaStream_t stream) {
  switch (m) {
    case 3: return dispatch<3>(log2p, a, tw_n, blocks, groups, rounds, stream);
    case 5: return dispatch<5>(log2p, a, tw_n, blocks, groups, rounds, stream);
    case 9: return dispatch<9>(log2p, a, tw_n, blocks, groups, rounds, stream);
    case 15: return dispatch<15>(log2p, a, tw_n, blocks, groups, rounds, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wiener
