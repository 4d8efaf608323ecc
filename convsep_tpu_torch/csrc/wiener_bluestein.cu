// The Wiener+iSTFT's Bluestein instances, for Hopper (sm_90a):
// wiener_bluestein_kernel<LOG2M, kFramePairs> for every M from 64 on the
// FFT core to 16 384 on the level, and the level's frame pairs, on
// wiener_common.cuh::wiener_bluestein_block. wiener_istft.cu's header says
// what the kernel computes, what bounds it and how it is built; its
// wiener_istft_launch routes the even sizes up to 8192 that neither the core
// nor the split takes here. A translation unit of its own, so that nvcc
// builds its 10 instances beside wiener_istft.cu's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wiener_common.cuh"

namespace {

using namespace wiener;

// Bluestein's least M here: N 18, the least even size off the core and the split
constexpr int kMinLog2M = 6;

template <int LOG2M, bool kFramePairs>
__global__ void __launch_bounds__(kMaxThreads) wiener_bluestein_kernel(
    Args a, const float2* __restrict__ chirp, const float2* __restrict__ chat, int nfft,
    int rounds) {
  extern __shared__ float4 smem4[];
  wiener_bluestein_block<LOG2M, false, kFramePairs>(smem4, a, chirp, chat, nfft, rounds);
}

template <int LOG2M, bool kFramePairs>
cudaError_t launch_instance(const Args& a, const float2* chirp, const float2* chat, int nfft,
                            unsigned blocks, int groups, int rounds, cudaStream_t stream) {
  const size_t smem = wiener_bluestein_smem_bytes(LOG2M, nfft, a.hop, groups, kFramePairs ? 1 : 2);
  cudaError_t err = cudaFuncSetAttribute(wiener_bluestein_kernel<LOG2M, kFramePairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wiener_bluestein_kernel<LOG2M, kFramePairs><<<blocks, groups * bluestein_threads(LOG2M), smem,
                                                stream>>>(a, chirp, chat, nfft, rounds);
  return cudaGetLastError();
}

template <int LOG2M = kMinLog2M>
cudaError_t dispatch(int log2m, bool frame_pairs, const Args& a, const float2* chirp,
                     const float2* chat, int nfft, unsigned blocks, int groups, int rounds,
                     cudaStream_t stream) {
  if constexpr (LOG2M > kLevelLog2) {
    return cudaErrorInvalidValue;
  } else {
    if (log2m == LOG2M) {
      if constexpr (LOG2M == kLevelLog2) {
        if (frame_pairs)
          return launch_instance<LOG2M, true>(a, chirp, chat, nfft, blocks, groups, rounds,
                                              stream);
      }
      return launch_instance<LOG2M, false>(a, chirp, chat, nfft, blocks, groups, rounds, stream);
    }
    return dispatch<LOG2M + 1>(log2m, frame_pairs, a, chirp, chat, nfft, blocks, groups, rounds,
                               stream);
  }
}

}  // namespace

namespace wiener {

// M = 2^log2m = fft_common::bluestein_log2(nfft) <= 16 384; frame_pairs only
// on the level; a.tw the M-point quarter table, chirp (nfft) and chat (M)
// fft_plan.bluestein_tables; blocks, groups and rounds as
// wiener_istft_launch computes them.
cudaError_t launch_bluestein(int log2m, bool frame_pairs, const Args& a, const float2* chirp,
                             const float2* chat, int nfft, unsigned blocks, int groups,
                             int rounds, cudaStream_t stream) {
  return dispatch(log2m, frame_pairs, a, chirp, chat, nfft, blocks, groups, rounds, stream);
}

}  // namespace wiener
