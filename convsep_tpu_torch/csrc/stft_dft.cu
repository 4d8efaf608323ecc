// The STFT of the training step and the fft_impl="pallas" separation route,
// for Hopper (sm_90a): framing with the W/2 front pad, window and a real FFT
// (stft_fft_kernel for powers of two, stft_split_kernel for m 2^a, m in
// {3, 5, 9, 15}, stft_bluestein_kernel for any other nfft <= 8192,
// stft_cluster_kernel past 8192 up to 65 536, the stft_level2_* kernels up
// to 262 144), and the dense DFT (stft_dft_kernel) for the sizes past those.
//
// Replaces convsep_tpu/dsp/pallas/stft_kernel.py::stft_pallas (_kernel). For
// signal b, frame f and bin c < nfft / 2 + 1:
//
//   X[b, f, c] = sum_{t < W} x[b, f hop + t - W / 2] win[t] e^{-2 pi i c t / nfft}
//
// with x read as zero outside [0, L): the W / 2 front pad and the tail pad of
// stft_matmul's framing, applied by guards instead of a padded copy.
//
// What bounds it on the H100: device-memory bytes. The dsd100 training step
// takes the STFT of 32 mixtures and 128 stems of 14 336 samples (nf 30, W
// 1024, 513 bins): 9.2 MB read and 19.7 MB written, 8.6 us at 3.35 TB/s,
// while the FFT's 1.2e8 operations are 1.8 us at 67 TFLOP/s in float32. The
// dense DFT this file first held did 10.1 GFLOP for the same step (0.15 ms
// at best on the CUDA cores) and read 4.2 MB of window-folded cos / sin
// matrices: no tiling of it comes near the bound.
//
// Design (stft_fft_kernel, powers of two 2^4 .. 2^13): fft_common.cuh. A
// block loads the signal span of its 2 G frames once with 16-byte loads
// (guards give the pads and the zeros past W), and each of its G groups of
// nfft / 16 threads runs one register-resident Stockham FFT that carries two
// frames, then writes both frames' rows, Nyquist bin included, coalesced by
// bin. The twiddles come from a float32 quarter table made once on the host
// and copied into shared memory by each block. G is
// chosen on the host (fft_plan.stft_plan) so that a shape fills the card:
// B 32 x 30 frames at 1024 points runs one FFT per block (480 blocks), B 128
// four (512 blocks), the dsd100 separation track's 2882 frames four (361).
//
// stft_split_kernel (nfft = m 2^a, m in {3, 5, 9, 15}, 2^a >= 16, nfft <=
// 8192: frame sizes such as 768, 1280, 1536, 2304, 3072; no preset uses one)
// is the same design on the core's mixed-radix split (fft_common.cuh::
// stft_split_block): m interleaved 2^a-point FFTs read at stride m from the
// staged span, the twiddles e^{-2 pi i n1 k1 / nfft} from a second quarter
// table in shared memory, 2^a m-point DFTs in registers across the exchange
// buffer. A transform is a group of nfft / 16 threads; the block (whole
// warps, fft_plan.split_plan) synchronizes as a whole. At W 768, hop 256, B
// 32 (58 frames x 385 bins) it does about 0.04 GFLOP against the dense
// DFT's 2.2 and is bound by its 7.5 MB of device-memory bytes (2.2 us); on
// an H100 at 700 W it takes 8.5 us, against torch.stft's 12.8 and the dense
// kernel's 170 (PERF.md, row 6').
//
// stft_bluestein_kernel (nfft <= 8192 that neither the core nor the split
// takes: 1000 = 8 x 125, 7 x 256, 25 x 64, 6000, odd sizes; no preset uses
// one) is Bluestein's chirp-z over the core (fft_common.cuh::
// stft_bluestein_block): per pair of frames a forward and an inverse FFT of
// M = 2^ceil(log2(2 nfft - 1)) points and two chirp products; past 4096
// points M is 16 384, the level (fft_common.cuh::Level: one 512-thread group
// a block, two 8192-point runs of the core and a radix-2 stage a transform,
// the frames read straight from global memory, as the span no longer fits
// beside the tables and the exchange buffer). At W 1000,
// hop 250, B 32 (60 frames x 501 bins) its bound is bytes: 9.5 MB, 2.84 us,
// where the dense DFT below does 3.8 GFLOP and reads 4.0 MB of matrices. The
// design keeps the bytes at the bound's: the span is loaded once a block
// with 16-byte loads, the chirp (nfft float2) and the convolution's chirp
// spectrum (M float2) are made once on the host in float64
// (fft_plan.bluestein_tables) and read through L1 (16 + 32 KB at W 1000,
// shared by every block; a copy in shared memory measured slower), the rows
// are written coalesced by bin; the two transforms' points cross threads
// only in shared memory, behind each group's own barriers.
//
// stft_cluster_kernel (8192 < nfft <= 65 536: 12 288, 20 000, 40 000, odd
// sizes; no preset uses one) is Bluestein over a thread-block cluster
// (fft_common.cuh::stft_cluster_block): M = 32 768, 65 536 or 131 072
// points no longer fit one block's 227 KB, so a cluster of C = M / 8192
// blocks (4, 8 or 16: 16 past the portable limit, which the kernel allows
// before its launch) holds them, each block one 512-thread group
// running the core's 8192-point transform on its part in 87 KB of shared
// memory. The forward transform is decimation in frequency with its radix-C
// first stage fed straight from the frames in global memory, so its output
// Y[C k + r] is already in block r; the product with the chirp spectrum is
// in place; the inverse is decimation in time over each block's own points,
// and its radix-C combine is read through distributed shared memory where
// it is consumed (by the bins' writers): one exchange a transform pair,
// one cluster barrier before it and one before the blocks exit. At W 12
// 288, hop 3072, B 32 (7 frames x 6145 bins) the bound is bytes, 12.8 MB
// and 3.8 us, where the dense kernel below reads 604 MB of matrices; at W
// 40 000, hop 10 000, B 32 (4 frames x 20 001 bins, 16 blocks a cluster)
// 12.0 MB and 3.6 us, where the dense kernel reads 6.4 GB.
//
// The stft_level2_* kernels (65 536 < nfft <= 262 144: 70 000, 131 072,
// odd sizes; no preset uses one) are Bluestein on the core's second level
// (fft_common.cuh::level2_first, level2_middle, level2_last): M = 262 144 or
// 524 288 points no cluster holds, so a pair's convolution lives in a
// scratch of M float2 in device memory, R = M / 8192 rows: phase A a
// radix-R DFT in registers a column (the pre-chirped frames read straight
// from the signal), phase B/C one 512-thread block a row (the core's
// 8192-point transform, the chirp spectrum's product, the transform again),
// phase D the radix-R combine a column (the post-chirp on the stores), then
// the split into the two frames' bins; four launches a round of pairs, the
// round's scratch within half the L2 (fft_plan.level2_plan), so each
// phase reads back from the L2 what the one before wrote. At W 70 000, hop
// 17 500, B 32 (96 frames x 35 001 bins) its bound is bytes, 28.7 MB and
// 8.6 us, where the dense kernel reads 19.6 GB of matrices.
//
// stft_dft_kernel (the sizes past those: nfft > 262 144; and any nfft
// through stft_dft_pallas) multiplies frames built from
// hop rows staged in shared memory by the (W, bins) window-folded cos / -sin
// matrices: a block owns 32 frames x 64 bins of one signal and every thread
// accumulates 2 frames x 4 bins of re and of im in registers.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

using namespace fft_common;

// re / im rows (B nf, nfft / 2 + 1), the Nyquist bin included
struct FullRows {
  float* re;
  float* im;
  int bins;
  __device__ __forceinline__ void operator()(long long row, bool has_b, int k, float2 a,
                                             float2 b) const {
    const long long o = row * bins + k;
    re[o] = a.x;
    im[o] = a.y;
    if (has_b) {
      re[o + bins] = b.x;
      im[o + bins] = b.y;
    }
  }
};

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads) stft_fft_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    float* __restrict__ re, float* __restrict__ im, int L, int W, int hop, int nf) {
  stft_block<LOG2N>(x, win, tw, L, W, hop, nf, FullRows{re, im, (1 << LOG2N) / 2 + 1});
}

template <int LOG2N>
cudaError_t launch_fft(const float* x, const float* win, const float2* tw, float* re, float* im,
                       int B, int L, int W, int hop, int nf, int ffts, cudaStream_t stream) {
  const size_t smem = smem_bytes(LOG2N, W, hop, ffts);
  cudaError_t err = cudaFuncSetAttribute(stft_fft_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((nf + 2 * ffts - 1) / (2 * ffts));
  stft_fft_kernel<LOG2N><<<(unsigned)blocks, ffts * fft_threads(LOG2N), smem, stream>>>(
      x, win, tw, re, im, L, W, hop, nf);
  return cudaGetLastError();
}

template <int LOG2P, int M>
__global__ void __launch_bounds__(kMaxThreads) stft_split_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw_p,
    const float2* __restrict__ tw_n, float* __restrict__ re, float* __restrict__ im, int L,
    int W, int hop, int nf) {
  stft_split_block<LOG2P, M>(x, win, tw_p, tw_n, L, W, hop, nf,
                             FullRows{re, im, (M << LOG2P) / 2 + 1});
}

template <int LOG2P, int M>
cudaError_t launch_split(const float* x, const float* win, const float2* tw_p,
                         const float2* tw_n, float* re, float* im, int B, int L, int W, int hop,
                         int nf, int ffts, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(LOG2P, M, W, hop, ffts);
  cudaError_t err = cudaFuncSetAttribute(stft_split_kernel<LOG2P, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((nf + 2 * ffts - 1) / (2 * ffts));
  stft_split_kernel<LOG2P, M><<<(unsigned)blocks, ffts * M * fft_threads(LOG2P), smem, stream>>>(
      x, win, tw_p, tw_n, re, im, L, W, hop, nf);
  return cudaGetLastError();
}

// The split's instances: every 2^a (16 <= 2^a, m 2^a <= 8192) for each m.
template <int M, int LOG2P = kMinLog2>
cudaError_t dispatch_split(int log2p, const float* x, const float* win, const float2* tw_p,
                           const float2* tw_n, float* re, float* im, int B, int L, int W,
                           int hop, int nf, int ffts, cudaStream_t stream) {
  if constexpr ((M << LOG2P) > (1 << kMaxLog2)) {
    return cudaErrorInvalidValue;
  } else {
    if (log2p == LOG2P)
      return launch_split<LOG2P, M>(x, win, tw_p, tw_n, re, im, B, L, W, hop, nf, ffts, stream);
    return dispatch_split<M, LOG2P + 1>(log2p, x, win, tw_p, tw_n, re, im, B, L, W, hop, nf,
                                        ffts, stream);
  }
}

template <int LOG2M>
__global__ void __launch_bounds__(kMaxThreads) stft_bluestein_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ chat, float* __restrict__ re,
    float* __restrict__ im, int L, int W, int hop, int nf, int nfft) {
  stft_bluestein_block<LOG2M, false>(x, win, tw, chirp, chat, L, W, hop, nf, nfft,
                                     FullRows{re, im, nfft / 2 + 1});
}

template <int LOG2M>
cudaError_t launch_bluestein(const float* x, const float* win, const float2* tw,
                             const float2* chirp, const float2* chat, float* re, float* im, int B,
                             int L, int W, int hop, int nf, int nfft, int ffts,
                             cudaStream_t stream) {
  const size_t smem = bluestein_smem_bytes(LOG2M, W, hop, ffts);
  cudaError_t err = cudaFuncSetAttribute(stft_bluestein_kernel<LOG2M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((nf + 2 * ffts - 1) / (2 * ffts));
  stft_bluestein_kernel<LOG2M><<<(unsigned)blocks, ffts * bluestein_threads(LOG2M), smem,
                                 stream>>>(
      x, win, tw, chirp, chat, re, im, L, W, hop, nf, nfft);
  return cudaGetLastError();
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads) stft_cluster_kernel(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ chat, float* __restrict__ re,
    float* __restrict__ im, int L, int W, int hop, int nf, int nfft) {
  extern __shared__ float4 smem4[];
  stft_cluster_block<kMaxLog2, C>(smem4, x, win, tw, chirp, chat, L, W, hop, nf, nfft,
                                  FullRows{re, im, nfft / 2 + 1});
}

// one cluster of C blocks a pair of frames, the blocks of a cluster
// consecutive in x
template <int C>
cudaError_t launch_cluster(const float* x, const float* win, const float2* tw,
                           const float2* chirp, const float2* chat, float* re, float* im, int B,
                           int L, int W, int hop, int nf, int nfft, cudaStream_t stream) {
  return launch_clusters<C>(stft_cluster_kernel<C>, (long long)B * ((nf + 1) / 2),
                            cluster_smem_bytes(kMaxLog2, 0), stream, nullptr, x, win, tw, chirp,
                            chat, re, im, L, W, hop, nf, nfft);
}

// ---- the second level (nfft past 65 536): fft_common.cuh's phases --------

template <int LOG2M>
__global__ void __launch_bounds__(kLevel2Threads) stft_level2_first_kernel(
    const Level2Frames fr, const float2* __restrict__ tw, float2* __restrict__ scratch,
    int pair0) {
  const int g = 2 * (pair0 + (int)blockIdx.y);  // the pair's frame a
  level2_first<LOG2M>([&](int t) { return fr(g, t); },
                      scratch + ((long long)blockIdx.y << LOG2M), tw,
                      blockIdx.x * kLevel2Threads + threadIdx.x);
}

template <int LOG2M>
__global__ void __launch_bounds__(kMaxThreads) stft_level2_middle_kernel(
    float2* __restrict__ scratch, const float2* __restrict__ tw,
    const float2* __restrict__ chat) {
  extern __shared__ float4 smem4[];
  const long long row = (long long)blockIdx.x << kMaxLog2;  // r P
  level2_middle<LOG2M>(smem4, scratch + ((long long)blockIdx.y << LOG2M) + row, tw, chat + row,
                       blockIdx.x);
}

// D, then X[t] = chirp[t] conj Z[t] for t < N in place
template <int LOG2M>
__global__ void __launch_bounds__(kLevel2Threads) stft_level2_last_kernel(
    float2* scratch, const float2* __restrict__ tw, const float2* __restrict__ chirp, int N) {
  float2* xs = scratch + ((long long)blockIdx.y << LOG2M);
  level2_last<LOG2M>(xs, tw, blockIdx.x * kLevel2Threads + threadIdx.x, [&](int t, float2 z) {
    if (t < N) xs[t] = cmul(__ldg(chirp + t), make_float2(z.x, -z.y));
  });
}

template <int LOG2M>
__global__ void __launch_bounds__(kLevel2Threads) stft_level2_split_kernel(
    const float2* __restrict__ scratch, FullRows out, int N, int frames, int pair0) {
  const int k = blockIdx.x * kLevel2Threads + threadIdx.x;
  const int g = 2 * (pair0 + (int)blockIdx.y);
  if (k <= N / 2)
    level2_split(scratch + ((long long)blockIdx.y << LOG2M), N, k, g, g + 1 < frames, out);
}

// the pairs in rounds of `per_round`, each round's four phases on one stream,
// one scratch of M float2 a pair of the round
template <int LOG2M>
cudaError_t launch_level2(const Level2Frames& fr, const float2* tw, const float2* chirp,
                          const float2* chat, float2* scratch, FullRows out, int N,
                          int per_round, cudaStream_t stream) {
  constexpr int P = 1 << kMaxLog2, R = (1 << LOG2M) / P;
  cudaError_t err = cudaFuncSetAttribute(stft_level2_middle_kernel<LOG2M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         level2_middle_smem());
  if (err != cudaSuccess) return err;
  const int pairs = (fr.frames + 1) / 2;
  const unsigned split_blocks = (N / 2 + kLevel2Threads) / kLevel2Threads;
  for (int p0 = 0; p0 < pairs; p0 += per_round) {
    const unsigned n = (unsigned)min(per_round, pairs - p0);
    stft_level2_first_kernel<LOG2M><<<dim3(P / kLevel2Threads, n), kLevel2Threads, 0, stream>>>(
        fr, tw, scratch, p0);
    stft_level2_middle_kernel<LOG2M><<<dim3(R, n), kMaxThreads, level2_middle_smem(), stream>>>(
        scratch, tw, chat);
    stft_level2_last_kernel<LOG2M><<<dim3(P / kLevel2Threads, n), kLevel2Threads, 0, stream>>>(
        scratch, tw, chirp, N);
    stft_level2_split_kernel<LOG2M><<<dim3(split_blocks, n), kLevel2Threads, 0, stream>>>(
        scratch, out, N, fr.frames, p0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

constexpr int kThreads = 256;
constexpr int kTF = 32;  // frames per block: 16 thread rows of 2
constexpr int kTB = 64;  // bins per block: 16 thread columns of 4
constexpr int kHC = 32;  // hop columns per chunk

// Sample n = i * hop + h of frame f lies in hop row f + i, column h, so a
// tile of TF frames reads hop rows [f0, f0 + TF + k - 1), k = W / hop. The
// block walks the hop columns in chunks of HC: it stages that column chunk
// of its hop rows in shared memory, then for each row offset i the HC x TB
// tiles of cosw and sinw (rows i * hop + h). Frames past nf and bins past
// `bins` are computed from zeros and never stored.
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

// The FFT route: nfft a power of two in [2^4, 2^13], W <= nfft, `ffts`
// complex FFTs (2 ffts frames) per block, from fft_plan.stft_plan.
extern "C" int stft_fft_launch(const void* x, const void* win, const void* tw, void* re,
                               void* im, int B, int L, int W, int hop, int nf, int nfft,
                               int ffts, void* stream) {
  const int log2n = plan_log2(nfft);
  const int threads = log2n ? ffts * fft_threads(log2n) : 0;
  if (B < 1 || L < 1 || W < 2 || W > nfft || hop < 1 || W % hop != 0 || nf < 1 || !log2n ||
      ffts < 1 || threads > kMaxThreads || threads % 32 != 0 ||
      (fft_threads(log2n) > 32 && ffts > 8))
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(win);
  const auto* t = static_cast<const float2*>(tw);
  auto* r = static_cast<float*>(re);
  auto* i = static_cast<float*>(im);
  auto s = static_cast<cudaStream_t>(stream);
  switch (log2n) {
    case 4: return (int)launch_fft<4>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 5: return (int)launch_fft<5>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 6: return (int)launch_fft<6>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 7: return (int)launch_fft<7>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 8: return (int)launch_fft<8>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 9: return (int)launch_fft<9>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 10: return (int)launch_fft<10>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 11: return (int)launch_fft<11>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    case 12: return (int)launch_fft<12>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
    default: return (int)launch_fft<13>(xs, w, t, r, i, B, L, W, hop, nf, ffts, s);
  }
}

// The split route: nfft = m 2^a (m in {3, 5, 9, 15}, 16 <= 2^a, nfft <= 8192),
// W <= nfft, `ffts` transforms (2 ffts frames) per block, from
// fft_plan.split_plan; tw_p and tw_n the quarter tables of 2^a and nfft.
extern "C" int stft_split_launch(const void* x, const void* win, const void* tw_p,
                                 const void* tw_n, void* re, void* im, int B, int L, int W,
                                 int hop, int nf, int nfft, int ffts, void* stream) {
  int m, log2p;
  const bool sized = split_sizes(nfft, &m, &log2p);
  const int threads = sized ? ffts * (nfft / kPoints) : 0;
  if (B < 1 || L < 1 || W < 2 || W > nfft || hop < 1 || W % hop != 0 || nf < 1 || !sized ||
      ffts < 1 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(win);
  const auto* tp = static_cast<const float2*>(tw_p);
  const auto* tn = static_cast<const float2*>(tw_n);
  auto* r = static_cast<float*>(re);
  auto* i = static_cast<float*>(im);
  auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 3: return (int)dispatch_split<3>(log2p, xs, w, tp, tn, r, i, B, L, W, hop, nf, ffts, s);
    case 5: return (int)dispatch_split<5>(log2p, xs, w, tp, tn, r, i, B, L, W, hop, nf, ffts, s);
    case 9: return (int)dispatch_split<9>(log2p, xs, w, tp, tn, r, i, B, L, W, hop, nf, ffts, s);
    default:
      return (int)dispatch_split<15>(log2p, xs, w, tp, tn, r, i, B, L, W, hop, nf, ffts, s);
  }
}

// The Bluestein route: nfft <= 8192 (M = 2^ceil(log2(2 nfft - 1)) <= 16
// 384: the core up to 8192, the level at 16 384), W <= nfft, `ffts`
// transforms (2 ffts frames) per block (fft_plan.bluestein_plan; one on the
// level), chirp (nfft) and chat (M) from fft_plan.bluestein_tables, tw the
// M-point quarter table.
extern "C" int stft_bluestein_launch(const void* x, const void* win, const void* tw,
                                     const void* chirp, const void* chat, void* re, void* im,
                                     int B, int L, int W, int hop, int nf, int nfft, int ffts,
                                     void* stream) {
  const int log2m = nfft >= 2 ? bluestein_log2(nfft) : 0;
  const int t = log2m ? bluestein_threads(log2m) : 0;
  if (B < 1 || L < 1 || W < 2 || W > nfft || hop < 1 || W % hop != 0 || nf < 1 || !log2m ||
      log2m > kLevelLog2 ||
      ffts < 1 || ffts * t > kMaxThreads || ffts * t % 32 != 0 || (t > 32 && ffts > 8))
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(win);
  const auto* tws = static_cast<const float2*>(tw);
  const auto* cc = static_cast<const float2*>(chirp);
  const auto* ch = static_cast<const float2*>(chat);
  auto* r = static_cast<float*>(re);
  auto* i = static_cast<float*>(im);
  auto s = static_cast<cudaStream_t>(stream);
  switch (log2m) {
#define CASE(LG) \
  case LG: return (int)launch_bluestein<LG>(xs, w, tws, cc, ch, r, i, B, L, W, hop, nf, nfft, ffts, s);
    CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12) CASE(13)
#undef CASE
    default:
      return (int)launch_bluestein<kLevelLog2>(xs, w, tws, cc, ch, r, i, B, L, W, hop, nf, nfft,
                                               ffts, s);
  }
}

// The cluster route: 8192 < nfft <= 65 536 (M = 2^ceil(log2(2 nfft - 1)),
// 32 768, 65 536 or 131 072: a cluster of 4, 8 or 16 blocks of 512 threads
// a pair of frames, fft_plan.cluster_plan), W <= nfft, chirp (nfft) and chat
// (M) from fft_plan.bluestein_tables, tw the M-point quarter table.
extern "C" int stft_cluster_launch(const void* x, const void* win, const void* tw,
                                   const void* chirp, const void* chat, void* re, void* im, int B,
                                   int L, int W, int hop, int nf, int nfft, void* stream) {
  const int log2m = nfft >= 2 ? bluestein_log2(nfft) : 0;
  if (B < 1 || L < 1 || W < 2 || W > nfft || hop < 1 || W % hop != 0 || nf < 1 ||
      log2m <= kLevelLog2)
    return (int)cudaErrorInvalidValue;
  const auto* xs = static_cast<const float*>(x);
  const auto* w = static_cast<const float*>(win);
  const auto* tws = static_cast<const float2*>(tw);
  const auto* cc = static_cast<const float2*>(chirp);
  const auto* ch = static_cast<const float2*>(chat);
  auto* r = static_cast<float*>(re);
  auto* i = static_cast<float*>(im);
  auto s = static_cast<cudaStream_t>(stream);
  switch (log2m - kMaxLog2) {
    case 2: return (int)launch_cluster<4>(xs, w, tws, cc, ch, r, i, B, L, W, hop, nf, nfft, s);
    case 3: return (int)launch_cluster<8>(xs, w, tws, cc, ch, r, i, B, L, W, hop, nf, nfft, s);
    default: return (int)launch_cluster<16>(xs, w, tws, cc, ch, r, i, B, L, W, hop, nf, nfft, s);
  }
}

// The second level: 65 536 < nfft <= 262 144 (Bluestein's M 262 144 or 524
// 288 over two passes through device memory, fft_common.cuh's level2_*),
// W <= nfft; tw the M-point quarter table (fft_plan.twiddles), chirp (nfft)
// from fft_plan.bluestein_tables, chat (M) from fft_plan.level2_chat (the
// chirp spectrum at r P + k), scratch `per_round` M float2
// (fft_plan.level2_plan: the pairs of frames a round).
extern "C" int stft_level2_launch(const void* x, const void* win, const void* tw,
                                  const void* chirp, const void* chat, void* scratch, void* re,
                                  void* im, int B, int L, int W, int hop, int nf, int nfft,
                                  int per_round, void* stream) {
  const int log2m = level2_log2(nfft);
  if (B < 1 || L < 1 || W < 2 || W > nfft || hop < 1 || W % hop != 0 || nf < 1 || !log2m ||
      per_round < 1 || (long long)B * nf > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const Level2Frames fr{static_cast<const float*>(x), static_cast<const float*>(win),
                        static_cast<const float2*>(chirp), L, W, hop, nf, B * nf};
  const FullRows out{static_cast<float*>(re), static_cast<float*>(im), nfft / 2 + 1};
  const auto* t = static_cast<const float2*>(tw);
  const auto* c = static_cast<const float2*>(chirp);
  const auto* h = static_cast<const float2*>(chat);
  auto* sc = static_cast<float2*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(log2m == kLevel2MinLog2
                   ? launch_level2<kLevel2MinLog2>(fr, t, c, h, sc, out, nfft, per_round, s)
                   : launch_level2<kLevel2MaxLog2>(fr, t, c, h, sc, out, nfft, per_round, s));
}

// The dense route: any nfft >= W (the wrapper sends it only what none of
// the FFT, split, Bluestein, cluster and second-level routes plans, nfft
// past 262 144, or what stft_dft_pallas forces).
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
