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
// once (8 bytes per bin) and each sample written once: 236 MB, 0.0705 ms,
// for 8 signals of 1442 frames of 4096 points; the transforms are about
// 2.5 nfft log2(nfft) flops per frame, an order of magnitude below what the
// card's float32 rate would need to matter.
//
// Design (powers of two, 16 ... 8192 points): the FFT core of
// fft_common.cuh, run backwards by conjugation. A group of nfft / 16
// threads transforms two frames (Z = A + i B) with 16 points a thread in
// registers, each thread loading its points straight from the spectrum rows
// (the mirrored bin past Nyquist), Stockham passes through a padded exchange
// buffer behind barriers of the group alone, twiddles from the host's
// float32 quarter table in shared memory. A block of G groups walks its
// frames in rounds of 2G; the TPU kernels carried the overlap-add tail from
// one frame block to the next in order, and blocks here run in no order, so
// block (n, r) owns R hop rows [j0, j0 + R) of signal n and transforms the
// win/hop - 1 frames before j0 as well (the recomputed share (win/hop - 1) /
// R is at most 3/16). After a round's transforms (one block barrier, outside
// any transform) every output row that the round completes is a gather: a
// thread owns a column u of the hop rows and adds, for each row, the carry of
// the earlier rounds and the round's frames in frame order, so each sample
// sums its win/hop frames in one fixed order, with no atomics, and writes it
// normalized; the k - 1 rows the next round still adds to stay in a carry of
// (win/hop - 1) hop floats, read and written by the same thread.
// fft_plan.istft_plan picks G and the rounds (2 blocks per SM where shared
// memory allows) and mirrors this launcher's numbers.
//
// istft_split_kernel (nfft = m 2^a, m in {3, 5, 9, 15}, 2^a >= 16, nfft <=
// 8192: 768, 1280, 1536, 2304, ...; no preset uses one) is the same design
// on the core's mixed-radix split run backwards (fft_common.cuh::
// istft_split_block): its bound is bytes too, 85 MB and 0.0253 ms for 4
// signals of 5170 frames at 768 points, hop 256. The split's points sit at
// stride m in the spectrum rows, but the m sub-FFTs' threads of a warp read
// interleaved bins, so each thread loads its points straight from the rows
// (a copy of the rows in the exchange buffer, loaded coalesced, measured
// slower: PERF.md row 3′); split_run transforms them, and the gather, carry
// and epilogue are the power-of-two kernel's. Groups of m 2^a / 16 threads
// share warps, so the block synchronizes as a whole (fft_plan.istft_plan
// makes it whole warps, the fewest groups: measured fastest).
//
// istft_bluestein_kernel (the other sizes up to 8192: 1000 = 8 x 125, a
// factor 7, 6000, every odd size; no preset uses one) is the same design on
// Bluestein's
// chirp-z run backwards (fft_common.cuh::istft_bluestein_block): per pair
// of frames two transforms of M = 2^ceil(log2(2 nfft - 1)) points, on the
// core up to M 8192 and past 4096 points on the 16 384-point level (one
// 512-thread group a block, 191 KB of tables and exchange beside the
// carry), then the power-of-two kernel's gather. At 1000 points, hop 250, 4
// signals of 5294 frames its bound is bytes, 106 MB and 0.0317 ms, where the
// direct sum below did 2.1e10 complex products.
//
// istft_cluster_kernel (8192 < nfft <= 65 536: 10 000, 20 000, 40 000, odd
// sizes; no preset uses one) is Bluestein run backwards on a thread-block
// cluster of 4, 8 or 16 blocks (fft_common.cuh::istft_cluster_block, the
// forward kernel's ClusterChirp): a cluster owns R hop rows of a signal and walks them one
// pair of frames a round, each block loading its first stage's points
// straight from the spectrum rows; in the gather each block owns 1/C of
// every hop row's columns and their carry, and reads each frame sample
// across the cluster through distributed shared memory as it adds it. A
// signal of 532 frames (W 10 000, hop 2500) gives few clusters, so
// fft_plan.istft_cluster_plan weighs waves against rounds. Its bound is
// bytes: 26.6 MB, 7.9 us, at W 10 000 for one signal of 532 frames.
//
// istft_cluster_dit_kernel (the powers of two past 8192: the reference's
// 16 384 and 32 768, and 65 536; no preset uses one) is the direct inverse
// by decimation in time over a cluster of C = nfft / 8192 blocks (2, 4 or
// 8; fft_common.cuh::istft_cluster_dit_block on ClusterDit), without
// Bluestein's chirp and its transforms of twice the points: each round
// every block reads a contiguous 1/C of the pair's bins, coalesced, and
// puts the two points a bin gives into the blocks that own them through
// distributed shared memory; block r then runs one Fft<13> on its points t
// = r (mod C) and applies the combine's twiddle, and the radix-C combine is
// read in istft_cluster_kernel's gather. Its bound is bytes: 4 signals of
// 648 frames at 16 384, hop 2048, read 170 MB of spectra and write 21 MB
// of samples, 0.057 ms.
//
// istft_cluster_mixed_kernel (the 7-smooth sizes past 8192 whose nfft = C n
// has n <= 8192 on a cluster of C <= 8: the 204 even ones on the fewest C
// of 2, 4, 8, as 10 000, 14 000, 20 000, 40 000, 56 000; 77 more on the
// fewest C of 3, 5, 6, 7 that divides nfft, 40 of them odd, as 11 025 = 3
// x 3675, 22 050 = 3 x 7350, 44 100 = 6 x 7350; no preset uses one) is
// istft_cluster_dit_kernel on a mixed-radix block core
// (fft_common.cuh::istft_cluster_mixed_block on ClusterMixed): each block's
// n points in Stockham passes of radix 2, 3, 4, 5, 7, 8, 9 and 16 through
// its exchange buffer, in a schedule the host plans
// and passes in, so one instance per C serves every n, the twiddles from a
// whole n-point table in shared memory. fft_plan.istft_plan takes it at the
// sizes in ISTFT_MIXED_WON, where it beat Bluestein's cluster on the card.
// Its bound is bytes: one signal of 532 frames at 10 000, hop 2500, reads
// 21.3 MB of spectra and writes 5.3 MB of samples.
//
// An odd nfft has no Nyquist bin: inverse_point mirrors its last bin (N -
// 1) / 2 as any other, so every bin but DC counts twice, as the reference's
// inverse matrices weight them (convsep_tpu/dsp/dft.py::_inverse_mats).
//
// The istft_level2_* kernels (65 536 < nfft <= 262 144, any parity: 70
// 000, 131 072; no preset uses one) are the second level run backwards
// (fft_common.cuh::level2_first, level2_middle, level2_last): Bluestein's M
// = 262 144 or 524 288 points of a pair of frames in a scratch in device
// memory, R = M / 8192 rows of the core's transform between two radix-R
// passes in registers, the pairs in rounds whose scratch stays within half
// the L2 (fft_plan.level2_plan); phase D writes each frame's samples times
// win / N into a frames buffer, and istft_level2_ola_kernel sums every
// sample's frames in ascending order. Its bound is bytes: one 30 s signal
// at W 70 000, hop 17 500 (78 frames) reads 21.8 MB of spectra and writes
// 5.3 MB of samples, 8.1 us.
//
// The istft_level2_direct_* kernels (nfft = R n past 65 536, R 16 up to
// 131 072 and 32 past it, n <= 8192 7-smooth of either parity: 70 000 = 16
// x 4375, 131 072, 200 000 = 32 x 6250; 138 sizes; no preset uses one) are
// the direct inverse without Bluestein's chirp and its two transforms of
// 262 144 or 524 288 points (fft_common.cuh::level2_direct_combine,
// level2_direct_rows, level2_direct_overlap_add): the pair's N points by
// decimation in frequency over R, the radix-R combine a column in
// registers with the spectrum rows read coalesced, R rows of n points on
// the mixed-radix block core (mixed_fft, one 512-thread block a row) in a
// scratch of N float2 a pair, the rounds of pairs within half the L2
// (fft_plan.level2_direct_plan), the samples by rows into a frames buffer,
// then an overlap-add that reads them back and applies the window.
// fft_plan.istft_plan takes it at the sizes in ISTFT_LEVEL2_DIRECT_WON.
// Its bound is bytes, the second level's: 8.1 us at W 70 000, hop 17 500
// for one 30 s signal.
//
// istft_direct_kernel, a direct O(nfft) sum per output sample in one
// 512-thread block, a pair of frames at a time, with the host's
// float64-made table of e^{-2 pi i m / nfft}, serves no size of the
// wrapper now: its table and spectrum fit shared memory only up to 12 800
// points, so fft_plan.istft_plan refuses sizes past the second level's 262
// 144; istft_direct_pallas forces it at any size up to 12 800.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace {

using namespace fft_common;

constexpr int kDirectThreads = 512;

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads) istft_fft_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, void* __restrict__ out, int out_int16, int nf, int win,
    int hop, int length, int rounds, int rows, int per_signal) {
  using F = Fft<LOG2N>;
  constexpr int N = F::N;
  constexpr int bins = N / 2 + 1;
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / F::T;
  const int group = threadIdx.x / F::T;
  const int j = threadIdx.x - group * F::T;
  const int k = win / hop;       // frames that overlap one hop row
  const int f2 = 2 * groups;     // frames per round
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* bufs = tws + twiddle_len(LOG2N);
  float* carry = reinterpret_cast<float*>(bufs + groups * exchange_len(LOG2N));  // (k-1) hop
  const int n = blockIdx.x / per_signal;
  const int j0 = (blockIdx.x - n * per_signal) * rows;  // first hop row of the block
  const int total_rows = nf + k - 1;
  const int j_end = min(j0 + rows, total_rows);
  const long long track = (long long)n * nf * bins;
  const float* re_n = re + track;
  const float* im_n = im + track;

  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) tws[slot(i)] = __ldg(tw + i);
  for (int i = threadIdx.x; i < (k - 1) * hop; i += blockDim.x) carry[i] = 0.f;
  __syncthreads();

  float2* buf = bufs + group * exchange_len(LOG2N);
  for (int r = 0; r < rounds; ++r) {
    const int fr = j0 - (k - 1) + r * f2;  // first frame of the round
    const int fa = fr + 2 * group, fb = fa + 1;
    const bool ha = fa >= 0 && fa < nf, hb = fb >= 0 && fb < nf;
    float2 v[kPoints];
    inverse_input<LOG2N>(v, ha ? re_n + (long long)fa * bins : nullptr,
                         ha ? im_n + (long long)fa * bins : nullptr,
                         hb ? re_n + (long long)fb * bins : nullptr,
                         hb ? im_n + (long long)fb * bins : nullptr, j);
    F::run(v, buf, tws, j, group);
    __syncthreads();  // every group's frames are in its buffer
    gather_round(
        [&](int g, int t) { return bufs[g * exchange_len(LOG2N) + slot(t)]; }, carry, win_over_n,
        inv_norm, out, out_int16, n, fr, f2, k, hop, j0, j_end, length);
    __syncthreads();  // the buffers are read; the next round's first pass rewrites them
  }
}

// any size up to 12 800 through istft_direct_pallas: z[t] = sum_k Z[k]
// e^{+2 pi i k t / N} per sample, a pair of frames at a time, accumulated in
// shared memory over the block's R hop rows.
__global__ void __launch_bounds__(kDirectThreads) istft_direct_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ table, void* __restrict__ out, int out_int16, int nf, int nfft,
    int win, int hop, int length, int rows, int per_signal) {
  extern __shared__ float4 smem4[];
  const int half = nfft / 2, bins = half + 1, k_ratio = win / hop;
  float2* tw = reinterpret_cast<float2*>(smem4);     // nfft: e^{-2 pi i m / N}
  float2* buf = tw + nfft;                             // nfft: Z in natural order
  float* acc = reinterpret_cast<float*>(buf + nfft);  // rows * hop
  const int tid = threadIdx.x;
  const int n = blockIdx.x / per_signal;
  const int j0 = (blockIdx.x - n * per_signal) * rows;
  const int nrows = min(rows, nf + k_ratio - 1 - j0);
  const long long track = (long long)n * nf * bins;
  for (int i = tid; i < nfft; i += kDirectThreads) tw[i] = __ldg(table + i);
  for (int i = tid; i < rows * hop; i += kDirectThreads) acc[i] = 0.f;
  const int f_lo = max(0, j0 - k_ratio + 1), f_hi = min(nf - 1, j0 + nrows - 1);
  for (int f = f_lo; f <= f_hi; f += 2) {
    const bool has1 = f + 1 <= f_hi;
    const long long fa = track + (long long)f * bins, fb = fa + bins;
    __syncthreads();  // the previous pair's readers of buf are done
    for (int kk = tid; kk <= half; kk += kDirectThreads) {
      const bool edge = kk == 0 || 2 * kk == nfft;  // odd nfft: no Nyquist bin
      const float ar = re[fa + kk], ai = edge ? 0.f : im[fa + kk];
      const float br = has1 ? re[fb + kk] : 0.f, bi = has1 && !edge ? im[fb + kk] : 0.f;
      buf[kk] = make_float2(ar - bi, ai + br);
      if (!edge) buf[nfft - kk] = make_float2(ar + bi, br - ai);
    }
    __syncthreads();
    const int span = win + (has1 ? hop : 0);
    for (int u = tid; u < span; u += kDirectThreads) {
      const int row = f + u / hop - j0;
      if (row < 0 || row >= nrows) continue;
      float v = 0.f;
      for (int part = 0; part < 2; ++part) {  // sample u of frame f, u - hop of f + 1
        const int t = part ? u - hop : u;
        if (part ? !(has1 && u >= hop) : u >= win) continue;
        float zr = 0.f, zi = 0.f;
        int idx = 0;
        for (int kk = 0; kk < nfft; ++kk) {  // Z[kk] conj(tw[kk t mod N])
          const float2 w = tw[idx], z = buf[kk];
          zr += z.x * w.x + z.y * w.y;
          zi += z.y * w.x - z.x * w.y;
          idx += t;
          if (idx >= nfft) idx -= nfft;
        }
        v += win_over_n[t] * (part ? zi : zr);
      }
      acc[row * hop + u % hop] += v;
    }
  }
  __syncthreads();
  const long long front = win / 2;
  for (int i = tid; i < nrows * hop; i += kDirectThreads) {
    const long long nabs = (long long)j0 * hop + i;
    const long long tpos = nabs - front;
    if (tpos < 0 || tpos >= length) continue;
    write_sample(out, out_int16, (long long)n * length + tpos, acc[i] * inv_norm[nabs]);
  }
}

template <int LOG2N>
cudaError_t launch_fft(const float* re, const float* im, const float* wn, const float* inv,
                       const float2* tw, void* out, int out_int16, int nt, int nf, int win,
                       int hop, int length, int groups, int rounds, cudaStream_t stream) {
  const int k = win / hop;
  const int rows = rounds * 2 * groups - (k - 1);
  if (rows < 1) return cudaErrorInvalidValue;
  const int per_signal = (nf + k - 1 + rows - 1) / rows;
  const size_t smem = (size_t)(twiddle_len(LOG2N) + groups * exchange_len(LOG2N)) * sizeof(float2) +
                      (size_t)(k - 1) * hop * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(istft_fft_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  istft_fft_kernel<LOG2N><<<(unsigned)((long long)nt * per_signal), groups * fft_threads(LOG2N),
                            smem, stream>>>(re, im, wn, inv, tw, out, out_int16, nf, win, hop,
                                            length, rounds, rows, per_signal);
  return cudaGetLastError();
}

template <int LOG2P, int M>
__global__ void __launch_bounds__(kMaxThreads) istft_split_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw_p, const float2* __restrict__ tw_n, void* __restrict__ out,
    int out_int16, int nf, int win, int hop, int length, int rounds, int rows, int per_signal) {
  istft_split_block<LOG2P, M>(re, im, win_over_n, inv_norm, tw_p, tw_n, out, out_int16, nf, win,
                              hop, length, rounds, rows, per_signal);
}

struct SplitArgs {
  const float *re, *im, *wn, *inv;
  const float2 *tw_p, *tw_n;
  void* out;
  int out_int16, nt, nf, win, hop, length, groups, rounds;
  cudaStream_t stream;
};

template <int LOG2P, int M>
cudaError_t launch_split(const SplitArgs& a) {
  const int k = a.win / a.hop;
  const int rows = a.rounds * 2 * a.groups - (k - 1);
  if (rows < 1) return cudaErrorInvalidValue;
  const int per_signal = (a.nf + k - 1 + rows - 1) / rows;
  const size_t smem = istft_split_smem_bytes(LOG2P, M, a.win, a.hop, a.groups);
  cudaError_t err = cudaFuncSetAttribute(istft_split_kernel<LOG2P, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  istft_split_kernel<LOG2P, M><<<(unsigned)((long long)a.nt * per_signal),
                                 a.groups * M * fft_threads(LOG2P), smem, a.stream>>>(
      a.re, a.im, a.wn, a.inv, a.tw_p, a.tw_n, a.out, a.out_int16, a.nf, a.win, a.hop, a.length,
      a.rounds, rows, per_signal);
  return cudaGetLastError();
}

// The split's instances: every 2^a (16 <= 2^a, m 2^a <= 8192) for each m.
template <int M, int LOG2P = kMinLog2>
cudaError_t dispatch_split(int log2p, const SplitArgs& a) {
  if constexpr ((M << LOG2P) > (1 << kMaxLog2)) {
    return cudaErrorInvalidValue;
  } else {
    if (log2p == LOG2P) return launch_split<LOG2P, M>(a);
    return dispatch_split<M, LOG2P + 1>(log2p, a);
  }
}

template <int LOG2M>
__global__ void __launch_bounds__(kMaxThreads) istft_bluestein_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, const float2* __restrict__ chirp,
    const float2* __restrict__ chat, void* __restrict__ out, int out_int16, int nf, int nfft,
    int win, int hop, int length, int rounds, int rows, int per_signal) {
  istft_bluestein_block<LOG2M, false>(re, im, win_over_n, inv_norm, tw, chirp, chat, out,
                                      out_int16, nf, nfft, win, hop, length, rounds, rows,
                                      per_signal);
}

struct BluesteinArgs {
  const float *re, *im, *wn, *inv;
  const float2 *tw, *chirp, *chat;
  void* out;
  int out_int16, nt, nf, nfft, win, hop, length, groups, rounds;
  cudaStream_t stream;
};

template <int LOG2M>
cudaError_t launch_bluestein(const BluesteinArgs& a) {
  const int k = a.win / a.hop;
  const int rows = a.rounds * 2 * a.groups - (k - 1);
  if (rows < 1) return cudaErrorInvalidValue;
  const int per_signal = (a.nf + k - 1 + rows - 1) / rows;
  const size_t smem = istft_bluestein_smem_bytes(LOG2M, a.win, a.hop, a.groups);
  cudaError_t err = cudaFuncSetAttribute(istft_bluestein_kernel<LOG2M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  istft_bluestein_kernel<LOG2M><<<(unsigned)((long long)a.nt * per_signal),
                                  a.groups * bluestein_threads(LOG2M), smem, a.stream>>>(
      a.re, a.im, a.wn, a.inv, a.tw, a.chirp, a.chat, a.out, a.out_int16, a.nf, a.nfft, a.win,
      a.hop, a.length, a.rounds, rows, per_signal);
  return cudaGetLastError();
}

// Bluestein's instances: every M from 16 on the core to 16 384 on the level.
template <int LOG2M = kMinLog2>
cudaError_t dispatch_bluestein(int log2m, const BluesteinArgs& a) {
  if constexpr (LOG2M > kLevelLog2) {
    return cudaErrorInvalidValue;
  } else {
    if (log2m == LOG2M) return launch_bluestein<LOG2M>(a);
    return dispatch_bluestein<LOG2M + 1>(log2m, a);
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads) istft_cluster_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, const float2* __restrict__ chirp,
    const float2* __restrict__ chat, void* __restrict__ out, int out_int16, int nf, int nfft,
    int win, int hop, int length, int rounds, int rows, int per_signal) {
  extern __shared__ float4 smem4[];
  istft_cluster_block<kMaxLog2, C>(smem4, re, im, win_over_n, inv_norm, tw, chirp, chat, out,
                                   out_int16, nf, nfft, win, hop, length, rounds, rows,
                                   per_signal);
}

// clusters of C blocks, each owning `rows` hop rows of a signal, the blocks
// of a cluster consecutive in x; with `active`, launches nothing and sets
// how many such clusters the card holds at once
template <int C>
cudaError_t launch_cluster(const BluesteinArgs& a, int* active = nullptr) {
  const int k = a.win / a.hop;
  const int rows = 2 * a.rounds - (k - 1);
  if (rows < 1) return cudaErrorInvalidValue;
  const int per_signal = (a.nf + k - 1 + rows - 1) / rows;
  return launch_clusters<C>(istft_cluster_kernel<C>, (long long)a.nt * per_signal,
                            cluster_smem_bytes(kMaxLog2, (k - 1) * cluster_columns(a.hop, C)),
                            a.stream, active, a.re, a.im, a.wn, a.inv, a.tw, a.chirp, a.chat,
                            a.out, a.out_int16, a.nf, a.nfft, a.win, a.hop, a.length, a.rounds,
                            rows, per_signal);
}

// One block an SM, as wiener_cluster_dit_kernel: 128 registers a thread.
template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1) istft_cluster_dit_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, void* __restrict__ out, int out_int16, int nf, int win,
    int hop, int length, int rounds, int rows, int per_signal) {
  extern __shared__ float4 smem4[];
  istft_cluster_dit_block<kMaxLog2, C>(smem4, re, im, win_over_n, inv_norm, tw, out, out_int16,
                                       nf, win, hop, length, rounds, rows, per_signal);
}

// the same for the direct transform, N = 8192 C (C 2, 4 or 8)
template <int C>
cudaError_t launch_cluster_dit(const BluesteinArgs& a, int* active) {
  const int k = a.win / a.hop;
  const int rows = 2 * a.rounds - (k - 1);
  if (rows < 1) return cudaErrorInvalidValue;
  const int per_signal = (a.nf + k - 1 + rows - 1) / rows;
  return launch_clusters<C>(istft_cluster_dit_kernel<C>, (long long)a.nt * per_signal,
                            cluster_smem_bytes(kMaxLog2, (k - 1) * cluster_columns(a.hop, C)),
                            a.stream, active, a.re, a.im, a.wn, a.inv, a.tw, a.out, a.out_int16,
                            a.nf, a.win, a.hop, a.length, a.rounds, rows, per_signal);
}

cudaError_t dispatch_cluster_dit(int nfft, const BluesteinArgs& a, int* active = nullptr) {
  if (nfft == 2 << kMaxLog2) return launch_cluster_dit<2>(a, active);
  if (nfft == 4 << kMaxLog2) return launch_cluster_dit<4>(a, active);
  if (nfft == 8 << kMaxLog2) return launch_cluster_dit<8>(a, active);
  return cudaErrorInvalidValue;
}

// One block an SM, as istft_cluster_dit_kernel.
template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1) istft_cluster_mixed_kernel(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, void* __restrict__ out, int out_int16, int nf, int n, int win,
    int hop, int length, int rounds, int rows, int per_signal, unsigned long long sched) {
  extern __shared__ float4 smem4[];
  istft_cluster_mixed_block<C>(smem4, re, im, win_over_n, inv_norm, tw, out, out_int16, nf, n,
                               win, hop, length, rounds, rows, per_signal, sched);
}

// the same for the 7-smooth block core, N = C n
template <int C>
cudaError_t launch_cluster_mixed(const BluesteinArgs& a, int n, unsigned long long sched,
                                 int* active) {
  const int k = a.win / a.hop;
  const int rows = 2 * a.rounds - (k - 1);
  if (rows < 1) return cudaErrorInvalidValue;
  const int per_signal = (a.nf + k - 1 + rows - 1) / rows;
  return launch_clusters<C>(istft_cluster_mixed_kernel<C>, (long long)a.nt * per_signal,
                            cluster_mixed_smem_bytes(n, (k - 1) * cluster_columns(a.hop, C)),
                            a.stream, active, a.re, a.im, a.wn, a.inv, a.tw, a.out, a.out_int16,
                            a.nf, n, a.win, a.hop, a.length, a.rounds, rows, per_signal, sched);
}

cudaError_t dispatch_cluster_mixed(int nfft, const BluesteinArgs& a, unsigned long long sched,
                                   int* active = nullptr) {
  int c, n;
  if (!mixed_sizes(nfft, &c, &n)) return cudaErrorInvalidValue;
  switch (c) {
    case 2: return launch_cluster_mixed<2>(a, n, sched, active);
    case 3: return launch_cluster_mixed<3>(a, n, sched, active);
    case 4: return launch_cluster_mixed<4>(a, n, sched, active);
    case 5: return launch_cluster_mixed<5>(a, n, sched, active);
    case 6: return launch_cluster_mixed<6>(a, n, sched, active);
    case 7: return launch_cluster_mixed<7>(a, n, sched, active);
    default: return launch_cluster_mixed<8>(a, n, sched, active);
  }
}

// the cluster instance for Bluestein's M = 2^log2m: C = M / 8192
cudaError_t dispatch_cluster(int log2m, const BluesteinArgs& a, int* active = nullptr) {
  switch (log2m - kMaxLog2) {
    case 2: return launch_cluster<4>(a, active);
    case 3: return launch_cluster<8>(a, active);
    case 4: return launch_cluster<16>(a, active);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the second level (nfft past 65 536): fft_common.cuh's phases --------

template <int LOG2M>
__global__ void __launch_bounds__(kLevel2Threads) istft_level2_first_kernel(
    const Level2Spectra sp, const float2* __restrict__ tw, float2* __restrict__ scratch,
    int pair0) {
  const int g = 2 * (pair0 + (int)blockIdx.y);  // the pair's frame a
  level2_first<LOG2M>([&](int t) { return sp(g, t); },
                      scratch + ((long long)blockIdx.y << LOG2M), tw,
                      blockIdx.x * kLevel2Threads + threadIdx.x);
}

template <int LOG2M>
__global__ void __launch_bounds__(kMaxThreads) istft_level2_middle_kernel(
    float2* __restrict__ scratch, const float2* __restrict__ tw,
    const float2* __restrict__ chat) {
  extern __shared__ float4 smem4[];
  const long long row = (long long)blockIdx.x << kMaxLog2;  // r P
  level2_middle<LOG2M>(smem4, scratch + ((long long)blockIdx.y << LOG2M) + row, tw, chat + row,
                       blockIdx.x);
}

// D, then the pair's samples t < win, chirp[t] conj Z[t] = N conj(a[t] + i
// b[t]) times win / N, into rows g and g + 1 of `frames`
template <int LOG2M>
__global__ void __launch_bounds__(kLevel2Threads) istft_level2_last_kernel(
    const float2* __restrict__ scratch, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float* __restrict__ win_over_n,
    float* __restrict__ frames, int win, int nframes, int pair0) {
  const int g = 2 * (pair0 + (int)blockIdx.y);
  const bool hb = g + 1 < nframes;
  float* fa = frames + (long long)g * win;
  level2_last<LOG2M>(scratch + ((long long)blockIdx.y << LOG2M), tw,
                     blockIdx.x * kLevel2Threads + threadIdx.x, [&](int t, float2 z) {
                       if (t >= win) return;
                       const float2 y = cmul(__ldg(chirp + t), make_float2(z.x, -z.y));
                       const float w = __ldg(win_over_n + t);
                       fa[t] = w * y.x;
                       if (hb) fa[win + t] = -w * y.y;
                     });
}

__global__ void __launch_bounds__(kLevel2Threads) istft_level2_ola_kernel(
    const float* __restrict__ frames, const float* __restrict__ inv_norm, void* __restrict__ out,
    int out_int16, int nf, int win, int hop, int length) {
  const int tpos = blockIdx.x * kLevel2Threads + threadIdx.x;
  if (tpos < length)
    level2_overlap_add(frames, inv_norm, out, out_int16, blockIdx.y, nf, win, hop, length, tpos);
}

template <int LOG2M>
cudaError_t launch_level2(const Level2Spectra& sp, const float2* tw, const float2* chirp,
                          const float2* chat, const float* wn, const float* inv,
                          float2* scratch, float* frames, void* out, int out_int16, int nt,
                          int nf, int win, int hop, int length, int per_round,
                          cudaStream_t stream) {
  constexpr int P = 1 << kMaxLog2, R = (1 << LOG2M) / P;
  cudaError_t err = cudaFuncSetAttribute(istft_level2_middle_kernel<LOG2M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         level2_middle_smem());
  if (err != cudaSuccess) return err;
  const int pairs = (sp.frames + 1) / 2;
  for (int p0 = 0; p0 < pairs; p0 += per_round) {
    const unsigned n = (unsigned)min(per_round, pairs - p0);
    istft_level2_first_kernel<LOG2M><<<dim3(P / kLevel2Threads, n), kLevel2Threads, 0, stream>>>(
        sp, tw, scratch, p0);
    istft_level2_middle_kernel<LOG2M><<<dim3(R, n), kMaxThreads, level2_middle_smem(), stream>>>(
        scratch, tw, chat);
    istft_level2_last_kernel<LOG2M><<<dim3(P / kLevel2Threads, n), kLevel2Threads, 0, stream>>>(
        scratch, tw, chirp, wn, frames, win, sp.frames, p0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  istft_level2_ola_kernel<<<dim3((length + kLevel2Threads - 1) / kLevel2Threads, nt),
                            kLevel2Threads, 0, stream>>>(frames, inv, out, out_int16, nf, win,
                                                         hop, length);
  return cudaGetLastError();
}

// ---- the second level's direct transform (7-smooth sizes past 65 536) ---

// phase 1 (level2_direct_combine) for columns n2 of the round's pairs
template <int R>
__global__ void __launch_bounds__(kLevel2Threads) istft_level2_direct_combine_kernel(
    const float* __restrict__ re, const float* __restrict__ im, const float2* __restrict__ tw2,
    float2* __restrict__ scratch, int n, int nframes, int pair0) {
  const int n2 = blockIdx.x * kLevel2Threads + threadIdx.x;
  if (n2 >= n) return;
  const int g = 2 * (pair0 + (int)blockIdx.y);  // the pair's frame a
  const int N = R * n;
  level2_direct_combine<R>([&](int t) { return level2_bin_point(re, im, N, nframes, g, t); },
                           scratch + (long long)blockIdx.y * N, tw2, n, n2);
}

// phase 2 (level2_direct_rows) for row k1 = blockIdx.x of R = gridDim.x:
// frame a's samples N Re y[t] and frame b's -N Im y[t], t = k1 + R k2 <
// win, at k1 n + k2 of rows g and g + 1 of `frames` (N floats a frame). One
// block an SM: mixed_fft takes 128 registers of 512 threads.
__global__ void __launch_bounds__(kMaxThreads, 1) istft_level2_direct_rows_kernel(
    const float2* __restrict__ scratch, const float2* __restrict__ tw, float* __restrict__ frames,
    int n, int win, int nframes, int pair0, unsigned long long sched) {
  extern __shared__ float4 smem4[];
  const long long N = (long long)gridDim.x * n;
  level2_direct_rows(smem4, scratch + blockIdx.y * N + (long long)blockIdx.x * n, tw, n, sched,
                     [&](int k2, float2 y) {
                       const int k1 = blockIdx.x;
                       const int g = 2 * (pair0 + (int)blockIdx.y);
                       if (k1 + (int)gridDim.x * k2 >= win) return;
                       float* fa = frames + g * N + (long long)k1 * n + k2;
                       fa[0] = y.x;
                       if (g + 1 < nframes) fa[N] = -y.y;
                     });
}

// phase 3 (level2_direct_overlap_add) for samples tpos of signal blockIdx.y
template <int R>
__global__ void __launch_bounds__(kLevel2Threads) istft_level2_direct_ola_kernel(
    const float* __restrict__ frames, const float* __restrict__ win_over_n,
    const float* __restrict__ inv_norm, void* __restrict__ out, int out_int16, int nf, int N,
    int win, int hop, int length) {
  const int tpos = blockIdx.x * kLevel2Threads + threadIdx.x;
  if (tpos < length)
    level2_direct_overlap_add<R>(frames, win_over_n, inv_norm, out, out_int16, blockIdx.y, nf, N,
                                 win, hop, length, tpos);
}

struct Level2DirectArgs {
  const float *re, *im, *wn, *inv;
  const float2* tables;  // the (R, n) table w^{n2 k1}, then the n-point table w^{R m}
  float2* scratch;
  float* frames;
  void* out;
  int out_int16, nt, nf, n, win, hop, length, per_round;
  unsigned long long sched;
  cudaStream_t stream;
};

template <int R>
cudaError_t launch_level2_direct(const Level2DirectArgs& a) {
  const int N = R * a.n, count = a.nt * a.nf, pairs = (count + 1) / 2;
  const size_t smem = (size_t)mixed_tables_len(a.n) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(istft_level2_direct_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  for (int p0 = 0; p0 < pairs; p0 += a.per_round) {
    const unsigned cnt = (unsigned)min(a.per_round, pairs - p0);
    istft_level2_direct_combine_kernel<R>
        <<<dim3((a.n + kLevel2Threads - 1) / kLevel2Threads, cnt), kLevel2Threads, 0, a.stream>>>(
            a.re, a.im, a.tables, a.scratch, a.n, count, p0);
    istft_level2_direct_rows_kernel<<<dim3(R, cnt), kMaxThreads, smem, a.stream>>>(
        a.scratch, a.tables + N, a.frames, a.n, a.win, count, p0, a.sched);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  istft_level2_direct_ola_kernel<R>
      <<<dim3((a.length + kLevel2Threads - 1) / kLevel2Threads, a.nt), kLevel2Threads, 0,
          a.stream>>>(a.frames, a.wn, a.inv, a.out, a.out_int16, a.nf, N, a.win, a.hop, a.length);
  return cudaGetLastError();
}

}  // namespace

// tw: the quarter twiddle table (fft_plan.twiddles) for a power of two in
// [16, 8192], else the full table e^{-2 pi i m / nfft} (fft_plan.dft_table).
// groups, rounds: fft_plan.istft_plan (groups = 0: the direct sum, with
// rounds hop rows per block). The split's sizes go to istft_split_launch,
// the other sizes up to 8192 to istft_bluestein_launch.
extern "C" int istft_launch(const void* re, const void* im, const void* win_over_n,
                            const void* inv_norm, const void* tw, void* out, int out_int16,
                            int nt, int nf, int nfft, int win, int hop, int length, int groups,
                            int rounds, void* stream) {
  if (nfft < 2 || win < 1 || win > nfft || hop < 1 || win % hop != 0 || nt < 1 || nf < 1 ||
      rounds < 1 || groups < 0)
    return (int)cudaErrorInvalidValue;
  const auto* r = static_cast<const float*>(re);
  const auto* i = static_cast<const float*>(im);
  const auto* wn = static_cast<const float*>(win_over_n);
  const auto* inv = static_cast<const float*>(inv_norm);
  const auto* t = static_cast<const float2*>(tw);
  auto s = static_cast<cudaStream_t>(stream);
  const int log2n = plan_log2(nfft);
  if (groups == 0) {  // the direct sum
    if (log2n) return (int)cudaErrorInvalidValue;
    const int rows = rounds;
    const int per_signal = (nf + win / hop - 1 + rows - 1) / rows;
    const size_t smem = (size_t)2 * nfft * sizeof(float2) + (size_t)rows * hop * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(istft_direct_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    istft_direct_kernel<<<(unsigned)((long long)nt * per_signal), kDirectThreads, smem, s>>>(
        r, i, wn, inv, t, out, out_int16, nf, nfft, win, hop, length, rows, per_signal);
    return (int)cudaGetLastError();
  }
  if (!log2n || groups * fft_threads(log2n) > kMaxThreads ||
      groups * fft_threads(log2n) % 32 != 0 || (fft_threads(log2n) > 32 && groups > 8))
    return (int)cudaErrorInvalidValue;
  switch (log2n) {
#define CASE(L) \
  case L: return (int)launch_fft<L>(r, i, wn, inv, t, out, out_int16, nt, nf, win, hop, length, groups, rounds, s);
    CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
    default: return (int)launch_fft<13>(r, i, wn, inv, t, out, out_int16, nt, nf, win, hop,
                                        length, groups, rounds, s);
#undef CASE
  }
}

// The split route: nfft = m 2^a (m in {3, 5, 9, 15}, 16 <= 2^a, nfft <= 8192);
// tw_p and tw_n the quarter tables of 2^a and nfft (fft_plan.twiddles);
// groups, rounds from fft_plan.istft_plan (whole warps, at most 512 threads).
extern "C" int istft_split_launch(const void* re, const void* im, const void* win_over_n,
                                  const void* inv_norm, const void* tw_p, const void* tw_n,
                                  void* out, int out_int16, int nt, int nf, int nfft, int win,
                                  int hop, int length, int groups, int rounds, void* stream) {
  int m, log2p;
  const bool sized = split_sizes(nfft, &m, &log2p);
  const int threads = sized ? groups * (nfft / kPoints) : 0;
  if (!sized || win < 1 || win > nfft || hop < 1 || win % hop != 0 || nt < 1 || nf < 1 ||
      rounds < 1 || groups < 1 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const SplitArgs a{static_cast<const float*>(re), static_cast<const float*>(im),
                    static_cast<const float*>(win_over_n), static_cast<const float*>(inv_norm),
                    static_cast<const float2*>(tw_p), static_cast<const float2*>(tw_n), out,
                    out_int16, nt, nf, win, hop, length, groups, rounds,
                    static_cast<cudaStream_t>(stream)};
  switch (m) {
    case 3: return (int)dispatch_split<3>(log2p, a);
    case 5: return (int)dispatch_split<5>(log2p, a);
    case 9: return (int)dispatch_split<9>(log2p, a);
    default: return (int)dispatch_split<15>(log2p, a);
  }
}

// The Bluestein route: nfft <= 8192, any parity (M = 2^ceil(log2(2 nfft - 1)) <=
// 16 384); tw the M-point quarter table (fft_plan.twiddles), chirp (nfft)
// and chat (M) from fft_plan.bluestein_tables; groups, rounds from
// fft_plan.istft_plan (the fewest groups of M/16 threads in whole warps; on
// the level one group of 512 threads).
extern "C" int istft_bluestein_launch(const void* re, const void* im, const void* win_over_n,
                                      const void* inv_norm, const void* tw, const void* chirp,
                                      const void* chat, void* out, int out_int16, int nt, int nf,
                                      int nfft, int win, int hop, int length, int groups,
                                      int rounds, void* stream) {
  const int log2m = nfft >= 2 ? bluestein_log2(nfft) : 0;
  const int t = log2m ? bluestein_threads(log2m) : 0;
  if (!log2m || log2m > kLevelLog2 || win < 1 || win > nfft || hop < 1 || win % hop != 0 ||
      nt < 1 || nf < 1 || rounds < 1 || groups < 1 || groups * t > kMaxThreads || groups * t % 32 != 0 ||
      (t > 32 && groups > 8))
    return (int)cudaErrorInvalidValue;
  const BluesteinArgs a{static_cast<const float*>(re),
                        static_cast<const float*>(im),
                        static_cast<const float*>(win_over_n),
                        static_cast<const float*>(inv_norm),
                        static_cast<const float2*>(tw),
                        static_cast<const float2*>(chirp),
                        static_cast<const float2*>(chat),
                        out,
                        out_int16, nt, nf, nfft, win, hop, length, groups, rounds,
                        static_cast<cudaStream_t>(stream)};
  return (int)dispatch_bluestein(log2m, a);
}

// The cluster route: 8192 < nfft <= 65 536, any parity (M 32 768, 65 536 or 131
// 072: a cluster of 4, 8 or 16 blocks of 512 threads, one pair of frames a
// round);
// tw the M-point quarter table (fft_plan.twiddles), chirp (nfft) and chat
// (M) from fft_plan.bluestein_tables; rounds from fft_plan.istft_plan
// (istft_cluster_plan).
extern "C" int istft_cluster_launch(const void* re, const void* im, const void* win_over_n,
                                    const void* inv_norm, const void* tw, const void* chirp,
                                    const void* chat, void* out, int out_int16, int nt, int nf,
                                    int nfft, int win, int hop, int length, int rounds,
                                    void* stream) {
  const int log2m = nfft >= 2 ? bluestein_log2(nfft) : 0;
  if (log2m <= kLevelLog2 || win < 1 || win > nfft || hop < 1 || win % hop != 0 || nt < 1 ||
      nf < 1 || rounds < 1)
    return (int)cudaErrorInvalidValue;
  const BluesteinArgs a{static_cast<const float*>(re),
                        static_cast<const float*>(im),
                        static_cast<const float*>(win_over_n),
                        static_cast<const float*>(inv_norm),
                        static_cast<const float2*>(tw),
                        static_cast<const float2*>(chirp),
                        static_cast<const float2*>(chat),
                        out,
                        out_int16, nt, nf, nfft, win, hop, length, 1, rounds,
                        static_cast<cudaStream_t>(stream)};
  return (int)dispatch_cluster(log2m, a);
}

// The powers of two past 8192: nfft 16 384, 32 768 or 65 536, the direct
// inverse by decimation in time on a cluster of nfft / 8192 blocks (2, 4 or
// 8) of 512 threads, one pair of frames a round; tw the nfft-point quarter
// table (fft_plan.twiddles); rounds from fft_plan.istft_plan
// (istft_cluster_dit_plan).
extern "C" int istft_cluster_dit_launch(const void* re, const void* im, const void* win_over_n,
                                        const void* inv_norm, const void* tw, void* out,
                                        int out_int16, int nt, int nf, int nfft, int win, int hop,
                                        int length, int rounds, void* stream) {
  if (win < 1 || win > nfft || hop < 1 || win % hop != 0 || nt < 1 || nf < 1 || rounds < 1)
    return (int)cudaErrorInvalidValue;
  const BluesteinArgs a{static_cast<const float*>(re),
                        static_cast<const float*>(im),
                        static_cast<const float*>(win_over_n),
                        static_cast<const float*>(inv_norm),
                        static_cast<const float2*>(tw),
                        nullptr,
                        nullptr,
                        out,
                        out_int16, nt, nf, nfft, win, hop, length, 1, rounds,
                        static_cast<cudaStream_t>(stream)};
  return (int)dispatch_cluster_dit(nfft, a);
}

// The 7-smooth sizes past 8192 (fft_plan.mixed_factors: nfft = C n, n <=
// 8192, n = 2^a 3^b 5^c 7^d, C 2, 4 or 8 the fewest at the even sizes that
// rule takes, else the fewest from ceil(nfft / 8192) to 8 that divides
// nfft; 10 000, 14 000, 20 000, 40 000, 56 000, the odd 11 025 on C 3 and
// 44 100 on C 6), the direct inverse by decimation in
// time on a cluster of C blocks of 512 threads, each block's n points on
// the mixed-radix core in the passes of `sched` (fft_plan.mixed_schedule:
// their radices multiply to n), one pair of frames a round; tw the
// nfft-point table e^{-2 pi i m / nfft} (fft_plan.dft_table); rounds from
// fft_plan.istft_cluster_mixed_plan.
extern "C" int istft_cluster_mixed_launch(const void* re, const void* im, const void* win_over_n,
                                          const void* inv_norm, const void* tw, void* out,
                                          int out_int16, int nt, int nf, int nfft, int win,
                                          int hop, int length, int rounds, long long sched,
                                          void* stream) {
  int c, n;
  if (!mixed_sizes(nfft, &c, &n) || !mixed_schedule_ok(n, (unsigned long long)sched) || win < 1 ||
      win > nfft || hop < 1 || win % hop != 0 || nt < 1 || nf < 1 || rounds < 1)
    return (int)cudaErrorInvalidValue;
  const BluesteinArgs a{static_cast<const float*>(re),
                        static_cast<const float*>(im),
                        static_cast<const float*>(win_over_n),
                        static_cast<const float*>(inv_norm),
                        static_cast<const float2*>(tw),
                        nullptr,
                        nullptr,
                        out,
                        out_int16, nt, nf, nfft, win, hop, length, 1, rounds,
                        static_cast<cudaStream_t>(stream)};
  return (int)dispatch_cluster_mixed(nfft, a, (unsigned long long)sched);
}

// The second level: 65 536 < nfft <= 262 144, any parity (Bluestein's M
// 262 144 or 524 288 over two passes through device memory, fft_common.cuh's
// level2_*): the pairs of the flattened (nt x nf) frames in rounds of
// `per_round` (fft_plan.level2_plan), each pair's samples times win / nfft
// into `frames` (nt nf win floats), then the overlap-add of every signal.
// tw the M-point quarter table, chirp (nfft) from fft_plan.bluestein_tables,
// chat (M) from fft_plan.level2_chat, scratch `per_round` M float2.
extern "C" int istft_level2_launch(const void* re, const void* im, const void* win_over_n,
                                   const void* inv_norm, const void* tw, const void* chirp,
                                   const void* chat, void* scratch, void* frames, void* out,
                                   int out_int16, int nt, int nf, int nfft, int win, int hop,
                                   int length, int per_round, void* stream) {
  const int log2m = level2_log2(nfft);
  if (!log2m || win < 1 || win > nfft || hop < 1 || win % hop != 0 || nt < 1 || nt > 65535 ||
      nf < 1 || length < 1 || per_round < 1 || (long long)nt * nf > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const Level2Spectra sp{static_cast<const float*>(re), static_cast<const float*>(im),
                         static_cast<const float2*>(chirp), nfft, nt * nf};
  const auto* t = static_cast<const float2*>(tw);
  const auto* c = static_cast<const float2*>(chirp);
  const auto* h = static_cast<const float2*>(chat);
  const auto* wn = static_cast<const float*>(win_over_n);
  const auto* inv = static_cast<const float*>(inv_norm);
  auto* sc = static_cast<float2*>(scratch);
  auto* fr = static_cast<float*>(frames);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(log2m == kLevel2MinLog2
                   ? launch_level2<kLevel2MinLog2>(sp, t, c, h, wn, inv, sc, fr, out, out_int16,
                                                   nt, nf, win, hop, length, per_round, s)
                   : launch_level2<kLevel2MaxLog2>(sp, t, c, h, wn, inv, sc, fr, out, out_int16,
                                                   nt, nf, win, hop, length, per_round, s));
}

// The second level's direct transform: nfft = R n past 65 536, up to 262
// 144, R 16 up to 131 072 and 32 past it, n 7-smooth (fft_plan.
// level2_direct_factors: 70 000, 131 072, 200 000; 138 sizes): the pairs of
// the flattened (nt x nf) frames in rounds of `per_round`
// (fft_plan.level2_direct_plan), each pair's radix-R combine into `scratch`
// (per_round nfft float2), its R rows of n points on the mixed-radix core
// in the passes of `sched` (fft_plan.mixed_schedule) into `frames` (nt nf
// nfft floats, a frame's samples by rows), then the overlap-add of every
// signal. tables: fft_plan.level2_direct_tables (nfft + n float2).
extern "C" int istft_level2_direct_launch(const void* re, const void* im, const void* win_over_n,
                                          const void* inv_norm, const void* tables, void* scratch,
                                          void* frames, void* out, int out_int16, int nt, int nf,
                                          int nfft, int win, int hop, int length, int per_round,
                                          long long sched, void* stream) {
  int r, n;
  if (!level2_direct_sizes(nfft, &r, &n) || !mixed_schedule_ok(n, (unsigned long long)sched) ||
      win < 1 || win > nfft || hop < 1 || win % hop != 0 || nt < 1 || nt > 65535 || nf < 1 ||
      length < 1 || per_round < 1 || per_round > 65535 || (long long)nt * nf > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const Level2DirectArgs a{static_cast<const float*>(re),
                           static_cast<const float*>(im),
                           static_cast<const float*>(win_over_n),
                           static_cast<const float*>(inv_norm),
                           static_cast<const float2*>(tables),
                           static_cast<float2*>(scratch),
                           static_cast<float*>(frames),
                           out,
                           out_int16, nt, nf, n, win, hop, length, per_round,
                           (unsigned long long)sched,
                           static_cast<cudaStream_t>(stream)};
  return (int)(r == kLevel2DirectMinR ? launch_level2_direct<kLevel2DirectMinR>(a)
                                      : launch_level2_direct<kLevel2DirectMaxR>(a));
}

// How many clusters of istft_cluster_kernel (Bluestein's, `route` 0), of
// istft_cluster_dit_kernel (`route` 1, the powers of two past 8192) or of
// istft_cluster_mixed_kernel (`route` 2, the 7-smooth sizes) a launch at
// (nfft, win, hop) finds room for at once (cudaOccupancyMaxActiveClusters:
// one block an SM, the clusters' blocks within one GPC);
// fft_plan.CLUSTERS_AT_ONCE is this reading. Launches nothing.
extern "C" int istft_cluster_occupancy(int nfft, int win, int hop, int route, int* active) {
  const int log2m = nfft >= 2 ? bluestein_log2(nfft) : 0;
  if (log2m <= kLevelLog2 || win < 1 || win > nfft || hop < 1 || win % hop != 0 || !active)
    return (int)cudaErrorInvalidValue;
  const int k = win / hop;
  const BluesteinArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        0, 1, 1, nfft, win, hop, 1, 1, k, nullptr};
  switch (route) {
    case 0: return (int)dispatch_cluster(log2m, a, active);
    case 1: return (int)dispatch_cluster_dit(nfft, a, active);
    default: return (int)dispatch_cluster_mixed(nfft, a, 0, active);
  }
}
