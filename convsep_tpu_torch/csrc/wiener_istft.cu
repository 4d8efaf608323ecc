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
// The mixture comes either as re/im of nfft/2 + 1 bins, or (ny given) as
// the forward STFT kernel's nfft/2-bin bodies plus its real Nyquist row
// ny[n, f] (ct_stft.cu; the reference's has_ny input): bin nfft/2 of the
// mixture is then ny with imaginary part 0, while y keeps all nfft/2 + 1
// bins. No concatenated spectrum is ever built.
//
// What bounds it on the H100: device-memory bytes. y (S rows per frame, f32
// or bf16) and the mixture are read once, the stems written once: 68 MB,
// 0.0212 ms, at highres4096 (4 sources, 1442 frames of 4096 points, bf16
// y); the inverse FFTs are about 2.5 N log2(N) flops per source frame, an
// order of magnitude below what the card's float32 rate would need to
// matter. The masked spectra never reach device memory.
//
// Design (powers of two, 16 ... 8192 points): the FFT core of
// fft_common.cuh run backwards by conjugation, as istft.cu runs it. A block
// owns one pair of sources (s0 = 2 pair, s1 = s0 + 1; with S odd the last
// pair has B = 0) and R hop rows [j0, j0 + R) of one track. A group of N / 16
// threads transforms one frame of the pair per pass, Z = A + i B with A and
// B the masked spectra of s0 and s1: each thread loads its 16 bins' y for
// all S sources (the mirrored bin N - k past Nyquist), forms the
// denominator in registers in source order (s = 0 .. S - 1, then + eps), and
// builds conj Z straight into its first-pass registers (inverse_points); no
// spectrum, denominator row or bit-reversed slot is ever written to shared
// memory. The blocks of a row range's pairs are adjacent in the grid, so
// the second pair's reads of y and of the mixture come from L2. A block of
// G groups walks its frames in rounds of G; each output sample then sums
// its win/hop frames in ascending order by a gather after the round's one
// block barrier, the k - 1 rows the next round still adds staying in a
// carry of (k - 1) hop floats per source (no atomics, deterministic). The
// block transforms the k - 1 frames before j0 too (the halo); block counts
// and rounds come from fft_plan.wiener_plan, which mirrors this launcher.
//
// Even sizes past 8192, up to the reference's 32 768 (no preset uses one):
// a thread-block cluster owns one pair of sources and R hop rows of a
// track and transforms one frame of the pair a round; each block gathers
// its 1/C of every hop row's columns for both sources, two carries in its
// shared memory, reading the transform across the cluster through
// distributed shared memory as it is consumed.
// * The powers of two, the reference's 16 384 and 32 768
//   (wiener_cluster_dit_kernel, wiener_common.cuh::wiener_cluster_dit_block):
//   the direct N-point inverse by decimation in time over C = N / 8192
//   blocks (2 at 16 384, 4 at 32 768; fft_common.cuh::ClusterDit): each
//   block masks a contiguous 1/C of the bins, read coalesced, each bin's
//   mask formed once a frame, and puts the two points a bin gives into the
//   blocks that own them through distributed shared memory; block r then
//   runs one Fft<13> on its points t = r (mod C) and applies the combine's
//   twiddle; the radix-C combine is read in the gather. 144 384 bytes of
//   shared memory a block at hop N/8.
// * The 7-smooth sizes, N = C n with n = 2^a 3^b 5^c 7^d (10 000, 14 000,
//   20 000 and 133 more from 8232 to 32 400 on C 2 or 4; 22 050 and 12 more
//   from 17 010 to 31 250 on C 3, 5 or 6; wiener_cluster_mixed_kernel,
//   wiener_common.cuh::wiener_cluster_mixed_block): the same rounds, each
//   block's n points on the mixed-radix core (fft_common.cuh::ClusterMixed,
//   mixed_fft: Stockham passes of radix 2-16, 3, 5, 7 and 9 in a schedule
//   the host plans), the whole N-point table in global memory for the
//   combine.
// * The other even sizes (wiener_cluster_kernel,
//   wiener_common.cuh::wiener_cluster_block): Bluestein run backwards on a
//   cluster of 4 or 8 blocks (M 32 768 or 65 536,
//   fft_common.cuh::ClusterChirp), istft.cu's istft_cluster_kernel with the
//   mask in the point loads; every block's first stage reads the whole
//   frame, and each round runs two 8192-point transforms a block.
// The plans (fft_plan.wiener_cluster_dit_plan, wiener_cluster_mixed_plan,
// wiener_cluster_plan) weigh waves of the clusters the card holds at once
// against rounds. At W 16 384, hop 2048, 4 stems of a 30 s track (648
// frames, f32 y) the bound is bytes: 85 MB of y, 42 MB of mixture and 21 MB
// of stems, 0.044 ms.
//
// The split's sizes, N = m 2^a (m 3, 5, 9, 15, 2^a >= 16, N <= 8192: 768,
// 1280, 1536, 2304, 3072, ...; wiener_split.cu::wiener_split_kernel,
// wiener_common.cuh::wiener_split_block; no preset uses one): istft.cu's istft_split_kernel
// with the mask in the point loads, a group one frame of a pair of sources,
// the two sources' carries. At W 768, hop 256, 4 stems of a 30 s track
// (5170 frames, bf16 y) its bound is bytes: 16 MB of y, 16 MB of mixture
// and 21 MB of stems, 0.0158 ms.
//
// The other even sizes up to 8192 (1000, 2000, 6000, 8190, ...;
// wiener_bluestein.cu::wiener_bluestein_kernel, wiener_common.cuh::
// wiener_bluestein_block; no preset uses one): istft.cu's istft_bluestein_kernel (Bluestein run
// backwards, on the core up to M 8192 and past N 4096 on the 16 384-point
// level) with the mask in the point loads, a pair of sources a block. The
// level's tables and exchange take 191 488 bytes, so where the two
// sources' carries do not fit beside them ((N/hop - 1) hop > 5120 floats:
// N 8190, hop 910) a block takes one source and a group a pair of its
// frames, with one carry.
//
// wiener_direct_kernel, a direct O(N) sum per output sample in one
// 512-thread block per pair and row range with the host's float64-made
// table of e^{-2 pi i m / N}, served the sizes off the core before the split
// and Bluestein did; it serves none now, and wiener_direct_pallas forces it
// at any even size up to 8192 that is not a power of two.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wiener_common.cuh"

namespace wiener {
// The split's and Bluestein's instances live in translation units of their
// own (wiener_split.cu, wiener_bluestein.cu), which nvcc builds beside this
// one: in one file their 37 instances kept the build past 100 s.
cudaError_t launch_split(int m, int log2p, const Args& a, const float2* tw_n, unsigned blocks,
                         int groups, int rounds, cudaStream_t stream);
cudaError_t launch_bluestein(int log2m, bool frame_pairs, const Args& a, const float2* chirp,
                             const float2* chat, int nfft, unsigned blocks, int groups,
                             int rounds, cudaStream_t stream);
}  // namespace wiener

namespace {

using namespace wiener;

constexpr int kDirectThreads = 512;
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory a block may use

template <int LOG2N>
__global__ void __launch_bounds__(kMaxThreads) wiener_fft_kernel(Args a, int rounds) {
  using F = Fft<LOG2N>;
  constexpr int N = F::N;
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / F::T;
  const int group = threadIdx.x / F::T;
  const int j = threadIdx.x - group * F::T;
  const int hop = a.hop;
  const int k = N / hop;  // frames that overlap one hop row
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* bufs = tws + twiddle_len(LOG2N);
  float* carry = reinterpret_cast<float*>(bufs + groups * exchange_len(LOG2N));  // 2 (k-1) hop
  float* carry1 = carry + (k - 1) * hop;
  const Place pl = place(a, blockIdx.x);
  const int j_end = min(pl.j0 + a.rows, a.nf + k - 1);

  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) tws[slot(i)] = __ldg(a.tw + i);
  for (int i = threadIdx.x; i < 2 * (k - 1) * hop; i += blockDim.x) carry[i] = 0.f;
  __syncthreads();

  float2* buf = bufs + group * exchange_len(LOG2N);
  for (int r = 0; r < rounds; ++r) {
    const int fr = pl.j0 - (k - 1) + r * groups;  // first frame of the round
    const int f = fr + group;
    const bool live = f >= 0 && f < a.nf;
    float2 v[kPoints];
    inverse_points<LOG2N>(v, j, [&](int kk, bool edge) {
      return live ? masked_bin(a, pl, N, f, kk, edge) : make_float4(0.f, 0.f, 0.f, 0.f);
    });
    F::run(v, buf, tws, j, group);
    __syncthreads();  // every group's frame is in its buffer
    // rows fr .. fr + G + k - 2 meet the round's frames; rows below fr + G
    // are complete after it, the k - 1 above carry on to the next round
    for (int u = threadIdx.x; u < hop; u += blockDim.x) {
      for (int i = 0; i < groups + k - 1; ++i) {
        const int row = fr + i;
        float v0 = i < k - 1 ? carry[i * hop + u] : 0.f;
        float v1 = i < k - 1 ? carry1[i * hop + u] : 0.f;
        const int f_lo = max(fr, row - k + 1), f_hi = min(fr + groups - 1, row);
        for (int ff = f_lo; ff <= f_hi; ++ff) {
          const int t = (row - ff) * hop + u;
          const float2 z = bufs[(ff - fr) * exchange_len(LOG2N) + slot(t)];
          const float w = __ldg(a.win_over_n + t);
          v0 += w * z.x;
          v1 += w * -z.y;
        }
        if (i >= groups) {
          carry[(i - groups) * hop + u] = v0;
          carry1[(i - groups) * hop + u] = v1;
        } else if (row >= pl.j0 && row < j_end) {
          store_pair(a, pl, row, u, N, v0, v1);
        }
      }
    }
    __syncthreads();  // the buffers are read; the next round's first pass rewrites them
  }
}

// N even but not a power of two in [16, 8192], forced: z[t] = sum_k Z[k]
// e^{+2 pi i k t / N} per sample, one frame of the pair at a time, summed
// in shared memory over the block's R hop rows.
__global__ void __launch_bounds__(kDirectThreads) wiener_direct_kernel(Args a, int N) {
  extern __shared__ float4 smem4[];
  const int half = N / 2, hop = a.hop, k = N / hop;
  float2* tab = reinterpret_cast<float2*>(smem4);   // N: e^{-2 pi i m / N}
  float2* buf = tab + N;                              // N: Z in natural order
  float* acc = reinterpret_cast<float*>(buf + N);     // 2 R hop
  float* acc1 = acc + a.rows * hop;
  const int tid = threadIdx.x;
  const Place pl = place(a, blockIdx.x);
  const int nrows = min(a.rows, a.nf + k - 1 - pl.j0);
  for (int i = tid; i < N; i += kDirectThreads) tab[i] = __ldg(a.tw + i);
  for (int i = tid; i < 2 * a.rows * hop; i += kDirectThreads) acc[i] = 0.f;
  const int f_lo = max(0, pl.j0 - k + 1), f_hi = min(a.nf - 1, pl.j0 + nrows - 1);
  for (int f = f_lo; f <= f_hi; ++f) {
    __syncthreads();  // the previous frame's readers of buf are done
    for (int kk = tid; kk <= half; kk += kDirectThreads) {
      const bool edge = kk == 0 || kk == half;
      const float4 ab = masked_bin(a, pl, N, f, kk, edge);  // Z = A + i B
      buf[kk] = make_float2(ab.x - ab.w, ab.y + ab.z);
      if (!edge) buf[N - kk] = make_float2(ab.x + ab.w, ab.z - ab.y);
    }
    __syncthreads();
    for (int t = tid; t < N; t += kDirectThreads) {
      const int row = f + t / hop - pl.j0;
      if (row < 0 || row >= nrows) continue;
      float zr = 0.f, zi = 0.f;
      int idx = 0;
      for (int kk = 0; kk < N; ++kk) {  // Z[kk] conj(tab[kk t mod N])
        const float2 w = tab[idx], z = buf[kk];
        zr += z.x * w.x + z.y * w.y;
        zi += z.y * w.x - z.x * w.y;
        idx += t;
        if (idx >= N) idx -= N;
      }
      const float wv = __ldg(a.win_over_n + t);
      acc[row * hop + t % hop] += wv * zr;
      acc1[row * hop + t % hop] += wv * zi;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * hop; i += kDirectThreads)
    store_pair(a, pl, pl.j0 + i / hop, i % hop, N, acc[i], acc1[i]);
}

template <int LOG2N>
cudaError_t launch_fft(const Args& a, unsigned blocks, int groups, int rounds,
                       cudaStream_t stream) {
  const int k = (1 << LOG2N) / a.hop;
  const size_t smem = (size_t)(twiddle_len(LOG2N) + groups * exchange_len(LOG2N)) * sizeof(float2) +
                      (size_t)2 * (k - 1) * a.hop * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wiener_fft_kernel<LOG2N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  wiener_fft_kernel<LOG2N><<<blocks, groups * fft_threads(LOG2N), smem, stream>>>(a, rounds);
  return cudaGetLastError();
}

// One block an SM by its launch bound, so each instance may hold 128
// registers: under the bound of 512 threads alone ptxas gave the C 8
// instance 64 and 648 bytes of stack, 1.1x slower at 32 768 points on an
// H100 (PERF.md row 1″).
template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1) wiener_cluster_kernel(
    Args a, const float2* __restrict__ chirp, const float2* __restrict__ chat, int nfft,
    int rounds) {
  extern __shared__ float4 smem4[];
  wiener_cluster_block<kMaxLog2, C>(smem4, a, chirp, chat, nfft, rounds);
}

// One block an SM, as wiener_cluster_kernel.
template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1) wiener_cluster_dit_kernel(Args a, int rounds) {
  extern __shared__ float4 smem4[];
  wiener_cluster_dit_block<kMaxLog2, C>(smem4, a, rounds);
}

// clusters of C blocks, one pair of sources and a.rows hop rows of a track
// each, a.pairs clusters a row range; with `active`, launches nothing and
// sets how many such clusters the card holds at once
template <int C>
cudaError_t launch_wiener_cluster(const Args& a, const float2* chirp, const float2* chat,
                                  long long clusters, int nfft, int rounds, cudaStream_t stream,
                                  int* active) {
  const int k = nfft / a.hop;
  return launch_clusters<C>(wiener_cluster_kernel<C>, clusters,
                            cluster_smem_bytes(kMaxLog2, 2 * (k - 1) * cluster_columns(a.hop, C)),
                            stream, active, a, chirp, chat, nfft, rounds);
}

// the same for the powers of two, N = 8192 C (C 2 or 4)
template <int C>
cudaError_t launch_wiener_cluster_dit(const Args& a, long long clusters, int rounds,
                                      cudaStream_t stream, int* active) {
  const int k = (C << kMaxLog2) / a.hop;
  return launch_clusters<C>(wiener_cluster_dit_kernel<C>, clusters,
                            cluster_smem_bytes(kMaxLog2, 2 * (k - 1) * cluster_columns(a.hop, C)),
                            stream, active, a, rounds);
}

// One block an SM, as wiener_cluster_kernel.
template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1) wiener_cluster_mixed_kernel(
    Args a, int n, int rounds, unsigned long long sched) {
  extern __shared__ float4 smem4[];
  wiener_cluster_mixed_block<C, kMaxThreads>(smem4, a, n, rounds, sched);
}

// the same for the 7-smooth block core, N = C n (C 2 to 6)
template <int C>
cudaError_t launch_wiener_cluster_mixed(const Args& a, long long clusters, int n, int rounds,
                                        unsigned long long sched, cudaStream_t stream,
                                        int* active) {
  const int k = C * n / a.hop;
  return launch_clusters<C>(wiener_cluster_mixed_kernel<C>, clusters,
                            cluster_mixed_smem_bytes(n, 2 * (k - 1) * cluster_columns(a.hop, C)),
                            stream, active, a, n, rounds, sched);
}

// The cluster launches' common arguments: R = rounds - (k - 1) hop rows a
// cluster, a.pairs clusters a row range; false where R < 1.
bool cluster_args(Args* a, int nf, int nfft, int hop, int rounds) {
  a->rows = rounds - (nfft / hop - 1);
  if (a->rows < 1) return false;
  a->per_signal = (nf + nfft / hop - 1 + a->rows - 1) / a->rows;
  return true;
}

}  // namespace

// Routes by nfft: powers of two in [16, 8192] to wiener_fft_kernel (tw the
// quarter twiddle table, fft_plan.twiddles); the split's sizes to
// wiener_split_kernel (tw the 2^a-point quarter table, tw_n the nfft-point
// one); the other even sizes up to 8192 to wiener_bluestein_kernel (tw the
// M-point quarter table, chirp (nfft) and chat (M) from
// fft_plan.bluestein_tables; frame pairs on the level where the two carries
// do not fit). groups, rounds: fft_plan.wiener_plan. groups = 0 forces the
// direct sum at any even size up to 8192 off the core (tw the full table
// e^{-2 pi i m / nfft}, fft_plan.dft_table; rounds its hop rows per block).
// Pointers a route does not read may be null.
extern "C" int wiener_istft_launch(
    const void* y, int y_bf16, const void* re, const void* im, const void* ny,
    const void* win_over_n, const void* inv_norm, const void* tw, const void* tw_n,
    const void* chirp, const void* chat, void* out, int out_int16, int nt, int S, int nf,
    int nfft, int hop, int length, int groups, int rounds, int p2, float eps, int conserve_last,
    void* stream) {
  if (nfft < 16 || nfft > 8192 || nfft % 2 != 0 || hop < 1 || nfft % hop != 0 || nt < 1 ||
      S < 1 || nf < 1 || rounds < 1 || groups < 0)
    return (int)cudaErrorInvalidValue;
  const int k = nfft / hop;
  const int log2n = plan_log2(nfft);
  Args a{y, static_cast<const float*>(re), static_cast<const float*>(im),
         static_cast<const float*>(ny), static_cast<const float*>(win_over_n),
         static_cast<const float*>(inv_norm), static_cast<const float2*>(tw), out, y_bf16,
         out_int16, S, nf, hop, length, p2, conserve_last, eps, 0, 0, (S + 1) / 2};
  auto s = static_cast<cudaStream_t>(stream);
  if (groups == 0) {  // the direct sum
    if (log2n) return (int)cudaErrorInvalidValue;
    a.rows = rounds;
    a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
    const size_t smem = (size_t)2 * nfft * sizeof(float2) + (size_t)2 * a.rows * hop * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(wiener_direct_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    wiener_direct_kernel<<<(unsigned)((long long)nt * a.per_signal * a.pairs), kDirectThreads,
                           smem, s>>>(a, nfft);
    return (int)cudaGetLastError();
  }
  int m, log2p;
  if (split_sizes(nfft, &m, &log2p)) {
    const int threads = groups * (nfft / kPoints);
    if (threads > kMaxThreads || threads % 32 != 0) return (int)cudaErrorInvalidValue;
    a.rows = groups * rounds - (k - 1);
    if (a.rows < 1) return (int)cudaErrorInvalidValue;
    a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
    const unsigned blocks = (unsigned)((long long)nt * a.per_signal * a.pairs);
    return (int)launch_split(m, log2p, a, static_cast<const float2*>(tw_n), blocks, groups,
                             rounds, s);
  }
  if (!log2n) {  // Bluestein
    const int log2m = bluestein_log2(nfft);
    const int t = bluestein_threads(log2m);
    if (log2m > kLevelLog2 || groups * t > kMaxThreads || groups * t % 32 != 0 ||
        (t > 32 && groups > 8))
      return (int)cudaErrorInvalidValue;
    const bool frame_pairs = log2m == kLevelLog2 &&
                             wiener_bluestein_smem_bytes(log2m, nfft, hop, groups, 2) > kSmemMax;
    a.rows = (frame_pairs ? 2 : 1) * groups * rounds - (k - 1);
    if (a.rows < 1) return (int)cudaErrorInvalidValue;
    a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
    const unsigned blocks =
        (unsigned)((long long)nt * a.per_signal * (frame_pairs ? S : a.pairs));
    return (int)launch_bluestein(log2m, frame_pairs, a, static_cast<const float2*>(chirp),
                                 static_cast<const float2*>(chat), nfft, blocks, groups, rounds,
                                 s);
  }
  if (groups * fft_threads(log2n) > kMaxThreads ||
      groups * fft_threads(log2n) % 32 != 0 || (fft_threads(log2n) > 32 && groups > 8))
    return (int)cudaErrorInvalidValue;
  a.rows = groups * rounds - (k - 1);
  if (a.rows < 1) return (int)cudaErrorInvalidValue;
  a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
  const unsigned blocks = (unsigned)((long long)nt * a.per_signal * a.pairs);
  switch (log2n) {
#define CASE(L) \
  case L: return (int)launch_fft<L>(a, blocks, groups, rounds, s);
    CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10) CASE(11) CASE(12)
    default: return (int)launch_fft<13>(a, blocks, groups, rounds, s);
#undef CASE
  }
}

// The cluster route: even 8192 < nfft <= 32 768 (Bluestein's M = 32 768 or
// 65 536: a cluster of 4 or 8 blocks of 512 threads a pair of sources, one
// frame a round); tw the M-point quarter table (fft_plan.twiddles), chirp
// (nfft) and chat (M) from fft_plan.bluestein_tables; rounds from
// fft_plan.wiener_cluster_plan, each cluster owning rounds - (nfft/hop - 1)
// hop rows. With `active` (y and the other arrays may then be null),
// launches nothing and sets how many clusters of the launch the card holds
// at once (cudaOccupancyMaxActiveClusters).
extern "C" int wiener_cluster_launch(
    const void* y, int y_bf16, const void* re, const void* im, const void* ny,
    const void* win_over_n, const void* inv_norm, const void* tw, const void* chirp,
    const void* chat, void* out, int out_int16, int nt, int S, int nf, int nfft, int hop,
    int length, int rounds, int p2, float eps, int conserve_last, int* active, void* stream) {
  const int log2m = nfft >= 2 ? bluestein_log2(nfft) : 0;
  if (nfft <= (1 << kMaxLog2) || nfft % 2 != 0 || log2m < kMaxLog2 + 2 || log2m > kMaxLog2 + 3 ||
      hop < 1 || nfft % hop != 0 || nt < 1 || S < 1 || nf < 1)
    return (int)cudaErrorInvalidValue;
  Args a{y, static_cast<const float*>(re), static_cast<const float*>(im),
         static_cast<const float*>(ny), static_cast<const float*>(win_over_n),
         static_cast<const float*>(inv_norm), static_cast<const float2*>(tw), out, y_bf16,
         out_int16, S, nf, hop, length, p2, conserve_last, eps, 0, 0, (S + 1) / 2};
  if (!cluster_args(&a, nf, nfft, hop, rounds)) return (int)cudaErrorInvalidValue;
  const long long clusters = (long long)nt * a.per_signal * a.pairs;
  const auto* cc = static_cast<const float2*>(chirp);
  const auto* ch = static_cast<const float2*>(chat);
  auto s = static_cast<cudaStream_t>(stream);
  if (log2m == kMaxLog2 + 2)
    return (int)launch_wiener_cluster<4>(a, cc, ch, clusters, nfft, rounds, s, active);
  return (int)launch_wiener_cluster<8>(a, cc, ch, clusters, nfft, rounds, s, active);
}

// The powers of two past 8192, nfft 16 384 or 32 768: the direct inverse by
// decimation in time on a cluster of nfft / 8192 blocks (2 or 4) of 512
// threads a pair of sources, one frame a round; tw the nfft-point quarter
// table (fft_plan.twiddles); rounds from fft_plan.wiener_cluster_dit_plan,
// each cluster owning rounds - (nfft/hop - 1) hop rows. `active` as
// wiener_cluster_launch's.
extern "C" int wiener_cluster_dit_launch(
    const void* y, int y_bf16, const void* re, const void* im, const void* ny,
    const void* win_over_n, const void* inv_norm, const void* tw, void* out, int out_int16,
    int nt, int S, int nf, int nfft, int hop, int length, int rounds, int p2, float eps,
    int conserve_last, int* active, void* stream) {
  if ((nfft != 2 << kMaxLog2 && nfft != 4 << kMaxLog2) || hop < 1 || nfft % hop != 0 || nt < 1 ||
      S < 1 || nf < 1)
    return (int)cudaErrorInvalidValue;
  Args a{y, static_cast<const float*>(re), static_cast<const float*>(im),
         static_cast<const float*>(ny), static_cast<const float*>(win_over_n),
         static_cast<const float*>(inv_norm), static_cast<const float2*>(tw), out, y_bf16,
         out_int16, S, nf, hop, length, p2, conserve_last, eps, 0, 0, (S + 1) / 2};
  if (!cluster_args(&a, nf, nfft, hop, rounds)) return (int)cudaErrorInvalidValue;
  const long long clusters = (long long)nt * a.per_signal * a.pairs;
  auto s = static_cast<cudaStream_t>(stream);
  if (nfft == 2 << kMaxLog2)
    return (int)launch_wiener_cluster_dit<2>(a, clusters, rounds, s, active);
  return (int)launch_wiener_cluster_dit<4>(a, clusters, rounds, s, active);
}

// The 7-smooth even sizes past 8192 up to 32 768 (fft_plan.mixed_factors:
// nfft = C n, n = 2^a 3^b 5^c 7^d; C 2 or 4 at 10 000, 14 000, 20 000 and
// 133 more, C 3, 5 or 6 at 22 050 = 3 x 7350, 30 618 = 6 x 5103 and 11
// more; not 17 150 = 5 x 3430, whose last block's 1715 bins are under the
// four unguarded strides of the mask loads): the
// direct inverse by decimation in time on a cluster of C blocks of 512
// threads a pair of sources, one frame a round, each block's n points on
// the mixed-radix core in the passes of `sched` (fft_plan.mixed_schedule:
// their radices multiply to n); tw the nfft-point table e^{-2 pi i m /
// nfft} (fft_plan.dft_table); rounds from fft_plan.wiener_cluster_mixed_plan,
// each cluster owning rounds - (nfft/hop - 1) hop rows. `active` as
// wiener_cluster_launch's.
extern "C" int wiener_cluster_mixed_launch(
    const void* y, int y_bf16, const void* re, const void* im, const void* ny,
    const void* win_over_n, const void* inv_norm, const void* tw, void* out, int out_int16,
    int nt, int S, int nf, int nfft, int hop, int length, int rounds, long long sched, int p2,
    float eps, int conserve_last, int* active, void* stream) {
  int c, n;
  if (!mixed_sizes(nfft, &c, &n) || nfft % 2 || nfft > (4 << kMaxLog2) ||
      !mixed_schedule_ok(n, (unsigned long long)sched) || hop < 1 || nfft % hop != 0 || nt < 1 ||
      S < 1 || nf < 1)
    return (int)cudaErrorInvalidValue;
  const int half = nfft / 2, share = (half + c - 1) / c;
  if (half - (c - 1) * share < 4 * kMaxThreads)  // the last block's bins: each unguarded stride
    return (int)cudaErrorInvalidValue;
  Args a{y, static_cast<const float*>(re), static_cast<const float*>(im),
         static_cast<const float*>(ny), static_cast<const float*>(win_over_n),
         static_cast<const float*>(inv_norm), static_cast<const float2*>(tw), out, y_bf16,
         out_int16, S, nf, hop, length, p2, conserve_last, eps, 0, 0, (S + 1) / 2};
  if (!cluster_args(&a, nf, nfft, hop, rounds)) return (int)cudaErrorInvalidValue;
  const long long clusters = (long long)nt * a.per_signal * a.pairs;
  auto s = static_cast<cudaStream_t>(stream);
  const auto q = (unsigned long long)sched;
  switch (c) {  // an even nfft <= 32 768 takes C 2 to 6
    case 2: return (int)launch_wiener_cluster_mixed<2>(a, clusters, n, rounds, q, s, active);
    case 3: return (int)launch_wiener_cluster_mixed<3>(a, clusters, n, rounds, q, s, active);
    case 4: return (int)launch_wiener_cluster_mixed<4>(a, clusters, n, rounds, q, s, active);
    case 5: return (int)launch_wiener_cluster_mixed<5>(a, clusters, n, rounds, q, s, active);
    default: return (int)launch_wiener_cluster_mixed<6>(a, clusters, n, rounds, q, s, active);
  }
}
