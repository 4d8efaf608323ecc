// The Wiener+iSTFT kernels' device code shared by csrc/wiener_istft.cu and
// the host emulations (tests/cuda_host/wiener_cluster.cpp, wiener_split.cpp,
// wiener_bluestein.cpp): the launch's arguments, a block's place in the
// grid, the masked spectrum points (masked_bin), a finished sample pair
// (store_pair), and the kernels on the mixed-radix split
// (wiener_split_block), on Bluestein (wiener_bluestein_block) and on a
// thread-block cluster (wiener_cluster_block, Bluestein;
// wiener_cluster_dit_block, the powers of two by decimation in time;
// wiener_cluster_mixed_block, the same on the 7-smooth block core).
// wiener_istft.cu's header says what the kernels compute, what bounds them
// and how they are built.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace wiener {

using namespace fft_common;

__device__ __forceinline__ float relu_pow(float v, int p2) {
  v = v > 0.f ? v : 0.f;
  return p2 ? v * v : v;
}

struct Args {
  const void* y;
  const float* re;
  const float* im;
  const float* ny;  // null: re/im carry all N/2 + 1 bins
  const float* win_over_n;
  const float* inv_norm;
  const float2* tw;
  void* out;
  int y_bf16, out_int16, S, nf, hop, length, p2, conserve_last;
  float eps;
  int rows, per_signal, pairs;
};

// The place of a block (or of a cluster) `index` of the grid: track n, its
// pair of sources and its first hop row.
struct Place {
  int n, s0, j0;
  bool has1;
};

__device__ __forceinline__ Place place(const Args& a, int index) {
  const int pair = index % a.pairs;  // the pairs of a row range run together
  const int rest = index / a.pairs;
  const int n = rest / a.per_signal;
  return {n, 2 * pair, (rest - n * a.per_signal) * a.rows, 2 * pair + 1 < a.S};
}

// The relu'd magnitude (squared with p2) of source row offset i of y.
__device__ __forceinline__ float y_at(const Args& a, long long i) {
  return relu_pow(a.y_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(a.y) + i))
                           : __ldg(static_cast<const float*>(a.y) + i), a.p2);
}

// y_at through one byte address for either dtype: a load needs one
// address register pair where y_at's two dtypes need two.
__device__ __forceinline__ float y_shift(const Args& a, long long i) {
  const char* p = static_cast<const char*>(a.y) + (i << (a.y_bf16 ? 1 : 2));
  return relu_pow(a.y_bf16 ? __bfloat162float(__ldg(reinterpret_cast<const __nv_bfloat16*>(p)))
                           : __ldg(reinterpret_cast<const float*>(p)), a.p2);
}

// The masks of sources s0 and s1 from the denominator's source sum d and
// their magnitudes ya, yb, times the mixture bin (mr, mi): (Re A, Im A, Re
// B, Im B). The ratio follows models/masks.py::wiener_mask: the denominator
// sums the sources in order, then adds eps; conserve_last adds eps to the
// last source's numerator.
__device__ __forceinline__ float4 mask_pair(const Args& a, const Place& pl, float d, float ya,
                                            float yb, float mr, float mi) {
  d += a.eps;
  if (a.conserve_last && pl.s0 == a.S - 1) ya += a.eps;
  if (a.conserve_last && pl.s0 + 1 == a.S - 1) yb += a.eps;
  const float ma = ya / d, mb = pl.has1 ? yb / d : 0.f;
  return make_float4(ma * mr, ma * mi, mb * mr, mb * mi);
}

// The masked half-spectra of sources s0 (A) and s1 (B) at bin kk of frame f
// of track n, as (Re A, Im A, Re B, Im B); imaginary parts 0 at the edges.
__device__ __forceinline__ float4 masked_bin(const Args& a, const Place& pl, int N, int f,
                                             int kk, bool edge) {
  const int half = N / 2, bins = half + 1;
  const long long frame = (long long)pl.n * a.nf + f;
  const long long mix = frame * (a.ny ? half : bins) + kk;
  const float mr = a.ny && kk == half ? __ldg(a.ny + frame) : __ldg(a.re + mix);
  const float mi = edge ? 0.f : __ldg(a.im + mix);
  const long long src = (long long)a.nf * bins;
  const long long y0 = ((long long)pl.n * a.S * a.nf + f) * bins + kk;
  float d = 0.f, ya = 0.f, yb = 0.f;
  for (int s = 0; s < a.S; ++s) {
    const float q = y_at(a, y0 + s * src);
    d += q;
    ya = s == pl.s0 ? q : ya;
    yb = s == pl.s0 + 1 ? q : yb;
  }
  return mask_pair(a, pl, d, ya, yb, mr, mi);
}

// masked_bin at the K bins k0 + stride i (i < K) of frame f, all below
// Nyquist (bin 0 an edge), the same arithmetic in the same order: the
// loads go source by source, each source's K bins at once, so they are in
// flight together; neighbouring threads' k0 are neighbouring bins. Only
// the first KF bins (all K by default) are read unguarded: bin k0 + stride i
// for i >= KF is read only below k_end (the others come out 0), for a share
// of bins that is not K strides of every thread. Such a bin's load is never
// skipped by a branch, which would serialize the loads behind it: it reads
// min(bin, k_end - 1) and selects 0 past k_end. With kLean the source loop
// keeps only the denominators, and the pair's own magnitudes are read again
// after it (from L1), each y load through one address (y_shift): in
// wiener_cluster_mixed_block, whose share needs the guards' registers, the
// loads then spill nothing (48 bytes without); wiener_cluster_dit_block,
// which spills nothing either way, keeps the one pass (4-5 % faster on an
// H100).
template <int K, int KF = K, bool kLean = false>
__device__ __forceinline__ void masked_bins(float4 (&ab)[K], const Args& a, const Place& pl,
                                            int N, int f, int k0, int stride, int k_end = 0) {
  const int half = N / 2, bins = half + 1;
  const long long frame = (long long)pl.n * a.nf + f;
  const long long mix = frame * (a.ny ? half : bins) + k0;
  const long long src = (long long)a.nf * bins;
  const long long y0 = ((long long)pl.n * a.S * a.nf + f) * bins + k0;
  float d[K], ya[K], yb[K];
#pragma unroll
  for (int i = 0; i < K; ++i) d[i] = ya[i] = yb[i] = 0.f;
  // the offset of bin i from k0 that is read, and whether it counts
  const auto at = [&](int i) {
    return i < KF ? i * stride : min(k0 + i * stride, k_end - 1) - k0;
  };
  const auto in = [&](int i) { return i < KF || k0 + i * stride < k_end; };
  for (int s = 0; s < a.S; ++s) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float q0 = kLean ? y_shift(a, y0 + s * src + at(i)) : y_at(a, y0 + s * src + at(i));
      const float q = in(i) ? q0 : 0.f;
      d[i] += q;
      if constexpr (!kLean) {
        ya[i] = s == pl.s0 ? q : ya[i];
        yb[i] = s == pl.s0 + 1 ? q : yb[i];
      }
    }
  }
  if constexpr (kLean) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float qa = y_shift(a, y0 + pl.s0 * src + at(i));
      const float qb = pl.has1 ? y_shift(a, y0 + (pl.s0 + 1) * src + at(i)) : 0.f;
      ya[i] = in(i) ? qa : 0.f;
      yb[i] = in(i) ? qb : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float mr = __ldg(a.re + mix + at(i));
    const float mi = k0 + at(i) == 0 ? 0.f : __ldg(a.im + mix + at(i));
    ab[i] = mask_pair(a, pl, d[i], ya[i], yb[i], in(i) ? mr : 0.f, in(i) ? mi : 0.f);
  }
}

// The place of block `index` of a grid of one source a block (S blocks a
// row range; Bluestein's frame pairs): track n, source s0 and its first hop
// row, with no second source.
__device__ __forceinline__ Place place_source(const Args& a, int index) {
  const int s = index % a.S;
  const int rest = index / a.S;
  const int n = rest / a.per_signal;
  return {n, s, (rest - n * a.per_signal) * a.rows, false};
}

// A finished sample of sources s0 and s1 at hop row `row`, column u.
__device__ __forceinline__ void store_pair(const Args& a, const Place& pl, int row, int u,
                                           int win, float v0, float v1) {
  const long long nabs = (long long)row * a.hop + u;
  const long long tpos = nabs - win / 2;
  if (tpos < 0 || tpos >= a.length) return;
  const float inv = __ldg(a.inv_norm + nabs);
  const long long o = ((long long)pl.n * a.S + pl.s0) * a.length + tpos;
  write_sample(a.out, a.out_int16, o, v0 * inv);
  if (pl.has1) write_sample(a.out, a.out_int16, o + a.length, v1 * inv);
}

// One round's overlap-add on a cluster block's columns [u0, u0 + ncols) of
// every hop row (cluster_columns, cols a row): frame f's sample t = i hop +
// u, sample(t) = N conj(a[t] + i b[t]) read across the cluster as it is
// consumed, lies in hop row f + i; its real part goes to s0, its imaginary
// part, negated, to s1; row f completes with it and rows f + 1 .. f + k - 1
// carry on in carry0 and carry1 ((k - 1) cols floats each), so each sample
// sums its win/hop frames in ascending order, with no atomics; rows in
// [j0, j_end) are written by store_pair.
template <class Sample>
__device__ __forceinline__ void cluster_pair_gather(Sample sample, float* carry0, float* carry1,
                                                    const Args& a, const Place& pl, int N, int f,
                                                    int cols, int u0, int ncols, int j_end) {
  const int hop = a.hop, k = N / hop;
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const int u = u0 + c;
    for (int i = 0; i < k; ++i) {
      const int t = i * hop + u;
      const float2 z = sample(t);
      const float w = __ldg(a.win_over_n + t);
      const float v0 = (i < k - 1 ? carry0[i * cols + c] : 0.f) + w * z.x;
      const float v1 = (i < k - 1 ? carry1[i * cols + c] : 0.f) + w * -z.y;
      if (i >= 1) {
        carry0[(i - 1) * cols + c] = v0;
        carry1[(i - 1) * cols + c] = v1;
      } else if (f >= pl.j0 && f < j_end) {
        store_pair(a, pl, f, u, N, v0, v1);
      }
    }
  }
}

// The Wiener+iSTFT for even 8192 < N <= 32 768 on a cluster of C blocks
// (M = 8192 C, C 4 or 8): istft_cluster_block with two changes.
// * The points. Cluster q = blockIdx.x / C is one pair of sources (s0, s0 +
//   1) and R hop rows of one track (place), and a round transforms one
//   frame f of the pair, Z = A + i B with A and B the masked spectra of s0
//   and s1: each block's first stage loads its points straight from y and
//   the mixture through masked_bin (the denominator over all S sources in
//   order, then + eps, conserve_last, bf16 or f32 y, the ny row), conj Z[t]
//   conj c_t for t < N (inverse_point, the mirrored bin past Nyquist).
// * The gather. Block r owns the r-th 1/C of every hop row's columns
//   (cluster_columns) and keeps two carries of (k - 1) of them, one a
//   source (cluster_pair_gather), each sample chirp[t] conj(Z[t]) = N
//   conj(a[t] + i b[t]).
// A cluster barrier ends each round (the peers have read the buffers the
// next round rewrites). Every thread runs every round and every barrier (a
// frame outside [0, nf) loads zeros). a.tw is the M-point quarter table,
// chirp (N) and chat (M) fft_plan.bluestein_tables; smem4 the block's
// dynamic shared memory (cluster_smem_bytes with 2 (k - 1) columns' carry).
// The power-of-two sizes run wiener_cluster_dit_block, the 7-smooth ones
// that won their A/B wiener_cluster_mixed_block.
template <int LOG2P, int C>
__device__ __forceinline__ void wiener_cluster_block(float4* smem4, const Args& a,
                                                     const float2* __restrict__ chirp,
                                                     const float2* __restrict__ chat, int N,
                                                     int rounds) {
  using CC = ClusterChirp<LOG2P, C>;
  const int rank = blockIdx.x % C;
  const Place pl = place(a, blockIdx.x / C);
  const int k = N / a.hop;  // frames that overlap one hop row
  const int cols = cluster_columns(a.hop, C);
  const int u0 = rank * cols;
  const int ncols = max(0, min(cols, a.hop - u0));
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + CC::TABLES;
  float* carry0 = reinterpret_cast<float*>(buf + exchange_len(LOG2P));  // (k - 1) cols
  float* carry1 = carry0 + (k - 1) * cols;
  const int j_end = min(pl.j0 + a.rows, a.nf + k - 1);

  CC::load_tables(tws, a.tw);
  for (int i = threadIdx.x; i < 2 * (k - 1) * cols; i += blockDim.x) carry0[i] = 0.f;
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    const int f = pl.j0 - (k - 1) + r;  // the round's frame
    const bool live = f >= 0 && f < a.nf;
    CC::convolve(
        [&](int t) {
          if (t >= N || !live) return make_float2(0.f, 0.f);
          const float2 z = inverse_point(t, N, [&](int kk, bool edge) {
            return masked_bin(a, pl, N, f, kk, edge);
          });
          return cmul(z, __ldg(chirp + t));
        },
        buf, tws, a.tw, chat, rank, threadIdx.x);
    cluster_pair_gather(
        [&](int t) {
          const float2 zb = CC::point(buf, a.tw, t);
          return cmul(__ldg(chirp + t), make_float2(zb.x, -zb.y));
        },
        carry0, carry1, a, pl, N, f, cols, u0, ncols, j_end);
    cluster_sync();  // the peers have read this round's buffers
  }
}

// The Wiener+iSTFT at the powers of two past 8192, N = 2^LOG2P C (the
// reference's 16 384 on C = 2 blocks, 32 768 on C = 4): the direct inverse
// by decimation in time over the cluster (ClusterDit), without Bluestein's
// chirp and first transform. Cluster q = blockIdx.x / C is one pair of
// sources and R hop rows of a track (place), one frame f of the pair a
// round, as wiener_cluster_block. A round:
// 1. block r masks its contiguous 1/C of the bins, [r P/2, (r + 1) P/2)
//    (the last block also Nyquist), eight a thread at a stride of the
//    block (masked_bins: neighbouring threads read neighbouring bins, and
//    each bin's mask is formed once a frame), and puts both points of conj
//    Z, Z = A + i B, a bin gives (k and N - k, as inverse_point forms them)
//    into the blocks that own them (ClusterDit::put); a cluster barrier;
// 2. ClusterDit::run_staged: each block's Fft<LOG2P> on its points t = r
//    (mod C), the combine's twiddle in place, a cluster barrier;
// 3. the gather reads Z[t] = N conj(a[t] + i b[t]) across the cluster
//    (ClusterDit::point) for the block's 1/C of the hop columns, with the
//    two sources' carries (cluster_pair_gather); a cluster barrier (the
//    peers have read the buffers the next round's puts rewrite).
// Every thread runs every round and every barrier (a frame outside [0, nf)
// puts zeros). a.tw is the N-point quarter table (fft_plan.twiddles);
// smem4 the block's dynamic shared memory (cluster_smem_bytes with 2 (k -
// 1) columns' carry).
template <int LOG2P, int C>
__device__ __forceinline__ void wiener_cluster_dit_block(float4* smem4, const Args& a,
                                                         int rounds) {
  using D = ClusterDit<LOG2P, C>;
  constexpr int N = D::M;
  constexpr int K = D::P / 2 / D::T;  // bins a thread masks: 8
  const int rank = blockIdx.x % C;
  const Place pl = place(a, blockIdx.x / C);
  const int k = N / a.hop;  // frames that overlap one hop row
  const int cols = cluster_columns(a.hop, C);
  const int u0 = rank * cols;
  const int ncols = max(0, min(cols, a.hop - u0));
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + D::TABLES;
  float* carry0 = reinterpret_cast<float*>(buf + exchange_len(LOG2P));  // (k - 1) cols
  float* carry1 = carry0 + (k - 1) * cols;
  const int j_end = min(pl.j0 + a.rows, a.nf + k - 1);
  const int k0 = rank * (D::P / 2) + threadIdx.x;  // the thread's first bin

  D::load_tables(tws, a.tw);
  for (int i = threadIdx.x; i < 2 * (k - 1) * cols; i += blockDim.x) carry0[i] = 0.f;
  // A cluster barrier, not a block one: the first round's puts write the
  // peers' shared memory, so every block of the cluster must be running.
  cluster_sync();

  for (int r = 0; r < rounds; ++r) {
    const int f = pl.j0 - (k - 1) + r;  // the round's frame
    const bool live = f >= 0 && f < a.nf;
    float4 ab[K];
    if (live) {
      masked_bins(ab, a, pl, N, f, k0, D::T);
    } else {
#pragma unroll
      for (int i = 0; i < K; ++i) ab[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {  // conj Z[kk] and conj Z[N - kk] (inverse_point)
      const int kk = k0 + i * D::T;
      D::put(buf, kk, make_float2(ab[i].x - ab[i].w, -(ab[i].y + ab[i].z)));
      if (kk) D::put(buf, N - kk, make_float2(ab[i].x + ab[i].w, ab[i].y - ab[i].z));
    }
    if (rank == C - 1 && threadIdx.x == 0) {  // Nyquist: real parts only
      const float4 q = live ? masked_bin(a, pl, N, f, N / 2, true)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      D::put(buf, N / 2, make_float2(q.x, -q.z));
    }
    cluster_sync();  // every block's points are in place
    D::run_staged(buf, tws, a.tw, rank, threadIdx.x);  // ends in a cluster barrier
    cluster_pair_gather([&](int t) { return D::point(buf, a.tw, t); }, carry0, carry1, a, pl,
                        N, f, cols, u0, ncols, j_end);
    cluster_sync();  // the peers have read this round's buffers
  }
}

// wiener_cluster_dit_block for even N = C n, n 7-smooth (C 2 or 4, 8232 ...
// 32 400; C 3, 5 or 6, 17 010 ... 31 250; fft_common.cuh's ClusterMixed):
// the same rounds of one frame of a
// pair of sources, each block's n points on the mixed-radix core. A round:
// 1. block r masks its contiguous share of the bins, [r S, (r + 1) S) with
//    S = ceil(N / 2 / C) (n / 2 at even n; the last block also Nyquist), at
//    most eight a thread at a stride of the block (masked_bins, guarded at
//    the share's end), and puts conj Z[k] and conj Z[N - k] into their
//    owners (ClusterMixed::put); a cluster barrier;
// 2. ClusterMixed::run_staged: the block's n-point transform in the passes
//    of `sched` on its points t = r (mod C), the combine's twiddle, a
//    cluster barrier;
// 3. the gather of the block's 1/C of the hop columns, each sample read
//    across the cluster (ClusterMixed::point), with the two sources'
//    carries (cluster_pair_gather); a cluster barrier.
// a.tw is the N-point table e^{-2 pi i m / N} (fft_plan.dft_table), sched
// fft_plan.mixed_schedule(mixed_radices(n)); smem4 holds
// cluster_mixed_smem_bytes with 2 (k - 1) columns' carry. T is blockDim.x
// (the card's 512), n <= 16 T: a stride the compiler knows keeps the mask
// loads' addresses in immediates (a stride read from blockDim.x spilled 72
// bytes at 128 registers). The cluster's place (place, the round's frame,
// the gather's columns and rows) is derived from fresh_block_index twice a
// round, for the mask and again for the gather, not held across the
// transform: held, with the radix-7 pass in mixed_fft, it spilled at 128
// registers.
template <int C, int T>
__device__ __forceinline__ void wiener_cluster_mixed_block(float4* smem4, const Args& a, int n,
                                                           int rounds, unsigned long long sched) {
  using D = ClusterMixed<C>;
  constexpr int K = kPoints / 2;  // bins a thread masks at most: S <= 8 T
  // bins every thread masks: at the card's 512 threads each block's share
  // is at least 2048 bins (2058 at 8232, the last block's 2549 at 30 618 on
  // C 6; wiener_cluster_mixed_launch checks), so the first four strides
  // need no guard
  constexpr int KF = T == kMaxThreads ? 4 : 0;
  const int N = C * n;
  const int half = N / 2;
  const int share = (half + C - 1) / C;
  const int rank = blockIdx.x % C;
  const int k = N / a.hop;  // frames that overlap one hop row
  const int cols = cluster_columns(a.hop, C);
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + n;
  float* carry0 = reinterpret_cast<float*>(buf + split_exchange_len(n));  // (k - 1) cols
  float* carry1 = carry0 + (k - 1) * cols;

  D::load_tables(tws, a.tw, n);
  for (int i = threadIdx.x; i < 2 * (k - 1) * cols; i += blockDim.x) carry0[i] = 0.f;
  // A cluster barrier, not a block one: the first round's puts write the
  // peers' shared memory, so every block of the cluster must be running.
  cluster_sync();

  for (int r = 0; r < rounds; ++r) {
    {
      const Place pl = place(a, fresh_block_index() / C);
      const int f = pl.j0 - (k - 1) + r;  // the round's frame
      const bool live = f >= 0 && f < a.nf;
      const int k0 = rank * share + threadIdx.x;  // the thread's first bin
      const int k_end = min(half, (rank + 1) * share);
      float4 ab[K];
      if (live) {
        masked_bins<K, KF, true>(ab, a, pl, N, f, k0, T, k_end);
      } else {
#pragma unroll
        for (int i = 0; i < K; ++i) ab[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      D::template put_bins<K>(buf, ab, k0, T, k_end, N);  // conj Z[kk], conj Z[N - kk]
      if (rank == C - 1 && threadIdx.x == 0) {  // Nyquist: real parts only
        const float4 q = live ? masked_bin(a, pl, N, f, half, true)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        D::put(buf, half, make_float2(q.x, -q.z));
      }
    }
    cluster_sync();  // every block's points are in place
    D::run_staged(buf, tws, a.tw, n, sched, rank);  // ends in a cluster barrier
    {
      const Place pl = place(a, fresh_block_index() / C);
      const int u0 = rank * cols;
      cluster_pair_gather([&](int t) { return D::point(buf, a.tw, n, t); }, carry0, carry1, a,
                          pl, N, pl.j0 - (k - 1) + r, cols, u0, max(0, min(cols, a.hop - u0)),
                          min(pl.j0 + a.rows, a.nf + k - 1));
    }
    cluster_sync();  // the peers have read this round's buffers
  }
}

// The two sources' overlap-add of one round of `frames` frames from fr on,
// after a block barrier: frame fr + g's samples are sample(g, t) = N conj(a[t]
// + i b[t]) (t < N, a for source s0, b for s1), and rows fr .. fr + frames +
// k - 2 meet them; rows below fr + frames complete with the round, the k - 1
// above carry on in carry0 and carry1 ((k - 1) hop floats each). A thread
// owns columns u and sums, for each row, the carry and the round's frames in
// ascending order (no atomics); rows in [j0, j_end) are written by
// store_pair. wiener_bluestein_block uses it; wiener_fft_kernel and
// wiener_split_block keep the same loop written out.
template <class Sample>
__device__ __forceinline__ void pair_gather(Sample sample, float* carry0, float* carry1,
                                            const Args& a, const Place& pl, int N, int fr,
                                            int frames, int j_end) {
  const int hop = a.hop, k = N / hop;
  for (int u = threadIdx.x; u < hop; u += blockDim.x) {
    for (int i = 0; i < frames + k - 1; ++i) {
      const int row = fr + i;
      float v0 = i < k - 1 ? carry0[i * hop + u] : 0.f;
      float v1 = i < k - 1 ? carry1[i * hop + u] : 0.f;
      const int f_lo = max(fr, row - k + 1), f_hi = min(fr + frames - 1, row);
      for (int f = f_lo; f <= f_hi; ++f) {
        const int t = (row - f) * hop + u;
        const float2 z = sample(f - fr, t);
        const float w = __ldg(a.win_over_n + t);
        v0 += w * z.x;
        v1 += w * -z.y;
      }
      if (i >= frames) {
        carry0[(i - frames) * hop + u] = v0;
        carry1[(i - frames) * hop + u] = v1;
      } else if (row >= pl.j0 && row < j_end) {
        store_pair(a, pl, row, u, N, v0, v1);
      }
    }
  }
}

// Dynamic shared memory of a Wiener split block of `groups` groups: the P-
// and N-point quarter tables, one N-point exchange buffer a group, the two
// sources' carries of (N/hop - 1) hop rows.
inline size_t wiener_split_smem_bytes(int log2p, int m, int hop, int groups) {
  const int n = m << log2p;
  return ((size_t)twiddle_len(log2p) + (size_t)quarter_len(n) +
          (size_t)groups * split_exchange_len(n)) * sizeof(float2) +
         (size_t)2 * (n - hop) * sizeof(float);
}

// The Wiener+iSTFT for N = M 2^LOG2P (M 3, 5, 9, 15; the split's sizes up to
// 8192): istft_split_block with two changes.
// * The points. Block index (place) is one pair of sources (s0, s0 + 1) and
//   R hop rows of one track; a round's group g transforms frame fr + g of
//   the pair, Z = A + i B with A and B the masked spectra of s0 and s1, each
//   thread loading its points at the split's stride straight from y and the
//   mixture through masked_bin (split_inverse_points): no masked spectrum,
//   denominator or mask reaches shared or device memory.
// * The gather. Two carries of (k - 1) hop rows, one a source; frame f's
//   sample t, N conj(a[t] + i b[t]), lies in hop row f + t / hop, its real
//   part goes to s0 and its imaginary part, negated, to s1; each sample sums
//   its N/hop frames in ascending order, with no atomics; written by
//   store_pair. pair_gather's loop written out: through a helper ptxas gave
//   some of the split's instances larger stack frames (istft_split_block).
// The groups share warps (M is odd), so split_run synchronizes the block;
// every thread runs every round (a frame outside [0, nf) loads zeros).
// a.tw is the P-point quarter table, tw_n the N-point one; smem4 the block's
// dynamic shared memory (wiener_split_smem_bytes).
template <int LOG2P, int M>
__device__ __forceinline__ void wiener_split_block(float4* smem4, const Args& a,
                                                   const float2* __restrict__ tw_n, int rounds) {
  constexpr int P = 1 << LOG2P;
  constexpr int N = M * P;
  constexpr int T = N / kPoints;  // threads of one transform
  constexpr int E = split_exchange_len(N);
  const int groups = blockDim.x / T;
  const int group = threadIdx.x / T;
  const int jj = threadIdx.x - group * T;
  const int hop = a.hop;
  const int k = N / hop;  // frames that overlap one hop row
  float2* twp = reinterpret_cast<float2*>(smem4);
  float2* twn = twp + twiddle_len(LOG2P);
  float2* bufs = twn + quarter_len(N);
  float* carry0 = reinterpret_cast<float*>(bufs + groups * E);  // (k - 1) hop
  float* carry1 = carry0 + (k - 1) * hop;
  const Place pl = place(a, blockIdx.x);
  const int j_end = min(pl.j0 + a.rows, a.nf + k - 1);

  for (int i = threadIdx.x; i < P / 4; i += blockDim.x) twp[slot(i)] = __ldg(a.tw + i);
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) twn[slot(i)] = __ldg(tw_n + i);
  for (int i = threadIdx.x; i < 2 * (k - 1) * hop; i += blockDim.x) carry0[i] = 0.f;
  __syncthreads();

  float2* buf = bufs + group * E;
  for (int r = 0; r < rounds; ++r) {
    const int fr = pl.j0 - (k - 1) + r * groups;  // first frame of the round
    const int f = fr + group;
    const bool live = f >= 0 && f < a.nf;
    float2 v[kPoints];
    split_inverse_points<LOG2P, M>(v, jj, [&](int kk, bool edge) {
      return live ? masked_bin(a, pl, N, f, kk, edge) : make_float4(0.f, 0.f, 0.f, 0.f);
    });
    split_run<LOG2P, M>(v, buf, twp, twn, jj, group);  // ends in a block barrier
    for (int u = threadIdx.x; u < hop; u += blockDim.x) {
      for (int i = 0; i < groups + k - 1; ++i) {
        const int row = fr + i;
        float v0 = i < k - 1 ? carry0[i * hop + u] : 0.f;
        float v1 = i < k - 1 ? carry1[i * hop + u] : 0.f;
        const int f_lo = max(fr, row - k + 1), f_hi = min(fr + groups - 1, row);
        for (int ff = f_lo; ff <= f_hi; ++ff) {
          const int t = (row - ff) * hop + u;
          const float2 z = bufs[(ff - fr) * E + slot(t)];
          const float w = __ldg(a.win_over_n + t);
          v0 += w * z.x;
          v1 += w * -z.y;
        }
        if (i >= groups) {
          carry0[(i - groups) * hop + u] = v0;
          carry1[(i - groups) * hop + u] = v1;
        } else if (row >= pl.j0 && row < j_end) {
          store_pair(a, pl, row, u, N, v0, v1);
        }
      }
    }
    __syncthreads();  // the buffers are read; the next round's first pass rewrites them
  }
}

// Dynamic shared memory of a Wiener Bluestein block of `groups` groups: the
// tables, one M-point exchange buffer a group, `carries` carries (two: a
// pair of sources; one: a pair of frames) of (N/hop - 1) hop rows.
inline size_t wiener_bluestein_smem_bytes(int log2m, int n, int hop, int groups, int carries) {
  return ((size_t)bluestein_tables_len(log2m) + (size_t)groups * exchange_len(log2m)) *
             sizeof(float2) +
         (size_t)carries * (n - hop) * sizeof(float);
}

// The Wiener+iSTFT at the other even N <= 8192 (M = 2^LOG2M, on the core up
// to 8192, on the 16 384-point level past N 4096): istft_bluestein_block
// with the same two changes as wiener_split_block. Chirp::convolve's point
// t < N is inverse_point over masked_bin (the mirrored bin past Nyquist)
// times chirp[t]; then the in-place chirp[t] conj pass leaves N conj(a[t] +
// i b[t]) at at(t) for t < N.
// * kFramePairs false: block index (place) is a pair of sources and R hop
//   rows; a round's group g transforms frame fr + g of the pair; the two
//   sources' carries (pair_gather).
// * kFramePairs true (the level where two carries do not fit beside its
//   191 488 bytes: (N/hop - 1) hop > 5120 floats, as N 8190, hop 910): block
//   index (place_source) is one source and R hop rows, and a group
//   transforms frames fr + 2g and fr + 2g + 1 of it, as istft_bluestein_block
//   pairs them: A and B the masked spectra of the two frames, each block
//   forming its frames' denominators again (the other sources' blocks read
//   the same y from L2); one carry (gather_round, the stem as its signal).
// Every thread runs every round and every barrier (a frame outside [0, nf)
// loads zeros). a.tw is the M-point quarter table, chirp (N) and chat (M)
// fft_plan.bluestein_tables; smem4 the block's dynamic shared memory
// (wiener_bluestein_smem_bytes).
template <int LOG2M, bool kBlockSync, bool kFramePairs>
__device__ __forceinline__ void wiener_bluestein_block(float4* smem4, const Args& a,
                                                       const float2* __restrict__ chirp,
                                                       const float2* __restrict__ chat, int N,
                                                       int rounds) {
  using C = Chirp<LOG2M, kBlockSync>;
  const int groups = blockDim.x / C::T;
  const int group = threadIdx.x / C::T;
  const int j = threadIdx.x - group * C::T;
  const int hop = a.hop;
  const int k = N / hop;  // frames that overlap one hop row
  const int frames = kFramePairs ? 2 * groups : groups;  // a round's
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* bufs = tws + C::TABLES;
  float* carry0 = reinterpret_cast<float*>(bufs + groups * C::E);  // (k - 1) hop
  float* carry1 = carry0 + (k - 1) * hop;                           // source pairs only
  const Place pl = kFramePairs ? place_source(a, blockIdx.x) : place(a, blockIdx.x);
  const int j_end = min(pl.j0 + a.rows, a.nf + k - 1);

  C::load_tables(tws, a.tw);
  for (int i = threadIdx.x; i < (kFramePairs ? 1 : 2) * (k - 1) * hop; i += blockDim.x)
    carry0[i] = 0.f;
  __syncthreads();

  float2* buf = bufs + group * C::E;
  for (int r = 0; r < rounds; ++r) {
    const int fr = pl.j0 - (k - 1) + r * frames;  // first frame of the round
    if constexpr (kFramePairs) {
      const int fa = fr + 2 * group, fb = fa + 1;
      const bool ha = fa >= 0 && fa < a.nf, hb = fb >= 0 && fb < a.nf;
      C::convolve(
          [&](int t) {
            if (t >= N) return make_float2(0.f, 0.f);
            const float2 z = inverse_point(t, N, [&](int kk, bool edge) {
              const float4 p = ha ? masked_bin(a, pl, N, fa, kk, edge)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
              const float4 q = hb ? masked_bin(a, pl, N, fb, kk, edge)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
              return make_float4(p.x, p.y, q.x, q.y);
            });
            return cmul(z, __ldg(chirp + t));
          },
          buf, tws, chat, j, group);
    } else {
      const int f = fr + group;
      const bool live = f >= 0 && f < a.nf;
      C::convolve(
          [&](int t) {
            if (t >= N || !live) return make_float2(0.f, 0.f);
            const float2 z = inverse_point(t, N, [&](int kk, bool edge) {
              return masked_bin(a, pl, N, f, kk, edge);
            });
            return cmul(z, __ldg(chirp + t));
          },
          buf, tws, chat, j, group);
    }
    for (int t = j; t < N; t += C::T) {  // each thread its own points: in place
      const float2 z = buf[C::at(t)];
      buf[C::at(t)] = cmul(__ldg(chirp + t), make_float2(z.x, -z.y));
    }
    __syncthreads();  // every group's frames are in its buffer
    if constexpr (kFramePairs) {
      gather_round([&](int g, int t) { return bufs[g * C::E + C::at(t)]; }, carry0,
                   a.win_over_n, a.inv_norm, a.out, a.out_int16, pl.n * a.S + pl.s0, fr,
                   frames, k, hop, pl.j0, j_end, a.length);
    } else {
      pair_gather([&](int g, int t) { return bufs[g * C::E + C::at(t)]; }, carry0, carry1, a,
                  pl, N, fr, frames, j_end);
    }
    __syncthreads();  // the buffers are read; the next round's first pass rewrites them
  }
}

}  // namespace wiener
