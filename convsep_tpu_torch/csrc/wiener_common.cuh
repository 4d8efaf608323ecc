// The Wiener+iSTFT kernels' device code shared by csrc/wiener_istft.cu and
// the host emulation (tests/cuda_host/wiener_cluster.cpp): the launch's
// arguments, a block's place in the grid, the masked spectrum points
// (masked_bin), a finished sample pair (store_pair) and the kernel on a
// thread-block cluster (wiener_cluster_block). wiener_istft.cu's header
// says what the kernels compute, what bounds them and how they are built.

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

// The masked half-spectra of sources s0 (A) and s1 (B) at bin kk of frame f
// of track n, as (Re A, Im A, Re B, Im B); imaginary parts 0 at the edges.
// The ratio follows models/masks.py::wiener_mask: the denominator sums the
// sources in order, then adds eps; conserve_last adds eps to the last
// source's numerator.
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
    const long long i = y0 + s * src;
    const float q = relu_pow(a.y_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(a.y) + i))
                                      : __ldg(static_cast<const float*>(a.y) + i), a.p2);
    d += q;
    ya = s == pl.s0 ? q : ya;
    yb = s == pl.s0 + 1 ? q : yb;
  }
  d += a.eps;
  if (a.conserve_last && pl.s0 == a.S - 1) ya += a.eps;
  if (a.conserve_last && pl.s0 + 1 == a.S - 1) yb += a.eps;
  const float ma = ya / d, mb = pl.has1 ? yb / d : 0.f;
  return make_float4(ma * mr, ma * mi, mb * mr, mb * mi);
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
//   source: frame f's sample t = i hop + u, chirp[t] conj(Z[t]) = N conj(a[t]
//   + i b[t]) read across the cluster as it is consumed, lies in hop row f +
//   i; its real part goes to s0, its imaginary part to s1; row f completes
//   with it and rows f + 1 .. f + k - 1 carry on, so each sample sums its
//   win/hop frames in ascending order, with no atomics.
// A cluster barrier ends each round (the peers have read the buffers the
// next round rewrites). Every thread runs every round and every barrier (a
// frame outside [0, nf) loads zeros). a.tw is the M-point quarter table,
// chirp (N) and chat (M) fft_plan.bluestein_tables; smem4 the block's
// dynamic shared memory (cluster_smem_bytes with 2 (k - 1) columns' carry).
template <int LOG2P, int C>
__device__ __forceinline__ void wiener_cluster_block(float4* smem4, const Args& a,
                                                     const float2* __restrict__ chirp,
                                                     const float2* __restrict__ chat, int N,
                                                     int rounds) {
  using CC = ClusterChirp<LOG2P, C>;
  const int rank = blockIdx.x % C;
  const Place pl = place(a, blockIdx.x / C);
  const int hop = a.hop;
  const int k = N / hop;  // frames that overlap one hop row
  const int cols = cluster_columns(hop, C);
  const int u0 = rank * cols;
  const int ncols = max(0, min(cols, hop - u0));
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
    for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
      const int u = u0 + c;
      for (int i = 0; i < k; ++i) {
        const int t = i * hop + u;
        const float2 zb = CC::point(buf, a.tw, t);
        const float2 z = cmul(__ldg(chirp + t), make_float2(zb.x, -zb.y));
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
    cluster_sync();  // the peers have read this round's buffers
  }
}

}  // namespace wiener
