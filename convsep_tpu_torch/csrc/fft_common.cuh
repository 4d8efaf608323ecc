// The FFT core shared by the forward STFT kernels (stft_dft.cu, ct_stft.cu)
// and the inverse STFT kernels (istft.cu, wiener_istft.cu), for Hopper
// (sm_90a): framing, window, a register-resident complex FFT that carries two
// real frames, the split back into the two half-spectra, and the inverse
// direction by conjugation (inverse_points, below).
//
// Plan (dsp/cuda/fft_plan.py mirrors every number here and sizes the launch):
// * a complex FFT of N = 2^LOG2N points (16 <= N <= 8192) belongs to one
//   group of T = N / 16 threads; each thread holds 16 points in registers;
// * Stockham passes of radix r (the first pass takes LOG2N mod 4 bits, radix
//   2, 4 or 8, when N is not a power of 16; the rest radix 16): a thread
//   reads its 16 points at j + T m, multiplies by the twiddles, runs 16 / r
//   radix-r DFTs in registers and writes the results to their Stockham slots
//   (b / Ns) Ns r + b % Ns + s Ns, so the output is in natural order with no
//   bit-reversed scatter;
// * points cross threads only between passes, through one float2 exchange
//   buffer of N + N / 16 entries per group in shared memory, slot i at
//   i + i / 16, which keeps every pass's reads and writes free of bank
//   conflicts (the split's mirrored read is two-way);
// * a group synchronizes alone: __syncwarp when it fits one warp, else a
//   named barrier (bar.sync 1 + group, T); the block synchronizes once, after
//   loading the frames' signal span and the twiddles;
// * twiddles e^{-2 pi i m / N}, m < N: the host computes the first quadrant
//   (m < N/4) in float64 and rounds it to float32 once (fft_plan.twiddles);
//   each block copies it into shared memory (slot i + i / 16) and turns it
//   by the exact quarter turns (multiplying by -i, -1, i swaps and negates),
//   so a pass's twiddles are shared-memory reads; from global memory they
//   are gathers of up to 32 sectors per warp instruction, 15 a butterfly,
//   through an L1 that the shared memory leaves small. The radix-r DFTs
//   use literal 16th roots of unity;
// * two real frames ride one transform, Z = a + i b, and split after the last
//   pass: A[k] = (Z[k] + conj Z[N-k]) / 2, B[k] = (Z[k] - conj Z[N-k]) / 2i,
//   k = 0 .. N/2, each group's threads taking consecutive k, so output rows
//   are written coalesced by bin.
//
// The mixed-radix split (stft_split_block, below) takes the sizes N = m P
// that are not powers of two: m odd in {3, 5, 9, 15}, P = 2^a a size the
// core plans, N <= 8192. With n = m n2 + n1 and k = k1 + P k2,
//
//   Z[k1 + P k2] = sum_{n1 < m} e^{-2 pi i n1 k2 / m} e^{-2 pi i n1 k1 / N} Y_n1[k1],
//
// Y_n1 the P-point FFT of the points m n2 + n1. A transform is one group of
// m P / 16 threads: stage 1 runs the m FFTs Y_n1 on the core's passes (m
// sub-groups of P / 16 threads, sub-group n1's exchange buffer the range
// [n1 P, (n1 + 1) P) of the group's N-point buffer), stage 2 the P m-point
// DFTs in registers, column k1 read from slot(n P + k1), n < m, and written
// back to the same slots as Z[k1 + P k2] at slot(k2 P + k1): Z in natural
// order, in place, each column owned by one thread. The twiddles
// e^{-2 pi i n1 k1 / N} come from an N-point quarter table (rounded once
// from float64 on the host, turned by exact quarter turns), the m-point
// DFTs' roots are literals (radix-3 and radix-5 butterflies; 9 and 15 by
// Cooley-Tukey over them). A group is not a whole warp when P < 512, so the
// block synchronizes as a whole; fft_plan.split_plan makes the block whole
// warps. The two-real-frames split is the same for any even N. Stages 1
// and 2 are one function, split_run, which the inverse split
// (istft_split_block) runs backwards by conjugation as the core's inverse
// does, its points filled by split_inverse_points.
//
// Bluestein's chirp-z (Chirp, stft_bluestein_block) takes any other N <=
// 8192 onto the power-of-two core: with c_n = e^{i pi n^2 / N},
//
//   X[k] = conj c_k sum_{t < N} (x_t conj c_t) c_{k-t},
//
// a cyclic convolution of M = 2^ceil(log2(2N - 1)) points: the core's FFT of
// the pre-chirped frames, times the FFT of the wrapped chirp (c_n at n and
// M - n, made on the host in float64 with 1/M folded in), the core again
// run backwards by conjugation, then the post-chirp and the two-real-frames
// split at the partner N - k. Past N = 4096, M is 16 384: the level (Level),
// two 8192-point runs of the core on one 512-thread group and a radix-2
// stage. The inverse STFT at any other even N <= 8192
// (istft_bluestein_block) is the same convolution run backwards: the
// inverse DFT is conj(DFT_N(conj Z)) / N.
//
// Past 8192 points (N <= 65 536) Bluestein's M = 8192 C points (C 4, 8 or
// 16; 16 is past the portable cluster size) live across the C blocks of a
// thread-block cluster (ClusterChirp, stft_cluster_block,
// istft_cluster_block, and wiener_common.cuh's wiener_cluster_block): each
// block runs the core's 8192-point transform on its part, and the one
// exchange between them is read through distributed shared memory (peer)
// where it is consumed. launch_clusters launches them. A power of two past
// 8192 needs no chirp: its N = 8192 C points are one transform by
// decimation in time over the cluster (ClusterDit, the Wiener+iSTFT's
// wiener_cluster_dit_block), each block forming only 1/C of them. So does
// an even N = C n with n 7-smooth (10 000, 14 000, 20 000, 40 000):
// ClusterMixed, each block's n points on a mixed-radix core of radix-2 to
// 16, 3, 5, 7 and 9 passes (mixed_fft, istft_cluster_mixed_block).
//
// Past 65 536 points (N <= 262 144) Bluestein's M = 262 144 or 524 288 lives
// in a scratch in device memory: the second level (level2_first,
// level2_middle, level2_last), ClusterChirp's factorization with two passes
// through that scratch in place of distributed shared memory; its 7-smooth
// sizes N = R n (R 16 or 32) need no chirp: one N-point transform a pair of
// frames, a radix-R combine and R rows of the mixed-radix core through the
// same kind of scratch (level2_direct_combine, level2_direct_rows). The fused
// forward STFT's 16 384 points run as one transform a pair of frames on the
// level itself (stft_level_block), without a chirp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>

// blockIdx.x read through volatile asm: the compiler neither hoists nor
// merges the read, so what a kernel derives from it is derived again where
// it is used instead of held in registers across a loop's heavier parts.
__device__ __forceinline__ int fresh_block_index() {
  int b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

// Distributed shared memory: p's address in block `rank` of the cluster.
// The host emulation (tests/cuda_host/cuda_runtime.h) defines its own.
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
// u into p's address in block `rank` of the cluster, and the float2 there,
// through a 32-bit shared::cluster address (mapa.shared::cluster.u32)
// where peer's generic pointer takes two registers. The host emulation
// defines its own through peer.
__device__ __forceinline__ unsigned peer_address(const float2* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void peer_store(float2* p, int rank, float2 u) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(peer_address(p, rank)),
               "f"(u.x), "f"(u.y)
               : "memory");
}
__device__ __forceinline__ float2 peer_load(const float2* p, int rank) {
  float2 u;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(u.x), "=f"(u.y)
               : "r"(peer_address(p, rank))
               : "memory");
  return u;
}
// A barrier of the cluster's blocks: shared-memory writes before it are
// visible to every block of the cluster after it.
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }
#endif

namespace fft_common {

constexpr int kPoints = 16;       // complex points a thread holds
constexpr int kMaxThreads = 512;  // threads a block may have
constexpr int kMinLog2 = 4;
constexpr int kMaxLog2 = 13;

__host__ __device__ constexpr int fft_threads(int log2n) { return (1 << log2n) / kPoints; }
__host__ __device__ constexpr int exchange_len(int log2n) {
  return (1 << log2n) + ((1 << log2n) >> 4);
}
__host__ __device__ constexpr int first_radix(int log2n) {
  return log2n % 4 ? 1 << (log2n % 4) : 16;
}
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// log2(n) when n is a power of two in the plan's range, else 0
inline int plan_log2(int n) {
  for (int lg = kMinLog2; lg <= kMaxLog2; ++lg)
    if (n == 1 << lg) return lg;
  return 0;
}

// Floats of the frames' signal span: (frames - 1) hop + W samples, rounded
// up to whole float4s, plus the 16-byte alignment shift and its tail.
__host__ __device__ inline int span_floats(int frames, int win, int hop) {
  const int len = (frames - 1) * hop + win;
  return (len + 3) / 4 * 4 + 8;
}

// float2 slots of the quarter twiddle table in shared memory (N/4 entries,
// one pad per 16)
__host__ __device__ constexpr int twiddle_len(int log2n) {
  return (1 << log2n) / 4 + (1 << log2n) / 64;
}

// Dynamic shared memory of a block of `ffts` groups: the span of their
// 2 * ffts frames, the quarter twiddle table, then one exchange buffer per
// group.
inline size_t smem_bytes(int log2n, int win, int hop, int ffts) {
  return (size_t)span_floats(2 * ffts, win, hop) * sizeof(float) +
         ((size_t)twiddle_len(log2n) + (size_t)ffts * exchange_len(log2n)) * sizeof(float2);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// u * e^{-2 pi i e / 16}, 0 <= e < 8; e is a constant after unrolling, so
// the switch folds to literals, and 0 and 4 (times 1 and -i) to no product.
__device__ __forceinline__ float2 rot16(float2 u, int e) {
  float c, s;  // e^{-2 pi i e / 16} = c - i s
  switch (e) {
    case 0: return u;
    case 4: return make_float2(u.y, -u.x);
    case 1: c = 0.92387953251128674f; s = 0.38268343236508978f; break;
    case 2: c = 0.70710678118654752f; s = 0.70710678118654752f; break;
    case 3: c = 0.38268343236508978f; s = 0.92387953251128674f; break;
    case 5: c = -0.38268343236508978f; s = 0.92387953251128674f; break;
    case 6: c = -0.70710678118654752f; s = 0.70710678118654752f; break;
    default: c = -0.92387953251128674f; s = 0.38268343236508978f; break;
  }
  return make_float2(u.x * c + u.y * s, u.y * c - u.x * s);
}

__host__ __device__ constexpr int bit_reverse(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | bit_reverse(i >> 1, bits - 1);
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// In-register forward DFT of r points (r = 2, 4, 8, 16), natural order in
// and out: radix-2 decimation in time over registers. The permutation and
// the stages recurse on template arguments, so every register index is a
// constant and the arrays never leave registers.
template <int r, int I = 0>
__device__ __forceinline__ void bit_reverse_permute(float2 (&u)[r]) {
  if constexpr (I < r) {
    constexpr int K = bit_reverse(I, ilog2(r));
    if constexpr (K > I) {
      const float2 t = u[I];
      u[I] = u[K];
      u[K] = t;
    }
    bit_reverse_permute<r, I + 1>(u);
  }
}

template <int r, int LEN = 2>
__device__ __forceinline__ void dft_stages(float2 (&u)[r]) {
  if constexpr (LEN <= r) {
#pragma unroll
    for (int i = 0; i < r; i += LEN) {
#pragma unroll
      for (int k = 0; k < LEN / 2; ++k) {
        const float2 a = u[i + k];
        const float2 b = rot16(u[i + k + LEN / 2], k * (16 / LEN));
        u[i + k] = make_float2(a.x + b.x, a.y + b.y);
        u[i + k + LEN / 2] = make_float2(a.x - b.x, a.y - b.y);
      }
    }
    dft_stages<r, 2 * LEN>(u);
  }
}

template <int r>
__device__ __forceinline__ void dft(float2 (&u)[r]) {
  bit_reverse_permute<r>(u);
  dft_stages<r>(u);
}

// Synchronize the T threads of one group.
template <int T>
__device__ __forceinline__ void group_sync(int group) {
  if (T <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(T) : "memory");
  }
}

// kBlockSync: the passes synchronize the whole block (__syncthreads) instead
// of their group alone; the split (stft_split_block) runs m FFTs a group, and
// its groups may share warps.
template <int LOG2N, bool kBlockSync = false>
struct Fft {
  static constexpr int N = 1 << LOG2N;
  static constexpr int T = fft_threads(LOG2N);
  static constexpr int R0 = first_radix(LOG2N);
  static constexpr int PASSES = (LOG2N + 3) / 4;

  __device__ __forceinline__ static void sync(int group) {
    if constexpr (kBlockSync) {
      __syncthreads();
    } else {
      group_sync<T>(group);
    }
  }

  __host__ __device__ static constexpr int stride(int p) {  // Ns of pass p
    return p == 0 ? 1 : p == 1 ? R0 : 16 * stride(p - 1);
  }

  // e^{-2 pi i m / N}, 0 <= m < N, from the quarter table tw (slot i holds
  // m = i < N/4): quadrant q multiplies by (-i)^q, which is exact.
  __device__ __forceinline__ static float2 twiddle(const float2* tw, int m) {
    const float2 w = tw[slot(m & (N / 4 - 1))];
    switch (m / (N / 4)) {
      case 0: return w;
      case 1: return make_float2(w.y, -w.x);
      case 2: return make_float2(-w.x, -w.y);
      default: return make_float2(-w.y, w.x);
    }
  }

  // One Stockham pass of radix r over v (v[m] is element j + T m of the
  // pass's input): twiddles, 16 / r radix-r DFTs, then the exchange into
  // buf. The first pass's input came from the span, not buf, so it writes
  // without waiting; later passes wait until the group has read buf.
  template <int r, int Ns, bool kFirst>
  __device__ __forceinline__ static void pass(float2 (&v)[kPoints], float2* buf,
                                              const float2* tw, int j, int group) {
    constexpr int nb = kPoints / r;
#pragma unroll
    for (int q = 0; q < nb; ++q) {
      const int b = j + q * T;
      float2 u[r];
#pragma unroll
      for (int s = 0; s < r; ++s) u[s] = v[q + s * nb];
      if (Ns > 1) {
        // e^{-2 pi i (b % Ns) s / (Ns r)}, m = (b % Ns) s N / (Ns r) < N
        const int step = (b & (Ns - 1)) * (N / (Ns * r));
#pragma unroll
        for (int s = 1; s < r; ++s) u[s] = cmul(u[s], twiddle(tw, s * step));
      }
      dft<r>(u);
#pragma unroll
      for (int s = 0; s < r; ++s) v[q + s * nb] = u[s];
    }
    if (!kFirst) sync(group);
#pragma unroll
    for (int q = 0; q < nb; ++q) {
      const int b = j + q * T;
      const int bm = b & (Ns - 1);
      const int base = (b - bm) * r + bm;  // (b / Ns) Ns r + b % Ns
#pragma unroll
      for (int s = 0; s < r; ++s) buf[slot(base + s * Ns)] = v[q + s * nb];
    }
    sync(group);
  }

  template <int P>
  __device__ __forceinline__ static void later_passes(float2 (&v)[kPoints], float2* buf,
                                                      const float2* tw, int j, int group) {
    if constexpr (P < PASSES) {
#pragma unroll
      for (int m = 0; m < kPoints; ++m) v[m] = buf[slot(j + T * m)];
      pass<16, stride(P), false>(v, buf, tw, j, group);
      later_passes<P + 1>(v, buf, tw, j, group);
    }
  }

  // The FFT of v (the first pass's input, element j + T m in v[m]); on
  // return buf holds Z in natural order (at slot(k)) for the whole group.
  __device__ __forceinline__ static void run(float2 (&v)[kPoints], float2* buf,
                                             const float2* tw, int j, int group) {
    pass<R0, 1, true>(v, buf, tw, j, group);
    later_passes<1>(v, buf, tw, j, group);
  }
};

// The inverse direction, by conjugation: ifft(Z) = conj(FFT(conj Z)) / N, so
// the forward passes above serve it unchanged. Two real frames a, b with
// half-spectra A, B (bins 0 .. N/2) ride one transform as Z = A + i B, whose
// inverse is a + i b; Z's bins past N/2 come from the mirrored bins, Z[N - k]
// = conj A[k] + i conj B[k]. irfft ignores the imaginary parts of DC and
// Nyquist. inverse_points fills thread j's first-pass points v[m] = conj Z[k],
// k = j + T m, from bin(kk, edge), which returns (Re A, Im A, Re B, Im B) at
// bin kk <= N/2 (edge: kk is DC or Nyquist, and the imaginary parts must be
// 0): bins k <= N/2 are asked for as they are, the rest at N - k, so each
// warp reads whole runs of consecutive bins, forward or backward. After
// Fft<LOG2N>::run, buf[slot(t)] holds N conj(a[t] + i b[t]): a[t] = x / N,
// b[t] = -y / N.
//
// conj Z[k] of n points at k from bin(kk, edge), kk = k or its mirror n - k.
// kAnyParity: n may be odd, which has no Nyquist bin: its last bin (n - 1) /
// 2 is mirrored like any other, so every bin but DC counts twice, as the
// reference's inverse matrices weight it (dsp/dft.py::_inverse_mats). The
// callers that take even n only keep the even test (the Wiener cluster's
// registers move with it).
template <bool kAnyParity = false, class Bin>
__device__ __forceinline__ float2 inverse_point(int k, int n, Bin bin) {
  const bool mirrored = k > n / 2;
  const int kk = mirrored ? n - k : k;
  const float4 ab = bin(kk, kk == 0 || (kAnyParity ? 2 * kk == n : kk == n / 2));
  // conj Z[k] = (ar - bi) - i (ai + br); conj Z[N - kk] = (ar + bi) + i (ai - br)
  return mirrored ? make_float2(ab.x + ab.w, ab.y - ab.z)
                  : make_float2(ab.x - ab.w, -(ab.y + ab.z));
}

template <int N, class Bin>
__device__ __forceinline__ float2 inverse_point(int k, Bin bin) {
  return inverse_point(k, N, bin);
}

template <int LOG2N, class Bin>
__device__ __forceinline__ void inverse_points(float2 (&v)[kPoints], int j, Bin bin) {
  constexpr int T = fft_threads(LOG2N);
#pragma unroll
  for (int m = 0; m < kPoints; ++m) v[m] = inverse_point<1 << LOG2N>(j + T * m, bin);
}

// inverse_points straight from the spectrum rows of two frames (re_a, im_a,
// re_b, im_b: the rows at bin 0; re_a or re_b null for a frame that is zero).
template <int LOG2N>
__device__ __forceinline__ void inverse_input(float2 (&v)[kPoints], const float* re_a,
                                              const float* im_a, const float* re_b,
                                              const float* im_b, int j) {
  inverse_points<LOG2N>(v, j, [&](int kk, bool edge) {
    return make_float4(re_a ? __ldg(re_a + kk) : 0.f, re_a && !edge ? __ldg(im_a + kk) : 0.f,
                       re_b ? __ldg(re_b + kk) : 0.f, re_b && !edge ? __ldg(im_b + kk) : 0.f);
  });
}

// span[e] = xs[s0 + e] for 0 <= s0 + e < L, else 0, for 0 <= e < len; the
// block reads whole aligned float4s (16-byte loads) and stores them at
// 16-byte-aligned shared addresses: smem[4 c] holds the first float of
// aligned chunk c, so the span starts at smem + shift. Returns the span.
__device__ __forceinline__ const float* load_span(float* smem, const float* __restrict__ xs,
                                                  int L, long long s0, int len) {
  const long long a = (long long)(reinterpret_cast<uintptr_t>(xs) >> 2) + s0;
  const int shift = (int)(a & 3);  // span element 0 is float `shift` of chunk 0
  const int chunks = (len + shift + 3) / 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const long long s = s0 - shift + 4LL * c;  // signal index of the chunk's first float
    float4 v;
    if (s >= 0 && s + 4 <= L) {
      v = __ldg(reinterpret_cast<const float4*>(xs + s));
    } else {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = (s + i >= 0 && s + i < L) ? __ldg(xs + s + i) : 0.f;
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    reinterpret_cast<float4*>(smem)[c] = v;
  }
  return smem + shift;
}

// The forward STFT of frames f0 + 2 g and f0 + 2 g + 1 of signal `sig` by
// group g of the block, for frames f at signal samples f hop - W/2 + t,
// t < W (zero outside [0, L)), windowed, zero-padded to N; tw is the
// quarter twiddle table (N/4 entries). Calls out(frame_a, has_b, k, A, B)
// for every bin k = 0 .. N/2 this thread owns (k = j + T q), A and B the
// spectra of the pair's two frames at k.
template <int LOG2N, class Out>
__device__ __forceinline__ void stft_block(const float* __restrict__ x,
                                           const float* __restrict__ win,
                                           const float2* __restrict__ tw, int L, int W, int hop,
                                           int nf, Out out) {
  using F = Fft<LOG2N>;
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / F::T;
  const int group = threadIdx.x / F::T;
  const int j = threadIdx.x - group * F::T;
  const int frames = 2 * groups;
  const int per_signal = (nf + frames - 1) / frames;
  const int sig = blockIdx.x / per_signal;
  const int f0 = (blockIdx.x - sig * per_signal) * frames;
  const int span_len = (frames - 1) * hop + W;
  float* smem = reinterpret_cast<float*>(smem4);
  float2* tws = reinterpret_cast<float2*>(smem + span_floats(frames, W, hop));
  float2* buf = tws + twiddle_len(LOG2N) + group * exchange_len(LOG2N);
  const float* span =
      load_span(smem, x + (long long)sig * L, L, (long long)f0 * hop - W / 2, span_len);
  for (int i = threadIdx.x; i < F::N / 4; i += blockDim.x) tws[slot(i)] = __ldg(tw + i);
  __syncthreads();

  // pass 0's input: frame a (real) and frame b (imaginary), windowed
  const float* fa = span + 2 * group * hop;
  const float* fb = fa + hop;
  float2 v[kPoints];
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int t = j + F::T * m;
    if (t < W) {
      const float w = __ldg(win + t);
      v[m] = make_float2(fa[t] * w, fb[t] * w);
    } else {
      v[m] = make_float2(0.f, 0.f);
    }
  }
  F::run(v, buf, tws, j, group);

  const int frame_a = f0 + 2 * group;
  if (frame_a >= nf) return;
  const bool has_b = frame_a + 1 < nf;
  // k = j + T q for q < 8 covers 0 .. N/2 - 1; thread 0 also takes N/2
#pragma unroll
  for (int q = 0; q <= kPoints / 2; ++q) {
    const int k = j + F::T * q;
    if (q == kPoints / 2 && j != 0) break;
    const float2 z = buf[slot(k)];
    const float2 w = buf[slot((F::N - k) & (F::N - 1))];
    out((long long)sig * nf + frame_a, has_b, k,
        make_float2(0.5f * (z.x + w.x), 0.5f * (z.y - w.y)),
        make_float2(0.5f * (z.y + w.y), 0.5f * (w.x - z.x)));
  }
}

// ---- the mixed-radix split -------------------------------------------------

// e^{-2 pi i e / M} for M = 9, 15 and 0 < e < M: literals rounded once from
// the decimal; e is a constant after unrolling, so the switch folds.
template <int M>
__device__ __forceinline__ float2 odd_root(int e) {
  static_assert(M == 9 || M == 15, "literal roots for 9 and 15 only");
  float c, s;  // e^{-2 pi i e / M} = c - i s
  if constexpr (M == 9) {
    switch (e) {
      case 1: c = 0.766044443118978f; s = 0.6427876096865393f; break;
      case 2: c = 0.17364817766693041f; s = 0.984807753012208f; break;
      case 3: c = -0.5f; s = 0.8660254037844387f; break;
      default: c = -0.9396926207859083f; s = 0.3420201433256689f; break;  // 4
    }
  } else {
    switch (e) {
      case 1: c = 0.9135454576426009f; s = 0.40673664307580015f; break;
      case 2: c = 0.6691306063588582f; s = 0.7431448254773941f; break;
      case 3: c = 0.30901699437494745f; s = 0.9510565162951535f; break;
      case 4: c = -0.10452846326765333f; s = 0.9945218953682734f; break;
      case 5: c = -0.5f; s = 0.8660254037844387f; break;
      case 6: c = -0.8090169943749473f; s = 0.5877852522924732f; break;
      case 7: c = -0.9781476007338057f; s = 0.20791169081775931f; break;
      default: c = -0.9781476007338057f; s = -0.20791169081775907f; break;  // 8
    }
  }
  return make_float2(c, -s);
}

// In-register forward DFT of M points (M = 3, 5, 7, 9, 15), natural order in
// and out: the radix-3, radix-5 and radix-7 butterflies (the symmetric
// form: sums and differences of the partners s and M - s, cosines on the
// sums, sines on the differences); 9 = 3 x 3 and 15 = 3 x 5
// by Cooley-Tukey (3 sub-DFTs of M / 3 points at stride 3, the twiddles
// e^{-2 pi i n1 k1 / M}, then M / 3 DFTs of 3), every index a constant.
template <int M>
__device__ __forceinline__ void dft_odd(float2 (&u)[M]) {
  if constexpr (M == 3) {
    constexpr float s3 = 0.8660254037844386f;  // sin(2 pi / 3)
    const float2 t1 = make_float2(u[1].x + u[2].x, u[1].y + u[2].y);
    const float2 t2 = make_float2(u[0].x - 0.5f * t1.x, u[0].y - 0.5f * t1.y);
    const float2 d = make_float2((u[1].x - u[2].x) * s3, (u[1].y - u[2].y) * s3);
    u[0] = make_float2(u[0].x + t1.x, u[0].y + t1.y);
    u[1] = make_float2(t2.x + d.y, t2.y - d.x);  // t2 - i d
    u[2] = make_float2(t2.x - d.y, t2.y + d.x);  // t2 + i d
  } else if constexpr (M == 5) {
    constexpr float c1 = 0.30901699437494745f, s1 = 0.9510565162951535f;   // 2 pi / 5
    constexpr float c2 = -0.8090169943749473f, s2 = 0.5877852522924732f;   // 4 pi / 5
    const float2 a1 = make_float2(u[1].x + u[4].x, u[1].y + u[4].y);
    const float2 b1 = make_float2(u[1].x - u[4].x, u[1].y - u[4].y);
    const float2 a2 = make_float2(u[2].x + u[3].x, u[2].y + u[3].y);
    const float2 b2 = make_float2(u[2].x - u[3].x, u[2].y - u[3].y);
    const float2 r1 = make_float2(u[0].x + c1 * a1.x + c2 * a2.x, u[0].y + c1 * a1.y + c2 * a2.y);
    const float2 r2 = make_float2(u[0].x + c2 * a1.x + c1 * a2.x, u[0].y + c2 * a1.y + c1 * a2.y);
    const float2 i1 = make_float2(s1 * b1.x + s2 * b2.x, s1 * b1.y + s2 * b2.y);
    const float2 i2 = make_float2(s2 * b1.x - s1 * b2.x, s2 * b1.y - s1 * b2.y);
    u[0] = make_float2(u[0].x + a1.x + a2.x, u[0].y + a1.y + a2.y);
    u[1] = make_float2(r1.x + i1.y, r1.y - i1.x);  // r1 - i i1
    u[4] = make_float2(r1.x - i1.y, r1.y + i1.x);  // r1 + i i1
    u[2] = make_float2(r2.x + i2.y, r2.y - i2.x);
    u[3] = make_float2(r2.x - i2.y, r2.y + i2.x);
  } else if constexpr (M == 7) {
    constexpr float c1 = 0.6234898018587336f, s1 = 0.7818314824680298f;    // 2 pi / 7
    constexpr float c2 = -0.22252093395631434f, s2 = 0.9749279121818236f;  // 4 pi / 7
    constexpr float c3 = -0.900968867902419f, s3 = 0.43388373911755823f;   // 6 pi / 7
    const float2 a1 = make_float2(u[1].x + u[6].x, u[1].y + u[6].y);
    const float2 b1 = make_float2(u[1].x - u[6].x, u[1].y - u[6].y);
    const float2 a2 = make_float2(u[2].x + u[5].x, u[2].y + u[5].y);
    const float2 b2 = make_float2(u[2].x - u[5].x, u[2].y - u[5].y);
    const float2 a3 = make_float2(u[3].x + u[4].x, u[3].y + u[4].y);
    const float2 b3 = make_float2(u[3].x - u[4].x, u[3].y - u[4].y);
    const float2 r1 = make_float2(u[0].x + c1 * a1.x + c2 * a2.x + c3 * a3.x,
                                  u[0].y + c1 * a1.y + c2 * a2.y + c3 * a3.y);
    const float2 r2 = make_float2(u[0].x + c2 * a1.x + c3 * a2.x + c1 * a3.x,
                                  u[0].y + c2 * a1.y + c3 * a2.y + c1 * a3.y);
    const float2 r3 = make_float2(u[0].x + c3 * a1.x + c1 * a2.x + c2 * a3.x,
                                  u[0].y + c3 * a1.y + c1 * a2.y + c2 * a3.y);
    const float2 i1 = make_float2(s1 * b1.x + s2 * b2.x + s3 * b3.x,
                                  s1 * b1.y + s2 * b2.y + s3 * b3.y);
    const float2 i2 = make_float2(s2 * b1.x - s3 * b2.x - s1 * b3.x,
                                  s2 * b1.y - s3 * b2.y - s1 * b3.y);
    const float2 i3 = make_float2(s3 * b1.x - s1 * b2.x + s2 * b3.x,
                                  s3 * b1.y - s1 * b2.y + s2 * b3.y);
    u[0] = make_float2(u[0].x + a1.x + a2.x + a3.x, u[0].y + a1.y + a2.y + a3.y);
    u[1] = make_float2(r1.x + i1.y, r1.y - i1.x);  // r1 - i i1
    u[6] = make_float2(r1.x - i1.y, r1.y + i1.x);  // r1 + i i1
    u[2] = make_float2(r2.x + i2.y, r2.y - i2.x);
    u[5] = make_float2(r2.x - i2.y, r2.y + i2.x);
    u[3] = make_float2(r3.x + i3.y, r3.y - i3.x);
    u[4] = make_float2(r3.x - i3.y, r3.y + i3.x);
  } else {
    constexpr int R2 = M / 3;
    float2 t[M];
#pragma unroll
    for (int n1 = 0; n1 < 3; ++n1) {
      float2 sub[R2];
#pragma unroll
      for (int n2 = 0; n2 < R2; ++n2) sub[n2] = u[3 * n2 + n1];
      dft_odd<R2>(sub);
#pragma unroll
      for (int k1 = 0; k1 < R2; ++k1)
        t[n1 * R2 + k1] = n1 * k1 ? cmul(sub[k1], odd_root<M>(n1 * k1)) : sub[k1];
    }
#pragma unroll
    for (int k1 = 0; k1 < R2; ++k1) {
      float2 col[3] = {t[k1], t[R2 + k1], t[2 * R2 + k1]};
      dft_odd<3>(col);
#pragma unroll
      for (int k2 = 0; k2 < 3; ++k2) u[k1 + R2 * k2] = col[k2];
    }
  }
}

// e^{-2 pi i e / N}, 0 <= e < N, 4 | N, from the quarter table tw (slot i
// holds e = i < N/4): quadrant q multiplies by (-i)^q, which is exact.
template <int N>
__device__ __forceinline__ float2 quarter_twiddle(const float2* tw, int e) {
  constexpr int Q = N / 4;
  const int q = e / Q;
  const float2 w = tw[slot(e - q * Q)];
  switch (q) {
    case 0: return w;
    case 1: return make_float2(w.y, -w.x);
    case 2: return make_float2(-w.x, -w.y);
    default: return make_float2(-w.y, w.x);
  }
}

// float2 slots of an N-point quarter twiddle table (N/4 entries, one pad per 16)
__host__ __device__ constexpr int quarter_len(int n) { return n / 4 + n / 64; }
// float2 entries of an N-point exchange buffer (one pad per 16)
__host__ __device__ constexpr int split_exchange_len(int n) { return n + n / 16; }

// nfft = m 2^log2p with m in {3, 5, 9, 15}, 2^log2p >= 16 and nfft <= 8192:
// the split's sizes (fft_plan.split_factors). Sets m and log2p.
inline bool split_sizes(int nfft, int* m, int* log2p) {
  *m = nfft > 0 ? nfft : 1;
  *log2p = 0;
  while (*m % 2 == 0) {
    *m /= 2;
    ++*log2p;
  }
  return (*m == 3 || *m == 5 || *m == 9 || *m == 15) && *log2p >= kMinLog2 &&
         nfft <= (1 << kMaxLog2);
}

// Dynamic shared memory of a split block of `ffts` groups: the span of their
// 2 * ffts frames, the P-point quarter table (stage 1), the N-point quarter
// table (the split's twiddles), one N-point exchange buffer per group.
inline size_t split_smem_bytes(int log2p, int m, int win, int hop, int ffts) {
  const int n = m << log2p;
  return (size_t)span_floats(2 * ffts, win, hop) * sizeof(float) +
         ((size_t)twiddle_len(log2p) + (size_t)quarter_len(n) +
          (size_t)ffts * split_exchange_len(n)) * sizeof(float2);
}

// The split's transform of N = M 2^LOG2P points by the M P / 16 threads of
// one group (thread jj of the group is thread j = jj % (P / 16) of stage 1's
// sub-FFT n1 = jj / (P / 16)): v holds stage 1's input, point M (j + T1 m) +
// n1 in v[m]; tw_p the P-point quarter table, tw_n the N-point one, both in
// shared memory. On return, after a block barrier, buf[slot(k)] holds Z[k]
// in natural order for the whole group.
template <int LOG2P, int M>
__device__ __forceinline__ void split_run(float2 (&v)[kPoints], float2* buf,
                                          const float2* tw_p, const float2* tw_n, int jj,
                                          int group) {
  using F = Fft<LOG2P, true>;
  constexpr int P = F::N;
  constexpr int N = M * P;
  constexpr int T1 = F::T;     // threads of one sub-FFT
  constexpr int T = M * T1;    // threads of one transform (N / 16)
  const int n1 = jj / T1;
  F::run(v, buf + n1 * exchange_len(LOG2P), tw_p, jj - n1 * T1, group);

  // stage 2: column k1 = jj + T q, twiddled, one M-point DFT, in place
#pragma unroll
  for (int q = 0; q < (P + T - 1) / T; ++q) {
    const int k1 = jj + T * q;
    if (k1 < P) {
      float2 u[M];
#pragma unroll
      for (int n = 0; n < M; ++n) u[n] = buf[slot(n * P + k1)];
#pragma unroll
      for (int n = 1; n < M; ++n) u[n] = cmul(u[n], quarter_twiddle<N>(tw_n, n * k1));
      dft_odd<M>(u);
#pragma unroll
      for (int n = 0; n < M; ++n) buf[slot(n * P + k1)] = u[n];
    }
  }
  __syncthreads();
}

// stft_block for N = M 2^LOG2P (M odd): the frames' span and the windows as
// there; tw_p the P-point quarter table, tw_n the N-point one. The block's
// threads are groups of M P / 16, each group one transform of two frames;
// thread jj of a group is thread j = jj % (P / 16) of stage 1's sub-FFT
// n1 = jj / (P / 16). Calls out(frame_a, has_b, k, A, B) as stft_block.
template <int LOG2P, int M, class Out>
__device__ __forceinline__ void stft_split_block(const float* __restrict__ x,
                                                 const float* __restrict__ win,
                                                 const float2* __restrict__ tw_p,
                                                 const float2* __restrict__ tw_n, int L, int W,
                                                 int hop, int nf, Out out) {
  constexpr int P = 1 << LOG2P;
  constexpr int N = M * P;
  constexpr int T1 = fft_threads(LOG2P);  // threads of one sub-FFT
  constexpr int T = M * T1;               // threads of one transform (N / 16)
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / T;
  const int group = threadIdx.x / T;
  const int jj = threadIdx.x - group * T;
  const int n1 = jj / T1;
  const int j = jj - n1 * T1;
  const int frames = 2 * groups;
  const int per_signal = (nf + frames - 1) / frames;
  const int sig = blockIdx.x / per_signal;
  const int f0 = (blockIdx.x - sig * per_signal) * frames;
  const int span_len = (frames - 1) * hop + W;
  float* smem = reinterpret_cast<float*>(smem4);
  float2* twp = reinterpret_cast<float2*>(smem + span_floats(frames, W, hop));
  float2* twn = twp + twiddle_len(LOG2P);
  float2* buf = twn + quarter_len(N) + group * split_exchange_len(N);
  const float* span =
      load_span(smem, x + (long long)sig * L, L, (long long)f0 * hop - W / 2, span_len);
  for (int i = threadIdx.x; i < P / 4; i += blockDim.x) twp[slot(i)] = __ldg(tw_p + i);
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) twn[slot(i)] = __ldg(tw_n + i);
  __syncthreads();

  // stage 1's input: sub-FFT n1 of frame a (real) and frame b (imaginary),
  // points t = M n2 + n1, n2 = j + T1 m, windowed
  const float* fa = span + 2 * group * hop;
  const float* fb = fa + hop;
  float2 v[kPoints];
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int t = M * (j + T1 * m) + n1;
    if (t < W) {
      const float w = __ldg(win + t);
      v[m] = make_float2(fa[t] * w, fb[t] * w);
    } else {
      v[m] = make_float2(0.f, 0.f);
    }
  }
  split_run<LOG2P, M>(v, buf, twp, twn, jj, group);

  const int frame_a = f0 + 2 * group;
  if (frame_a >= nf) return;
  const bool has_b = frame_a + 1 < nf;
  // k = jj + T q for q < 8 covers 0 .. N/2 - 1; thread 0 also takes N/2
#pragma unroll
  for (int q = 0; q <= kPoints / 2; ++q) {
    const int k = jj + T * q;
    if (q == kPoints / 2 && jj != 0) break;
    const float2 z = buf[slot(k)];
    const float2 w = buf[slot(k ? N - k : 0)];
    out((long long)sig * nf + frame_a, has_b, k,
        make_float2(0.5f * (z.x + w.x), 0.5f * (z.y - w.y)),
        make_float2(0.5f * (z.y + w.y), 0.5f * (w.x - z.x)));
  }
}

// ---- the inverse split ------------------------------------------------------

// inverse_points for the split: thread jj of a group (thread j of stage 1's
// sub-FFT n1, as split_run numbers them) fills v[m] = conj Z[k], k = M (j +
// T1 m) + n1, from bin(kk, edge) as inverse_points does. After split_run,
// buf[slot(t)] holds N conj(a[t] + i b[t]).
template <int LOG2P, int M, class Bin>
__device__ __forceinline__ void split_inverse_points(float2 (&v)[kPoints], int jj, Bin bin) {
  constexpr int T1 = fft_threads(LOG2P);
  const int n1 = jj / T1;
  const int j = jj - n1 * T1;
#pragma unroll
  for (int m = 0; m < kPoints; ++m) v[m] = inverse_point<(M << LOG2P)>(M * (j + T1 * m) + n1, bin);
}

// out[o] = v as float32, or as PCM16: round to nearest even, clipped
__device__ __forceinline__ void write_sample(void* out, int out_int16, long long o, float v) {
  if (out_int16) {
    const float qv = fminf(fmaxf(rintf(v * 32768.f), -32768.f), 32767.f);
    static_cast<int16_t*>(out)[o] = (int16_t)qv;
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

// The inverse kernels' overlap-add of one round, after its transforms and a
// block barrier: the round's f2 frames start at frame fr, and rows fr .. fr
// + f2 + k - 2 (k = win / hop) meet them; rows below fr + f2 are complete
// after it, the k - 1 above carry on to the next round. A thread owns
// columns u of the hop rows and sums, for each row, the carry of earlier
// rounds and the round's frames in ascending order (each sample its win/hop
// frames in one fixed order, no atomics); sample(g, t) is the float2 at
// sample t of group g's transform, N conj(a[t] + i b[t]) for its frames a =
// fr + 2 g and b = a + 1. A complete row of signal n in [j0, j_end) is
// written times inv_norm, the win/2 front trim, by write_sample. The
// power-of-two and Bluestein inverse kernels use it; istft_split_block
// keeps the same loop written out.
template <class Sample>
__device__ __forceinline__ void gather_round(Sample sample, float* carry,
                                             const float* __restrict__ win_over_n,
                                             const float* __restrict__ inv_norm,
                                             void* __restrict__ out, int out_int16, int n, int fr,
                                             int f2, int k, int hop, int j0, int j_end,
                                             int length) {
  const long long front = (long long)k * hop / 2;
  for (int u = threadIdx.x; u < hop; u += blockDim.x) {
    for (int i = 0; i < f2 + k - 1; ++i) {
      const int row = fr + i;
      float acc = i < k - 1 ? carry[i * hop + u] : 0.f;
      const int f_lo = max(fr, row - k + 1), f_hi = min(fr + f2 - 1, row);
      for (int f = f_lo; f <= f_hi; ++f) {
        const int t = (row - f) * hop + u;
        const float2 z = sample((f - fr) >> 1, t);
        acc += __ldg(win_over_n + t) * (((f - fr) & 1) ? -z.y : z.x);
      }
      if (i >= f2) {
        carry[(i - f2) * hop + u] = acc;
      } else if (row >= j0 && row < j_end) {
        const long long nabs = (long long)row * hop + u;
        const long long tpos = nabs - front;
        if (tpos >= 0 && tpos < length)
          write_sample(out, out_int16, (long long)n * length + tpos, acc * __ldg(inv_norm + nabs));
      }
    }
  }
}

// Dynamic shared memory of an inverse split block of `groups` groups: the
// P-point and N-point quarter tables, one N-point exchange buffer per group,
// the carry of (win/hop - 1) hop rows.
inline size_t istft_split_smem_bytes(int log2p, int m, int win, int hop, int groups) {
  const int n = m << log2p;
  return ((size_t)twiddle_len(log2p) + (size_t)quarter_len(n) +
          (size_t)groups * split_exchange_len(n)) * sizeof(float2) +
         (size_t)(win / hop - 1) * hop * sizeof(float);
}

// istft.cu's istft_fft_kernel for N = M 2^LOG2P (M odd): block (n, r) owns
// hop rows [j0, j0 + rows) of signal n and walks frames j0 - (win/hop - 1)
// on in rounds of 2 G (G groups of M P / 16 threads, each group two frames
// a round). A round loads each thread's points straight from its pair's
// spectrum rows (inverse_input's loads at the split's points: the M
// sub-FFTs' threads of a warp read interleaved bins, so a warp's loads
// cover whole runs of bins between them), runs split_run backwards and,
// after its block barrier, gathers the rows the round completes: each
// sample sums the carry of earlier rounds and its frames in ascending
// order, times win_over_n and inv_norm, the win/2 front trim, written by
// write_sample. Every thread runs every round (a frame outside [0, nf)
// loads zeros) and every barrier.
template <int LOG2P, int M>
__device__ __forceinline__ void istft_split_block(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw_p, const float2* __restrict__ tw_n, void* __restrict__ out,
    int out_int16, int nf, int win, int hop, int length, int rounds, int rows, int per_signal) {
  constexpr int P = 1 << LOG2P;
  constexpr int N = M * P;
  constexpr int T = N / kPoints;   // threads of one transform
  constexpr int bins = N / 2 + 1;
  constexpr int E = split_exchange_len(N);
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / T;
  const int group = threadIdx.x / T;
  const int jj = threadIdx.x - group * T;
  const int k = win / hop;       // frames that overlap one hop row
  const int f2 = 2 * groups;     // frames per round
  float2* twp = reinterpret_cast<float2*>(smem4);
  float2* twn = twp + twiddle_len(LOG2P);
  float2* bufs = twn + quarter_len(N);
  float* carry = reinterpret_cast<float*>(bufs + groups * E);  // (k - 1) hop
  const int n = blockIdx.x / per_signal;
  const int j0 = (blockIdx.x - n * per_signal) * rows;  // first hop row of the block
  const int total_rows = nf + k - 1;
  const int j_end = min(j0 + rows, total_rows);
  const long long track = (long long)n * nf * bins;
  const long long front = win / 2;

  for (int i = threadIdx.x; i < P / 4; i += blockDim.x) twp[slot(i)] = __ldg(tw_p + i);
  for (int i = threadIdx.x; i < N / 4; i += blockDim.x) twn[slot(i)] = __ldg(tw_n + i);
  for (int i = threadIdx.x; i < (k - 1) * hop; i += blockDim.x) carry[i] = 0.f;
  __syncthreads();

  float2* buf = bufs + group * E;
  for (int r = 0; r < rounds; ++r) {
    const int fr = j0 - (k - 1) + r * f2;  // first frame of the round
    const int fa = fr + 2 * group, fb = fa + 1;
    const bool ha = fa >= 0 && fa < nf, hb = fb >= 0 && fb < nf;
    const float* ra = ha ? re + track + (long long)fa * bins : nullptr;
    const float* ia = ha ? im + track + (long long)fa * bins : nullptr;
    const float* rb = hb ? re + track + (long long)fb * bins : nullptr;
    const float* ib = hb ? im + track + (long long)fb * bins : nullptr;
    float2 v[kPoints];
    split_inverse_points<LOG2P, M>(v, jj, [&](int kk, bool edge) {
      return make_float4(ra ? __ldg(ra + kk) : 0.f, ra && !edge ? __ldg(ia + kk) : 0.f,
                         rb ? __ldg(rb + kk) : 0.f, rb && !edge ? __ldg(ib + kk) : 0.f);
    });
    split_run<LOG2P, M>(v, buf, twp, twn, jj, group);
    // gather_round's loop, written out: through the helper ptxas gives some
    // of the split's instances larger stack frames
    for (int u = threadIdx.x; u < hop; u += blockDim.x) {
      for (int i = 0; i < f2 + k - 1; ++i) {
        const int row = fr + i;
        float acc = i < k - 1 ? carry[i * hop + u] : 0.f;
        const int f_lo = max(fr, row - k + 1), f_hi = min(fr + f2 - 1, row);
        for (int f = f_lo; f <= f_hi; ++f) {
          const int t = (row - f) * hop + u;
          const float2 z = bufs[((f - fr) >> 1) * E + slot(t)];
          acc += __ldg(win_over_n + t) * (((f - fr) & 1) ? -z.y : z.x);
        }
        if (i >= f2) {
          carry[(i - f2) * hop + u] = acc;
        } else if (row >= j0 && row < j_end) {
          const long long nabs = (long long)row * hop + u;
          const long long tpos = nabs - front;
          if (tpos >= 0 && tpos < length)
            write_sample(out, out_int16, (long long)n * length + tpos,
                         acc * __ldg(inv_norm + nabs));
        }
      }
    }
    __syncthreads();  // the buffers are read; the next round's first pass rewrites them
  }
}

// ---- the 16 384-point level -------------------------------------------------

constexpr int kLevelLog2 = kMaxLog2 + 1;  // the level's 2 x 8192 points

// One complex FFT of 16 384 points by one group of 512 threads (the whole
// block), each thread holding 16 points in registers at a time: split_run's
// structure with m = 2, its two 8192-point sub-FFTs run one after the other
// on the same threads. The group's exchange buffer is exchange_len(14)
// float2, two 8192-point buffers back to back: slot(8192 + k) is slot k of
// the second half. tw13 is the 8192-point quarter table, tw14 the 16
// 384-point one, both in shared memory; w = e^{-2 pi i / 16384}.
//
// forward (decimation in time), from point(t), the input point t: Fft<13>
// on the even points into half 0, then on the odd points into half 1 (the
// first run's last pass has left half 0 whole behind its barrier, and the
// second writes only half 1), then 8192 radix-2 butterflies in place, Z[k1]
// = Y0[k1] + w^k1 Y1[k1] and Z[k1 + 8192] = Y0[k1] - w^k1 Y1[k1], thread j
// taking the columns k1 = j + 512 m: Z in natural order at slot(k).
//
// forward_dif (decimation in frequency) takes its input u[n] = pre(n,
// buf[slot(n)]) in natural order from the buffer instead (the forward
// transform's output): a[n] = u[n] + u[n + 8192] stays in registers as the
// first run's points, b[n] = (u[n] - u[n + 8192]) w^n goes to half 1's
// column n; Fft<13> on a into half 0 and on b into half 1 gives Z[2k] at
// slot(k) and Z[2k + 1] at slot(8192 + k) (dif_slot).
template <bool kBlockSync>
struct Level {
  using F = Fft<kMaxLog2, kBlockSync>;
  static constexpr int H = F::N;  // 8192, a half
  static constexpr int N = 2 * H;
  static constexpr int T = F::T;  // 512
  static constexpr int E = exchange_len(kMaxLog2);  // slot(H): the first of half 1

  __device__ __forceinline__ static int dif_slot(int k) { return (k & 1) * E + slot(k >> 1); }

  template <class Point>
  __device__ __forceinline__ static void forward(Point point, float2* buf, const float2* tw13,
                                                 const float2* tw14, int j) {
    float2 v[kPoints];
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int m = 0; m < kPoints; ++m) v[m] = point(2 * (j + T * m) + h);
      F::run(v, buf + h * E, tw13, j, 0);
    }
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int k1 = j + T * m;
      const float2 y0 = buf[slot(k1)];
      const float2 y1 = cmul(buf[E + slot(k1)], quarter_twiddle<N>(tw14, k1));
      buf[slot(k1)] = make_float2(y0.x + y1.x, y0.y + y1.y);
      buf[E + slot(k1)] = make_float2(y0.x - y1.x, y0.y - y1.y);
    }
    F::sync(0);
  }

  template <class Pre>
  __device__ __forceinline__ static void forward_dif(Pre pre, float2* buf, const float2* tw13,
                                                     const float2* tw14, int j) {
    float2 v[kPoints];
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int n = j + T * m;
      const float2 a = pre(n, buf[slot(n)]);
      const float2 b = pre(n + H, buf[E + slot(n)]);
      v[m] = make_float2(a.x + b.x, a.y + b.y);
      buf[E + slot(n)] = cmul(make_float2(a.x - b.x, a.y - b.y), quarter_twiddle<N>(tw14, n));
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      if (h) {
#pragma unroll
        for (int m = 0; m < kPoints; ++m) v[m] = buf[E + slot(j + T * m)];
      }
      F::sync(0);  // every thread has read this half; the first pass rewrites it
      F::run(v, buf + h * E, tw13, j, 0);
    }
  }
};

// ---- Bluestein -------------------------------------------------------------

constexpr int kClusterLog2 = kMaxLog2 + 4;  // 131 072 points: a cluster of 16 blocks of 8192

// M = 2^ceil(log2(2 N - 1)), at least 16: Bluestein's convolution length
// for N points (fft_plan.bluestein_size); 0 past a cluster's 131 072. Up to
// the level's 16 384 one block holds a transform (stft_bluestein_block),
// past it a cluster (stft_cluster_block).
inline int bluestein_log2(int n) {
  int lg = kMinLog2;
  while ((1 << lg) < 2 * n - 1) ++lg;
  return lg <= kClusterLog2 ? lg : 0;
}

// Threads of one Bluestein transform: M / 16 on the core, 512 on the level.
__host__ __device__ constexpr int bluestein_threads(int log2m) {
  return log2m > kMaxLog2 ? kMaxThreads : fft_threads(log2m);
}

// float2 slots of a Bluestein block's twiddle tables in shared memory: the
// M-point quarter table on the core; on the level the 8192-point one (its
// halves' passes) and the 16 384-point one (its radix-2 stage).
__host__ __device__ constexpr int bluestein_tables_len(int log2m) {
  return log2m > kMaxLog2 ? twiddle_len(kMaxLog2) + quarter_len(1 << log2m) : twiddle_len(log2m);
}

// Dynamic shared memory of a forward Bluestein block of `ffts` groups: on
// the core stft_block's at M points (the span, the table, one exchange
// buffer a group); on the level the two tables and one exchange buffer,
// 191 488 bytes, the frames read straight from global memory (a span of
// two frames of up to 8192 samples does not fit beside them).
inline size_t bluestein_smem_bytes(int log2m, int win, int hop, int ffts) {
  if (log2m <= kMaxLog2) return smem_bytes(log2m, win, hop, ffts);
  return ((size_t)bluestein_tables_len(log2m) + (size_t)exchange_len(log2m)) * sizeof(float2);
}

// Dynamic shared memory of an inverse Bluestein block of `groups` groups:
// the tables, one exchange buffer per group, the carry of (win/hop - 1) hop
// rows.
inline size_t istft_bluestein_smem_bytes(int log2m, int win, int hop, int groups) {
  return ((size_t)bluestein_tables_len(log2m) + (size_t)groups * exchange_len(log2m)) *
             sizeof(float2) +
         (size_t)(win / hop - 1) * hop * sizeof(float);
}

// Bluestein's cyclic convolution of M = 2^LOG2M points for one group: with
// c_n = e^{i pi n^2 / N},
//
//   X[k] = conj c_k sum_{t < N} (x_t conj c_t) c_{k-t},
//
// the pre-chirped points v_t = point(t) (0 for N <= t < M), the FFT of v,
// times chat (the FFT of the wrapped chirp, c_n at n and M - n, made on the
// host in float64 with 1/M folded in), conjugated, the FFT again: the
// inverse by conjugation. On return, behind the group's barrier, buf[at(k)]
// holds conj((v * c)[k]). The core's Fft<LOG2M> (M <= 8192, M / 16 threads)
// runs both transforms, or the level (M 16 384, 512 threads): forward, then
// forward_dif with the product and conjugation as its input's pre. chat is
// read from global memory through L1 (copying the chirp tables into shared
// memory measured slower, PERF.md row 6″). kBlockSync: the core's transforms
// synchronize the whole block (the host emulation, which has only
// __syncthreads); the card synchronizes each group alone.
template <int LOG2M, bool kBlockSync>
struct Chirp {
  static constexpr bool kLevel = LOG2M > kMaxLog2;
  static constexpr int M = 1 << LOG2M;
  static constexpr int T = bluestein_threads(LOG2M);
  static constexpr int E = exchange_len(LOG2M);  // a group's exchange buffer
  static constexpr int TABLES = bluestein_tables_len(LOG2M);
  using F = Fft<kLevel ? kMaxLog2 : LOG2M, kBlockSync>;
  using Lv = Level<kBlockSync>;

  // tws (shared) from tw, the M-point quarter table (fft_plan.twiddles); on
  // the level the 8192-point table first, as tw's even entries: the same
  // float64 angles, rounded once.
  __device__ __forceinline__ static void load_tables(float2* tws, const float2* __restrict__ tw) {
    if constexpr (kLevel) {
      for (int i = threadIdx.x; i < Lv::H / 4; i += blockDim.x) tws[slot(i)] = __ldg(tw + 2 * i);
      float2* tw14 = tws + twiddle_len(kMaxLog2);
      for (int i = threadIdx.x; i < M / 4; i += blockDim.x) tw14[slot(i)] = __ldg(tw + i);
    } else {
      for (int i = threadIdx.x; i < M / 4; i += blockDim.x) tws[slot(i)] = __ldg(tw + i);
    }
  }

  // where point k of the convolution lies in the group's buffer
  __device__ __forceinline__ static int at(int k) {
    if constexpr (kLevel) {
      return Lv::dif_slot(k);
    } else {
      return slot(k);
    }
  }

  template <class Point>
  __device__ __forceinline__ static void convolve(Point point, float2* buf, const float2* tws,
                                                  const float2* __restrict__ chat, int j,
                                                  int group) {
    if constexpr (kLevel) {
      const float2* tw14 = tws + twiddle_len(kMaxLog2);
      Lv::forward(point, buf, tws, tw14, j);
      Lv::forward_dif(
          [&](int n, float2 z) {
            const float2 p = cmul(z, __ldg(chat + n));
            return make_float2(p.x, -p.y);
          },
          buf, tws, tw14, j);
    } else {
      float2 v[kPoints];
#pragma unroll
      for (int m = 0; m < kPoints; ++m) v[m] = point(j + T * m);
      F::run(v, buf, tws, j, group);
      // the inverse's input: conj(FFT times chat)
#pragma unroll
      for (int m = 0; m < kPoints; ++m) {
        const int k = j + T * m;
        const float2 p = cmul(buf[slot(k)], __ldg(chat + k));
        v[m] = make_float2(p.x, -p.y);
      }
      F::sync(group);  // every point is read; the first pass rewrites buf
      F::run(v, buf, tws, j, group);
    }
  }
};

// stft_block for any N <= 8192 by Bluestein (Chirp) over M = 2^LOG2M >= 2N
// - 1 points: each group carries frames f0 + 2 g and f0 + 2 g + 1 as z = a +
// i b (windowed, t < W) times chirp[t] = conj c_t, convolves, and gives Z[k]
// = chirp[k] conj(buf[at(k)]); then A and B at bins k <= N/2 from Z[k] and
// its partner Z[N - k], so odd N works. On the core the block stages its
// frames' span in shared memory; on the level (one group of two frames a
// block) it reads them straight from global memory, thread j's points t = 2
// (j + 512 m) + h coalesced across a warp. chirp (N) and chat (M) are read
// through L1. Calls out(frame_a, has_b, k, A, B) as stft_block.
template <int LOG2M, bool kBlockSync, class Out>
__device__ __forceinline__ void stft_bluestein_block(
    const float* __restrict__ x, const float* __restrict__ win, const float2* __restrict__ tw,
    const float2* __restrict__ chirp, const float2* __restrict__ chat, int L, int W, int hop,
    int nf, int N, Out out) {
  using C = Chirp<LOG2M, kBlockSync>;
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / C::T;
  const int group = threadIdx.x / C::T;
  const int j = threadIdx.x - group * C::T;
  const int frames = 2 * groups;
  const int per_signal = (nf + frames - 1) / frames;
  const int sig = blockIdx.x / per_signal;
  const int f0 = (blockIdx.x - sig * per_signal) * frames;
  const float* xs = x + (long long)sig * L;
  const long long s0 = (long long)f0 * hop - W / 2;  // the block's first sample
  float* smem = reinterpret_cast<float*>(smem4);
  float2* tws = reinterpret_cast<float2*>(smem);
  const float* span = nullptr;
  if constexpr (!C::kLevel) {
    tws = reinterpret_cast<float2*>(smem + span_floats(frames, W, hop));
    span = load_span(smem, xs, L, s0, (frames - 1) * hop + W);
  }
  float2* buf = tws + C::TABLES + group * C::E;
  C::load_tables(tws, tw);
  __syncthreads();

  // frame a (real) and frame b (imaginary), windowed, times conj c_t
  const int off = 2 * group * hop;  // frame a's first sample in the span
  C::convolve(
      [&](int t) {
        if (t >= W) return make_float2(0.f, 0.f);
        const float w = __ldg(win + t);
        float a, b;
        if constexpr (C::kLevel) {
          const long long s = s0 + t;
          a = s >= 0 && s < L ? __ldg(xs + s) : 0.f;
          b = s + hop >= 0 && s + hop < L ? __ldg(xs + s + hop) : 0.f;
        } else {
          a = span[off + t];
          b = span[off + hop + t];
        }
        return cmul(make_float2(a * w, b * w), __ldg(chirp + t));
      },
      buf, tws, chat, j, group);

  const int frame_a = f0 + 2 * group;
  if (frame_a >= nf) return;
  const bool has_b = frame_a + 1 < nf;
  for (int k = j; k <= N / 2; k += C::T) {
    const int kp = k ? N - k : 0;  // the partner bin
    const float2 zb = buf[C::at(k)], wb = buf[C::at(kp)];
    const float2 z = cmul(__ldg(chirp + k), make_float2(zb.x, -zb.y));
    const float2 w = cmul(__ldg(chirp + kp), make_float2(wb.x, -wb.y));
    out((long long)sig * nf + frame_a, has_b, k,
        make_float2(0.5f * (z.x + w.x), 0.5f * (z.y - w.y)),
        make_float2(0.5f * (z.y + w.y), 0.5f * (w.x - z.x)));
  }
}

// The iSTFT at any even N <= 8192 by Bluestein run backwards: istft.cu's
// istft_fft_kernel with Chirp in place of the core. The inverse N-point DFT
// of Z = A + i B is conj(DFT_N(conj Z)) / N, so a round's group fills v_t =
// conj Z[t] conj c_t for t < N from its pair's spectrum rows (inverse_point,
// the mirrored bin past Nyquist), convolves, and leaves Y[t] = conj c_t
// conj(buf[at(t)]) = N conj(a[t] + i b[t]) in place for t < win, as the
// core's inverse leaves its buffer; then istft_fft_kernel's gather, carry
// and epilogue (gather_round). Block (n, r) owns hop rows [j0, j0 + rows) of
// signal n and walks frames j0 - (win/hop - 1) on in rounds of 2 G; every
// thread runs every round and every barrier (a frame outside [0, nf) loads
// zeros). tw is the M-point quarter table, chirp (N) and chat (M) the
// forward kernel's tables (fft_plan.bluestein_tables).
template <int LOG2M, bool kBlockSync>
__device__ __forceinline__ void istft_bluestein_block(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, const float2* __restrict__ chirp,
    const float2* __restrict__ chat, void* __restrict__ out, int out_int16, int nf, int N,
    int win, int hop, int length, int rounds, int rows, int per_signal) {
  using C = Chirp<LOG2M, kBlockSync>;
  const int bins = N / 2 + 1;
  extern __shared__ float4 smem4[];
  const int groups = blockDim.x / C::T;
  const int group = threadIdx.x / C::T;
  const int j = threadIdx.x - group * C::T;
  const int k = win / hop;    // frames that overlap one hop row
  const int f2 = 2 * groups;  // frames per round
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* bufs = tws + C::TABLES;
  float* carry = reinterpret_cast<float*>(bufs + groups * C::E);  // (k - 1) hop
  const int n = blockIdx.x / per_signal;
  const int j0 = (blockIdx.x - n * per_signal) * rows;  // first hop row of the block
  const int j_end = min(j0 + rows, nf + k - 1);
  const long long track = (long long)n * nf * bins;

  C::load_tables(tws, tw);
  for (int i = threadIdx.x; i < (k - 1) * hop; i += blockDim.x) carry[i] = 0.f;
  __syncthreads();

  float2* buf = bufs + group * C::E;
  for (int r = 0; r < rounds; ++r) {
    const int fr = j0 - (k - 1) + r * f2;  // first frame of the round
    const int fa = fr + 2 * group, fb = fa + 1;
    const bool ha = fa >= 0 && fa < nf, hb = fb >= 0 && fb < nf;
    const float* ra = ha ? re + track + (long long)fa * bins : nullptr;
    const float* ia = ha ? im + track + (long long)fa * bins : nullptr;
    const float* rb = hb ? re + track + (long long)fb * bins : nullptr;
    const float* ib = hb ? im + track + (long long)fb * bins : nullptr;
    C::convolve(
        [&](int t) {
          if (t >= N) return make_float2(0.f, 0.f);
          const float2 z = inverse_point<true>(t, N, [&](int kk, bool edge) {
            return make_float4(ra ? __ldg(ra + kk) : 0.f, ra && !edge ? __ldg(ia + kk) : 0.f,
                               rb ? __ldg(rb + kk) : 0.f, rb && !edge ? __ldg(ib + kk) : 0.f);
          });
          return cmul(z, __ldg(chirp + t));
        },
        buf, tws, chat, j, group);
    for (int t = j; t < win; t += C::T) {  // each thread its own points: in place
      const float2 z = buf[C::at(t)];
      buf[C::at(t)] = cmul(__ldg(chirp + t), make_float2(z.x, -z.y));
    }
    __syncthreads();  // every group's frames are in its buffer
    gather_round([&](int g, int t) { return bufs[g * C::E + C::at(t)]; }, carry, win_over_n,
                 inv_norm, out, out_int16, n, fr, f2, k, hop, j0, j_end, length);
    __syncthreads();  // the buffers are read; the next round's first pass rewrites them
  }
}

// ---- Bluestein over a thread-block cluster ----------------------------------

// e^{-2 pi i e / M}, 0 <= e < M, from the M-point quarter table tw in global
// memory (fft_plan.twiddles, M/4 entries): quadrant q multiplies by (-i)^q.
template <int M>
__device__ __forceinline__ float2 ldg_twiddle(const float2* __restrict__ tw, int e) {
  constexpr int Q = M / 4;
  const int q = e / Q;
  const float2 w = __ldg(tw + (e - q * Q));
  switch (q) {
    case 0: return w;
    case 1: return make_float2(w.y, -w.x);
    case 2: return make_float2(-w.x, -w.y);
    default: return make_float2(-w.y, w.x);
  }
}

// Dynamic shared memory of a cluster's block (one group of fft_threads(P)
// threads): the P-point quarter table, one P-point exchange buffer and
// `carry` floats (the inverse's carry of its columns). 87 040 bytes at P
// 8192 and no carry.
inline size_t cluster_smem_bytes(int log2p, int carry) {
  return ((size_t)twiddle_len(log2p) + (size_t)exchange_len(log2p)) * sizeof(float2) +
         (size_t)carry * sizeof(float);
}
// the hop columns each block of a cluster of c owns in the inverse's gather
__host__ __device__ constexpr int cluster_columns(int hop, int c) { return (hop + c - 1) / c; }

// The FFT of M = C P points (P = 2^LOG2P, C = 2, 4, 8 or 16) on the C
// blocks of a cluster by decimation in time, one group of P / 16 threads a
// block, each block holding one P-point exchange buffer. With w =
// e^{-2 pi i / M} and W = w^P = e^{-2 pi i / C}, block r (its rank) holds
// the points u[C n + r], n < P, and
//
// 1. (run) the core's Fft<LOG2P> gives V_r[k1] at slot(k1); the owner
//    applies the combine's twiddle, w^{r k1} V_r[k1], in place; a cluster
//    barrier;
// 2. (point) the radix-C combine, computed where it is consumed:
//    Z[k1 + P q] = sum_r W^{r q} w^{r k1} V_r[k1], read from the C blocks'
//    buffers through distributed shared memory (peer), summed by Horner in
//    W^q.
//
// A caller that makes the points in another order stages them first: put
// stores u[t] in its owner's buffer (block t mod C, slot(t / C)) through
// distributed shared memory, and after a cluster barrier run_staged reads
// each thread's points back and runs step 1. The inverses at the powers of
// two past 8192 (wiener_common.cuh::wiener_cluster_dit_block,
// istft_cluster_dit_block) stage their points this way: each block forms a
// contiguous 1/C of the bins, read coalesced, and puts both points a bin
// gives.
// ClusterChirp's second transform runs on the points its first one left in
// registers. A block's buffer is read by its peers until the cluster's next
// barrier, which the caller places before the buffer is written again or
// the block exits. tw is the M-point quarter table in global memory (the
// P-point table in shared memory is its entries at stride C, bit for bit:
// the same float64 angles), read through L1. The core's transforms
// synchronize the whole block (it is one group), so the host emulation
// runs the same code.
template <int LOG2P, int C>
struct ClusterDit {
  static_assert(C == 2 || C == 4 || C == 8 || C == 16, "a cluster of 2, 4, 8 or 16 blocks");
  static constexpr int P = 1 << LOG2P;
  static constexpr int M = C * P;
  static constexpr int T = fft_threads(LOG2P);
  static constexpr int TABLES = twiddle_len(LOG2P);
  using F = Fft<LOG2P, true>;

  __device__ __forceinline__ static void load_tables(float2* tws, const float2* __restrict__ tw) {
    for (int i = threadIdx.x; i < P / 4; i += blockDim.x) tws[slot(i)] = __ldg(tw + C * i);
  }

  // step 1 on v, thread j's points of block `rank` (v[m] = u[C (j + T m) + rank])
  __device__ __forceinline__ static void run(float2 (&v)[kPoints], float2* buf, const float2* tws,
                                             const float2* __restrict__ tw, int rank, int j) {
    F::run(v, buf, tws, j, 0);
    if (rank) {
#pragma unroll
      for (int m = 0; m < kPoints; ++m) {
        const int k1 = j + T * m;
        buf[slot(k1)] = cmul(buf[slot(k1)], ldg_twiddle<M>(tw, rank * k1));
      }
    }
    cluster_sync();
  }

  // u[t] into the buffer of its owner, block t mod C, at slot(t / C)
  __device__ __forceinline__ static void put(float2* buf, int t, float2 u) {
    peer(buf, t & (C - 1))[slot(t >> ilog2(C))] = u;
  }

  // step 1 on the points put into this block's buffer (after a cluster
  // barrier that follows the puts)
  __device__ __forceinline__ static void run_staged(float2* buf, const float2* tws,
                                                    const float2* __restrict__ tw, int rank,
                                                    int j) {
    float2 v[kPoints];
#pragma unroll
    for (int m = 0; m < kPoints; ++m) v[m] = buf[slot(j + T * m)];
    F::sync(0);  // every point is read; the first pass rewrites buf
    run(v, buf, tws, tw, rank, j);
  }

  // Z[t], t < M, after run: the radix-C sum over the C buffers, by Horner
  // in W^q
  __device__ __forceinline__ static float2 point(const float2* buf,
                                                 const float2* __restrict__ tw, int t) {
    const int k1 = t & (P - 1);
    const float2 wq = ldg_twiddle<M>(tw, P * (t >> LOG2P));
    float2 v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) v[r] = peer(buf, r)[slot(k1)];
    float2 z = v[C - 1];
#pragma unroll
    for (int r = C - 2; r >= 0; --r) {
      const float2 b = cmul(z, wq);
      z = make_float2(v[r].x + b.x, v[r].y + b.y);
    }
    return z;
  }
};

// Bluestein's cyclic convolution of M = C P points (P = 2^LOG2P, C = 2, 4,
// 8 or 16) on the C blocks of a cluster, one group of P / 16 threads a block,
// each block holding one P-point exchange buffer: Chirp::convolve with the
// points spread over the cluster. With w = e^{-2 pi i / M} and W = w^P =
// e^{-2 pi i / C}, block r (its rank):
//
// 1. forward, decimation in frequency, the first stage fed from the point
//    functor (global memory): b_r[n] = w^{r n} sum_q u[n + P q] W^{r q},
//    n < P (u is 0 from M/2 on, so q < C/2), then the core's Fft<LOG2P> on
//    b_r leaves Y[C k + r] at slot(k): no exchange. Block r needs only its
//    own output r of the radix-C DFT, so it sums by Horner in W^r (C/2 - 1
//    products a point) where a whole dft<C> would cost C log2 C and discard
//    C - 1 of its outputs;
// 2. times chat[C k + r] (the FFT of the wrapped chirp with 1/M folded in),
//    conjugated, in place;
// 3. the inverse by conjugation, decimation in time: block r holds the
//    points = r (mod C), and ClusterDit runs them (Fft<LOG2P>, the
//    combine's twiddle in place, a cluster barrier);
// 4. the radix-C combine, computed where it is consumed (point,
//    ClusterDit::point). Z = conj(u * c), as Chirp leaves its buffer.
//
// Every block reads all N points of the frame in step 1 (the Horner sum
// over q), so a power-of-two N, which needs no chirp, runs on ClusterDit
// alone. The buffers, barriers, tables and point are ClusterDit's.
template <int LOG2P, int C>
struct ClusterChirp : ClusterDit<LOG2P, C> {
  using D = ClusterDit<LOG2P, C>;
  using D::M;
  using D::P;
  using D::T;
  using typename D::F;

  template <class Point>
  __device__ __forceinline__ static void convolve(Point point, float2* buf, const float2* tws,
                                                  const float2* __restrict__ tw,
                                                  const float2* __restrict__ chat, int rank,
                                                  int j) {
    const float2 wr = ldg_twiddle<M>(tw, P * rank);  // W^r
    float2 v[kPoints];
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int n = j + T * m;
      float2 s = point(n + P * (C / 2 - 1));  // Horner in W^r over q
#pragma unroll
      for (int q = C / 2 - 2; q >= 0; --q) {
        const float2 a = point(n + P * q), b = cmul(s, wr);
        s = make_float2(a.x + b.x, a.y + b.y);
      }
      v[m] = rank ? cmul(s, ldg_twiddle<M>(tw, rank * n)) : s;
    }
    F::run(v, buf, tws, j, 0);
#pragma unroll
    for (int m = 0; m < kPoints; ++m) {
      const int k = j + T * m;
      const float2 p = cmul(buf[slot(k)], __ldg(chat + C * k + rank));
      v[m] = make_float2(p.x, -p.y);
    }
    F::sync(0);  // every point is read; the first pass rewrites buf
    D::run(v, buf, tws, tw, rank, j);
  }
};

// stft_bluestein_block for 8192 < N <= 65 536 (M = 8192 C) on a cluster of C
// blocks (ClusterChirp at P = 2^LOG2P): cluster p = blockIdx.x / C (its
// blocks are consecutive in x) carries frames 2 p' and 2 p' + 1 of its
// signal as z = a + i b (windowed, t < W) times chirp[t], every block reading
// the points of its first stage straight from global memory (from L2 after
// the first); after the convolution block r takes the r-th 1/C of the bins k
// <= N/2, each from Z[k] and its partner Z[N - k] read across the cluster
// (so odd N works), and calls out(frame_a, has_b, k, A, B) as stft_block.
// smem4 is the block's dynamic shared memory (cluster_smem_bytes).
template <int LOG2P, int C, class Out>
__device__ __forceinline__ void stft_cluster_block(
    float4* smem4, const float* __restrict__ x, const float* __restrict__ win,
    const float2* __restrict__ tw, const float2* __restrict__ chirp,
    const float2* __restrict__ chat, int L, int W, int hop, int nf, int N, Out out) {
  using CC = ClusterChirp<LOG2P, C>;
  const int rank = blockIdx.x % C;
  const int pair = blockIdx.x / C;
  const int per_signal = (nf + 1) / 2;
  const int sig = pair / per_signal;
  const int f0 = (pair - sig * per_signal) * 2;
  const float* xs = x + (long long)sig * L;
  const long long s0 = (long long)f0 * hop - W / 2;  // frame a's first sample
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + CC::TABLES;
  const int j = threadIdx.x;
  CC::load_tables(tws, tw);
  __syncthreads();

  CC::convolve(
      [&](int t) {
        if (t >= W) return make_float2(0.f, 0.f);
        const float w = __ldg(win + t);
        const long long s = s0 + t;
        const float a = s >= 0 && s < L ? __ldg(xs + s) : 0.f;
        const float b = s + hop >= 0 && s + hop < L ? __ldg(xs + s + hop) : 0.f;
        return cmul(make_float2(a * w, b * w), __ldg(chirp + t));
      },
      buf, tws, tw, chat, rank, j);

  const bool has_b = f0 + 1 < nf;
  const int bins = N / 2 + 1, share = (bins + C - 1) / C;
  const int k_end = min(bins, (rank + 1) * share);
  for (int k = rank * share + j; k < k_end; k += CC::T) {
    const int kp = k ? N - k : 0;  // the partner bin
    const float2 zb = CC::point(buf, tw, k), wb = CC::point(buf, tw, kp);
    const float2 z = cmul(__ldg(chirp + k), make_float2(zb.x, -zb.y));
    const float2 w = cmul(__ldg(chirp + kp), make_float2(wb.x, -wb.y));
    out((long long)sig * nf + f0, has_b, k, make_float2(0.5f * (z.x + w.x), 0.5f * (z.y - w.y)),
        make_float2(0.5f * (z.y + w.y), 0.5f * (w.x - z.x)));
  }
  cluster_sync();  // the peers have read this block's buffer
}

// The inverse clusters' overlap-add of one round's pair of frames (fr, fr +
// 1) on a block's columns [u0, u0 + ncols) of every hop row
// (cluster_columns, cols a row), after the pair's transform: sample(t) =
// N conj(a[t] + i b[t]), read across the cluster once, serves frame a at
// row fr + i (t = i hop + u) and frame b at row fr + i + 1; a row sums the
// carry, frame a, then frame b (ascending frames, as gather_round); rows fr
// and fr + 1 complete, the k - 1 above carry on in carry ((k - 1) cols
// floats). A complete row of signal n in [j0, j_end) is written times
// inv_norm, the win/2 front trim, by write_sample.
template <class Sample>
__device__ __forceinline__ void cluster_pair_round(Sample sample, float* carry,
                                                   const float* __restrict__ win_over_n,
                                                   const float* __restrict__ inv_norm,
                                                   void* __restrict__ out, int out_int16, int n,
                                                   int fr, int k, int hop, int win, int cols,
                                                   int u0, int ncols, int j0, int j_end,
                                                   int length) {
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    const int u = u0 + c;
    float b_term = 0.f;  // frame b's term of row fr + i, from Z[(i - 1) hop + u]
    for (int i = 0; i <= k; ++i) {
      const int row = fr + i;
      float acc = i < k - 1 ? carry[i * cols + c] : 0.f;
      float b_next = 0.f;
      if (i < k) {
        const int t = i * hop + u;
        const float2 z = sample(t);
        const float w = __ldg(win_over_n + t);
        acc += w * z.x;
        b_next = w * -z.y;
      }
      if (i >= 1) acc += b_term;
      b_term = b_next;
      if (i >= 2) {
        carry[(i - 2) * cols + c] = acc;
      } else if (row >= j0 && row < j_end) {
        const long long nabs = (long long)row * hop + u;
        const long long tpos = nabs - win / 2;
        if (tpos >= 0 && tpos < length)
          write_sample(out, out_int16, (long long)n * length + tpos, acc * __ldg(inv_norm + nabs));
      }
    }
  }
}

// istft_bluestein_block for even 8192 < N <= 65 536 on a cluster of C
// blocks: cluster q = blockIdx.x / C owns hop rows [j0, j0 + rows) of
// signal n and walks frames j0 - (win/hop - 1) on in rounds of one pair (a
// block is one group): each block loads the points of its first stage
// straight from the pair's spectrum rows (conj Z[t] conj c_t, inverse_point,
// the mirrored bin past Nyquist), the cluster convolves, and block r gathers
// the r-th 1/C of every hop row's columns (cluster_columns): each frame
// sample t it adds is chirp[t] conj(Z[t]) = N conj(a[t] + i b[t]), Z read
// across the cluster as it is consumed; the carry of its columns stays in
// its shared memory. A cluster barrier ends each round (the peers have read
// the buffers the next round rewrites). Every thread runs every round and
// every barrier (a frame outside [0, nf) loads zeros).
template <int LOG2P, int C>
__device__ __forceinline__ void istft_cluster_block(
    float4* smem4, const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, const float2* __restrict__ chirp,
    const float2* __restrict__ chat, void* __restrict__ out, int out_int16, int nf, int N,
    int win, int hop, int length, int rounds, int rows, int per_signal) {
  using CC = ClusterChirp<LOG2P, C>;
  const int bins = N / 2 + 1;
  const int rank = blockIdx.x % C;
  const int cl = blockIdx.x / C;
  const int j = threadIdx.x;
  const int k = win / hop;  // frames that overlap one hop row
  const int cols = cluster_columns(hop, C);
  const int u0 = rank * cols;
  const int ncols = max(0, min(cols, hop - u0));
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + CC::TABLES;
  float* carry = reinterpret_cast<float*>(buf + exchange_len(LOG2P));  // (k - 1) cols
  const int n = cl / per_signal;
  const int j0 = (cl - n * per_signal) * rows;  // first hop row of the cluster
  const int j_end = min(j0 + rows, nf + k - 1);
  const long long track = (long long)n * nf * bins;

  CC::load_tables(tws, tw);
  for (int i = threadIdx.x; i < (k - 1) * cols; i += blockDim.x) carry[i] = 0.f;
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    const int fr = j0 - (k - 1) + 2 * r;  // the round's pair: frames fr, fr + 1
    const bool ha = fr >= 0 && fr < nf, hb = fr + 1 >= 0 && fr + 1 < nf;
    const float* ra = ha ? re + track + (long long)fr * bins : nullptr;
    const float* ia = ha ? im + track + (long long)fr * bins : nullptr;
    const float* rb = hb ? re + track + (long long)(fr + 1) * bins : nullptr;
    const float* ib = hb ? im + track + (long long)(fr + 1) * bins : nullptr;
    CC::convolve(
        [&](int t) {
          if (t >= N) return make_float2(0.f, 0.f);
          const float2 z = inverse_point<true>(t, N, [&](int kk, bool edge) {
            return make_float4(ra ? __ldg(ra + kk) : 0.f, ra && !edge ? __ldg(ia + kk) : 0.f,
                               rb ? __ldg(rb + kk) : 0.f, rb && !edge ? __ldg(ib + kk) : 0.f);
          });
          return cmul(z, __ldg(chirp + t));
        },
        buf, tws, tw, chat, rank, j);
    cluster_pair_round(
        [&](int t) {
          const float2 zb = CC::point(buf, tw, t);
          return cmul(__ldg(chirp + t), make_float2(zb.x, -zb.y));
        },
        carry, win_over_n, inv_norm, out, out_int16, n, fr, k, hop, win, cols, u0, ncols, j0,
        j_end, length);
    cluster_sync();  // the peers have read this round's buffers
  }
}

// istft_cluster_block at the powers of two past 8192, N = 2^LOG2P C (the
// reference's 16 384 on C = 2 blocks, 32 768 on C = 4, and 65 536 on C = 8):
// the direct inverse by decimation in time over the cluster (ClusterDit),
// without Bluestein's chirp and first transform. Cluster q = blockIdx.x / C
// owns hop rows [j0, j0 + rows) of signal n and walks frames j0 - (win/hop
// - 1) on in rounds of one pair (fr, fr + 1), as istft_cluster_block. A
// round:
// 1. block r reads its contiguous 1/C of both frames' bins, [r P/2, (r + 1)
//    P/2) (the last block also Nyquist), eight a thread at a stride of the
//    block (neighbouring threads read neighbouring bins), and puts both
//    points of conj Z, Z = A + i B, that a bin gives (k and N - k, as
//    inverse_point forms them) into the blocks that own them
//    (ClusterDit::put); a cluster barrier;
// 2. ClusterDit::run_staged: each block's Fft<LOG2P> on its points t = r
//    (mod C), the combine's twiddle in place, a cluster barrier;
// 3. istft_cluster_block's gather (cluster_pair_round) on the block's 1/C
//    of the hop columns, each sample Z[t] = N conj(a[t] + i b[t]) read
//    across the cluster (ClusterDit::point); a cluster barrier (the peers
//    have read the buffers the next round's puts rewrite).
// Every thread runs every round and every barrier (a frame outside [0, nf)
// puts zeros). tw is the N-point quarter table (fft_plan.twiddles); smem4
// the block's dynamic shared memory (cluster_smem_bytes with (k - 1)
// columns' carry).
template <int LOG2P, int C>
__device__ __forceinline__ void istft_cluster_dit_block(
    float4* smem4, const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, void* __restrict__ out, int out_int16, int nf, int win,
    int hop, int length, int rounds, int rows, int per_signal) {
  using D = ClusterDit<LOG2P, C>;
  constexpr int N = D::M;
  constexpr int bins = N / 2 + 1;
  constexpr int K = D::P / 2 / D::T;  // bins a thread reads: 8
  const int rank = blockIdx.x % C;
  const int cl = blockIdx.x / C;
  const int j = threadIdx.x;
  const int k = win / hop;  // frames that overlap one hop row
  const int cols = cluster_columns(hop, C);
  const int u0 = rank * cols;
  const int ncols = max(0, min(cols, hop - u0));
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + D::TABLES;
  float* carry = reinterpret_cast<float*>(buf + exchange_len(LOG2P));  // (k - 1) cols
  const int n = cl / per_signal;
  const int j0 = (cl - n * per_signal) * rows;  // first hop row of the cluster
  const int j_end = min(j0 + rows, nf + k - 1);
  const long long track = (long long)n * nf * bins;
  const int k0 = rank * (D::P / 2) + j;  // the thread's first bin

  D::load_tables(tws, tw);
  for (int i = threadIdx.x; i < (k - 1) * cols; i += blockDim.x) carry[i] = 0.f;
  // A cluster barrier, not a block one: the first round's puts write the
  // peers' shared memory, so every block of the cluster must be running.
  cluster_sync();

  for (int r = 0; r < rounds; ++r) {
    const int fr = j0 - (k - 1) + 2 * r;  // the round's pair: frames fr, fr + 1
    const bool ha = fr >= 0 && fr < nf, hb = fr + 1 >= 0 && fr + 1 < nf;
    const float* ra = ha ? re + track + (long long)fr * bins : nullptr;
    const float* ia = ha ? im + track + (long long)fr * bins : nullptr;
    const float* rb = hb ? re + track + (long long)(fr + 1) * bins : nullptr;
    const float* ib = hb ? im + track + (long long)(fr + 1) * bins : nullptr;
    float4 ab[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {  // DC's imaginary parts are ignored
      const int kk = k0 + i * D::T;
      ab[i] = make_float4(ra ? __ldg(ra + kk) : 0.f, ra && kk ? __ldg(ia + kk) : 0.f,
                          rb ? __ldg(rb + kk) : 0.f, rb && kk ? __ldg(ib + kk) : 0.f);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {  // conj Z[kk] and conj Z[N - kk] (inverse_point)
      const int kk = k0 + i * D::T;
      D::put(buf, kk, make_float2(ab[i].x - ab[i].w, -(ab[i].y + ab[i].z)));
      if (kk) D::put(buf, N - kk, make_float2(ab[i].x + ab[i].w, ab[i].y - ab[i].z));
    }
    if (rank == C - 1 && j == 0)  // Nyquist: real parts only
      D::put(buf, N / 2, make_float2(ra ? __ldg(ra + N / 2) : 0.f, rb ? -__ldg(rb + N / 2) : 0.f));
    cluster_sync();  // every block's points are in place
    D::run_staged(buf, tws, tw, rank, j);  // ends in a cluster barrier
    cluster_pair_round([&](int t) { return D::point(buf, tw, t); }, carry, win_over_n, inv_norm,
                       out, out_int16, n, fr, k, hop, win, cols, u0, ncols, j0, j_end, length);
    cluster_sync();  // the peers have read this round's buffers
  }
}

// ---- the 7-smooth block core over a cluster ---------------------------------
//
// The sizes past 8192 that are not powers of two but factor as N = C n, n
// <= 8192 and n = 2^a 3^b 5^c 7^d, run the direct inverse by decimation in
// time over a cluster of C blocks as ClusterDit does at the powers of two,
// each block's n points on a mixed-radix core (mixed_fft). C is the fewest
// of 2, 4, 8 with n <= 8192 for the 204 even sizes that rule takes (10 000,
// 20 000 and 40 000 are C 5000, 14 000, 28 000 and 56 000 C 7000), else
// the fewest blocks from ceil(N / 8192) to 8 that divide N (11 025 = 3 x
// 3675, 22 050 = 3 x 7350, 44 100 = 6 x 7350, 16 807 = 7 x 2401): 281
// sizes up to 65 536, 40 of them odd (fft_plan.mixed_factors):
//
// * Stockham passes of radix r in {2, 3, 4, 5, 7, 8, 9, 16} through the block's
//   exchange buffer (slot(i)), a schedule the host plans and passes in
//   (fft_plan.mixed_radices, kMixedRadixBits a radix), so one instance per
//   C serves every n; the pass of radix r after passes whose radices
//   multiply to Ns reads butterfly j's points j + s n / r, s < r,
//   multiplies point s by e^{-2 pi i s (j mod Ns) / (Ns r)}, runs an r-point
//   DFT in registers (dft, dft_odd) and writes its outputs to (j - j mod Ns)
//   r + j mod Ns + s Ns: natural order out, no reordering;
// * thread tid takes the butterflies j = tid + b T, b < ceil(16 / r), so n
//   <= 16 T (8192 at the card's 512 threads), and holds their points in
//   registers (kMixedPoints: 21, three radix-7 butterflies where n / 7 >
//   1024 at 512 threads, as n 7203 or 8064) across the barrier between the
//   pass's reads and its writes: one buffer serves;
// * every pass's twiddles are entries of one n-point table e^{-2 pi i m / n},
//   m < n, in shared memory: the N-point table's entries at stride C (the
//   host rounds it once from float64, fft_plan.dft_table). The table is
//   whole, not a quarter, so n need not be a multiple of 4 (4374, 6250, the
//   odd 4375, 5625, 6075, 6561 and 7203);
// * the combine is ClusterDit's with P = n: block r holds u[C m + r], m < n,
//   its transform V_r is multiplied by w^{r k1} (w = e^{-2 pi i / N}, the
//   N-point table in global memory, read through L1), and Z[k1 + n q] =
//   sum_r W^{r q} w^{r k1} V_r[k1] (W = e^{-2 pi i / C}) is summed by Horner
//   in W^q where it is consumed.

constexpr int kMixedRadixBits = 5;  // the bits of one radix in a schedule

// float2 slots of a mixed block's table and exchange buffer (n + n + n / 16)
__host__ __device__ constexpr int mixed_tables_len(int n) { return n + split_exchange_len(n); }

// Dynamic shared memory of a mixed cluster's block: the n-point table, the
// exchange buffer and `carry` floats (the inverse's carry of its columns).
inline size_t cluster_mixed_smem_bytes(int n, int carry) {
  return (size_t)mixed_tables_len(n) * sizeof(float2) + (size_t)carry * sizeof(float);
}

// m = 2^a 3^b 5^c 7^d
inline bool smooth7(int m) {
  while (m % 2 == 0) m /= 2;
  while (m % 3 == 0) m /= 3;
  while (m % 5 == 0) m /= 5;
  while (m % 7 == 0) m /= 7;
  return m == 1;
}

// C and n of a size the mixed cluster takes (fft_plan.mixed_factors): a
// 7-smooth nfft in (8192, 65 536], not a power of two, n = nfft / C. C is
// the fewest of 2, 4, 8 with nfft / C <= 8192 where that C divides nfft
// (the 204 even sizes of clusters of 2, 4 and 8), else the fewest blocks
// from ceil(nfft / 8192) to 8 that divide it (77 more on 3, 5, 6 and 7,
// odd sizes among them); none past 8 (46 875, 59 049 and 11 more).
inline bool mixed_sizes(int nfft, int* c, int* n) {
  if (nfft <= (1 << kMaxLog2) || nfft > (8 << kMaxLog2) || (nfft & (nfft - 1)) == 0 ||
      !smooth7(nfft))
    return false;
  *c = nfft <= (2 << kMaxLog2) ? 2 : nfft <= (4 << kMaxLog2) ? 4 : 8;
  for (int b = (nfft + (1 << kMaxLog2) - 1) >> kMaxLog2; nfft % *c; ++b) {
    if (b > 8) return false;
    *c = b;
  }
  *n = nfft / *c;
  return true;
}

// The schedule's radices are each one the core has and multiply to n.
inline bool mixed_schedule_ok(int n, unsigned long long sched) {
  long long prod = 1;
  for (; sched; sched >>= kMixedRadixBits) {
    const int r = (int)(sched & ((1u << kMixedRadixBits) - 1));
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8 && r != 9 && r != 16)
      return false;
    prod *= r;
  }
  return prod == n;
}

template <int R>
__device__ __forceinline__ void dft_any(float2 (&u)[R]) {
  if constexpr (R == 3 || R == 5 || R == 7 || R == 9) {
    dft_odd<R>(u);
  } else {
    dft<R>(u);
  }
}

constexpr int kMixedPoints = 21;  // a thread's points in a pass at most: 3 radix-7 butterflies

// One Stockham pass of radix R over the block's n points in buf (after a
// barrier that follows their writes); ends behind a barrier. tws is the
// n-point table, ns the product of the earlier passes' radices; v holds the
// thread's points between the pass's reads and its writes, one array that
// every pass shares (as the core's passes share theirs).
template <int R>
__device__ __forceinline__ void mixed_pass(float2 (&v)[kMixedPoints], float2* buf,
                                           const float2* tws, int n, int ns) {
  constexpr int B = (kPoints + R - 1) / R;  // butterflies a thread at most: n <= 16 T
  static_assert(B * R <= kMixedPoints, "a pass's points fit the thread's array");
  const int T = blockDim.x;
  const int nb = n / R;              // the pass's butterflies
  const int step = n / (ns * R);     // e^{-2 pi i s k / (ns R)} = tws[s k step]
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * T;
    if (j < nb) {
      const int k = j % ns;
      float2 u[R];
#pragma unroll
      for (int s = 0; s < R; ++s) u[s] = buf[slot(j + s * nb)];
      if (k) {
#pragma unroll
        for (int s = 1; s < R; ++s) u[s] = cmul(u[s], tws[s * k * step]);
      }
      dft_any<R>(u);
#pragma unroll
      for (int s = 0; s < R; ++s) v[b * R + s] = u[s];
    }
  }
  __syncthreads();  // every point is read; the writes below overwrite them
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = threadIdx.x + b * T;
    if (j < nb) {
      const int k = j % ns;
      const int base = (j - k) * R + k;
#pragma unroll
      for (int s = 0; s < R; ++s) buf[slot(base + s * ns)] = v[b * R + s];
    }
  }
  __syncthreads();
}

// The forward DFT of the n points at buf[slot(i)] (natural order, in
// place) by the whole block, in the passes of `sched`; every point must be
// in place behind a barrier, and the result is, behind the last pass's.
// The passes run grouped by radix, 16, 8, 4, 2, 5, 7, 9, 3 (the order
// fft_plan.mixed_radices plans them in; any order is the same transform),
// one loop a radix, all on one array of points: one loop that switched on
// the radix, or an array a pass, spilled 700-1100 bytes at 128 registers
// inside istft_cluster_mixed_block's rounds, where each pass alone takes
// 56-72. Loops that ran while the schedule's next radix was theirs, in
// place of the counts, spilled in wiener_cluster_mixed_block.
__device__ __forceinline__ void mixed_fft(float2* buf, const float2* tws, int n,
                                          unsigned long long sched) {
  int c16 = 0, c8 = 0, c4 = 0, c2 = 0, c5 = 0, c7 = 0, c9 = 0, c3 = 0;  // passes of each radix
#pragma unroll 1
  for (; sched; sched >>= kMixedRadixBits) {
    const int r = (int)(sched & ((1u << kMixedRadixBits) - 1));
    c16 += r == 16;
    c8 += r == 8;
    c4 += r == 4;
    c2 += r == 2;
    c5 += r == 5;
    c7 += r == 7;
    c9 += r == 9;
    c3 += r == 3;
  }
  float2 v[kMixedPoints];
  int ns = 1;
#pragma unroll 1
  for (int i = 0; i < c16; ++i, ns *= 16) mixed_pass<16>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c8; ++i, ns *= 8) mixed_pass<8>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c4; ++i, ns *= 4) mixed_pass<4>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c2; ++i, ns *= 2) mixed_pass<2>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c5; ++i, ns *= 5) mixed_pass<5>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c7; ++i, ns *= 7) mixed_pass<7>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c9; ++i, ns *= 9) mixed_pass<9>(v, buf, tws, n, ns);
#pragma unroll 1
  for (int i = 0; i < c3; ++i, ns *= 3) mixed_pass<3>(v, buf, tws, n, ns);
}

// ClusterDit for N = C n, n 7-smooth (the header above): block r holds u[C m
// + r], m < n, in its exchange buffer at slot(m); tw is the N-point table
// e^{-2 pi i m / N}, m < N, in global memory (fft_plan.dft_table). Nothing
// asks C to be a power of two: the owner and slot of a point are t mod C
// and t / C, and the combine sums by Horner in W^q with q = t / n.
//
// At 2, 4 and 8 the owner and slot are a mask and a shift and a thread's
// bins a stride of 512 apart share their owner, so the puts go through
// peer's pointers. At 3, 5, 6 and 7 they go through 32-bit shared::cluster
// addresses (peer_store), each bin's owner and slot advanced from the last
// one's (put_bins), and the combine's loads too at 3, 5 and 7 (peer_load):
// with peer's generic pointers and a division a point, ptxas spilled 92-104
// bytes in wiener_cluster_mixed_kernel<3>, <5> and <6> and 8-24 in
// istft_cluster_mixed_kernel<5> and <7> at 128 registers; these forms
// spill none. At 6 the combine keeps peer's loads: with peer_load the
// Wiener instance spilled 64 bytes.
template <int C>
struct ClusterMixed {
  static_assert(C >= 2 && C <= 8, "a cluster of 2 to 8 blocks (the portable cluster size)");
  static constexpr bool kPow2 = (C & (C - 1)) == 0;
  static constexpr bool kLoad32 = !kPow2 && C != 6;  // the combine's loads by peer_load

  // tws (shared, n entries): the N-point table's entries at stride C
  __device__ __forceinline__ static void load_tables(float2* tws, const float2* __restrict__ tw,
                                                     int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) tws[i] = __ldg(tw + C * i);
  }

  // u[t] into the buffer of its owner, block t mod C, at slot(t / C)
  __device__ __forceinline__ static void put(float2* buf, int t, float2 u) {
    const unsigned v = (unsigned)t;
    if constexpr (kPow2) {
      peer(buf, (int)(v % C))[slot((int)(v / C))] = u;
    } else {
      peer_store(buf + slot((int)(v / C)), (int)(v % C), u);
    }
  }

  // the two points of conj Z a bin gives (inverse_point), ab[i] = (A re, A
  // im, B re, B im) of Z = A + i B at bin kk = kk0 + i stride: conj Z[kk]
  // and, but at DC, conj Z[N - kk], for each kk < k_end
  template <int K>
  __device__ __forceinline__ static void put_bins(float2* buf, const float4 (&ab)[K], int kk0,
                                                  int stride, int k_end, int N) {
    if constexpr (kPow2) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int kk = kk0 + i * stride;
        if (kk < k_end) {
          put(buf, kk, make_float2(ab[i].x - ab[i].w, -(ab[i].y + ab[i].z)));
          if (kk) put(buf, N - kk, make_float2(ab[i].x + ab[i].w, ab[i].y - ab[i].z));
        }
      }
    } else {
      // kk = C q1 + r1 and N - kk = C q2 + r2, a stride = C sq + sr on
      const unsigned sq = (unsigned)stride / C, sr = (unsigned)stride % C;
      unsigned q1 = (unsigned)kk0 / C, r1 = (unsigned)kk0 % C;
      unsigned q2 = (unsigned)(N - kk0) / C, r2 = (unsigned)(N - kk0) % C;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int kk = kk0 + i * stride;
        if (kk < k_end) {
          peer_store(buf + slot((int)q1), (int)r1,
                     make_float2(ab[i].x - ab[i].w, -(ab[i].y + ab[i].z)));
          if (kk)
            peer_store(buf + slot((int)q2), (int)r2,
                       make_float2(ab[i].x + ab[i].w, ab[i].y - ab[i].z));
        }
        r1 += sr;
        q1 += sq;
        if (r1 >= C) {
          r1 -= C;
          ++q1;
        }
        if (r2 < sr) {
          r2 += C;
          --q2;
        }
        r2 -= sr;
        q2 -= sq;
      }
    }
  }

  // after the puts and a cluster barrier: the block's transform, the
  // combine's twiddle w^{rank k1} in place, a cluster barrier
  __device__ __forceinline__ static void run_staged(float2* buf, const float2* tws,
                                                    const float2* __restrict__ tw, int n,
                                                    unsigned long long sched, int rank) {
    mixed_fft(buf, tws, n, sched);
    if (rank) {
      for (int k1 = threadIdx.x; k1 < n; k1 += blockDim.x)
        buf[slot(k1)] = cmul(buf[slot(k1)], __ldg(tw + rank * k1));
    }
    cluster_sync();
  }

  // Z[t], t < N, after run_staged: the radix-C sum over the C buffers, by
  // Horner in W^q
  __device__ __forceinline__ static float2 point(const float2* buf,
                                                 const float2* __restrict__ tw, int n, int t) {
    const int q = t / n;
    const int k1 = t - q * n;
    const float2 wq = __ldg(tw + n * q);
    float2 v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      if constexpr (kLoad32) {
        v[r] = peer_load(buf + slot(k1), r);
      } else {
        v[r] = peer(buf, r)[slot(k1)];
      }
    }
    float2 z = v[C - 1];
#pragma unroll
    for (int r = C - 2; r >= 0; --r) {
      const float2 b = cmul(z, wq);
      z = make_float2(v[r].x + b.x, v[r].y + b.y);
    }
    return z;
  }
};

// istft_cluster_dit_block for N = C n, n 7-smooth (ClusterMixed, the
// header above): the same rounds of one pair (fr, fr + 1), a cluster owning
// hop rows [j0, j0 + rows) of signal n_sig. A round:
// 1. block r reads its contiguous 1/C of both frames' bins, [r S, (r + 1) S)
//    with S = ceil(H / C), H the bins that give two points: N / 2 at even N
//    (S = n / 2 at even n; the last block also Nyquist, real parts only),
//    (N + 1) / 2 at odd N, which has no Nyquist bin (its last bin (N - 1) /
//    2 gives two points as any other, as inverse_point<true> forms them); at
//    most eight a thread at a stride of the block, and puts the two points
//    of conj Z a bin gives (k and N - k) into their owners
//    (ClusterMixed::put); a cluster barrier;
// 2. ClusterMixed::run_staged: the block's n-point transform on its points
//    t = r (mod C), the combine's twiddle, a cluster barrier;
// 3. the gather (cluster_pair_round) on the block's 1/C of the hop columns,
//    each sample read across the cluster (ClusterMixed::point); a cluster
//    barrier.
// sched is the block transform's schedule (fft_plan.mixed_schedule), tw the
// N-point table (fft_plan.dft_table); smem4 holds cluster_mixed_smem_bytes
// with (k - 1) columns' carry. n <= 16 blockDim.x. D is the cluster's
// exchange (ClusterMixed<C>; the host emulation swaps in other forms of
// its put to hold them to it bit for bit).
template <int C, class D = ClusterMixed<C>>
__device__ __forceinline__ void istft_cluster_mixed_block(
    float4* smem4, const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ win_over_n, const float* __restrict__ inv_norm,
    const float2* __restrict__ tw, void* __restrict__ out, int out_int16, int nf, int n,
    int win, int hop, int length, int rounds, int rows, int per_signal,
    unsigned long long sched) {
  constexpr int K = kPoints / 2;  // bins a thread reads at most: S <= 8 T
  const int N = C * n;
  const int half = N / 2;
  const int bins = half + 1;
  const bool odd = N & 1;
  const int pairs = odd ? bins : half;  // the bins that give two points (DC one)
  const int share = (pairs + C - 1) / C;
  const int rank = blockIdx.x % C;
  const int cl = blockIdx.x / C;
  const int j = threadIdx.x;
  const int T = blockDim.x;
  const int k = win / hop;  // frames that overlap one hop row
  const int cols = cluster_columns(hop, C);
  const int u0 = rank * cols;
  const int ncols = max(0, min(cols, hop - u0));
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + n;
  float* carry = reinterpret_cast<float*>(buf + split_exchange_len(n));  // (k - 1) cols
  const int sig = cl / per_signal;
  const int j0 = (cl - sig * per_signal) * rows;  // first hop row of the cluster
  const int j_end = min(j0 + rows, nf + k - 1);
  const long long track = (long long)sig * nf * bins;
  const int k0 = rank * share;                    // the block's first bin
  const int k_end = min(pairs, k0 + share);

  D::load_tables(tws, tw, n);
  for (int i = threadIdx.x; i < (k - 1) * cols; i += blockDim.x) carry[i] = 0.f;
  // A cluster barrier, not a block one: the first round's puts write the
  // peers' shared memory, so every block of the cluster must be running.
  cluster_sync();

  for (int r = 0; r < rounds; ++r) {
    const int fr = j0 - (k - 1) + 2 * r;  // the round's pair: frames fr, fr + 1
    const bool ha = fr >= 0 && fr < nf, hb = fr + 1 >= 0 && fr + 1 < nf;
    const float* ra = ha ? re + track + (long long)fr * bins : nullptr;
    const float* ia = ha ? im + track + (long long)fr * bins : nullptr;
    const float* rb = hb ? re + track + (long long)(fr + 1) * bins : nullptr;
    const float* ib = hb ? im + track + (long long)(fr + 1) * bins : nullptr;
    float4 ab[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {  // DC's imaginary parts are ignored
      const int kk = k0 + j + i * T;
      const bool in = kk < k_end;
      ab[i] = make_float4(in && ra ? __ldg(ra + kk) : 0.f, in && ra && kk ? __ldg(ia + kk) : 0.f,
                          in && rb ? __ldg(rb + kk) : 0.f, in && rb && kk ? __ldg(ib + kk) : 0.f);
    }
    D::template put_bins<K>(buf, ab, k0 + j, T, k_end, N);  // conj Z[kk], conj Z[N - kk]
    if (!odd && rank == C - 1 && j == 0)  // Nyquist: real parts only
      D::put(buf, half, make_float2(ra ? __ldg(ra + half) : 0.f, rb ? -__ldg(rb + half) : 0.f));
    cluster_sync();  // every block's points are in place
    D::run_staged(buf, tws, tw, n, sched, rank);  // ends in a cluster barrier
    cluster_pair_round([&](int t) { return D::point(buf, tw, n, t); }, carry, win_over_n,
                       inv_norm, out, out_int16, sig, fr, k, hop, win, cols, u0, ncols, j0,
                       j_end, length);
    cluster_sync();  // the peers have read this round's buffers
  }
}

// ---- the direct 16 384-point STFT on the level ------------------------------

// stft_block for N = 16 384 on the level (one 512-thread block a pair of
// frames): frame a = f0 and b = f0 + 1 of signal sig ride one transform as
// z = win (x_a + i x_b), the points read straight from global memory as
// Level::forward asks for them (t = 2 (j + 512 m) + h), then A and B at bins
// k <= N/2 from Z[k] and Z[N - k] as stft_block splits them. No chirp: one
// transform of N points a pair where Bluestein runs two of 2N. smem4 holds
// the level's two quarter tables (tw is the 16 384-point one;
// Chirp::load_tables takes its even entries for the halves) and one
// 16 384-point exchange buffer: 191 488 bytes. Calls out(frame_a, has_b, k,
// A, B) as stft_block.
template <bool kBlockSync, class Out>
__device__ __forceinline__ void stft_level_block(float4* smem4, const float* __restrict__ x,
                                                 const float* __restrict__ win,
                                                 const float2* __restrict__ tw, int L, int W,
                                                 int hop, int nf, Out out) {
  using C = Chirp<kLevelLog2, kBlockSync>;
  using Lv = Level<kBlockSync>;
  constexpr int N = Lv::N;
  const int per_signal = (nf + 1) / 2;
  const int sig = blockIdx.x / per_signal;
  const int f0 = (blockIdx.x - sig * per_signal) * 2;
  const float* xs = x + (long long)sig * L;
  const long long s0 = (long long)f0 * hop - W / 2;  // frame a's first sample
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + C::TABLES;
  C::load_tables(tws, tw);
  __syncthreads();
  Lv::forward(
      [&](int t) {
        if (t >= W) return make_float2(0.f, 0.f);
        const float w = __ldg(win + t);
        const long long s = s0 + t;
        const float a = s >= 0 && s < L ? __ldg(xs + s) : 0.f;
        const float b = s + hop >= 0 && s + hop < L ? __ldg(xs + s + hop) : 0.f;
        return make_float2(a * w, b * w);
      },
      buf, tws, tws + twiddle_len(kMaxLog2), threadIdx.x);
  const bool has_b = f0 + 1 < nf;
  for (int k = threadIdx.x; k <= N / 2; k += Lv::T) {
    const float2 z = buf[slot(k)];
    const float2 w = buf[slot((N - k) & (N - 1))];
    out((long long)sig * nf + f0, has_b, k, make_float2(0.5f * (z.x + w.x), 0.5f * (z.y - w.y)),
        make_float2(0.5f * (z.y + w.y), 0.5f * (w.x - z.x)));
  }
}

// ---- the second level: Bluestein past 65 536 points ------------------------
//
// Past a cluster's 131 072 points, Bluestein's M = R P (P = 8192, R = 32 or
// 64: M 262 144 up to 131 072 points, 524 288 up to 262 144) lives in device
// memory, a scratch of M float2 for each pair of frames in flight
// (fft_plan.level2_plan keeps the scratch of a round within the L2). It is
// ClusterChirp's factorization with the cluster's distributed shared memory
// replaced by two passes through that scratch; w = e^{-2 pi i / M}, W_R =
// e^{-2 pi i / R}:
//
// A. (level2_first) for each n1 < P, one thread: the points u[n1 + P q]
//    (q < R/2: u is 0 from M/2 on, as N <= M/2) from the point functor, a
//    radix-R DFT over q in registers (dft_wide), times w^{r n1}: b_r[n1] at
//    scratch[r P + n1];
// B/C. (level2_middle) for each r, one 512-thread block: Fft<13> of b_r
//    leaves the forward transform's Y[R k + r] at slot(k); times chat[R k +
//    r] (fft_plan.level2_chat stores it at r P + k), conjugated; Fft<13>
//    again, the inverse's decimation in time over the points = r (mod R),
//    gives V_r[k1]; times w^{r k1}, back to scratch[r P + k1] (the block
//    reads and writes only its own row);
// D. (level2_last) for each k1 < P, one thread: the radix-R combine over r,
//    Z[k1 + P q] = sum_r W_R^{r q} (w^{r k1} V_r[k1]), q < R/2 (t < M/2
//    covers every t < N): Z = conj(u * c) at t, as Chirp leaves its buffer,
//    handed to store(t, Z[t]).
//
// The point functor of A carries the pre-chirp, D's store the post-chirp;
// the inverse STFT is the same convolution run backwards (conjugation), as
// on the core. The phases are separate launches on one stream (the
// grid-wide exchange between them has no other barrier).

constexpr int kLevel2MinLog2 = kMaxLog2 + 5;  // M 262 144 = 32 x 8192
constexpr int kLevel2MaxLog2 = kMaxLog2 + 6;  // M 524 288 = 64 x 8192
constexpr int kLevel2Threads = 256;           // threads of a block of phases A and D

// log2 of Bluestein's M for n points when the second level takes it (M 262
// 144 or 524 288: 65 536 < n <= 262 144), else 0
inline int level2_log2(int n) {
  int lg = kMinLog2;
  while ((1 << lg) < 2 * n - 1 && lg <= kLevel2MaxLog2) ++lg;
  return lg >= kLevel2MinLog2 && lg <= kLevel2MaxLog2 ? lg : 0;
}

// In-register forward DFT of R = 16 B points (B = 2 or 4), natural order in
// and out: B DFTs of 16 points over x[B m + j] (literal roots), the twiddles
// turn(u, e) = u W_R^e (W_R = e^{-2 pi i / R}, 0 < e < 16 (B - 1)), then 16
// DFTs of B points: X[k + 16 l].
template <int R, class Turn>
__device__ __forceinline__ void dft_wide(float2 (&x)[R], Turn turn) {
  constexpr int B = R / 16;
  static_assert(B == 2 || B == 4, "R = 32 or 64");
  float2 y[R];
#pragma unroll
  for (int j = 0; j < B; ++j) {
    float2 u[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) u[m] = x[B * m + j];
    dft<16>(u);
#pragma unroll
    for (int k = 0; k < 16; ++k) y[j * 16 + k] = j * k ? turn(u[k], j * k) : u[k];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float2 c[B];
#pragma unroll
    for (int j = 0; j < B; ++j) c[j] = y[j * 16 + k];
    dft<B>(c);
#pragma unroll
    for (int l = 0; l < B; ++l) x[k + 16 * l] = c[l];
  }
}

// dft_wide with W_R^e from the M-point quarter table tw in global memory
// (read through L1: W_R^e = w^{e M / R})
template <int R, int LOG2M>
__device__ __forceinline__ void dft_wide(float2 (&x)[R], const float2* __restrict__ tw) {
  constexpr int M = 1 << LOG2M;
  dft_wide<R>(x, [&](float2 u, int e) { return cmul(u, ldg_twiddle<M>(tw, e * (M / R))); });
}

// Phase A for column n1 of one pair's scratch (M float2): point(t), t < M/2.
template <int LOG2M, class Point>
__device__ __forceinline__ void level2_first(Point point, float2* __restrict__ scratch,
                                             const float2* __restrict__ tw, int n1) {
  constexpr int M = 1 << LOG2M, P = 1 << kMaxLog2, R = M / P;
  float2 u[R];
#pragma unroll
  for (int q = 0; q < R; ++q) u[q] = q < R / 2 ? point(n1 + P * q) : make_float2(0.f, 0.f);
  dft_wide<R, LOG2M>(u, tw);
#pragma unroll
  for (int r = 0; r < R; ++r)
    scratch[r * P + n1] = r ? cmul(u[r], ldg_twiddle<M>(tw, r * n1)) : u[r];
}

// Dynamic shared memory of a phase B/C block: the 8192-point quarter table
// and one 8192-point exchange buffer (87 040 bytes).
__host__ __device__ constexpr int level2_middle_smem() {
  return (twiddle_len(kMaxLog2) + exchange_len(kMaxLog2)) * (int)sizeof(float2);
}

// Phase B/C for row r of one pair's scratch: one block of 512 threads; row
// = scratch + r P, chat_r = level2_chat + r P. tw is the M-point quarter
// table (the 8192-point one is its entries at stride R, bit for bit).
template <int LOG2M>
__device__ __forceinline__ void level2_middle(float4* smem4, float2* __restrict__ row,
                                              const float2* __restrict__ tw,
                                              const float2* __restrict__ chat_r, int r) {
  using F = Fft<kMaxLog2, true>;
  constexpr int M = 1 << LOG2M, P = F::N, R = M / P, T = F::T;
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + twiddle_len(kMaxLog2);
  const int j = threadIdx.x;
  for (int i = j; i < P / 4; i += blockDim.x) tws[slot(i)] = __ldg(tw + R * i);
  float2 v[kPoints];
#pragma unroll
  for (int m = 0; m < kPoints; ++m) v[m] = row[j + T * m];
  __syncthreads();  // the table is in
  F::run(v, buf, tws, j, 0);
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int k = j + T * m;
    const float2 p = cmul(buf[slot(k)], __ldg(chat_r + k));
    v[m] = make_float2(p.x, -p.y);
  }
  F::sync(0);  // every point is read; the first pass rewrites buf
  F::run(v, buf, tws, j, 0);
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int k1 = j + T * m;
    const float2 z = buf[slot(k1)];
    row[k1] = r ? cmul(z, ldg_twiddle<M>(tw, r * k1)) : z;
  }
}

// Phase D for column k1 of one pair's scratch: store(t, Z[t]) for t = k1 +
// P q, q < R/2. Column k1's entries are read before any is stored, and no
// other thread touches them, so store may write them in place.
template <int LOG2M, class Store>
__device__ __forceinline__ void level2_last(const float2* scratch,
                                            const float2* __restrict__ tw, int k1, Store store) {
  constexpr int M = 1 << LOG2M, P = 1 << kMaxLog2, R = M / P;
  float2 u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) u[r] = scratch[r * P + k1];
  dft_wide<R, LOG2M>(u, tw);
#pragma unroll
  for (int q = 0; q < R / 2; ++q) store(k1 + P * q, u[q]);
}

// The forward STFT's points of a pair on the second level: frames g and g +
// 1 of the flattened (signals x nf) frames (frame b absent past `frames`),
// windowed, times chirp[t] = conj c_t; 0 from W on.
struct Level2Frames {
  const float* x;
  const float* win;
  const float2* chirp;
  int L, W, hop, nf, frames;
  __device__ __forceinline__ float sample(int g, int t) const {
    if (g >= frames) return 0.f;
    const int sig = g / nf;
    const long long s = (long long)(g - sig * nf) * hop - W / 2 + t;
    return s >= 0 && s < L ? __ldg(x + (long long)sig * L + s) : 0.f;
  }
  __device__ __forceinline__ float2 operator()(int g, int t) const {
    if (t >= W) return make_float2(0.f, 0.f);
    const float w = __ldg(win + t);
    return cmul(make_float2(sample(g, t) * w, sample(g + 1, t) * w), __ldg(chirp + t));
  }
};

// The forward STFT's last phase after D stored X[t] = chirp[t] conj Z[t]
// (t < N) at scratch[t]: A and B of the pair's frames at bin k from X[k] and
// its partner X[N - k] (so odd N works), handed to out(g, has_b, k, A, B).
template <class Out>
__device__ __forceinline__ void level2_split(const float2* __restrict__ xs, int N, int k, int g,
                                             bool has_b, Out out) {
  const float2 z = xs[k], w = xs[k ? N - k : 0];
  out((long long)g, has_b, k, make_float2(0.5f * (z.x + w.x), 0.5f * (z.y - w.y)),
      make_float2(0.5f * (z.y + w.y), 0.5f * (w.x - z.x)));
}

// conj Z[t], t < N, of frames g and g + 1 of the flattened (signals x nf)
// spectrum rows re, im (inverse_point, the mirrored bin past N/2; frame b
// absent past `frames`)
__device__ __forceinline__ float2 level2_bin_point(const float* __restrict__ re,
                                                   const float* __restrict__ im, int N,
                                                   int frames, int g, int t) {
  const long long bins = N / 2 + 1;
  const float* ra = re + g * bins;
  const float* ia = im + g * bins;
  const bool hb = g + 1 < frames;
  return inverse_point<true>(t, N, [&](int kk, bool edge) {
    return make_float4(__ldg(ra + kk), edge ? 0.f : __ldg(ia + kk),
                       hb ? __ldg(ra + bins + kk) : 0.f, hb && !edge ? __ldg(ia + bins + kk) : 0.f);
  });
}

// The inverse STFT's points of a pair on the second level: conj Z[t] conj
// c_t of frames g and g + 1 (level2_bin_point), 0 from N on.
struct Level2Spectra {
  const float* re;
  const float* im;
  const float2* chirp;
  int N, frames;
  __device__ __forceinline__ float2 operator()(int g, int t) const {
    if (t >= N) return make_float2(0.f, 0.f);
    return cmul(level2_bin_point(re, im, N, frames, g, t), __ldg(chirp + t));
  }
};

// The inverse STFT's overlap-add after every frame's samples are in
// `frames` (row g = n nf + f: sample t < win of frame f of signal n, times
// win / N): out[n, tpos] = inv_norm[s] sum_f frames[n nf + f, s - f hop],
// s = tpos + win / 2, the frames f with 0 <= s - f hop < win in ascending
// order, written by write_sample.
__device__ __forceinline__ void level2_overlap_add(const float* __restrict__ frames,
                                                   const float* __restrict__ inv_norm,
                                                   void* __restrict__ out, int out_int16, int n,
                                                   int nf, int win, int hop, int length,
                                                   int tpos) {
  const long long s = (long long)tpos + win / 2;
  const int f_hi = min(nf - 1, (int)(s / hop));
  const long long lo = (s - win + hop) / hop;  // ceil((s - win + 1) / hop) where positive
  const int f_lo = lo > 0 ? (int)lo : 0;
  float acc = 0.f;
  for (int f = f_lo; f <= f_hi; ++f)
    acc += __ldg(frames + ((long long)n * nf + f) * win + (s - (long long)f * hop));
  write_sample(out, out_int16, (long long)n * length + tpos, acc * __ldg(inv_norm + s));
}

// ---- the second level's direct transform: 7-smooth sizes past 65 536 --------
//
// N = R n with R = 16 (N <= 131 072) or 32 (past it) and n <= 8192 7-smooth,
// any parity (70 000 = 16 x 4375, 131 072 = 16 x 8192, 200 000 = 32 x 6250;
// 138 sizes, fft_plan.level2_direct_factors) needs no chirp: the inverse of
// a pair of frames is one N-point transform of u = conj Z, by decimation in
// frequency over R, with the second level's scratch in device memory (a
// pair's N float2) in place of a cluster's distributed shared memory. With
// t = n2 + n q (n2 < n, q < R), k = k1 + R k2 (k1 < R, k2 < n), w = e^{-2 pi
// i / N}:
//
//   y[k1 + R k2] = sum_{n2} w^{R n2 k2} (w^{n2 k1} sum_q W_R^{q k1} u[n2 + n q])
//
// 1. (level2_direct_combine) for each n2 < n, one thread: the points u[n2 +
//    n q] straight from the pair's spectrum rows (level2_bin_point; a warp's
//    32 consecutive n2 read consecutive bins, coalesced), the radix-R DFT over
//    q in registers (dft<16>, or dft_wide<32> on literal roots), times
//    w^{n2 k1} (the host's (R, n) table w^{n2 k1} at k1 n + n2, read
//    coalesced), to scratch[k1 n + n2];
// 2. (level2_direct_rows) for each k1 < R, one block of 512 threads: the
//    row's n points from the scratch into the exchange buffer, mixed_fft on
//    the n-point table w^{R m} (the N-point table's entries at stride R,
//    stored contiguous by the host), and y[k1 + R k2] at slot(k2);
// 3. (level2_direct_overlap_add) every output sample sums its frames' y[t]
//    in ascending frame order, t = s - f hop, each times win[t] / N.
//
// Decimation in time (the radix-R combine last) would read each point's four
// floats at a stride of R bins in the rows' loads, one float of each 32-byte
// sector: 128 bytes of sectors for 8 of point (W 70 000: 350 MB a call); here
// the loads are coalesced and the strided access moves to the overlap-add,
// which reads a row's samples t = k1 + R k2 through L1: a block of 256
// consecutive samples reads whole sectors of R rows. So the frames buffer
// holds a frame's samples by rows, y[k1 + R k2] at k1 n + k2 (frame a's N
// Re y, frame b's -N Im y, before the window), and the rows write whole
// rows.

constexpr int kLevel2DirectMinR = 16;  // R up to 131 072 points
constexpr int kLevel2DirectMaxR = 32;  // R past it, up to 262 144

// R and n of a size the direct second level takes (fft_plan.
// level2_direct_factors): 65 536 < nfft <= 262 144, R 16 up to 131 072 and
// 32 past it, R | nfft, n = nfft / R 7-smooth.
inline bool level2_direct_sizes(int nfft, int* r, int* n) {
  if (nfft <= (8 << kMaxLog2) || nfft > (32 << kMaxLog2)) return false;
  *r = nfft <= (16 << kMaxLog2) ? kLevel2DirectMinR : kLevel2DirectMaxR;
  *n = nfft / *r;
  return nfft % *r == 0 && smooth7(*n);
}

// u * e^{-2 pi i e / 32}, 0 <= e < 16; e is a constant after unrolling, so
// the switch folds to literals (the even e are rot16's).
__device__ __forceinline__ float2 rot32(float2 u, int e) {
  float c, s;  // e^{-2 pi i e / 32} = c - i s
  switch (e) {
    case 1: c = 0.98078528040323044f; s = 0.19509032201612825f; break;
    case 3: c = 0.83146961230254524f; s = 0.55557023301960222f; break;
    case 5: c = 0.55557023301960222f; s = 0.83146961230254524f; break;
    case 7: c = 0.19509032201612825f; s = 0.98078528040323044f; break;
    case 9: c = -0.19509032201612825f; s = 0.98078528040323044f; break;
    case 11: c = -0.55557023301960222f; s = 0.83146961230254524f; break;
    case 13: c = -0.83146961230254524f; s = 0.55557023301960222f; break;
    case 15: c = -0.98078528040323044f; s = 0.19509032201612825f; break;
    default: return rot16(u, e / 2);
  }
  return make_float2(u.x * c + u.y * s, u.y * c - u.x * s);
}

// Phase 1 for column n2 < n of one pair: point(t) the pair's points, tw2
// the (R, n) table w^{n2 k1} (fft_plan.level2_direct_tables' first N
// entries), scratch the pair's N float2.
template <int R, class Point>
__device__ __forceinline__ void level2_direct_combine(Point point, float2* __restrict__ scratch,
                                                      const float2* __restrict__ tw2, int n,
                                                      int n2) {
  float2 u[R];
#pragma unroll
  for (int q = 0; q < R; ++q) u[q] = point(n2 + n * q);
  if constexpr (R == kLevel2DirectMinR) {
    dft<R>(u);
  } else {
    dft_wide<R>(u, [](float2 v, int e) { return rot32(v, e); });
  }
  scratch[n2] = u[0];
#pragma unroll
  for (int k1 = 1; k1 < R; ++k1)
    scratch[k1 * n + n2] = cmul(u[k1], __ldg(tw2 + k1 * n + n2));
}

// Phase 2 for one row of n points (row = scratch + k1 n) on the whole block
// (n <= 16 blockDim.x): tw the n-point table w^{R m} in global memory,
// smem4 mixed_tables_len(n) float2 (the table and the exchange buffer);
// store(k2, y[k1 + R k2]) for k2 < n.
template <class Store>
__device__ __forceinline__ void level2_direct_rows(float4* smem4, const float2* __restrict__ row,
                                                   const float2* __restrict__ tw, int n,
                                                   unsigned long long sched, Store store) {
  float2* tws = reinterpret_cast<float2*>(smem4);
  float2* buf = tws + n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    tws[i] = __ldg(tw + i);
    buf[slot(i)] = row[i];
  }
  __syncthreads();
  mixed_fft(buf, tws, n, sched);
  for (int k2 = threadIdx.x; k2 < n; k2 += blockDim.x) store(k2, buf[slot(k2)]);
}

// Phase 3: out[sig, tpos] = inv_norm[s] sum_f win_over_n[t] y_f[t], t = s -
// f hop, s = tpos + win / 2, over the frames f with 0 <= t < win in
// ascending order (level2_overlap_add's order); y_f[t] read from frame f's
// row of `frames` (N floats by rows: t = k1 + R k2 at k1 n + k2).
template <int R>
__device__ __forceinline__ void level2_direct_overlap_add(
    const float* __restrict__ frames, const float* __restrict__ win_over_n,
    const float* __restrict__ inv_norm, void* __restrict__ out, int out_int16, int sig, int nf,
    int N, int win, int hop, int length, int tpos) {
  const int n = N / R;
  const long long s = (long long)tpos + win / 2;
  const int f_hi = min(nf - 1, (int)(s / hop));
  const long long lo = (s - win + hop) / hop;
  const int f_lo = lo > 0 ? (int)lo : 0;
  float acc = 0.f;
  for (int f = f_lo; f <= f_hi; ++f) {
    const int t = (int)(s - (long long)f * hop);
    acc += __ldg(win_over_n + t) *
           __ldg(frames + ((long long)sig * nf + f) * N + (t % R) * n + t / R);
  }
  write_sample(out, out_int16, (long long)sig * length + tpos, acc * __ldg(inv_norm + s));
}

#ifdef __CUDACC__
// Launch kern(args...) as `clusters` clusters of C blocks of kMaxThreads
// threads, the blocks of a cluster consecutive in x, each with `smem` bytes
// of dynamic shared memory. A cluster of 16 is past the portable size of 8:
// the kernel must allow it (cudaFuncAttributeNonPortableClusterSizeAllowed).
// With `active`, launches nothing and sets how many such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters: at 512 threads and 128
// registers one block an SM, a cluster's blocks within one GPC).
template <int C, class... Params, class... Args>
cudaError_t launch_clusters(void (*kern)(Params...), long long clusters, size_t smem,
                            cudaStream_t stream, int* active, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr) return cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
#endif

}  // namespace fft_common
