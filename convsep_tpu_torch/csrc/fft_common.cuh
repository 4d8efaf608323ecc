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
// warps. The two-real-frames split is the same for any even N.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
template <int LOG2N, class Bin>
__device__ __forceinline__ void inverse_points(float2 (&v)[kPoints], int j, Bin bin) {
  constexpr int N = 1 << LOG2N;
  constexpr int T = fft_threads(LOG2N);
#pragma unroll
  for (int m = 0; m < kPoints; ++m) {
    const int k = j + T * m;
    const bool mirrored = k > N / 2;
    const int kk = mirrored ? N - k : k;
    const float4 ab = bin(kk, kk == 0 || kk == N / 2);
    // conj Z[k] = (ar - bi) - i (ai + br); conj Z[N - kk] = (ar + bi) + i (ai - br)
    v[m] = mirrored ? make_float2(ab.x + ab.w, ab.y - ab.z)
                    : make_float2(ab.x - ab.w, -(ab.y + ab.z));
  }
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

// In-register forward DFT of M points (M = 3, 5, 9, 15), natural order in
// and out: the radix-3 and radix-5 butterflies; 9 = 3 x 3 and 15 = 3 x 5
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

// Dynamic shared memory of a split block of `ffts` groups: the span of their
// 2 * ffts frames, the P-point quarter table (stage 1), the N-point quarter
// table (the split's twiddles), one N-point exchange buffer per group.
inline size_t split_smem_bytes(int log2p, int m, int win, int hop, int ffts) {
  const int n = m << log2p;
  return (size_t)span_floats(2 * ffts, win, hop) * sizeof(float) +
         ((size_t)twiddle_len(log2p) + (size_t)quarter_len(n) +
          (size_t)ffts * split_exchange_len(n)) * sizeof(float2);
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
  using F = Fft<LOG2P, true>;
  constexpr int P = F::N;
  constexpr int N = M * P;
  constexpr int T1 = F::T;     // threads of one sub-FFT
  constexpr int T = M * T1;    // threads of one transform (N / 16)
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

  // stage 1: sub-FFT n1 of frame a (real) and frame b (imaginary), points
  // t = M n2 + n1, n2 = j + T1 m, windowed
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
  F::run(v, buf + n1 * exchange_len(LOG2P), twp, j, group);

  // stage 2: column k1 = jj + T q, twiddled, one M-point DFT, in place
#pragma unroll
  for (int q = 0; q < (P + T - 1) / T; ++q) {
    const int k1 = jj + T * q;
    if (k1 < P) {
      float2 u[M];
#pragma unroll
      for (int n = 0; n < M; ++n) u[n] = buf[slot(n * P + k1)];
#pragma unroll
      for (int n = 1; n < M; ++n) u[n] = cmul(u[n], quarter_twiddle<N>(twn, n * k1));
      dft_odd<M>(u);
#pragma unroll
      for (int n = 0; n < M; ++n) buf[slot(n * P + k1)] = u[n];
    }
  }
  __syncthreads();

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

}  // namespace fft_common
