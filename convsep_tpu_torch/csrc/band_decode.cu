// Banded time-stage decode of the tied ConvSep decoder, bf16 operands with
// float32 accumulation, on the tensor cores of Hopper (sm_90a).
//
// Replaces convsep_tpu/models/decoder_pallas.py::band_decode_pallas (_kernel).
// With rows r = (n, w) of the expansion in its own w-major layout, depth
// k = (h, c) < Tp C2 and columns j = (t, i) < T I:
//
//   out[r, j] = sum_k z[r, k] band[k, j]       (f32, z and band in bf16)
//
// band[(h, c), (t, i)] = kernel[t - h, 0, i, c] where 0 <= t - h < kh, else 0
// (kh = T - Tp + 1): the reference's per-tap sum over h of z[n, h, w, :] @
// band[h] as one product. The reference demotes both operands to bf16 and
// accumulates in f32; so does this kernel: each bf16 x bf16 product is exact
// in f32, so it computes the reference's function up to the order of the
// f32 sums.
//
// What bounds it on the H100: bytes. At one multires4096 track (rows 196 x
// 505, depth 800, 1500 columns) the output alone is 594 MB of f32 against
// ~1.2e11 operations of the band (half the dense product's: the rest are
// structural zeros), 0.18 ms of writes against 0.12 ms of bf16 tensor-core
// work at the data sheet's rates.
//
// Design, and how it differs from the TPU kernel. The TPU kernel held one
// (Tp, W, C) slab per grid step and summed Tp 2-D matmuls (Mosaic has no
// rank-changing reshapes); its input was transposed to (N, Tp, W, C) for
// that. Here the rows are read in the expansion's w-major layout, with no
// transpose, and each block computes a 128 x 128 output tile with mma.sync
// m16n8k16 (bf16 in, f32 accumulate): 8 warps of 64 x 32, the A and B tiles
// (128 x 32 each) staged through shared memory with the next tile's loads
// in registers while the current one is multiplied. A column tile touches
// only the depth range of its own t values, so the band's structural zeros
// outside [min h, max h] of the tile are skipped (they add exact zeros).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // rows per block
constexpr int kBN = 128;   // columns per block
constexpr int kBK = 32;    // depth per stage
constexpr int kLds = 40;   // shared row stride in bf16 (80 bytes: conflict-free fragments)

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8 bf16 of row `row` (< rows) from depth k (k + 8 <= K, 16-byte aligned), or zeros
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p, long long row,
                                       long long rows, int k, int K) {
  if (row < rows && k < K) return __ldg(reinterpret_cast<const uint4*>(p + row * K + k));
  return make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads) band_decode_kernel(
    const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ bt,
    float* __restrict__ out, long long M, int K, int NC, int Tp, int C2, int I) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN * kLds];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;       // 0..1: rows wm * 64
  const int wn = warp & 3;        // 0..3: columns wn * 32
  const int g = lane >> 2;        // fragment row / column group
  const int q = lane & 3;         // thread in group
  const int j0 = blockIdx.x * kBN;
  const long long r0 = (long long)blockIdx.y * kBM;

  // the depth this column tile needs: columns j0 .. j0 + kBN - 1 hold
  // t = j / I, which reads taps h in [t - kh + 1, t]
  const int T = NC / I;
  const int kh = T - Tp + 1;
  const int t_lo = j0 / I;
  const int t_hi = min(NC - 1, j0 + kBN - 1) / I;
  const int h_lo = max(0, t_lo - kh + 1);
  const int h_hi = min(Tp - 1, t_hi);
  const int k_begin = (h_lo * C2) / kBK * kBK;
  const int k_end = min(K, (h_hi + 1) * C2);

  // each thread stages two 8-wide chunks of A and two of B per stage
  const int lr = tid >> 2;          // 0..63: tile row (and row + 64)
  const int lk = (tid & 3) * 8;     // depth offset in the stage
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ra[u] = load8(z, r0 + lr + 64 * u, M, k0 + lk, K);
      rb[u] = load8(bt, j0 + lr + 64 * u, NC, k0 + lk, K);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      *reinterpret_cast<uint4*>(As + (lr + 64 * u) * kLds + lk) = ra[u];
      *reinterpret_cast<uint4*>(Bs + (lr + 64 * u) * kLds + lk) = rb[u];
    }
    __syncthreads();
    if (k0 + kBK < k_end) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* bp = Bs + (wn * 32 + ni * 8 + g) * kLds + kk + 2 * q;
        bf[ni][0] = lds32(bp);
        bf[ni][1] = lds32(bp + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const __nv_bfloat16* ap = As + (wm * 64 + mi * 16 + g) * kLds + kk + 2 * q;
        const uint32_t a0 = lds32(ap);
        const uint32_t a1 = lds32(ap + 8 * kLds);
        const uint32_t a2 = lds32(ap + 8);
        const uint32_t a3 = lds32(ap + 8 * kLds + 8);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a0, a1, a2, a3, bf[ni][0], bf[ni][1]);
      }
    }
    __syncthreads();
  }

  // accumulator (mi, ni): rows g and g + 8, columns 2q and 2q + 1 of the 16 x 8 tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long row = r0 + wm * 64 + mi * 16 + g + 8 * hr;
      if (row >= M) continue;
      float* orow = out + row * NC;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = j0 + wn * 32 + ni * 8 + 2 * q;
        if (col < NC) orow[col] = acc[mi][ni][2 * hr];
        if (col + 1 < NC) orow[col + 1] = acc[mi][ni][2 * hr + 1];
      }
    }
  }
}

}  // namespace

extern "C" int band_decode_launch(const void* z, const void* bt, void* out, long long M, int K,
                                  int NC, int Tp, int C2, int I, void* stream) {
  if (M < 1 || K < 8 || K % 8 != 0 || NC < 1 || Tp < 1 || C2 < 1 || I < 1 || K != Tp * C2 ||
      NC % I != 0 || NC / I < Tp)
    return (int)cudaErrorInvalidValue;
  const long long row_tiles = (M + kBM - 1) / kBM;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  // column tiles on x: the blocks that share a row tile run together, so its
  // A rows are read from device memory once and from L2 after
  dim3 grid((NC + kBN - 1) / kBN, (unsigned)row_tiles);
  band_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(bt),
      static_cast<float*>(out), M, K, NC, Tp, C2, I);
  return (int)cudaGetLastError();
}
