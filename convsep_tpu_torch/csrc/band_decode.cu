// Banded time-stage decode of the tied ConvSep decoder, bf16 operands with
// float32 accumulation, on Hopper's tensor cores (wgmma, sm_90a).
//
// Replaces convsep_tpu/models/decoder_pallas.py::band_decode_pallas (_kernel).
// With rows r = (n, w) of the expansion in its own w-major layout, depth
// (h, c) < Tp x C2 and columns (t, i) < T x I:
//
//   out[r, (t, i)] = sum_{h, c} z[r, (h, c)] K[t - h, c, i]   over 0 <= t - h < kh
//
// (f32, z and the taps in bf16; kh = T - Tp + 1): the band of the reference,
// band[(h, c), (t, i)] = K[t - h, c, i] inside the band and 0 outside, is a
// banded Toeplitz expansion of the kh taps of the time kernel, and the
// reference's per-tap sum of z @ band[h] is this product. Both operands are
// bf16 and each bf16 x bf16 product is exact in f32, so the kernel computes
// the reference's function up to the order of the f32 sums.
//
// What bounds it on the H100: bytes. At one multires4096 track (rows 196 x
// 505, Tp 16, C2 50, kh 15, I 50, T 30) the f32 output is 594 MB and z
// (bf16) 158 MB, 0.225 ms at 3.35 TB/s, against 1.19e11 operations of the
// band's nonzero products, 0.12 ms at 989 TFLOP/s.
//
// Design. The band is 2.4 MB but holds only kh x C2 x I distinct values, the
// taps (75 KB in bf16): column block t reads, for depth block h, tap t - h.
// So a block keeps the taps resident in shared memory for its whole life, in
// an order (d = kh - 1 down to 0, each tap's C2 rows padded to C2p, a
// multiple of 8) in which column block t's operand over h = h_lo .. h_hi is
// one contiguous run of rows starting at tap t - h_lo: no band tile is ever
// read from device memory or L2, and column block t's depth is exactly its
// taps (rounded up to the product's depth of 16, the extra rows zero). The
// model packs the taps into that layout once per weight tensor
// (models/decoder_band_cuda.py::band_operand). A persistent block (one per
// SM: 220 KB of shared memory at multires4096) walks row tiles of 64 rows:
// it stores the tile of z into shared memory in the same padded depth order
// (z is read from device memory once; on the main path each thread loads its
// share of the next tile, 16 bytes a load, into registers before this tile's
// products and stores it after them, so the loads overlap the products),
// then two consumer warpgroups take the (t, column chunk) units in turn,
// each a chain of wgmma m64nNk16 with A (z) and B (taps) from shared memory
// in the K-major layout without swizzle (core matrices of 8 rows x 16
// bytes; A: the 8-deep halves 1024 bytes apart, row groups 128; B: halves Ip
// x 16 bytes apart, column groups 128). A warpgroup holds two accumulators:
// while one unit's products run on the tensor cores it stores the previous
// unit's, staged through shared memory (8 rows a warp at a time) and written
// one 200-byte row piece an instruction; the other warpgroup's products run
// meanwhile too. The output's row pieces (I floats of 8448 rows in flight at
// once) are what bounds it now, not the products.
//
// A band whose taps and 64-row z tile do not fit one block's shared memory
// at once (the presets take 225 KB of 227; twice their channels do not
// fit) runs in pieces (decoder_band_cuda.py::band_pieces,
// band_decode_piece_launch): each piece a band decode of z's depths h0 ..
// h1 - 1 (z read with the whole band's row stride) against its own packed
// taps d0 .. d1 - 1, added into output columns h0 + d0 on (the output's
// row stride the whole band's, read and written back), one launch a piece
// on one stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kRows = 64;      // rows of a tile: one wgmma m64
constexpr int kAGroup = kRows * 16;  // bytes of one 8-deep column of A's core matrices
constexpr int kQuads = 25;  // register path: 16-byte chunk quads a lane holds (Tp C2 <= 800)
// floats a staging row takes: at least nw and 24 mod 32, so that the four
// rows that half a warp's fragment stores write start on different banks
__host__ __device__ constexpr int stage_floats(int nw) { return nw + ((24 - nw) % 32 + 32) % 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes from global to shared, zero-filled when !valid
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B), "r"(valid ? B : 0));
  }
}
// 16 bytes from global memory, or zeros when !ok; volatile, so the load is
// issued where it stands (before the products it is meant to overlap)
__device__ __forceinline__ uint4 ld_nc(const void* p, bool ok) {
  uint4 v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\nmov.b32 %0, 0;\nmov.b32 %1, 0;\n"
      "mov.b32 %2, 0;\nmov.b32 %3, 0;\n@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)ok));
  return v;
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// a shared-memory matrix descriptor, K-major without swizzle: start address,
// LBO (the next 8-deep half), SBO (the next 8 rows or columns)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of d across the asynchronous product
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, f32 += bf16 x bf16, A and B from shared memory (K-major),
// scale_d 0 starts from zero. d[4 j + v]: column group j, (row, column) =
// (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1) of the warp's 16 rows.
__device__ __forceinline__ void wg_mma(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[12], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[20], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[28], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, %28, %29, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

struct Args {
  const __nv_bfloat16* z;   // (M, Tp C2), row r at z + r zs
  const __nv_bfloat16* taps;  // the packed operand: (kh C2p + 8) rows x Ip columns, core matrices
  float* out;               // (M, T I), row r at out + r os
  long long M;
  int Tp, C2, C2p, kh, I, Ip, T, chunks, row_tiles;
  int zs, os;               // the rows' strides: Tp C2 and T I, or a whole band's (a piece)
};

// ACC: add into out instead of storing (a piece of a band cut by
// decoder_band_cuda.band_pieces; its z rows by pairs or thread stores)
template <int NW, int VEC, bool ACC>
__global__ void __launch_bounds__(kThreads, 1) band_decode_kernel(Args a) {
  extern __shared__ float4 smem4[];
  constexpr int NA = NW / 2;  // accumulators a thread holds per unit
  const int KA = a.Tp * a.C2p + 8;        // A's padded depth (8 zero rows past the last tap)
  const int KB = a.kh * a.C2p + 8;        // B's rows (8 zero rows past tap 0)
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem4);  // 64 x KA, core matrices
  auto* Bs = As + kRows * KA;                            // KB x Ip, core matrices
  float* Ss = reinterpret_cast<float*>(Bs + KB * a.Ip);  // 8 warps x 8 rows x stage_floats(NW)
  const int tid = threadIdx.x;
  // the warpgroup's index from lane 0, so the compiler knows it is uniform in
  // a warp: branches on it then hold no wgmma in a divergent path, which
  // ptxas would serialize
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid & 31, warp = (tid / 32) & 3;
  const int g = lane >> 2, q = lane & 3;
  const int K = a.Tp * a.C2;
  const int NC = a.os;
  const uint32_t lbo_b = a.Ip * 16;

  // A's padding (c >= C2 and the 8 rows past the last tap) stays zero: the
  // copies below write only c < C2. The taps come packed, zeros included.
  for (int i = tid; i < kRows * KA / 8; i += kThreads)
    reinterpret_cast<uint4*>(As)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < KB * a.Ip / 8; i += kThreads)
    cp_async<16>(Bs + 8 * i, a.taps + 8 * i, true);

  const int units = a.T * a.chunks;
  const int mine = (units - wg + 1) / 2;  // this warpgroup's units: wg, wg + 2, ...

  // the products of unit u = (t, chunk) into d: depth h_lo .. h_hi of z against
  // the taps t - h_lo down to t - h_hi, in steps of 16
  auto issue = [&](float (&d)[NA], int u) {
    const int t = u / a.chunks, ch = u - t * a.chunks;
    const int h_lo = max(0, t - a.kh + 1), h_hi = min(a.Tp - 1, t);
    const int steps = ((h_hi - h_lo + 1) * a.C2p + 15) / 16;
    const char* ab = reinterpret_cast<const char*>(As) + (h_lo * a.C2p / 8) * kAGroup;
    const char* bb = reinterpret_cast<const char*>(Bs) +
                     ((a.kh - 1 - (t - h_lo)) * a.C2p / 8) * lbo_b + ch * (NW / 8) * 128;
    wg_fence();
    for (int s = 0; s < steps; ++s)
      wg_mma(d, desc(ab + s * 2 * kAGroup, kAGroup, 128), desc(bb + s * 2 * lbo_b, lbo_b, 128),
             s);
    wg_commit();
  };
  // unit u's accumulators to out, rows r0 + 16 warp + g (+ 8), columns t I +
  // chunk NW + n: each warp puts 8 of its rows in its staging rows (n at 8 j
  // + 2 q), then writes them one row an instruction, consecutive lanes on
  // consecutive columns, evict-first (st.global.cs). The fragment order (8
  // rows' 32 bytes an instruction) is slower: at one multires4096 track with
  // z's reads, that store pattern alone took 0.75 ms and this one 0.40 on an
  // H100 80GB HBM3 at 700 W (tools/torch_band_study.py).
  constexpr int kSS = stage_floats(NW);
  float* stage = Ss + (tid / 32) * 8 * kSS;
  auto store = [&](const float (&acc)[NA], int u, long long r0) {
    const int t = u / a.chunks, ch = u - t * a.chunks;
    const int n0 = ch * NW, cols = min(NW, a.I - n0);
    // float2 stores stay 8-byte aligned (a piece's out starts at a column)
    const bool pairs = ((a.I | NC) & 1) == 0 &&
                       (!ACC || reinterpret_cast<uintptr_t>(a.out) % 8 == 0);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      __syncwarp();  // the previous rows are read
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
        *reinterpret_cast<float2*>(stage + g * kSS + 8 * j + 2 * q) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      __syncwarp();
      const long long row0 = r0 + 16 * warp + 8 * hr;
      float* o = a.out + row0 * NC + t * a.I + n0;
      if (pairs) {
        for (int rr = 0; rr < 8; ++rr)
          for (int c = 2 * lane; c < cols; c += 64)
            if (row0 + rr < a.M) {
              float2 v = *reinterpret_cast<const float2*>(stage + rr * kSS + c);
              float2* dst = reinterpret_cast<float2*>(o + rr * NC + c);
              if constexpr (ACC) {
                const float2 p = *dst;
                v = make_float2(p.x + v.x, p.y + v.y);
              }
              __stcs(dst, v);
            }
      } else {
        for (int rr = 0; rr < 8; ++rr)
          for (int c = lane; c < cols; c += 32)
            if (row0 + rr < a.M)
              __stcs(o + rr * NC + c, stage[rr * kSS + c] + (ACC ? o[rr * NC + c] : 0.f));
      }
    }
  };

  // the register path (VEC 0): warp w's lanes load rows 8 w + lane / 4 of a
  // tile, 16 bytes each, four consecutive chunks a row an instruction (whole
  // sectors), chunk quad v into zr[v]; a tile's loads are issued before the
  // previous tile's products and stored into A after them, so they overlap
  // the products. Pairs of z elements (C2 even) never straddle two taps.
  uint4 zr[VEC == 0 ? kQuads : 1];
  const int quads = (K / 8 + 3) / 4;
  auto fetch = [&](long long r0) {
#pragma unroll
    for (int v = 0; v < (VEC == 0 ? kQuads : 0); ++v) {
      const int m = 8 * (tid / 32) + (lane >> 2), chunk = 4 * v + (lane & 3);
      const bool ok = v < quads && chunk < K / 8 && r0 + m < a.M;
      zr[v] = ld_nc(ok ? a.z + (r0 + m) * a.zs + 8 * chunk : a.z, ok);
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int v = 0; v < (VEC == 0 ? kQuads : 0); ++v) {
      const int m = 8 * (tid / 32) + (lane >> 2), chunk = 4 * v + (lane & 3);
      if (v >= quads || chunk >= K / 8) continue;
      const uint32_t w[4] = {zr[v].x, zr[v].y, zr[v].z, zr[v].w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int k = 8 * chunk + 2 * p, h = k / a.C2, kp = h * a.C2p + (k - h * a.C2);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(As) + (kp / 8) * kAGroup +
                                     (m / 8) * 128 + (m & 7) * 16 + (kp & 7) * 2) = w[p];
      }
    }
  };

  float d0[NA], d1[NA];
  if constexpr (VEC == 0) fetch((long long)blockIdx.x * kRows);
  for (int rt = blockIdx.x; rt < a.row_tiles; rt += gridDim.x) {
    const long long r0 = (long long)rt * kRows;
    __syncthreads();  // the previous tile's products have read A (each warpgroup waited)
    if constexpr (VEC == 0) {
      put();
    } else {
      // z's tile into A: element (m, h C2 + c) at depth h C2p + c, VEC at a
      // time (2: C2 even, so a pair by cp.async stays inside one tap and one
      // core row; 1: thread stores)
      const int per_row = K / VEC;
      for (int i = tid; i < kRows * per_row; i += kThreads) {
        const int m = i / per_row, kv = (i - m * per_row) * VEC;
        const int h = kv / a.C2, kp = h * a.C2p + (kv - h * a.C2);
        const bool ok = r0 + m < a.M;
        const __nv_bfloat16* src = ok ? a.z + (r0 + m) * a.zs + kv : a.z;
        char* dst = reinterpret_cast<char*>(As) + (kp / 8) * kAGroup + (m / 8) * 128 +
                    (m & 7) * 16 + (kp & 7) * 2;
        if constexpr (VEC == 1) {
          *reinterpret_cast<__nv_bfloat16*>(dst) = ok ? *src : __float2bfloat16(0.f);
        } else {
          cp_async<2 * VEC>(dst, src, ok);
        }
      }
    }
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // A's stores -> wgmma's reads
    __syncthreads();
    if constexpr (VEC == 0) {
      if (rt + (int)gridDim.x < a.row_tiles) fetch(r0 + (long long)gridDim.x * kRows);
    }

    // two accumulators in turn: one unit's products run while the previous
    // unit's are stored
    for (int j = 0; j < mine; j += 2) {
      const int u = wg + 2 * j;
      issue(d0, u);
      if (j > 0) {
        wg_wait<1>();
        wg_pin(d1);
        store(d1, u - 2, r0);
      }
      if (j + 1 < mine) {
        issue(d1, u + 2);
        wg_wait<1>();
        wg_pin(d0);
        store(d0, u, r0);
      } else {
        wg_wait<0>();
        wg_pin(d0);
        store(d0, u, r0);
      }
    }
    if (mine > 0 && mine % 2 == 0) {
      wg_wait<0>();
      wg_pin(d1);
      store(d1, wg + 2 * (mine - 1), r0);
    }
  }
}

template <int NW>
cudaError_t launch_nw(const Args& a, int vec, bool acc, int grid, size_t smem, cudaStream_t s) {
  auto kern = acc ? (vec == 2 ? band_decode_kernel<NW, 2, true> : band_decode_kernel<NW, 1, true>)
              : vec == 0 ? band_decode_kernel<NW, 0, false>
              : vec == 2 ? band_decode_kernel<NW, 2, false> : band_decode_kernel<NW, 1, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const void* z, const void* taps, void* out, long long M, int Tp, int C2, int kh,
                int I, long long zs, long long os, int accumulate, int grid, cudaStream_t s) {
  if (M < 1 || Tp < 1 || C2 < 1 || kh < 1 || I < 1 || grid < 1 || zs < (long long)Tp * C2 ||
      os < (long long)(Tp + kh - 1) * I || zs > INT32_MAX || os > INT32_MAX)
    return cudaErrorInvalidValue;
  Args a{static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(taps),
         static_cast<float*>(out), M, Tp, C2, (C2 + 7) / 8 * 8, kh, I, (I + 7) / 8 * 8,
         Tp + kh - 1, 0, (int)((M + kRows - 1) / kRows), (int)zs, (int)os};
  int nw = 64;  // the widest chunk (a multiple of 8, at most 64) that divides Ip
  while (a.Ip % nw) nw -= 8;
  a.chunks = a.Ip / nw;
  // z's loads: 0 the register path (Tp C2 a multiple of 8 and at most 32
  // kQuads, C2 even; not for a piece), else pairs by cp.async (C2 even, rows
  // 4-byte aligned) or thread stores
  const int K = Tp * C2;
  const uintptr_t zp = reinterpret_cast<uintptr_t>(z);
  const int vec = !accumulate && C2 % 2 == 0 && K % 8 == 0 && K <= 32 * kQuads ? 0
                  : C2 % 2 == 0 && zs % 2 == 0 && zp % 4 == 0 ? 2
                                                              : 1;
  const size_t smem = (size_t)kRows * (Tp * a.C2p + 8) * 2 + (size_t)(kh * a.C2p + 8) * a.Ip * 2 +
                      (size_t)kThreads / 32 * 8 * stage_floats(nw) * 4;
  if (smem > 232448) return cudaErrorInvalidValue;
  switch (nw) {
    case 8: return launch_nw<8>(a, vec, accumulate, grid, smem, s);
    case 16: return launch_nw<16>(a, vec, accumulate, grid, smem, s);
    case 24: return launch_nw<24>(a, vec, accumulate, grid, smem, s);
    case 32: return launch_nw<32>(a, vec, accumulate, grid, smem, s);
    case 40: return launch_nw<40>(a, vec, accumulate, grid, smem, s);
    case 48: return launch_nw<48>(a, vec, accumulate, grid, smem, s);
    case 56: return launch_nw<56>(a, vec, accumulate, grid, smem, s);
    default: return launch_nw<64>(a, vec, accumulate, grid, smem, s);
  }
}

}  // namespace

// z (M, Tp C2) bf16, taps: the packed operand of
// models/decoder_band_cuda.py::pack_taps ((kh C2p + 8) x Ip bf16), out (M, T I)
// f32; grid: persistent blocks (decoder_band_cuda.band_plan).
extern "C" int band_decode_launch(const void* z, const void* taps, void* out, long long M,
                                  int Tp, int C2, int kh, int I, int grid, void* stream) {
  return (int)run(z, taps, out, M, Tp, C2, kh, I, (long long)Tp * C2,
                  (long long)(Tp + kh - 1) * I, 0, grid, static_cast<cudaStream_t>(stream));
}

// One piece of a band whose taps and z tile do not fit shared memory at
// once (decoder_band_cuda.band_pieces): depths h0 .. h0 + Tp - 1 of z (z
// points at depth h0 of row 0, rows zs elements apart) against taps d0 ..
// d0 + kh - 1 (their own packed operand), added to output columns h0 + d0
// .. (out points at column (h0 + d0) I of row 0, rows os floats apart) when
// accumulate is 1.
extern "C" int band_decode_piece_launch(const void* z, const void* taps, void* out, long long M,
                                        int Tp, int C2, int kh, int I, long long zs,
                                        long long os, int accumulate, int grid, void* stream) {
  return (int)run(z, taps, out, M, Tp, C2, kh, I, zs, os, accumulate, grid,
                  static_cast<cudaStream_t>(stream));
}
