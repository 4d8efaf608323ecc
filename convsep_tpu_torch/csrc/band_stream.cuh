// Banded time-stage decode past one block's shared memory, streamed: the
// kernel body of band_stream.cu, instantiated there and in band_stream_n*.cu
// (one nvcc each, so that the widths compile in parallel).
//
// Replaces convsep_tpu/models/decoder_pallas.py::band_decode_pallas (_kernel)
// where the band's taps and a 64-row tile of z do not fit one block's shared
// memory at once (csrc/band_decode.cu keeps the shapes where they do):
//
//   out[r, (t, i)] = sum_{h, c} z[r, (h, c)] K[t - h, c, i]   over 0 <= t - h < kh
//
// z and the taps in bf16, the sums in f32 (each bf16 x bf16 product is exact
// in f32), so the kernel computes the reference's function up to the order
// of the f32 sums.
//
// What bounds it on the H100: operations or bytes, about evenly. At N 196,
// W 505, Tp 16, kh 15, C2 128, I 64 the band's 3.9e11 products take 0.39 ms
// at 989 TFLOP/s, z (405 MB bf16) and the output (760 MB f32) 0.35 ms at
// 3.35 TB/s. A 64-row tile of z (262 KB) does not fit shared memory, nor do
// the taps (245 KB), so operands stream from L2, and L2's bandwidth is the
// design's limit: each byte brought in has to feed as many products as it can.
//
// Design. A unit is (a tile of 128 rows of z, a column block t, a chunk of N
// columns, N = Ip up to 256). Over depth k = h C2 + c, column block t reads
// only the taps h_lo .. h_hi (0 <= t - h < kh), so a unit is an ordinary
// GEMM of depth (h_hi - h_lo + 1) C2 over z's own row order: the slabs
// j_lo .. j_hi of 64 depths of z (k from 64 j), against the band's column
// block t on those depths. That block of the band is one run of rows of the
// taps packed once per weight tensor (models/decoder_band_cuda.py::
// pack_stream_taps): row rho = 64 + (kh - 1 - d) C2 + c holds tap d, 64 zero
// rows before and after, so slab j of column block t is rows 64 + (kh - 1 -
// t) C2 + 64 j onward, and depths outside the band meet zeros there. Each
// column keeps its rows contiguous (K-major), in 8 / gcd(C2, 8) copies
// shifted by 0..7 rows, so that every slab starts 16-byte aligned in one of
// them, as TMA's boxes must.
//
// Persistent clusters of two blocks (one an SM) walk items (a pair of row
// tiles, one a block; a chunk; a group of G consecutive column blocks t, G N
// <= 256). In each block a producer warp streams the item's slabs of z (the
// union of its column blocks' depths, 128 x 64 bf16) and, for each column
// block whose depths the slab meets, its 64 x N slab of taps, by TMA (2-D
// tensor maps, 128-byte swizzle, rows and depths past the tensor read as
// zero) into a ring of 4 stages, each counted on an mbarrier by its bytes;
// the two blocks take turns at the slabs of taps and multicast each to both.
// Two consumer warpgroups (rows 0-63 and 64-127) run wgmma m64nNk16 from the
// ring into G accumulators each while the next stages' copies are in flight,
// and release a stage in both blocks (a second mbarrier, counting both
// blocks' consumer warps) once their products have read it. A slab of z
// feeds the G column blocks of the item, a slab of taps four row halves;
// the items of one row tile are consecutive, so the clusters working at once
// share z's tile in L2 and the taps stay in L2 for the whole launch. After
// an item's last slab each warp writes its accumulators once, staged through
// shared memory 8 rows x 64 columns at a time and stored one row piece an
// instruction (evict-first): the output is written exactly once, with no
// fill and no read-back. A deep band (a column block past kFold slabs)
// folds its accumulators into float32 sums every kFold slabs (below).

// z by TMA needs its rows 16-byte aligned (Tp C2 % 8 == 0, amode 16). Else
// the producer warpgroup loads z itself into the same swizzled layout: pairs
// of 4-byte cp.async when Tp C2 is even (amode 4), else element loads through
// registers (amode 1). The first design loaded everything by 16-byte
// cp.async, one block a 128-row tile: it took 2.56 ms at C2 128, I 64, the
// loads alone 2.56 and the products and stores without them 0.65; by TMA
// 1.05; with each slab of taps multicast to a cluster's two blocks 0.81,
// 1.01 without the multicast (tools/torch_band_stream_study.py, H100 80GB
// HBM3, 700 W).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace band_stream {

constexpr int kThreads = 384;     // a producer warpgroup, two consumer warpgroups
constexpr int kTileRows = 128;    // rows of an item: 64 a consumer warpgroup
constexpr int kSlab = 64;         // depths of a stage
constexpr int kStages = 4;        // the ring
constexpr int kCluster = 2;       // blocks of a cluster: two row tiles share each slab of taps
constexpr int kASlab = 64 * kSlab * 2;  // bytes of one warpgroup's slab of z
constexpr int kBarBytes = 2048;   // the mbarriers, and room to align the ring to 1024 bytes
constexpr int kStageCols = 64;    // columns a warp stages at a time
constexpr int kStageFloats = 88;  // 64 + 24: the rows a half warp writes start on different banks
constexpr int kStagingBytes = 8 * 8 * kStageFloats * 4;  // 8 consumer warps x 8 rows

// the column blocks an item takes at once: their accumulators, G N / 2
// floats a thread, stay within 128 registers
__host__ __device__ constexpr int group_of(int n) {
  return n >= 256 ? 1 : (256 / n > 4 ? 4 : 256 / n);
}
// a deep band's units restart their accumulators every kFold slabs and add
// them into float32 sums in shared memory (the tensor cores truncate as they
// accumulate: one chain of 16 000 depths drifted to 1.5e-5 of the peak,
// folded 3.9e-6; tools/torch_band_stream_study.py, H100 80GB HBM3, 700 W);
// an item then takes half the column blocks, whose sums take the room
constexpr int kFold = 64;
__host__ __device__ constexpr int groups_run(int n, bool fold) {
  return fold ? (group_of(n) / 2 > 0 ? group_of(n) / 2 : 1) : group_of(n);
}
__host__ __device__ constexpr int stage_bytes(int n, bool fold) {
  return 2 * kASlab + groups_run(n, fold) * kSlab * n * 2;
}
__host__ __device__ constexpr int sum_bytes(int n, bool fold) {
  return fold ? 256 * groups_run(n, fold) * (n / 2) * 4 : 0;
}
__host__ __device__ constexpr int smem_bytes(int n, bool fold) {
  return kBarBytes + kStages * stage_bytes(n, fold) + kStagingBytes + sum_bytes(n, fold);
}
// a launch's shared memory: a deep band takes N <= 128 (two or more chunks past)
__host__ __device__ constexpr int launch_smem(int n) {
  return n > 128 || smem_bytes(n, false) > smem_bytes(n, true) ? smem_bytes(n, false)
                                                               : smem_bytes(n, true);
}

struct Args {
  const __nv_bfloat16* z;     // (M, S) bf16, S = Tp C2
  float* out;                 // (M, T I) f32
  long long M;
  int Tp, C2, kh, I, T, S;
  int chunks, groups, items;
  int np, copy_div;           // the packed taps' columns a copy (chunks N), gcd(C2, 8)
  int amode;                  // 16 (TMA), 4 or 1: z's loads
  int fold;                   // 1: a deep band (groups_run, kFold, sums in shared memory)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* m, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(m)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* m, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(smem_addr(m)),
      "r"(parity)
      : "memory");
}
// the one arrival of the phase, which also waits for `bytes` more bytes
__device__ __forceinline__ void mbar_expect(uint64_t* m, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(m)),
               "r"(bytes)
               : "memory");
}
// a box of a 2-D tensor map at (inner x, outer y) into dst, counted on m
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* m) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(m))
      : "memory");
}
// the same box into the same offset of both blocks of the cluster, counted
// on the barrier at m's offset in each
__device__ __forceinline__ void tma_multicast(void* dst, const CUtensorMap* map, int x, int y,
                                              uint64_t* m) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(m)),
      "h"((uint16_t)((1 << kCluster) - 1)), "r"(x), "r"(y)
      : "memory");
}
// the address of p in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
// one arrival on the mbarrier at a cluster address (the warp's wgmma have
// read the stage: waited for)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t m) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(m) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* m) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(m)) : "memory");
}
// one arrival once all of this thread's earlier cp.async have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* m) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(m))
               : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a shared-memory matrix descriptor, K-major with the 128-byte swizzle (rows
// of 64 bf16, 16-byte chunk c of row r at c ^ (r % 8), 8 rows 1024 bytes
// apart, the tile 1024-byte aligned); depth 16 s of the tile starts 32 s
// bytes on
__device__ __forceinline__ uint64_t desc(const void* p) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}
// keeps the compiler from moving reads or writes of d across the asynchronous product
template <int K>
__device__ __forceinline__ void wg_pin(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the depth slabs (64 depths of z from 64 j) that column block t reads
__device__ __forceinline__ int slab_lo(const Args& a, int t) {
  return (max(0, t - a.kh + 1) * a.C2) / kSlab;
}
__device__ __forceinline__ int slab_hi(const Args& a, int t) {
  return ((min(a.Tp - 1, t) + 1) * a.C2 - 1) / kSlab;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    band_stream_kernel(const __grid_constant__ CUtensorMap z_map,
                       const __grid_constant__ CUtensorMap taps_map, Args a) {
  constexpr int G = group_of(N);
  constexpr int NA = N / 2;            // accumulators a thread holds per column block
  constexpr int kBSlab = kSlab * N * 2;
  const bool fold = a.fold != 0;
  const int gr = groups_run(N, fold);  // the column blocks of an item
  const int kStage = stage_bytes(N, fold);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  // the swizzled tiles start 1024-byte aligned
  unsigned char* ring = smem + ((smem_addr(smem) + 2 * kStages * 8 + 1023) / 1024 * 1024 -
                                smem_addr(smem));
  float* staging = reinterpret_cast<float*>(ring + kStages * kStage);
  float* sums = staging + 8 * 8 * kStageFloats;  // a deep band's: [g][i][consumer thread]
  const int tid = threadIdx.x;
  // the warpgroup's index from lane 0, so the compiler knows it is uniform in
  // a warp: branches on it then hold no wgmma in a divergent path, which
  // ptxas would serialize
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int lane = tid & 31;
  const int rank = blockIdx.x % kCluster;  // the block's row tile of its cluster's pair
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producer's first thread once (by the bytes of this block's TMA
      // and its peer's multicasts), and where z comes through the producer
      // warpgroup's threads, each of them once more
      mbar_init(&full[s], a.amode == 16 ? 1 : 129);
      mbar_init(&empty[s], 8 * kCluster);  // each consumer warp of the cluster once
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cooperative_groups::this_cluster().sync();  // the peer's barriers exist

  const int per_pair = a.chunks * a.groups;
  const int cluster = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;

  if (wg == 0) {
    // ---- producer: the item's slabs of z and of the taps into the ring (by
    // TMA, from its first thread; where z's rows are not 16-byte aligned,
    // z's slabs from all its threads)
    const int p = tid;  // 0 .. 127
    int stage = 0;
    uint32_t phase = 0;
    // by TMA only warp 0 walks the items (its lanes together: a warp split
    // between this loop and the cluster barrier below runs slowly)
    for (int it = cluster; it < a.items && (a.amode != 16 || p < 32); it += clusters) {
      const int rt = kCluster * (it / per_pair) + rank, rem = it % per_pair;
      const int ch = rem / a.groups, t0 = (rem - ch * a.groups) * gr;
      const int t1 = min(a.T, t0 + gr) - 1;
      const long long r0 = (long long)rt * kTileRows;
      const int jb = slab_lo(a, t0), je = slab_hi(a, t1);
      for (int j = jb; j <= je; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);  // both blocks have read the stage
        unsigned char* st = ring + stage * kStage;
        if (p == 0) {
          // the slab of z (amode 16; none for a tile past M) into this block,
          // and the taps' slabs into both blocks of the cluster, the k-th of
          // the item's column blocks that meet slab j from block k % 2
          const bool z_tma = a.amode == 16 && r0 < a.M;
          int bytes = z_tma ? 2 * kASlab : 0;
          for (int g = 0; g < G; ++g) {
            const int t = t0 + g;
            if (t <= t1 && j >= slab_lo(a, t) && j <= slab_hi(a, t)) bytes += kBSlab;
          }
          mbar_expect(&full[stage], bytes);
          if (z_tma) tma_load(st, &z_map, j * kSlab, (int)r0, &full[stage]);
          for (int g = 0, k = 0; g < G; ++g) {
            const int t = t0 + g;
            if (t > t1 || j < slab_lo(a, t) || j > slab_hi(a, t)) continue;
            const int rho = kSlab + (a.kh - 1 - t) * a.C2 + kSlab * j, res = rho & 7;
            if (k++ % kCluster == rank)
              tma_multicast(st + 2 * kASlab + g * kBSlab, &taps_map, rho + ((8 - res) & 7),
                            (res / a.copy_div) * a.np + ch * N, &full[stage]);
          }
        }
        if (a.amode != 16) {
          // z's rows not 16-byte aligned: 128 rows x 64 depths as 1024 chunks
          // of 16 bytes into the swizzled layout (chunk c of row m at c ^ (m %
          // 8)); eight consecutive threads take one chunk of 8 rows
          const int k0 = j * kSlab;
#pragma unroll 1
          for (int idx = p; idx < 1024; idx += 128) {
            const int kg = (idx >> 3) & 7, m = (idx & 7) + 8 * (idx >> 6);
            const long long r = r0 + m;
            const int k = k0 + 8 * kg;
            unsigned char* dst = st + m * 128 + ((kg ^ (m & 7)) << 4);
            const bool rok = r < a.M;
            const __nv_bfloat16* src = a.z + (rok ? r : 0) * a.S + k;
            if (a.amode == 4) {
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const bool ok = rok && k + 2 * q < a.S;
                cp_async4(dst + 4 * q, ok ? src + 2 * q : a.z, ok);
              }
            } else {
              uint16_t v[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const bool ok = rok && k + q < a.S;
                v[q] = ok ? reinterpret_cast<const uint16_t*>(src)[q] : uint16_t(0);
              }
              *reinterpret_cast<uint4*>(dst) =
                  make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                             v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16));
            }
          }
          if (a.amode == 1) {  // through registers: publish the stores as a release
            fence_async_shared();
            mbar_arrive(&full[stage]);
          } else {
            mbar_arrive_cp_async(&full[stage]);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 rows 0-63 of an item, warpgroup 2 rows 64-127
    const int cw = wg - 1;
    const int wq = (tid / 32) & 3;  // warp in the warpgroup: rows 16 wq ..
    float* stage_rows = staging + ((tid - 128) / 32) * 8 * kStageFloats;
    const int ct = tid - 128;  // the thread's slot in a deep band's sums
    float acc[G][NA];
    int stage = 0, held = -1;
    uint32_t phase = 0;
    const long long NC = (long long)a.T * a.I;
    const bool pairs = (a.I & 1) == 0;
    // a stage is released in both blocks of the cluster: each one's producer
    // multicasts into the other
    auto release = [&](int s) {
      if (lane == 0)
#pragma unroll
        for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(cluster_addr(&empty[s], c));
    };
    for (int it = cluster; it < a.items; it += clusters) {
      const int rt = kCluster * (it / per_pair) + rank, rem = it % per_pair;
      const int ch = rem / a.groups, t0 = (rem - ch * a.groups) * gr;
      const int t1 = min(a.T, t0 + gr) - 1;
      const int jb = slab_lo(a, t0), je = slab_hi(a, t1);
      if (fold)
        for (int i = 0; i < gr * NA; ++i) sums[i * 256 + ct] = 0.f;
      for (int j = jb; j <= je; ++j) {
        mbar_wait(&full[stage], phase);
        if (a.amode != 16) fence_async_shared();  // the producer's copies -> wgmma's reads
        const unsigned char* st = ring + stage * kStage;
        const unsigned char* as = st + cw * kASlab;
        wg_fence();
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int t = t0 + g;
          const int lo = slab_lo(a, t);
          if (t <= t1 && j >= lo && j <= slab_hi(a, t)) {
            const unsigned char* bs = st + 2 * kASlab + g * kBSlab;
            const bool first = j == lo || (fold && (j - lo) % kFold == 0);
#pragma unroll
            for (int kk = 0; kk < kSlab / 16; ++kk)
              Wgmma<N>::mma(acc[g], desc(as + 32 * kk), desc(bs + 32 * kk),
                            (!first || kk > 0) ? 1 : 0);
          }
        }
        wg_commit();
        wg_wait<1>();  // the previous stage's products have read it
        if (held >= 0) release(held);
        held = stage;
        if (fold) {  // a unit at the end of kFold slabs adds its products into its sums
          bool any = false;
          for (int g = 0; g < gr; ++g) {
            const int t = t0 + g, lo = slab_lo(a, t);
            any = any || (t <= t1 && j >= lo && j < slab_hi(a, t) && (j - lo + 1) % kFold == 0);
          }
          if (any) {
            wg_wait<0>();
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int t = t0 + g, lo = slab_lo(a, t);
              if (g < gr && t <= t1 && j >= lo && j < slab_hi(a, t) &&
                  (j - lo + 1) % kFold == 0) {
                wg_pin(acc[g]);
#pragma unroll
                for (int i = 0; i < NA; ++i) sums[(g * NA + i) * 256 + ct] += acc[g][i];
              }
            }
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      release(held);
      held = -1;

      // each column block's 64 x N accumulators to out once: rows r0 + 16 wq +
      // g (+ 8), columns t I + ch N + n. A warp puts 8 of its rows' 64 columns
      // in its staging rows, then writes them one row piece an instruction,
      // consecutive lanes on consecutive columns, evict-first.
      const long long rw = (long long)rt * kTileRows + cw * 64 + 16 * wq;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        wg_pin(acc[g]);
        const int t = t0 + g;
#pragma unroll
        for (int pc = 0; pc < (N + kStageCols - 1) / kStageCols; ++pc) {
          const int n0 = ch * N + pc * kStageCols;
          const int cols = min(min(kStageCols, N - pc * kStageCols), a.I - n0);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            __syncwarp();  // the previous rows are read
#pragma unroll
            for (int jj = 0; jj < kStageCols / 8; ++jj) {
              const int jg = pc * (kStageCols / 8) + jj;
              if (jg < N / 8) {
                const int i = 4 * jg + 2 * hr;
                const bool s2 = fold && g < gr;
                *reinterpret_cast<float2*>(stage_rows + (lane >> 2) * kStageFloats + 8 * jj +
                                           2 * (lane & 3)) =
                    make_float2(acc[g][i] + (s2 ? sums[(g * NA + i) * 256 + ct] : 0.f),
                                acc[g][i + 1] + (s2 ? sums[(g * NA + i + 1) * 256 + ct] : 0.f));
              }
            }
            __syncwarp();
            if (t > t1 || cols <= 0) continue;
            const long long row0 = rw + 8 * hr;
            float* o = a.out + row0 * NC + (long long)t * a.I + n0;
            if (pairs) {
              for (int rr = 0; rr < 8; ++rr)
                if (row0 + rr < a.M && 2 * lane < cols)
                  __stcs(reinterpret_cast<float2*>(o + rr * NC + 2 * lane),
                         *reinterpret_cast<const float2*>(stage_rows + rr * kStageFloats +
                                                          2 * lane));
            } else {
              for (int rr = 0; rr < 8; ++rr)
                if (row0 + rr < a.M)
                  for (int c = lane; c < cols; c += 32)
                    __stcs(o + rr * NC + c, stage_rows[rr * kStageFloats + c]);
            }
          }
        }
      }
    }
  }
  // no block leaves while its peer may still arrive on its barriers
  cooperative_groups::this_cluster().sync();
}

struct Maps {
  CUtensorMap z, taps;
};

// grid: blocks, a multiple of kCluster, launched as clusters of kCluster,
// at most as many as the card holds at once (a second wave would double the
// time: a GPC with an odd count of free SMs leaves one idle); active, when
// not null, takes that count and nothing is launched
template <int N>
cudaError_t launch(const Maps& m, const Args& a, int grid, cudaStream_t s, int* active) {
  constexpr int smem = launch_smem(N);
  auto kern = band_stream_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int at_once = 0;
  if (at_once == 0) {
    err = cudaOccupancyMaxActiveClusters(&at_once, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (at_once < 1) return cudaErrorInvalidConfiguration;
  }
  if (active != nullptr) {
    *active = at_once;
    return cudaSuccess;
  }
  cfg.gridDim = dim3(grid < kCluster * at_once ? grid : kCluster * at_once);
  err = cudaLaunchKernelEx(&cfg, kern, m.z, m.taps, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instances, by width: band_stream.cu N 8-64, band_stream_n128.cu 72-128,
// band_stream_n192.cu 136-192, band_stream_n256.cu 200-256
cudaError_t launch_n64(int n, const Maps& m, const Args& a, int grid, cudaStream_t s, int* act);
cudaError_t launch_n128(int n, const Maps& m, const Args& a, int grid, cudaStream_t s, int* act);
cudaError_t launch_n192(int n, const Maps& m, const Args& a, int grid, cudaStream_t s, int* act);
cudaError_t launch_n256(int n, const Maps& m, const Args& a, int grid, cudaStream_t s, int* act);

}  // namespace band_stream

// Instances of band_stream_kernel for the widths n0 + 8, ..., n0 + 64, and
// the dispatcher that launches one of them by n.
#define BAND_STREAM_INSTANCES(NAME, n0)                                                  \
  namespace band_stream {                                                                \
  cudaError_t NAME(int n, const Maps& m, const Args& a, int grid, cudaStream_t s,       \
                   int* act) {                                                          \
    switch (n - (n0)) {                                                                  \
      case 8: return launch<(n0) + 8>(m, a, grid, s, act);                                       \
      case 16: return launch<(n0) + 16>(m, a, grid, s, act);                                     \
      case 24: return launch<(n0) + 24>(m, a, grid, s, act);                                     \
      case 32: return launch<(n0) + 32>(m, a, grid, s, act);                                     \
      case 40: return launch<(n0) + 40>(m, a, grid, s, act);                                     \
      case 48: return launch<(n0) + 48>(m, a, grid, s, act);                                     \
      case 56: return launch<(n0) + 56>(m, a, grid, s, act);                                     \
      case 64: return launch<(n0) + 64>(m, a, grid, s, act);                                     \
      default: return cudaErrorInvalidValue;                                             \
    }                                                                                    \
  }                                                                                      \
  }
