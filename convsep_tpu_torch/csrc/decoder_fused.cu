// Fused ConvSep decode: expansion GEMM -> ReLU -> composed band GEMM -> tap
// fold, on the tensor cores of Hopper (sm_90a), with float32 parity.
//
// Replaces convsep_tpu/models/decoder_fused_pallas.py::band_freq_decode_pallas
// (_kernel). For each fc row b, source s and expansion row w:
//
//   e[b, s, w, :] = relu(fc[b, :] @ K4[:, s, w, :] + bias[s, w, :])   (TpC)
//   out[b, s, w + i, :] += e[b, s, w, :] @ Kcat[:, i, :]               (TM)
//
// for taps i < ktaps (Kcat is tap-reversed: column block i holds conv tap
// ktaps - 1 - i), output in float32 or bfloat16 (mask_dtype).
//
// What bounds it on the H100: tensor-core operations. About 175 GFLOP per
// 30 s highres4096 track (B 49, TM 120), 88 % of it in the e @ Kcat product;
// K4 (839 MB) and the output are 0.26 ms of device-memory bytes. Run as
// 3xTF32 (below) the products are three times that many TF32 operations:
// 1.06 ms at the data sheet's 495 TFLOP/s (TM 120), 2.93 ms at TM 360.
// PERF.md, row 2, has its times beside the plain decode's.
//
// Float32 parity, 3xTF32: every float32 operand x is split into a TF32 "big"
// part hi (round to nearest, ties away, 10 mantissa bits: an integer add and
// mask, as cvt.rna.tf32.f32 rounds) and the remainder lo = x - hi, exact in
// float32, whose TF32 bits the tensor core reads (lo's low 13 bits are
// dropped: 2^-21 of x). A product is hi*hi' + hi*lo' + lo*hi' (lo*lo' is
// below float32's last bit). One TF32 product alone errs by ~1e-3 relative,
// which no float32 gate of this decode (1e-5 of the peak) admits. Both
// products are split. The tensor core adds a product into its accumulator
// with the alignment bits truncated, so a long chain of products into one
// accumulator drifts (2400 k-steps read 4e-5 of the peak on the H100): the
// three products of each (tap, tile) go into a fresh accumulator, which a
// float32 add folds into the tile; stage 1's chains are J / 8 deep.
//
// Design. The expansion e (about 1.3 GB per highres4096 batch) never reaches
// device memory. The output rows of a block are the pairs (wo, b) of WB
// expansion rows and all the fc rows of a row tile (B <= 64 is one tile;
// larger B tiles by 64), flattened wo-major with the fc rows padded to BP, a
// multiple of 4 (52 at B 49): W MI m16 tiles, MI per warp. A row's tap-i
// operand is the e row i expansion rows above it, which in the flattened
// layout is i * BP rows above: one shifted view of e for all rows. A block
// takes 8 NI output columns: 16 warps of MI x NI = 3 x 4 tiles (TM <= 256;
// 48 accumulators a thread) or 12 warps of 4 x 6 (96; 12 warps leave 168
// registers a thread), 768 output rows either way (WB 14 at B 49). The C =
// TM / (8 NI) <= 8 blocks that hold the column tiles of one (row tile,
// source, w block) form a thread-block cluster and share stage 1: block
// `rank` computes RC of the R = WB + ktaps - 1 expansion rows the w block
// needs (the halo is the ktaps - 1 rows above it: R / WB = 21 / 14 = 1.5 at
// ktaps 8) and the copy engine sends them into the shared memory of the
// other blocks (cp.async.bulk to distributed shared memory, counted on an
// mbarrier per e buffer). So K4 is read from device memory once per
// cluster, and stage 1 is computed R / WB times in all. The block walks t
// in chunks of 8 (one TF32 k-step); in iteration c:
//   * the K4 rows of chunk c + 2 are in flight by cp.async;
//   * the Kcat tile of c + 1, as copied, is split into hi and lo in wgmma's
//     layout;
//   * stage 1 of c + 1: a warp takes jobs of 16 fc rows x one or two e rows
//     (mma.sync m16n8k8), fc and the K4 rows from shared memory, then bias
//     and ReLU into this block's e buffer; then a block barrier, the copy
//     of the Kcat tile of c + 2 (by cp.async, into the tile just split) and
//     the copies of this block's rows to the cluster;
//   * stage 2 of c: each warpgroup accumulates its MI m64 x 8 NI tiles over
//     all taps with wgmma (A, the shifted view of e, from registers, split
//     there; B, the split Kcat tile, from shared memory), once the other
//     blocks' rows of c have arrived;
//   * a block barrier; then each block tells the others, by a remote
//     mbarrier arrival, that its e buffer of c is read: a block sends rows
//     into a buffer only once every reader is done with it (e, the K4 rows
//     and the split Kcat tiles are double-buffered). No cluster barrier is
//     in the loop, so a block may run up to a chunk ahead of the others.
// Every shape the reference's rule admits (ktaps <= 17, TM 90-384) has a
// plan: where the double-buffered 64-row tile does not keep stage 1's halo
// at or under 2 in shared memory (ktaps 16-17, or J past 128), the split
// Kcat tiles take one buffer (the tile of c + 1 split after stage 2 of c,
// behind a block barrier), then the K4 rows too (the rows of c + 2 copied
// once stage 1 of c + 1 has read them), and the row tile 32, 16 or 8 fc
// rows (make_plan). The launcher takes J a multiple of the mma depth 8: the
// wrapper pads fc with zero columns and K4 with zero rows (exact).
// decoder_fused_cuda.py::decode_plan mirrors the plan (fused_decode_plan).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kBT = 64;                   // fc rows per row tile, at most
constexpr int kTC = 8;                    // t per chunk: one k-step
constexpr int kMaxCluster = 8;  // blocks of a cluster (the portable limit)
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the split A fragment of a 16 x 8 tile stored [k][row] with row stride ld:
// a0 (row g, k q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float* p,
                                       int ld, int g, int q) {
  const float x[4] = {p[q * ld + g], p[q * ld + g + 8], p[(q + 4) * ld + g],
                      p[(q + 4) * ld + g + 8]};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    float h, l;
    split(x[v], h, l);
    ah[v] = __float_as_uint(h);
    al[v] = __float_as_uint(l);
  }
}

// the split B fragment of an 8 x 8 tile stored [k][col] with row stride ld:
// b0 (k q, col g), b1 (q + 4, g)
__device__ __forceinline__ void load_b(uint32_t (&bh)[2], uint32_t (&bl)[2], const float* p,
                                       int ld, int g, int q) {
  float h, l;
  split(p[q * ld + g], h, l);
  bh[0] = __float_as_uint(h);
  bl[0] = __float_as_uint(l);
  split(p[(q + 4) * ld + g], h, l);
  bh[1] = __float_as_uint(h);
  bl[1] = __float_as_uint(l);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wgmma (sm_90a): a warpgroup's m64 x (8 NI) x k8 TF32 product, A from
// registers (each warp its 16 rows, laid out as mma.m16n8k8's A), B from a
// shared-memory tile in the K-major layout without swizzle: core matrices of
// 8 columns x 4 k (16 bytes a column), the two k halves 128 bytes apart
// (LBO), column groups of 8 256 bytes apart (SBO). scale_d 0 starts the
// accumulators from zero. D is laid out as NI mma.m16n8k8 C fragments.
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(tile));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of d across the asynchronous product
template <int NI>
__device__ __forceinline__ void wg_pin(float (&d)[NI][4]) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(d[ni][v])::"memory");
}
__device__ __forceinline__ void wg_mma(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wg_mma(float (&d)[6][4], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// distributed shared memory: the address of p in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const float* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
// bytes (a multiple of 16) from this block's shared memory at src to the
// address dst of another block of the cluster, by the copy engine; the bytes
// count down the transaction count of the mbarrier at mbar (in dst's block)
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const float* src, int bytes,
                                             uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(src))), "r"(bytes), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* m, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(m)), "r"(count)
               : "memory");
}
// one arrival on the mbarrier at `remote` (a cluster address), ordered after
// this thread's (and, through a block barrier before it, the block's) reads
__device__ __forceinline__ void mbar_arrive_remote(uint32_t remote) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* m, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, [%0], %1;\n"
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
__device__ __forceinline__ void mbar_wait(uint64_t* m, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT;\n}\n" ::"r"(smem_addr(m)),
      "r"(parity)
      : "memory");
}

struct Args {
  const float* fc;
  const float* k4;
  const float* bias;
  const float* kcat;
  void* out;
  int out_bf16, B, J, S, W_pad, TpC, ktaps, TM;
  int b_tiles, BP, FS, WB, RC, ES, vec_k4, vec_kc;
  int BT;  // fc rows a row tile holds (64 where KC is 2)
};

// KC, K4: buffers of the split Kcat tiles and of the K4 rows (2, or 1 where
// shared memory holds one: make_plan)
template <int MI, int NI, int kWarps, int KC, int K4>
__global__ void __launch_bounds__(kWarps * 32, 1) fused_decode_kernel(const Args a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kKS = 8 * NI + 8;  // floats of a (tap, t) row of the Kcat tile as copied, padded
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int J = a.J, ktaps = a.ktaps, TpC = a.TpC, TM = a.TM, BP = a.BP, ES = a.ES;
  const int BT = KC == 2 ? kBT : a.BT;  // the double-buffered plans take whole 64-row tiles
  const int R = a.WB + ktaps - 1;  // expansion rows of the w block: its rows + the halo
  const int rows = a.WB * BP;      // output rows (wo, b), flattened wo-major (<= 16 * 16 MI)
  const int MB1 = (BP + 15) / 16;  // stage 1's m16 tiles of fc rows

  constexpr int kCan = 64 * NI;                   // floats of a split Kcat k8 tile (one tap)
  extern __shared__ float4 smem4[];
  // kcan: [kc_bufs][hi, lo][ktaps][kCan], wgmma layout
  float* kcan = reinterpret_cast<float*>(smem4);
  float* fcs = kcan + 2 * KC * ktaps * kCan;  // [J][FS]
  float* k4s = fcs + J * a.FS;                // [K4][RC][J][kTC]
  float* es = k4s + K4 * a.RC * J * kTC;      // [2][kTC][ES]
  // e is followed by 16 W MI floats of room: tiles past the block's rows
  // (their products are dropped) read there
  float* kcs = es + 2 * kTC * ES + 16 * kWarps * MI;  // [ktaps][kTC][kKS], as copied
  // mbarriers: [0, 2) the other blocks' e rows of buffer b are in; [2, 4)
  // the other blocks are done reading their e buffer b
  uint64_t* mbar = reinterpret_cast<uint64_t*>(kcs + ktaps * kTC * kKS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int bt = blockIdx.z % a.b_tiles;
  const int s = blockIdx.z / a.b_tiles;
  const int b0 = bt * BT;
  const int Bt = min(BT, a.B - b0);  // real fc rows of the tile
  const int w0 = blockIdx.y * a.WB;
  const int wlo = w0 - (ktaps - 1);   // expansion row of e row 0
  const int m0 = rank * 8 * NI;
  const long long kstride = (long long)a.S * a.W_pad * TpC;  // K4 row j stride
  const int chunks = (TpC + kTC - 1) / kTC;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mi][ni][v] = 0.f;

  // The buffer of chunk c's K4 rows and of its split Kcat tile: c & 1 when
  // double-buffered, else the one. (Written out where used: as two helper
  // lambdas ptxas gave the presets' instance 24 bytes of stack.)

  // chunk c's K4 rows (this block's share of stage 1) into its buffer.
  // Each thread copies the same (j, half) of every kq-th row: kp is its
  // 16-byte piece of a row (2 J of them), kq0 its first row.
  const int klanes = a.vec_k4 ? 2 * J : kTC * J;
  const int kq = max(1, kThreads / klanes);
  const int kp0 = tid % klanes, kq0 = tid < kq * klanes ? tid / klanes : a.RC;
  auto fetch_k4 = [&](int c) {
    const int t0 = c * kTC;
    float* kd = k4s + (K4 == 2 ? (c & 1) : 0) * a.RC * J * kTC;  // [k][j][t]
    for (int k = kq0; k < a.RC; k += kq) {
      const int r = rank * a.RC + k, w = wlo + r;
      const bool row = r < R && w >= 0 && w < a.W_pad;
      const float* src = a.k4 + ((long long)s * a.W_pad + w) * TpC + t0;
      float* dst = kd + k * J * kTC;
      for (int p = kp0; p < klanes; p += kThreads) {
        if (a.vec_k4) {  // p = 2 j + half
          const int j = p >> 1, t = 4 * (p & 1);
          const bool ok = row && t0 + t < TpC;
          cp_async16(dst + 4 * p, ok ? src + j * kstride + t : a.k4, ok);
        } else {  // p = 8 j + t
          const int j = p >> 3, t = p & 7;
          const bool ok = row && t0 + t < TpC;
          cp_async4(dst + p, ok ? src + j * kstride + t : a.k4, ok);
        }
      }
    }
  };
  // chunk c's Kcat tile (this block's columns), as copied
  auto fetch_kcat = [&](int c) {
    const int t0 = c * kTC;
    float* cd = kcs;  // [i][t][n]
    const long long krow = (long long)ktaps * TM;
    if (a.vec_kc) {
      for (int p = tid; p < ktaps * kTC * 2 * NI; p += kThreads) {
        const int it = p / (2 * NI), n4 = p - it * (2 * NI);  // it = i * kTC + tt
        const int i = it / kTC, t = t0 + it - i * kTC, m = m0 + 4 * n4;
        const bool ok = t < TpC && m < TM;
        cp_async16(cd + it * kKS + 4 * n4, ok ? a.kcat + t * krow + i * TM + m : a.kcat, ok);
      }
    } else {
      for (int p = tid; p < ktaps * kTC * 8 * NI; p += kThreads) {
        const int it = p / (8 * NI), n = p - it * (8 * NI);
        const int i = it / kTC, t = t0 + it - i * kTC, m = m0 + n;
        const bool ok = t < TpC && m < TM;
        cp_async4(cd + it * kKS + n, ok ? a.kcat + t * krow + i * TM + m : a.kcat, ok);
      }
    }
  };

  // stage 1 of chunk c: this block's e rows r = RC rank + k (k < own_rows)
  // from chunk c's K4 buffer into e buffer c & 1. A job is 16 fc rows of one e
  // row, or of two where that still leaves a job for every warp: then each fc
  // fragment is read and split once for both (shared-memory bandwidth bounds
  // stage 1). The three products run in three chains of J / 8 (16 at J 128)
  // mma each: short enough not to drift, and independent.
  const int own_rows = max(0, min(a.RC, R - rank * a.RC));
  auto stage1_jobs = [&](int c, auto rows_per_job) {
    constexpr int RJ = decltype(rows_per_job)::value;
    const int t0 = c * kTC;
    const float* kt = k4s + (K4 == 2 ? (c & 1) : 0) * a.RC * J * kTC;
    float* ed = es + (c & 1) * kTC * ES;
    for (int job = kWarps - 1 - warp; job < (own_rows + RJ - 1) / RJ * MB1; job += kWarps) {
      const int k0 = RJ * (job / MB1), mb = job - (job / MB1) * MB1;
      float ce[RJ][4], cl[RJ][4], cr[RJ][4];
      const float* kk[RJ];
#pragma unroll
      for (int u = 0; u < RJ; ++u) {
        kk[u] = kt + min(k0 + u, own_rows - 1) * J * kTC;
#pragma unroll
        for (int v = 0; v < 4; ++v) ce[u][v] = cl[u][v] = cr[u][v] = 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < J; j += 8) {
        uint32_t ah[4], al[4];
        load_a(ah, al, fcs + j * a.FS + 16 * mb, a.FS, g, q);
#pragma unroll
        for (int u = 0; u < RJ; ++u) {
          uint32_t bh[2], bl[2];
          load_b(bh, bl, kk[u] + j * kTC, kTC, g, q);
          mma(cl[u], al, bh[0], bh[1]);
          mma(cr[u], ah, bl[0], bl[1]);
          mma(ce[u], ah, bh[0], bh[1]);
        }
      }
#pragma unroll
      for (int u = 0; u < RJ; ++u) {
        if (k0 + u >= own_rows) break;
        const int r = rank * a.RC + k0 + u, w = wlo + r;
        const bool live = w >= 0 && w < a.W_pad;
        // c0 (b g, t 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
        const float* bp = a.bias + ((long long)s * a.W_pad + w) * TpC + t0 + 2 * q;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int tt = 2 * q + (v & 1), b = 16 * mb + g + 8 * (v >> 1);
          const float x = ce[u][v] + cl[u][v] + cr[u][v];
          if (b < BP)
            ed[tt * ES + r * BP + b] =
                live && t0 + tt < TpC ? fmaxf(x + __ldg(bp + (v & 1)), 0.f) : 0.f;
        }
      }
    }
  };
  auto stage1 = [&](int c) {
    if (own_rows * MB1 > kWarps)
      stage1_jobs(c, std::integral_constant<int, 2>());
    else
      stage1_jobs(c, std::integral_constant<int, 1>());
  };

  // this block's e rows of chunk c (one line of own_rows x BP floats a t)
  // into e buffer c & 1 of the other blocks of the cluster, by the copy
  // engine: a thread a (peer, t) line; each block's mbarrier c & 1 counts
  // the bytes in. The copies run while stage 2 of chunk c - 1 runs.
  auto send = [&](int c) {
    float* ed = es + (c & 1) * kTC * ES;
    if (tid == 0) mbar_expect(mbar + (c & 1), (R - own_rows) * kTC * BP * 4);
    if (own_rows == 0 || tid >= (C - 1) * kTC) return;
    // into buffers the other blocks read for chunk c - 2
    if (c >= 2) mbar_wait_cluster(mbar + 2 + (c & 1), ((c >> 1) - 1) & 1);
    const int t = tid & (kTC - 1), peer = (rank + 1 + tid / kTC) % C;
    const float* src = ed + t * ES + rank * a.RC * BP;
    copy_to_peer(cluster_addr(src, peer), src, own_rows * BP * 4,
                 cluster_addr(reinterpret_cast<const float*>(mbar + (c & 1)), peer));
  };

  // chunk c's Kcat tile, as copied, split into the wgmma layout of its buffer:
  // tap i, column n, t -> core matrix (n / 8, t / 4), row n % 8, element t % 4
  auto split_kcat = [&](int c) {
    const float* src = kcs;
    float* hi = kcan + (KC == 2 ? (c & 1) : 0) * 2 * ktaps * kCan;
    float* lo = hi + ktaps * kCan;
    for (int p = tid; p < ktaps * kTC * 8 * NI; p += kThreads) {
      const int it = p / (8 * NI), n = p - it * (8 * NI);  // it = i * kTC + t
      const int i = it / kTC, t = it - i * kTC;
      const int o = i * kCan + ((n >> 3) * 2 + (t >> 2)) * 32 + (n & 7) * 4 + (t & 3);
      float h, l;
      split(src[it * kKS + n], h, l);
      hi[o] = h;
      lo[o] = l;
    }
  };

  // stage 2 of chunk c: out[(wo, b)] += e[(wo - i, b), chunk] @ Kcat[chunk, i, m]
  // for all taps, from e buffer c & 1 and chunk c's split Kcat buffer. Warpgroup
  // wg holds the m64 tiles at rows 64 wg + 16 W mi (W warps). Each (tap, tile)
  // is three products into a fresh partial, folded into its accumulators.
  auto stage2 = [&](int c) {
    const float* ec = es + (c & 1) * kTC * ES;
    const float* hi = kcan + (KC == 2 ? (c & 1) : 0) * 2 * ktaps * kCan;
    const float* lo = hi + ktaps * kCan;
    for (int i = 0; i < ktaps; ++i) {
      const uint64_t bh = b_desc(hi + i * kCan), bl = b_desc(lo + i * kCan);
      const float* ai = ec + 16 * warp + (ktaps - 1 - i) * BP;
      // kP partials in turn: with two, tile mi's products run while tile
      // mi - 1's partial is folded; 48 columns leave registers for one
      constexpr int kP = NI <= 4 ? 2 : 1;
      float p[kP][NI][4];
      uint32_t ah[kP][4], al[kP][4];
#pragma unroll
      for (int mi = 0; mi <= MI; ++mi) {
        if (mi < MI) {
          load_a(ah[mi % kP], al[mi % kP], ai + 16 * kWarps * mi, ES, g, q);
          wg_pin(p[mi % kP]);
          wg_fence();
          wg_mma(p[mi % kP], al[mi % kP], bh, 0);
          wg_mma(p[mi % kP], ah[mi % kP], bl, 1);
          wg_mma(p[mi % kP], ah[mi % kP], bh, 1);
          wg_commit();
        }
        const int done = mi + 1 - kP;  // the tile whose partial is folded now
        if (done >= 0 && done < MI) {
          if (kP == 2 && mi < MI)
            wg_wait<1>();
          else
            wg_wait<0>();
          wg_pin(p[done % kP]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[done][ni][v] += p[done % kP][ni][v];
        }
      }
    }
  };

  // The pipeline: iteration c splits the Kcat tile of chunk c + 1, computes
  // stage 1 of c + 1 and starts the copies of this block's e rows of c + 1 to
  // the cluster, then runs stage 2 of c while they land; K4 rows and the
  // Kcat tile of c + 2 are in flight meanwhile (the Kcat tile from when the
  // one of c + 1 is split). A block barrier ends it; the
  // blocks of a cluster wait for each other only through mbarriers: for the
  // e rows they send, and before sending into a buffer, for its readers.
  // Where shared memory holds one buffer of the split Kcat tiles (KC 1),
  // the tile of c + 1 is split after stage 2 of c, behind a block barrier,
  // and the tile of c + 2 copied after that; where it holds one buffer of K4
  // rows (K4 1), the rows of c + 2 are copied once stage 1 of c + 1 has read
  // them, behind its barrier.
  fetch_k4(0);
  fetch_kcat(0);
  if constexpr (K4 == 2) {
    if (chunks > 1) fetch_k4(1);
  }
  cp_async_commit();
  for (int p = tid; p < J * a.FS; p += kThreads) {
    const int b = p / J, j = p - b * J;
    fcs[j * a.FS + b] = b < Bt ? a.fc[(long long)(b0 + b) * J + j] : 0.f;
  }
  if (tid == 0) {
    mbar_init(mbar, 1);
    mbar_init(mbar + 1, 1);
    mbar_init(mbar + 2, max(C - 1, 1));
    mbar_init(mbar + 3, max(C - 1, 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait_all();
  cluster.sync();  // every block of the cluster runs (its shared memory exists); tiles are in
  split_kcat(0);
  stage1(0);
  // the split Kcat tile and the e rows are read by wgmma and the copies,
  // through the asynchronous proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (chunks > 1) {
    fetch_kcat(1);
    if constexpr (K4 == 1) fetch_k4(1);  // stage 1 of 0 has read the buffer
  }
  cp_async_commit();
  send(0);
  cp_async_wait_all();
  __syncthreads();  // the Kcat tile and the K4 rows of chunk 1 are in
  for (int c = 0; c < chunks; ++c) {
    if constexpr (K4 == 2) {
      if (c + 2 < chunks) fetch_k4(c + 2);  // into the buffer stage 1 of c read
    }
    cp_async_commit();
    if (c + 1 < chunks) {
      if constexpr (KC == 2) split_kcat(c + 1);  // into the buffer stage 2 of c - 1 read
      stage1(c + 1);      // into the e buffer stage 2 of c - 1 read
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();    // this block's rows of c + 1 are in; the Kcat tile is split
      if (c + 2 < chunks) {
        if constexpr (KC == 2) fetch_kcat(c + 2);
        if constexpr (K4 == 1) fetch_k4(c + 2);  // stage 1 of c + 1 read them
      }
      cp_async_commit();
      send(c + 1);
    }
    mbar_wait(mbar + (c & 1), (c >> 1) & 1);  // the other blocks' rows of c are in
    stage2(c);
    if (c + 1 < chunks) {
      cp_async_wait_all();
      __syncthreads();  // stage 2 of c is done with its buffers; the copies of c + 2 are in
      // tell the other blocks: this block's e buffer c & 1 may take chunk c + 2
      if (tid < C - 1)
        mbar_arrive_remote(cluster_addr(reinterpret_cast<const float*>(mbar + 2 + (c & 1)),
                                        (rank + 1 + tid) % C));
      if constexpr (KC == 1) {
        split_kcat(c + 1);  // into the buffer stage 2 of c read
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();    // split; the copied tile is free
        if (c + 2 < chunks) fetch_kcat(c + 2);
        cp_async_commit();
      }
    }
  }
  cluster.sync();  // the other blocks' copies out of this block's shared memory are done

  // store (B, S, W_pad, TM): tile (mi, ni) holds flattened rows g, g + 8 and
  // columns 2q, 2q + 1 of column group ni
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = 16 * (warp + kWarps * mi) + g + 8 * h;
      if (f >= rows) continue;
      const int wr = f / BP, bl = f - wr * BP;
      const int wo = w0 + wr;
      if (wo >= a.W_pad || bl >= Bt) continue;
      const long long o = (((long long)(b0 + bl) * a.S + s) * a.W_pad + wo) * TM;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int m = m0 + 8 * ni + 2 * q + u;
          if (m >= TM) continue;
          const float v = acc[mi][ni][2 * h + u];
          if (a.out_bf16)
            static_cast<__nv_bfloat16*>(a.out)[o + m] = __float2bfloat16(v);
          else
            static_cast<float*>(a.out)[o + m] = v;
        }
      }
    }
  }
}

struct Plan {
  int MI, NI, W, C, BP, FS, WB, RC, ES;  // W: warps a block
  int BT, kc_bufs, k4_bufs;
  size_t smem;
};

size_t plan_smem(int J, int ktaps, int MI, int NI, int W, int FS, int RC, int ES, int kc_bufs,
                 int k4_bufs) {
  return sizeof(float) * (2 * (size_t)kc_bufs * ktaps * 64 * NI + (size_t)J * FS +
                          (size_t)k4_bufs * RC * J * kTC + 2 * (size_t)kTC * ES +
                          16 * (size_t)W * MI + (size_t)ktaps * kTC * (8 * NI + 8)) +
         4 * sizeof(uint64_t);
}

// The most expansion rows per block (WB) that shared memory holds for a row
// tile of BT fc rows and the given buffers; false if not even one.
bool fit_rows(int B, int J, int W_pad, int ktaps, Plan& p) {
  p.BP = (min(B, p.BT) + 3) / 4 * 4;
  // fc's row stride: 16 fc rows of a fragment read from one stride = 8 or 24
  // mod 32 are free of bank conflicts (rows past BP read the next j's: junk rows)
  p.FS = (p.BP + 7) / 8 * 8;
  if (p.FS % 16 == 0) p.FS += 8;
  for (p.WB = min(p.W * p.MI * 16 / p.BP, W_pad); p.WB >= 1; --p.WB) {
    const int R = p.WB + ktaps - 1;
    p.RC = (R + p.C - 1) / p.C;
    p.ES = (R * p.BP + 16 + 15) / 16 * 16 + 8;  // = 8 or 24 mod 32: fragment reads conflict-free
    p.smem = plan_smem(J, ktaps, p.MI, p.NI, p.W, p.FS, p.RC, p.ES, p.kc_bufs, p.k4_bufs);
    if (p.smem <= kSmemMax) return true;
  }
  return false;
}

// The launch for a shape (decoder_fused_cuda.py::decode_plan): the column
// tile (NI column groups of 8) and cluster size, then the first of these
// (row tile, split Kcat buffers, K4 buffers) whose most expansion rows per
// block keep stage 1's halo (WB + ktaps - 1) / WB at or under 2: (64, 2, 2),
// (64, 1, 2), (64, 1, 1), (32, 1, 2), (32, 1, 1), (16, 1, 1), (8, 1, 1);
// where none does, the one with the least halo (the earliest of equals).
// Every preset takes the first. False if none fits.
bool make_plan(int B, int J, int W_pad, int ktaps, int TM, Plan& p) {
  // 32 columns a block in clusters of up to 8 (TM <= 256): 16 warps of 3 x 4
  // tiles; else 48 columns, 12 warps of 4 x 6 (up to 168 registers a thread)
  const bool wide = TM > 256;
  p.MI = wide ? 4 : 3;
  p.NI = wide ? 6 : 4;
  p.W = wide ? 12 : 16;
  p.C = (TM + 8 * p.NI - 1) / (8 * p.NI);
  if (p.C > kMaxCluster) return false;
  constexpr int kOptions[7][3] = {{64, 2, 2}, {64, 1, 2}, {64, 1, 1}, {32, 1, 2},
                                  {32, 1, 1}, {16, 1, 1}, {8, 1, 1}};
  Plan best{};
  bool found = false;
  for (const auto& o : kOptions) {
    Plan q = p;
    q.BT = o[0];
    q.kc_bufs = o[1];
    q.k4_bufs = o[2];
    if (!fit_rows(B, J, W_pad, ktaps, q)) continue;
    if (q.WB >= ktaps - 1) {  // halo <= 2
      p = q;
      return true;
    }
    // the least halo: (WB + ktaps - 1) / WB is least where WB is largest
    if (!found || q.WB > best.WB) best = q;
    found = true;
  }
  if (found) p = best;
  return found;
}

template <int MI, int NI, int W, int KC, int K4>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream, int* active) {
  auto kern = fused_decode_kernel<MI, NI, W, KC, K4>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  // column tiles fastest: the blocks of a cluster; then w blocks; then (source, row tile)
  cfg.gridDim = dim3(p.C, (a.W_pad + p.WB - 1) / p.WB, a.S * a.b_tiles);
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr) return cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  return cudaLaunchKernelEx(&cfg, kern, a);
}

cudaError_t run(const float* fc, const float* k4, const float* bias, const float* kcat,
                void* out, int out_bf16, int B, int J, int S, int W_pad, int TpC, int ktaps,
                int TM, void* stream, Plan* plan_out, int* active) {
  if (B < 1 || J < 8 || J % 8 != 0 || S < 1 || W_pad < 1 || TpC < 1 || ktaps < 1 || TM < 1)
    return cudaErrorInvalidValue;
  Plan p;
  if (!make_plan(B, J, W_pad, ktaps, TM, p)) return cudaErrorInvalidValue;
  if (plan_out != nullptr) *plan_out = p;
  Args a{fc, k4, bias, kcat, out, out_bf16, B, J, S, W_pad, TpC, ktaps, TM,
         (B + p.BT - 1) / p.BT, p.BP, p.FS, p.WB, p.RC, p.ES,
         (TpC % 4 == 0 && reinterpret_cast<uintptr_t>(k4) % 16 == 0) ? 1 : 0,
         (TM % 4 == 0 && reinterpret_cast<uintptr_t>(kcat) % 16 == 0) ? 1 : 0,
         p.BT};
  auto s = static_cast<cudaStream_t>(stream);
  const int bufs = p.kc_bufs * 2 + p.k4_bufs;  // (2, 2) 6, (1, 2) 4, (1, 1) 3
  cudaError_t err =
      p.NI == 4 ? (bufs == 6 ? launch<3, 4, 16, 2, 2>(a, p, s, active)
                   : bufs == 4 ? launch<3, 4, 16, 1, 2>(a, p, s, active)
                               : launch<3, 4, 16, 1, 1>(a, p, s, active))
                : (bufs == 6 ? launch<4, 6, 12, 2, 2>(a, p, s, active)
                   : bufs == 4 ? launch<4, 6, 12, 1, 2>(a, p, s, active)
                               : launch<4, 6, 12, 1, 1>(a, p, s, active));
  if (err != cudaSuccess || active != nullptr) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_decode_launch(const void* fc, const void* k4, const void* bias,
                                   const void* kcat, void* out, int out_bf16, int B,
                                   int J, int S, int W_pad, int TpC, int ktaps, int TM,
                                   void* stream) {
  return (int)run(static_cast<const float*>(fc), static_cast<const float*>(k4),
                  static_cast<const float*>(bias), static_cast<const float*>(kcat), out,
                  out_bf16, B, J, S, W_pad, TpC, ktaps, TM, stream, nullptr, nullptr);
}

// The plan of a shape as the launcher makes it, and how many of its clusters
// the card runs at once: info = {MI, NI, C, BP, WB, RC, ES, smem bytes,
// active clusters, BT, kc_bufs, k4_bufs}. Launches nothing.
extern "C" int fused_decode_plan(int B, int J, int S, int W_pad, int TpC, int ktaps, int TM,
                                 int* info) {
  Plan p{};
  int active = 0;
  const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, nullptr, 0, B, J, S, W_pad,
                              TpC, ktaps, TM, nullptr, &p, &active);
  const int v[12] = {p.MI, p.NI, p.C, p.BP, p.WB, p.RC, p.ES, (int)p.smem, active,
                     p.BT, p.kc_bufs, p.k4_bufs};
  for (int i = 0; i < 12; ++i) info[i] = v[i];
  return (int)err;
}
