// The streamed band decode (row 8': a band whose taps and 64-row z tile do
// not fit one block's shared memory at once): the launcher and the
// instances of widths 8-64. The kernel, its design and what bounds it are in
// band_stream.cuh; the wider instances in band_stream_n128.cu,
// band_stream_n192.cu and band_stream_n256.cu.

#include "band_stream.cuh"

BAND_STREAM_INSTANCES(launch_n64, 0)

namespace {

int gcd8(int c) { return c % 8 == 0 ? 8 : c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1; }

struct Plan {
  int n, g, chunks, groups, lq, np, copies, smem, fold;
  long long row_tiles, items;
};

// the launch of a (M, Tp, C2, kh, I) band (decoder_band_cuda.band_stream_plan
// mirrors it): chunks of N = Ip up to 256 columns, groups of G column blocks,
// items (128-row tile, chunk, group)
bool make_plan(long long M, int Tp, int C2, int kh, int I, Plan& p) {
  if (M < 1 || Tp < 1 || C2 < 1 || kh < 1 || I < 1 || (long long)Tp * C2 > (1 << 30) ||
      (long long)(Tp + kh - 1) * I > (1 << 30) || (long long)kh * C2 > (1 << 24))
    return false;
  // a deep band: some column block's depths pass kFold slabs
  const int T = Tp + kh - 1, slab = band_stream::kSlab;
  int most = 0;
  for (int t = 0; t < T; ++t) {
    const int h_lo = t - kh + 1 > 0 ? t - kh + 1 : 0, h_hi = t < Tp - 1 ? t : Tp - 1;
    const int slabs = ((h_hi + 1) * C2 - 1) / slab - h_lo * C2 / slab + 1;
    if (slabs > most) most = slabs;
  }
  p.fold = most > band_stream::kFold;
  const int ip = (I + 7) / 8 * 8, widest = p.fold ? 128 : 256;
  p.chunks = (ip + widest - 1) / widest;
  p.n = ((ip + p.chunks - 1) / p.chunks + 7) / 8 * 8;
  p.g = band_stream::groups_run(p.n, p.fold);
  p.groups = (T + p.g - 1) / p.g;
  p.np = p.n * p.chunks;
  p.lq = (kh * C2 + 2 * band_stream::kSlab + 8 + 7) / 8 * 8;
  p.copies = 8 / gcd8(C2);
  p.smem = band_stream::launch_smem(p.n);
  p.row_tiles = (M + band_stream::kTileRows - 1) / band_stream::kTileRows;
  // items of a cluster: a pair of row tiles, a chunk, a group
  p.items = (p.row_tiles + band_stream::kCluster - 1) / band_stream::kCluster * p.chunks *
            p.groups;
  return p.items <= INT32_MAX;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime without linking libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a 2-D bf16 tensor (outer rows of inner elements, rows inner elements
// apart) read in boxes of box_outer rows x 64 elements (128 bytes, swizzled
// 128 B); elements past it read as zero
bool tensor_map(CUtensorMap* map, const void* base, unsigned long long inner,
                unsigned long long outer, unsigned box_outer) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)band_stream::kSlab, box_outer};
  const cuuint32_t steps[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// The plan of a launch, 11 ints into info: N, G (the column blocks of an
// item), chunks, groups, Lq, Np, copies, shared memory bytes, row tiles,
// items (of a cluster: a pair of row tiles), fold (1: a deep band).
extern "C" int band_stream_plan(long long M, int Tp, int C2, int kh, int I, int* info) {
  Plan p;
  if (!make_plan(M, Tp, C2, kh, I, p)) return (int)cudaErrorInvalidValue;
  const int v[11] = {p.n, p.g, p.chunks, p.groups, p.lq, p.np, p.copies, p.smem,
                     (int)p.row_tiles, (int)p.items, p.fold};
  for (int i = 0; i < 11; ++i) info[i] = v[i];
  return 0;
}

namespace {

cudaError_t dispatch(int n, const band_stream::Maps& maps, const band_stream::Args& a, int grid,
                     cudaStream_t s, int* active) {
  return n <= 64    ? band_stream::launch_n64(n, maps, a, grid, s, active)
         : n <= 128 ? band_stream::launch_n128(n, maps, a, grid, s, active)
         : n <= 192 ? band_stream::launch_n192(n, maps, a, grid, s, active)
                    : band_stream::launch_n256(n, maps, a, grid, s, active);
}

}  // namespace

// The clusters of the width-N instance the card holds at once, into active.
extern "C" int band_stream_clusters(int n, int* active) {
  if (n < 8 || n > 256 || n % 8) return (int)cudaErrorInvalidValue;
  band_stream::Maps maps = {};
  band_stream::Args a = {};
  return (int)dispatch(n, maps, a, band_stream::kCluster, nullptr, active);
}

// z (M, Tp C2) bf16, taps: models/decoder_band_cuda.py::pack_stream_taps
// (copies x Np x Lq bf16), out (M, (Tp + kh - 1) I) f32, each element
// written once; grid: persistent blocks, in clusters of 2
// (decoder_band_cuda.band_stream_plan), cut to the clusters the card holds
// at once.
extern "C" int band_stream_launch(const void* z, const void* taps, void* out, long long M,
                                  int Tp, int C2, int kh, int I, int grid, void* stream) {
  Plan p;
  if (grid < 1 || grid % band_stream::kCluster || !make_plan(M, Tp, C2, kh, I, p) ||
      reinterpret_cast<uintptr_t>(taps) % 16 || reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  const int S = Tp * C2;
  const uintptr_t zp = reinterpret_cast<uintptr_t>(z);
  const int amode = S % 8 == 0 && zp % 16 == 0 ? 16 : S % 2 == 0 && zp % 4 == 0 ? 4 : 1;
  band_stream::Maps maps;
  if (!tensor_map(&maps.taps, taps, p.lq, (unsigned long long)p.copies * p.np, p.n) ||
      !tensor_map(&maps.z, amode == 16 ? z : taps, amode == 16 ? S : p.lq,
                  amode == 16 ? M : p.np, band_stream::kTileRows))
    return (int)cudaErrorInvalidValue;
  band_stream::Args a{static_cast<const __nv_bfloat16*>(z), static_cast<float*>(out), M, Tp, C2,
                      kh, I, Tp + kh - 1, S, p.chunks, p.groups, (int)p.items, p.np,
                      gcd8(C2), amode, p.fold};
  return (int)dispatch(p.n, maps, a, grid, static_cast<cudaStream_t>(stream), nullptr);
}
