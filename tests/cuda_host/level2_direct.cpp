// The direct second level's phases (convsep_tpu_torch/csrc/fft_common.cuh:
// level2_direct_combine, level2_direct_rows, level2_direct_overlap_add) run
// on CPU threads through the stand-in cuda_runtime.h beside this file, as
// istft.cu::launch_level2_direct launches them, every pair of frames in one
// round.
//
//   level2_direct DIR R NT NF NFFT WIN HOP LENGTH INT16 SCHED
//
// reads DIR/re.bin and DIR/im.bin (NT x NF x (NFFT/2 + 1) float32),
// DIR/wn.bin (window / NFFT), DIR/inv.bin (the inverse window-power
// envelope) and DIR/tables.bin (fft_plan.level2_direct_tables: NFFT + NFFT
// / R float2) and writes DIR/out.bin: NT x LENGTH float32, or int16 when
// INT16 is 1. SCHED is the rows' schedule (fft_plan.mixed_schedule).
//
//   level2_direct sizes
//
// prints "NFFT R N" for every NFFT in (65 536, 262 144] that
// level2_direct_sizes (the launcher's check) takes.
#include <cmath>
#include <cstdio>
#include <cstring>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

using namespace fft_common;

constexpr int TB = kLevel2Threads;

template <int R>
int run(char** argv) {
  const char* dir = argv[1];
  const int nt = atoi(argv[3]), nf = atoi(argv[4]), N = atoi(argv[5]), win = atoi(argv[6]),
            hop = atoi(argv[7]), length = atoi(argv[8]), int16 = atoi(argv[9]);
  const unsigned long long sched = strtoull(argv[10], nullptr, 10);
  int r, n;
  if (!level2_direct_sizes(N, &r, &n) || r != R || !mixed_schedule_ok(n, sched)) return 2;
  const int frames = nt * nf, pairs = (frames + 1) / 2;
  const auto rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin"), wv = slurp(dir, "wn.bin");
  const auto nv = slurp(dir, "inv.bin"), tv = slurp(dir, "tables.bin");
  const auto* re = reinterpret_cast<const float*>(rv.data());
  const auto* im = reinterpret_cast<const float*>(iv.data());
  const auto* tables = reinterpret_cast<const float2*>(tv.data());
  std::vector<float2> scratch((size_t)pairs * N, float2{NAN, NAN});
  std::vector<float> fbuf((size_t)frames * N, NAN);
  const int per = (n + TB - 1) / TB;
  emulate(pairs * per, TB, [&] {
    const int pr = blockIdx.x / per;
    const int n2 = (blockIdx.x - pr * per) * TB + threadIdx.x;
    if (n2 < n)
      level2_direct_combine<R>([&](int t) { return level2_bin_point(re, im, N, frames, 2 * pr, t); },
                               scratch.data() + (size_t)pr * N, tables, n, n2);
  });
  emulate_cluster(pairs * R, 1, kMaxThreads, (size_t)mixed_tables_len(n) * sizeof(float2), [&] {
    const int pr = blockIdx.x / R, k1 = blockIdx.x - pr * R, g = 2 * pr;
    level2_direct_rows(block_smem, scratch.data() + (size_t)pr * N + (size_t)k1 * n, tables + N,
                       n, sched, [&](int k2, float2 y) {
                         if (k1 + R * k2 >= win) return;
                         float* fa = fbuf.data() + (size_t)g * N + (size_t)k1 * n + k2;
                         fa[0] = y.x;
                         if (g + 1 < frames) fa[N] = -y.y;
                       });
  });
  std::vector<float> outf((size_t)nt * length, NAN);
  std::vector<int16_t> outi((size_t)nt * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  const auto* wn = reinterpret_cast<const float*>(wv.data());
  const auto* inv = reinterpret_cast<const float*>(nv.data());
  const int per_l = (length + TB - 1) / TB;
  emulate(nt * per_l, TB, [&] {
    const int sig = blockIdx.x / per_l;
    const int tpos = (blockIdx.x - sig * per_l) * TB + threadIdx.x;
    if (tpos < length)
      level2_direct_overlap_add<R>(fbuf.data(), wn, inv, out, int16, sig, nf, N, win, hop, length,
                                   tpos);
  });
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 2 && strcmp(argv[1], "sizes") == 0) {
    for (int nfft = (8 << kMaxLog2) + 1; nfft <= (32 << kMaxLog2); ++nfft) {
      int r, n;
      if (level2_direct_sizes(nfft, &r, &n)) printf("%d %d %d\n", nfft, r, n);
    }
    return 0;
  }
  if (argc != 11) return 2;
  switch (atoi(argv[2])) {
    case kLevel2DirectMinR: return run<kLevel2DirectMinR>(argv);
    case kLevel2DirectMaxR: return run<kLevel2DirectMaxR>(argv);
    default: return 3;
  }
}
