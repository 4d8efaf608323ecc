// wiener_cluster_mixed_block (convsep_tpu_torch/csrc/wiener_common.cuh) run
// on CPU threads through the stand-in cuda_runtime.h beside this file: a
// cluster's C blocks at once (C 2 to 6), each with its own shared memory and
// THREADS threads (4, 16, 32, 128 or 512; 16, 32 or 512 at C 3, 5 and 6;
// the card runs 512), each block's N points on the mixed-radix core, NFFT =
// C N.
//
//   wiener_cluster_mixed DIR C N THREADS NT S NF HOP LENGTH ROUNDS YBF16 P2 EPS CONSERVE HASNY
//                        INT16 SCHED
//
// reads DIR/y.bin (NT x S x NF x (NFFT/2 + 1): float32, or bfloat16 bits
// when YBF16 is 1), DIR/re.bin and DIR/im.bin (NT x NF x (NFFT/2 + 1), or
// NFFT/2 with HASNY), DIR/ny.bin (NT x NF, with HASNY), DIR/wn.bin (window /
// NFFT), DIR/inv.bin (the inverse window-power envelope) and DIR/tw.bin (the
// NFFT-point table e^{-2 pi i m / NFFT}, fft_plan.dft_table) and writes
// DIR/out.bin: the stems NT x S x LENGTH, float32 or int16 when INT16 is 1,
// as wiener_istft.cu::wiener_cluster_mixed_kernel launches it, the block
// transform in the passes of SCHED (fft_plan.mixed_schedule).
#include <cmath>

#include "cuda_runtime.h"
#include "host_io.h"
#include "wiener_common.cuh"

using namespace fft_common;

template <int C, int T>
void run(const wiener::Args& a, int nt, int n, int rounds, unsigned long long sched) {
  const int k = C * n / a.hop;
  emulate_cluster(nt * a.per_signal * a.pairs, C, T,
                  cluster_mixed_smem_bytes(n, 2 * (k - 1) * cluster_columns(a.hop, C)), [&] {
                    wiener::wiener_cluster_mixed_block<C, T>(block_smem, a, n, rounds, sched);
                  });
}

int main(int argc, char** argv) {
  if (argc != 18) return 2;
  const char* dir = argv[1];
  const int c = atoi(argv[2]), n = atoi(argv[3]), threads = atoi(argv[4]), nt = atoi(argv[5]),
            S = atoi(argv[6]), nf = atoi(argv[7]), hop = atoi(argv[8]), length = atoi(argv[9]),
            rounds = atoi(argv[10]), ybf16 = atoi(argv[11]), p2 = atoi(argv[12]);
  const float eps = (float)atof(argv[13]);
  const int conserve = atoi(argv[14]), has_ny = atoi(argv[15]), int16 = atoi(argv[16]);
  const unsigned long long sched = strtoull(argv[17], nullptr, 10);
  const int nfft = c * n;
  const int k = nfft / hop;
  if (nfft % hop || n > 16 * threads || !mixed_schedule_ok(n, sched)) return 2;
  const auto yv = slurp(dir, "y.bin"), rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin");
  const auto wv = slurp(dir, "wn.bin"), nv = slurp(dir, "inv.bin"), tv = slurp(dir, "tw.bin");
  const auto qv = has_ny ? slurp(dir, "ny.bin") : std::vector<char>();
  std::vector<float> outf((size_t)nt * S * length, NAN);
  std::vector<int16_t> outi((size_t)nt * S * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  wiener::Args a{yv.data(), reinterpret_cast<const float*>(rv.data()),
                 reinterpret_cast<const float*>(iv.data()),
                 has_ny ? reinterpret_cast<const float*>(qv.data()) : nullptr,
                 reinterpret_cast<const float*>(wv.data()),
                 reinterpret_cast<const float*>(nv.data()),
                 reinterpret_cast<const float2*>(tv.data()), out, ybf16, int16, S, nf, hop,
                 length, p2, conserve, eps, rounds - (k - 1), 0, (S + 1) / 2};
  if (a.rows < 1) return 2;
  a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
  switch (c * 1024 + threads) {
#define CASE(C, T) \
  case C * 1024 + T: run<C, T>(a, nt, n, rounds, sched); break;
    CASE(2, 4) CASE(2, 16) CASE(2, 32) CASE(2, 128) CASE(2, 512)
    CASE(3, 16) CASE(3, 32) CASE(3, 512)
    CASE(4, 4) CASE(4, 16) CASE(4, 32) CASE(4, 128) CASE(4, 512)
    CASE(5, 16) CASE(5, 32) CASE(5, 512)
    CASE(6, 16) CASE(6, 32) CASE(6, 512)
#undef CASE
    default: return 3;
  }
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}
