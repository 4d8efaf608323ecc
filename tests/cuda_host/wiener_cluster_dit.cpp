// wiener_cluster_dit_block (convsep_tpu_torch/csrc/wiener_common.cuh) run on
// CPU threads through the stand-in cuda_runtime.h beside this file: a
// cluster's C blocks at once, each with its own shared memory, at a part of
// 2^LOG2P points (the card runs 8192; here also 64 and 512), NFFT = C 2^LOG2P.
//
//   wiener_cluster_dit DIR LOG2P C NT S NF HOP LENGTH ROUNDS YBF16 P2 EPS CONSERVE HASNY INT16
//
// reads DIR/y.bin (NT x S x NF x (NFFT/2 + 1): float32, or bfloat16 bits
// when YBF16 is 1), DIR/re.bin and DIR/im.bin (NT x NF x (NFFT/2 + 1), or
// NFFT/2 with HASNY), DIR/ny.bin (NT x NF, with HASNY), DIR/wn.bin (window /
// NFFT), DIR/inv.bin (the inverse window-power envelope) and DIR/tw.bin (the
// NFFT-point quarter twiddle table) and writes DIR/out.bin: the stems NT x S
// x LENGTH, float32 or int16 when INT16 is 1, as
// wiener_istft.cu::wiener_cluster_dit_kernel launches it.
#include <cmath>

#include "cuda_runtime.h"
#include "host_io.h"
#include "wiener_common.cuh"

using namespace fft_common;

template <int LOG2P, int C>
void run(const wiener::Args& a, int nt, int rounds) {
  const int k = (C << LOG2P) / a.hop;
  emulate_cluster(nt * a.per_signal * a.pairs, C, fft_threads(LOG2P),
                  cluster_smem_bytes(LOG2P, 2 * (k - 1) * cluster_columns(a.hop, C)),
                  [&] { wiener::wiener_cluster_dit_block<LOG2P, C>(block_smem, a, rounds); });
}

int main(int argc, char** argv) {
  if (argc != 16) return 2;
  const char* dir = argv[1];
  const int lp = atoi(argv[2]), c = atoi(argv[3]), nt = atoi(argv[4]), S = atoi(argv[5]),
            nf = atoi(argv[6]), hop = atoi(argv[7]), length = atoi(argv[8]),
            rounds = atoi(argv[9]), ybf16 = atoi(argv[10]), p2 = atoi(argv[11]);
  const float eps = (float)atof(argv[12]);
  const int conserve = atoi(argv[13]), has_ny = atoi(argv[14]), int16 = atoi(argv[15]);
  const int nfft = c << lp;
  const auto yv = slurp(dir, "y.bin"), rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin");
  const auto wv = slurp(dir, "wn.bin"), nv = slurp(dir, "inv.bin"), tv = slurp(dir, "tw.bin");
  const auto qv = has_ny ? slurp(dir, "ny.bin") : std::vector<char>();
  std::vector<float> outf((size_t)nt * S * length, NAN);
  std::vector<int16_t> outi((size_t)nt * S * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  const int k = nfft / hop;
  wiener::Args a{yv.data(), reinterpret_cast<const float*>(rv.data()),
                 reinterpret_cast<const float*>(iv.data()),
                 has_ny ? reinterpret_cast<const float*>(qv.data()) : nullptr,
                 reinterpret_cast<const float*>(wv.data()),
                 reinterpret_cast<const float*>(nv.data()),
                 reinterpret_cast<const float2*>(tv.data()), out, ybf16, int16, S, nf, hop,
                 length, p2, conserve, eps, rounds - (k - 1), 0, (S + 1) / 2};
  if (a.rows < 1 || nfft % hop) return 2;
  a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
  switch (lp * 32 + c) {
#define CASE(LP, C) \
  case LP * 32 + C: run<LP, C>(a, nt, rounds); break;
    CASE(6, 2) CASE(6, 4) CASE(9, 2) CASE(9, 4) CASE(13, 2) CASE(13, 4)
#undef CASE
    default: return 3;
  }
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}
