// istft_cluster_dit_block (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU
// threads through the stand-in cuda_runtime.h beside this file: a cluster's
// C blocks at once, each with its own shared memory, at a part of 2^LOG2P
// points (the card runs 8192; here also 64 and 512), NFFT = C 2^LOG2P.
//
//   istft_cluster_dit DIR LOG2P C NT NF WIN HOP LENGTH ROUNDS INT16
//
// reads DIR/re.bin and DIR/im.bin (NT x NF x (NFFT/2 + 1) float32),
// DIR/wn.bin (window / NFFT), DIR/inv.bin (the inverse window-power
// envelope) and DIR/tw.bin (the NFFT-point quarter twiddle table) and
// writes DIR/out.bin: NT x LENGTH float32, or int16 when INT16 is 1, as
// istft.cu::istft_cluster_dit_kernel launches it.
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

using namespace fft_common;

template <int LOG2P, int C>
void run(const float* re, const float* im, const float* wn, const float* inv, const float2* tw,
         void* out, int int16, int nt, int nf, int win, int hop, int length, int rounds) {
  const int k = win / hop;
  const int rows = 2 * rounds - (k - 1);
  const int per_signal = (nf + k - 1 + rows - 1) / rows;
  emulate_cluster(nt * per_signal, C, fft_threads(LOG2P),
                  cluster_smem_bytes(LOG2P, (k - 1) * cluster_columns(hop, C)), [&] {
                    istft_cluster_dit_block<LOG2P, C>(block_smem, re, im, wn, inv, tw, out,
                                                      int16, nf, win, hop, length, rounds, rows,
                                                      per_signal);
                  });
}

int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const char* dir = argv[1];
  const int lp = atoi(argv[2]), c = atoi(argv[3]), nt = atoi(argv[4]), nf = atoi(argv[5]),
            win = atoi(argv[6]), hop = atoi(argv[7]), length = atoi(argv[8]),
            rounds = atoi(argv[9]), int16 = atoi(argv[10]);
  const int k = win / hop;
  if (win % hop || win > (c << lp) || 2 * rounds - (k - 1) < 1) return 2;
  const auto rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin"), wv = slurp(dir, "wn.bin");
  const auto nv = slurp(dir, "inv.bin"), tv = slurp(dir, "tw.bin");
  std::vector<float> outf((size_t)nt * length, NAN);
  std::vector<int16_t> outi((size_t)nt * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  const auto* re = reinterpret_cast<const float*>(rv.data());
  const auto* im = reinterpret_cast<const float*>(iv.data());
  const auto* wn = reinterpret_cast<const float*>(wv.data());
  const auto* inv = reinterpret_cast<const float*>(nv.data());
  const auto* tw = reinterpret_cast<const float2*>(tv.data());
  switch (lp * 32 + c) {
#define CASE(LP, C) \
  case LP * 32 + C: run<LP, C>(re, im, wn, inv, tw, out, int16, nt, nf, win, hop, length, rounds); break;
    CASE(6, 2) CASE(6, 4) CASE(6, 8) CASE(9, 2) CASE(9, 4) CASE(13, 2) CASE(13, 4)
#undef CASE
    default: return 3;
  }
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}
