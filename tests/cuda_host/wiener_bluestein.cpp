// wiener_bluestein_block (convsep_tpu_torch/csrc/wiener_common.cuh) run on
// CPU threads through the stand-in cuda_runtime.h beside this file, its
// transforms synchronizing the whole block (kBlockSync), on the core (LOG2M
// <= 13) or on the 16 384-point level (LOG2M 14), each block with its own
// shared memory filled with NaN.
//
//   wiener_bluestein DIR LOG2M NT S NF NFFT HOP LENGTH GROUPS ROUNDS PAIRS YBF16 P2 EPS CONSERVE HASNY INT16
//
// reads DIR/y.bin (NT x S x NF x (NFFT/2 + 1): float32, or bfloat16 bits
// when YBF16 is 1), DIR/re.bin and DIR/im.bin (NT x NF x (NFFT/2 + 1), or
// NFFT/2 with HASNY), DIR/ny.bin (NT x NF, with HASNY), DIR/wn.bin (window /
// NFFT), DIR/inv.bin (the inverse window-power envelope), DIR/tw.bin (the
// M-point quarter twiddle table), DIR/chirp.bin and DIR/chat.bin (the chirp
// tables) and writes DIR/out.bin: the stems NT x S x LENGTH, float32 or int16
// when INT16 is 1, as wiener_istft.cu::wiener_istft_launch launches
// wiener_bluestein_kernel. PAIRS is the plan's frame_pairs; the program
// exits with 4 if the launcher's arithmetic chooses otherwise.
#include <cmath>

#include "cuda_runtime.h"
#include "host_io.h"
#include "wiener_common.cuh"

using namespace fft_common;

template <int LOG2M, bool kFramePairs>
void run(const wiener::Args& a, const float2* chirp, const float2* chat, int nt, int nfft,
         int groups, int rounds) {
  emulate_cluster(nt * a.per_signal * (kFramePairs ? a.S : a.pairs), 1,
                  groups * bluestein_threads(LOG2M),
                  wiener::wiener_bluestein_smem_bytes(LOG2M, nfft, a.hop, groups,
                                                      kFramePairs ? 1 : 2),
                  [&] {
                    wiener::wiener_bluestein_block<LOG2M, true, kFramePairs>(
                        block_smem, a, chirp, chat, nfft, rounds);
                  });
}

int main(int argc, char** argv) {
  if (argc != 18) return 2;
  const char* dir = argv[1];
  const int lm = atoi(argv[2]), nt = atoi(argv[3]), S = atoi(argv[4]), nf = atoi(argv[5]),
            nfft = atoi(argv[6]), hop = atoi(argv[7]), length = atoi(argv[8]),
            groups = atoi(argv[9]), rounds = atoi(argv[10]), pairs = atoi(argv[11]),
            ybf16 = atoi(argv[12]), p2 = atoi(argv[13]);
  const float eps = (float)atof(argv[14]);
  const int conserve = atoi(argv[15]), has_ny = atoi(argv[16]), int16 = atoi(argv[17]);
  // wiener_istft_launch's choice
  const bool frame_pairs = lm == kLevelLog2 && wiener::wiener_bluestein_smem_bytes(
                                                   lm, nfft, hop, groups, 2) > 227 * 1024;
  if (frame_pairs != (pairs != 0)) return 4;
  const auto yv = slurp(dir, "y.bin"), rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin");
  const auto wv = slurp(dir, "wn.bin"), nv = slurp(dir, "inv.bin"), tv = slurp(dir, "tw.bin");
  const auto cv = slurp(dir, "chirp.bin"), hv = slurp(dir, "chat.bin");
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
                 length, p2, conserve, eps,
                 (frame_pairs ? 2 : 1) * groups * rounds - (k - 1), 0, (S + 1) / 2};
  if (a.rows < 1) return 2;
  a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
  const auto* chirp = reinterpret_cast<const float2*>(cv.data());
  const auto* chat = reinterpret_cast<const float2*>(hv.data());
  switch (lm * 2 + (int)frame_pairs) {
#define CASE(LG, FP) \
  case LG * 2 + FP: run<LG, FP>(a, chirp, chat, nt, nfft, groups, rounds); break;
    CASE(6, 0) CASE(11, 0) CASE(12, 0) CASE(14, 0) CASE(14, 1)
#undef CASE
    default: return 3;
  }
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}
