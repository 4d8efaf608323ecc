// istft_split_block (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU
// threads through the stand-in cuda_runtime.h beside this file.
//
//   split_istft DIR M LOG2P NT NF WIN HOP LENGTH GROUPS ROUNDS INT16
//
// reads DIR/re.bin and DIR/im.bin (NT x NF x (N/2 + 1) float32, N = M
// 2^LOG2P), DIR/wn.bin (window / N), DIR/inv.bin (the inverse window-power
// envelope), DIR/twp.bin and DIR/twn.bin (the 2^LOG2P- and N-point quarter
// twiddle tables, float2) and writes DIR/out.bin: NT x LENGTH float32, or
// int16 when INT16 is 1, as istft.cu::istft_split_kernel launches it.
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

namespace fft_common {
alignas(16) float4 smem4[1 << 16];  // the block's dynamic shared memory
}
using namespace fft_common;

template <int LOG2P, int M>
void run(const float* re, const float* im, const float* wn, const float* inv, const float2* twp,
         const float2* twn, void* out, int int16, int nt, int nf, int win, int hop, int length,
         int groups, int rounds) {
  const int k = win / hop;
  const int rows = rounds * 2 * groups - (k - 1);
  const int per_signal = (nf + k - 1 + rows - 1) / rows;
  emulate(nt * per_signal, groups * M * fft_threads(LOG2P), [&] {
    istft_split_block<LOG2P, M>(re, im, wn, inv, twp, twn, out, int16, nf, win, hop, length,
                                rounds, rows, per_signal);
  });
}

int main(int argc, char** argv) {
  if (argc != 12) return 2;
  const char* dir = argv[1];
  const int m = atoi(argv[2]), lp = atoi(argv[3]), nt = atoi(argv[4]), nf = atoi(argv[5]),
            win = atoi(argv[6]), hop = atoi(argv[7]), length = atoi(argv[8]),
            groups = atoi(argv[9]), rounds = atoi(argv[10]), int16 = atoi(argv[11]);
  const auto rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin"), wv = slurp(dir, "wn.bin");
  const auto nv = slurp(dir, "inv.bin"), tp = slurp(dir, "twp.bin"), tn = slurp(dir, "twn.bin");
  std::vector<float> outf((size_t)nt * length, NAN);
  std::vector<int16_t> outi((size_t)nt * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  const auto* re = reinterpret_cast<const float*>(rv.data());
  const auto* im = reinterpret_cast<const float*>(iv.data());
  const auto* wn = reinterpret_cast<const float*>(wv.data());
  const auto* inv = reinterpret_cast<const float*>(nv.data());
  const auto* twp = reinterpret_cast<const float2*>(tp.data());
  const auto* twn = reinterpret_cast<const float2*>(tn.data());
  bool ran = true;
#define CASE(MM, LP) \
  else if (m == MM && lp == LP) run<LP, MM>(re, im, wn, inv, twp, twn, out, int16, nt, nf, win, hop, length, groups, rounds);
  if (false) {
  }
  CASE(3, 4) CASE(5, 4) CASE(15, 4) CASE(3, 8) CASE(5, 8) CASE(9, 8) CASE(3, 11)
  else ran = false;
  if (!ran) return 3;
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}
