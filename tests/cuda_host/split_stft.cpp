// stft_split_block (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU threads
// through the stand-in cuda_runtime.h beside this file.
//
//   split_stft DIR M LOG2P B L W HOP NF FFTS
//
// reads DIR/x.bin (B x L float32), DIR/w.bin (W), DIR/twp.bin and
// DIR/twn.bin (the 2^LOG2P- and N-point quarter twiddle tables, float2) and
// writes DIR/out.bin: re then im, each (B, NF, N/2 + 1) float32, N = M 2^LOG2P,
// with FFTS transforms a block, as stft_dft.cu::stft_split_kernel launches it.
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

namespace fft_common {
alignas(16) float4 smem4[1 << 16];  // the block's dynamic shared memory
}
using namespace fft_common;

template <int LOG2P, int M>
void run(const float* x, const float* win, const float2* twp, const float2* twn, float* re,
         float* im, int B, int L, int W, int hop, int nf, int ffts) {
  const int blocks = B * ((nf + 2 * ffts - 1) / (2 * ffts));
  emulate(blocks, ffts * M * fft_threads(LOG2P), [&] {
    stft_split_block<LOG2P, M>(x, win, twp, twn, L, W, hop, nf,
                               FullRows{re, im, (M << LOG2P) / 2 + 1});
  });
}

int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const char* dir = argv[1];
  const int m = atoi(argv[2]), lp = atoi(argv[3]), B = atoi(argv[4]), L = atoi(argv[5]),
            W = atoi(argv[6]), hop = atoi(argv[7]), nf = atoi(argv[8]), ffts = atoi(argv[9]);
  const auto xv = slurp(dir, "x.bin"), wv = slurp(dir, "w.bin");
  const auto tp = slurp(dir, "twp.bin"), tn = slurp(dir, "twn.bin");
  const int bins = (m << lp) / 2 + 1;
  std::vector<float> re((size_t)B * nf * bins, NAN), im(re.size(), NAN);
  const auto* x = reinterpret_cast<const float*>(xv.data());
  const auto* w = reinterpret_cast<const float*>(wv.data());
  const auto* twp = reinterpret_cast<const float2*>(tp.data());
  const auto* twn = reinterpret_cast<const float2*>(tn.data());
  bool ran = true;
#define CASE(MM, LP) \
  else if (m == MM && lp == LP) run<LP, MM>(x, w, twp, twn, re.data(), im.data(), B, L, W, hop, nf, ffts);
  if (false) {
  }
  CASE(3, 4) CASE(5, 4) CASE(9, 4) CASE(15, 4) CASE(3, 8) CASE(5, 8) CASE(9, 8) CASE(3, 9)
  else ran = false;
  if (!ran) return 3;
  spill<float>(dir, {&re, &im});
  return 0;
}
