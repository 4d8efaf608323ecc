// stft_level_block (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU threads
// through the stand-in cuda_runtime.h beside this file, its transforms
// synchronizing the whole block (kBlockSync): one 16 384-point transform a
// pair of frames on the level, the output rows of ct_stft.cu (bins below
// Nyquist, the Nyquist row apart).
//
//   level_stft DIR B L HOP NF
//
// reads DIR/x.bin (B x L float32), DIR/w.bin (16 384 float32) and DIR/tw.bin
// (the 16 384-point quarter twiddle table, float2) and writes DIR/out.bin:
// re, im (B x NF x 8192) and ny (B x NF), float32, as
// ct_stft.cu::ct_stft_level_kernel launches it.
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

using namespace fft_common;

struct HalfRows {  // ct_stft.cu's output rows
  float* re;
  float* im;
  float* ny;
  int half;
  void operator()(long long row, bool has_b, int k, float2 a, float2 b) const {
    if (k == half) {
      ny[row] = a.x;
      if (has_b) ny[row + 1] = b.x;
      return;
    }
    const long long o = row * half + k;
    re[o] = a.x;
    im[o] = a.y;
    if (has_b) {
      re[o + half] = b.x;
      im[o + half] = b.y;
    }
  }
};

int main(int argc, char** argv) {
  if (argc != 6) return 2;
  const char* dir = argv[1];
  const int B = atoi(argv[2]), L = atoi(argv[3]), hop = atoi(argv[4]), nf = atoi(argv[5]);
  constexpr int N = 1 << kLevelLog2, half = N / 2;
  const auto xv = slurp(dir, "x.bin"), wv = slurp(dir, "w.bin"), tv = slurp(dir, "tw.bin");
  std::vector<float> re((size_t)B * nf * half, NAN), im(re.size(), NAN), ny((size_t)B * nf, NAN);
  const auto* x = reinterpret_cast<const float*>(xv.data());
  const auto* w = reinterpret_cast<const float*>(wv.data());
  const auto* tw = reinterpret_cast<const float2*>(tv.data());
  emulate_cluster(B * ((nf + 1) / 2), 1, 512, bluestein_smem_bytes(kLevelLog2, N, hop, 1), [&] {
    stft_level_block<true>(block_smem, x, w, tw, L, N, hop, nf,
                           HalfRows{re.data(), im.data(), ny.data(), half});
  });
  spill<float>(dir, {&re, &im, &ny});
  return 0;
}
