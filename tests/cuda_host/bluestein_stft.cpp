// stft_bluestein_block (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU
// threads through the stand-in cuda_runtime.h beside this file, its
// transforms synchronizing the whole block (kBlockSync: the stand-in has
// only __syncthreads; the card's kernel synchronizes each group alone), on
// the core (LOG2M <= 13) or on the 16 384-point level (LOG2M 14).
//
//   bluestein_stft DIR LOG2M B L W HOP NF NFFT FFTS
//
// reads DIR/x.bin (B x L float32), DIR/w.bin (W), DIR/tw.bin (the M-point
// quarter twiddle table), DIR/chirp.bin and DIR/chat.bin (the chirp tables,
// float2) and writes DIR/out.bin: re then im, each (B, NF, NFFT/2 + 1)
// float32, as stft_dft.cu::stft_bluestein_kernel launches it.
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

namespace fft_common {
alignas(16) float4 smem4[1 << 16];  // the block's dynamic shared memory
}
using namespace fft_common;

template <int LOG2M>
void run(const float* x, const float* win, const float2* tw, const float2* chirp,
         const float2* chat, float* re, float* im, int B, int L, int W, int hop, int nf,
         int nfft, int ffts) {
  const int blocks = B * ((nf + 2 * ffts - 1) / (2 * ffts));
  emulate(blocks, ffts * bluestein_threads(LOG2M), [&] {
    stft_bluestein_block<LOG2M, true>(x, win, tw, chirp, chat, L, W, hop, nf, nfft,
                                      FullRows{re, im, nfft / 2 + 1});
  });
}

int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const char* dir = argv[1];
  const int lm = atoi(argv[2]), B = atoi(argv[3]), L = atoi(argv[4]), W = atoi(argv[5]),
            hop = atoi(argv[6]), nf = atoi(argv[7]), nfft = atoi(argv[8]), ffts = atoi(argv[9]);
  const auto xv = slurp(dir, "x.bin"), wv = slurp(dir, "w.bin"), tv = slurp(dir, "tw.bin");
  const auto cv = slurp(dir, "chirp.bin"), hv = slurp(dir, "chat.bin");
  const int bins = nfft / 2 + 1;
  std::vector<float> re((size_t)B * nf * bins, NAN), im(re.size(), NAN);
  const auto* x = reinterpret_cast<const float*>(xv.data());
  const auto* w = reinterpret_cast<const float*>(wv.data());
  const auto* tw = reinterpret_cast<const float2*>(tv.data());
  const auto* chirp = reinterpret_cast<const float2*>(cv.data());
  const auto* chat = reinterpret_cast<const float2*>(hv.data());
  switch (lm) {
#define CASE(LG) \
  case LG: run<LG>(x, w, tw, chirp, chat, re.data(), im.data(), B, L, W, hop, nf, nfft, ffts); break;
    CASE(6) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14)
#undef CASE
    default: return 3;
  }
  spill<float>(dir, {&re, &im});
  return 0;
}
