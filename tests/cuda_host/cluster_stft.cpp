// stft_cluster_block (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU
// threads through the stand-in cuda_runtime.h beside this file: a cluster's
// C blocks at once, each with its own shared memory, at a part of 2^LOG2P
// points (the card runs 8192; here also 64 and 512, so that small sizes
// take every code path), C 2, 4, 8 or 16.
//
//   cluster_stft DIR LOG2P C B L W HOP NF NFFT
//
// reads DIR/x.bin (B x L float32), DIR/w.bin (W), DIR/tw.bin (the M-point
// quarter twiddle table, M = C 2^LOG2P), DIR/chirp.bin and DIR/chat.bin (the
// chirp tables, float2) and writes DIR/out.bin: re then im, each (B, NF,
// NFFT/2 + 1) float32, as stft_dft.cu::stft_cluster_kernel launches it (one
// cluster a pair of frames).
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

using namespace fft_common;

template <int LOG2P, int C>
void run(const float* x, const float* win, const float2* tw, const float2* chirp,
         const float2* chat, float* re, float* im, int B, int L, int W, int hop, int nf,
         int nfft) {
  emulate_cluster(B * ((nf + 1) / 2), C, fft_threads(LOG2P), cluster_smem_bytes(LOG2P, 0),
                  [&] {
                    stft_cluster_block<LOG2P, C>(block_smem, x, win, tw, chirp, chat, L, W, hop,
                                                 nf, nfft, FullRows{re, im, nfft / 2 + 1});
                  });
}

int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const char* dir = argv[1];
  const int lp = atoi(argv[2]), c = atoi(argv[3]), B = atoi(argv[4]), L = atoi(argv[5]),
            W = atoi(argv[6]), hop = atoi(argv[7]), nf = atoi(argv[8]), nfft = atoi(argv[9]);
  const auto xv = slurp(dir, "x.bin"), wv = slurp(dir, "w.bin"), tv = slurp(dir, "tw.bin");
  const auto cv = slurp(dir, "chirp.bin"), hv = slurp(dir, "chat.bin");
  const int bins = nfft / 2 + 1;
  std::vector<float> re((size_t)B * nf * bins, NAN), im(re.size(), NAN);
  const auto* x = reinterpret_cast<const float*>(xv.data());
  const auto* w = reinterpret_cast<const float*>(wv.data());
  const auto* tw = reinterpret_cast<const float2*>(tv.data());
  const auto* chirp = reinterpret_cast<const float2*>(cv.data());
  const auto* chat = reinterpret_cast<const float2*>(hv.data());
  switch (lp * 32 + c) {
#define CASE(LP, C) \
  case LP * 32 + C: run<LP, C>(x, w, tw, chirp, chat, re.data(), im.data(), B, L, W, hop, nf, nfft); break;
    CASE(6, 2) CASE(6, 4) CASE(6, 8) CASE(6, 16) CASE(9, 2) CASE(9, 4) CASE(9, 8) CASE(9, 16)
    CASE(13, 4) CASE(13, 16)
#undef CASE
    default: return 3;
  }
  spill<float>(dir, {&re, &im});
  return 0;
}
