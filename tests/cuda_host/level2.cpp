// The second level's phases (convsep_tpu_torch/csrc/fft_common.cuh:
// level2_first, level2_middle, level2_last, and the STFT's level2_split or
// the iSTFT's level2_overlap_add) run on CPU threads through the stand-in
// cuda_runtime.h beside this file, as stft_dft.cu::launch_level2 and
// istft.cu::launch_level2 launch them, every pair of frames in one round.
//
//   level2 DIR 0 LOG2M B L W HOP NF NFFT
//   level2 DIR 1 LOG2M NT NF NFFT WIN HOP LENGTH INT16
//
// Mode 0 (the STFT) reads DIR/x.bin (B x L float32) and DIR/w.bin (W
// float32) and writes DIR/out.bin: re, im (B x NF x (NFFT/2 + 1) float32).
// Mode 1 (the iSTFT) reads DIR/re.bin and DIR/im.bin (NT x NF x (NFFT/2 +
// 1) float32), DIR/wn.bin (window / NFFT) and DIR/inv.bin (the inverse
// window-power envelope) and writes DIR/out.bin: NT x LENGTH float32, or
// int16 when INT16 is 1. Both read DIR/tw.bin (the M-point quarter twiddle
// table), DIR/chirp.bin (fft_plan.bluestein_tables) and DIR/chat.bin
// (fft_plan.level2_chat), float2.
#include <cmath>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

using namespace fft_common;

constexpr int P = 1 << kMaxLog2;
constexpr int TB = kLevel2Threads;

// phases A, B/C and D of `pairs` pairs, point(g, t) the points of the pair
// whose frame a is g, store(scratch of the pair, g, t, Z[t])
template <int LOG2M, class Point, class Store>
void convolve(int pairs, float2* scratch, const float2* tw, const float2* chat, Point point,
              Store store) {
  constexpr int M = 1 << LOG2M, R = M / P;
  emulate(pairs * (P / TB), TB, [&] {
    const int pr = blockIdx.x / (P / TB);
    const int n1 = (blockIdx.x - pr * (P / TB)) * TB + threadIdx.x;
    level2_first<LOG2M>([&](int t) { return point(2 * pr, t); }, scratch + (size_t)pr * M, tw,
                        n1);
  });
  emulate_cluster(pairs * R, 1, 512, level2_middle_smem(), [&] {
    const int pr = blockIdx.x / R, r = blockIdx.x - pr * R;
    level2_middle<LOG2M>(block_smem, scratch + (size_t)pr * M + (size_t)r * P, tw,
                         chat + (size_t)r * P, r);
  });
  emulate(pairs * (P / TB), TB, [&] {
    const int pr = blockIdx.x / (P / TB);
    const int k1 = (blockIdx.x - pr * (P / TB)) * TB + threadIdx.x;
    float2* xs = scratch + (size_t)pr * M;
    level2_last<LOG2M>(xs, tw, k1, [&](int t, float2 z) { store(xs, 2 * pr, t, z); });
  });
}

template <int LOG2M>
int run(int argc, char** argv) {
  constexpr int M = 1 << LOG2M;
  const char* dir = argv[1];
  const int mode = atoi(argv[2]);
  const auto tv = slurp(dir, "tw.bin"), cv = slurp(dir, "chirp.bin"), hv = slurp(dir, "chat.bin");
  const auto* tw = reinterpret_cast<const float2*>(tv.data());
  const auto* chirp = reinterpret_cast<const float2*>(cv.data());
  const auto* chat = reinterpret_cast<const float2*>(hv.data());
  if (mode == 0) {
    if (argc != 10) return 2;
    const int B = atoi(argv[4]), L = atoi(argv[5]), W = atoi(argv[6]), hop = atoi(argv[7]),
              nf = atoi(argv[8]), N = atoi(argv[9]);
    const int bins = N / 2 + 1, frames = B * nf, pairs = (frames + 1) / 2;
    const auto xv = slurp(dir, "x.bin"), wv = slurp(dir, "w.bin");
    const Level2Frames fr{reinterpret_cast<const float*>(xv.data()),
                          reinterpret_cast<const float*>(wv.data()), chirp, L, W, hop, nf,
                          frames};
    std::vector<float2> scratch((size_t)pairs * M, float2{NAN, NAN});
    std::vector<float> re((size_t)frames * bins, NAN), im(re.size(), NAN);
    convolve<LOG2M>(pairs, scratch.data(), tw, chat, fr, [&](float2* xs, int, int t, float2 z) {
      if (t < N) xs[t] = cmul(chirp[t], make_float2(z.x, -z.y));
    });
    const FullRows out{re.data(), im.data(), bins};
    emulate(pairs * ((N / 2 + TB) / TB), TB, [&] {
      const int per = (N / 2 + TB) / TB;
      const int pr = blockIdx.x / per;
      const int k = (blockIdx.x - pr * per) * TB + threadIdx.x;
      if (k <= N / 2)
        level2_split(scratch.data() + (size_t)pr * M, N, k, 2 * pr, 2 * pr + 1 < frames, out);
    });
    spill<float>(dir, {&re, &im});
    return 0;
  }
  if (argc != 11) return 2;
  const int nt = atoi(argv[4]), nf = atoi(argv[5]), N = atoi(argv[6]), win = atoi(argv[7]),
            hop = atoi(argv[8]), length = atoi(argv[9]), int16 = atoi(argv[10]);
  const int frames = nt * nf, pairs = (frames + 1) / 2;
  const auto rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin"), wv = slurp(dir, "wn.bin");
  const auto nv = slurp(dir, "inv.bin");
  const auto* wn = reinterpret_cast<const float*>(wv.data());
  const Level2Spectra sp{reinterpret_cast<const float*>(rv.data()),
                         reinterpret_cast<const float*>(iv.data()), chirp, N, frames};
  std::vector<float2> scratch((size_t)pairs * M, float2{NAN, NAN});
  std::vector<float> fbuf((size_t)frames * win, NAN);
  convolve<LOG2M>(pairs, scratch.data(), tw, chat, sp, [&](float2*, int g, int t, float2 z) {
    if (t >= win) return;
    const float2 y = cmul(chirp[t], make_float2(z.x, -z.y));
    fbuf[(size_t)g * win + t] = wn[t] * y.x;
    if (g + 1 < frames) fbuf[(size_t)(g + 1) * win + t] = -wn[t] * y.y;
  });
  std::vector<float> outf((size_t)nt * length, NAN);
  std::vector<int16_t> outi((size_t)nt * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  const auto* inv = reinterpret_cast<const float*>(nv.data());
  const int per = (length + TB - 1) / TB;
  emulate(nt * per, TB, [&] {
    const int n = blockIdx.x / per;
    const int tpos = (blockIdx.x - n * per) * TB + threadIdx.x;
    if (tpos < length)
      level2_overlap_add(fbuf.data(), inv, out, int16, n, nf, win, hop, length, tpos);
  });
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  switch (atoi(argv[3])) {
    case kLevel2MinLog2: return run<kLevel2MinLog2>(argc, argv);
    case kLevel2MaxLog2: return run<kLevel2MaxLog2>(argc, argv);
    default: return 3;
  }
}
