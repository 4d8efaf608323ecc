// wiener_split_block (convsep_tpu_torch/csrc/wiener_common.cuh) run on CPU
// threads through the stand-in cuda_runtime.h beside this file, each block
// with its own shared memory filled with NaN.
//
//   wiener_split DIR M LOG2P NT S NF HOP LENGTH GROUPS ROUNDS YBF16 P2 EPS CONSERVE HASNY INT16
//
// reads DIR/y.bin (NT x S x NF x (N/2 + 1), N = M 2^LOG2P: float32, or
// bfloat16 bits when YBF16 is 1), DIR/re.bin and DIR/im.bin (NT x NF x (N/2 +
// 1), or N/2 with HASNY), DIR/ny.bin (NT x NF, with HASNY), DIR/wn.bin
// (window / N), DIR/inv.bin (the inverse window-power envelope), DIR/twp.bin
// and DIR/twn.bin (the 2^LOG2P- and N-point quarter twiddle tables) and
// writes DIR/out.bin: the stems NT x S x LENGTH, float32 or int16 when INT16
// is 1, as wiener_istft.cu::wiener_istft_launch launches wiener_split_kernel.
#include <cmath>

#include "cuda_runtime.h"
#include "host_io.h"
#include "wiener_common.cuh"

using namespace fft_common;

template <int LOG2P, int M>
void run(const wiener::Args& a, const float2* twn, int nt, int groups, int rounds) {
  emulate_cluster(nt * a.per_signal * a.pairs, 1, groups * M * fft_threads(LOG2P),
                  wiener::wiener_split_smem_bytes(LOG2P, M, a.hop, groups),
                  [&] { wiener::wiener_split_block<LOG2P, M>(block_smem, a, twn, rounds); });
}

int main(int argc, char** argv) {
  if (argc != 17) return 2;
  const char* dir = argv[1];
  const int m = atoi(argv[2]), lp = atoi(argv[3]), nt = atoi(argv[4]), S = atoi(argv[5]),
            nf = atoi(argv[6]), hop = atoi(argv[7]), length = atoi(argv[8]),
            groups = atoi(argv[9]), rounds = atoi(argv[10]), ybf16 = atoi(argv[11]),
            p2 = atoi(argv[12]);
  const float eps = (float)atof(argv[13]);
  const int conserve = atoi(argv[14]), has_ny = atoi(argv[15]), int16 = atoi(argv[16]);
  const auto yv = slurp(dir, "y.bin"), rv = slurp(dir, "re.bin"), iv = slurp(dir, "im.bin");
  const auto wv = slurp(dir, "wn.bin"), nv = slurp(dir, "inv.bin");
  const auto tp = slurp(dir, "twp.bin"), tn = slurp(dir, "twn.bin");
  const auto qv = has_ny ? slurp(dir, "ny.bin") : std::vector<char>();
  std::vector<float> outf((size_t)nt * S * length, NAN);
  std::vector<int16_t> outi((size_t)nt * S * length, INT16_MIN);
  void* out = int16 ? static_cast<void*>(outi.data()) : static_cast<void*>(outf.data());
  const int k = (m << lp) / hop;
  wiener::Args a{yv.data(), reinterpret_cast<const float*>(rv.data()),
                 reinterpret_cast<const float*>(iv.data()),
                 has_ny ? reinterpret_cast<const float*>(qv.data()) : nullptr,
                 reinterpret_cast<const float*>(wv.data()),
                 reinterpret_cast<const float*>(nv.data()),
                 reinterpret_cast<const float2*>(tp.data()), out, ybf16, int16, S, nf, hop,
                 length, p2, conserve, eps, groups * rounds - (k - 1), 0, (S + 1) / 2};
  if (a.rows < 1) return 2;
  a.per_signal = (nf + k - 1 + a.rows - 1) / a.rows;
  const auto* twn = reinterpret_cast<const float2*>(tn.data());
  switch (m * 32 + lp) {
#define CASE(MM, LP) \
  case MM * 32 + LP: run<LP, MM>(a, twn, nt, groups, rounds); break;
    CASE(3, 7) CASE(3, 8) CASE(5, 8) CASE(15, 4)
#undef CASE
    default: return 3;
  }
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}
