// The mixed-radix block core and istft_cluster_mixed_block
// (convsep_tpu_torch/csrc/fft_common.cuh) run on CPU threads through the
// stand-in cuda_runtime.h beside this file.
//
//   istft_cluster_mixed fft DIR N THREADS SCHED
//
// reads DIR/x.bin (N complex float32) and DIR/tw.bin (the N-point table
// e^{-2 pi i m / N}, m < N) and writes DIR/out.bin: the forward DFT of x by
// one block of THREADS threads (mixed_fft in the passes of SCHED,
// fft_plan.mixed_schedule), in natural order.
//
//   istft_cluster_mixed istft DIR C N THREADS NT NF WIN HOP LENGTH ROUNDS INT16 SCHED
//
// runs the inverse STFT at NFFT = C N (C 2 to 8, NFFT odd too) on clusters
// of C blocks of THREADS threads (the card runs 512), as
// istft.cu::istft_cluster_mixed_kernel launches it: reads DIR/re.bin and
// DIR/im.bin (NT x NF x (NFFT/2 + 1) float32), DIR/wn.bin (window / NFFT),
// DIR/inv.bin (the inverse window-power envelope) and DIR/tw.bin (the
// NFFT-point table) and writes DIR/out.bin: NT x LENGTH float32, or int16
// when INT16 is 1.
//
//   istft_cluster_mixed istft_mask DIR C N ... SCHED
//
// the same at C 2, 4 or 8 with ClusterMixed's put in its power-of-two form
// (the owner t & (C - 1), the slot t >> log2 C), to hold the kernel's
// division by C to it bit for bit.
//
//   istft_cluster_mixed sizes
//
// prints "NFFT C N" for every NFFT in (8192, 65 536] that mixed_sizes (the
// launchers' check) takes.
#include <cmath>
#include <cstdio>
#include <cstring>

#include "cuda_runtime.h"
#include "fft_common.cuh"
#include "host_io.h"

using namespace fft_common;

static int fft_main(char** argv) {
  const char* dir = argv[2];
  const int n = atoi(argv[3]), threads = atoi(argv[4]);
  const unsigned long long sched = strtoull(argv[5], nullptr, 10);
  if (n > 16 * threads || !mixed_schedule_ok(n, sched)) return 2;
  const auto xv = slurp(dir, "x.bin"), tv = slurp(dir, "tw.bin");
  const auto* x = reinterpret_cast<const float2*>(xv.data());
  const auto* tw = reinterpret_cast<const float2*>(tv.data());
  std::vector<float2> out(n, float2{NAN, NAN});
  emulate_cluster(1, 1, threads, (size_t)mixed_tables_len(n) * sizeof(float2), [&] {
    float2* tws = reinterpret_cast<float2*>(block_smem);
    float2* buf = tws + n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      tws[i] = tw[i];
      buf[slot(i)] = x[i];
    }
    __syncthreads();
    mixed_fft(buf, tws, n, sched);
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = buf[slot(i)];
  });
  std::vector<float> flat(2 * (size_t)n);
  memcpy(flat.data(), out.data(), flat.size() * sizeof(float));
  spill<float>(dir, {&flat});
  return 0;
}

// ClusterMixed<C> with its puts written for a power-of-two C alone: the
// owner and slot of a point by a mask and a shift, a bin at a time
template <int C>
struct ClusterMixedMask : ClusterMixed<C> {
  static void put(float2* buf, int t, float2 u) { peer(buf, t & (C - 1))[slot(t >> ilog2(C))] = u; }
  template <int K>
  static void put_bins(float2* buf, const float4 (&ab)[K], int kk0, int stride, int k_end, int N) {
    for (int i = 0; i < K; ++i) {
      const int kk = kk0 + i * stride;
      if (kk < k_end) {
        put(buf, kk, make_float2(ab[i].x - ab[i].w, -(ab[i].y + ab[i].z)));
        if (kk) put(buf, N - kk, make_float2(ab[i].x + ab[i].w, ab[i].y - ab[i].z));
      }
    }
  }
};

template <int C, class D = ClusterMixed<C>>
void run(const float* re, const float* im, const float* wn, const float* inv, const float2* tw,
         void* out, int int16, int n, int threads, int nt, int nf, int win, int hop, int length,
         int rounds, unsigned long long sched) {
  const int k = win / hop;
  const int rows = 2 * rounds - (k - 1);
  const int per_signal = (nf + k - 1 + rows - 1) / rows;
  emulate_cluster(nt * per_signal, C, threads,
                  cluster_mixed_smem_bytes(n, (k - 1) * cluster_columns(hop, C)), [&] {
                    istft_cluster_mixed_block<C, D>(block_smem, re, im, wn, inv, tw, out, int16,
                                                    nf, n, win, hop, length, rounds, rows,
                                                    per_signal, sched);
                  });
}

static int istft_main(char** argv, bool mask) {
  const char* dir = argv[2];
  const int c = atoi(argv[3]), n = atoi(argv[4]), threads = atoi(argv[5]), nt = atoi(argv[6]),
            nf = atoi(argv[7]), win = atoi(argv[8]), hop = atoi(argv[9]), length = atoi(argv[10]),
            rounds = atoi(argv[11]), int16 = atoi(argv[12]);
  const unsigned long long sched = strtoull(argv[13], nullptr, 10);
  const int k = win / hop;
  if (win % hop || win > c * n || 2 * rounds - (k - 1) < 1 || n > 16 * threads ||
      !mixed_schedule_ok(n, sched))
    return 2;
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
  using Run = void (*)(const float*, const float*, const float*, const float*, const float2*,
                      void*, int, int, int, int, int, int, int, int, int, unsigned long long);
  Run fn = nullptr;
  if (mask) {
    fn = c == 2 ? run<2, ClusterMixedMask<2>>
         : c == 4 ? run<4, ClusterMixedMask<4>>
         : c == 8 ? run<8, ClusterMixedMask<8>> : nullptr;
  } else if (c >= 2 && c <= 8) {
    const Run all[] = {run<2>, run<3>, run<4>, run<5>, run<6>, run<7>, run<8>};
    fn = all[c - 2];
  }
  if (!fn) return 3;
  fn(re, im, wn, inv, tw, out, int16, n, threads, nt, nf, win, hop, length, rounds, sched);
  if (int16)
    spill<int16_t>(dir, {&outi});
  else
    spill<float>(dir, {&outf});
  return 0;
}

static int sizes_main() {
  for (int nfft = (1 << kMaxLog2) + 1; nfft <= (8 << kMaxLog2); ++nfft) {
    int c, n;
    if (mixed_sizes(nfft, &c, &n)) printf("%d %d %d\n", nfft, c, n);
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 2 && !strcmp(argv[1], "sizes")) return sizes_main();
  if (argc == 6 && !strcmp(argv[1], "fft")) return fft_main(argv);
  if (argc == 14 && !strcmp(argv[1], "istft")) return istft_main(argv, false);
  if (argc == 14 && !strcmp(argv[1], "istft_mask")) return istft_main(argv, true);
  return 2;
}
