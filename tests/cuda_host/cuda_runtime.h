// A host stand-in for <cuda_runtime.h>: just enough of CUDA for the device
// code of convsep_tpu_torch/csrc/fft_common.cuh to compile with g++ and run
// on the CPU. Each CUDA thread is a fiber (its own stack, switched by hand
// on one OS thread): a fiber runs until it reaches a barrier, then the next
// one runs, and a barrier releases its fibers once all of them have reached
// it (__syncthreads for a block, cluster_sync for a cluster). The fibers of
// a block run in ascending thread order between one barrier and the next,
// and in descending order between the next two, so a read that misses its
// barrier sees the other thread's write missing in one of the two. A
// barrier that some fibers never reach stops the program (a deadlock, exit
// code 4). __syncwarp is not emulated, so only code that synchronizes whole
// blocks runs here (the mixed-radix split, forward and inverse, Bluestein
// at kBlockSync, and the cluster's blocks). A cluster's blocks run at once
// (emulate_cluster), each with its own shared memory, cluster_sync a barrier
// of all their threads and peer() the address in another block's shared
// memory. Used by tests/test_torch_fft_host*.py.
#pragma once
#include <sys/mman.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <limits>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(x)
#define __restrict__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline dim3 threadIdx, blockIdx;  // the running fiber's
inline dim3 blockDim;
inline void __syncwarp() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
typedef int cudaError_t;
constexpr int cudaSuccess = 0;

// ---- fibers -----------------------------------------------------------------

// Saves the callee-saved registers on the running stack, stores its pointer
// in *from and resumes the stack `to` (System V x86-64).
extern "C" void host_fiber_switch(void** from, void* to);
asm(R"(
  .text
  .globl host_fiber_switch
  .type host_fiber_switch, @function
host_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size host_fiber_switch, .-host_fiber_switch
)");

namespace host_fiber {

struct Barrier {
  int expected, count = 0;
  unsigned gen = 0;
};

struct Fiber {
  void* sp = nullptr;
  dim3 tid, bid;
  Barrier* block = nullptr;
  void* smem = nullptr;
  Barrier* waiting = nullptr;  // the barrier it waits at, of generation wait_gen
  unsigned wait_gen = 0;
  bool done = false;
};

constexpr size_t kStack = 512 * 1024;  // bytes a fiber, committed as touched

inline Fiber* current = nullptr;
inline void* scheduler_sp = nullptr;
inline const std::function<void()>* body = nullptr;

[[noreturn]] inline void entry() {
  (*body)();
  current->done = true;
  void* dead;
  host_fiber_switch(&dead, scheduler_sp);
  abort();  // a finished fiber is never resumed
}

// The fiber reaches barrier b: the last one to arrive releases the others and
// runs on; the others wait until it has.
inline void arrive(Barrier* b) {
  if (++b->count == b->expected) {
    b->count = 0;
    ++b->gen;
    return;
  }
  current->waiting = b;
  current->wait_gen = b->gen;
  host_fiber_switch(&current->sp, scheduler_sp);
}

// Runs the fibers (each fn on its own stack from `stacks`) to their ends,
// a sweep over the runnable ones at a time, in ascending and descending
// order by turns.
inline void run(std::vector<Fiber>& fibers, std::vector<char*>& stacks,
                const std::function<void()>& fn) {
  while (stacks.size() < fibers.size()) {
    void* p = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      fprintf(stderr, "host fibers: no memory for a stack\n");
      exit(4);
    }
    stacks.push_back(static_cast<char*>(p));
  }
  for (size_t i = 0; i < fibers.size(); ++i) {
    // the stack as host_fiber_switch leaves it: six registers, then the
    // return into entry, whose frame starts 16-byte aligned less 8
    auto* top = reinterpret_cast<void**>(stacks[i] + kStack);
    top[-1] = nullptr;
    top[-2] = reinterpret_cast<void*>(&entry);
    for (int r = 3; r <= 8; ++r) top[-r] = nullptr;
    fibers[i].sp = top - 8;
  }
  body = &fn;
  size_t live = fibers.size();
  bool up = true;
  while (live) {
    bool moved = false;
    for (size_t j = 0; j < fibers.size(); ++j) {
      Fiber& f = fibers[up ? j : fibers.size() - 1 - j];
      if (f.done || (f.waiting && f.waiting->gen == f.wait_gen)) continue;
      f.waiting = nullptr;
      current = &f;
      threadIdx = f.tid;
      blockIdx = f.bid;
      host_fiber_switch(&scheduler_sp, f.sp);
      moved = true;
      live -= f.done;
    }
    if (!moved) {
      fprintf(stderr, "host fibers: deadlock, %zu threads wait at a barrier\n", live);
      exit(4);
    }
    up = !up;
  }
}

}  // namespace host_fiber

inline void __syncthreads() { host_fiber::arrive(host_fiber::current->block); }

// Run fn as a grid of `blocks` blocks of `threads` threads, a block at a time.
inline void emulate(int blocks, int threads, const std::function<void()>& fn) {
  blockDim.x = threads;
  std::vector<char*> stacks;
  for (int b = 0; b < blocks; ++b) {
    host_fiber::Barrier bar{threads};
    std::vector<host_fiber::Fiber> fibers(threads);
    for (int t = 0; t < threads; ++t) {
      fibers[t].tid.x = t;
      fibers[t].bid.x = b;
      fibers[t].block = &bar;
    }
    host_fiber::run(fibers, stacks, fn);
  }
  for (char* s : stacks) munmap(s, host_fiber::kStack);
}

// ---- clusters ---------------------------------------------------------------

inline host_fiber::Barrier* cluster_barrier = nullptr;
inline std::vector<std::vector<float4>>* cluster_smem = nullptr;  // a block's each

inline void cluster_sync() { host_fiber::arrive(cluster_barrier); }

// the card reads %ctaid.x through volatile asm (fft_common.cuh)
inline int fresh_block_index() { return blockIdx.x; }

// this thread's block's shared memory
#define block_smem (static_cast<float4*>(host_fiber::current->smem))

// p (in this block's shared memory) at the same offset in block `rank`'s
template <class T>
inline T* peer(T* p, int rank) {
  const auto off = reinterpret_cast<const char*>(p) - reinterpret_cast<const char*>(block_smem);
  return reinterpret_cast<T*>(reinterpret_cast<char*>((*cluster_smem)[rank].data()) + off);
}

// the card's 32-bit shared::cluster store and load (fft_common.cuh)
inline void peer_store(float2* p, int rank, float2 u) { *peer(p, rank) = u; }
inline float2 peer_load(const float2* p, int rank) { return *peer(p, rank); }

// Run fn as `clusters` clusters of c blocks of `threads` threads, a cluster
// at a time, its blocks at once: block r of cluster q is blockIdx.x = q c +
// r, with `smem_bytes` of shared memory of its own (filled with NaN: a read
// of what no thread wrote shows in the output), which fn reaches through
// block_smem.
inline void emulate_cluster(int clusters, int c, int threads, size_t smem_bytes,
                            const std::function<void()>& fn) {
  blockDim.x = threads;
  const float nan = std::numeric_limits<float>::quiet_NaN();
  std::vector<char*> stacks;
  for (int q = 0; q < clusters; ++q) {
    std::vector<std::vector<float4>> smem(c, std::vector<float4>((smem_bytes + 15) / 16,
                                                                 float4{nan, nan, nan, nan}));
    std::vector<host_fiber::Barrier> bars(c, host_fiber::Barrier{threads});
    host_fiber::Barrier all{c * threads};
    cluster_barrier = &all;
    cluster_smem = &smem;
    std::vector<host_fiber::Fiber> fibers(c * threads);
    for (int r = 0; r < c; ++r)
      for (int t = 0; t < threads; ++t) {
        auto& f = fibers[r * threads + t];
        f.tid.x = t;
        f.bid.x = q * c + r;
        f.block = &bars[r];
        f.smem = smem[r].data();
      }
    host_fiber::run(fibers, stacks, fn);
  }
  for (char* s : stacks) munmap(s, host_fiber::kStack);
}
