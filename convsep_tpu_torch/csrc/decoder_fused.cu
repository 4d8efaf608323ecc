// Fused ConvSep decode: expansion GEMM -> ReLU -> composed band GEMM -> tap
// fold, for Hopper (sm_90a).
//
// Replaces convsep_tpu/models/decoder_fused_pallas.py::band_freq_decode_pallas
// (_kernel). For each fc row b, source s and expansion row w:
//
//   e[b, s, w, :] = relu(fc[b, :] @ K4[:, s, w, :] + bias[s, w, :])   (TpC)
//   out[b, s, w + i, :] += e[b, s, w, :] @ Kcat[:, i, :]               (TM)
//
// for taps i < ktaps (Kcat is tap-reversed: column block i holds conv tap
// ktaps - 1 - i), output in float32 or bfloat16 (mask_dtype).
//
// What bounds it on the H100: arithmetic. About 175 GFLOP per 30 s
// highres4096 track in float32, 88 % of it in the e @ Kcat product; the
// K4 stream (827 MB) is read a few times and Kcat (3 MB) stays in L2. This
// version runs on the CUDA cores, not the tensor cores.
//
// Design: the point is that the per-source expansion e (about 1.3 GB per
// highres batch) never reaches device memory. A block owns (8 fc rows,
// 16 output rows [w0, w0 + 16), 128 output columns, one source). The TPU
// carried the fold's ktaps - 1 spill rows from one w block to the next;
// blocks here run in no order, so a block recomputes e for the ktaps - 1
// rows before w0 (a halo). Written as output row wo = sum over taps i of
// e[wo - i] @ Kcat[:, i, :], the fold is one product of depth ktaps * TpC
// whose left operand is a shifted view of e, so no thread idles on taps
// that miss its row. The block walks t in chunks of 32: it computes the
// chunk of e for its 16 + ktaps - 1 rows into shared memory, then for each
// tap stages the matching 32 x 128 Kcat tile in shared memory, and every
// thread accumulates an 8 x 8 register tile (8 fc rows x 8 columns of one
// output row): 16 shared loads feed 64 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBB = 8;    // fc rows per block: a thread's accumulator rows
constexpr int kWB = 16;   // output rows per block: one per 16-thread group
constexpr int kMT = 128;  // output columns per block: 16 groups of 8
constexpr int kTC = 32;   // expansion columns (t) per chunk

__device__ __forceinline__ void fma8(float (&acc)[8], float a, const float (&c)[8]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) acc[q] = fmaf(a, c[q], acc[q]);
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__global__ void __launch_bounds__(kThreads, 2) fused_decode_kernel(
    const float* __restrict__ fc, const float* __restrict__ k4,
    const float* __restrict__ bias, const float* __restrict__ kcat,
    void* __restrict__ out, int out_bf16,
    int B, int J, int S, int W_pad, int TpC, int ktaps, int TM) {
  extern __shared__ float4 smem4[];
  const int R = kWB + ktaps - 1;  // expansion rows: the block's rows + halo
  float* fc_s = reinterpret_cast<float*>(smem4);  // J x kBB, j-major
  float* e_s = fc_s + J * kBB;                     // R x kTC x kBB
  float* kc_s = e_s + R * kTC * kBB;               // kTC x kMT
  const int tid = threadIdx.x;
  const int rg = tid / 16;  // output row w0 + rg
  const int cg = tid % 16;  // output columns m0 + 8 cg + [0, 8)
  const int n_mt = (TM + kMT - 1) / kMT;
  const int b0 = blockIdx.x * kBB;
  const int w0 = blockIdx.y * kWB;
  const int s = blockIdx.z / n_mt;
  const int m0 = (blockIdx.z % n_mt) * kMT;
  const int wlo = w0 - (ktaps - 1);  // expansion row held in e_s row 0
  const long long kstride = (long long)S * W_pad * TpC;  // K4 row j stride
  const long long kcat_row = (long long)ktaps * TM;

  for (int i = tid; i < J * kBB; i += kThreads) {
    const int j = i / kBB;
    const int b = i - j * kBB;
    fc_s[i] = (b0 + b < B) ? fc[(long long)(b0 + b) * J + j] : 0.f;
  }
  float acc[kBB][8];
#pragma unroll
  for (int b = 0; b < kBB; ++b)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[b][q] = 0.f;

  for (int t0 = 0; t0 < TpC; t0 += kTC) {
    __syncthreads();  // fc_s is written; the previous chunk's e_s readers are done
    // stage 1: e_s[r][tt][:] = relu(fc @ K4[:, s, wlo + r, t0 + tt] + bias)
    for (int p = tid; p < R * kTC; p += kThreads) {
      const int r = p / kTC;
      const int w = wlo + r;
      const int t = t0 + (p - r * kTC);
      float ea[kBB];
#pragma unroll
      for (int b = 0; b < kBB; ++b) ea[b] = 0.f;
      if (w >= 0 && w < W_pad && t < TpC) {
        const long long col = ((long long)s * W_pad + w) * TpC + t;
        const float* kp = k4 + col;
#pragma unroll 8
        for (int j = 0; j < J; ++j) {
          const float kv = __ldg(kp + j * kstride);
          float f[kBB];
          load8(f, fc_s + j * kBB);
#pragma unroll
          for (int b = 0; b < kBB; ++b) ea[b] = fmaf(f[b], kv, ea[b]);
        }
        const float bv = __ldg(bias + col);
#pragma unroll
        for (int b = 0; b < kBB; ++b) ea[b] = fmaxf(ea[b] + bv, 0.f);
      }
      float4* dst = reinterpret_cast<float4*>(e_s + p * kBB);
      dst[0] = make_float4(ea[0], ea[1], ea[2], ea[3]);
      dst[1] = make_float4(ea[4], ea[5], ea[6], ea[7]);
    }
    // stage 2: out[wo] += e[wo - i] @ Kcat[t0:t0+kTC, i, m0:m0+kMT] per tap
    for (int i = 0; i < ktaps; ++i) {
      __syncthreads();  // e_s is complete; the previous tap's kc_s readers are done
      for (int q = tid; q < kTC * kMT; q += kThreads) {
        const int tt = q / kMT;
        const int t = t0 + tt;
        const int m = m0 + (q - tt * kMT);
        kc_s[q] = (t < TpC && m < TM) ? __ldg(kcat + t * kcat_row + i * TM + m) : 0.f;
      }
      __syncthreads();
      const float* ea = e_s + (rg + ktaps - 1 - i) * kTC * kBB;  // row w0 + rg - i
      const float* kc = kc_s + cg * 8;
#pragma unroll 4
      for (int tt = 0; tt < kTC; ++tt) {
        float a[kBB], c[8];
        load8(a, ea + tt * kBB);
        load8(c, kc + tt * kMT);
#pragma unroll
        for (int b = 0; b < kBB; ++b) fma8(acc[b], a[b], c);
      }
    }
  }
  // store (B, S, W_pad, TM) in the output dtype
  const int wo = w0 + rg;
  if (wo >= W_pad) return;
#pragma unroll
  for (int b = 0; b < kBB; ++b) {
    if (b0 + b >= B) continue;
    const long long o = (((long long)(b0 + b) * S + s) * W_pad + wo) * TM;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int m = m0 + cg * 8 + q;
      if (m >= TM) continue;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o + m] = __float2bfloat16(acc[b][q]);
      else
        static_cast<float*>(out)[o + m] = acc[b][q];
    }
  }
}

}  // namespace

extern "C" int fused_decode_launch(const void* fc, const void* k4, const void* bias,
                                   const void* kcat, void* out, int out_bf16, int B,
                                   int J, int S, int W_pad, int TpC, int ktaps, int TM,
                                   void* stream) {
  if (B < 1 || J < 1 || S < 1 || W_pad < 1 || TpC < 1 || ktaps < 1 || TM < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)J * kBB + (size_t)(kWB + ktaps - 1) * kTC * kBB + kTC * kMT);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_mt = (TM + kMT - 1) / kMT;
  dim3 grid((B + kBB - 1) / kBB, (W_pad + kWB - 1) / kWB, S * n_mt);
  fused_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fc), static_cast<const float*>(k4),
      static_cast<const float*>(bias), static_cast<const float*>(kcat), out, out_bf16, B, J,
      S, W_pad, TpC, ktaps, TM);
  return (int)cudaGetLastError();
}
