// A host stand-in for <cuda_bf16.h>: the bfloat16 storage type and its
// exact widening to float, for the device code of
// convsep_tpu_torch/csrc/wiener_common.cuh on CPU threads (cuda_runtime.h
// beside this file).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = uint32_t(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
