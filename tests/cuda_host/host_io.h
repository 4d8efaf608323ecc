// File I/O and the forward kernels' output rows for the host emulations
// beside this file (split_stft.cpp, bluestein_stft.cpp, split_istft.cpp, ...).
#pragma once
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "cuda_runtime.h"

// DIR/NAME's bytes; exits with code 2 if it cannot be read
inline std::vector<char> slurp(const char* dir, const char* name) {
  char path[1024];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = fopen(path, "rb");
  if (!f) exit(2);
  fseek(f, 0, SEEK_END);
  std::vector<char> v(ftell(f));
  fseek(f, 0, SEEK_SET);
  if (fread(v.data(), 1, v.size(), f) != v.size()) exit(2);
  fclose(f);
  return v;
}

// writes the given arrays one after the other to DIR/out.bin
template <class T>
void spill(const char* dir, std::initializer_list<const std::vector<T>*> parts) {
  char path[1024];
  snprintf(path, sizeof path, "%s/out.bin", dir);
  FILE* f = fopen(path, "wb");
  for (const auto* p : parts) fwrite(p->data(), sizeof(T), p->size(), f);
  fclose(f);
}

struct FullRows {  // stft_dft.cu's output rows
  float* re;
  float* im;
  int bins;
  void operator()(long long row, bool has_b, int k, float2 a, float2 b) const {
    const long long o = row * bins + k;
    re[o] = a.x;
    im[o] = a.y;
    if (has_b) {
      re[o + bins] = b.x;
      im[o + bins] = b.y;
    }
  }
};
