#!/usr/bin/env python3
"""Where the band decode kernel's time goes, on one CUDA GPU (no JAX).

    python3 tools/torch_band_study.py [--out FILE]

Two parts, at one multires4096 track (``chip_smoke.BAND_SHAPE``: rows 196 x
505, depth 16 x 50, 1500 columns), the prepared operand:

1. the kernel (``csrc/band_decode.cu``) and three copies of it, each built
   from the checkout's source with one part taken out: ``no_stores`` (the
   output is not written), ``no_loads`` (z is loaded for the first tile
   only), ``no_products`` (no wgmma); CUDA events, median of 5 rounds of 10
   calls. The copies' outputs are wrong by design; only the base is checked.
2. the output's store pattern alone, in a small kernel of its own: each
   block walks 64-row tiles as the kernel does, optionally reading the tile
   of z (bf16, 16-byte loads), then writes the tile in column pieces of P
   floats, two warpgroups taking alternate pieces, either one row piece an
   instruction (the kernel's order) or the wgmma fragment order (8 rows'
   32 bytes an instruction), evict-first stores (st.global.cs) as the
   kernel's; ``torch.zero_`` of the same output beside it.

The builds go to ``build/band_study/`` (git-ignored). Prints one line a
measurement and the card's nvidia-smi line; ``--out`` writes them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch import kernels  # noqa: E402
from convsep_tpu_torch.models.decoder_band_cuda import (  # noqa: E402
    band_decode_wmajor_plain,
    band_operand,
    band_plan,
)

# each copy: (text in csrc/band_decode.cu, what replaces it)
CUTS = {
    "no_stores": ("      const long long row0 = r0 + 16 * warp + 8 * hr;",
                  "      if (a.M > 0) continue;\n      const long long row0 = r0 + 16 * warp + 8 * hr;"),
    "no_loads": ("if (rt + (int)gridDim.x < a.row_tiles) fetch(", "if (a.M < 0) fetch("),
    "no_products": ("      wg_mma(d, desc(", "      if (a.M < 0) wg_mma(d, desc("),
}

STORE_PATTERN = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// out (M, NC) f32 in 64-row tiles; per tile: read z's tile (reads != 0),
// then write column pieces of P floats, warpgroup wg taking pieces wg, wg + 2, ...
// order 0: one row piece an instruction; 1: the wgmma fragment order
__global__ void k(float* out, const uint4* z, long long M, int NC, int K, int P, int tiles,
                  int reads, int order) {
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) & 3, lane = tid & 31;
  unsigned acc = 0;
  for (int rt = blockIdx.x; rt < tiles; rt += gridDim.x) {
    const long long r0 = (long long)rt * 64;
    if (reads)
      for (int i = tid; i < 64 * K / 8; i += 256) { const uint4 v = z[r0 * K / 8 + i]; acc += v.x ^ v.w; }
    for (int pc = wg; pc < (NC + P - 1) / P; pc += 2) {
      const int c0 = pc * P, cols = min(P, NC - c0);
      for (int rr = 0; rr < 16; ++rr) {
        const int r = order ? 16 * warp + (lane >> 2) + 8 * (rr & 1) : 16 * warp + rr;
        if (order && rr > 1) break;
        if (r0 + r >= M) continue;
        float* o = out + (r0 + r) * NC + c0;
        if (order) {
          for (int c = 2 * (lane & 3); c + 1 < cols; c += 8)
            __stcs(reinterpret_cast<float2*>(o + c), make_float2(1.f, (float)acc));
        } else {
          for (int c = 2 * lane; c + 1 < cols; c += 64)
            __stcs(reinterpret_cast<float2*>(o + c), make_float2(1.f, (float)acc));
        }
      }
    }
  }
}
extern "C" int run(void* out, const void* z, long long M, int NC, int K, int P, int grid,
                   int reads, int order) {
  k<<<grid, 256>>>((float*)out, (const uint4*)z, M, NC, K, P, (int)((M + 63) / 64), reads, order);
  return (int)cudaGetLastError();
}
'''


def build(name: str, text: str, out_dir: Path) -> subprocess.Popen:
    cu = out_dir / f"{name}.cu"
    cu.write_text(text)
    return subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I",
                             str(kernels.CSRC), "-o", str(out_dir / f"{name}.so"), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(path: Path, name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_band_study: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "band_study"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (kernels.CSRC / "band_decode.cu").read_text()
    texts = {"kernel": src}
    for name, (old, new) in CUTS.items():
        if old not in src:
            raise SystemExit(f"torch_band_study: {name}: the kernel's source changed; update CUTS")
        texts[name] = src.replace(old, new)
    procs = {name: build(name, text, out_dir) for name, text in texts.items()}
    procs["store_pattern"] = build("store_pattern", STORE_PATTERN, out_dir)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"torch_band_study: nvcc failed for {name}:\n{log}")

    card = cs.smi_line()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    N, Tp, W, C2, kh, I = cs.BAND_SHAPE
    T = Tp + kh - 1
    M = N * W
    z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=dev)).to(torch.bfloat16)
    op = band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=dev), T)
    plan = band_plan(M, Tp, C2, kh, I, torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty(N, W, T * I, device=dev)
    res: dict = {"card": card}
    for name in texts:
        fn = bind(out_dir / f"{name}.so", "band_decode_launch",
                  kernels._SIGNATURES["band_decode_launch"])

        def call():
            code = fn(z.data_ptr(), op.packed.data_ptr(), out.data_ptr(), M, Tp, C2, kh, I,
                      plan.grid, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{name}: cudaError_t {code}")

        call()
        torch.cuda.synchronize()
        if name == "kernel":
            want = band_decode_wmajor_plain(z, op)
            err = (out - want).abs().max().item()
            if not err <= cs.TOL_BAND * want.abs().max().item():
                raise SystemExit(f"torch_band_study: the kernel disagrees with plain: {err}")
            del want
        res[name] = cs.cuda_ms(call)
        print(f"band decode, {name}: {res[name]:.4f} ms | {card}", flush=True)

    run = bind(out_dir / "store_pattern.so", "run",
               (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int))
    flat = out.view(M, T * I)
    zf = torch.zeros(M + 64, Tp * C2, device=dev, dtype=torch.bfloat16)  # a tile past the end
    res["zero_"] = cs.cuda_ms(lambda: flat.zero_())
    print(f"store pattern, torch zero_ of the output: {res['zero_']:.4f} ms | {card}", flush=True)
    for reads in (0, 1):
        for order in (0, 1):
            for P in (I, 5 * I, T * I):
                key = f"pieces {P}, {'with' if reads else 'without'} z reads, " \
                      f"{'fragment order' if order else 'a row an instruction'}"
                res[key] = cs.cuda_ms(lambda: run(flat.data_ptr(), zf.data_ptr(), M, T * I,
                                                  Tp * C2, P, plan.grid, reads, order))
                print(f"store pattern, {key}: {res[key]:.4f} ms | {card}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
