#!/usr/bin/env python3
"""Where the streamed band decode's time goes, on one CUDA GPU (no JAX).

    python3 tools/torch_band_stream_study.py [--out FILE] [--variants NAME ...]

At the two shapes of ``chip_smoke.BAND_STREAM_SHAPES`` (multires4096's
rows 196 x 505, Tp 16, kh 15 at C2 128, I 64 and at C2 100, I 100) it times
``csrc/band_stream.cu`` and copies of it, each built from the checkout's
source with one change (the widths 64 and 104 only):

* ``base``: the source as it is (checked against the plain version);
* ``no_stores``: the output is not written;
* ``no_loads``: the producer issues no copy (the ring's barriers still
  turn; z's rows are 16-byte aligned at both shapes, so all copies are
  TMA's);
* ``no_products``: no wgmma;
* ``no_multicast``: each block of a cluster loads every slab of taps
  itself, none multicast to its peer;
* ``acc64``: groups of column blocks with G·N <= 128 (64 accumulators a
  thread) in place of 256;
* ``maxnreg``: the producer warpgroup gives registers to the consumers
  (``setmaxnreg`` 40 / 232);
* ``no_fold``: deep bands do not fold their accumulators into float32
  sums (one wgmma chain a column block).

Then, at a deep band (``DEEP``: 130 rows, Tp 16, C2 1000, kh 15, I 64;
15 000 depths a column block), ``base`` and ``no_fold``'s error against
the plain version and against the same bf16 operands' product in float64.

The copies' outputs are wrong by design except ``base``,
``no_multicast``, ``acc64``, ``maxnreg`` and ``no_fold``, which are checked
too. Each copy's clusters at once (``band_stream_clusters``) are printed. CUDA events, median of 5 rounds of 10
calls. The builds go to ``build/band_stream_study/`` (git-ignored), one
``nvcc`` a copy, all at once; each copy's ptxas lines (registers, spills,
warnings) are printed. Prints one line a measurement and the card's
nvidia-smi line; ``--out`` writes them as JSON.
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
from convsep_tpu_torch.models import decoder_band_cuda as dbc  # noqa: E402

HEADER = "band_stream.cuh"
DEEP = (1, 16, 130, 1000, 15, 64)  # (N, Tp, W, C2, kh, I)
# each copy: [(text in csrc/band_stream.cuh or band_stream.cu, what replaces it)]
CUTS = {
    "base": [],
    "no_stores": [("          if (t > t1 || cols <= 0) continue;",
                   "          if (t > t1 || cols <= 0 || a.M > 0) continue;")],
    "no_loads": [("mbar_expect(&full[stage], bytes);", "mbar_expect(&full[stage], 0);"),
                 ("if (z_tma) tma_load(", "if (z_tma && a.M < 0) tma_load("),
                 ("if (k++ % kCluster == rank)", "if (k++ % kCluster == rank && a.M < 0)")],
    "no_multicast": [("if (k++ % kCluster == rank)\n              tma_multicast(",
                      "if (k++ >= 0)\n              tma_load(")],
    "no_products": [("          for (int kk = 0; kk < kSlab / 16; ++kk)",
                     "          for (int kk = 0; kk < (a.M < 0 ? kSlab / 16 : 0); ++kk)")],
    "acc64": [("return n >= 256 ? 1 : (256 / n > 4 ? 4 : 256 / n);",
               "return n >= 128 ? 1 : (128 / n > 4 ? 4 : 128 / n);")],
    "no_fold": [("  p.fold = most > band_stream::kFold;", "  p.fold = false;")],
    "maxnreg": [("    const int p = tid;  // 0 .. 127",
                 "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 40;\\n\");\n"
                 "    const int p = tid;  // 0 .. 127"),
                ("  const int cw = wg - 1;",
                 "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\\n\");\n"
                 "  const int cw = wg - 1;")],
}
CHECKED = ("base", "no_multicast", "acc64", "maxnreg", "no_fold")
# the launcher's own file with only the widths timed here
DISPATCH = '''
namespace band_stream {
cudaError_t launch_n64(int n, const Maps& m, const Args& a, int grid, cudaStream_t s, int* act) {
  return n == 64 ? launch<64>(m, a, grid, s, act) : cudaErrorInvalidValue;
}
cudaError_t launch_n128(int n, const Maps& m, const Args& a, int grid, cudaStream_t s, int* act) {
  return n == 104 ? launch<104>(m, a, grid, s, act) : cudaErrorInvalidValue;
}
cudaError_t launch_n192(int, const Maps&, const Args&, int, cudaStream_t, int*) {
  return cudaErrorInvalidValue;
}
cudaError_t launch_n256(int, const Maps&, const Args&, int, cudaStream_t, int*) {
  return cudaErrorInvalidValue;
}
}  // namespace band_stream
'''


def build(names: list[str]) -> dict[str, ctypes.CDLL]:
    out = ROOT / "build" / "band_stream_study"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(exist_ok=True)
        text = {HEADER: (kernels.CSRC / HEADER).read_text(),
                "band_stream.cu": (kernels.CSRC / "band_stream.cu").read_text().replace(
                    "BAND_STREAM_INSTANCES(launch_n64, 0)", DISPATCH)}
        for old, new in CUTS[name]:
            where = [f for f, t in text.items() if old in t]
            if not where:
                raise RuntimeError(f"{name}: {old!r} is in neither source")
            text[where[0]] = text[where[0]].replace(old, new)
        for f, t in text.items():
            (d / f).write_text(t)
        (d / "wgmma_bf16.cuh").write_text((kernels.CSRC / "wgmma_bf16.cuh").read_text())
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-shared",
               str(d / "band_stream.cu"), "-o", str(d / "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "band_stream_kernel" in line and "Compiling" not in line or "Used" in line \
                    or "arning" in line:
                print(f"  ptxas {name}: {line.strip()[-150:]}", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.band_stream_launch.argtypes = list(kernels._SIGNATURES["band_stream_launch"])
        lib.band_stream_launch.restype = ctypes.c_int
        for n in (64, 104):
            active = ctypes.c_int(0)
            kernels.check(lib.band_stream_clusters(n, ctypes.byref(active)), "band_stream study")
            print(f"  {name}: N {n}, {active.value} clusters at once", flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--variants", nargs="*", default=list(CUTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = cs.smi_line()
    print(smi, flush=True)
    libs = build(args.variants)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {"card": smi}
    for N, Tp, W, C2, kh, I in cs.BAND_STREAM_SHAPES:
        T = Tp + kh - 1
        M = N * W
        key = f"C2 {C2} I {I}"
        z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=dev)).to(torch.bfloat16)
        op = dbc.band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=dev), T)
        want = dbc.band_decode_wmajor_plain(z, op)
        scale = want.abs().max().item()
        plan = dbc.band_stream_plan(M, Tp, C2, kh, I, sms)
        out = torch.empty_like(want)
        row = {}
        for name, lib in libs.items():
            def run(lib=lib):
                code = lib.band_stream_launch(z.data_ptr(), op.stream.data_ptr(), out.data_ptr(),
                                              M, Tp, C2, kh, I, plan.grid,
                                              torch.cuda.current_stream().cuda_stream)
                kernels.check(code, "band_stream study")
            run()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item() / scale if name in CHECKED else None
            if err is not None and not err <= cs.TOL_BAND:
                raise AssertionError(f"{key} {name}: {err} x max|out| > {cs.TOL_BAND}")
            ms = cs.cuda_ms(run)
            row[name] = {"ms": ms, "err": err}
            print(f"{key} {name}: {ms:.4f} ms" + (f", err {err:.2e} x max|out|" if err is not None
                                                   else "") + f" | {smi}", flush=True)
        res[key] = row
        del z, op, want, out
        torch.cuda.empty_cache()
    N, Tp, W, C2, kh, I = DEEP
    T, M = Tp + kh - 1, N * W
    z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=dev)).to(torch.bfloat16)
    op = dbc.band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=dev), T)
    want = dbc.band_decode_wmajor_plain(z, op)
    exact = (z.double().reshape(M, -1) @ op.band.to(torch.bfloat16).double().reshape(Tp * C2, -1))
    plan = dbc.band_stream_plan(M, Tp, C2, kh, I, sms)
    out = torch.empty_like(want)
    for name in ("base", "no_fold"):
        if name not in libs:
            continue
        code = libs[name].band_stream_launch(z.data_ptr(), op.stream.data_ptr(), out.data_ptr(),
                                             M, Tp, C2, kh, I, plan.grid,
                                             torch.cuda.current_stream().cuda_stream)
        kernels.check(code, "band_stream study")
        torch.cuda.synchronize()
        peak = exact.abs().max().item()
        row = {"vs_plain": (out - want).abs().max().item() / peak,
               "vs_float64": (out.double().reshape(M, -1) - exact).abs().max().item() / peak,
               "plain_vs_float64": (want.double().reshape(M, -1) - exact).abs().max().item() / peak}
        res[f"deep C2 {C2} I {I} {name}"] = row
        print(f"deep C2 {C2} I {I} ({Tp * C2} depths) {name}: err {row['vs_plain']:.3e} x max|out| "
              f"against plain, {row['vs_float64']:.3e} against float64 (plain "
              f"{row['plain_vs_float64']:.3e})", flush=True)
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
