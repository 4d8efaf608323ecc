#!/usr/bin/env python3
"""Where a direct Wiener+iSTFT cluster kernel's time goes, on one CUDA
GPU (no JAX): copies of it with one part cut out each.

    python3 tools/torch_wiener_cluster_study.py [--route dit|mixed] [--out FILE]
                                                [--variants NAME ...]

``--route dit`` (the default): at the reference kernel's 16 384 points
(hop 2048) and 32 768 (hop 4096), 4 stems of a 30 s track
(``chip_smoke.W16384_NF``, ``W32768_NF``), bf16 y, it times by CUDA events
(``chip_smoke.cuda_ms``) copies of ``csrc/wiener_istft.cu`` built from the
checkout's sources with one change to ``wiener_cluster_dit_block`` each:
``base`` (none), ``no_mask`` (no bin is loaded or masked: no y, mixture or
mask; the points are still put), ``no_gather`` (no overlap-add: nothing
read across the cluster, no stores), ``no_transform`` (no Fft<13>, no
twiddle; the puts and the cluster barriers stay) and ``prefetch`` (the
next round's bins asked into L2, ``prefetch.global.L2``, before the
gather). ``--route mixed``: the same cuts (but ``prefetch``) of
``wiener_cluster_mixed_block`` at W 10 000 (hop 2500) and 20 000 (hop
5000), ``no_transform`` cutting ``mixed_fft``. ``base`` and ``prefetch``
are held to the plain version; the others are wrong by design. The
kernel on its route, Bluestein's forced, the masked chain and
``torch.istft`` are timed by ``chip_smoke.py`` phase 3c, not here.

Each change replaces an exact line of the sources: a source that no
longer holds it stops the tool with the variant's name. It prints each
copy's ptxas lines for the route's kernel (registers, stack, spills) and
the card's nvidia-smi line. The copies go to
``build/wiener_cluster_study/`` (git-ignored), one ``nvcc`` a copy, all at
once. ``--out`` writes the measurements as JSON.
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
from convsep_tpu_torch.dsp.cuda import fft_plan as fp  # noqa: E402

BODY = "wiener_common.cuh"
MASK = "      masked_bins(ab, a, pl, N, f, k0, D::T);"
GATHER = """    cluster_pair_gather([&](int t) { return D::point(buf, a.tw, t); }, carry0, carry1, a, pl,
                        N, f, cols, u0, ncols, j_end);"""
TRANSFORM = """    F::run(v, buf, tws, j, 0);
    if (rank) {"""
# the next round's bins asked into L2 before the gather (prefetch.global.L2)
PREFETCH = """    if (f + 1 >= 0 && f + 1 < a.nf) {
      const long long bins = N / 2 + 1, frame = (long long)pl.n * a.nf + f + 1;
      const long long mix = frame * (a.ny ? N / 2 : bins) + k0;
      const long long y0 = ((long long)pl.n * a.S * a.nf + f + 1) * bins + k0;
      const char* yb = static_cast<const char*>(a.y);
      const int size = a.y_bf16 ? 2 : 4;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        for (int s = 0; s < a.S; ++s)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              yb + (y0 + s * (long long)a.nf * bins + i * D::T) * size));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.re + mix + i * D::T));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(a.im + mix + i * D::T));
      }
    }
"""
MIXED_MASK = "        masked_bins<K, KF, true>(ab, a, pl, N, f, k0, T, k_end);"
MIXED_GATHER = """      cluster_pair_gather([&](int t) { return D::point(buf, a.tw, n, t); }, carry0, carry1, a,
                          pl, N, pl.j0 - (k - 1) + r, cols, u0, max(0, min(cols, a.hop - u0)),
                          min(pl.j0 + a.rows, a.nf + k - 1));"""
MIXED_TRANSFORM = """    mixed_fft(buf, tws, n, sched);
    if (rank) {"""
FAKE_MASK = ("      for (int i = 0; i < K; ++i)\n"
             "        ab[i] = make_float4(1e-3f * i, 0.f, 0.f, 0.f);")
# each route's copies: [(text in csrc/wiener_common.cuh or fft_common.cuh, what replaces it)]
CUTS = {
    "dit": {
        "base": [],
        "no_mask": [(MASK, FAKE_MASK)],
        "no_gather": [(GATHER, "    if (a.hop < 0)\n" + GATHER)],
        "no_transform": [(TRANSFORM,
                          "    if (M < 0) F::run(v, buf, tws, j, 0);\n    if (rank) {")],
        "prefetch": [(GATHER, PREFETCH + GATHER)],
    },
    "mixed": {
        "base": [],
        "no_mask": [(MIXED_MASK, FAKE_MASK)],
        "no_gather": [(MIXED_GATHER, "    if (a.hop < 0)\n" + MIXED_GATHER)],
        "no_transform": [(MIXED_TRANSFORM,
                          "    if (n < 0) mixed_fft(buf, tws, n, sched);\n    if (rank) {")],
    },
}
CHECKED = ("base", "prefetch")
KERNEL = {"dit": "wiener_cluster_dit_kernel", "mixed": "wiener_cluster_mixed_kernel"}
# the split's and Bluestein's launchers live in other sources; a copy
# serves only the cluster routes
STUBS = """
namespace wiener {
cudaError_t launch_split(int, int, const Args&, const float2*, unsigned, int, int, cudaStream_t) {
  return cudaErrorInvalidValue;
}
cudaError_t launch_bluestein(int, bool, const Args&, const float2*, const float2*, int, unsigned,
                             int, int, cudaStream_t) {
  return cudaErrorInvalidValue;
}
}  // namespace wiener
"""
SHAPES = {"dit": ((16384, 2048, cs.W16384_NF), (32768, 4096, cs.W32768_NF)),
          "mixed": ((10000, 2500, cs.W10000_NF), (20000, 5000, cs.W20000_NF))}


def build(route: str, names: list[str]) -> dict[str, ctypes.CDLL]:
    out = ROOT / "build" / "wiener_cluster_study" / route
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(exist_ok=True)
        text = {f: (kernels.CSRC / f).read_text() for f in (BODY, "fft_common.cuh")}
        for old, new in CUTS[route][name]:
            where = [f for f, t in text.items() if old in t]
            if not where:
                raise RuntimeError(f"{name}: {old!r} is in neither source")
            text[where[0]] = text[where[0]].replace(old, new, 1)
        for f, t in text.items():
            (d / f).write_text(t)
        (d / "wiener_istft.cu").write_text((kernels.CSRC / "wiener_istft.cu").read_text() + STUBS)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-shared",
               str(d / "wiener_istft.cu"), "-o", str(d / "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if KERNEL[route] in line and "Compiling" in line:
                for follow in lines[i + 1:i + 4]:
                    print(f"  ptxas {name} {line.split()[-1][-40:]}: {follow.strip()}",
                          flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for entry in ("wiener_cluster_dit_launch", "wiener_cluster_mixed_launch"):
            getattr(lib, entry).argtypes = list(kernels._SIGNATURES[entry])
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", choices=list(CUTS), default="dit")
    ap.add_argument("--out")
    ap.add_argument("--variants", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain

    smi = cs.smi_line()
    print(smi, flush=True)
    libs = build(args.route, args.variants or list(CUTS[args.route]))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"card": smi, "route": args.route}
    for nfft, hop, nf in SHAPES[args.route]:
        key = f"W {nfft}"
        w, L, y, re, im = cs.wiener_inputs(nfft, hop, nf, 4, dev, gen)
        want = wiener_istft_plain(y, re, im, w, hop, L)
        plan = fp.wiener_plan(1, 4, nf, nfft, hop)
        row = {"plan": plan.__dict__}
        re, im = re.contiguous(), im.contiguous()  # the copies read rows of nfft/2 + 1 bins
        args_ = (y.data_ptr(), 1, re.data_ptr(), im.data_ptr(), None)
        win_n, inv_norm = fp.synthesis_tables(w, nfft, hop, nf, str(dev))
        mixed = args.route == "mixed"
        tw = (fp.dft_table if mixed else fp.twiddles)(nfft, str(dev))
        sched = (fp.mixed_schedule(fp.mixed_radices(nfft // plan.cluster)),) if mixed else ()
        out = torch.empty(1, 4, L, device=dev)
        for name, vlib in libs.items():
            def run(vlib=vlib):
                launch = (vlib.wiener_cluster_mixed_launch if mixed
                          else vlib.wiener_cluster_dit_launch)
                kernels.check(launch(
                    *args_, win_n.data_ptr(), inv_norm.data_ptr(), tw.data_ptr(),
                    out.data_ptr(), 0, 1, 4, nf, nfft, hop, L, plan.rounds, *sched, 0,
                    ctypes.c_float(1e-8), 0, None, torch.cuda.current_stream().cuda_stream),
                    name)
            run()
            torch.cuda.synchronize()
            if name in CHECKED:
                err = (out.reshape(want.shape) - want).abs().max().item()
                if not err <= cs.TOL_WIENER_F32:
                    raise AssertionError(f"{key} {name}: {err} > {cs.TOL_WIENER_F32}")
            row[name] = {"ms": cs.cuda_ms(run)}
        res[key] = row
        print(f"{key}: " + "; ".join(f"{k} {v['ms']:.4f} ms" for k, v in row.items()
                                     if isinstance(v, dict) and "ms" in v)
              + f" | {smi}", flush=True)
        del y, re, im, want, out
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
