#!/usr/bin/env python3
"""The Wiener+iSTFT's mixed cluster A/B on one CUDA GPU (no JAX): at every
size it takes (``fft_plan.wiener_mixed_factors``, 149 even sizes from 8232
to 32 400), at the 78 on clusters of 2 or 4 whose block size n has a
factor 7 (``--radix7``), at the 13 on clusters of 3, 5 or 6 (``--new``),
or at the sizes given, 4 stems of one 30 s track at hop
nfft / 4 (nfft / 5, / 3 or / 7 where 4 does not divide it), bf16 y, on the
mixed cluster forced (``wiener_cluster_mixed_pallas``, ``fft_plan.
wiener_cluster_mixed_plan``: "auto"'s route where the size won) against
Bluestein's cluster forced (``wiener_bluestein_cluster_pallas``) and
against the masked chain "auto" takes where it does not take the kernel
(the float32 mask, then ``istft_matmul``'s own "auto": the factored
products at these sizes), on the same random spectra and magnitudes; then
(with no sizes, ``--radix7`` or ``--new``) the same A/B against the chain at the
powers of two's shapes in ``WIENER_CLUSTER_WON`` (16 384, hop 2048 and
32 768, hop 4096: the direct cluster against the mask and the iSTFT's
direct cluster).

    python3 tools/torch_wiener_mixed_ab.py [--out FILE] [--radix7 | --new] [nfft ...]

Prints the card's name and power limit, builds the kernels and prints
ptxas's registers and stack frames of the
Wiener cluster kernels and the clusters the card holds at once for the
mixed kernel at C 2 to 6 (``wiener_cluster_mixed_launch`` with
``active``) beside ``fft_plan.CLUSTERS_AT_ONCE``, then a line a size: the
kernel's, Bluestein's and the chain's
card ms (CUDA events; kernel and Bluestein in turns: mixed, Bluestein,
Bluestein, mixed, the median of each) and both kernels' largest error
against the float64 synthesis over its peak. A chain whose products do not
fit the card is left out (null). Fails if either kernel is off by more
than 2e-6 × the peak. ``--out`` writes every number to FILE as JSON. It
prints the sizes the mixed cluster won against Bluestein's
(``fft_plan.WIENER_MIXED_WON``'s candidates) and the (nfft, hop) at which
the kernel won against the chain (``ct_istft_kernel.WIENER_CLUSTER_WON``'s).
Run it from the root of the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

SECONDS = 30      # one track
SOURCES = 4       # stems
TOL = 2e-6        # × max|out| against the float64 synthesis (chip_smoke.TOL_CLUSTER_F32)
DIT_SHAPES = ((16384, 2048), (32768, 4096))


def median(t: list[float]) -> float:
    t = sorted(t)
    return t[len(t) // 2] if len(t) % 2 else (t[len(t) // 2 - 1] + t[len(t) // 2]) / 2


def main() -> int:
    import torch

    import chip_smoke as cs
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import (
        wiener_bluestein_cluster_pallas,
        wiener_cluster_mixed_pallas,
        wiener_istft,
    )
    from convsep_tpu_torch.dsp.stft import num_frames
    from convsep_tpu_torch.dsp.windows import sinebell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    pick = ap.add_mutually_exclusive_group()
    pick.add_argument("--radix7", action="store_true",
                      help="only the sizes on C 2 or 4 whose block size has a factor 7")
    pick.add_argument("--new", action="store_true",
                      help="only the sizes on clusters of 3, 5 or 6 blocks")
    ap.add_argument("sizes", nargs="*", type=int)
    args = ap.parse_args()
    if cs.setup():
        return 1
    card = cs.smi_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):  # nvcc's ptxas lines
        lib = kernels.build(verbose=True)
    kernels.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {}
    for m in re.finditer(r"Function properties for (\S*wiener_cluster\S*)\n\s+(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*Used "
                         r"(\d+) registers", buf.getvalue()):
        ptxas[m[1]] = {"stack": int(m[2]), "spill_stores": int(m[3]), "spill_loads": int(m[4]),
                       "registers": int(m[5])}
        print(f"ptxas {m[1]}: {m[2]} bytes stack, {m[3]}/{m[4]} bytes spilled, {m[5]} "
              "registers")

    occupancy = {}
    for nfft in (10000, 22050, 20000, 30870, 30618):  # C 2, 3, 4, 5, 6
        hop = nfft // next(k for k in (4, 5, 3) if nfft % k == 0)
        plan = fp.wiener_cluster_mixed_plan(1, SOURCES, 100, nfft, hop)
        active = ctypes.c_int(0)
        kernels.check(kernels.library().wiener_cluster_mixed_launch(
            None, 0, None, None, None, None, None, None, None, 0, 1, SOURCES, 100, nfft,
            hop, 1, plan.rounds, fp.mixed_schedule(fp.mixed_radices(nfft // plan.cluster)),
            0, ctypes.c_float(1e-8), 0, ctypes.byref(active), None), "wiener_cluster_mixed")
        occupancy[plan.cluster] = active.value
        print(f"clusters of {plan.cluster} at once (wiener_cluster_mixed_kernel, W {nfft}): the "
              f"card's {active.value}, CLUSTERS_AT_ONCE {fp.CLUSTERS_AT_ONCE[plan.cluster]}",
              flush=True)

    sizes = args.sizes or [
        n for n in range(fp.MAX_NFFT + 2, fp.WIENER_CLUSTER_NFFT + 1, 2)
        if fp.wiener_mixed_factors(n)
        and (not args.radix7 or (fp.mixed_factors(n)[0] in (2, 4)
                                 and fp.mixed_factors(n)[1] % 7 == 0))
        and (not args.new or fp.mixed_factors(n)[0] in (3, 5, 6))]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, dit_rows = {}, {}
    shapes = [(n, n // next(k for k in (4, 5, 3, 7, 2) if n % k == 0), True) for n in sizes]
    shapes += [(n, hop, False) for n, hop in DIT_SHAPES
               if not (args.sizes or args.radix7 or args.new)]
    for nfft, hop, mixed in shapes:
        nf = num_frames(SECONDS * cs.FS, hop)
        L = (nf - 2) * hop
        w = sinebell(nfft)
        bins = nfft // 2 + 1
        re_ = torch.randn(1, nf, bins, generator=gen, device=device)
        im_ = torch.randn(1, nf, bins, generator=gen, device=device)
        y = torch.randn(1, SOURCES, nf, bins, generator=gen, device=device).abs()
        y[..., : nf // 3, :8] = 0.0  # dead bins: the eps shortfall paths
        y = y.to(torch.bfloat16)
        plan = (fp.wiener_cluster_mixed_plan if mixed else fp.wiener_plan)(1, SOURCES, nf, nfft,
                                                                           hop)
        row = {"route": plan.route, "c": plan.cluster, "hop": hop, "nf": nf,
               "rounds": plan.rounds, "clusters": plan.blocks // plan.cluster}
        want = cs.wiener64(y, re_, im_, w, hop, L)
        peak = want.abs().max().item()
        fns = {"kernel": lambda: (wiener_cluster_mixed_pallas if mixed else wiener_istft)(
            y, re_, im_, w, hop, L)}
        if mixed:
            row.update(n=nfft // plan.cluster, radices=fp.mixed_radices(nfft // plan.cluster))
            fns["bluestein"] = lambda: wiener_bluestein_cluster_pallas(y, re_, im_, w, hop, L)
        for key, fn in fns.items():
            row[f"{key}_rel_err"] = (fn() - want).abs().max().item() / peak
        del want
        times = {k: [] for k in fns}
        for key in (("kernel", "bluestein", "bluestein", "kernel") if mixed else ("kernel",)):
            times[key].append(cs.cuda_ms(fns[key], reps=5, rounds=3))
        for key, t in times.items():
            row[f"{key}_ms"] = median(t)
        try:
            row["chain"], row["chain_ms"] = cs.masked_chain_ms(nfft, hop, w, L, y, re_, im_,
                                                               device)
        except torch.cuda.OutOfMemoryError:
            row["chain"], row["chain_ms"] = None, None
        torch.cuda.empty_cache()
        row["won_chain"] = row["chain_ms"] is not None and row["kernel_ms"] < row["chain_ms"]
        text = (f"W {nfft}, hop {hop} ({plan.route}, C {plan.cluster}"
                + (f", n {row['n']} = {'·'.join(map(str, row['radices']))}" if mixed else "")
                + f"): kernel {row['kernel_ms']:.4f} ms")
        if mixed:
            row["won"] = row["kernel_ms"] < row["bluestein_ms"]
            text += (f", Bluestein {row['bluestein_ms']:.4f} ms, "
                     f"{row['bluestein_ms'] / row['kernel_ms']:.2f}x")
        text += (f"; chain (mask + {row['chain']}) " + cs.ms_str(row["chain_ms"])
                 + f"; rel err {row['kernel_rel_err']:.2e}"
                 + (f" / {row['bluestein_rel_err']:.2e}" if mixed else ""))
        print(text, flush=True)
        if not all(row[f"{k}_rel_err"] <= TOL for k in fns):
            raise AssertionError(f"W {nfft}: past {TOL} × max|out| from the float64 synthesis")
        (rows if mixed else dit_rows)[nfft] = row
        del re_, im_, y
    won = sorted(n for n, r in rows.items() if r["won"])
    lost = sorted(n for n, r in rows.items() if not r["won"])
    won_chain = sorted((n, r["hop"]) for n, r in {**rows, **dit_rows}.items() if r["won_chain"])
    print(f"won against Bluestein's cluster {len(won)}: {won}")
    print(f"lost {len(lost)}: {lost}")
    print(f"won against the masked chain {len(won_chain)}: {won_chain}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "ptxas": ptxas, "occupancy": occupancy, "rows": rows,
             "dit_rows": dit_rows, "won": won, "lost": lost, "won_chain": won_chain}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
