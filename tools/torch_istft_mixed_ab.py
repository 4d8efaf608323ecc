#!/usr/bin/env python3
"""The mixed cluster's A/B on one CUDA GPU (no JAX): at every size it takes
(``fft_plan.mixed_factors``, 281 sizes from 8232 to 64 827), at the 117 on
clusters of 2, 4 or 8 whose block size n has a factor 7 (``--radix7``),
at the 77 on clusters of 3, 5, 6 or 7 blocks, 40 of them odd (``--new``),
or at the sizes given, the iSTFT of one 30 s track at hop nfft / 4 (nfft /
5, / 3 or / 7 where 4 does not divide it, as 11 250, 13 122, 14 406, 11
025 and 16 807) on the mixed
cluster (``launch_istft(cluster_mixed=True)``) against Bluestein's cluster
forced (``bluestein_cluster=True``) and ``torch.istft`` on the same random
spectra.

    python3 tools/torch_istft_mixed_ab.py [--out FILE] [--radix7 | --new] [nfft ...]

Prints the card's name and power limit, builds the kernels and prints
ptxas's registers, spills and stack frames of the cluster iSTFT kernels,
the clusters the card holds at once for the mixed kernel at C 2 to 8
(``istft_cluster_occupancy`` route 2) beside ``fft_plan.CLUSTERS_AT_ONCE``,
then a line a size: both routes'
card ms and ``torch.istft``'s (CUDA events, in turns: mixed, Bluestein,
``torch.istft``, Bluestein, mixed, the median of each), the bytes bound (spectra read once,
samples written once) and both routes' largest error against the float64
synthesis over its peak. Fails if either route is off by more than 2e-6 ×
the peak. ``--out`` writes every number to FILE as JSON. It prints the
sizes the mixed cluster won, ``fft_plan.ISTFT_MIXED_WON``'s candidates. Run
it from the root of the checkout.
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
TOL = 2e-6        # × max|out| against the float64 synthesis (chip_smoke.TOL_CLUSTER_F32)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp
    from convsep_tpu_torch.dsp.cuda.istft_kernel import launch_istft
    from convsep_tpu_torch.dsp.stft import num_frames
    from convsep_tpu_torch.dsp.windows import sinebell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    pick = ap.add_mutually_exclusive_group()
    pick.add_argument("--radix7", action="store_true",
                      help="only the sizes on C 2, 4 or 8 whose block size has a factor 7")
    pick.add_argument("--new", action="store_true",
                      help="only the sizes on clusters of 3, 5, 6 or 7 blocks")
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
    for m in re.finditer(r"Function properties for (\S*istft_cluster\S*)\n\s+(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*Used "
                         r"(\d+) registers", buf.getvalue()):
        ptxas[m[1]] = {"stack": int(m[2]), "spill_stores": int(m[3]), "spill_loads": int(m[4]),
                       "registers": int(m[5])}
        print(f"ptxas {m[1]}: {m[2]} bytes stack, {m[3]}/{m[4]} bytes spilled, {m[5]} "
              "registers")

    occupancy = {}
    for nfft in (10000, 11025, 20000, 30870, 44100, 16807, 40000):  # C 2, 3, 4, 5, 6, 7, 8
        active = ctypes.c_int(0)
        hop = nfft // next(k for k in (4, 5, 3, 7) if nfft % k == 0)
        kernels.check(kernels.library().istft_cluster_occupancy(nfft, nfft, hop, 2,
                                                                ctypes.byref(active)),
                      "istft_cluster_occupancy")
        c = fp.mixed_factors(nfft)[0]
        occupancy[c] = active.value
        print(f"clusters of {c} at once (istft_cluster_mixed_kernel, W {nfft}): the card's "
              f"{active.value}, CLUSTERS_AT_ONCE {fp.CLUSTERS_AT_ONCE[c]}", flush=True)

    sizes = args.sizes or [
        n for n in range(fp.MAX_NFFT + 1, fp.CLUSTER_NFFT + 1) if fp.mixed_factors(n)
        and (not args.radix7 or (fp.mixed_factors(n)[0] in (2, 4, 8)
                                 and fp.mixed_factors(n)[1] % 7 == 0))
        and (not args.new or fp.mixed_factors(n)[0] in (3, 5, 6, 7))]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for nfft in sizes:
        hop = nfft // next(k for k in (4, 5, 3, 7, 2) if nfft % k == 0)
        nf = num_frames(SECONDS * cs.FS, hop)
        L = (nf - 2) * hop
        w = sinebell(nfft)
        re_ = torch.randn(1, nf, nfft // 2 + 1, generator=gen, device=device)
        im_ = torch.randn(1, nf, nfft // 2 + 1, generator=gen, device=device)
        want = cs.istft64(re_, im_, w, hop, L)
        peak = want.abs().max().item()
        wt = torch.from_numpy(w.astype(np.float32)).to(device)
        spec = torch.complex(re_, im_).transpose(-1, -2)  # torch.istft's (..., bins, frames)
        fns = {"mixed": lambda: launch_istft(re_, im_, w, hop, L, nfft, cluster_mixed=True),
               "bluestein": lambda: launch_istft(re_, im_, w, hop, L, nfft,
                                                 bluestein_cluster=True),
               "library": lambda: torch.istft(spec, nfft, hop, window=wt, center=True,
                                              length=L)}
        row = {"c": fp.mixed_factors(nfft)[0], "n": fp.mixed_factors(nfft)[1],
               "radices": fp.mixed_radices(fp.mixed_factors(nfft)[1]), "hop": hop, "nf": nf}
        for key, fn in fns.items():
            row[f"{key}_rel_err"] = (fn() - want).abs().max().item() / peak
        times = {k: [] for k in fns}
        for key in ("mixed", "bluestein", "library", "bluestein", "mixed"):
            times[key].append(cs.cuda_ms(fns[key], reps=5, rounds=3))
        for key, t in times.items():
            row[f"{key}_ms"] = sorted(t)[len(t) // 2] if len(t) % 2 else sum(t) / len(t)
        row.update(cs.bound(8 * re_.numel() + 4 * L, cs.fft_flops(nf, nfft)))
        row["won"] = row["mixed_ms"] < row["bluestein_ms"]
        rows[nfft] = row
        print(f"W {nfft} (C {row['c']}, n {row['n']} = {'·'.join(map(str, row['radices']))}, "
              f"hop {hop}): mixed {row['mixed_ms']:.4f} ms, Bluestein {row['bluestein_ms']:.4f} "
              f"ms, {row['bluestein_ms'] / row['mixed_ms']:.2f}x; torch.istft "
              f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms; rel err "
              f"{row['mixed_rel_err']:.2e} / {row['bluestein_rel_err']:.2e}", flush=True)
        if not (row["mixed_rel_err"] <= TOL and row["bluestein_rel_err"] <= TOL):
            raise AssertionError(f"W {nfft}: past {TOL} × max|out| from the float64 synthesis")
        del re_, im_, want, spec
    won = sorted(n for n, r in rows.items() if r["won"])
    lost = sorted(n for n, r in rows.items() if not r["won"])
    print(f"won {len(won)}: {won}")
    print(f"lost {len(lost)}: {lost}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "ptxas": ptxas, "occupancy": occupancy, "rows": rows, "won": won,
             "lost": lost}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
