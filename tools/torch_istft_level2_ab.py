#!/usr/bin/env python3
"""The direct second level's A/B on one CUDA GPU (no JAX): at every size it
takes (``fft_plan.level2_direct_factors``, 138 sizes from 65 856 to 262
144) or at the sizes given, the iSTFT of one 30 s track at hop nfft / 4 on
the direct level (``launch_istft(level2_direct=True)``) against
Bluestein's second level forced (``level2_bluestein=True``) and
``torch.istft`` on the same random spectra.

    python3 tools/torch_istft_level2_ab.py [--out FILE] [nfft ...]

Prints the card's name and power limit, builds the kernels and prints
ptxas's registers, spills and stack frames of the second level's iSTFT
kernels, then a line a size: both routes' card ms and ``torch.istft``'s
(CUDA events, in turns: direct, Bluestein, ``torch.istft``, Bluestein,
direct, the median of each), their device ms (``torch.profiler``, the
median of three sessions: a session has dropped a kernel's records, as
cuFFT's at 104 976 and Bluestein's phases at 117 600 in one run; the
kernels' own time, without the wrappers' host time, which bounds the card
ms of both routes past about 100 000 points: the window's tables are found
again by comparing its bytes), the bytes bound (spectra read once, samples
written once) and both routes' largest error against the float64 synthesis
over its peak. Fails if either route is off by more than 2e-6 × the peak.
A size is won where the direct level's device ms is under Bluestein's and
its card ms is not over Bluestein's by more than ``SPREAD``. ``--out``
writes every number to FILE as JSON. It prints the sizes the direct level
won, ``fft_plan.ISTFT_LEVEL2_DIRECT_WON``'s candidates. Run it from the root
of the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

SECONDS = 30      # one track
TOL = 2e-6        # × max|out| against the float64 synthesis (chip_smoke.TOL_LEVEL2)
SPREAD = 0.05     # card ms of two host-bound routes differ by this much between turns


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
    for m in re.finditer(r"Function properties for (\S*istft_level2\S*)\n\s+(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*Used "
                         r"(\d+) registers", buf.getvalue()):
        ptxas[m[1]] = {"stack": int(m[2]), "spill_stores": int(m[3]), "spill_loads": int(m[4]),
                       "registers": int(m[5])}
        print(f"ptxas {m[1]}: {m[2]} bytes stack, {m[3]}/{m[4]} bytes spilled, {m[5]} "
              "registers")

    sizes = args.sizes or [n for n in range(fp.CLUSTER_NFFT + 1, fp.LEVEL2_NFFT + 1)
                           if fp.level2_direct_factors(n)]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for nfft in sizes:
        hop = nfft // 4
        nf = num_frames(SECONDS * cs.FS, hop)
        L = (nf - 2) * hop
        w = sinebell(nfft)
        re_ = torch.randn(1, nf, nfft // 2 + 1, generator=gen, device=device)
        im_ = torch.randn(1, nf, nfft // 2 + 1, generator=gen, device=device)
        want = cs.istft64(re_, im_, w, hop, L)
        peak = want.abs().max().item()
        wt = torch.from_numpy(w.astype(np.float32)).to(device)
        spec = torch.complex(re_, im_).transpose(-1, -2)  # torch.istft's (..., bins, frames)
        fns = {"direct": lambda: launch_istft(re_, im_, w, hop, L, nfft, level2_direct=True),
               "bluestein": lambda: launch_istft(re_, im_, w, hop, L, nfft,
                                                 level2_bluestein=True),
               "library": lambda: torch.istft(spec, nfft, hop, window=wt, center=True,
                                              length=L)}
        r, n = fp.level2_direct_factors(nfft)
        row = {"r": r, "n": n, "radices": fp.mixed_radices(n), "hop": hop, "nf": nf}
        for key, fn in fns.items():
            row[f"{key}_rel_err"] = (fn() - want).abs().max().item() / peak
        times = {k: [] for k in fns}
        for key in ("direct", "bluestein", "library", "bluestein", "direct"):
            times[key].append(cs.cuda_ms(fns[key], reps=5, rounds=3))
        for key, t in times.items():
            row[f"{key}_ms"] = sorted(t)[len(t) // 2] if len(t) % 2 else sum(t) / len(t)
        for key, fn in fns.items():
            runs = sorted((cs.profile_ms(fn) for _ in range(3)),
                          key=lambda p: p["device_ms"] or 0.0)
            row[f"{key}_device_ms"] = runs[1]["device_ms"]
            row[f"{key}_kernels"] = runs[1]["by_kernel"]
        row.update(cs.bound(8 * re_.numel() + 4 * L, cs.fft_flops(nf, nfft)))
        row["won"] = (row["direct_device_ms"] is not None
                      and row["direct_device_ms"] < (row["bluestein_device_ms"] or 0.0)
                      and row["direct_ms"] <= (1 + SPREAD) * row["bluestein_ms"])
        rows[nfft] = row
        print(f"W {nfft} (R {r}, n {n} = {'·'.join(map(str, row['radices']))}, hop {hop}, nf "
              f"{nf}): direct {row['direct_ms']:.4f} ms, Bluestein {row['bluestein_ms']:.4f} ms, "
              f"{row['bluestein_ms'] / row['direct_ms']:.2f}x; torch.istft "
              f"{row['library_ms']:.4f} ms; device {cs.ms_str(row['direct_device_ms'])}, "
              f"{cs.ms_str(row['bluestein_device_ms'])}, {cs.ms_str(row['library_device_ms'])}; "
              f"bound {row['bound_ms']:.4f} ms; rel err "
              f"{row['direct_rel_err']:.2e} / {row['bluestein_rel_err']:.2e}", flush=True)
        if not (row["direct_rel_err"] <= TOL and row["bluestein_rel_err"] <= TOL):
            raise AssertionError(f"W {nfft}: past {TOL} × max|out| from the float64 synthesis")
        del re_, im_, want, spec
        torch.cuda.empty_cache()
    won = sorted(n for n, r in rows.items() if r["won"])
    lost = sorted(n for n, r in rows.items() if not r["won"])
    slower = sorted(n for n, r in rows.items()
                    if (r["direct_device_ms"] or 0.0) >= (r["library_device_ms"] or 0.0))
    print(f"won {len(won)}: {won}")
    print(f"lost {len(lost)}: {lost}")
    print(f"not under torch.istft's device ms {len(slower)}: {slower}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "ptxas": ptxas, "rows": rows, "won": won, "lost": lost,
             "not_under_library": slower}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
