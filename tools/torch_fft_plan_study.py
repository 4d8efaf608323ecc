#!/usr/bin/env python3
"""Device time of the inverse split (``csrc/istft.cu::istft_split_kernel``)
and of Bluestein (``csrc/stft_dft.cu::stft_bluestein_kernel``) at every
launch their plans could choose, on one card, so that the plans'
choices rest on measurements.

    python3 tools/torch_fft_plan_study.py [--reps 20]

For each shape and each candidate (transforms a block; for the inverse
split with the rounds that keep the recomputed share at or under 3/16) it
launches the kernel through its C entry, checks the output against the
plan's (Bluestein bit for bit: a launch changes no sum; the inverse split
within 1e-5 × max|out|: another row split may pair other frames in a
transform, which moves the last bits) and prints the device ms per call
from ``torch.profiler`` (the kernels' own time), the card's name and
power limit beside it. The last line is one JSON object of every
reading."""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the smoke's shapes (phases 5 and 7) and two more of each kernel's sizes
ISTFT_SHAPES = ((768, 256), (1280, 320), (2304, 576))  # 4 signals of a 30 s track
BLUESTEIN_SHAPES = ((1000, 250), (1792, 448), (4000, 1000))  # B 32 × 14 336 samples


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """The kernels' own device time per call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
             if "CUDA" in str(getattr(e, "device_type", "")))
    return us / 1e3 / reps


def istft_candidates(nfft: int, win: int, hop: int):
    """(groups, rounds) of every power-of-two G whose block is whole warps
    within 512 threads and shared memory, the rounds by the plan's 3/16 rule."""
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    m, p = fp.split_factors(nfft)
    t, k = nfft // fp.POINTS, win // hop
    need = max(1, math.ceil((k - 1) / fp.MAX_HALO))
    for e in range(10):
        g = 1 << e
        if (g * fp.threads_per_fft(p)) % 32 or g * t > fp.MAX_THREADS:
            continue
        if fp.istft_smem_bytes(nfft, win, hop, g) > fp.SMEM_MAX:
            continue
        yield g, -(-(need + k - 1) // (2 * g))


def study_istft(reps: int) -> list[dict]:
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp
    from convsep_tpu_torch.dsp.dft import stft_matmul
    from convsep_tpu_torch.dsp.stft import num_frames
    from convsep_tpu_torch.dsp.windows import sinebell

    lib = kernels.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for nfft, hop in ISTFT_SHAPES:
        signals, nf = 4, num_frames(30 * 44100, hop)
        L = (nf - 2) * hop
        w = sinebell(nfft)
        re, im = stft_matmul(0.3 * torch.randn(signals, L, generator=gen, device=dev), w, hop)
        re, im = re.contiguous(), im.contiguous()
        wn, inv = fp.synthesis_tables(w, nfft, hop, nf, str(dev))
        m, p = fp.split_factors(nfft)
        twp, twn = fp.twiddles(p, str(dev)), fp.twiddles(nfft, str(dev))
        plan = fp.istft_plan(signals, nf, nfft, nfft, hop)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ref = None
        for g, rounds in [(plan.groups, plan.rounds)] + [
                c for c in istft_candidates(nfft, nfft, hop)
                if c != (plan.groups, plan.rounds)]:
            out = torch.empty(signals, L, device=dev)

            def call():
                kernels.check(lib.istft_split_launch(
                    re.data_ptr(), im.data_ptr(), wn.data_ptr(), inv.data_ptr(), twp.data_ptr(),
                    twn.data_ptr(), out.data_ptr(), 0, signals, nf, nfft, nfft, hop, L, g,
                    rounds, stream), "istft_split")

            call()
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            diff = (out - ref).abs().max().item()
            ms = device_ms(call, reps)
            r = {"kernel": "istft_split", "nfft": nfft, "hop": hop, "signals": signals, "nf": nf,
                 "groups": g, "rounds": rounds, "threads": g * nfft // fp.POINTS,
                 "rows": 2 * g * rounds - (nfft // hop - 1), "plan": (g, rounds) == (
                     plan.groups, plan.rounds), "max_abs_diff_plan": diff,
                 "agrees": diff <= 1e-5 * ref.abs().max().item(), "device_ms": ms}
            print(f"istft_split {nfft} hop {hop}: G {g} rounds {rounds} ({r['threads']} threads, "
                  f"{r['rows']} rows){' [plan]' if r['plan'] else ''}: device {ms:.4f} ms, "
                  f"{diff:.3e} from the plan's output", flush=True)
            rows.append(r)
    return rows


def study_bluestein(reps: int) -> list[dict]:
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp
    from convsep_tpu_torch.dsp.stft import num_frames
    from convsep_tpu_torch.dsp.windows import sinebell

    lib = kernels.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for nfft, hop in BLUESTEIN_SHAPES:
        B, L = 32, 14336
        nf = num_frames(L, hop)
        x = 0.3 * torch.randn(B, L, generator=gen, device=dev)
        w = fp.window_f32(sinebell(nfft), str(dev))
        chirp, chat = fp.bluestein_tables(nfft, str(dev))
        plan = fp.bluestein_plan(B, nf, nfft, nfft, hop)
        tw = fp.twiddles(plan.m, str(dev))
        t = plan.m // fp.POINTS
        stream = torch.cuda.current_stream(dev).cuda_stream
        g_max = fp.MAX_THREADS // t if t <= 32 else min(fp.MAX_NAMED_GROUPS, fp.MAX_THREADS // t)
        cands = [plan.ffts_per_block] + [
            g for g in (1 << e for e in range(10)) if max(1, 32 // t) <= g <= g_max
            and g != plan.ffts_per_block and fp.smem_bytes(plan.m, nfft, hop, g) <= fp.SMEM_MAX]
        ref = None
        for g in cands:
            re, im = torch.empty(2, B, nf, nfft // 2 + 1, device=dev)

            def call():
                kernels.check(lib.stft_bluestein_launch(
                    x.data_ptr(), w.data_ptr(), tw.data_ptr(), chirp.data_ptr(), chat.data_ptr(),
                    re.data_ptr(), im.data_ptr(), B, L, nfft, hop, nf, nfft, g, stream),
                    "stft_bluestein")

            call()
            torch.cuda.synchronize()
            if ref is None:
                ref = (re.clone(), im.clone())
            same = bool(torch.equal(re, ref[0]) and torch.equal(im, ref[1]))
            ms = device_ms(call, reps)
            r = {"kernel": "stft_bluestein", "nfft": nfft, "hop": hop, "B": B, "nf": nf,
                 "m": plan.m, "ffts": g, "threads": g * t, "plan": g == plan.ffts_per_block,
                 "agrees": same, "device_ms": ms}
            print(f"stft_bluestein {nfft} hop {hop} (M {plan.m}): G {g} ({g * t} threads)"
                  f"{' [plan]' if r['plan'] else ''}: device {ms:.4f} ms, bits equal to the "
                  f"plan's: {same}", flush=True)
            rows.append(r)
    return rows


def main(argv: list[str]) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from convsep_tpu_torch import kernels

    card = smi_line()
    kernels.build()
    print(f"card: {card} | torch {torch.__version__}", flush=True)
    rows = study_istft(args.reps) + study_bluestein(args.reps)
    if not all(r["agrees"] for r in rows):
        print("a launch's output disagrees with the plan's", file=sys.stderr)
        return 1
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
