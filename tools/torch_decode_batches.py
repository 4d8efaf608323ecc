#!/usr/bin/env python3
"""The fused decode kernel against the plain decode across batch sizes, on
one CUDA GPU (convsep_tpu_torch; no JAX).

    python3 tools/torch_decode_batches.py [--out FILE]

For each TM the package routes (120: highres4096, 240: its stereo preset,
360: multires4096) the model is built at full width with seeded random
weights, and ``band_freq_decode`` (the kernel, forced) and
``band_freq_decode_plain`` run on the same random fc rows at each batch B
(fc rows = segments; a 30 s track is 49, a chunk of ``chunk_segments``
32 is 32, an online chunk 8, a stream batch of two tracks 98), bf16
output as on the separation paths: every B from 1 to 64 (one row tile of
the kernel) and ``BEYOND`` past it. Times are ``chip_smoke.cuda_ms`` (CUDA
events around 10 calls, median of 5 rounds), kernel and plain in turns:
plain, kernel, kernel, plain. A point is won when both kernel times are
below both plain times. The tool prints, per TM, the won batches as
ranges of consecutive timed points: the literal of
``models/decoder_fused_cuda.py::FUSED_DECODE_WON["float32"]`` (the sweep runs
the float32 model). ``--out`` writes the
numbers as JSON. Prints the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch.ckpt import init_params  # noqa: E402
from convsep_tpu_torch.configs import get_preset  # noqa: E402
from convsep_tpu_torch.models import ConvSep  # noqa: E402
from convsep_tpu_torch.models.decoder_fused_cuda import (  # noqa: E402
    band_freq_decode,
    band_freq_decode_plain,
)

PRESETS = ("highres4096", "highres4096-stereo", "multires4096")
BEYOND = (65, 72, 80, 96, 98, 112, 128, 147, 196)  # past one row tile


def won_ranges(points: list[dict]) -> tuple[tuple[int, int], ...]:
    """The won batches as (first, last) runs of consecutive timed points."""
    out: list[list[int]] = []
    prev_won = False
    for row in sorted(points, key=lambda r: r["B"]):
        if row["won"] and prev_won and row["B"] == out[-1][1] + 1:
            out[-1][1] = row["B"]
        elif row["won"]:
            out.append([row["B"], row["B"]])
        prev_won = row["won"]
    return tuple((a, b) for a, b in out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    print(f"card: {card}", flush=True)
    results = []
    rule = {}
    for seed, name in enumerate(PRESETS):
        preset = get_preset(name)
        state = init_params(preset.model, torch.Generator(device=dev).manual_seed(seed), dev)
        model = ConvSep(preset.model, state, device=dev).prepare_inference()
        del state
        ops = (model.k4, model.b3, model.kcat)
        TM = model.kcat.shape[2]
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        points = []
        for B in (*range(1, 65), *BEYOND):
            fc = torch.relu(torch.randn(B, model.k4.shape[0], generator=gen, device=dev))
            kernel = lambda: band_freq_decode(fc, *ops, out_dtype=torch.bfloat16)  # noqa: E731
            plain = lambda: band_freq_decode_plain(fc, *ops, out_dtype=torch.bfloat16)  # noqa: E731
            p1, k1, k2, p2 = (cs.cuda_ms(f) for f in (plain, kernel, kernel, plain))
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            won = max(k1, k2) < min(p1, p2)
            row = {"preset": name, "TM": TM, "B": B, "kernel_ms": k, "plain_ms": p,
                   "ratio": k / p, "kernel_runs": [k1, k2], "plain_runs": [p1, p2], "won": won}
            points.append(row)
            print(f"TM {TM} B {B}: kernel {k:.3f} ms ({k1:.3f}, {k2:.3f}), plain {p:.3f} ms "
                  f"({p1:.3f}, {p2:.3f}), kernel/plain {k / p:.3f}, "
                  f"{'won' if won else 'not won'} | {card}", flush=True)
        results += points
        rule[TM] = won_ranges(points)
        print(f"TM {TM} won: {rule[TM]}", flush=True)
        del model, ops
        torch.cuda.empty_cache()
    print(f'FUSED_DECODE_WON["float32"] = {rule}', flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "won": {str(k): v for k, v in
                                                                    rule.items()},
                                              "points": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
