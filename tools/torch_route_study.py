#!/usr/bin/env python3
"""How far one dsd100 train step parts between two float32-correct routes,
on one CUDA GPU (convsep_tpu_torch; no JAX).

    python3 tools/torch_route_study.py [--seeds 6] [--batches 3] [--out FILE]

For each seed, from the seeded random init and from the weights after
``Trainer.fit(max_steps=20)`` on synthetic stems, on each of ``--batches``
B 32 batches, at ``wiener_eps`` 1e-8 (the preset's) and 1e-2:
``chip_smoke.route_check``, i.e. one step of the kernel route
(``fft_impl="pallas"``, ``optimizer_impl="fused"``) and of the witness
(the plain route on the factored STFT), each against the plain route
(direct STFT, plain optimizer), from the same weights, zero accumulators
and the same batch. Prints one line per case and, per wiener_eps and
pair, the median and max of each gap (loss and grad_norm relative,
gradients and weights in units of max|g|, the mixture spectrum in units
of its peak), then the card's name and power limit. ``--out`` also
writes every case as JSON. ``chip_smoke.py``'s route gates
(``TOL_ROUTE_GN_EPS``, ``TOL_ROUTE_WEIGHTS``) come from the witness's
spread here.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples  # noqa: E402
from convsep_tpu_torch.data.pipeline import to_device  # noqa: E402
from convsep_tpu_torch.train.loop import Trainer, create_train_state  # noqa: E402

GAPS = ("loss", "grad_norm", "grads", "weights", "stft")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--out", default=None, help="write every case as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_study: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    preset = cs.train_preset(True)
    seg = segment_samples(preset)
    with tempfile.TemporaryDirectory() as root:
        cs.write_tracks(root, preset.sources)
        ds = AudioSegmentDataset(root, preset.sources, seg, fs=cs.FS)
    batches = [to_device(next(ds.batches(preset.train.batch_size, shuffle=True, seed=123 + b)),
                         dev) for b in range(args.batches)]
    cases = []
    for seed in range(args.seeds):
        init = create_train_state(preset, seed, dev)[0].params
        tr = Trainer(preset, from_audio=True, device=dev, seed=seed)
        with contextlib.redirect_stdout(io.StringIO()):
            tr.fit(ds, max_steps=cs.TRAIN_STEPS)
        fitted = {k: v.detach().clone() for k, v in tr.state.params.items()}
        del tr
        for state, params in (("init", init), ("fitted", fitted)):
            for b, (mix, stems) in enumerate(batches):
                for eps in (preset.sep.wiener_eps, 1e-2):
                    with contextlib.redirect_stdout(io.StringIO()):
                        r = cs.route_check(params, mix, stems, eps, dev)
                    cases.append({"seed": seed, "state": state, "batch": b, "wiener_eps": eps,
                                  **r})
                    print(f"seed {seed} {state:6s} batch {b} eps {eps:g}: " + "; ".join(
                        f"{name} " + " ".join(f"{g} {r[name][g]:.2e}" for g in GAPS)
                        for name in ("kernel", "witness")) + f"; exact {r['exact']}",
                        flush=True)
        del init, fitted
        torch.cuda.empty_cache()
    for eps in (preset.sep.wiener_eps, 1e-2):
        for name in ("kernel", "witness"):
            rows = np.array([[c[name][g] for g in GAPS] for c in cases if c["wiener_eps"] == eps])
            print(f"eps {eps:g} {name:7s} vs plain, n {len(rows)}: " + "; ".join(
                f"{g} median {np.median(rows[:, i]):.2e} max {rows[:, i].max():.2e}"
                for i, g in enumerate(GAPS)))
    print(f"fused step bit-exact in every case: {all(c['exact'] for c in cases)}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"smi": cs.smi_line(), "cases": cases}, f, indent=1)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
