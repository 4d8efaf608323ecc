#!/usr/bin/env python3
"""The feature-file Trainer's loop on one CUDA GPU against its step alone,
and the device's idle share while the loop runs (convsep_tpu_torch; no JAX).

    python3 tools/torch_time_feature_train.py [--rounds 2] [--steps 20]

Smoke phase 20's setting: 8 synthetic 4-stem tracks of 20 s through
``compute_features(dsd100)`` on the card, a ``SegmentDataset`` (T 30,
overlap 20), ``Trainer(dsd100, optimizer_impl="fused")`` at full width,
B 32, logging every step. Each round prints, in ms per step:

- the step alone (``chip_smoke.time_steps``: one batch already on the
  device, a synchronize after each step);
- ``Trainer.fit`` over ``--steps`` steps after 3 warm-up steps: the
  Trainer's logged ``step_time_ms`` (median) and the host clock around
  the whole fit;
- the same fit under ``torch.profiler``: device busy (the union of every
  kernel and copy interval of the trace, ``tools/torch_time_separate.py``),
  the idle share 1 - busy / the profiled wall, and 1 - busy / the
  unprofiled host clock (the profiler adds host time to every step).

The last line is one JSON object with every number and the card's name
and power limit (nvidia-smi). The script imports ``chip_smoke`` and the
package from the checkout it lives in, so a copy placed in another
checkout's ``tools/`` times that checkout's code.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch.data.features import compute_features  # noqa: E402
from convsep_tpu_torch.data.pipeline import SegmentDataset, to_device  # noqa: E402
from convsep_tpu_torch.train.loop import Trainer, create_train_state, make_train_step  # noqa: E402
from tools.torch_time_separate import device_intervals, length, union  # noqa: E402


def fit_round(trainer: Trainer, ds, steps: int, metrics: str) -> dict:
    """Warm up 3 steps, then ``steps`` steps timed by the host clock and the
    Trainer's own log, then ``steps`` more under the profiler."""
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.fit(ds, max_steps=int(trainer.state.step) + 3)
        torch.cuda.synchronize()
        if os.path.exists(metrics):
            os.remove(metrics)
        t0 = time.perf_counter()
        trainer.fit(ds, max_steps=int(trainer.state.step) + steps, metrics_path=metrics)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        with open(metrics) as f:
            logged = [json.loads(line)["step_time_ms"] for line in f if "step_time_ms" in line]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.fit(ds, max_steps=int(trainer.state.step) + steps)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
    kern, copy = device_intervals(prof)
    busy = length(union(kern + copy))
    return {"logged_step_ms": float(np.median(logged)), "fit_wall_ms_per_step": wall,
            "profiled_wall_ms_per_step": prof_wall / steps, "busy_ms_per_step": busy / steps,
            "idle_share": 1.0 - busy / prof_wall,
            "idle_share_host_clock": 1.0 - busy / steps / wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_time_feature_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    preset = cs.train_preset(True)
    tr = preset.train
    out: dict = {"rounds": []}
    with tempfile.TemporaryDirectory() as root:
        audio_dir, feat_dir = os.path.join(root, "audio"), os.path.join(root, "features")
        cs.write_tracks(audio_dir, preset.sources)
        compute_features(audio_dir, feat_dir, preset, device=dev)
        ds = SegmentDataset(feat_dir, preset.sources, time_context=tr.time_context,
                            overlap=tr.overlap, mult_factor_in=tr.mult_factor_in,
                            mult_factor_out=tr.mult_factor_out)
        idx = next(ds.batch_indices(tr.batch_size, seed=tr.seed))
        x, y = to_device(ds._assemble(idx), dev)
        metrics = os.path.join(root, "metrics.jsonl")
        for rnd in range(args.rounds):
            state, opt = create_train_state(preset, 0, dev)
            alone = cs.time_steps(make_train_step(preset, opt), state, x, y)
            del state
            trainer = Trainer(preset, device=dev, seed=0)
            r = {"step_alone_ms": alone, **fit_round(trainer, ds, args.steps, metrics)}
            del trainer
            torch.cuda.empty_cache()
            print(f"round {rnd}: step alone {r['step_alone_ms']:.3f} ms; Trainer.fit logged "
                  f"step {r['logged_step_ms']:.3f} ms, host clock {r['fit_wall_ms_per_step']:.3f}"
                  f" ms/step; profiled {r['profiled_wall_ms_per_step']:.3f} ms/step, device busy "
                  f"{r['busy_ms_per_step']:.3f} ms/step, idle share {r['idle_share']:.3f} "
                  f"(of the host clock {r['idle_share_host_clock']:.3f})", flush=True)
            out["rounds"].append(r)
    out["card"] = cs.smi_line()
    print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
