#!/usr/bin/env python3
"""Where a dsd100 train step's device time goes, on one CUDA GPU
(convsep_tpu_torch; no JAX).

    python3 tools/torch_profile_train.py [--steps 5] [--out FILE]

``torch.profiler`` over ``--steps`` B 32 train steps (after 3 warm-ups,
the batch already on the device) on the kernel route (``fft_impl=
"pallas"``, ``optimizer_impl="fused"``) and on the plain route: wall ms
per step, device busy ms per step (the sum of device kernel and memcpy
time on the one stream) and the largest device items. Then
``Trainer.fit`` profiled over 10 steps at its default log cadence: wall
and device busy per step. A profiler session slows the host for the rest
of the process, so host timings belong to ``tools/torch_time_train.py``.
``--out`` writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples  # noqa: E402
from convsep_tpu_torch.data.synth import sine_mixture  # noqa: E402
from convsep_tpu_torch.train.e2e import make_audio_train_step  # noqa: E402
from convsep_tpu_torch.train.loop import Trainer, create_train_state  # noqa: E402


def device_ms(event) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr) / 1e3
    return 0.0


def device_rows(prof, n: int) -> list:
    """(name, device ms per step, launches per step), largest first."""
    rows = [(e.key, device_ms(e) / n, e.count // n) for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", "")) and device_ms(e) > 0]
    return sorted(rows, key=lambda r: -r[1])


def profile_steps(fn, n: int) -> tuple[float, list]:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return wall, device_rows(prof, n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"smi": cs.smi_line()}
    preset = cs.train_preset(True)
    seg = segment_samples(preset)
    stems = torch.from_numpy(np.stack([
        sine_mixture(4, seg, fs=cs.FS, seed=b)[0] for b in range(preset.train.batch_size)
    ])).to(dev)
    mix = stems.sum(1)
    for kernels_on in (True, False):
        name = "kernel route" if kernels_on else "plain route"
        p = cs.train_preset(kernels_on)
        state, opt = create_train_state(p, 0, dev)
        step = make_audio_train_step(p, opt)
        holder = [state]

        def one():
            holder[0], _ = step(holder[0], mix, stems)

        wall, rows = profile_steps(one, args.steps)
        busy = sum(r[1] for r in rows)
        print(f"{name}: wall {wall:.3f} ms/step (profiled), device busy {busy:.3f} ms/step, "
              f"{sum(r[2] for r in rows)} device items/step")
        for key, ms, count in rows[:14]:
            print(f"  {ms:8.3f} ms  x{count:<3d} {key[:110]}")
        out[name] = {"wall_ms": wall, "busy_ms": busy, "top": rows[:25]}
        del state, holder, step
        torch.cuda.empty_cache()
    p = dataclasses.replace(preset, train=dataclasses.replace(preset.train, log_every_steps=50))
    with tempfile.TemporaryDirectory() as root:
        cs.write_tracks(root, p.sources)
        ds = AudioSegmentDataset(root, p.sources, seg, fs=cs.FS)
    tr = Trainer(p, from_audio=True, device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        tr.fit(ds, max_steps=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tr.fit(ds, max_steps=tr.state.step + 10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
    busy = sum(r[1] for r in device_rows(prof, 10))
    print(f"Trainer.fit profiled: wall {wall:.3f} ms/step, device busy {busy:.3f} ms/step "
          f"({100 * busy / wall:.1f} %)")
    out["fit_profiled"] = {"wall_ms": wall, "busy_ms": busy}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(out["smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
