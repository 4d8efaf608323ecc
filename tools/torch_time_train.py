#!/usr/bin/env python3
"""Host-clock timings of dsd100 training on one CUDA GPU, without a
profiler (convsep_tpu_torch; no JAX).

    python3 tools/torch_time_train.py [--rounds 2]

On 8 synthetic 4-stem tracks of 20 s, B 32, kernel route
(``fft_impl="pallas"``, ``optimizer_impl="fused"``) unless it says
otherwise, each number in ms per step or batch:

- batch assembly alone (``AudioSegmentDataset.batches``), pinning plus
  the host-to-device copy alone, and a pageable copy;
- train steps with the batches already on the device, steps fed by
  ``prefetch_to_device`` from a list and from the dataset, and the host's
  time to enqueue a step without waiting for the device;
- ``Trainer.fit`` at its default log cadence (50) on the kernel and the
  plain route, alternating, ``--rounds`` times.

Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples  # noqa: E402
from convsep_tpu_torch.data.pipeline import prefetch_to_device, to_device  # noqa: E402
from convsep_tpu_torch.train.e2e import make_audio_train_step  # noqa: E402
from convsep_tpu_torch.train.loop import Trainer, create_train_state  # noqa: E402

N = 14  # steps per timing: within one epoch of the 15 batches


def timed(label: str, fn, n: int = N) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"{label}: {ms:.3f} ms", flush=True)
    return ms


def preset_at(kernels_on: bool):
    p = cs.train_preset(kernels_on)
    return dataclasses.replace(p, train=dataclasses.replace(p.train, log_every_steps=50))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_time_train: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    p = preset_at(True)
    B = p.train.batch_size
    seg = segment_samples(p)
    with tempfile.TemporaryDirectory() as root:
        cs.write_tracks(root, p.sources)
        ds = AudioSegmentDataset(root, p.sources, seg, fs=cs.FS)
    batches = list(ds.batches(B, seed=0))[:N]
    timed("batch assembly alone, per batch",
          lambda: list(zip(range(N), ds.batches(B, seed=1))))
    timed("pin + host-to-device copy, per batch", lambda: [to_device(b, dev) for b in batches])
    timed("pageable host-to-device copy, per batch",
          lambda: [tuple(torch.from_numpy(x).to(dev) for x in b) for b in batches])
    state, opt = create_train_state(p, 0, dev)
    step = make_audio_train_step(p, opt)
    on_dev = [to_device(b, dev) for b in batches]
    holder = [state]
    del state
    for _ in range(3):
        holder[0], _ = step(holder[0], *on_dev[0])

    def run(source, limit=N):
        for i, (x, y) in enumerate(source):
            if i == limit:
                break
            holder[0], _ = step(holder[0], x, y)

    timed("train steps, batches already on the device, per step", lambda: run(on_dev))
    timed("train steps fed by prefetch_to_device(list), per step",
          lambda: run(prefetch_to_device(iter(batches), dev)))
    timed("train steps fed by prefetch_to_device(ds.batches), per step",
          lambda: run(prefetch_to_device(ds.batches(B, seed=2), dev)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(on_dev[:5])
    print(f"host enqueue of a step without waiting: {(time.perf_counter() - t0) * 1e3 / 5:.3f} ms",
          flush=True)
    torch.cuda.synchronize()
    del holder, step
    torch.cuda.empty_cache()
    audio_s = B * seg / cs.FS
    for rnd in range(args.rounds):
        for kernels_on in (True, False):
            tr = Trainer(preset_at(kernels_on), from_audio=True, device=dev)
            with contextlib.redirect_stdout(io.StringIO()):
                tr.fit(ds, max_steps=3)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.fit(ds, max_steps=3 + 12)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / 12
            print(f"round {rnd}, {'kernel' if kernels_on else 'plain'} route: Trainer.fit "
                  f"{ms:.3f} ms/step, rtf_train {audio_s * 1e3 / ms:.1f}", flush=True)
            del tr
            torch.cuda.empty_cache()
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
