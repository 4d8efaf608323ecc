"""Profiling: a trace context, a timer and a trace summary.

Mirror of ``convsep_tpu.utils.profiling``. :func:`trace` records a
``torch.profiler`` run (CPU operations, and on a GPU its kernels and
copies) and writes it into ``logdir`` as a Chrome trace
(``*.pt.trace.json``, viewable in Perfetto); :func:`summarize_trace`
ranks that file's events by total time. :func:`timeit_fetch` times a
function on the host clock, each call closed by ``torch.cuda.synchronize``
when its outputs live on a GPU.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Callable

import numpy as np
import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str):
    """Record a profiler run into ``logdir`` (created): CPU
    operations, and CUDA kernels and copies when a GPU is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"convsep_{time.time_ns()}.pt.trace.json"))


def _tensors(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def timeit_fetch(fn: Callable, *args, runs: int = 5, warmup: int = 1) -> dict:
    """Median, min and every steady-state seconds of ``fn(*args)`` on the
    host clock; a call whose outputs are on a GPU ends in
    ``torch.cuda.synchronize`` of their device."""

    def call():
        for d in {t.device for t in _tensors(fn(*args)) if t.device.type == "cuda"}:
            torch.cuda.synchronize(d)

    for _ in range(max(warmup, 1)):
        call()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return {
        "median_s": float(np.median(times)),
        "min_s": float(np.min(times)),
        "all_s": [round(t, 5) for t in times],
    }


def summarize_trace(logdir: str, top: int = 20,
                    device: str | torch.device = "cuda") -> list[dict]:
    """The newest trace under ``logdir`` → [{"name", "total_ms", "count"}],
    hottest first: the GPU kernel and copy events of a run traced on a
    CUDA ``device`` (a trace without kernel events raises: its CUDA
    activity was lost), the CPU operations of a run on the CPU."""
    files = sorted(glob.glob(os.path.join(logdir, "**", "*.trace.json*"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no *.trace.json under {logdir}")
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    on_cuda = torch.device(device).type == "cuda"
    chosen = [e for e in events if e.get("cat") in (_DEVICE_CATS if on_cuda else ("cpu_op",))]
    if on_cuda and not any(e.get("cat") == "kernel" for e in chosen):
        raise RuntimeError(f"{files[-1]} holds no GPU kernel events: the run's CUDA activity "
                           "was not traced")
    durs: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in chosen:
        durs[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    return [
        {"name": name, "total_ms": round(us / 1e3, 3), "count": cnt[name]}
        for name, us in durs.most_common(top)
    ]
