"""Profiling on CPU: ``trace`` writes a Chrome trace, ``summarize_trace``
ranks its CPU operations (no GPU events in a CPU run) and refuses to rank
a trace said to be of a CUDA run that holds no kernel events,
``timeit_fetch`` times a call."""

import os

import pytest
import torch

from convsep_tpu_torch.utils.profiling import summarize_trace, timeit_fetch, trace


def test_trace_and_summary_on_cpu(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path)):
        for _ in range(3):
            b = a @ a
        torch.relu(b)
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))
    rows = summarize_trace(str(tmp_path), top=5, device="cpu")
    assert 0 < len(rows) <= 5
    assert set(rows[0]) == {"name", "total_ms", "count"}
    assert [r["total_ms"] for r in rows] == sorted((r["total_ms"] for r in rows), reverse=True)
    names = {r["name"]: r["count"]
             for r in summarize_trace(str(tmp_path), top=100, device="cpu")}
    assert names.get("aten::mm") == 3 and names.get("aten::relu") == 1


def test_summary_of_a_cuda_run_needs_kernel_events(tmp_path):
    with trace(str(tmp_path)):
        torch.relu(torch.randn(16, 16))
    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        summarize_trace(str(tmp_path), device="cuda")


def test_timeit_fetch():
    r = timeit_fetch(lambda x: (x @ x, {"y": x + 1}), torch.randn(8, 8), runs=3)
    assert len(r["all_s"]) == 3 and 0 <= r["min_s"] <= r["median_s"]
