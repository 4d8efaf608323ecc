"""The port's bench on CPU at the tiny preset of ``tests/test_cli.py``
(1 s tracks; the preset matrix cut to that preset, the memory watermark
to batches 8 and 16): ``convsep_tpu_torch.benchmark.run_benchmark`` returns
one JSON-serializable result whose detail keys cover the JAX bench's for
the same sections (bar the helpers the port leaves out), and a section
that raises makes the run raise and ``convsep-torch bench`` fail."""

import dataclasses
import json

import pytest

from convsep_tpu import benchmark as jax_bench
from convsep_tpu.configs import presets as jax_presets
from convsep_tpu_torch import benchmark, cli
from convsep_tpu_torch.configs import presets as port_presets
from convsep_tpu_torch.configs.presets import preset_from_dict
from tests.test_cli import _tiny_ikala
from tests.test_torch_chunked import one_intraop_thread  # noqa: F401

# the reference's tunnelled-runtime workarounds (fetch_parallel)
LEFT_OUT = {"link_probe/down4_mb_s", "link_probe/fetch_streams", "link_probe/post_down4_mb_s"}
RUN = dict(seconds=1, runs=2, matrix=True)


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setitem(jax_presets.PRESETS, "tinyikala", _tiny_ikala)
    monkeypatch.setitem(port_presets.PRESETS, "tinyikala",
                        lambda: preset_from_dict(dataclasses.asdict(_tiny_ikala())))
    jm, pm = jax_bench.preset_matrix, benchmark.preset_matrix
    monkeypatch.setattr(jax_bench, "preset_matrix",
                        lambda **kw: jm(preset_names=("tinyikala",), **kw))
    monkeypatch.setattr(benchmark, "preset_matrix",
                        lambda device, **kw: pm(device, preset_names=("tinyikala",), **kw))
    jw, pw = jax_bench.hbm_watermark, benchmark.hbm_watermark
    monkeypatch.setattr(jax_bench, "hbm_watermark",
                        lambda *a, **kw: jw(*a, start_batch=8, max_batch=16, **kw))
    monkeypatch.setattr(benchmark, "hbm_watermark",
                        lambda *a, **kw: pw(*a, start_batch=8, max_batch=16, **kw))


def _paths(d: dict, prefix: str = "") -> set[str]:
    out = set()
    for k, v in d.items():
        p = f"{prefix}{k}"
        out.add(p)
        if isinstance(v, dict) and k != "tried":
            out |= _paths(v, p + "/")
    return out


def test_detail_keys_cover_the_reference():
    got = benchmark.run_benchmark("tinyikala", device="cpu", **RUN)
    line = json.dumps(got)
    assert "\n" not in line and json.loads(line) == got
    assert got["value"] > 0 and got["value"] == got["detail"]["rtf_sustained_batched"]
    d = got["detail"]
    assert d["sections_skipped"] == [] and "section_error" not in d
    assert 0 < d["mfu_bf16"] and d["finite"] is True
    want = jax_bench.run_benchmark("tinyikala", **RUN)
    assert "section_errors" not in want["detail"]
    missing = {p for p in _paths(want["detail"]) - _paths(d)
               if not any(p == k or p.startswith(k + "/") for k in LEFT_OUT)}
    assert not missing, sorted(missing)


def test_a_failing_section_fails_the_run(monkeypatch, capsys):
    import convsep_tpu_torch.separate.chunked as chunked

    def boom(*a, **kw):
        raise RuntimeError("chunked section broke")

    monkeypatch.setattr(chunked, "ChunkedSeparator", boom)
    seen = []
    with pytest.raises(RuntimeError, match="chunked section broke"):
        benchmark.run_benchmark("tinyikala", seconds=1, runs=1, device="cpu",
                                on_section=lambda r, name: seen.append((name, dict(r["detail"]))))
    name, detail = seen[-1]
    assert name == "chunked" and "RuntimeError" in detail["section_error"]["chunked"]
    assert "rtf_e2e_streaming" in detail  # the sections before it are in the partial result
    with pytest.raises(RuntimeError, match="chunked section broke"):
        cli.main(["bench", "--preset", "tinyikala", "--seconds", "1", "--runs", "1",
                  "--device", "cpu"])
    assert not [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def test_a_matrix_row_out_of_memory_is_skipped(monkeypatch):
    """A batched matrix row that runs the card out of memory is named under
    ``skipped`` with the allocator's message, and the matrix goes on; any
    other error raises."""
    import torch

    import convsep_tpu_torch.separate.stream as stream

    real = stream.separate_batch

    def short_of_memory(model, tracks, *a, **kw):
        if len(tracks) == 32:
            raise torch.cuda.OutOfMemoryError("Tried to allocate 98.76 GiB")
        return real(model, tracks, *a, **kw)

    monkeypatch.setattr(stream, "separate_batch", short_of_memory)
    skipped = []
    rows = benchmark.preset_matrix(torch.device("cpu"), seconds=1, skipped=skipped)["tinyikala"]
    assert rows["rtf_batched_b16"] > 0 and rows["rtf_batched_vmap"] > 0
    assert rows["rtf_batched_b32"].startswith("skipped: OutOfMemoryError: Tried to allocate")
    assert skipped == [f"matrix:tinyikala:rtf_batched_b32 ({rows['rtf_batched_b32'][9:]})"]

    def broken(*a, **kw):
        raise RuntimeError("batched row broke")

    monkeypatch.setattr(stream, "separate_batch", broken)
    with pytest.raises(RuntimeError, match="batched row broke"):
        benchmark.preset_matrix(torch.device("cpu"), seconds=1)
