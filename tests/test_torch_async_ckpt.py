"""The asynchronous checkpoint writer, on CPU (``ckpt/checkpoint.py``): a
save that starts while another is in flight, a writer stalled past
``async_timeout_s`` (the watchdog's fallback to synchronous saves, as
``tests/test_utils.py::test_checkpoint_watchdog_falls_back_to_sync`` holds
the reference's manager), a write killed midway, a write that fails, and
a script that ends without waiting. Restored states bit for bit."""

import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from convsep_tpu_torch.ckpt import checkpoint
from convsep_tpu_torch.ckpt.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(v: float) -> dict:
    return {"step": int(v), "w": torch.arange(4, dtype=torch.float32) * v}


class _Gate:
    """``torch.save`` that blocks its first ``blocked`` calls until
    released (a wedged or slow writer)."""

    def __init__(self, monkeypatch, blocked: int = 1):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = 0
        self.blocked = blocked
        real = checkpoint.torch.save

        def save(obj, path):
            self.calls += 1
            if self.calls <= self.blocked:
                self.entered.set()
                self.release.wait(30)
            real(obj, path)

        monkeypatch.setattr(checkpoint.torch, "save", save)


def test_save_waits_for_the_write_in_flight(tmp_path, monkeypatch):
    gate = _Gate(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True, async_timeout_s=30.0)
    t0 = time.perf_counter()
    assert mgr.save(1, _state(1), extra={"epoch": 0})
    assert time.perf_counter() - t0 < 5  # the caller is not held by the write
    assert gate.entered.wait(10)
    # the write is in flight: nothing is listed on disk yet
    assert not [d for d in os.listdir(tmp_path / "ck") if d.isdigit()]
    done = []
    second = threading.Thread(target=lambda: done.append(mgr.save(2, _state(2))))
    second.start()
    time.sleep(0.3)
    assert not done  # the second save waits for the first write
    gate.release.set()
    second.join(30)
    assert done == [True] and mgr.wait() and not mgr.fell_back_to_sync
    assert mgr.all_steps() == [1, 2]
    got, meta = CheckpointManager(str(tmp_path / "ck")).restore(1, _state(0))
    assert torch.equal(got["w"], _state(1)["w"]) and meta == {"epoch": 0}
    got, _ = mgr.restore_latest(_state(0))
    assert got["step"] == 2 and torch.equal(got["w"], _state(2)["w"])


def test_stalled_writer_falls_back_to_sync(tmp_path, monkeypatch):
    """Mirror of the reference's watchdog test: the next save finds the
    write wedged past the timeout, warns, drops that step and saves
    synchronously from then on."""
    gate = _Gate(monkeypatch)
    warnings = []
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True, async_timeout_s=0.5,
                            on_warning=warnings.append)
    mgr.save(1, _state(1), extra={"epoch": 0})
    assert gate.entered.wait(10)
    mgr.save(2, _state(2), extra={"epoch": 0, "batch_in_epoch": 2})
    assert mgr.fell_back_to_sync and warnings and "SYNCHRONOUS" in warnings[0]
    assert "within 0.5s" in warnings[0]
    assert mgr.wait(timeout=30.0)  # synchronous now: nothing outstanding
    restored, meta = mgr.restore_latest(_state(0))
    assert restored["step"] == 2 and meta["batch_in_epoch"] == 2
    torch.testing.assert_close(restored["w"], _state(2)["w"], rtol=0, atol=0)
    # the wedged writer, released, does not land its dropped step
    gate.release.set()
    deadline = time.time() + 10
    while any(d.startswith(".tmp-1-") for d in os.listdir(tmp_path / "ck")):
        assert time.time() < deadline
        time.sleep(0.05)
    assert mgr.all_steps() == [2]
    # and wait() times out the same way on a later wedge
    gate2 = _Gate(monkeypatch)
    mgr2 = CheckpointManager(str(tmp_path / "ck2"), async_timeout_s=30.0,
                             on_warning=warnings.append)
    mgr2.save(1, _state(1))
    assert gate2.entered.wait(10)
    assert mgr2.wait(timeout=0.2) is False and mgr2.fell_back_to_sync
    gate2.release.set()


def test_killed_write_is_never_listed(tmp_path, monkeypatch):
    """A write killed midway (the process gone after part of the file)
    leaves a temporary directory: no read lists it, the last finished
    step restores, and later saves go on."""
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d), async_save=True)
    mgr.save(1, _state(1))
    mgr.wait()
    tmp = d / ".tmp-2-killed"
    tmp.mkdir()
    (tmp / "state.pt").write_bytes(b"PK\x03\x04 partial")
    (d / "3").mkdir()  # a step directory whose metadata never came
    (d / "3" / "state.pt").write_bytes(b"partial")
    fresh = CheckpointManager(str(d))
    assert fresh.all_steps() == [1] and fresh.latest_step() == 1
    got, _ = fresh.restore_latest(_state(0))
    assert torch.equal(got["w"], _state(1)["w"])
    assert fresh.save(4, _state(4)) and fresh.wait()
    assert fresh.all_steps() == [1, 4]


def test_failed_write_raises_at_the_next_call(tmp_path, monkeypatch):
    def boom(obj, path):
        raise OSError("disk full")

    mgr = CheckpointManager(str(tmp_path / "ck"))
    monkeypatch.setattr(checkpoint.torch, "save", boom)
    assert mgr.save(1, _state(1))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [] and not os.listdir(tmp_path / "ck")


def test_the_save_blocks_only_for_the_host_copy(tmp_path, monkeypatch):
    """With a slow write, the caller returns while the file is written: the
    leaves it handed over are copies, so later in-place updates of the
    live tensors do not reach the checkpoint."""
    gate = _Gate(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    live = _state(3)
    mgr.save(3, live)
    live["w"].add_(100.0)  # training goes on in place
    gate.release.set()
    got, _ = mgr.restore_latest(_state(0))
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4, dtype=np.float32) * 3)


def test_a_script_that_exits_finishes_its_last_write(tmp_path):
    """A process that saves and ends without ``wait()`` (a CLI verb, a
    script) still finishes the write in flight: the writer thread is not
    a daemon."""
    script = textwrap.dedent(f"""
        import time, torch
        from convsep_tpu_torch.ckpt import checkpoint
        real = checkpoint.torch.save
        def slow(obj, path):
            time.sleep(1.0)
            real(obj, path)
        checkpoint.torch.save = slow
        mgr = checkpoint.CheckpointManager({str(tmp_path / "ck")!r})
        assert mgr.save(4, {{"w": torch.arange(3.0)}})
        print("saved")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "saved", out.stderr[-2000:]
    got, _ = CheckpointManager(str(tmp_path / "ck")).restore_latest({"w": torch.zeros(3)})
    assert torch.equal(got["w"], torch.arange(3.0))
