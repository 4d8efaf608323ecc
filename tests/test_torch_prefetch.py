"""``data/pipeline.py::prefetch_to_device`` on CPU: the reference's prefetch
thread (``convsep_tpu/data/pipeline.py::prefetch_to_device``) with a
bounded lead. Order, the lead of at most ``size`` items, a producer's
exception raised in the consumer, and no thread left behind when the
consumer stops early, by a ``break``, an exception or ``Trainer.fit``'s
``max_steps``. On the CPU no copy is made: a leaf is a tensor over the
array's own memory. (The pinned pool and the copy stream run only on a
card: ``tests/test_torch_cuda.py``.)"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from convsep_tpu.data.pipeline import prefetch_to_device as jax_prefetch
from convsep_tpu_torch.data.pipeline import prefetch_to_device

WAIT_S = 5.0  # how long a test waits for the producer to reach its lead


class Recorder:
    """An iterator over ``n`` numbered batches (None: endless) that records
    how many items have been pulled, and raises ``fail`` after ``fail_after``."""

    def __init__(self, n=None, fail_after=None, fail=ValueError("bad batch")):
        self.n, self.fail_after, self.fail = n, fail_after, fail
        self.pulled = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.fail_after is not None and self.pulled == self.fail_after:
            raise self.fail
        if self.n is not None and self.pulled >= self.n:
            raise StopIteration
        i = self.pulled
        self.pulled += 1
        return np.full((2, 3), i, np.float32), np.arange(i, i + 4)


def producers():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device" and t.is_alive()]


def wait_for(cond):
    end = time.monotonic() + WAIT_S
    while not cond() and time.monotonic() < end:
        time.sleep(0.002)
    return cond()


def test_order_and_leaves_match_the_reference():
    items = [(np.ones(3) * i, (np.arange(4.0) + i, np.zeros(2))) for i in range(5)]
    got = list(prefetch_to_device(items, "cpu"))
    want = list(jax_prefetch(iter(items)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        leaves = [g[0], g[1][0], g[1][1]]
        assert all(isinstance(t, torch.Tensor) for t in leaves)
        for t, r in zip(leaves, [w[0], w[1][0], w[1][1]]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    other = list(prefetch_to_device([("single", np.ones(3), None)] * 2, "cpu"))
    assert [(o[0], o[2]) for o in other] == [("single", None)] * 2
    assert not producers()


def test_no_copy_on_the_cpu():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    (t,) = list(prefetch_to_device([a], "cpu"))
    assert t.data_ptr() == a.__array_interface__["data"][0]


@pytest.mark.parametrize("size", [1, 2, 3])
def test_producer_runs_at_most_size_ahead(size):
    src = Recorder(n=12)
    taken = 0
    for x, idx in prefetch_to_device(src, "cpu", size=size):
        assert int(x[0, 0]) == taken and idx.tolist() == list(range(taken, taken + 4))
        taken += 1
        lead = min(taken + size, src.n)
        # the producer reaches its full lead while the consumer holds an item
        assert wait_for(lambda: src.pulled >= lead), (taken, src.pulled)
        time.sleep(0.01)  # and goes no further
        assert src.pulled == lead, (taken, src.pulled)
    assert taken == 12 and not producers()


def test_producer_error_reaches_the_consumer():
    src = Recorder(fail_after=3, fail=KeyError("missing track"))
    got = []
    with pytest.raises(KeyError, match="missing track"):
        for x, _ in prefetch_to_device(src, "cpu"):
            got.append(int(x[0, 0]))
    assert got == [0, 1, 2]
    assert wait_for(lambda: not producers())


def test_closing_early_ends_the_thread():
    src = Recorder()  # endless
    gen = prefetch_to_device(src, "cpu", size=2)
    assert int(next(gen)[0][0, 0]) == 0 and int(next(gen)[0][0, 0]) == 1
    assert len(producers()) == 1
    gen.close()
    assert not producers()
    pulled = src.pulled
    time.sleep(0.02)
    assert src.pulled == pulled <= 2 + 2


@pytest.mark.parametrize("how", ["break", "raise"])
def test_leaving_the_loop_ends_the_thread(how):
    for _ in range(3):  # repeated loops do not pile up threads
        with pytest.raises(RuntimeError) if how == "raise" else contextlib.nullcontext():
            for i, _ in enumerate(prefetch_to_device(Recorder(), "cpu")):
                if i == 4:
                    if how == "raise":
                        raise RuntimeError("step failed")
                    break
        assert wait_for(lambda: not producers())


def test_size_must_be_positive():
    with pytest.raises(ValueError, match="at least 1"):
        next(prefetch_to_device([np.zeros(1)], "cpu", size=0))
