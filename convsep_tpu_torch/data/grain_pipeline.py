"""Training batches in grain's order, with grain's checkpointable state,
without grain.

Mirror of ``convsep_tpu.data.grain_pipeline``, whose loader is grain's
``DataLoader`` over an ``IndexSampler`` with one ``Batch`` operation
(drop remainder). The port cannot import grain (it imports jax, and the
card's machine has neither), so this module computes what that loader
yields and the state it checkpoints:

* **The order.** ``IndexSampler(shuffle=True, seed=s)`` maps sampler index
  ``i`` of epoch ``e = i // n`` to record ``index_shuffle(i % n, n - 1,
  (s + e) % 2**32, rounds=4)``. grain's C++ ``index_shuffle`` is a Simon
  block cipher (word of ``w/2`` bits, ``w`` the even bit width of the
  largest index, at least 16) keyed by ``std::seed_seq{seed}`` and
  cycle-walked until the index is at most ``max_index``; :func:`index_shuffle`
  computes the same bits.
* **Workers.** With ``worker_count`` W > 0, grain's worker ``k`` reads
  sampler indices ``k, k + W, k + 2W, …``, batches them on its own
  (dropping its own remainder), and the batches come out round robin,
  the iteration ending at the first worker in turn that has no whole batch
  left. Here ``torch.utils.data.DataLoader`` worker processes assemble the
  batches in that order (which process assembles a batch does not change
  its contents).
* **The state** is grain's JSON, key for key and byte for byte:
  ``version``, ``last_seen_indices``, ``last_worker_index``,
  ``worker_count``, ``sampler`` (``repr`` of :class:`IndexSampler`) and
  ``data_source`` (``repr`` of :class:`_Source`), so a data position the
  JAX Trainer wrote resumes here, and the reverse.

One difference is grain's own: where ``n - 1`` is a power of two at least
2**16 (``n`` = 65 537, …), ``ceil(log2(n - 1))`` bits cannot hold the
index ``n - 1``, the cipher reads it truncated, and record ``n - 1`` is
never drawn while another is drawn twice. This module does the same.
"""

from __future__ import annotations

import collections
import json
import math
from typing import Iterator

import numpy as np

_MASK32 = 0xFFFFFFFF
_MIN_BLOCK_BITS = 16
_TABLE_BITS = 20
_VERSION = 2


def _seed_seq(seed: int, n: int) -> list[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` 32-bit words ([rand.util.seedseq])."""
    out = [0x8B8B8B8B] * n
    s = 1
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(out[k % n] ^ out[(k + p) % n] ^ out[(k - 1) % n])) & _MASK32
        r2 = (r1 + (s if k == 0 else (k % n + seed if k <= s else k % n))) & _MASK32
        out[(k + p) % n] = (out[(k + p) % n] + r1) & _MASK32
        out[(k + q) % n] = (out[(k + q) % n] + r2) & _MASK32
        out[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((out[k % n] + out[(k + p) % n] + out[(k - 1) % n]) & _MASK32)
              ) & _MASK32
        r4 = (r3 - k % n) & _MASK32
        out[(k + p) % n] ^= r3
        out[(k + q) % n] ^= r4
        out[k % n] = r4
    return out


def _simon(v: np.ndarray, keys: list[int], half: int) -> np.ndarray:
    """grain's ``simon_encrypt<half>``: two ``half``-bit words, two rounds a
    key pair."""
    mask = np.uint64((1 << half) - 1)

    def rotl(x, k):
        return ((x << np.uint64(k)) | (x >> np.uint64(half - k))) & mask

    def f(x):
        return rotl(x, 2) ^ (rotl(x, 8) & rotl(x, 1))

    x = (v >> np.uint64(half)) & mask
    y = v & mask
    for i in range(0, len(keys), 2):
        x = x ^ f(y) ^ (np.uint64(keys[i]) & mask)
        y = y ^ f(x) ^ (np.uint64(keys[i + 1]) & mask)
    return (x << np.uint64(half)) | y


def index_shuffle(index, max_index: int, seed: int, rounds: int = 4):
    """Position of ``index`` (an int or an array of them) in grain's
    pseudorandom permutation of ``[0, max_index]``: grain's C++
    ``index_shuffle`` bit for bit."""
    if rounds < 4 or rounds % 2:
        raise ValueError(f"rounds must be even and at least 4, got {rounds}")
    scalar = np.ndim(index) == 0
    v = np.atleast_1d(np.asarray(index, np.uint64))
    if max_index == 0:
        out = np.zeros_like(v)
    else:
        bits = int(math.ceil(math.log2(float(max_index))))
        bits = max(bits + bits % 2, _MIN_BLOCK_BITS)
        keys = _seed_seq(seed & _MASK32, rounds)
        top = np.uint64(max_index)
        if bits <= _TABLE_BITS:
            # the walk back into [0, max_index] can take up to 2**bits steps
            # where max_index is small: the cipher on the whole domain once,
            # then pointer doubling (each entry jumps to the first in-range
            # index on its path; bits rounds cover any cycle)
            step = _simon(np.arange(1 << bits, dtype=np.uint64), keys, bits // 2)
            for _ in range(bits):
                step = np.where(step > top, step[step.astype(np.int64)], step)
            out = step[(v & np.uint64((1 << bits) - 1)).astype(np.int64)]
        else:  # max_index ≥ 2**(bits - 2): a few steps on average
            out = _simon(v, keys, bits // 2)
            todo = out > top
            while todo.any():  # cycle-walk back into [0, max_index]
                out[todo] = _simon(out[todo], keys, bits // 2)
                todo = out > top
    return int(out[0]) if scalar else out.astype(np.int64)


class IndexSampler:
    """grain's ``IndexSampler`` over ``num_records`` records without
    sharding: sampler index ``i`` → record key, ``num_epochs`` epochs
    (None: endless), each epoch shuffled with ``seed + epoch``."""

    def __init__(self, num_records: int, shuffle: bool = False,
                 num_epochs: int | None = None, seed: int | None = None):
        if num_records <= 0:
            raise ValueError(f"num_records must be positive, got {num_records}")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(f"num_epochs must be positive, got {num_epochs}")
        if shuffle and seed is None:
            raise ValueError("Shuffling requires specifying a seed.")
        if seed is not None and (seed < 0 or seed.bit_length() > 32):
            raise ValueError("Seed should be positive 32-bit integer.")
        self.num_records = num_records
        self.shuffle = shuffle
        self.num_epochs = num_epochs
        self.seed = seed
        self._epochs: dict[int, np.ndarray] = {}

    def __repr__(self) -> str:
        return (f"IndexSampler(num_records={self.num_records}, shard_options=NoSharding("
                f"shard_index=0, shard_count=1, drop_remainder=False), shuffle={self.shuffle}, "
                f"num_epochs={self.num_epochs}, seed={self.seed})")

    def in_range(self, index: int) -> bool:
        return self.num_epochs is None or index < self.num_epochs * self.num_records

    def record_key(self, index: int) -> int:
        n = self.num_records
        epoch, i = divmod(index, n)
        if not self.shuffle:
            return i
        if epoch not in self._epochs:
            self._epochs = {epoch: index_shuffle(np.arange(n), n - 1,
                                                 (self.seed + epoch) % 2**32)}
        return int(self._epochs[epoch][i])


class _Source:
    """The reference's grain data source over a dataset's segments: its
    ``repr`` is what a checkpointed state is validated against."""

    def __init__(self, ds):
        self._ds = ds

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, i: int):
        return self._ds.get(int(i))

    def __repr__(self) -> str:
        ds = self._ds
        return (f"_Source({type(ds).__name__}, root={ds.root!r}, "
                f"sources={ds.sources!r}, n={len(ds)})")


def _stack(items: list) -> tuple:
    return tuple(np.stack(leaf) for leaf in zip(*items))


class DataLoader:
    """What grain's ``DataLoader(data_source=_Source(ds), sampler=…,
    operations=[Batch(batch_size, drop_remainder=True)], worker_count=…)``
    yields; ``iter()`` gives a :class:`LoaderIterator` with grain's
    ``get_state`` / ``set_state``."""

    def __init__(self, source: _Source, sampler: IndexSampler, batch_size: int,
                 worker_count: int = 0):
        if worker_count < 0:
            raise ValueError(f"worker_count must be at least 0, got {worker_count}")
        self.source = source
        self.sampler = sampler
        self.batch_size = batch_size
        self.worker_count = worker_count

    def __iter__(self) -> "LoaderIterator":
        return LoaderIterator(self)

    def validate(self, state: dict) -> None:
        for key, want in (("worker_count", self.worker_count), ("sampler", repr(self.sampler)),
                          ("data_source", repr(self.source))):
            if state[key] != want:
                raise ValueError(f"{key} in checkpoint does not match the loader's:\n"
                                 f"checkpoint: {state[key]}\nloader: {want}")


class LoaderIterator:
    """Batches in grain's order, and after each one the state grain's
    iterator reports at that point."""

    def __init__(self, loader: DataLoader):
        self._loader = loader
        self._workers = max(loader.worker_count, 1)
        self._next = [0] * self._workers  # records each worker's batches consumed
        self._last_worker = -1
        self._it: Iterator | None = None

    def _batch_keys(self, worker: int, first: int) -> list[int] | None:
        """Record keys of the worker's batch starting at its record
        ``first``; None where fewer than a batch remain."""
        W, b, sampler = self._workers, self._loader.batch_size, self._loader.sampler
        idx = [worker + (first + t) * W for t in range(b)]
        if not sampler.in_range(idx[-1]):
            return None
        return [sampler.record_key(i) for i in idx]

    def _plan(self, owners: collections.deque) -> Iterator[list[int]]:
        """Each batch's record keys, round robin from the worker after the
        last one; ``owners`` gets the worker of every batch handed out."""
        nxt = list(self._next)
        w = (self._last_worker + 1) % self._workers
        while True:
            keys = self._batch_keys(w, nxt[w])
            if keys is None:
                return
            nxt[w] += self._loader.batch_size
            owners.append(w)
            yield keys
            w = (w + 1) % self._workers

    def _start(self) -> Iterator:
        owners: collections.deque = collections.deque()
        src = self._loader.source
        if self._loader.worker_count == 0:
            batches = (_stack([src[k] for k in keys]) for keys in self._plan(owners))
        else:
            import torch.utils.data

            # spawned, not forked: a fork copies the caller's threads' locks
            # (a Trainer's prefetch thread builds this iterator)
            batches = iter(torch.utils.data.DataLoader(
                src, batch_sampler=self._plan(owners), collate_fn=_stack,
                num_workers=self._loader.worker_count, multiprocessing_context="spawn"))
        for batch in batches:
            w = owners.popleft()
            self._next[w] += self._loader.batch_size
            self._last_worker = w if self._loader.worker_count else -1
            yield batch

    def __iter__(self) -> "LoaderIterator":
        return self

    def __next__(self):
        if self._it is None:
            self._it = self._start()
        return next(self._it)

    def get_state(self) -> bytes:
        W = self._workers
        state = {
            "version": _VERSION,
            "last_seen_indices": {str(i): -W + i + self._next[i] * W for i in range(W)},
            "last_worker_index": self._last_worker,
            "worker_count": self._loader.worker_count,
            "sampler": repr(self._loader.sampler),
            "data_source": repr(self._loader.source),
        }
        return json.dumps(state, indent=4).encode()

    def set_state(self, state: bytes | str) -> None:
        state = json.loads(state)
        self._loader.validate(state)
        W = self._workers
        seen = state["last_seen_indices"]
        self._next = [(seen[str(i)] + W - i) // W for i in range(W)]
        self._last_worker = state["last_worker_index"]
        self._it = None


def make_loader(ds, batch_size: int, seed: int = 0, num_epochs: int | None = 1,
                shuffle: bool = True, worker_count: int = 0) -> DataLoader:
    """Deterministic (seeded) loader of ``(x, y)`` batches in grain's order
    whose iterators checkpoint as grain's do."""
    sampler = IndexSampler(len(ds), shuffle=shuffle, num_epochs=num_epochs, seed=seed)
    return DataLoader(_Source(ds), sampler, batch_size, worker_count)


def batches(ds, batch_size: int, seed: int = 0) -> Iterator:
    """One deterministic epoch of ``(x, y)`` batches."""
    return iter(make_loader(ds, batch_size, seed=seed, num_epochs=1))


def stateful_batches(loader: DataLoader, state: str | bytes | None = None) -> Iterator:
    """Yield ``(batch, state)`` pairs: the state (a string) is the position
    *after* that batch, so checkpointing the last consumed one resumes on
    exactly the unseen batches, however far a prefetch queue ran ahead.
    ``state`` (from a checkpoint) resumes the iterator."""
    it = iter(loader)
    if state is not None:
        it.set_state(state.encode() if isinstance(state, str) else state)
    for batch in it:
        yield batch, it.get_state().decode()
