"""Training data pipeline: feature scan → segment index → batches → device.

Mirror of ``convsep_tpu.data.pipeline``. :class:`SegmentDataset` indexes
the overlapped ``time_context``-frame segments of a directory of feature
files (data/io.py; memory-mapped, never read whole) and assembles
scaled batches on the host, through the native gather (data/fastbatch.py)
where it is built, else numpy (the same bytes). ``prefetch_to_device`` is
the reference's prefetch thread: one daemon producer assembles the batches
and uploads them at most ``size`` ahead of the consumer, through page-locked
host buffers it reuses and a copy stream of its own, so a step's host work
overlaps the previous step's device work; errors surface on the consumer's
side. ``to_device`` is the one-off upload (a fresh pinned buffer a call).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from convsep_tpu_torch.data.io import load_tensor
from convsep_tpu_torch.data.segment import segment_count

@dataclass
class SegmentDataset:
    """Index of (track, start frame) training segments over a feature
    directory: ``<track>.mix.data`` and ``<track>.<source>.data`` for each
    of ``sources``; ``extra_channels`` names more per-track input channels
    (``<track>.<channel>.data``, e.g. score-informed runs). Segments start
    every ``time_context - overlap`` frames; a track's tail is zero-padded
    into its last segment."""

    root: str
    sources: tuple[str, ...]
    time_context: int = 30
    overlap: int = 20
    mult_factor_in: float = 0.3
    mult_factor_out: float = 0.3
    extra_channels: tuple[str, ...] = ()
    _tracks: list[str] = field(default_factory=list, init=False)
    _index: list[tuple[int, int]] = field(default_factory=list, init=False)
    _cache: dict[str, np.ndarray] = field(default_factory=dict, init=False)

    def __post_init__(self):
        if not (0 <= self.overlap < self.time_context):
            raise ValueError(f"overlap {self.overlap} must be in [0, {self.time_context})")
        names = sorted(
            f[: -len(".mix.data")] for f in os.listdir(self.root) if f.endswith(".mix.data")
        )
        if not names:
            raise FileNotFoundError(f"no *.mix.data feature files under {self.root}")
        self._tracks = names
        step = self.time_context - self.overlap
        for ti, name in enumerate(names):
            for s in self.sources + self.extra_channels:
                p = os.path.join(self.root, f"{name}.{s}.data")
                if not os.path.exists(p):
                    raise FileNotFoundError(f"missing stem feature file {p}")
            n_frames = self._load(name, "mix").shape[0]
            for k in range(segment_count(n_frames, self.time_context, step)):
                self._index.append((ti, k * step))

    def _load(self, name: str, stem: str) -> np.ndarray:
        key = f"{name}.{stem}"
        if key not in self._cache:
            self._cache[key] = load_tensor(os.path.join(self.root, key + ".data"))
        return self._cache[key]

    def __len__(self) -> int:
        return len(self._index)

    @property
    def num_channels(self) -> int:
        return 1 + len(self.extra_channels)

    def _slice(self, arr: np.ndarray, start: int) -> np.ndarray:
        T = self.time_context
        seg = np.asarray(arr[start: start + T], dtype=np.float32)
        if seg.shape[0] < T:  # zero-pad the tail segment
            seg = np.pad(seg, ((0, T - seg.shape[0]), (0, 0)))
        return seg

    def get(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Segment i → (input (T, F, C), targets (S, T, F)), scaled; the
        targets source-major, the model's output layout."""
        ti, start = self._index[i]
        name = self._tracks[ti]
        chans = [self._slice(self._load(name, "mix"), start)]
        for c in self.extra_channels:
            chans.append(self._slice(self._load(name, c), start))
        x = np.stack(chans, axis=-1) * self.mult_factor_in
        y = (
            np.stack([self._slice(self._load(name, s), start) for s in self.sources], axis=0)
            * self.mult_factor_out
        )
        return x, y

    def _assemble(self, idx: np.ndarray, native: bool | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """One batch (x (B, T, F, C), y (B, S, T, F)) of the segments
        ``idx``: the native gather when it is available (``native=None``)
        or asked for, else numpy."""
        from convsep_tpu_torch.data import fastbatch

        if native is None:
            native = fastbatch.available()
        if not native:
            xs, ys = zip(*(self.get(int(i)) for i in idx))
            return np.stack(xs), np.stack(ys)
        seg = np.asarray([self._index[int(i)] for i in idx], np.int64).reshape(-1, 2)
        seg_track, seg_start = seg[:, 0].copy(), seg[:, 1].copy()

        def plane(stem, scale):
            tracks = [np.asarray(self._load(n, stem)) for n in self._tracks]
            return fastbatch.assemble_batch(tracks, seg_track, seg_start, self.time_context,
                                            scale)

        x = np.stack([plane("mix", self.mult_factor_in)]
                     + [plane(c, self.mult_factor_in) for c in self.extra_channels], axis=-1)
        y = np.stack([plane(s, self.mult_factor_out) for s in self.sources], axis=1)
        return x, y

    def batch_indices(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                      drop_remainder: bool = True, start: int = 0) -> Iterator[np.ndarray]:
        """The segment indices of each batch that :meth:`batches` yields."""
        order = np.arange(len(self._index))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = len(order) - batch_size + 1 if drop_remainder else len(order)
        for b0 in range(start * batch_size, max(stop, 0), batch_size):
            yield order[b0: b0 + batch_size]

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        start: int = 0,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One epoch of (inputs (B, T, F, C), targets (B, S, T, F)) float32
        host batches, shuffled by ``seed``. ``start`` skips the first
        ``start`` batches without assembling them (mid-epoch resume); with
        ``drop_remainder=False`` the last batch is zero-padded to B."""
        for idx in self.batch_indices(batch_size, shuffle, seed, drop_remainder, start):
            x, y = self._assemble(idx)
            if x.shape[0] < batch_size:
                pad = batch_size - x.shape[0]
                x = np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
                y = np.pad(y, ((0, pad),) + ((0, 0),) * (y.ndim - 1))
            yield x, y


def to_device(item: Any, device: torch.device) -> Any:
    """numpy arrays and tensors in nested tuples / lists → tensors on
    ``device`` (pinned, non-blocking for CUDA); other leaves unchanged."""
    if isinstance(item, (tuple, list)):
        return type(item)(to_device(x, device) for x in item)
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(np.ascontiguousarray(item))
    if not isinstance(item, torch.Tensor):
        return item
    if device.type == "cuda" and item.device.type == "cpu":
        return item.pin_memory().to(device, non_blocking=True)
    return item.to(device)


class _Raised:
    """An exception raised in the producer, carried to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


_STAGING = object()  # a pool entry taken by the batch being staged


class _Uploader:
    """The producer's side of :func:`prefetch_to_device`: numpy arrays and
    host tensors in nested tuples / lists become tensors on ``device``.
    For a CUDA device each leaf is copied into a page-locked buffer of a
    pool kept per (shape, dtype) and uploaded on the copy stream; one event
    recorded after the batch's copies marks the batch, and a buffer is
    written again only once the event of its last copy has completed. On
    the CPU a leaf becomes a tensor over the same memory (no copy)."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth  # buffers a key may hold: the batches in flight, and one
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._pools: dict[tuple, list[list]] = {}  # key → [[pinned buffer, event | None]]

    def _buffer(self, shape: tuple, dtype: torch.dtype) -> list:
        """A free buffer of the key, marked as taken by the batch being staged."""
        pool = self._pools.setdefault((shape, dtype), [])
        entry = next((e for e in pool if e[1] is None
                      or (e[1] is not _STAGING and e[1].query())), None)
        if entry is None and len(pool) >= self.depth and pool[0][1] is not _STAGING:
            entry = pool.pop(0)  # the oldest copy: wait for it, then reuse its buffer
            entry[1].synchronize()
            pool.append(entry)
        if entry is None:
            entry = [torch.empty(shape, dtype=dtype, pin_memory=True), None]
            pool.append(entry)
        entry[1] = _STAGING
        return entry

    def stage(self, item: Any) -> tuple[Any, torch.cuda.Event | None]:
        """``item`` on the device, its copies enqueued; the event after them."""
        if self.stream is None:
            return _tensors(item), None
        used = []
        with torch.cuda.stream(self.stream):
            out = self._upload(item, used)
        done = torch.cuda.Event()
        done.record(self.stream)
        for entry in used:
            entry[1] = done
        return out, done

    def _upload(self, item: Any, used: list) -> Any:
        if isinstance(item, (tuple, list)):
            return type(item)(self._upload(x, used) for x in item)
        item = _tensors(item)
        if not isinstance(item, torch.Tensor):
            return item
        if item.device.type != "cpu":
            return item.to(self.device)
        entry = self._buffer(tuple(item.shape), item.dtype)
        entry[0].copy_(item)
        used.append(entry)
        return entry[0].to(self.device, non_blocking=True)


def _tensors(item: Any) -> Any:
    """numpy arrays in nested tuples / lists → CPU tensors over their memory."""
    if isinstance(item, (tuple, list)):
        return type(item)(_tensors(x) for x in item)
    if isinstance(item, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(item))
    return item


def _ready(item: Any, done: torch.cuda.Event | None) -> Any:
    """Order the consumer's current stream after the batch's copies and
    tell the caching allocator that stream uses each device tensor."""
    if done is None:
        return item
    leaves = [item]
    while leaves:
        x = leaves.pop()
        if isinstance(x, (tuple, list)):
            leaves.extend(x)
        elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
            current = torch.cuda.current_stream(x.device)
            current.wait_event(done)
            x.record_stream(current)
    return item


_END = object()


def prefetch_to_device(iterator: Iterable, device: str | torch.device, size: int = 2,
                       sharding: Callable[[Any], Any] | None = None) -> Iterator:
    """Yield the iterator's items on ``device``, each leaf a tensor, with
    one daemon producer thread pulling, assembling and uploading them at
    most ``size`` items ahead of the consumer (the reference's bounded
    prefetch queue). ``sharding``: a placer the producer applies to each
    host item before the upload (``distributed.mesh.host_block``: a rank's
    block of the batch, so only that block is copied). An exception in the
    producer is raised here, in the consumer. Closing the generator early
    (a ``break`` out of the loop, an exception in its body) stops the
    producer and waits for it: no thread outlives the loop. See
    :class:`_Uploader` for the copies."""
    if size < 1:
        raise ValueError(f"prefetch size must be at least 1, got {size}")
    device = torch.device(device)
    uploader = _Uploader(device, size + 1)
    source = iter(iterator)
    slots = threading.Semaphore(size)  # items pulled and not yet taken
    stop = threading.Event()
    q: queue.Queue = queue.Queue(maxsize=size + 1)  # the items and the end (or an error)

    def producer():
        try:
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device)
            while True:
                slots.acquire()
                if stop.is_set():
                    return
                try:
                    item = next(source)
                except StopIteration:
                    q.put(_END)
                    return
                q.put(uploader.stage(item if sharding is None else sharding(item)))
        except Exception as e:  # surface pipeline errors on the consumer side
            q.put(_Raised(e))

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is _END:
                return
            if isinstance(got, _Raised):
                raise got.error
            slots.release()
            yield _ready(*got)
    finally:
        stop.set()
        slots.release()  # wake a producer waiting for a slot
        thread.join()
