"""Training data pipeline: feature scan → segment index → batches → device.

Mirror of ``convsep_tpu.data.pipeline``. :class:`SegmentDataset` indexes
the overlapped ``time_context``-frame segments of a directory of feature
files (data/io.py; memory-mapped, never read whole) and assembles
scaled batches on the host, through the native gather (data/fastbatch.py)
where it is built, else numpy (the same bytes). ``prefetch_to_device`` is
a one-deep prefetch on the caller's thread: batch i + 1 is assembled on
the host and its copy enqueued while the device still runs step i
(PyTorch returns from a step before the device finishes it). Arrays go
through pinned host buffers and ``non_blocking`` copies to an explicit
device; the caching host allocator keeps a pinned buffer alive until its
copy is done.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Iterator

import numpy as np
import torch

from convsep_tpu_torch.data.io import load_tensor
from convsep_tpu_torch.data.segment import segment_count

_EMPTY = object()


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


def prefetch_to_device(iterator: Iterator, device: str | torch.device) -> Iterator:
    """Yield the iterator's items on ``device``, one item ahead: each item's
    copy is enqueued before the previous item is handed out."""
    device = torch.device(device)
    pending = _EMPTY
    for item in iterator:
        item = to_device(item, device)
        if pending is not _EMPTY:
            yield pending
        pending = item
    if pending is not _EMPTY:
        yield pending
