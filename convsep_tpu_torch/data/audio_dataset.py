"""Raw-audio training dataset: wav segments, no offline feature pass.

Mirror of ``convsep_tpu.data.audio_dataset`` (mono): the STFT runs inside
the training step (:mod:`convsep_tpu_torch.train.e2e`), so training reads
wav stems and slices fixed-size segments. ``seg_samples = (T - 2) * hop``
makes the reference's frame count land exactly on the model's
time_context. Stereo segments are not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.io import read_wav


def segment_samples(preset: Preset) -> int:
    """Samples per training segment so num_frames == time_context."""
    return (preset.model.time_context - 2) * preset.transform.hop_size


@dataclass
class AudioSegmentDataset:
    """(track, start) index over ``<root>/<track>/<stem>.wav`` stems.

    Yields float32 segments: mixture (seg,) and targets (S, seg). The
    mixture is ``mixture.wav`` if present, else the sum of the stems.
    """

    root: str
    sources: tuple[str, ...]
    seg_samples: int
    overlap_samples: int = 0
    fs: int = 44100
    stereo: bool = False
    _tracks: list[dict] = field(default_factory=list, init=False)
    _index: list[tuple[int, int]] = field(default_factory=list, init=False)

    def __post_init__(self):
        if self.stereo:
            raise NotImplementedError(
                "stereo training segments are not ported (ROADMAP queue 1)"
            )
        if not (0 <= self.overlap_samples < self.seg_samples):
            raise ValueError("overlap must be in [0, seg_samples)")
        names = sorted(
            d for d in os.listdir(self.root) if os.path.isdir(os.path.join(self.root, d))
        )
        if not names:
            raise FileNotFoundError(f"no track directories under {self.root}")
        step = self.seg_samples - self.overlap_samples
        for name in names:
            tdir = os.path.join(self.root, name)
            stems = {}
            for s in self.sources:
                fs, a = read_wav(os.path.join(tdir, f"{s}.wav"))
                if fs != self.fs:
                    raise ValueError(f"{name}/{s}: fs {fs} != {self.fs}")
                stems[s] = _mono(a)
            n = min(a.shape[-1] for a in stems.values())
            stems = {s: a[..., :n] for s, a in stems.items()}
            mp = os.path.join(tdir, "mixture.wav")
            if os.path.exists(mp):
                _, mix = read_wav(mp)
                mix = _mono(mix)[..., :n]
            else:
                mix = np.sum(list(stems.values()), axis=0)
            ti = len(self._tracks)
            self._tracks.append({"mix": mix, **stems})
            n_segs = max(1, int(np.ceil(max(n - self.seg_samples, 0) / step)) + 1)
            for k in range(n_segs):
                self._index.append((ti, k * step))

    def __len__(self) -> int:
        return len(self._index)

    def _slice(self, a: np.ndarray, start: int) -> np.ndarray:
        seg = np.asarray(a[..., start : start + self.seg_samples], np.float32)
        short = self.seg_samples - seg.shape[-1]
        if short > 0:
            seg = np.pad(seg, [(0, 0)] * (seg.ndim - 1) + [(0, short)])
        return seg

    def get(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        ti, start = self._index[i]
        tr = self._tracks[ti]
        mix = self._slice(tr["mix"], start)
        stems = np.stack([self._slice(tr[s], start) for s in self.sources])
        return mix, stems

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        start: int = 0,
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(mix (B, seg), stems (B, S, seg)) float32 batches. ``start``
        skips the first ``start`` batches unassembled (mid-epoch resume);
        with ``drop_remainder=False`` the last batch may be short."""
        order = np.arange(len(self._index))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = len(order) - batch_size + 1 if drop_remainder else len(order)
        for b0 in range(start * batch_size, max(stop, 0), batch_size):
            idx = order[b0 : b0 + batch_size]
            xs, ys = zip(*(self.get(int(i)) for i in idx))
            yield np.stack(xs), np.stack(ys)


def _mono(a: np.ndarray) -> np.ndarray:
    """wav array → mono (n,): channels averaged."""
    return a.mean(axis=1) if a.ndim == 2 else a
