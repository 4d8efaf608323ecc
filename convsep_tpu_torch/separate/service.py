"""Watch-folder separation service: a minimal serving loop.

Mirror of ``convsep_tpu.separate.service``. The service watches a directory
for mixture wavs and separates them in batches as they arrive:

    >>> svc = WatchService(preset, state, "incoming/", "done/", device="cuda")
    >>> svc.run()                       # poll forever

One :class:`~convsep_tpu_torch.separate.stream.StreamSeparator` (PCM16 in
and out) holds the model; each sweep batches whatever arrived since the
last (up to ``batch_size`` a batch). A track is done when its stem
directory holds every stem wav, so restarting the service resumes (a
partly written track is separated again). A file whose size changed
between two sweeps is still being written and is left for the next sweep.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.features import score_channels
from convsep_tpu_torch.data.io import read_wav, write_wav
from convsep_tpu_torch.dsp.transform import TransformFFT
from convsep_tpu_torch.score import parse_note_annotations
from convsep_tpu_torch.separate.stream import StreamSeparator


class WatchService:
    """Separate the wavs that arrive in ``input_dir`` into
    ``out_dir/<track>/<source>.wav``.

    ``score_dir``: score-informed serving (mono presets only):
    ``<score_dir>/<track>/<source>.notes.txt`` must exist beside each
    incoming wav; its channels come from ``TransformFFT``,
    ``score_channels`` (``score_filter``) and ``parse_note_annotations``.
    ``mesh``: every rank of the mesh runs the service; rank 0 decides
    what is pending and writes the stems, and each rank separates its block
    of every batch (the stream separator's ``mesh``). ``device``: ``None``
    means "cuda" (raises without a GPU), the rank's device under a mesh.
    """

    def __init__(
        self,
        preset: Preset,
        state: dict[str, torch.Tensor],
        input_dir: str,
        out_dir: str,
        batch_size: int = 4,
        poll_s: float = 1.0,
        mesh=None,
        score_dir: str | None = None,
        score_filter: str = "comb",
        device: str | torch.device | None = None,
    ):
        self.preset = preset
        self.input_dir = input_dir
        self.out_dir = out_dir
        self.batch_size = int(batch_size)
        self.poll_s = float(poll_s)
        self.stereo = preset.model.decoder_reduce == "all"
        if score_dir is not None and self.stereo:
            raise ValueError("score-informed serving is mono-preset only")
        self.score_dir = score_dir
        self.score_filter = score_filter
        self.mesh = mesh
        self.sep = StreamSeparator(preset, state, mesh=mesh, output_dtype="int16",
                                   input_dtype="int16", device=device)
        self._writer = mesh is None or torch.distributed.get_rank() == 0
        self._sizes: dict[str, int] = {}
        os.makedirs(out_dir, exist_ok=True)

    def _done(self, name: str) -> bool:
        d = os.path.join(self.out_dir, name)
        return all(os.path.exists(os.path.join(d, f"{s}.wav")) for s in self.preset.sources)

    def _stable(self, path: str) -> bool:
        """Only files whose size did not change since the last sweep (a
        writer may still be uploading the others)."""
        size = os.path.getsize(path)
        prev = self._sizes.get(path)
        self._sizes[path] = size
        return prev == size

    def pending(self) -> list[str]:
        """The tracks to separate now, by name, sorted."""
        names = sorted(f[: -len(".wav")] for f in os.listdir(self.input_dir)
                       if f.endswith(".wav"))
        out = []
        for n in names:
            if self._done(n):
                continue
            if self.score_dir is not None and not all(
                os.path.exists(os.path.join(self.score_dir, n, f"{s}.notes.txt"))
                for s in self.preset.sources
            ):
                continue  # the wav arrived before its score: the next sweep
            if self._stable(os.path.join(self.input_dir, n + ".wav")):
                out.append(n)
        return out

    def _extra(self, name: str, audio: np.ndarray) -> np.ndarray:
        mag = TransformFFT(self.preset.transform, device=self.sep.device).compute_file(
            np.asarray(audio, np.float32))
        notes = [
            parse_note_annotations(os.path.join(self.score_dir, name, f"{s}.notes.txt"))
            for s in self.preset.sources
        ]
        return score_channels(mag, notes, self.preset,
                              self.score_filter) * self.preset.train.mult_factor_in

    def _read(self, name: str) -> np.ndarray:
        fs, audio = read_wav(os.path.join(self.input_dir, name + ".wav"))
        if fs != self.preset.transform.fs:
            raise ValueError(f"{name}: fs {fs} != preset fs {self.preset.transform.fs}")
        if self.stereo:
            if audio.ndim != 2:
                raise ValueError(f"{name}: stereo preset needs a stereo wav")
            return audio.T[:2]
        return audio.mean(axis=1) if audio.ndim == 2 else audio

    def _write(self, name: str, stems: np.ndarray) -> None:
        outdir = os.path.join(self.out_dir, name)
        os.makedirs(outdir, exist_ok=True)
        for sname, stem in zip(self.preset.sources, stems):
            write_wav(os.path.join(outdir, f"{sname}.wav"), self.preset.transform.fs,
                      stem.T if self.stereo else stem)

    def sweep(self) -> int:
        """Separate everything pending now; returns the tracks separated."""
        done = 0
        names = self.pending() if self._writer else None
        if self.mesh is not None:  # every rank takes rank 0's list
            box = [names]
            torch.distributed.broadcast_object_list(box, src=0)
            names = box[0]
        while names:
            batch, names = names[: self.batch_size], names[self.batch_size:]
            tracks = [self._read(n) for n in batch]
            extras = ([self._extra(n, t) for n, t in zip(batch, tracks)]
                      if self.score_dir is not None else None)
            for n, stems in zip(batch, self.sep.separate_many(tracks, extras=extras)):
                if self._writer:
                    self._write(n, stems)
                done += 1
        return done

    def run(
        self,
        max_sweeps: int | None = None,
        should_stop: Callable[[], bool] | None = None,
        on_sweep: Callable[[int], None] | None = None,
    ) -> int:
        """Poll loop; returns the tracks separated in all. Stops after
        ``max_sweeps`` sweeps (None: never) or when ``should_stop()``."""
        total = 0
        sweeps = 0
        while True:
            n = self.sweep()
            total += n
            sweeps += 1
            if on_sweep is not None:
                on_sweep(n)
            if max_sweeps is not None and sweeps >= max_sweeps:
                return total
            if should_stop is not None and should_stop():
                return total
            time.sleep(self.poll_s)
