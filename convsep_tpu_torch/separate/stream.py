"""Batched multi-track separation.

Mirror of ``convsep_tpu.separate.stream``. Tracks are bucketed to one
length, stacked on a leading batch axis and separated together; a producer
thread prepares batch k + 1 (bucketing, PCM16 conversion, pinned staging,
the upload on the separator's copy stream) while batch k computes, and
batch k − 1's stems are copied out meanwhile on the same copy stream.

On one card the mono batch runs as one batch through
:func:`~convsep_tpu_torch.separate.pipeline.separate_fused_batch` (the
model sees B · nseg segments at once; one Wiener+iSTFT launch a batch). The
reference's ``lax.map`` choice on one TPU was about XLA's compile time and
memory, which a PyTorch loop does not have; its loop is kept as
:func:`separate_batch_scan`. The ``fft_impl="pallas"`` route and the stereo
route take one track at a time, as the reference's kernels do.

Not ported: ``mesh=`` (ROADMAP queue 1 item 9, distributed) and
``apply_fn=`` (no caller of the reference passes it; ROADMAP.md, "Also left
out"); both raise.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.separate.pipeline import (
    bucket_length,
    check_options,
    check_supported,
    separate_fused,
    separate_fused_batch,
)
from convsep_tpu_torch.separate.stereo import separate_fused_stereo
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.pcm import quantize_pcm16_host
from convsep_tpu_torch.utils.transfer import (
    fetch_async,
    host_array,
    stage_pinned,
    upload_async,
    wait_upload,
)


def _no_apply_fn(apply_fn) -> None:
    if apply_fn is not None:
        raise NotImplementedError(
            "apply_fn= (a model override) is not ported: no caller of the reference "
            "passes it, its bench and CLI included (ROADMAP.md, \"Also left out\")"
        )


def _track_extra(extra: torch.Tensor | None, i: int) -> torch.Tensor | None:
    """Track i's channels: shared (nf, F, C − 1) or per track (B, nf, F, C − 1)."""
    if extra is None or extra.dim() == 3:
        return extra
    return extra[i]


def separate_batch(
    model: ConvSep,
    tracks: torch.Tensor,
    preset: Preset,
    length: int,
    apply_fn=None,
    output_dtype: str = "float32",
    extra: torch.Tensor | None = None,
    conserve_last: bool = False,
) -> torch.Tensor:
    """(B, length) mixtures → (B, S, length) stems, one batch through
    :func:`~convsep_tpu_torch.separate.pipeline.separate_fused_batch`;
    ``fft_impl="pallas"`` presets take :func:`separate_batch_vmap`, whose
    kernels take one track at a time.

    ``extra``: score-informed channels, (B, n_frames, F, C − 1) per track
    or (n_frames, F, C − 1) shared by every track. ``conserve_last``:
    conservative Wiener masks (Σ masks = 1), so that the caller may derive
    the last stem on the host."""
    _no_apply_fn(apply_fn)
    if preset.transform.fft_impl == "pallas":
        return separate_batch_vmap(model, tracks, preset, length, apply_fn, output_dtype,
                                   extra, conserve_last)
    return separate_fused_batch(model, tracks, preset, length, output_dtype, conserve_last,
                                extra)


def separate_batch_vmap(
    model: ConvSep,
    tracks: torch.Tensor,
    preset: Preset,
    length: int,
    apply_fn=None,
    output_dtype: str = "float32",
    extra: torch.Tensor | None = None,
    conserve_last: bool = False,
) -> torch.Tensor:
    """:func:`separate_batch` one track at a time through
    :func:`~convsep_tpu_torch.separate.pipeline.separate_fused` (the
    reference's vmap of the single-track program): the route of
    ``fft_impl="pallas"`` presets, whose kernels take one track."""
    _no_apply_fn(apply_fn)
    return torch.stack([
        separate_fused(model, tracks[i], preset, length, output_dtype, conserve_last,
                       _track_extra(extra, i))
        for i in range(tracks.shape[0])
    ])


def separate_batch_scan(
    model: ConvSep,
    tracks: torch.Tensor,
    preset: Preset,
    length: int,
    apply_fn=None,
    output_dtype: str = "float32",
    group: int | None = None,
    extra: torch.Tensor | None = None,
    conserve_last: bool = False,
) -> torch.Tensor:
    """(B, length) → (B, S, length) like :func:`separate_batch`, with the
    tracks run in groups of ``group`` (default 1) one after another: the
    working set of ``group`` tracks. The model's composed operands are
    prepared once, outside the loop (``ConvSep.prepare_inference``)."""
    _no_apply_fn(apply_fn)
    g = 1 if group is None else int(group)
    if g < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    B = tracks.shape[0]
    parts = []
    for s in range(0, B, g):
        ex = extra if extra is None or extra.dim() == 3 else extra[s:s + g]
        parts.append(separate_batch(model, tracks[s:s + g], preset, length, None,
                                    output_dtype, ex, conserve_last))
    return torch.cat(parts)


def separate_batch_stereo(
    model: ConvSep,
    tracks: torch.Tensor,
    preset: Preset,
    length: int,
    output_dtype: str = "float32",
    conserve_last: bool = False,
) -> torch.Tensor:
    """(B, 2, length) stereo mixtures → (B, S, 2, length), one track at a
    time through :func:`~convsep_tpu_torch.separate.stereo.
    separate_fused_stereo` (the reference's vmap of it)."""
    return torch.stack([
        separate_fused_stereo(model, tracks[i], preset, length, output_dtype, conserve_last)
        for i in range(tracks.shape[0])
    ])


# The reference's lax.map of the stereo program is the same loop here.
separate_batch_scan_stereo = separate_batch_stereo


class StreamSeparator:
    """Stream many tracks through batched separation.

    >>> ss = StreamSeparator(preset, state, device="cuda")
    >>> for stems_batch in ss.stream(track_iterator, batch_size=8): ...

    ``state``, ``device``, ``output_dtype``, ``input_dtype``,
    ``conserve_last`` and ``complement_last`` as for the whole-track
    :class:`~convsep_tpu_torch.separate.pipeline.Separator`; neither
    conservative option runs on the ``fft_impl="pallas"`` route. The stems
    are views of pinned host memory, one block a batch, as the whole-track
    separator's: a caller that keeps many batches copies them. ``mesh=``
    and ``apply_fn=`` raise (see the module docstring).
    """

    def __init__(
        self,
        preset: Preset,
        state: dict[str, torch.Tensor],
        mesh=None,
        apply_fn=None,
        output_dtype: str = "float32",
        input_dtype: str = "float32",
        conserve_last: bool = False,
        complement_last: bool = False,
        device: str | torch.device | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (batch sharded over several devices) is not ported; "
                "ROADMAP queue 1 item 9 (distributed)"
            )
        _no_apply_fn(apply_fn)
        check_supported(preset, stereo=preset.model.decoder_reduce == "all")
        check_options(preset, output_dtype, input_dtype, conserve_last, complement_last)
        if (complement_last or conserve_last) and preset.transform.fft_impl == "pallas":
            raise ValueError("conserve_last is not supported by the pallas mask kernel")
        self.preset = preset
        self.device = resolve_device(device)
        self.model = ConvSep(preset.model, state, device=self.device).prepare_inference()
        self.output_dtype = output_dtype
        self.input_dtype = input_dtype
        self.complement_last = bool(complement_last)
        self.conserve_last = bool(conserve_last or complement_last)
        self._copy = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    @property
    def _stereo(self) -> bool:
        # joint-channel presets take (2, L) tracks and give (S, 2, L) stems
        return self.preset.model.decoder_reduce == "all"

    def _bucket(self, batch: Sequence[np.ndarray]) -> tuple[np.ndarray, list[int]]:
        lengths = [t.shape[-1] for t in batch]
        Lb = bucket_length(max(lengths), self.preset)
        dt = np.int16 if self.input_dtype == "int16" else np.float32
        shape = (len(batch), 2, Lb) if self._stereo else (len(batch), Lb)
        stacked = np.zeros(shape, dt)
        for i, t in enumerate(batch):
            if self._stereo and t.ndim != 2:
                raise ValueError(f"stereo preset expects (2, L) tracks, got {t.shape}")
            if dt == np.int16 and t.dtype != np.int16:
                t = quantize_pcm16_host(t)
            stacked[i, ..., : t.shape[-1]] = t
        return stacked, lengths

    def _bucket_extras(self, extras: Sequence[np.ndarray], n: int, Lb: int) -> np.ndarray:
        """Per-track score channels → (n, nf(Lb), F, C − 1), frame-padded."""
        if self._stereo:
            raise ValueError("score-informed extras are mono-preset only")
        nf = num_frames(Lb, self.preset.transform.hop_size)
        first = np.asarray(extras[0], np.float32)
        out = np.zeros((n, nf, *first.shape[1:]), np.float32)
        for i, e in enumerate(extras):
            e = np.asarray(e, np.float32)[:nf]
            out[i, : e.shape[0]] = e
        return out

    def _upload(self, stacked: np.ndarray, ex: np.ndarray | None):
        """Stage a batch (and its channels) in pinned memory and enqueue
        the upload on the copy stream; the host does not wait."""
        up = upload_async(stage_pinned(stacked, self.device), self.device, self._copy)
        ex_up = None
        if ex is not None:
            ex_up = upload_async(stage_pinned(ex, self.device), self.device, self._copy)
        return up, ex_up

    def _compute(self, up, ex_up, length: int) -> torch.Tensor:
        """Enqueue a batch's separation on the current stream, after its
        upload: (B, S[, 2], length) stems on the device."""
        dev = wait_upload(*up)
        if self._stereo:
            return separate_batch_stereo(self.model, dev, self.preset, length,
                                         self.output_dtype, self.conserve_last)
        extra = None if ex_up is None else wait_upload(*ex_up)
        return separate_batch(self.model, dev, self.preset, length, None,
                              self.output_dtype, extra, self.conserve_last)

    def _start_fetch(self, out_dev: torch.Tensor):
        """Enqueue the stems' copy to pinned memory on the copy stream, after
        the work enqueued so far; with complement_last the last stem is not
        copied."""
        S = self.preset.model.num_sources
        return fetch_async(out_dev[:, : S - 1] if self.complement_last else out_dev, self._copy)

    def _finish_fetch(self, host, done, stacked: np.ndarray) -> np.ndarray:
        """Wait for a batch's copy; with complement_last derive each track's
        last stem from the bucketed mixture (separate/complement.py)."""
        got = host_array(host, done)
        if not self.complement_last:
            return got
        last = np.stack([
            derive_last_stem(got[i], stacked[i], self.input_dtype, self.output_dtype)
            for i in range(got.shape[0])
        ])
        return np.concatenate([got, last[:, None]], axis=1)

    def _fetch_stems(self, out_dev: torch.Tensor, stacked: np.ndarray) -> np.ndarray:
        """Device stems batch → host (B, S[, 2], L), through pinned memory
        (the reference's ``fetch_parallel`` is left out on purpose)."""
        return self._finish_fetch(*self._start_fetch(out_dev), stacked)

    def separate_many(
        self,
        tracks: Sequence[np.ndarray],
        extras: Sequence[np.ndarray] | None = None,
    ) -> list[np.ndarray]:
        """Separate a list of tracks → a list of (S[, 2], len_i) stems.

        ``extras``: optional per-track score-informed channels, one
        (n_frames_i, F, C − 1) array per track (scaled like the network
        input, as for the whole-track separator)."""
        stacked, lengths = self._bucket(tracks)
        ex = None
        if extras is not None:
            if len(extras) != len(tracks):
                raise ValueError(f"{len(extras)} extras for {len(tracks)} tracks")
            ex = self._bucket_extras(extras, stacked.shape[0], stacked.shape[-1])
        out_dev = self._compute(*self._upload(stacked, ex), stacked.shape[-1])
        out = self._fetch_stems(out_dev, stacked)
        return [out[i, ..., : lengths[i]] for i in range(len(tracks))]

    def stream(
        self,
        tracks: Iterator[np.ndarray],
        batch_size: int,
        extras: Iterator[np.ndarray] | None = None,
    ) -> Iterator[list[np.ndarray]]:
        """Batched streaming: a producer thread buckets, stages and uploads
        batch k + 1 while batch k computes, and batch k − 1's stems are
        copied out and handed over meanwhile. An error in the producer (the
        track iterator's) is raised here.

        ``extras``: optional iterator of per-track score channels, parallel
        to ``tracks`` (see :meth:`separate_many`)."""

        def batches():
            buf, exbuf = [], []
            src = zip(tracks, extras) if extras is not None else ((t, None) for t in tracks)
            for t, e in src:
                # int16 stays as it is: _bucket would requantize a float32
                # copy of PCM16 values (×32768, saturated)
                t = np.asarray(t)
                buf.append(t if t.dtype == np.int16 else np.asarray(t, np.float32))
                exbuf.append(e)
                if len(buf) == batch_size:
                    yield self._bucket(buf), exbuf
                    buf, exbuf = [], []
            if buf:
                yield self._bucket(buf), exbuf

        q: queue.Queue = queue.Queue(maxsize=2)
        end = object()

        def producer():
            try:
                for (stacked, lengths), exbuf in batches():
                    ex = None
                    if exbuf and exbuf[0] is not None:
                        ex = self._bucket_extras(exbuf, stacked.shape[0], stacked.shape[-1])
                    q.put((self._upload(stacked, ex), lengths, stacked))
                q.put(end)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)

        threading.Thread(target=producer, daemon=True, name="convsep-stream-producer").start()
        pending = None
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, Exception):
                raise item
            (up, ex_up), lengths, stacked = item
            # batch k and its copy are enqueued; batch k − 1 is handed over
            # while they run
            fetch = self._start_fetch(self._compute(up, ex_up, stacked.shape[-1]))
            if pending is not None:
                yield self._hand_over(*pending)
            pending = (fetch, lengths, stacked)
        if pending is not None:
            yield self._hand_over(*pending)

    def _hand_over(self, fetch, lengths: list[int], stacked: np.ndarray) -> list[np.ndarray]:
        out = self._finish_fetch(*fetch, stacked)
        return [out[i, ..., : lengths[i]] for i in range(len(lengths))]
