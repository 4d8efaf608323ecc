"""Push-based online separation: feed sample blocks, pop finished stems.

Mirror of ``convsep_tpu.separate.online``. Blocks of any size go in as they
arrive (a capture callback, a socket, a decoder), and separated stems come
out with a fixed, known latency of ``latency_samples`` (one chunk span plus
one analysis window):

    >>> osep = OnlineSeparator(preset, state, chunk_segments=8, device="cuda")
    >>> for block in capture():          # any block sizes, any cadence
    ...     play(osep.push(block))       # (S, n_new) newly finished stems
    >>> play(osep.flush())               # drain the tail after end-of-stream
    >>> osep.close()

The same chunk program as :class:`~convsep_tpu_torch.separate.chunked.
ChunkedSeparator` (:func:`~convsep_tpu_torch.separate.chunked.
separate_chunk`, the overlap-add spill carried on the device), driven by a
rolling host buffer instead of a pre-sliced track. A chunk is dispatched as
soon as no future push can change its output: its normalization is then
in steady state, and the emitted samples equal ``ChunkedSeparator``'s for
the completed track bit for bit (same program, same shapes, same
:func:`~convsep_tpu_torch.separate.chunked.inv_norm_slice`).

On CUDA each chunk's stems are copied to pinned host memory on the
separator's own copy stream; with ``max_pending`` > 0 a chunk's copy
overlaps the next chunk's compute across pushes.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.dsp.stft import num_frames
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.separate.chunked import (
    check_chunkable,
    inv_norm_slice,
    separate_chunk,
    separate_chunk_stereo,
)
from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.separate.pipeline import check_options
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.pcm import quantize_pcm16_host
from convsep_tpu_torch.utils.transfer import (
    fetch_async,
    host_array,
    stage_pinned,
    upload_async,
    wait_upload,
)


class OnlineSeparator:
    """Streaming push/flush separation with bounded latency.

    push(samples) → (S, n_new) [stereo: (S, 2, n_new)] newly finished stem
    samples (often length 0 until a chunk boundary passes); flush() → the
    final tail. Concatenating every return value gives the whole-track
    separation of the concatenated pushes.

    Score-informed presets (channels_in > 1, no multires) stream too: pass
    conditioning frames through push(samples, extra=...); a chunk is
    dispatched once both its samples and its frames are in.

    ``max_pending``: 0 (the default) returns every finished chunk's stems
    from the same push; k > 0 lets up to k chunks stay in flight across
    pushes, so that a chunk's copy overlaps the next chunk's compute.
    ``complement_last`` (implies ``conserve_last``) copies S − 1 stems and
    derives the last on the host as mixture − Σ others. ``fetch_streams``
    is kept for the reference's signature; the port copies on one copy
    stream. ``device``: ``None`` means "cuda" (raises without a GPU).

    :meth:`reset` waits for the copies in flight before it forgets the
    stream; :meth:`close` does so too and releases the copy stream and the
    pinned buffers.
    """

    def __init__(
        self,
        preset: Preset,
        state: dict[str, torch.Tensor],
        chunk_segments: int = 8,
        output_dtype: str = "float32",
        input_dtype: str = "float32",
        fetch_streams: int = 4,
        complement_last: bool = False,
        conserve_last: bool = False,
        max_pending: int = 0,
        device: str | torch.device | None = None,
    ):
        self._stereo, self._n_extra = check_chunkable(preset, "online")
        check_options(preset, output_dtype, input_dtype, conserve_last, complement_last)
        t, m = preset.transform, preset.model
        self.preset = preset
        self.device = resolve_device(device)
        self.model = ConvSep(m, state, device=self.device).prepare_inference()
        self.chunk_segments = int(chunk_segments)
        self.output_dtype = output_dtype
        self.input_dtype = input_dtype
        self.complement_last = bool(complement_last)
        self.conserve_last = bool(conserve_last or complement_last)
        self.max_pending = int(max_pending)
        self._copy = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._closed = False
        self._W, self._hop = t.frame_size, t.hop_size
        self._span = m.time_context * self.chunk_segments * t.hop_size
        self._norm_cache: dict = {}
        self._pending: deque = deque()  # (chunk index, host stems, copy event, mixture span)
        self.reset()

    # -- stream geometry -----------------------------------------------------
    @property
    def latency_samples(self) -> int:
        """Samples that must arrive past a chunk's start before that chunk's
        output is emitted (worst-case algorithmic latency)."""
        return self._span + self._W

    @property
    def chunk_samples(self) -> int:
        """Output granularity: stems are emitted ``chunk_samples`` at a time."""
        return self._span

    def reset(self) -> None:
        """Forget all stream state; the next push starts a new track. Copies
        still in flight are waited for first, so none of them races the
        next track's chunks for its pinned buffer."""
        self._check_open()
        self._wait_pending()
        S = self.preset.model.num_sources
        dt = np.int16 if self.input_dtype == "int16" else np.float32
        lead = (2,) if self._stereo else ()
        # rolling buffer in padded STFT coordinates: starts at the current
        # chunk's origin; chunk 0's origin includes the W/2 front pad
        self._buf = np.zeros(lead + (self._W // 2,), dt)
        self._chunk = 0  # next chunk index to dispatch
        self._pushed = 0  # true samples received
        self._spill = torch.zeros((S, *lead, self._W - self._hop), dtype=torch.float32,
                                  device=self.device)
        self._exbuf = np.zeros((0, self.preset.model.feat_size, self._n_extra), np.float32)
        self._finished = False

    def close(self) -> None:
        """Wait for the copies in flight, then release the copy stream, the
        pinned buffers and the device state. The separator takes no more
        pushes afterwards; closing twice is allowed."""
        if self._closed:
            return
        self._wait_pending()
        self._closed = True
        self._copy = None
        self._spill = None
        self._buf = None
        self._exbuf = None

    # -- internals -----------------------------------------------------------
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("OnlineSeparator is closed")

    def _wait_pending(self) -> None:
        while self._pending:
            _, _, done, _ = self._pending.popleft()
            if done is not None:
                done.synchronize()

    def _append(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples)
        if self._stereo:
            if samples.ndim != 2 or samples.shape[0] != 2:
                raise ValueError(f"stereo push must be (2, n), got {samples.shape}")
        elif samples.ndim != 1:
            raise ValueError(f"mono push must be (n,), got {samples.shape}")
        if self.input_dtype == "int16":
            if samples.dtype != np.int16:
                samples = quantize_pcm16_host(samples)
        else:
            samples = np.asarray(samples, np.float32)
        self._pushed += samples.shape[-1]
        self._buf = np.concatenate([self._buf, samples], axis=-1)

    def _dispatch(self, norm: torch.Tensor) -> None:
        """Enqueue the chunk program on the buffer's first span and its
        stems' copy (neither waits for the device), queue the pending
        entry, and advance the stream."""
        W, hop, span = self._W, self._hop, self._span
        x = wait_upload(*upload_async(stage_pinned(self._buf[..., : span + (W - hop)],
                                                   self.device), self.device, self._copy))
        if self._stereo:
            out, self._spill = separate_chunk_stereo(
                self.model, x, self._spill, norm, self.preset, self.chunk_segments,
                self.output_dtype, self.conserve_last)
        else:
            extra = None
            if self._n_extra:
                Fc = span // hop
                extra = wait_upload(*upload_async(stage_pinned(self._exbuf[:Fc], self.device),
                                                  self.device, self._copy))
                self._exbuf = self._exbuf[Fc:]
            out, self._spill = separate_chunk(
                self.model, x, self._spill, norm, self.preset, self.chunk_segments,
                self.output_dtype, extra, self.conserve_last)
        S = self.preset.model.num_sources
        host, done = fetch_async(out[: S - 1 if self.complement_last else S], self._copy)
        # the mixture span for the complement (padded coordinates, aligned
        # sample for sample with the chunk's stems)
        mix = self._buf[..., :span].copy() if self.complement_last else None
        self._pending.append((self._chunk, host, done, mix))
        self._buf = self._buf[..., span:]
        self._chunk += 1

    def _gather_oldest(self) -> np.ndarray:
        """The oldest chunk in flight → (S[, 2], n) host samples."""
        idx, host, done, mix = self._pending.popleft()
        got = host_array(host, done)
        if self.complement_last:
            last = derive_last_stem(got, mix, self.input_dtype, self.output_dtype)
            got = np.concatenate([got, last[None]], 0)
        else:
            got = got.copy()  # out of the pinned block, which goes back for reuse
        if idx == 0:  # drop the W/2 front pad from the first chunk
            got = got[..., self._W // 2:]
        return got

    def _drain(self, keep: int) -> list:
        """Gather pending chunks (oldest first) until ≤ ``keep`` in flight."""
        outs = []
        while len(self._pending) > keep:
            outs.append(self._gather_oldest())
        return outs

    def _steady_norm(self, i: int) -> torch.Tensor:
        # a synthetic frame count two chunks past i puts both the head ramp
        # and the (absent) tail ramp outside chunk i's slice, so the slice
        # equals the final track's for any eventual length
        Fc = self._span // self._hop
        nf_big = (i + 2) * Fc + 2 * (self._W // self._hop) + 4
        return inv_norm_slice(self.preset, self.chunk_segments, i, i + 2, nf_big,
                              self._norm_cache, self.device)

    def _empty(self) -> np.ndarray:
        S = self.preset.model.num_sources
        dt = np.int16 if self.output_dtype == "int16" else np.float32
        return np.zeros((S, 2, 0) if self._stereo else (S, 0), dt)

    # -- public API ----------------------------------------------------------
    def push(self, samples: np.ndarray, extra: np.ndarray | None = None) -> np.ndarray:
        """Feed a block; return the stems it finished ((S[, 2], n_new)).

        ``extra``: score-informed presets only — (k, F, channels_in − 1)
        conditioning frames for the next k analysis frames of the stream,
        scaled as for the chunked and whole-track paths."""
        self._check_open()
        if self._finished:
            raise RuntimeError("flush() already called; reset() to start a new track")
        if extra is not None:
            if not self._n_extra:
                raise ValueError(f"preset {self.preset.name!r} takes no extra channels")
            extra = np.asarray(extra, np.float32)
            F = self.preset.model.feat_size
            if extra.ndim != 3 or extra.shape[1:] != (F, self._n_extra):
                raise ValueError(f"extra must be (k, {F}, {self._n_extra}), got {extra.shape}")
            self._exbuf = np.concatenate([self._exbuf, extra], axis=0)
        self._append(samples)
        # dispatch every chunk that future pushes can no longer affect (its
        # slice is complete, and one more chunk is sure to follow, so it is
        # not the last); score-informed streams also need its frames. All
        # ready chunks are enqueued before any copy is waited for.
        Fc = self._span // self._hop
        while self._buf.shape[-1] >= self._span + self._W and (
            not self._n_extra or self._exbuf.shape[0] >= Fc
        ):
            self._dispatch(self._steady_norm(self._chunk))
        outs = self._drain(self.max_pending)
        return np.concatenate(outs, axis=-1) if outs else self._empty()

    def flush(self) -> np.ndarray:
        """End of stream: separate the remaining tail and return it."""
        self._check_open()
        if self._finished:
            raise RuntimeError("flush() already called")
        self._finished = True
        L = self._pushed
        hop, W, span = self._hop, self._W, self._span
        Fc = span // hop
        nf = num_frames(L, hop)
        nc = max(1, math.ceil(nf / Fc))
        done = self._chunk
        if done >= nc:  # the stream ended exactly on emitted chunks
            outs = self._drain(0)
            if not outs:
                return self._empty()
            emitted = max(0, (done - len(outs)) * span - W // 2)
            return np.concatenate(outs, axis=-1)[..., : max(0, L - emitted)]
        # zero-pad the buffer out to the remaining chunks' framing margin
        pad = (nc - done) * span + (W - hop) - self._buf.shape[-1]
        if pad > 0:
            z = np.zeros(self._buf.shape[:-1] + (pad,), self._buf.dtype)
            self._buf = np.concatenate([self._buf, z], axis=-1)
        if self._n_extra:
            # missing tail frames are zeros, as ChunkedSeparator pads them
            need_f = (nc - done) * Fc
            if self._exbuf.shape[0] < need_f:
                z = np.zeros((need_f - self._exbuf.shape[0],) + self._exbuf.shape[1:],
                             np.float32)
                self._exbuf = np.concatenate([self._exbuf, z], axis=0)
        already = done - len(self._pending)  # chunks already returned
        for i in range(done, nc):
            self._dispatch(inv_norm_slice(self.preset, self.chunk_segments, i, nc, nf,
                                          self._norm_cache, self.device))
        tail = np.concatenate(self._drain(0), axis=-1)
        emitted = max(0, already * span - W // 2)  # true samples already returned
        return tail[..., : L - emitted]
