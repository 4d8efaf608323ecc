"""Spectrogram segmentation: tracks ↔ fixed-size time-context windows.

Mirror of ``convsep_tpu.data.segment``: a track's (n_frames, F)
spectrogram is cut into ``time_context``-frame segments at step
``time_context - overlap``, the tail zero-padded into a final segment.
Separation uses the non-overlapping case (step = time_context), a pad and
a reshape; the training pipeline the overlapped one. Every function takes
torch tensors and numpy arrays alike and returns the caller's kind.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_count(n_frames: int, time_context: int, step: int | None = None) -> int:
    """Number of segments covering ``n_frames`` (tail zero-padded)."""
    if step is None:
        step = time_context
    if step <= 0 or time_context <= 0:
        raise ValueError(f"bad segmenting: T={time_context} step={step}")
    if n_frames <= time_context:
        return 1
    return -(-(n_frames - time_context) // step) + 1


def pad_frames_to_segments(frames, time_context: int, step: int | None = None):
    """Zero-pad (..., n_frames, F) so segments tile it exactly → (padded,
    nseg)."""
    if step is None:
        step = time_context
    n = frames.shape[-2]
    nseg = segment_count(n, time_context, step)
    pad = (nseg - 1) * step + time_context - n
    if isinstance(frames, torch.Tensor):
        return (torch.nn.functional.pad(frames, (0, 0, 0, pad)) if pad else frames), nseg
    widths = [(0, 0)] * (frames.ndim - 2) + [(0, pad), (0, 0)]
    return np.pad(frames, widths), nseg


def segment_frames(frames, time_context: int, step: int | None = None):
    """(..., n_frames, F) → (..., nseg, time_context, F).

    Non-overlapping segmentation is a reshape; overlapped segmentation
    stacks ``time_context / step`` shifted slices of step-sized blocks
    where step divides time_context, else gathers the segments' rows."""
    if step is None:
        step = time_context
    padded, nseg = pad_frames_to_segments(frames, time_context, step)
    lead, F = padded.shape[:-2], padded.shape[-1]
    if step == time_context:
        return padded.reshape(*lead, nseg, time_context, F)
    is_t = isinstance(padded, torch.Tensor)
    if time_context % step == 0:
        nb = padded.shape[-2] // step
        blocks = padded[..., : nb * step, :].reshape(*lead, nb, step, F)
        parts = [blocks[..., i: i + nseg, :, :] for i in range(time_context // step)]
        return torch.cat(parts, dim=-2) if is_t else np.concatenate(parts, axis=-2)
    idx = (np.arange(nseg)[:, None] * step + np.arange(time_context)[None, :]).reshape(-1)
    if is_t:
        rows = padded.index_select(-2, torch.from_numpy(idx).to(padded.device))
    else:
        rows = np.take(padded, idx, axis=-2)
    return rows.reshape(*lead, nseg, time_context, F)


def unsegment_frames(segments, n_frames: int):
    """(..., nseg, T, F) → (..., n_frames, F), truncating the zero tail
    (inverse of non-overlapping segmentation)."""
    *lead, nseg, T, F = segments.shape
    return segments.reshape(*lead, nseg * T, F)[..., :n_frames, :]
