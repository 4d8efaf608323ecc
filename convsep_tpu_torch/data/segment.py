"""Spectrogram segmentation, non-overlapping case (what separation uses).

Mirror of ``convsep_tpu.data.segment``: (..., n_frames, F) is zero-padded
to whole ``time_context`` segments and reshaped; the inverse truncates the
zero tail.
"""

from __future__ import annotations

import torch


def segment_count(n_frames: int, time_context: int) -> int:
    """Number of non-overlapping segments covering ``n_frames``."""
    if time_context <= 0:
        raise ValueError(f"bad segmenting: T={time_context}")
    return max(1, -(-n_frames // time_context))


def segment_frames(frames: torch.Tensor, time_context: int) -> torch.Tensor:
    """(..., n_frames, F) → (..., nseg, time_context, F)."""
    n = frames.shape[-2]
    nseg = segment_count(n, time_context)
    pad = nseg * time_context - n
    if pad:
        frames = torch.nn.functional.pad(frames, (0, 0, 0, pad))
    return frames.reshape(*frames.shape[:-2], nseg, time_context, frames.shape[-1])


def unsegment_frames(segments: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(..., nseg, T, F) → (..., n_frames, F), truncating the zero tail."""
    *lead, nseg, T, F = segments.shape
    return segments.reshape(*lead, nseg * T, F)[..., :n_frames, :]
