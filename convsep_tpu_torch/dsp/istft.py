"""Overlap-add and its window-power normalization.

Mirror of ``convsep_tpu.dsp.istft``: frames are overlap-added at the hop
and divided by the overlap-added product of synthesis and analysis
windows (zeros replaced by 1); the first W//2 samples are then dropped by
the caller.
"""

from __future__ import annotations

import numpy as np
import torch


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., n_frames, W) → (..., (n_frames - 1) * hop + W), as
    ``k = ceil(W / hop)`` shifted adds over hop blocks."""
    *lead, n_frames, win_length = frames.shape
    k = -(-win_length // hop)
    pad_w = k * hop - win_length
    if pad_w:
        frames = torch.nn.functional.pad(frames, (0, pad_w))
    sub = frames.reshape(*lead, n_frames, k, hop)
    out = frames.new_zeros((*lead, n_frames + k - 1, hop))
    for i in range(k):
        out[..., i:i + n_frames, :] += sub[..., :, i, :]
    out = out.reshape(*lead, (n_frames + k - 1) * hop)
    return out[..., : (n_frames - 1) * hop + win_length]


def ola_norm(
    window: np.ndarray,
    analysis_window: np.ndarray,
    hop: int,
    n_frames: int,
) -> np.ndarray:
    """Overlap-added ``window * analysis_window`` with zeros replaced by 1
    (numpy, float32 result; the same arithmetic as the reference)."""
    win_length = int(window.shape[-1])
    prod = np.asarray(window, np.float64) * np.asarray(analysis_window, np.float64)
    total = (n_frames - 1) * hop + win_length
    norm = np.zeros(total, dtype=np.float64)
    for n in range(n_frames):
        norm[n * hop : n * hop + win_length] += prod
    norm[norm == 0.0] = 1.0
    return norm.astype(np.float32)
