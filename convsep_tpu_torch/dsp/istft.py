"""Overlap-add, its window-power normalization, and the complex iSTFT.

Mirror of ``convsep_tpu.dsp.istft``: frames are overlap-added at the hop
and divided by the overlap-added product of synthesis and analysis
windows (zeros replaced by 1); the first W//2 samples are then dropped.
:func:`istft` inverts :func:`~convsep_tpu_torch.dsp.stft.stft` with
``torch.fft.irfft``.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch.dsp.stft import num_frames


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


def istft(
    spec: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    analysis_window: np.ndarray | None = None,
    nfft: int | None = None,
) -> torch.Tensor:
    """Inverse STFT of (..., n_frames, nfft//2+1) complex → (..., length)
    float32, on the spectrum's device. ``spec`` must have the reference
    framing's ``ceil(length / hop) + 2`` frames; ``analysis_window``
    defaults to ``window``."""
    window = np.asarray(window, np.float32)
    analysis_window = window if analysis_window is None else np.asarray(analysis_window,
                                                                        np.float32)
    nfft = 2 * (int(spec.shape[-1]) - 1) if nfft is None else int(nfft)
    expect = num_frames(length, hop)
    if int(spec.shape[-2]) != expect:
        raise ValueError(
            f"spec has {spec.shape[-2]} frames but length={length}, hop={hop} "
            f"implies {expect} (reference framing)"
        )
    win = int(window.shape[-1])
    frames = torch.fft.irfft(spec, n=nfft, dim=-1)[..., :win]
    frames = frames * torch.from_numpy(window).to(spec.device)
    inv = torch.from_numpy(1.0 / ola_norm(window, analysis_window, int(hop), expect))
    data = overlap_add(frames, int(hop)) * inv.to(spec.device)
    return data[..., win // 2: win // 2 + int(length)].float()
