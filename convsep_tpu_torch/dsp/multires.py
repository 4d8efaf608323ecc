"""Multi-resolution spectrogram channels (multires4096's extra inputs).

Mirror of ``convsep_tpu.dsp.multires``: magnitudes from shorter windows at
the main hop (so the frame grids align exactly), each mapped onto the main
resolution's bin axis by one linear-interpolation matmul.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.utils.precision import float32_exact


@lru_cache(maxsize=16)
def freq_interp_matrix(bins_src: int, bins_dst: int, fs: float = 1.0) -> np.ndarray:
    """(bins_src, bins_dst) linear interpolation of one rfft bin axis onto
    another (both spanning 0..Nyquist)."""
    src = np.linspace(0.0, fs / 2, bins_src)
    dst = np.linspace(0.0, fs / 2, bins_dst)
    m = np.zeros((bins_src, bins_dst), np.float32)
    idx = np.searchsorted(src, dst, side="right") - 1
    idx = np.clip(idx, 0, bins_src - 2)
    frac = (dst - src[idx]) / (src[idx + 1] - src[idx])
    m[idx, np.arange(bins_dst)] = 1.0 - frac
    m[idx + 1, np.arange(bins_dst)] = frac
    return m


@lru_cache(maxsize=8)
def _interp(bins_src: int, bins_dst: int, device: str) -> torch.Tensor:
    return torch.from_numpy(freq_interp_matrix(bins_src, bins_dst)).to(device)


def _window(name: str, n: int) -> np.ndarray:
    return sinebell(n) if name == "sinebell" else hann(n)


@float32_exact()
def multires_channels(audio: torch.Tensor, t) -> torch.Tensor:
    """(..., length) → (..., n_frames, bins, len(t.multires)) extra
    magnitude channels on the main analysis grid (same hop ⇒ same
    n_frames). ``t`` is a ``TransformConfig``; every ``fft_impl`` takes
    :func:`stft_matmul` here (the reference's ``fft`` route computes the
    same magnitudes with a complex FFT)."""
    if not t.multires:
        raise ValueError("preset has no multires sizes configured")
    chans = []
    for size in t.multires:
        re, im = stft_matmul(audio, _window(t.window, size), t.hop_size, size)
        mag = torch.sqrt(re * re + im * im)
        chans.append(mag @ _interp(size // 2 + 1, t.bins, str(mag.device)))
    return torch.stack(chans, dim=-1)
