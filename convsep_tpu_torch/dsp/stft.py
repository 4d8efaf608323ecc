"""STFT framing with the reference's conventions, and the complex STFT.

Mirror of ``convsep_tpu.dsp.stft``: the signal is front-padded with
``W//2`` zeros and back-padded so that ``ceil(L / hop) + 2`` frames of
length ``W`` at stride ``hop`` tile it exactly; :func:`stft` windows the
frames and takes ``torch.fft.rfft`` of each (the complex-spectrum API;
the separation and training paths take the DFT products of
:mod:`convsep_tpu_torch.dsp.dft` or the CUDA kernels instead).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def num_frames(length: int, hop: int) -> int:
    """``ceil(length / hop) + 2`` frames (the +2 covers the W//2 front pad
    and the tail)."""
    return int(math.ceil(length / float(hop))) + 2


def padded_length(length: int, win_length: int, hop: int) -> int:
    """Total padded signal length: ``(num_frames - 1) * hop + win_length``."""
    return (num_frames(length, hop) - 1) * hop + win_length


def _pad_signal(signal: torch.Tensor, win_length: int, hop: int) -> torch.Tensor:
    """Front-pad W//2 zeros, back-pad to :func:`padded_length`."""
    length = signal.shape[-1]
    total = padded_length(length, win_length, hop)
    front = win_length // 2
    back = total - front - length
    if back < 0:
        raise ValueError(
            f"inconsistent padding: length={length} win={win_length} hop={hop}"
        )
    return torch.nn.functional.pad(signal, (front, back))


def frame_signal(padded: torch.Tensor, win_length: int, hop: int, n_frames: int) -> torch.Tensor:
    """(..., total) → (..., n_frames, win_length) overlapping frames (a
    strided view; no copy)."""
    need = (n_frames - 1) * hop + win_length
    if padded.shape[-1] < need:
        raise ValueError(f"padded length {padded.shape[-1]} < required {need}")
    return padded[..., :need].unfold(-1, win_length, hop)


def stft(signal, window: np.ndarray, hop: int, nfft: int | None = None) -> torch.Tensor:
    """STFT of a (..., length) signal → (..., num_frames, nfft//2+1)
    complex64, on the signal's device (a numpy signal: the CPU)."""
    x = torch.as_tensor(signal, dtype=torch.float32)
    w = torch.from_numpy(np.asarray(window, np.float32)).to(x.device)
    win, hop = int(w.shape[-1]), int(hop)
    frames = frame_signal(_pad_signal(x, win, hop), win, hop, num_frames(x.shape[-1], hop))
    return torch.fft.rfft(frames * w, n=int(nfft or win), dim=-1)


def magphase(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex spectrogram → (float32 magnitude, float32 phase)."""
    return spec.abs().float(), spec.angle().float()


def scale_magnitude(mag: torch.Tensor, iscale: str = "lin", kappa: float = 1e4) -> torch.Tensor:
    """'lin' is identity; 'log' is ``log10(1 + kappa * mag)``."""
    if iscale == "lin":
        return mag
    if iscale == "log":
        return torch.log1p(kappa * mag) / np.log(10.0)
    raise ValueError(f"unknown iscale {iscale!r}")


def unscale_magnitude(mag: torch.Tensor, iscale: str = "lin", kappa: float = 1e4) -> torch.Tensor:
    """Inverse of :func:`scale_magnitude`."""
    if iscale == "lin":
        return mag
    if iscale == "log":
        return torch.expm1(mag * np.log(10.0)) / kappa
    raise ValueError(f"unknown iscale {iscale!r}")
