"""TransformFFT: the user-facing analysis/resynthesis object.

Mirror of ``convsep_tpu.dsp.transform.TransformFFT`` (``compute_file``
and ``compute_inverse``) on this package's :func:`stft_matmul` /
:func:`istft_matmul`; numpy in, numpy out, the transforms on ``device``,
their products in full float32 whatever the caller's matmul precision
(:class:`~convsep_tpu_torch.utils.precision.float32_exact`).
``compute_transform`` (feature files on disk) is not ported: this package
has no feature-file writer yet.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch.dsp.dft import istft_matmul, stft_matmul
from convsep_tpu_torch.dsp.stft import scale_magnitude, unscale_magnitude
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.precision import float32_exact


class TransformFFT:
    """STFT feature transform with the reference's API.

    >>> t = TransformFFT(TransformConfig(), device="cpu")
    >>> mag, phase = t.compute_file(audio, phase=True)
    >>> audio_again = t.compute_inverse(mag, phase, length=len(audio))

    ``device``: where the transforms run; ``None`` means "cuda" and raises
    without a GPU. Every ``fft_impl`` takes the DFT chain (the reference's
    complex-FFT route computes the same spectra).
    """

    def __init__(self, config, device: str | torch.device | None = None):
        self.config = config
        self.device = resolve_device(device)
        if config.window == "sinebell":
            self.window = sinebell(config.frame_size)
        elif config.window == "hann":
            self.window = hann(config.frame_size)
        else:
            raise ValueError(f"unknown window {config.window!r}")

    @property
    def bins(self) -> int:
        return self.config.bins

    @float32_exact()
    @torch.inference_mode()
    def compute_file(
        self, audio: np.ndarray, phase: bool = False
    ) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """Mono audio (length,) → magnitude (frames, bins) float32
        [+ phase (frames, bins)] with the configured iscale applied."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim != 1:
            raise ValueError(f"expected mono audio, got shape {audio.shape}")
        x = torch.from_numpy(audio).to(self.device)
        re, im = stft_matmul(x, self.window, self.config.hop_size, self.config.nfft)
        mag = scale_magnitude(torch.sqrt(re * re + im * im), self.config.iscale).cpu().numpy()
        if phase:
            return mag, torch.atan2(im, re).cpu().numpy()
        return mag

    @float32_exact()
    @torch.inference_mode()
    def compute_inverse(
        self, mag: np.ndarray, phase: np.ndarray, length: int | None = None
    ) -> np.ndarray:
        """Magnitude (frames, bins) + phase → time signal (length,)."""
        m = unscale_magnitude(torch.from_numpy(np.asarray(mag, np.float32)).to(self.device),
                              self.config.iscale)
        ph = torch.from_numpy(np.asarray(phase, np.float32)).to(self.device)
        if length is None:
            # invert the reference frame-count formula: nf = ceil(L/hop)+2
            length = (m.shape[-2] - 2) * self.config.hop_size
        out = istft_matmul(m * torch.cos(ph), m * torch.sin(ph), self.window,
                           self.config.hop_size, int(length), nfft=self.config.nfft)
        return out.cpu().numpy()
