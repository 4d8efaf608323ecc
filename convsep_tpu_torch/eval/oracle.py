"""Ideal-soft-mask oracle: the upper bound a Wiener-mask separator of this
transform configuration can reach.

Mirror of ``convsep_tpu.eval.oracle``. The oracle knows the true stems'
magnitudes: mask_i = |S_i|^p / (Σ_j |S_j|^p + eps), applied to the complex
mixture spectrogram (the mixture's phase, as the model's Wiener path) and
inverted. Any model's SDR is bounded above by it; the gap model → oracle
is the learnable headroom.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.dsp.istft import istft
from convsep_tpu_torch.dsp.stft import stft
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.utils.device import resolve_device


def oracle_stems(
    mixture: np.ndarray,
    stems: np.ndarray,
    preset: Preset,
    p: float | None = None,
    eps: float | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """(L,) mixture + (S, L) true stems → (S, L) ideal-soft-mask estimates
    (float32), with the preset's window, hop, nfft and Wiener exponent.
    The transforms run on ``device`` (``None`` means "cuda")."""
    dev = resolve_device(device)
    t = preset.transform
    p = preset.sep.wiener_p if p is None else p
    eps = preset.sep.wiener_eps if eps is None else eps
    win = (sinebell if t.window == "sinebell" else hann)(t.frame_size)
    mixture = np.asarray(mixture, np.float32)
    stems = np.asarray(stems, np.float32)
    if stems.ndim != 2 or stems.shape[1] != mixture.shape[0]:
        raise ValueError(f"stems {stems.shape} do not match mixture {mixture.shape}")
    L = mixture.shape[0]
    spec_mix = stft(torch.from_numpy(mixture).to(dev), win, t.hop_size, t.nfft)
    spec_stems = stft(torch.from_numpy(stems).to(dev), win, t.hop_size, t.nfft)
    mags = spec_stems.abs() ** p
    mask = mags / (mags.sum(dim=0, keepdim=True) + eps)
    est = mask * spec_mix[None]
    return istft(est, win, t.hop_size, L, nfft=t.nfft).cpu().numpy()
