"""Wav file I/O (scipy), int16 ↔ float32.

Mirror of ``read_wav`` / ``write_wav`` in ``convsep_tpu.data.io``; the
reference's ``convsep_tpu.data`` package imports JAX, so this package keeps
its own copy. The feature-file and pickle helpers are not ported.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile

from convsep_tpu_torch.utils.pcm import quantize_pcm16_host

INT16_SCALE = 32768.0


def read_wav(path: str | os.PathLike) -> tuple[int, np.ndarray]:
    """Read a wav file → (sample_rate, float32 in [-1, 1) per channel);
    float wavs pass through, stereo stays (n, 2)."""
    fs, data = wavfile.read(os.fspath(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / INT16_SCALE
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return int(fs), data


def write_wav(path: str | os.PathLike, fs: int, audio: np.ndarray) -> None:
    """Write audio as int16 wav; float input is rounded and clipped to
    PCM16, int16 input is written as it is."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = quantize_pcm16_host(audio)
    wavfile.write(os.fspath(path), int(fs), audio)
