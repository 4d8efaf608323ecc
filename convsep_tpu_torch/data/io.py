"""Host-side I/O: wav files (scipy, int16 ↔ float32), raw tensor feature
files, pickles.

Mirror of ``convsep_tpu.data.io``; the reference's ``convsep_tpu.data``
package imports JAX, so this package keeps its own copy. A feature file is
``<name>.data`` (raw float32, C order) beside ``<name>.shape`` (the dims,
comma-separated text), the same bytes either package writes; loads are
memory-mapped by default so the training pipeline slices segments without
reading whole tracks.
"""

from __future__ import annotations

import os
import pickle

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


def save_tensor(arr: np.ndarray, path: str | os.PathLike) -> None:
    """Write ``arr`` as float32 ``<path>`` (must end in ``.data``) and its
    ``.shape`` sidecar."""
    path = os.fspath(path)
    if not path.endswith(".data"):
        raise ValueError(f"tensor path must end with .data, got {path}")
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    arr.tofile(path)
    with open(path[: -len(".data")] + ".shape", "w") as f:
        f.write(",".join(str(d) for d in arr.shape))


def load_tensor(path: str | os.PathLike, mmap: bool = True) -> np.ndarray:
    """Load a ``.data`` tensor; memory-mapped (read-only) by default."""
    path = os.fspath(path)
    with open(path[: -len(".data")] + ".shape") as f:
        shape = tuple(int(d) for d in f.read().strip().split(","))
    if mmap:
        return np.memmap(path, dtype=np.float32, mode="r", shape=shape)
    return np.fromfile(path, dtype=np.float32).reshape(shape)


def save_obj(obj, path: str | os.PathLike) -> None:
    with open(os.fspath(path), "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_obj(path: str | os.PathLike):
    with open(os.fspath(path), "rb") as f:
        return pickle.load(f)
