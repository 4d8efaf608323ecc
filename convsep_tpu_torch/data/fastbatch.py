"""ctypes binding of the native batch gather (``native/fastbatch.cpp``).

The counterpart of ``convsep_tpu.data.fastbatch``: the training pipeline's
host hot loop (cut a segment of ``time_context`` frames out of each
memory-mapped track, zero the tail, scale by the mult factor) in C++ on a
pool of threads. The repository's ``native/fastbatch.cpp`` is compiled with
``g++`` at first use into ``<checkout>/build/fastbatch/`` (git-ignored),
named by a hash of the source and the flags; a changed source rebuilds.

Where no compiler or no source exists, :func:`available` is False and
:class:`~convsep_tpu_torch.data.pipeline.SegmentDataset` assembles batches
with numpy instead (the same bytes); :func:`available` says which path is
in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "fastbatch.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
BUILD_DIR = ROOT / "build" / "fastbatch"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> Path | None:
    """Compile the source unless its hashed library exists; None when it
    cannot be built (no source, no g++, or g++ failed)."""
    if not SOURCE.is_file():
        return None
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"libfastbatch-{h}.so"
    if target.is_file():
        return target
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = Path(tmp) / "lib.so"
            subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(lib)], check=True,
                           capture_output=True, timeout=120)
            os.replace(lib, target)
    except (OSError, subprocess.SubprocessError):
        return None
    return target


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        if lib.fastbatch_abi_version() != 1:
            return None
        lib.assemble_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),  # tracks
            np.ctypeslib.ndpointer(np.int64, flags="C"),  # track_frames
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),  # seg_track
            np.ctypeslib.ndpointer(np.int64, flags="C"),  # seg_start
            ctypes.c_int64,  # batch
            ctypes.c_int64,  # T
            ctypes.c_int64,  # F
            ctypes.c_float,  # scale
            np.ctypeslib.ndpointer(np.float32, flags="C,WRITEABLE"),
            ctypes.c_int64,  # threads (0: one per core)
        ]
        lib.assemble_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded (the path
    ``SegmentDataset`` takes)."""
    return _load() is not None


def assemble_batch(
    tracks: list[np.ndarray],
    seg_track: np.ndarray,
    seg_start: np.ndarray,
    time_context: int,
    scale: float,
    out: np.ndarray | None = None,
    n_threads: int = 1,
) -> np.ndarray:
    """Gather (batch, T, F) float32 segments out of per-track (frames, F)
    float32 C-contiguous arrays (memmaps are), item b from track
    ``seg_track[b]`` at frame ``seg_start[b]``, zero past a track's end,
    each value times ``scale`` in float32. ``n_threads`` 0 starts one
    thread per core; one thread is the default because a training batch
    (32 segments of 30 × 513) copies in less time than the threads take
    to start (PERF.md)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastbatch unavailable (no g++ or no native/fastbatch.cpp)")
    F = tracks[0].shape[1]
    for t in tracks:
        if t.dtype != np.float32 or t.ndim != 2 or t.shape[1] != F:
            raise ValueError(f"tracks must be float32 (frames, {F}); got {t.dtype} {t.shape}")
        if not t.flags["C_CONTIGUOUS"]:
            raise ValueError("tracks must be C-contiguous (memmaps are)")
    batch = len(seg_track)
    if out is None:
        out = np.empty((batch, time_context, F), np.float32)
    ptrs = (ctypes.c_void_p * len(tracks))(*[t.ctypes.data for t in tracks])
    frames = np.asarray([t.shape[0] for t in tracks], np.int64)
    lib.assemble_batch(
        ptrs, frames, len(tracks),
        np.ascontiguousarray(seg_track, np.int64), np.ascontiguousarray(seg_start, np.int64),
        batch, time_context, F, float(scale), out, n_threads,
    )
    return out
