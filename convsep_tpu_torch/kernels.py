"""Build, load and count the package's hand-written CUDA kernels.

The ``.cu`` sources under ``csrc/`` expose a plain C interface. On first
CUDA use they are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and linked into one shared library under
``<checkout>/build/kernels/``, named by a content hash of the sources, the
headers they include and the flags, so a changed file rebuilds and an
unchanged one is reused. The
library is bound with ``ctypes``: pointers and the stream pass as
``c_void_p``, each C entry returns ``cudaGetLastError()`` and :func:`check`
raises on a non-zero code.

Importing this module touches neither ``nvcc`` nor the GPU; a failed build
raises, and nothing falls back to a plain version.

``LAUNCHES`` counts kernel launches by name. It is the package's only
mutable global: each wrapper adds one where it launches its kernel, and
nowhere else, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "wiener_split.cu", "wiener_bluestein.cu", "wiener_istft.cu", "decoder_fused.cu",
    "stft_dft.cu", "fused_adadelta.cu", "istft.cu", "wiener_apply.cu", "ct_stft.cu",
    "band_decode.cu", "band_stream.cu", "band_stream_n128.cu", "band_stream_n192.cu",
    "band_stream_n256.cu",
)
HEADERS = ("fft_common.cuh", "wiener_common.cuh", "band_stream.cuh", "wgmma_bf16.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

LAUNCHES: dict[str, int] = {
    "wiener_istft": 0, "wiener_istft_ny": 0, "wiener_istft_cluster": 0,
    "wiener_istft_ny_cluster": 0, "wiener_istft_cluster_dit": 0,
    "wiener_istft_ny_cluster_dit": 0, "wiener_istft_cluster_mixed": 0,
    "wiener_istft_ny_cluster_mixed": 0, "wiener_istft_split": 0, "wiener_istft_ny_split": 0,
    "wiener_istft_bluestein": 0, "wiener_istft_ny_bluestein": 0, "wiener_istft_direct": 0,
    "wiener_istft_ny_direct": 0, "fused_decode": 0, "stft": 0, "stft_split": 0,
    "stft_bluestein": 0, "stft_cluster": 0, "stft_dft": 0, "fused_adadelta": 0, "istft": 0,
    "istft_split": 0, "istft_bluestein": 0, "istft_cluster": 0, "istft_cluster_dit": 0,
    "istft_cluster_mixed": 0, "istft_direct": 0,
    "wiener_apply": 0, "ct_stft": 0, "ct_stft_cluster": 0, "band_decode": 0,
    "band_decode_stream": 0, "stft_level2": 0, "istft_level2": 0, "istft_level2_direct": 0,
    "ct_stft_level": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # y, y_bf16, re, im, ny (or NULL), win_over_n, inv_norm, tw, tw_n (the split),
    # chirp, chat (Bluestein), out, out_int16, nt, S, nf, nfft, hop, length, groups,
    # rounds (rows for the direct sum), p2, eps, conserve_last, stream
    "wiener_istft_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _P),
    # y, y_bf16, re, im, ny (or NULL), win_over_n, inv_norm, tw, chirp, chat, out,
    # out_int16, nt, S, nf, nfft, hop, length, rounds, p2, eps, conserve_last,
    # active (NULL, or 1 int out: launches nothing), stream
    "wiener_cluster_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _I, _P, _P),
    # y, y_bf16, re, im, ny (or NULL), win_over_n, inv_norm, tw, out, out_int16, nt, S,
    # nf, nfft, hop, length, rounds, p2, eps, conserve_last, active (as above), stream
    "wiener_cluster_dit_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _I, _P, _P),
    # y, y_bf16, re, im, ny (or NULL), win_over_n, inv_norm, tw (the nfft-point table), out,
    # out_int16, nt, S, nf, nfft, hop, length, rounds, schedule (the block core's radices),
    # p2, eps, conserve_last, active (as above), stream
    "wiener_cluster_mixed_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _L, _I, _F, _I, _P, _P),
    # fc, k4, bias, kcat, out, out_bf16, B, J, S, W_pad, TpC, ktaps, TM, stream
    "fused_decode_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P),
    # B, J, S, W_pad, TpC, ktaps, TM, info (9 ints out)
    "fused_decode_plan": (_I, _I, _I, _I, _I, _I, _I, _P),
    # x, cosw, sinw, re, im, B, L, W, hop, nf, bins, stream
    "stft_dft_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw, re, im, B, L, W, hop, nf, nfft, ffts_per_block, stream
    "stft_fft_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw_p, tw_n, re, im, B, L, W, hop, nf, nfft, ffts_per_block, stream
    "stft_split_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw, chirp, chat, re, im, B, L, W, hop, nf, nfft, ffts_per_block, stream
    "stft_bluestein_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw, chirp, chat, re, im, B, L, W, hop, nf, nfft, stream
    "stft_cluster_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw, chirp, chat, scratch, re, im, B, L, W, hop, nf, nfft, per_round, stream
    "stft_level2_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # p, g, accu, delta_accu, n, lr, rho, one_minus_rho, eps, partial, sq, stream
    "fused_adadelta_launch": (_P, _P, _P, _P, _L, _F, _F, _F, _F, _P, _P, _P),
    # re, im, win_over_n, inv_norm, tw, out, out_int16, nt, nf, nfft, win, hop,
    # length, groups, rounds (rows for the direct sum), stream
    "istft_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # re, im, win_over_n, inv_norm, tw_p, tw_n, out, out_int16, nt, nf, nfft,
    # win, hop, length, groups, rounds, stream
    "istft_split_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # re, im, win_over_n, inv_norm, tw, chirp, chat, out, out_int16, nt, nf,
    # nfft, win, hop, length, groups, rounds, stream
    "istft_bluestein_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P),
    # re, im, win_over_n, inv_norm, tw, chirp, chat, out, out_int16, nt, nf,
    # nfft, win, hop, length, rounds, stream
    "istft_cluster_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P),
    # re, im, win_over_n, inv_norm, tw, out, out_int16, nt, nf, nfft, win, hop,
    # length, rounds, stream
    "istft_cluster_dit_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # re, im, win_over_n, inv_norm, tw (the nfft-point table), out, out_int16, nt, nf,
    # nfft, win, hop, length, rounds, schedule (the block core's radices), stream
    "istft_cluster_mixed_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L,
                                   _P),
    # re, im, win_over_n, inv_norm, tw, chirp, chat, scratch, frames, out, out_int16,
    # nt, nf, nfft, win, hop, length, per_round, stream
    "istft_level2_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P),
    # re, im, win_over_n, inv_norm, tables, scratch, frames, out, out_int16, nt, nf, nfft,
    # win, hop, length, per_round, schedule (the block core's radices), stream
    "istft_level2_direct_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _L, _P),
    # nfft, win, hop, route (0: Bluestein's cluster, 1: the direct one at the powers of
    # two, 2: the mixed one), active (1 int out)
    "istft_cluster_occupancy": (_I, _I, _I, _I, _P),
    # y, y_bf16, re, im, out_re, out_im, S, n, pmode, p, eps, stream
    "wiener_apply_launch": (_P, _I, _P, _P, _P, _P, _I, _L, _I, _F, _F, _P),
    # x, win, tw, re, im, ny, B, L, nfft, hop, nf, ffts_per_block, stream
    "ct_stft_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, win, tw, chirp, chat, re, im, ny, B, L, nfft, hop, nf, stream
    "ct_stft_cluster_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, win, tw, re, im, ny, B, L, nfft, hop, nf, stream
    "ct_stft_level_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # z, packed taps, out, M, Tp, C2, kh, I, grid, stream
    "band_decode_launch": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # z, packed taps, out, M, Tp, C2, kh, I, z row stride, out row stride, accumulate,
    # grid, stream
    "band_decode_piece_launch": (_P, _P, _P, _L, _I, _I, _I, _I, _L, _L, _I, _I, _P),
    # z, stream-packed taps, out, M, Tp, C2, kh, I, grid, stream
    "band_stream_launch": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # M, Tp, C2, kh, I, info (10 ints out)
    "band_stream_plan": (_L, _I, _I, _I, _I, _P),
    # N, active (1 int out: the clusters the card holds at once)
    "band_stream_clusters": (_I, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    """``build/kernels`` beside the package (``build/`` is git-ignored)."""
    return Path(__file__).resolve().parent.parent / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels cannot be built"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands together; raise with nvcc's output if any fails.
    Returns each command's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return outs


def build(verbose: bool = False) -> Path:
    """Compile the sources into the hashed library unless it exists; return
    its path. Each source compiles in its own ``nvcc`` process, all at
    once; then one link. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"libconvsep_kernels-{source_hash()}.so"
    if target.is_file():
        return target
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else [])]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        outs = _run_all([[nvcc, *flags, "-c", str(CSRC / s), "-o", o]
                         for s, o in zip(SOURCES, objs)])
        lib = str(Path(tmp) / "lib.so")
        outs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        if verbose:
            print("".join(outs))
        os.replace(lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device for a
    launch: nothing to enter when it already is (entering costs host time
    on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(code: int, name: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {code}")
