"""Build, load and count the package's hand-written CUDA kernels.

The ``.cu`` sources under ``csrc/`` expose a plain C interface. On first
CUDA use they are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and linked into one shared library under
``<checkout>/build/kernels/``, named by a content hash of the sources and
flags, so a changed source rebuilds and an unchanged one is reused. The
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

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("wiener_istft.cu", "decoder_fused.cu", "stft_dft.cu", "fused_adadelta.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

LAUNCHES: dict[str, int] = {
    "wiener_istft": 0, "fused_decode": 0, "stft": 0, "fused_adadelta": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # y, y_bf16, re, im, win_over_n, inv_norm, out, out_int16, nt, S, nf,
    # nfft, hop, length, rows_per_block, p2, eps, conserve_last, stream
    "wiener_istft_launch": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _I, _P),
    # fc, k4, bias, kcat, out, out_bf16, B, J, S, W_pad, TpC, ktaps, TM, stream
    "fused_decode_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P),
    # x, cosw, sinw, re, im, B, L, W, hop, nf, bins, stream
    "stft_dft_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # p, g, accu, delta_accu, n, lr, rho, one_minus_rho, eps, partial, sq, stream
    "fused_adadelta_launch": (_P, _P, _P, _P, _L, _F, _F, _F, _F, _P, _P, _P),
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
    for name in SOURCES:
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


def check(code: int, name: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {code}")
