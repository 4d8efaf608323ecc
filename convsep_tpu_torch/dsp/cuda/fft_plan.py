"""Host side of the forward-STFT FFT core (``csrc/fft_common.cuh``): the
launch plan, the twiddle table and the device copies of the window.

The two forward STFT kernels (``csrc/stft_dft.cu``, ``csrc/ct_stft.cu``)
run one complex FFT of nfft points, carrying two real frames, on a group of
nfft / 16 threads that hold 16 points each in registers, in Stockham passes
of the radices :func:`radices` gives, with one exchange buffer of
:func:`exchange_entries` float2 per group in shared memory (slot
:func:`exchange_slot`). A block holds ``ffts_per_block`` groups and first
loads the signal span of their 2 · ``ffts_per_block`` frames.
:func:`stft_plan` chooses that number for a shape, and computes the block's
threads, shared memory and the grid exactly as the C launchers do.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_MAX = 227 * 1024    # dynamic shared memory a block may use
MAX_THREADS = 512        # fft_common::kMaxThreads
POINTS = 16              # complex points a thread holds
MAX_NAMED_GROUPS = 8     # groups per block that synchronize on named barriers
MIN_NFFT, MAX_NFFT = 2 ** 4, 2 ** 13


def fft_supported(nfft: int) -> bool:
    """A power of two that the FFT core's template covers (16 … 8192)."""
    return MIN_NFFT <= nfft <= MAX_NFFT and nfft & (nfft - 1) == 0


def radices(nfft: int) -> tuple[int, ...]:
    """The Stockham passes' radices in order: log2(nfft) mod 4 bits first
    (radix 2, 4 or 8) when nfft is not a power of 16, then radix 16."""
    lg = int(nfft).bit_length() - 1
    return ((1 << lg % 4,) if lg % 4 else ()) + (16,) * (lg // 4)


def threads_per_fft(nfft: int) -> int:
    return nfft // POINTS


def exchange_entries(nfft: int) -> int:
    """float2 entries of one group's exchange buffer: one pad per 16."""
    return nfft + nfft // 16


def exchange_slot(i):
    """Where element i of a pass's output lives in the exchange buffer."""
    return i + (i >> 4)


def span_floats(frames: int, win: int, hop: int) -> int:
    """Shared floats of the span of ``frames`` frames: (frames − 1) hop + W
    samples in whole float4s, plus the 16-byte alignment shift."""
    return ((frames - 1) * hop + win + 3) // 4 * 4 + 8


def twiddle_entries(nfft: int) -> int:
    """float2 slots of the quarter twiddle table in shared memory."""
    return nfft // 4 + nfft // 64


def smem_bytes(nfft: int, win: int, hop: int, ffts: int) -> int:
    return (4 * span_floats(2 * ffts, win, hop)
            + 8 * (twiddle_entries(nfft) + ffts * exchange_entries(nfft)))


@dataclass(frozen=True)
class StftPlan:
    nfft: int
    ffts_per_block: int   # complex FFTs (groups) per block: 2× as many frames
    threads: int          # per block
    blocks_per_signal: int
    blocks: int
    smem_bytes: int


@lru_cache(maxsize=64)
def stft_plan(signals: int, nf: int, nfft: int, win: int, hop: int) -> StftPlan:
    """The launch of ``signals`` × ``nf`` frames: the most FFTs per block
    (a power of two) that still gives at least two blocks per SM, so that
    overlapping frames share one span load and every SM has work; the
    fewest when no choice reaches that. Blocks are whole warps; at most 8
    groups of more than one warp (their named barriers) and 512 threads."""
    if not fft_supported(nfft):
        raise ValueError(f"no FFT plan for nfft={nfft}: a power of two in "
                         f"[{MIN_NFFT}, {MAX_NFFT}]")
    t = threads_per_fft(nfft)
    g_min = max(1, 32 // t)
    g_max = MAX_THREADS // t if t <= 32 else min(MAX_NAMED_GROUPS, MAX_THREADS // t)
    choices = [1 << e for e in range(int(math.log2(g_max)), int(math.log2(g_min)) - 1, -1)
               if smem_bytes(nfft, win, hop, 1 << e) <= SMEM_MAX]
    if not choices:
        raise ValueError(f"no FFT plan fits shared memory: nfft={nfft} win={win} hop={hop}")
    g = next((c for c in choices if signals * -(-nf // (2 * c)) >= 2 * SMS), choices[-1])
    per_signal = -(-nf // (2 * g))
    return StftPlan(nfft, g, g * t, per_signal, signals * per_signal,
                    smem_bytes(nfft, win, hop, g))


def twiddle_table(nfft: int) -> np.ndarray:
    """(nfft, 2) float32: e^{−2πi m / nfft} = (cos, −sin). The first
    quadrant (m < nfft/4) is computed in float64 and rounded once; the
    others are it times (−i)^q, exact swaps and negations, as the kernels
    turn it (``Fft::twiddle``)."""
    q = nfft // 4
    ang = 2.0 * np.pi * np.arange(q) / nfft
    c, s = np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)
    quads = [(c, s), (s, -c), (-c, -s), (-s, c)]
    return np.concatenate([np.stack(p, -1) for p in quads])


@lru_cache(maxsize=16)
def twiddles(nfft: int, device: str) -> torch.Tensor:
    """The first quadrant of :func:`twiddle_table` (nfft/4 rows), which the
    kernels copy into shared memory, on ``device``, made once per (nfft,
    device)."""
    return torch.from_numpy(np.ascontiguousarray(twiddle_table(nfft)[: nfft // 4])).to(device)


_windows: list[tuple[bytes, str, torch.Tensor]] = []
_windows_lock = threading.Lock()


def window_f32(window: np.ndarray, device: str) -> torch.Tensor:
    """The window as float32 on ``device``, copied once. Callers build a
    fresh array per call, so it is found again by comparing its bytes with
    the last few windows' (a memcmp), not by hashing them."""
    key = np.ascontiguousarray(window, np.float64).tobytes()
    with _windows_lock:
        for i, (k, d, t) in enumerate(_windows):
            if d == device and k == key:
                if i:
                    _windows.insert(0, _windows.pop(i))
                return t
        t = torch.from_numpy(np.frombuffer(key, np.float64).astype(np.float32)).to(device)
        _windows.insert(0, (key, device, t))
        del _windows[8:]
        return t
