"""Fused forward STFT with the Nyquist bin kept apart: the CUDA kernel's
wrapper, its plain version and the reference's routing rules.

:func:`stft_ct_pallas` replaces
``convsep_tpu/dsp/pallas/ct_stft_kernel.py::stft_ct_pallas``. Its kernel
(``csrc/ct_stft.cu``, on the FFT core ``csrc/fft_common.cuh`` that it
shares with the training STFT kernel) pads, frames, windows and FFTs the
signal in registers and shared memory, so the (nf, W) frames tensor never
exists, and writes the half-spectrum bins 0 … nfft/2 − 1 in natural order
with the real Nyquist bin as a row of its own; the Wiener+iSTFT kernel
reads that pair as it is (``wiener_istft(..., ny=)``). At the reference's
largest size, 16 384 points, past the core's 8192, the same file's level
kernel runs one 16 384-point transform a pair of frames on the core's level
(one 512-thread block a pair, counted as ``ct_stft_level``);
:func:`stft_ct_cluster_pallas` forces the earlier design there, Bluestein's
chirp-z on a thread-block cluster of 4 blocks (counted as
``ct_stft_cluster``), to hold and time it beside the level. The launch
plan, twiddle and chirp tables and window copy come from :mod:`.fft_plan`;
the kernel's header says what bounds it on the H100.

The wrapper takes its plain version only for CPU tensors. For CUDA tensors
it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.fft_plan import (
    MAX_NFFT,
    bluestein_size,
    bluestein_tables,
    fft_supported,
    stft_plan,
    twiddles,
    window_f32,
)
from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.stft import num_frames

_B = 128  # the reference kernel's lane-width sample factor: n = 128·a + b


def ct_stft_supported(nfft: int, win_len: int, hop: int) -> bool:
    """The reference kernel's shapes (``ct_stft_kernel.ct_stft_supported``):
    nfft == win, whole 128-sample sub-rows per hop (a multiple of 1024),
    A2 = nfft/128 >= 8 dividing 128 and K2 = nfft/256 >= 8 (nfft >= 2048),
    ``win % hop == 0``. Kept so ``analysis="ct_pallas"`` refuses what the
    reference refused."""
    if nfft != win_len or nfft % _B or hop % _B:
        return False
    A2, K2 = nfft // _B, nfft // (2 * _B)
    return (A2 >= 8 and K2 >= 8 and 128 % A2 == 0
            and (hop // _B) % 8 == 0 and win_len % hop == 0)


def resolve_analysis(analysis: str) -> str:
    """What the separation pipeline's analysis runs: "ct_pallas" (this
    wrapper) or "matmul" (:func:`stft_matmul`). "auto" means "matmul", as in
    the reference, whose kernel lost its A/B to the XLA chain on the TPU."""
    if analysis in ("auto", "matmul"):
        return "matmul"
    if analysis == "ct_pallas":
        return "ct_pallas"
    raise ValueError(f"unknown analysis {analysis!r}; have auto | ct_pallas | matmul")


def kernel_supported(nfft: int, hop: int) -> bool:
    """The CUDA kernels' own envelope: a power of two from 2048 to 16 384,
    every size :func:`ct_stft_supported` admits (the FFT core's template
    instances in ``ct_stft.cu`` up to 8192, the core's level at 16 384)."""
    return hop > 0 and (2048 <= nfft and fft_supported(nfft) or nfft == 2 * MAX_NFFT)


def stft_ct_pallas_plain(signal: torch.Tensor, window: np.ndarray, hop: int,
                         nfft: int | None = None):
    """The same function in plain PyTorch: :func:`stft_matmul` (factored at
    nfft >= 2048) split at the Nyquist bin."""
    nfft = int(nfft or len(window))
    half = nfft // 2
    re, im = stft_matmul(signal, window, hop, nfft)
    return re[..., :half], im[..., :half], re[..., half]


def stft_ct_pallas(
    signal: torch.Tensor,
    window: np.ndarray,
    hop: int,
    nfft: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, L) or (L,) signal → (re, im, ny): half-spectra without the
    Nyquist bin ((…, nf, nfft/2), natural bin order) and the real Nyquist
    row (…, nf). ``cat([re, ny[..., None]], -1)`` is :func:`stft_matmul`'s
    re up to float reassociation; im's Nyquist bin is 0.

    CPU tensors: :func:`stft_ct_pallas_plain`. CUDA tensors: the kernel."""
    return _stft_ct(signal, window, hop, nfft, cluster=False)


def stft_ct_cluster_pallas(
    signal: torch.Tensor,
    window: np.ndarray,
    hop: int,
    nfft: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`stft_ct_pallas` at 16 384 points through the cluster kernel
    (Bluestein on a cluster of 4 blocks) in place of the level's direct
    transform (CUDA tensors), so that the two can be held to each other and
    timed in one run. Other sizes and CPU tensors: :func:`stft_ct_pallas`."""
    return _stft_ct(signal, window, hop, nfft, cluster=True)


def _stft_ct(signal, window, hop, nfft, cluster: bool):
    window = np.asarray(window, np.float64)
    win_len = len(window)
    nfft = int(nfft or win_len)
    hop = int(hop)
    if not ct_stft_supported(nfft, win_len, hop):
        raise ValueError(
            f"stft_ct_pallas unsupported for nfft={nfft} win={win_len} hop={hop}; "
            "use dft.stft_matmul"
        )
    if signal.dim() not in (1, 2):
        raise ValueError(f"stft_ct_pallas expects (L,) or (B, L), got {tuple(signal.shape)}")
    if signal.device.type == "cpu":
        return stft_ct_pallas_plain(signal, window, hop, nfft)
    if signal.device.type != "cuda":
        raise ValueError(f"stft_ct_pallas: unsupported device {signal.device}")
    if not kernel_supported(nfft, hop):
        raise ValueError(f"stft_ct_pallas kernel unsupported for nfft={nfft} hop={hop}")
    x = signal.float().reshape(-1, signal.shape[-1]).contiguous()
    B, L = x.shape
    nf = num_frames(L, hop)
    half = nfft // 2
    dev = x.device
    out = torch.empty(B * nf * (2 * half + 1), dtype=torch.float32, device=dev)  # one allocation
    re, im, ny = (out[: B * nf * half].view(B, nf, half),
                  out[B * nf * half: 2 * B * nf * half].view(B, nf, half),
                  out[2 * B * nf * half:].view(B, nf))
    where = str(dev)
    win_d = window_f32(window, where).data_ptr()
    lib = kernels.library()
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        if fft_supported(nfft):
            name = "ct_stft"
            plan = stft_plan(B, nf, nfft, win_len, hop)
            code = lib.ct_stft_launch(
                x.data_ptr(), win_d, twiddles(nfft, where).data_ptr(), re.data_ptr(),
                im.data_ptr(), ny.data_ptr(), B, L, nfft, hop, nf, plan.ffts_per_block, stream,
            )
        elif not cluster:
            name = "ct_stft_level"
            code = lib.ct_stft_level_launch(
                x.data_ptr(), win_d, twiddles(nfft, where).data_ptr(), re.data_ptr(),
                im.data_ptr(), ny.data_ptr(), B, L, nfft, hop, nf, stream,
            )
        else:
            name = "ct_stft_cluster"
            chirp, chat = bluestein_tables(nfft, where)
            code = lib.ct_stft_cluster_launch(
                x.data_ptr(), win_d, twiddles(bluestein_size(nfft), where).data_ptr(),
                chirp.data_ptr(), chat.data_ptr(), re.data_ptr(), im.data_ptr(), ny.data_ptr(),
                B, L, nfft, hop, nf, stream,
            )
    kernels.check(code, name)
    kernels.LAUNCHES[name] += 1
    if signal.dim() == 1:
        return re[0], im[0], ny[0]
    return re, im, ny
