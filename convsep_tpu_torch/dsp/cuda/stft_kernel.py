"""Fused framing + windowed dense DFT: the CUDA kernel's wrapper and plain
version.

Replaces ``convsep_tpu/dsp/pallas/stft_kernel.py::stft_pallas``, which the
from-audio training step runs for the mixture and every stem when
``TransformConfig.fft_impl="pallas"``. The kernel (``csrc/stft_dft.cu``)
builds each frame from hop rows staged in shared memory, so the
(frames × W) array never reaches device memory, and multiplies it by the
window-folded (W, bins) cos / -sin matrices of :func:`_forward_mats`; its
header says what bounds it on the H100.

The contract is the reference's: (L,) or (B, L) signals, ``win % hop ==
0``, the W//2 front pad and tail pad of :func:`_pad_signal`, and
:func:`num_frames` frames. :func:`stft_pallas` takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.dft import _forward_mats, _key, stft_matmul
from convsep_tpu_torch.dsp.stft import num_frames


def _check(signal: torch.Tensor, win_len: int, hop: int) -> None:
    if signal.dim() not in (1, 2):
        raise ValueError(f"stft_pallas expects (L,) or (B, L), got {tuple(signal.shape)}")
    if win_len % hop != 0:
        raise ValueError(f"pallas stft requires win % hop == 0, got {win_len}/{hop}")


def stft_pallas_plain(
    signal: torch.Tensor, window: np.ndarray, hop: int, nfft: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: :func:`stft_matmul`'s direct
    route (frames @ the window-folded DFT matrices)."""
    window = np.asarray(window, np.float64)
    _check(signal, len(window), int(hop))
    return stft_matmul(signal, window, int(hop), nfft, algorithm="direct")


def stft_pallas(
    signal: torch.Tensor, window: np.ndarray, hop: int, nfft: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of (L,) or (B, L) → (re, im), each (..., nf, nfft//2 + 1)
    float32, equal to :func:`stft_matmul`.

    CPU tensors: :func:`stft_pallas_plain`. CUDA tensors: the kernel."""
    window = np.asarray(window, np.float64)
    win_len = len(window)
    hop = int(hop)
    _check(signal, win_len, hop)
    if signal.device.type == "cpu":
        return stft_pallas_plain(signal, window, hop, nfft)
    if signal.device.type != "cuda":
        raise ValueError(f"stft_pallas: unsupported device {signal.device}")
    nfft = int(nfft or win_len)
    if nfft < win_len:
        raise ValueError(f"nfft {nfft} < window length {win_len}")
    batched = signal.dim() == 2
    x = (signal if batched else signal[None]).float().contiguous()
    B, L = x.shape
    nf = num_frames(L, hop)
    bins = nfft // 2 + 1
    cos_m, sin_m = _forward_mats(nfft, _key(window), str(x.device))
    re = torch.empty((B, nf, bins), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.stft_dft_launch(
            x.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(), re.data_ptr(),
            im.data_ptr(), B, L, win_len, hop, nf, bins, stream,
        )
    kernels.check(code, "stft")
    kernels.LAUNCHES["stft"] += 1
    return (re, im) if batched else (re[0], im[0])
