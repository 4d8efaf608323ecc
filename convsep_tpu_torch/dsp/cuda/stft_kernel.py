"""Fused framing + windowed real FFT: the CUDA kernels' wrapper and plain
version.

Replaces ``convsep_tpu/dsp/pallas/stft_kernel.py::stft_pallas``, which the
from-audio training step runs for the mixture and every stem when
``TransformConfig.fft_impl="pallas"``, as does the ``fft_impl="pallas"``
separation route. ``csrc/stft_dft.cu`` holds four kernels, and the
wrapper dispatches on the shape:

* nfft a power of two in [16, 8192] (every preset): the FFT kernel of the
  shared core ``csrc/fft_common.cuh`` (launch plan, twiddles and window
  from :mod:`.fft_plan`), counted as ``LAUNCHES["stft"]``;
* nfft = m · 2^a, m in (3, 5, 9, 15), 2^a >= 16, nfft <= 8192 (768, 1280,
  1536, 2304, 3072, 6144, …): the core's mixed-radix split
  (:func:`.fft_plan.split_plan`), counted as ``LAUNCHES["stft_split"]``;
* any other nfft up to 8192 (1000 = 8 · 125, a factor 7, odd sizes; past
  4096 on the core's 16 384-point level, as 6000): Bluestein's chirp-z
  over the core (:func:`.fft_plan.bluestein_plan`, the chirp tables of
  :func:`.fft_plan.bluestein_tables`), counted as
  ``LAUNCHES["stft_bluestein"]``;
* past 8192, up to 65 536 (12 288, 20 000, 40 000, odd sizes): Bluestein over a
  thread-block cluster of the core (:func:`.fft_plan.cluster_plan`: M /
  8192 blocks a pair of frames, M 32 768, 65 536 or 131 072), counted as
  ``LAUNCHES["stft_cluster"]``;
* past 65 536, up to 262 144 (70 000, 131 072, odd sizes): Bluestein on the
  core's second level (:func:`.fft_plan.level2_plan`: M 262 144 or 524 288
  over two passes through a scratch in device memory, a round of pairs
  within half the L2), counted as ``LAUNCHES["stft_level2"]`` (one count a
  call: each round is four launches of its phases);
* the rest (past 262 144): the dense DFT kernel over the window-folded
  cos / -sin matrices of :func:`_forward_mats`, counted as
  ``LAUNCHES["stft_dft"]``; :func:`stft_dft_pallas` forces it at any size,
  to hold and time it. Its matrices take nfft × (nfft/2 + 1) × 8 bytes of
  device memory, which passes the card's 80 GB near nfft 140 000: past
  there only the second level computes the function on the card.

All keep the (frames × W) array out of device memory (the level, the
cluster and the second level read their frames from global memory into
registers, the others stage them in shared memory); the file's header says
what bounds them on the H100.

The contract is the reference's: (L,) or (B, L) signals, ``win % hop ==
0``, the W//2 front pad and tail pad of :func:`_pad_signal`, and
:func:`num_frames` frames. :func:`stft_pallas` takes the plain version
only for CPU tensors; for CUDA tensors it launches a kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.cuda.fft_plan import (
    bluestein_plan,
    bluestein_supported,
    bluestein_tables,
    cluster_plan,
    cluster_supported,
    fft_supported,
    level2_chat,
    level2_plan,
    level2_supported,
    split_plan,
    split_supported,
    stft_plan,
    twiddles,
    window_f32,
)
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

    CPU tensors: :func:`stft_pallas_plain`. CUDA tensors: the FFT kernel
    where :func:`fft_supported`, the split kernel where
    :func:`split_supported`, the Bluestein kernel where
    :func:`bluestein_supported`, the cluster kernel where
    :func:`cluster_supported`, the second level where
    :func:`level2_supported`, else the dense DFT kernel. A failed build or
    launch raises."""
    return _stft(signal, window, hop, nfft, dense=False)


def stft_dft_pallas(
    signal: torch.Tensor, window: np.ndarray, hop: int, nfft: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`stft_pallas` through the dense DFT kernel at any nfft (CUDA
    tensors), so that it can be held to the plain version and timed beside
    the FFT kernels at their sizes. CPU tensors: the plain version."""
    return _stft(signal, window, hop, nfft, dense=True)


def _stft(signal, window, hop, nfft, dense: bool):
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
    dev = x.device
    re, im = torch.empty((2, B, nf, bins), dtype=torch.float32, device=dev)  # one allocation
    lib = kernels.library()
    where = str(dev)
    with kernels.on_device(dev):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        if dense:
            name = "stft_dft"
        elif fft_supported(nfft):
            name = "stft"
        elif split_supported(nfft):
            name = "stft_split"
        elif bluestein_supported(nfft):
            name = "stft_bluestein"
        elif cluster_supported(nfft):
            name = "stft_cluster"
        else:
            name = "stft_level2" if level2_supported(nfft) else "stft_dft"
        if name == "stft":
            plan = stft_plan(B, nf, nfft, win_len, hop)
            code = lib.stft_fft_launch(
                x.data_ptr(), window_f32(window, where).data_ptr(),
                twiddles(nfft, where).data_ptr(), re.data_ptr(), im.data_ptr(),
                B, L, win_len, hop, nf, nfft, plan.ffts_per_block, stream,
            )
        elif name == "stft_split":
            plan = split_plan(B, nf, nfft, win_len, hop)
            code = lib.stft_split_launch(
                x.data_ptr(), window_f32(window, where).data_ptr(),
                twiddles(plan.p, where).data_ptr(), twiddles(nfft, where).data_ptr(),
                re.data_ptr(), im.data_ptr(), B, L, win_len, hop, nf, nfft,
                plan.ffts_per_block, stream,
            )
        elif name == "stft_bluestein":
            plan = bluestein_plan(B, nf, nfft, win_len, hop)
            chirp, chat = bluestein_tables(nfft, where)
            code = lib.stft_bluestein_launch(
                x.data_ptr(), window_f32(window, where).data_ptr(),
                twiddles(plan.m, where).data_ptr(), chirp.data_ptr(), chat.data_ptr(),
                re.data_ptr(), im.data_ptr(), B, L, win_len, hop, nf, nfft,
                plan.ffts_per_block, stream,
            )
        elif name == "stft_cluster":
            plan = cluster_plan(B, nf, nfft, win_len, hop)
            chirp, chat = bluestein_tables(nfft, where)
            code = lib.stft_cluster_launch(
                x.data_ptr(), window_f32(window, where).data_ptr(),
                twiddles(plan.m, where).data_ptr(), chirp.data_ptr(), chat.data_ptr(),
                re.data_ptr(), im.data_ptr(), B, L, win_len, hop, nf, nfft, stream,
            )
        elif name == "stft_level2":
            plan = level2_plan(B, nf, nfft, win_len, hop)
            chirp, _ = bluestein_tables(nfft, where)
            scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=dev)
            code = lib.stft_level2_launch(
                x.data_ptr(), window_f32(window, where).data_ptr(),
                twiddles(plan.m, where).data_ptr(), chirp.data_ptr(),
                level2_chat(nfft, where).data_ptr(), scratch.data_ptr(), re.data_ptr(),
                im.data_ptr(), B, L, win_len, hop, nf, nfft, plan.pairs_per_round, stream,
            )
        else:
            cos_m, sin_m = _forward_mats(nfft, _key(window), where)
            code = lib.stft_dft_launch(
                x.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(), re.data_ptr(),
                im.data_ptr(), B, L, win_len, hop, nf, bins, stream,
            )
    kernels.check(code, name)
    kernels.LAUNCHES[name] += 1
    return (re, im) if batched else (re[0], im[0])
