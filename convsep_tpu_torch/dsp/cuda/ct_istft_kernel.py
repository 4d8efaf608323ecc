"""Fused Wiener mask + iSTFT: the CUDA kernel's wrapper and plain version.

Replaces ``convsep_tpu/dsp/pallas/ct_istft_kernel.py::istft_ct_pallas_wiener``.
The kernel (``csrc/wiener_istft.cu``) masks the mixture spectrum with the
per-source magnitudes, inverse-FFTs each frame and overlap-adds it, so the
masked spectra never reach device memory; its header says what bounds it
on the H100 and how the design follows.

:func:`wiener_istft` takes the plain version only for CPU tensors. For CUDA
tensors it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.dsp.dft import _key, inverse_norm, istft_matmul
from convsep_tpu_torch.dsp.stft import num_frames

_SMEM_BUDGET = 200 * 1024  # bytes of the 227 KB a block may use
_MAX_ROWS = 16


def _max_rows(nfft: int, hop: int, S: int) -> int:
    """Hop rows that fit the shared-memory budget beside the twiddles, the
    spectrum buffer and the denominator row (the launcher sizes shared
    memory the same way)."""
    tw_len = nfft // 2 if nfft & (nfft - 1) == 0 else nfft
    fixed = tw_len * 8 + nfft * 8 + (nfft // 2 + 1) * 4
    return (_SMEM_BUDGET - fixed) // (S * hop * 4)


def wiener_istft_supported(nfft: int, win_len: int, hop: int, S: int = 1) -> bool:
    """The kernel's envelope: ``win == nfft``, nfft even in [16, 8192],
    ``nfft % hop == 0``, and one hop row of S sources in shared memory.
    Powers of two (every preset) take a radix-2 FFT; other even sizes a
    direct sum per sample."""
    return (
        win_len == nfft
        and 16 <= nfft <= 8192
        and nfft % 2 == 0
        and hop > 0
        and nfft % hop == 0
        and _max_rows(nfft, hop, S) >= 1
    )


def rows_per_block(nfft: int, hop: int, S: int) -> int:
    """Hop rows a block owns: as many as fit in shared memory, up to 16."""
    rows = min(_MAX_ROWS, _max_rows(nfft, hop, S))
    if rows < 1:
        raise ValueError(f"wiener_istft: S={S} hop={hop} nfft={nfft} exceeds shared memory")
    return rows


def wiener_istft_plain(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
    algorithm: str = "auto",
) -> torch.Tensor:
    """The same function in plain PyTorch: f32 Wiener mask × mixture (the
    masked spectra are materialized), then :func:`istft_matmul`."""
    from convsep_tpu_torch.models.masks import wiener_mask

    mask = wiener_mask(y, p=p, eps=eps, axis=-3, conserve_last=conserve_last)
    return istft_matmul(
        mask * re.unsqueeze(-3), mask * im.unsqueeze(-3), window, hop, length,
        nfft=2 * (int(re.shape[-1]) - 1), algorithm=algorithm,
        output_dtype=output_dtype,
    )


@lru_cache(maxsize=8)
def _win_over_n(window_key: tuple, device: str) -> torch.Tensor:
    w = np.asarray(window_key, np.float64)
    return torch.from_numpy((w / float(len(w))).astype(np.float32)).to(device)


def wiener_istft(
    y: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    window: np.ndarray,
    hop: int,
    length: int,
    p: float = 1.0,
    eps: float = 1e-8,
    conserve_last: bool = False,
    output_dtype: str = "float32",
) -> torch.Tensor:
    """y (..., S, nf, bins) nonnegative magnitudes (f32 or bf16) + re/im
    (..., nf, bins) mixture halves → stems (..., S, length), f32 or int16.

    CPU tensors: :func:`wiener_istft_plain`. CUDA tensors: the kernel."""
    window = np.asarray(window, np.float64)
    win_len = len(window)
    nfft = 2 * (int(re.shape[-1]) - 1)
    lead = tuple(re.shape[:-2])
    if tuple(y.shape[:len(lead)]) != lead or y.dim() != len(lead) + 3 \
            or tuple(y.shape[-2:]) != tuple(re.shape[-2:]) or im.shape != re.shape:
        raise ValueError(
            f"y {tuple(y.shape)} must be re/im's shape {tuple(re.shape)} with "
            "one sources axis inserted at -3"
        )
    if output_dtype not in ("float32", "int16"):
        raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
    expect = num_frames(length, hop)
    if int(re.shape[-2]) != expect:
        raise ValueError(
            f"re/im have {re.shape[-2]} frames but length={length}, hop={hop} "
            f"implies {expect}"
        )
    devices = {t.device.type for t in (y, re, im)}
    if devices == {"cpu"}:
        return wiener_istft_plain(
            y, re, im, window, hop, length, p=p, eps=eps,
            conserve_last=conserve_last, output_dtype=output_dtype,
        )
    if devices != {"cuda"} or len({t.device for t in (y, re, im)}) != 1:
        raise ValueError(f"wiener_istft: tensors on mixed devices {devices}")
    S = int(y.shape[-3])
    if not wiener_istft_supported(nfft, win_len, hop, S):
        raise ValueError(
            f"wiener_istft kernel unsupported for nfft={nfft} win={win_len} hop={hop} S={S}"
        )
    if p not in (1.0, 2.0):
        raise ValueError(f"wiener_istft kernel supports p in (1, 2), got {p}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError("re/im must be float32")
    nf = int(re.shape[-2])
    bins = int(re.shape[-1])
    nt = int(np.prod(lead)) if lead else 1
    dev = y.device
    y4 = y.reshape(nt, S, nf, bins).contiguous()
    re3 = re.reshape(nt, nf, bins).contiguous()
    im3 = im.reshape(nt, nf, bins).contiguous()
    win_n = _win_over_n(_key(window), str(dev))
    inv_norm = inverse_norm(_key(window.astype(np.float32)), int(hop), nf, str(dev))
    out_dt = torch.int16 if output_dtype == "int16" else torch.float32
    out = torch.empty((nt, S, length), dtype=out_dt, device=dev)
    rows = rows_per_block(nfft, hop, S)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.wiener_istft_launch(
            y4.data_ptr(), int(y4.dtype == torch.bfloat16), re3.data_ptr(),
            im3.data_ptr(), win_n.data_ptr(), inv_norm.data_ptr(), out.data_ptr(),
            int(out_dt == torch.int16), nt, S, nf, nfft, int(hop), int(length), rows,
            int(p == 2.0), ctypes.c_float(eps), int(conserve_last), stream,
        )
    kernels.check(code, "wiener_istft")
    kernels.LAUNCHES["wiener_istft"] += 1
    return out.reshape(*lead, S, length)
