"""Fused ConvSep decode: the CUDA kernel's wrapper and plain version.

Replaces ``convsep_tpu/models/decoder_fused_pallas.py::band_freq_decode_pallas``.
Per fc row b, source s and expansion row w the decode is

    e = relu(fc[b] @ K4[:, s, w] + bias[s, w])      # (TpC,)
    out[b, s, w + i] += e @ Kcat[:, i]               # tap i < ktaps

with Kcat the tap-reversed composed band/freq decode matrix. The kernel
(``csrc/decoder_fused.cu``) keeps ``e`` (about 1.3 GB per highres4096
batch) out of device memory; its header says what bounds it on the H100.

The plain version materializes ``e`` and the per-tap products and folds
them with shifted adds. It is also this package's ``bandconv`` decode: the
reference's bandconv chain is the same linear map written as a conv.

:func:`band_freq_decode` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from convsep_tpu_torch import kernels

_WPAD = 8  # expansion rows are padded to a multiple of this (as the reference)
_SMEM_MAX = 227 * 1024


def w_pad_rows(W: int, ktaps: int) -> int:
    """Expansion rows padded so every output row the full conv reaches
    (W + ktaps - 1) exists and w blocks tile exactly (as the reference)."""
    return -(-(W + ktaps - 1) // _WPAD) * _WPAD


def fused_decode_supported(TpC: int, TM: int, ktaps: int) -> bool:
    """The reference's routing rule for ``decoder_impl="auto"``
    (``decoder_fused_pallas.fused_decode_supported``): TPU lane padding of
    TM to 128 must waste at most 25 %. Kept so "auto" routes the same
    shapes as the TPU did (highres/multires geometry, not dsd100);
    widening it needs an A/B on the card."""
    if not (ktaps - 1 <= 16 and TpC % 8 == 0 and 90 <= TM <= 384):
        return False
    return (-(-TM // 128) * 128) / TM <= 1.25


def kernel_supported(J: int, ktaps: int) -> bool:
    """The CUDA kernel's own envelope: its shared memory (8 fc rows of J, a
    32-column chunk of e for 16 + ktaps - 1 rows, a 32 x 128 Kcat tile)
    fits in a block's 227 KB."""
    return 4 * (8 * J + (16 + ktaps - 1) * 32 * 8 + 32 * 128) <= _SMEM_MAX


def kcat_of(KC: torch.Tensor) -> torch.Tensor:
    """Composed decode KC (ktaps, 1, TpC, TM) → Kcat (TpC, ktaps, TM), column
    block i holding conv tap ktaps - 1 - i."""
    return KC[:, 0].flip(0).permute(1, 0, 2)


def tap_fold(e: torch.Tensor, kcat: torch.Tensor) -> torch.Tensor:
    """The composed decode as a full conv along W: e (N, W, TpC) →
    (N, W + ktaps - 1, TM), ``out[w + i] += e[w] @ kcat[:, i]``, one GEMM
    for all taps and shifted adds. Differentiable in both operands."""
    N, W, TpC = e.shape
    _, ktaps, TM = kcat.shape
    g = (e.reshape(N * W, TpC) @ kcat.reshape(TpC, ktaps * TM)).reshape(N, W, ktaps, TM)
    out = e.new_zeros((N, W + ktaps - 1, TM))
    for i in range(ktaps):
        out[:, i:i + W] += g[:, :, i]
    return out


def prepare_operands(kernel: torch.Tensor, bias: torch.Tensor, KC: torch.Tensor,
                     S: int, W: int, TpC: int):
    """Raw fc_expand params ((J, S·W·TpC), (S·W·TpC,)) and the composed
    decode KC (ktaps, 1, TpC, TM) → the decode's operands:
    k4 (J, S, W_pad, TpC), b3 (S, W_pad, TpC), kcat (TpC, ktaps, TM) with
    column block i holding tap ktaps - 1 - i. Padded rows are zeros."""
    J = kernel.shape[0]
    ktaps = KC.shape[0]
    W_pad = w_pad_rows(W, ktaps)
    k4 = torch.nn.functional.pad(kernel.float().reshape(J, S, W, TpC), (0, 0, 0, W_pad - W))
    b3 = torch.nn.functional.pad(bias.float().reshape(S, W, TpC), (0, 0, 0, W_pad - W))
    return k4.contiguous(), b3.contiguous(), kcat_of(KC.float()).contiguous()


def band_freq_decode_plain(fc: torch.Tensor, k4: torch.Tensor, b3: torch.Tensor,
                           kcat: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """fc (B, J) → decode output (B, S, W_pad, TM) in ``out_dtype``: the
    full conv's rows past W_pad are dropped (the padded rows cover every
    row the real ones reach)."""
    B, J = fc.shape
    _, S, W_pad, TpC = k4.shape
    e = torch.relu(fc.float() @ k4.reshape(J, -1) + b3.reshape(-1))
    out = tap_fold(e.reshape(B * S, W_pad, TpC), kcat)[:, :W_pad]
    return out.reshape(B, S, W_pad, kcat.shape[2]).to(out_dtype)


def band_freq_decode(fc: torch.Tensor, k4: torch.Tensor, b3: torch.Tensor,
                     kcat: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """The fused decode: plain version on CPU tensors, the CUDA kernel on
    CUDA tensors (raises outside its envelope)."""
    B, J = fc.shape
    if k4.dim() != 4 or k4.shape[0] != J or kcat.dim() != 3 or kcat.shape[0] != k4.shape[3]:
        raise ValueError(
            f"band_freq_decode: fc {tuple(fc.shape)}, k4 {tuple(k4.shape)}, "
            f"kcat {tuple(kcat.shape)} do not align"
        )
    _, S, W_pad, TpC = k4.shape
    _, ktaps, TM = kcat.shape
    if b3.shape != (S, W_pad, TpC):
        raise ValueError(f"bias {tuple(b3.shape)} != {(S, W_pad, TpC)}")
    devices = {t.device.type for t in (fc, k4, b3, kcat)}
    if devices == {"cpu"}:
        return band_freq_decode_plain(fc, k4, b3, kcat, out_dtype)
    if devices != {"cuda"} or len({t.device for t in (fc, k4, b3, kcat)}) != 1:
        raise ValueError(f"band_freq_decode: tensors on mixed devices {devices}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if any(t.dtype != torch.float32 for t in (fc, k4, b3, kcat)):
        raise ValueError("band_freq_decode kernel takes float32 operands")
    if not kernel_supported(J, ktaps):
        raise ValueError(f"band_freq_decode kernel unsupported for J={J} ktaps={ktaps}")
    fc = fc.contiguous()
    k4, b3, kcat = k4.contiguous(), b3.contiguous(), kcat.contiguous()
    out = torch.empty((B, S, W_pad, TM), dtype=out_dtype, device=fc.device)
    lib = kernels.library()
    with torch.cuda.device(fc.device):
        stream = torch.cuda.current_stream(fc.device).cuda_stream
        code = lib.fused_decode_launch(
            fc.data_ptr(), k4.data_ptr(), b3.data_ptr(), kcat.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), B, J, S, W_pad,
            TpC, ktaps, TM, stream,
        )
    kernels.check(code, "fused_decode")
    kernels.LAUNCHES["fused_decode"] += 1
    return out

