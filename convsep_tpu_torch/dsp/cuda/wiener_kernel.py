"""Generalized Wiener mask × mixture spectrum: the CUDA kernel's wrapper and
plain version.

Replaces ``convsep_tpu/dsp/pallas/wiener_kernel.py::wiener_apply_pallas``,
which separation runs with ``TransformConfig.fft_impl="pallas"`` between
the model and the iSTFT kernel. ``est_s = mix · relu(y_s)^p / (Σ_j
relu(y_j)^p + eps)``, the ratio in float32 whatever y's storage dtype. The
kernel (``csrc/wiener_apply.cu``) never writes the S masks to device
memory; its header says what bounds it on the H100.

The plain version fixes the order of every float32 operation (the sources'
sum runs from the first to the last, then eps is added; divide, then
multiply), and the kernel rounds each operation alone in that order, so
the two agree bit for bit for p in {1, 2}.

:func:`wiener_apply_pallas` takes the plain version only for CPU tensors.
For CUDA tensors it launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from convsep_tpu_torch import kernels


def _check(y: torch.Tensor, mix_re: torch.Tensor, mix_im: torch.Tensor) -> None:
    if y.dim() != 3 or tuple(mix_re.shape) != tuple(y.shape[1:]) or mix_im.shape != mix_re.shape:
        raise ValueError(
            f"mix {tuple(mix_re.shape)} / {tuple(mix_im.shape)} does not match y {tuple(y.shape)}"
        )


def wiener_apply_plain(
    y: torch.Tensor, mix_re: torch.Tensor, mix_im: torch.Tensor, p: float = 1.0,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, operation for operation."""
    _check(y, mix_re, mix_im)
    yf = y.float()
    yp = torch.where(yf > 0, yf, torch.zeros((), dtype=yf.dtype, device=yf.device))
    if p != 1.0:
        yp = torch.pow(yp, p)
    den = yp[0]
    for s in range(1, yp.shape[0]):
        den = den + yp[s]
    mask = yp / (den + eps)
    return mask * mix_re, mask * mix_im


def wiener_apply_pallas(
    y: torch.Tensor, mix_re: torch.Tensor, mix_im: torch.Tensor, p: float = 1.0,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """y (S, F, B) nonnegative estimates (float32 or bfloat16) + mixture
    re/im (F, B) float32 → masked estimates re/im (S, F, B) float32.

    CPU tensors: :func:`wiener_apply_plain`. CUDA tensors: the kernel."""
    _check(y, mix_re, mix_im)
    devices = {t.device.type for t in (y, mix_re, mix_im)}
    if devices == {"cpu"}:
        return wiener_apply_plain(y, mix_re, mix_im, p=p, eps=eps)
    if devices != {"cuda"} or len({t.device for t in (y, mix_re, mix_im)}) != 1:
        raise ValueError(f"wiener_apply: tensors on mixed devices {devices}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be float32 or bfloat16, got {y.dtype}")
    if mix_re.dtype != torch.float32 or mix_im.dtype != torch.float32:
        raise ValueError("mix re/im must be float32")
    S = int(y.shape[0])
    n = int(mix_re.numel())
    y = y.contiguous()
    mix_re, mix_im = mix_re.contiguous(), mix_im.contiguous()
    out_re = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    out_im = torch.empty_like(out_re)
    pmode = 0 if p == 1.0 else 1 if p == 2.0 else 2
    lib = kernels.library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        code = lib.wiener_apply_launch(
            y.data_ptr(), int(y.dtype == torch.bfloat16), mix_re.data_ptr(),
            mix_im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(), S, n, pmode,
            ctypes.c_float(p), ctypes.c_float(eps), stream,
        )
    kernels.check(code, "wiener_apply")
    kernels.LAUNCHES["wiener_apply"] += 1
    return out_re, out_im
