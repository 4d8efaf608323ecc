"""Banded time-stage decode: the CUDA kernel's wrappers and plain version.

Replaces ``convsep_tpu/models/decoder_pallas.py::band_decode_pallas``. The
tied decoder's time stage is, per expansion row (n, w),

    out[n, w, (t, i)] = Σ_{h, c} z[n, w, h, c] · band[h, c, (t, i)]

with ``band`` the banded tap tensor of the time kernel
(:func:`band_tensor`). As in the reference, z and the band are rounded to
bfloat16 and the products summed in float32 (the reference's XLA-default
GEMM precision, kept by its kernel); a float32 decode would not match it.
The kernel (``csrc/band_decode.cu``) reads z in the expansion's own
w-major layout (N, W, Tp·C2); its header says what bounds it on the H100.

:func:`band_decode_wmajor` takes the plain version only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from convsep_tpu_torch import kernels


def band_tensor(kernel: torch.Tensor, time_context: int) -> torch.Tensor:
    """(kh, 1, I, O) tied kernel → (Tp, O, T·I) banded taps:
    ``band[h, o, H·I + i] = kernel[H − h, 0, i, o]`` for 0 <= H − h < kh,
    else 0."""
    kh, kw, I, O = kernel.shape
    if kw != 1:
        raise ValueError(f"band decode expects a (kh, 1, I, O) kernel, got {tuple(kernel.shape)}")
    T = time_context
    Tp = T - kh + 1
    delta = torch.arange(T)[None, :] - torch.arange(Tp)[:, None]  # (Tp, T)
    valid = ((delta >= 0) & (delta < kh)).to(kernel.device)
    taps = kernel[:, 0].permute(0, 2, 1)  # (kh, O, I)
    band = taps[delta.clamp(0, kh - 1).to(kernel.device)] * valid[:, :, None, None].to(kernel.dtype)
    return band.permute(0, 2, 1, 3).reshape(Tp, O, T * I)


def band_decode_wmajor_plain(z: torch.Tensor, band: torch.Tensor) -> torch.Tensor:
    """z (N, W, Tp·O) and band (Tp, O, T·I) → (N, W, T·I) float32: both
    rounded to bfloat16, the product in float32 (each bf16 × bf16 product
    is exact in float32)."""
    Tp, O, TI = band.shape
    zb = z.to(torch.bfloat16).float()
    return zb @ band.to(torch.bfloat16).float().reshape(Tp * O, TI)


def band_decode_wmajor(z: torch.Tensor, band: torch.Tensor, time_context: int) -> torch.Tensor:
    """The decode on the w-major fold: z (N, W, Tp·O) (float32 or bf16; a
    float32 z is rounded to bf16 first) and band (Tp, O, T·I), a
    :func:`band_tensor` (the kernel skips its structural zeros), T the time
    context → (N, W, T·I) float32. CPU tensors:
    :func:`band_decode_wmajor_plain`. CUDA tensors: the kernel."""
    Tp, O, TI = band.shape
    if z.dim() != 3 or z.shape[-1] != Tp * O or TI % time_context or time_context < Tp:
        raise ValueError(
            f"band_decode: z {tuple(z.shape)} and band {tuple(band.shape)} do not align "
            f"(time context {time_context})"
        )
    devices = {z.device.type, band.device.type}
    if devices == {"cpu"}:
        return band_decode_wmajor_plain(z, band)
    if devices != {"cuda"} or z.device != band.device:
        raise ValueError(f"band_decode: tensors on mixed devices {devices}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"band_decode: z must be float32 or bfloat16, got {z.dtype}")
    N, W, K = z.shape
    if K % 8:
        raise ValueError(f"band_decode kernel needs Tp·O % 8 == 0, got {K}")
    zb = z.to(torch.bfloat16).contiguous()
    # the band transposed, depth contiguous: the kernel's B operand
    bt = band.reshape(K, TI).t().to(torch.bfloat16).contiguous()
    out = torch.empty((N, W, TI), dtype=torch.float32, device=z.device)
    lib = kernels.library()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = lib.band_decode_launch(zb.data_ptr(), bt.data_ptr(), out.data_ptr(), N * W, K,
                                      TI, Tp, O, TI // time_context, stream)
    kernels.check(code, "band_decode")
    kernels.LAUNCHES["band_decode"] += 1
    return out


def band_decode_pallas(z: torch.Tensor, kernel: torch.Tensor, time_context: int) -> torch.Tensor:
    """The reference's contract: the (N, Tp, W, O) fold and the (kh, 1, I,
    O) time kernel → the (N, W, T·I) w-major time-stage decode (the layout
    ``freq_decode_wmajor`` takes)."""
    N, Tp, W, O = z.shape
    zw = z.permute(0, 2, 1, 3).reshape(N, W, Tp * O)
    return band_decode_wmajor(zw, band_tensor(kernel, time_context), time_context)
