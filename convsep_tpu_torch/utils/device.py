"""Device resolution with no fallback.

Replaces ``convsep_tpu.utils.backend``: the reference resolved which
*platform* a jit would land on; here the caller names the device, and a
CUDA request on a machine without a usable GPU is an error, never a quiet
move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device that is not available raises
    ``RuntimeError``; only an explicit ``"cpu"`` gives the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only {torch.cuda.device_count()} "
                "CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}; have cpu | cuda")
    return dev
