"""PCM16 quantization: round-to-nearest (half to even), clipped.

Mirror of ``convsep_tpu.utils.pcm``; the Wiener+iSTFT kernel's int16
epilogue (``rintf`` + clip) computes the same function.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_pcm16(x: torch.Tensor) -> torch.Tensor:
    """Device-side float → PCM16 (tensor in, int16 tensor out)."""
    return torch.clamp(torch.round(x * 32768.0), -32768.0, 32767.0).to(torch.int16)


def quantize_pcm16_host(x: np.ndarray) -> np.ndarray:
    """Host-side float → PCM16 (numpy in, numpy out)."""
    return np.clip(
        np.rint(np.asarray(x, np.float32) * 32768.0), -32768, 32767
    ).astype(np.int16)
