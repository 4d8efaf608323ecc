"""Generalized Wiener time-frequency soft masks.

Mirror of ``convsep_tpu.models.masks``: ``mask_i = relu(y_i)^p /
(sum_j relu(y_j)^p + eps)``. The ratio always divides in float32,
whatever y's storage dtype (the bf16 mask tail narrows only the
magnitudes), so every mask consumer agrees with every other.
"""

from __future__ import annotations

import torch


def wiener_mask(
    y: torch.Tensor,
    p: float = 1.0,
    eps: float = 1e-8,
    axis: int = -1,
    conserve_last: bool = False,
) -> torch.Tensor:
    """Per-source soft masks, sources on ``axis``.

    ``conserve_last`` gives the eps shortfall to the LAST source, so the
    masks sum to exactly 1: ``mask_last = (y_last^p + eps) / (sum + eps)``.
    """
    y = y.float()
    yp = torch.where(y > 0, y, torch.zeros((), dtype=y.dtype, device=y.device))
    if p != 1.0:
        yp = torch.pow(yp, p)
    denom = yp.sum(dim=axis, keepdim=True) + eps
    if conserve_last:
        yp = yp.clone()
        yp.select(axis, -1).add_(eps)
    return yp / denom


def wiener_filter(
    y: torch.Tensor, mix: torch.Tensor, p: float = 1.0, eps: float = 1e-8, axis: int = -1
) -> torch.Tensor:
    """Masked mixture estimates ``mask_i * mix``: ``mix`` is y's shape
    without the sources axis, broadcast over it (the training loss masks
    the mixture magnitude)."""
    return wiener_mask(y, p=p, eps=eps, axis=axis) * mix.unsqueeze(axis)
