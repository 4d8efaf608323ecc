"""Separation training losses.

Mirror of ``convsep_tpu.train.losses``: squared error of each masked
estimate against its target, minus weighted squared errors against the
other sources' targets, with an (S, S) interference-weight matrix W (zero
diagonal):

    L = mean_i ||est_i - t_i||^2  -  mean_{i != j} W[i, j] ||est_i - t_j||^2
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def interference_matrix(
    num_sources: int,
    alpha: float = 0.001,
    beta: float | None = None,
    beta_voc: float | None = None,
    vocals_idx: int = 0,
    other_idx: int | None = None,
) -> np.ndarray:
    """Off-diagonal ``alpha``; columns whose target is the 'other' source
    ``beta``; columns whose target is the vocals ``beta_voc``."""
    w = np.full((num_sources, num_sources), alpha, dtype=np.float32)
    if beta is not None and other_idx is not None:
        w[:, other_idx] = beta
    if beta_voc is not None:
        w[:, vocals_idx] = beta_voc
    np.fill_diagonal(w, 0.0)
    return w


def interference_on_device(preset) -> Callable[[torch.device], torch.Tensor]:
    """The preset's interference matrix (its ``train`` weights) as a
    function of the device it is wanted on, each device's copy made once."""
    tr = preset.train
    w = interference_matrix(preset.model.num_sources, alpha=tr.alpha, beta=tr.beta,
                            beta_voc=tr.beta_voc, vocals_idx=tr.vocals_idx,
                            other_idx=tr.other_idx)
    copies: dict[torch.device, torch.Tensor] = {}

    def on(device: torch.device) -> torch.Tensor:
        if device not in copies:
            copies[device] = torch.as_tensor(w, device=device)
        return copies[device]

    return on


def separation_loss(
    est: torch.Tensor,
    targets: torch.Tensor,
    interference: np.ndarray | torch.Tensor | None = None,
    source_axis: int = -1,
) -> torch.Tensor:
    """Mean squared reconstruction minus weighted interference
    dissimilarity; sources on ``source_axis`` (``None`` interference:
    plain MSE summed over sources)."""
    if est.shape != targets.shape:
        raise ValueError(f"est {tuple(est.shape)} != targets {tuple(targets.shape)}")
    ax = source_axis % est.dim()
    recon = ((est - targets) ** 2).sum(dim=ax).mean()
    if interference is None:
        return recon
    w = torch.as_tensor(interference, dtype=est.dtype, device=est.device)
    # diff[..., i, j, ...] = est_i - t_j ; weighted mean over elements like recon
    diff = est.unsqueeze(ax + 1) - targets.unsqueeze(ax)
    w = w.reshape(w.shape + (1,) * (est.dim() - 1 - ax))
    penalty = (w * diff ** 2).sum(dim=(ax, ax + 1)).mean()
    return recon - penalty
