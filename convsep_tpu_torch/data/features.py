"""Score-filtered extra input channels.

Mirror of ``score_channels`` in ``convsep_tpu.data.features``. The rest of
that module (walking a dataset directory and writing feature files) needs
the feature-file writer, which this package does not have yet.
"""

from __future__ import annotations

import numpy as np

from convsep_tpu_torch.score.masks import score_filtered_channels


def score_channels(
    mix_mag: np.ndarray, notes: list, preset, score_filter: str = "comb"
) -> np.ndarray:
    """Score-filtered extra input channels (n_frames, bins, S) by filter
    kind: "comb" = harmonic-comb gating (score/masks.py), "nmf" =
    score-constrained KL-NMF refinement (score/nmf.py). ``preset`` is a
    ``Preset``; ``mix_mag`` the mixture magnitude (n_frames, bins)."""
    kw = dict(fs=preset.transform.fs, hop=preset.transform.hop_size)
    if score_filter == "comb":
        return score_filtered_channels(mix_mag, notes, **kw)
    if score_filter == "nmf":
        from convsep_tpu_torch.score.nmf import score_nmf_channels

        return score_nmf_channels(mix_mag, notes, **kw)
    raise ValueError(f"unknown score_filter {score_filter!r}; have comb | nmf")
