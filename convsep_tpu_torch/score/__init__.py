"""Score-informed separation support (Bach10): copies of
``convsep_tpu.score``, plain numpy."""

from convsep_tpu_torch.score.masks import (
    Note,
    parse_note_annotations,
    score_mask,
    score_filtered_channels,
    shift_notes,
    stretch_notes,
)
from convsep_tpu_torch.score.nmf import score_nmf, score_nmf_channels

__all__ = [
    "Note",
    "parse_note_annotations",
    "score_mask",
    "score_filtered_channels",
    "score_nmf",
    "score_nmf_channels",
    "shift_notes",
    "stretch_notes",
]
