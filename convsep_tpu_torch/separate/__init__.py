"""Whole-track separation."""

from convsep_tpu_torch.separate.pipeline import (
    Separator,
    bucket_length,
    separate_fused,
    separate_fused_batch,
    source_magnitudes,
)

__all__ = [
    "Separator",
    "bucket_length",
    "separate_fused",
    "separate_fused_batch",
    "source_magnitudes",
]
