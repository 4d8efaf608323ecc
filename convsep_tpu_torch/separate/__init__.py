"""Whole-track separation: mono (:class:`Separator`) and stereo
(:class:`StereoSeparator`)."""

from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.separate.pipeline import (
    Separator,
    bucket_length,
    separate_fused,
    separate_fused_batch,
    source_magnitudes,
)
from convsep_tpu_torch.separate.stereo import (
    StereoSeparator,
    separate_fused_stereo,
    stereo_source_magnitudes,
)

__all__ = [
    "Separator",
    "StereoSeparator",
    "bucket_length",
    "derive_last_stem",
    "separate_fused",
    "separate_fused_batch",
    "separate_fused_stereo",
    "source_magnitudes",
    "stereo_source_magnitudes",
]
