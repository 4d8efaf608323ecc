"""Separation: whole-track mono (:class:`Separator`) and stereo
(:class:`StereoSeparator`), chunked single-track (:class:`ChunkedSeparator`),
push-based online (:class:`OnlineSeparator`), batched multi-track
(:class:`StreamSeparator`) and the watch-folder service
(:class:`WatchService`)."""

from convsep_tpu_torch.separate.chunked import (
    ChunkedSeparator,
    separate_chunk,
    separate_chunk_stereo,
)
from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.separate.online import OnlineSeparator
from convsep_tpu_torch.separate.pipeline import (
    Separator,
    bucket_length,
    separate_fused,
    separate_fused_batch,
    source_magnitudes,
)
from convsep_tpu_torch.separate.service import WatchService
from convsep_tpu_torch.separate.stereo import (
    StereoSeparator,
    separate_fused_stereo,
    stereo_source_magnitudes,
)
from convsep_tpu_torch.separate.stream import (
    StreamSeparator,
    separate_batch,
    separate_batch_scan,
    separate_batch_scan_stereo,
    separate_batch_stereo,
)

__all__ = [
    "ChunkedSeparator",
    "OnlineSeparator",
    "Separator",
    "StereoSeparator",
    "StreamSeparator",
    "WatchService",
    "bucket_length",
    "derive_last_stem",
    "separate_batch",
    "separate_batch_scan",
    "separate_batch_scan_stereo",
    "separate_batch_stereo",
    "separate_chunk",
    "separate_chunk_stereo",
    "separate_fused",
    "separate_fused_batch",
    "separate_fused_stereo",
    "source_magnitudes",
    "stereo_source_magnitudes",
]
