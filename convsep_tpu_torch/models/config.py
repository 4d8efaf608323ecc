"""ConvSep architecture hyperparameters, framework-free.

Field-for-field mirror of ``convsep_tpu.models.convsep.ConvSepConfig``:
the same names, defaults and derived sizes, so a preset means the same
network in both packages. The routing fields keep the reference's values;
:func:`convsep_tpu_torch.models.convsep.resolve_decoder_impl` maps them
onto this package's backends.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvSepConfig:
    time_context: int = 30
    feat_size: int = 513
    channels_in: int = 1
    num_sources: int = 2
    conv1_filters: int = 50
    conv1_freq: int = 30
    conv1_freq_stride: int = 1
    conv2_filters: int = 50
    conv2_time: int | None = None  # None -> time_context // 2
    bottleneck: int = 128
    # "first" | "sum" | "all": how the decoder collapses input channels
    decoder_reduce: str = "first"
    # dtype of the encoder/decoder GEMMs; only "float32" is ported
    compute_dtype: str = "float32"
    # dtype of the decode output / mask-magnitude tail; the Wiener ratio
    # always divides in float32
    mask_dtype: str = "float32"
    # "auto" | "bandconv" | "bandconv_pallas" (the fused decode kernel) |
    # "band" (two-stage, f32 GEMM) | "band_pallas" (two-stage, the band
    # decode kernel, bf16 operands); the reference's other decision-record
    # decoders are not ported
    decoder_impl: str = "bandconv"
    expand_order: str = "wmajor"
    encoder_impl: str = "collapsed"
    expand_pad: str = "kernel"

    @property
    def conv2_time_eff(self) -> int:
        return self.conv2_time if self.conv2_time is not None else self.time_context // 2

    @property
    def enc_time(self) -> int:
        """Frames after the (VALID) horizontal conv."""
        return self.time_context - self.conv2_time_eff + 1

    @property
    def enc_freq(self) -> int:
        """Bins after the (VALID, strided) vertical conv."""
        return (self.feat_size - self.conv1_freq) // self.conv1_freq_stride + 1

    @property
    def enc_flat(self) -> int:
        return self.enc_time * self.enc_freq * self.conv2_filters

    @property
    def ktaps(self) -> int:
        """Taps of the phase-decomposed frequency decode."""
        return -(-self.conv1_freq // self.conv1_freq_stride)
