"""Evaluation: BSS Eval (SDR/SIR/SAR) in torch float64 and the
ideal-soft-mask oracle."""

from convsep_tpu_torch.eval.bss_eval import (
    bss_eval_sources,
    bss_eval_stereo,
    bss_eval_windowed,
    sdr_only,
)
from convsep_tpu_torch.eval.oracle import oracle_stems

__all__ = [
    "bss_eval_sources",
    "bss_eval_stereo",
    "bss_eval_windowed",
    "oracle_stems",
    "sdr_only",
]
