"""ConvSep model (inference and training), masks and the fused decode
kernel."""

from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.convsep import ConvSep

__all__ = ["ConvSep", "ConvSepConfig"]
