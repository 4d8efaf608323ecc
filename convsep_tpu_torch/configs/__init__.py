from convsep_tpu_torch.configs.presets import (
    PRESETS,
    Preset,
    SepConfig,
    TrainConfig,
    TransformConfig,
    get_preset,
    preset_from_dict,
    stereo_preset,
)

__all__ = [
    "PRESETS",
    "Preset",
    "SepConfig",
    "TrainConfig",
    "TransformConfig",
    "get_preset",
    "preset_from_dict",
    "stereo_preset",
]
