"""Checkpoints: the weight bridge to and from the reference parameter tree,
the checkpoint manager, and the reference pickle converter."""

from convsep_tpu_torch.ckpt.bridge import (
    from_jax_params,
    init_params,
    opt_state_from_jax,
    opt_state_to_jax,
    to_jax_params,
)
from convsep_tpu_torch.ckpt.checkpoint import CheckpointManager
from convsep_tpu_torch.ckpt.convert_reference import (
    convert_reference_checkpoint,
    convert_reference_params,
    export_reference_params,
    load_reference_pickle,
)

__all__ = [
    "CheckpointManager",
    "convert_reference_checkpoint",
    "convert_reference_params",
    "export_reference_params",
    "from_jax_params",
    "init_params",
    "load_reference_pickle",
    "opt_state_from_jax",
    "opt_state_to_jax",
    "to_jax_params",
]
