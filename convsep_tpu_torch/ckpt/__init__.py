"""Weight bridge to and from the reference parameter tree."""

from convsep_tpu_torch.ckpt.bridge import (
    from_jax_params,
    init_params,
    opt_state_from_jax,
    opt_state_to_jax,
    to_jax_params,
)

__all__ = [
    "from_jax_params",
    "init_params",
    "opt_state_from_jax",
    "opt_state_to_jax",
    "to_jax_params",
]
