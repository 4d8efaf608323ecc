"""Weight bridge to and from the reference parameter tree."""

from convsep_tpu_torch.ckpt.bridge import from_jax_params, init_params, to_jax_params

__all__ = ["from_jax_params", "init_params", "to_jax_params"]
