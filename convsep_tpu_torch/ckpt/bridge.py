"""Weight bridge between the reference's flax parameter tree and this
package's flat state dict, plus seeded initialization.

Leaves (reference name → here): ``conv1_kernel`` (HWIO), ``conv1_bias``,
``conv2_kernel``, ``conv2_bias``, ``fc/kernel`` (rows in (T', F', C2)
order) → ``fc_kernel``, ``fc/bias`` → ``fc_bias``, ``fc_expand/kernel``
(columns w-major (W', Tp, C)) → ``fc_expand_kernel``, ``fc_expand/bias``
→ ``fc_expand_bias``, ``out_bias``. Layouts are unchanged. The bridge
takes the RAW tree from ``ConvSep(cfg).init``: a tree that went through
the reference's ``prepare_inference`` lacks ``fc_expand/kernel`` and is
refused. The derived ``enc_cache`` / ``dec_cache`` collections are
recomputed by :meth:`ConvSep.prepare_inference`, never bridged.

Training state crosses too: the parameters as the same flat dict (a
training step takes them as they are), and the adadelta accumulators, an
``AdadeltaState`` of two parameter-shaped trees in the reference, as
:class:`convsep_tpu_torch.train.optim.AdadeltaState` of two flat dicts
(:func:`opt_state_from_jax` / :func:`opt_state_to_jax`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.convsep import param_shapes

_NESTED = {
    "fc_kernel": ("fc", "kernel"),
    "fc_bias": ("fc", "bias"),
    "fc_expand_kernel": ("fc_expand", "kernel"),
    "fc_expand_bias": ("fc_expand", "bias"),
}


def from_jax_params(tree, cfg: ConvSepConfig, device=None) -> dict[str, torch.Tensor]:
    """Reference variables (``{"params": {...}}`` or the inner dict, leaves
    numpy-convertible) → flat float32 state dict on ``device``."""
    params = tree.get("params", tree)
    state = {}
    for name, shape in param_shapes(cfg).items():
        path = _NESTED.get(name, (name,))
        leaf = params
        for key in path:
            if key not in leaf:
                raise KeyError(
                    f"reference tree has no {'/'.join(path)} (a tree after "
                    "prepare_inference drops fc_expand/kernel; bridge the raw one)"
                )
            leaf = leaf[key]
        arr = np.array(leaf, np.float32)  # a writable copy
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {shape}")
        state[name] = torch.from_numpy(arr).to(device)
    return state


def to_jax_params(state: dict[str, torch.Tensor]) -> dict:
    """Flat state dict → reference tree ``{"params": {...}}`` of numpy."""
    params: dict = {}
    for name, t in state.items():
        path = _NESTED.get(name, (name,))
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().float().cpu().numpy()
    return {"params": params}


def opt_state_from_jax(state, cfg: ConvSepConfig, device=None):
    """Reference ``AdadeltaState`` (or anything with ``accu`` and
    ``delta_accu`` parameter trees, leaves numpy-convertible) → the port's
    ``AdadeltaState`` of flat float32 dicts on ``device``."""
    from convsep_tpu_torch.train.optim import AdadeltaState

    return AdadeltaState(
        accu=from_jax_params(state.accu, cfg, device),
        delta_accu=from_jax_params(state.delta_accu, cfg, device),
    )


def opt_state_to_jax(state) -> dict:
    """Flat adadelta state → ``{"accu": tree, "delta_accu": tree}`` of
    numpy (``AdadeltaState(**d)`` in the reference)."""
    return {"accu": to_jax_params(state.accu), "delta_accu": to_jax_params(state.delta_accu)}


def _glorot_uniform(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """flax ``glorot_uniform`` on an HWIO kernel: U(-l, l), l = sqrt(6 /
    (fan_in + fan_out)), fans counting the receptive field."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-lim, lim, generator=g)


def _lecun_normal(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal`` on an (in, out) kernel: a normal truncated at
    ±2 std, scaled so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t.mul_(std)


def init_params(cfg: ConvSepConfig, generator: torch.Generator, device=None) -> dict[str, torch.Tensor]:
    """Random parameters from the reference initializers' distributions
    (glorot_uniform convs, truncated lecun_normal denses, zero biases).
    The numbers differ from ``jax.random``'s; tests that compare packages
    bridge one tree instead. ``generator`` must live on ``device``."""
    state = {}
    for name, shape in param_shapes(cfg).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if name.endswith("bias"):
            t.zero_()
        elif name.startswith("conv"):
            _glorot_uniform(t, generator)
        else:
            _lecun_normal(t, generator)
        state[name] = t
    return state
