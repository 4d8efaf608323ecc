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
training step takes them as they are), and the optimizer state, the
reference's ``AdadeltaState`` of two parameter-shaped trees (float32 or
bf16) or optax's adam, rmsprop and sgd chain states, as the port's
NamedTuples of flat dicts (:mod:`convsep_tpu_torch.train.optim`;
:func:`opt_state_from_jax` / :func:`opt_state_to_jax`).
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


def _state_tree(tree, cfg: ConvSepConfig, device=None) -> dict[str, torch.Tensor]:
    """A parameter-shaped state tree → flat dict, bf16 leaves kept bf16
    (their values pass float32 exactly), others float32."""
    flat = from_jax_params(tree, cfg, device)
    params = tree.get("params", tree)
    for name in flat:
        leaf = params
        for key in _NESTED.get(name, (name,)):
            leaf = leaf[key]
        if str(getattr(leaf, "dtype", "")) == "bfloat16":
            flat[name] = flat[name].to(torch.bfloat16)
    return flat


def opt_state_from_jax(state, cfg: ConvSepConfig, device=None):
    """A reference optimizer state, leaves numpy-convertible, → the port's:
    an ``AdadeltaState`` (float32 or bf16 accumulators), or optax's chain
    tuple of ``adam`` / ``adamw`` (``ScaleByAdamState`` first), ``rmsprop``
    (``ScaleByRmsState`` first) or ``sgd`` (empty states) as ``AdamState``,
    ``RmsState`` or ``SgdState``."""
    from convsep_tpu_torch.train import optim

    if hasattr(state, "accu"):
        return optim.AdadeltaState(accu=_state_tree(state.accu, cfg, device),
                                   delta_accu=_state_tree(state.delta_accu, cfg, device))
    head = state[0] if isinstance(state, tuple) and not hasattr(state, "_fields") else state
    if hasattr(head, "mu"):
        count = torch.tensor(int(np.asarray(head.count)), dtype=torch.int32, device=device)
        return optim.AdamState(count=count, mu=_state_tree(head.mu, cfg, device),
                               nu=_state_tree(head.nu, cfg, device))
    if hasattr(head, "nu"):
        return optim.RmsState(nu=_state_tree(head.nu, cfg, device))
    return optim.SgdState()


def opt_state_to_jax(state) -> dict:
    """The port's optimizer state → its reference fields as numpy:
    ``{"accu": tree, "delta_accu": tree}`` (``AdadeltaState(**d)``; bf16
    accumulators as float32 arrays of bf16 values), ``{"count": int32,
    "mu": tree, "nu": tree}`` (``ScaleByAdamState(**d)``), ``{"nu":
    tree}`` (``ScaleByRmsState(**d)``) or ``{}`` (SGD)."""
    out = {}
    for field, value in zip(state._fields, state):
        if isinstance(value, torch.Tensor):
            out[field] = np.int32(value.item())
        else:
            out[field] = to_jax_params(value)
    return out


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
