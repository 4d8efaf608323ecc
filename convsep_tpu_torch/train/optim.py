"""Optimizers.

Mirror of ``convsep_tpu.train.optim``: Lasagne's adadelta
(``lasagne.updates.adadelta(loss, params, learning_rate=1.0, rho=0.95,
epsilon=1e-6)``):

    accu       <- rho * accu + (1 - rho) * g^2
    update     <- g * sqrt(delta_accu + eps) / sqrt(accu + eps)
    param      <- param - lr * update
    delta_accu <- rho * delta_accu + (1 - rho) * update^2

and the rest of the reference's registry, ``adam``, ``adamw``, ``sgd`` and
``rmsprop``, to optax 0.2.6's formulas and defaults (not torch.optim's:
its adamw decays by 1e-2, its RMSprop averages with 0.99 and adds eps
outside the root). Each is an optax-shaped pair of functions over flat
``{name: tensor}`` dicts, ``init(params) -> state`` and ``update(grads,
state, params) -> (updates, state)`` with the ``-lr`` scale inside the
updates; each state is a NamedTuple of flat dicts (and optax's int32
``count`` where optax keeps one), so checkpoints walk it. This is the
``optimizer_impl="xla"`` route and the fused kernel's plain reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class AdadeltaState(NamedTuple):
    accu: dict[str, torch.Tensor]
    delta_accu: dict[str, torch.Tensor]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` (adam and adamw)."""

    count: torch.Tensor  # () int32, the steps taken
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class RmsState(NamedTuple):
    """optax's ``ScaleByRmsState``."""

    nu: dict[str, torch.Tensor]


class SgdState(NamedTuple):
    """optax's plain SGD keeps no state."""


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def adadelta_leaf(g, a, d, rho: float, eps: float):
    """One leaf's adadelta math: (g, accu, delta_accu) → (update, accu',
    delta_accu'), in the reference's op order. The plain optimizer and the
    fused kernel's plain version both call this, so they agree bit for bit
    (and the kernel rounds each operation as this does)."""
    a2 = rho * a + (1.0 - rho) * g * g
    u = g * torch.sqrt(d + eps) / torch.sqrt(a2 + eps)
    d2 = rho * d + (1.0 - rho) * u * u
    return u, a2, d2


def _zeros(params: dict[str, torch.Tensor], dtype=torch.float32) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}


def lasagne_adadelta(
    learning_rate: float = 1.0,
    rho: float = 0.95,
    eps: float = 1e-6,
    state_dtype: str | None = None,
) -> GradientTransformation:
    """Adadelta with the reference's (Lasagne) formulation and defaults.

    ``state_dtype="bfloat16"`` stores the two accumulators in bf16 while
    every operation stays float32, in the reference's order: the upcast
    accu' and, from it unrounded, the update, then delta_accu' from the
    update, and only then both rounded to bf16 (to nearest even)."""
    if state_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"optimizer state_dtype {state_dtype!r}; have float32 | bfloat16")
    store = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32

    def init_fn(params: dict[str, torch.Tensor]) -> AdadeltaState:
        return AdadeltaState(accu=_zeros(params, store), delta_accu=_zeros(params, store))

    def update_fn(grads, state: AdadeltaState, params=None):
        del params
        accu, delta, updates = {}, {}, {}
        for k, g in grads.items():
            u, a2, d2 = adadelta_leaf(g, state.accu[k].float(), state.delta_accu[k].float(),
                                      rho, eps)
            accu[k], delta[k] = a2.to(store), d2.to(store)
            updates[k] = -learning_rate * u
        return updates, AdadeltaState(accu=accu, delta_accu=delta)

    return GradientTransformation(init_fn, update_fn)


def _bias_correction(moment: torch.Tensor, decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``bias_correction``: moment / (1 - decay**count), the power in
    float32 on the device."""
    return moment / (1 - decay ** count.float())


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: + 1, saturating at the int32 maximum."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def _adam(learning_rate: float, b1: float, b2: float, eps: float, eps_root: float,
          weight_decay: float | None) -> GradientTransformation:
    """optax's ``scale_by_adam``, then (``weight_decay``: adamw's
    ``add_decayed_weights``) ``+ weight_decay * param``, then ``-lr``:
    bias-corrected moments, ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``."""

    def init_fn(params):
        count = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
        return AdamState(count=count, mu=_zeros(params), nu=_zeros(params))

    def update_fn(grads, state: AdamState, params=None):
        count = _increment(state.count)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state.mu[k]
            nu[k] = (1 - b2) * g ** 2 + b2 * state.nu[k]
            u = _bias_correction(mu[k], b1, count) / (
                torch.sqrt(_bias_correction(nu[k], b2, count) + eps_root) + eps)
            if weight_decay is not None:
                u = u + weight_decay * params[k]
            updates[k] = -learning_rate * u
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> GradientTransformation:
    """``optax.adam``."""
    return _adam(learning_rate, b1, b2, eps, eps_root, None)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw``: adam with decoupled weight decay (optax's 1e-4)."""
    return _adam(learning_rate, b1, b2, eps, eps_root, weight_decay)


def sgd(learning_rate: float) -> GradientTransformation:
    """``optax.sgd`` without momentum: ``-lr * g``."""

    def update_fn(grads, state: SgdState, params=None):
        return {k: -learning_rate * g for k, g in grads.items()}, state

    return GradientTransformation(lambda params: SgdState(), update_fn)


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8,
            initial_scale: float = 0.0) -> GradientTransformation:
    """``optax.rmsprop`` at its defaults (eps inside the root, not
    centred, no momentum, no bias correction): ``nu = decay * nu + (1 -
    decay) * g^2``, ``-lr * g * rsqrt(nu + eps)``."""

    def init_fn(params):
        return RmsState(nu={k: torch.full_like(p, initial_scale, dtype=torch.float32)
                            for k, p in params.items()})

    def update_fn(grads, state: RmsState, params=None):
        nu, updates = {}, {}
        for k, g in grads.items():
            nu[k] = (1 - decay) * g ** 2 + decay * state.nu[k]
            updates[k] = -learning_rate * (g * torch.rsqrt(nu[k] + eps))
        return updates, RmsState(nu=nu)

    return GradientTransformation(init_fn, update_fn)


_REGISTRY = {"adadelta": lasagne_adadelta, "adam": adam, "adamw": adamw, "sgd": sgd,
             "rmsprop": rmsprop}


def make_optimizer(name: str = "adadelta", **kwargs) -> GradientTransformation:
    """Named optimizer factory; 'adadelta' is the reference-parity default."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's square-sum (``optax.global_norm``)."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))
