"""Optimizers.

Mirror of ``convsep_tpu.train.optim``: Lasagne's adadelta
(``lasagne.updates.adadelta(loss, params, learning_rate=1.0, rho=0.95,
epsilon=1e-6)``):

    accu       <- rho * accu + (1 - rho) * g^2
    update     <- g * sqrt(delta_accu + eps) / sqrt(accu + eps)
    param      <- param - lr * update
    delta_accu <- rho * delta_accu + (1 - rho) * update^2

as an optax-shaped pair of functions over flat ``{name: tensor}`` dicts:
``init(params) -> AdadeltaState`` and ``update(grads, state, params) ->
(updates, state)``, with ``updates = -lr * update``. This is the
``optimizer_impl="xla"`` route and the fused kernel's plain reference.
Float32 state only; the other optimizers of the reference registry and
``state_dtype="bfloat16"`` are not ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class AdadeltaState(NamedTuple):
    accu: dict[str, torch.Tensor]
    delta_accu: dict[str, torch.Tensor]


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


def lasagne_adadelta(
    learning_rate: float = 1.0,
    rho: float = 0.95,
    eps: float = 1e-6,
    state_dtype: str | None = None,
) -> GradientTransformation:
    """Adadelta with the reference's (Lasagne) formulation and defaults."""
    if state_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"optimizer state_dtype={state_dtype!r} is not ported; float32 only "
            "(ROADMAP queue 1)"
        )

    def init_fn(params: dict[str, torch.Tensor]) -> AdadeltaState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

        return AdadeltaState(accu=zeros(), delta_accu=zeros())

    def update_fn(grads, state: AdadeltaState, params=None):
        del params
        accu, delta, updates = {}, {}, {}
        for k, g in grads.items():
            u, accu[k], delta[k] = adadelta_leaf(g, state.accu[k], state.delta_accu[k], rho, eps)
            updates[k] = -learning_rate * u
        return updates, AdadeltaState(accu=accu, delta_accu=delta)

    return GradientTransformation(init_fn, update_fn)


def _not_ported(name: str) -> Callable:
    def factory(**_kw):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported; have adadelta (ROADMAP queue 1)"
        )

    return factory


_REGISTRY = {
    "adadelta": lasagne_adadelta,
    **{name: _not_ported(name) for name in ("adam", "adamw", "sgd", "rmsprop")},
}


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
