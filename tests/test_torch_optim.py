"""The optimizer registry and bf16 adadelta state, port against reference,
on CPU: ``convsep_tpu_torch.train.optim`` against ``optax`` 0.2.6 (adam,
adamw, sgd, rmsprop) and ``convsep_tpu.train.optim.lasagne_adadelta``
(float32 and bf16 state), from one bridged state on the tiny dsd100
parameter tree, five steps of the same seeded gradients.

Tolerances: parameters and float32 state within 1e-6 relative to each
leaf's largest magnitude after every step (float32 operations that may
round an ulp apart: XLA's pow and rsqrt against torch's); bf16
accumulators within one bf16 ulp of the reference's (the same float32
value rounded to nearest even, unless the two float32 values straddle a
rounding boundary)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from convsep_tpu.train import loop as jax_loop
from convsep_tpu.train.optim import AdadeltaState as JaxAdadeltaState
from convsep_tpu.train.optim import lasagne_adadelta as jax_adadelta
from convsep_tpu_torch.ckpt import from_jax_params, opt_state_from_jax, opt_state_to_jax
from convsep_tpu_torch.ckpt.bridge import to_jax_params
from convsep_tpu_torch.ckpt.checkpoint import flatten
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.train import loop
from convsep_tpu_torch.train.optim import (
    AdadeltaState,
    AdamState,
    RmsState,
    SgdState,
    lasagne_adadelta,
    make_optimizer,
)
from tests.test_losses_optim import _numpy_adadelta_steps
from tests.test_torch_train_model import port, tiny_dsd_preset

STEPS = 5
LR = {"adam": 0.01, "adamw": 0.01, "sgd": 0.1, "rmsprop": 0.01}


def _close(got: torch.Tensor, want, tol: float = 1e-6) -> None:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=tol * scale)


def _grads(rng, params: dict) -> list[dict]:
    return [{k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
            for _ in range(STEPS)]


def _start(name: str, **train_kw):
    """The reference's seeded train state for the tiny dsd100 preset with
    optimizer ``name``, and the port's bridged from it."""
    jp = tiny_dsd_preset(optimizer=name, learning_rate=LR.get(name, 1.0), **train_kw)
    jst, jopt = jax_loop.create_train_state(jp, 0)
    cfg = trainable_config(port(jp).model)
    params = from_jax_params(jst.params, cfg)
    pst, popt = loop.create_train_state(port(jp), 0, "cpu", params=params)
    pst.opt_state = opt_state_from_jax(jst.opt_state, cfg)
    return jp, cfg, jst, jopt, pst, popt


def _bf16_ulp_close(got: torch.Tensor, want) -> None:
    """Within one bf16 ulp of the larger magnitude, elementwise."""
    a = got.float().numpy()
    b = np.asarray(jnp.asarray(want, jnp.float32))
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-38))) - 7), 0.0)
    assert np.all(np.abs(a - b) <= ulp), float(np.max(np.abs(a - b) - ulp))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
def test_registry_matches_optax(rng, name):
    jp, cfg, jst, jopt, pst, popt = _start(name)
    want_type = {"adam": AdamState, "adamw": AdamState, "sgd": SgdState, "rmsprop": RmsState}
    assert isinstance(pst.opt_state, want_type[name])
    jparams, jstate = jst.params, jst.opt_state
    step = loop._apply_from_opt(popt)
    for grads in _grads(rng, pst.params):
        jg = jax.tree.map(jnp.asarray, to_jax_params({k: torch.from_numpy(g)
                                                      for k, g in grads.items()}))
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = pst.opt_state
        _, pst.opt_state, _ = step(pst.params, {k: torch.from_numpy(g) for k, g in grads.items()},
                                   pst.opt_state)
        assert pst.opt_state is before  # updated in place
        for k, p in pst.params.items():
            _close(p, _leaf(jparams, k))
        got = opt_state_to_jax(pst.opt_state)
        if name in ("adam", "adamw"):
            assert got["count"] == int(jstate[0].count) and pst.opt_state.count.dtype == torch.int32
            for k in pst.params:
                _close(pst.opt_state.mu[k], _leaf(jstate[0].mu, k))
                _close(pst.opt_state.nu[k], _leaf(jstate[0].nu, k))
        elif name == "rmsprop":
            for k in pst.params:
                _close(pst.opt_state.nu[k], _leaf(jstate[0].nu, k))
        else:
            assert got == {}


def _leaf(tree, name: str):
    params = tree.get("params", tree)
    from convsep_tpu_torch.ckpt.bridge import _NESTED

    for key in _NESTED.get(name, (name,)):
        params = params[key]
    return np.asarray(params)


def test_adamw_defaults_are_optax_not_torch(rng):
    """optax's adamw decays by 1e-4 (torch.optim.AdamW by 1e-2) and its
    rmsprop adds eps inside the root at decay 0.9 (torch: 0.99, outside)."""
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 0.5)}
    adam_u, _ = make_optimizer("adam", learning_rate=1.0).update(g, make_optimizer(
        "adam", learning_rate=1.0).init(p), p)
    w_opt = make_optimizer("adamw", learning_rate=1.0)
    adamw_u, _ = w_opt.update(g, w_opt.init(p), p)
    torch.testing.assert_close(adamw_u["w"] - adam_u["w"], torch.full((4,), -1e-4))
    r = make_optimizer("rmsprop", learning_rate=1.0)
    u, st = r.update(g, r.init(p), p)
    torch.testing.assert_close(st.nu["w"], 0.1 * 0.25 * torch.ones(4))
    torch.testing.assert_close(u["w"], -0.5 * torch.rsqrt(st.nu["w"] + 1e-8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adadelta_state_matches_reference(rng, dtype):
    """Five steps of the reference's adadelta, each from the reference's
    state of the step before, bridged: bf16 accumulators within one bf16
    ulp of the reference's after every step, parameters within 1e-6
    relative; float32 state within 1e-6. (Left to run free, a one-ulp
    straddle at one step moves that element's next update by up to 2^-8 of
    it: at this seed one delta_accu element of 62 976 straddles at step 3
    and its weight parts by 1.3e-5 at step 4.)"""
    kw = {} if dtype == "float32" else {"optimizer_state_dtype": dtype}
    jp, cfg, jst, jopt, pst, popt = _start("adadelta", **kw)
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(t.dtype == want_dtype for t in pst.opt_state.accu.values())
    jparams, jstate = jst.params, jst.opt_state
    step = loop._apply_from_opt(popt)
    for grads in _grads(rng, pst.params):
        jg = jax.tree.map(jnp.asarray, to_jax_params({k: torch.from_numpy(g)
                                                      for k, g in grads.items()}))
        with torch.no_grad():
            for k, p in pst.params.items():
                p.copy_(torch.from_numpy(_leaf(jparams, k).astype(np.float32)))
        pst.opt_state = opt_state_from_jax(jstate, cfg)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        step(pst.params, {k: torch.from_numpy(g) for k, g in grads.items()}, pst.opt_state)
        for k, p in pst.params.items():
            _close(p, _leaf(jparams, k))
            for got, want in ((pst.opt_state.accu[k], _leaf(jstate.accu, k)),
                              (pst.opt_state.delta_accu[k], _leaf(jstate.delta_accu, k))):
                assert got.dtype == want_dtype
                if dtype == "bfloat16":
                    _bf16_ulp_close(got, want)
                else:
                    _close(got, want)
    # the state crosses back: bf16 values pass float32 exactly
    back = opt_state_to_jax(pst.opt_state)
    for k in pst.params:
        np.testing.assert_array_equal(
            _leaf(back["accu"], k), pst.opt_state.accu[k].float().numpy())


def test_adadelta_bf16_state_tracks_oracle(rng):
    """Mirror of ``tests/test_losses_optim.py::
    test_adadelta_bf16_state_tracks_oracle``: bf16 storage, float32 math,
    a few steps close to the float32 numpy oracle and not equal to it."""
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(5)]
    opt = lasagne_adadelta(state_dtype="bfloat16")
    params = {"p": torch.from_numpy(p0.copy())}
    state = opt.init(params)
    assert state.accu["p"].dtype == state.delta_accu["p"].dtype == torch.bfloat16
    for g in grads:
        updates, state = opt.update({"p": torch.from_numpy(g)}, state)
        assert updates["p"].dtype == torch.float32  # math dtype, not storage
        assert state.accu["p"].dtype == torch.bfloat16
        params["p"] += updates["p"]
    oracle = _numpy_adadelta_steps(grads, p0)
    np.testing.assert_allclose(params["p"].numpy(), oracle, rtol=0.05, atol=5e-3)
    assert np.abs(params["p"].numpy() - oracle).max() > 0
    # and it is the reference's own bf16 update, step for step
    jopt = jax_adadelta(state_dtype="bfloat16")
    jp, jst = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    for g in grads:
        u, jst = jopt.update(jnp.asarray(g), jst)
        jp = optax.apply_updates(jp, u)
    _close(params["p"], np.asarray(jp))
    _bf16_ulp_close(state.accu["p"], jst.accu)
    _bf16_ulp_close(state.delta_accu["p"], jst.delta_accu)


def test_registry_refusals_and_in_place_state():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("nope")
    with pytest.raises(ValueError, match="state_dtype"):
        lasagne_adadelta(state_dtype="float16")
    opt = lasagne_adadelta(state_dtype="bfloat16")
    st = opt.init({"w": torch.ones(3)})
    assert isinstance(st, AdadeltaState) and not st.accu["w"].any()
    keep = st.accu["w"]
    p = {"w": torch.ones(3)}
    _, got, _ = loop._apply_from_opt(opt)(p, {"w": torch.full((3,), 2.0)}, st)
    # the plain apply writes the new state into the tensors it was given
    assert got is st and st.accu["w"] is keep and keep.dtype == torch.bfloat16
    assert torch.equal(keep, torch.full((3,), 0.2, dtype=torch.bfloat16))
    adam_st = make_optimizer("adam", learning_rate=1.0).init({"w": torch.ones(3)})
    assert set(flatten(adam_st)) == {"count", "mu/w", "nu/w"}
    assert flatten(SgdState()) == {}


def test_bf16_state_wiring_matches_reference():
    """The preset's optimizer_state_dtype reaches both packages' states,
    and the fused route refuses it in both (the same sentence)."""
    jp = tiny_dsd_preset(optimizer_state_dtype="bfloat16")
    jst, _ = jax_loop.create_train_state(jp, 0)
    pst, _ = loop.create_train_state(port(jp), 0, "cpu")
    assert all(str(a.dtype) == "bfloat16" for a in jax.tree.leaves(jst.opt_state))
    assert all(t.dtype == torch.bfloat16 for t in flatten(pst.opt_state).values())
    fused = dataclasses.replace(jp, train=dataclasses.replace(jp.train, optimizer_impl="fused"))
    with pytest.raises(ValueError, match="optimizer_state_dtype='float32'"):
        loop._preset_apply_fn(port(fused))
    with pytest.raises(ValueError, match="optimizer_state_dtype='float32'"):
        jax_loop._preset_apply_fn(fused)
    assert isinstance(jst.opt_state, JaxAdadeltaState)
