"""The feature-file training slice, port against reference, on CPU: the
feature loss and every gradient leaf, a 3-step ``make_train_step``
trajectory with ``optimizer_impl="fused"`` from a bridged train state,
``make_train_step_multi``, the eval step, and ``Trainer(from_audio=False)``
on feature files written by the port's ``compute_features``, at the JAX
tests' tiny sizes (``tests/test_torch_train_model.py::PRESETS``).

Tolerances: loss within 1e-5 relative; every gradient leaf within 1e-5 ×
max|grad| over all leaves at ``wiener_eps`` 1e-2 (why: the module
docstring of ``tests/test_torch_train_e2e.py``); the trajectory step by
step as its test says; K steps per call equal K single steps bit for bit
(the same operations in the same order)."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.train import loop as jax_loop
from convsep_tpu_torch.ckpt import from_jax_params, opt_state_from_jax
from convsep_tpu_torch.data import io, synth
from convsep_tpu_torch.data.features import compute_features
from convsep_tpu_torch.data.pipeline import SegmentDataset
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.train import loop
from tests.test_torch_chunked import one_intraop_thread  # noqa: F401
from tests.test_torch_train_model import PRESETS, port

FS = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with(jp, optimizer_impl="fused", **train_kw):
    return dataclasses.replace(
        jp, train=dataclasses.replace(jp.train, optimizer_impl=optimizer_impl, **train_kw))


def _batch(rng, jp, B):
    """Feature batch: mixture magnitudes x (B, T, F, C) and source targets
    y (B, S, T, F), nonnegative, scaled like SegmentDataset's."""
    m = jp.model
    x = 0.3 * np.abs(rng.standard_normal((B, m.time_context, m.feat_size, m.channels_in)))
    y = 0.3 * np.abs(rng.standard_normal((B, m.num_sources, m.time_context, m.feat_size)))
    return x.astype(np.float32), y.astype(np.float32)


def _bridged_params(jax_params, cfg):
    return {k: v.requires_grad_() for k, v in from_jax_params(jax_params, cfg).items()}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_feature_loss_and_grads_match_jax(rng, name):
    jp = _with(PRESETS[name]())
    state, _ = jax_loop.create_train_state(jp, 0)
    x, y = _batch(rng, jp, 3)
    cfg = trainable_config(port(jp).model)
    args = torch.from_numpy(x), torch.from_numpy(y)
    loss = loop._feature_loss_fn(port(jp))(_bridged_params(state.params, cfg), *args)
    j_loss = jax_loop._feature_loss_fn(jp)(state.params, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    jp = dataclasses.replace(jp, sep=dataclasses.replace(jp.sep, wiener_eps=1e-2))
    j_loss, j_grads = jax.value_and_grad(jax_loop._feature_loss_fn(jp))(
        state.params, jnp.asarray(x), jnp.asarray(y))
    params = _bridged_params(state.params, cfg)
    loss = loop._feature_loss_fn(port(jp))(params, *args)
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    want = from_jax_params(j_grads, cfg)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, g in grads.items():
        assert float(g.abs().max()) > 1e-3 * scale, k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=k)
    # the eval step is the same loss, without gradients
    ev = loop.make_eval_step(port(jp))(params, *args)
    j_ev = jax_loop.make_eval_step(jp)(state.params, jnp.asarray(x), jnp.asarray(y))
    assert not ev.requires_grad
    np.testing.assert_allclose(float(ev), float(j_ev), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_fused_feature_trajectory_matches_jax(rng, name):
    """One JAX step makes the adadelta state nontrivial; the state is
    bridged and both packages take 3 more steps on the same batches, as
    ``test_torch_train_e2e.py::test_fused_trajectory_matches_jax`` does:
    every step's loss within 1e-4 relative, the first bridged step's grad
    norm within 1e-5 relative, and each port step taken from the bridged
    JAX state within 1e-6 of the JAX step's parameters."""
    jp = _with(PRESETS[name]())
    pp = port(jp)
    cfg = trainable_config(pp.model)
    jstate, jopt = jax_loop.create_train_state(jp, 1)
    jstep = jax_loop.make_train_step(jp, jopt)
    batches = [_batch(rng, jp, 4) for _ in range(4)]
    jstate, _ = jstep(jstate, *map(jnp.asarray, batches[0]))

    def bridged(js):
        s, opt = loop.create_train_state(pp, params=from_jax_params(js.params, cfg),
                                         device="cpu")
        return loop.TrainState(step=int(js.step), params=s.params,
                               opt_state=opt_state_from_jax(js.opt_state, cfg)), opt

    tstate, topt = bridged(jstate)
    tstep = loop.make_train_step(pp, topt)
    for i, (x, y) in enumerate(batches[1:]):
        args = torch.from_numpy(x), torch.from_numpy(y)
        fstate, _ = tstep(bridged(jstate)[0], *args)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tm = tstep(tstate, *args)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        if i == 0:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-5)
        want = from_jax_params(jstate.params, cfg)
        for k, p in fstate.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"step {i}: {k}")
    assert tstate.step == fstate.step == int(jstate.step) == 4


def test_multi_step_equals_single_steps(rng):
    jp = _with(PRESETS["dsd100_tiny"]())
    pp = port(jp)
    batches = [_batch(rng, jp, 4) for _ in range(3)]
    s1, opt = loop.create_train_state(pp, 5, "cpu")
    s2, _ = loop.create_train_state(pp, 5, "cpu")
    single = loop.make_train_step(pp, opt)
    losses = []
    for x, y in batches:
        s1, m = single(s1, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(m["loss"])
    xs = torch.from_numpy(np.stack([b[0] for b in batches]))
    ys = torch.from_numpy(np.stack([b[1] for b in batches]))
    s2, m2 = loop.make_train_step_multi(pp, opt)(s2, xs, ys)
    torch.testing.assert_close(m2["loss"], torch.stack(losses), rtol=0, atol=0)
    assert torch.isfinite(m2["grad_norm"]).all()
    for k in s1.params:
        torch.testing.assert_close(s1.params[k], s2.params[k], rtol=0, atol=0)
        torch.testing.assert_close(s1.opt_state.accu[k], s2.opt_state.accu[k], rtol=0, atol=0)
    assert s1.step == s2.step == 3


@pytest.fixture(scope="module")
def port_features(tmp_path_factory):
    """3 tracks of 2 s (2 stems) in the trackdirs layout, through the
    port's compute_features, and a validation track."""
    root = tmp_path_factory.mktemp("ft")
    pp = port(PRESETS["ikala_tiny"]())
    for split, seeds in (("train", (0, 1, 2)), ("val", (9,))):
        for i in seeds:
            d = root / "audio" / split / f"t{i}"
            d.mkdir(parents=True)
            stems, _ = synth.sine_mixture(2, 2 * FS, fs=FS, seed=i)
            for s, name in enumerate(pp.sources):
                io.write_wav(d / f"{name}.wav", FS, stems[s])
        compute_features(str(root / "audio" / split), str(root / split), pp, device="cpu")
    return str(root)


def _dataset(root, split, pp):
    tr = pp.train
    return SegmentDataset(f"{root}/{split}", pp.sources, time_context=tr.time_context,
                          overlap=tr.overlap, mult_factor_in=tr.mult_factor_in,
                          mult_factor_out=tr.mult_factor_out)


def test_trainer_fits_port_features(port_features, tmp_path):
    pp = port(_with(PRESETS["ikala_tiny"](num_epochs=4, log_every_steps=1)))
    ds, val = _dataset(port_features, "train", pp), _dataset(port_features, "val", pp)
    assert len(ds) >= 3 * pp.train.batch_size
    wd = tmp_path / "run"
    trainer = loop.Trainer(pp, workdir=str(wd), device="cpu")
    losses = trainer.fit(ds, val_dataset=val)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    recs = [json.loads(line) for line in (wd / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "grad_norm" in r]
    assert steps and all(r["step_time_ms"] > 0 and r["rtf_train"] > 0 for r in steps)
    vals = [r["val_loss"] for r in recs if "val_loss" in r]
    assert len(vals) == 4 and np.isfinite(vals).all()
    v = trainer.evaluate(val, max_batches=2)
    assert np.isfinite(v)
    # evaluate is the eval step's mean over the unshuffled batches
    ev = loop.make_eval_step(pp)
    want = np.mean([float(ev(trainer.state.params, torch.from_numpy(x), torch.from_numpy(y)))
                    for x, y in list(val.batches(pp.train.batch_size, shuffle=False))[:2]])
    np.testing.assert_allclose(v, want, rtol=1e-6)


def test_trainer_fits_leave_no_prefetch_thread(port_features):
    """``fit(max_steps=)`` stops inside an epoch: the prefetch generator is
    closed and its producer ends, so repeated fits do not pile up threads."""
    import threading

    pp = port(_with(PRESETS["ikala_tiny"](num_epochs=4, log_every_steps=1)))
    ds = _dataset(port_features, "train", pp)
    trainer = loop.Trainer(pp, device="cpu")
    for stop in (1, 2, 3):
        trainer.fit(ds, max_steps=stop)
        assert int(trainer.state.step) == stop
        assert not [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_feature_training_never_imports_jax(tmp_path):
    """compute_features, SegmentDataset, a checkpointed feature-file fit
    and its restore leave jax, flax and the JAX package out of
    sys.modules."""
    script = textwrap.dedent(
        f"""
        import dataclasses, os, sys
        import numpy as np
        from convsep_tpu_torch.configs import TransformConfig, get_preset
        from convsep_tpu_torch.data import io, synth
        from convsep_tpu_torch.data.features import compute_features
        from convsep_tpu_torch.data.pipeline import SegmentDataset
        from convsep_tpu_torch.train.loop import Trainer

        p = get_preset("ikala")
        t = TransformConfig(fs=8000, frame_size=256, hop_size=128)
        m = dataclasses.replace(p.model, time_context=10, feat_size=t.bins, conv1_freq=8,
                                conv1_filters=4, conv2_filters=4, bottleneck=16)
        p = dataclasses.replace(p, transform=t, model=m, train=dataclasses.replace(
            p.train, optimizer_impl="fused", batch_size=4, time_context=10, overlap=5))
        root = {str(tmp_path)!r}
        d = os.path.join(root, "audio", "t0")
        os.makedirs(d)
        stems, _ = synth.sine_mixture(2, 8000, fs=8000)
        for s, name in enumerate(p.sources):
            io.write_wav(os.path.join(d, name + ".wav"), 8000, stems[s])
        compute_features(os.path.join(root, "audio"), os.path.join(root, "f"), p, device="cpu")
        ds = SegmentDataset(os.path.join(root, "f"), p.sources, time_context=10, overlap=5)
        tr = Trainer(p, workdir=os.path.join(root, "run"), device="cpu")
        tr.fit(ds, max_steps=2)
        assert Trainer(p, workdir=os.path.join(root, "run"), device="cpu").restore() == 2
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "convsep_tpu")]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
