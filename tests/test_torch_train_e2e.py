"""The from-audio training slice, port against reference, on CPU: the loss
and every gradient leaf of ``make_audio_loss_fn`` with ``fft_impl="pallas"``
(JAX in Pallas interpret mode), a 3-step ``make_audio_train_step``
trajectory with ``optimizer_impl="fused"`` from a bridged train state, the
data layer, and ``Trainer(from_audio=True)``.

Tolerances: loss within 1e-5 relative; every gradient leaf within 1e-5 ×
max|grad| over all leaves (float32 sums in another order); the
trajectory's step by step as its test says.

The gradient comparison runs with ``wiener_eps = 1e-2`` in both packages.
With the presets' 1e-8, a bin where one source's output is ~1e-9 in one
package and exactly 0 in the other (ReLU of f32 sums taken in another
order) has a mask derivative of up to 1e8 × |X|: there the gradient
measures rounding, not the port. Against a float64 run of the port, the
JAX package's own float32 gradients are off by up to 2e-5 of their max
at 1e-8, and by up to 0.1 of it at other seeds."""

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

from convsep_tpu.data import sine_mixture as jax_sine_mixture
from convsep_tpu.data.audio_dataset import AudioSegmentDataset as JaxAudioSegmentDataset
from convsep_tpu.train import e2e as jax_e2e
from convsep_tpu.train import loop as jax_loop
from convsep_tpu_torch.ckpt import from_jax_params, opt_state_from_jax
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples
from convsep_tpu_torch.data.io import read_wav, write_wav
from convsep_tpu_torch.data.pipeline import prefetch_to_device
from convsep_tpu_torch.data.synth import sine_mixture
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.train import e2e, loop
from tests.test_torch_train_model import PRESETS, port, tiny_dsd_preset
from tests.torch_ranks import one_rank_mesh

FS = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with(jp, fft_impl="pallas", optimizer_impl="fused", **train_kw):
    return dataclasses.replace(
        jp,
        transform=dataclasses.replace(jp.transform, fft_impl=fft_impl),
        train=dataclasses.replace(jp.train, optimizer_impl=optimizer_impl, **train_kw),
    )


def _batch(rng, jp, B):
    seg = segment_samples(port(jp))
    stems = (0.1 * rng.standard_normal((B, jp.model.num_sources, seg))).astype(np.float32)
    return stems.sum(axis=1), stems


def _bridged_params(jax_params, cfg):
    return {k: v.requires_grad_() for k, v in from_jax_params(jax_params, cfg).items()}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_audio_loss_and_grads_match_jax(rng, name):
    jp = _with(PRESETS[name]())
    state, _ = jax_loop.create_train_state(jp, 0)
    mix, stems = _batch(rng, jp, 3)
    args = (torch.from_numpy(mix), torch.from_numpy(stems))
    cfg = trainable_config(port(jp).model)
    loss = e2e.make_audio_loss_fn(port(jp))(_bridged_params(state.params, cfg), *args)
    j_loss = jax_e2e.make_audio_loss_fn(jp)(state.params, jnp.asarray(mix), jnp.asarray(stems))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    jp = dataclasses.replace(jp, sep=dataclasses.replace(jp.sep, wiener_eps=1e-2))
    j_loss, j_grads = jax.value_and_grad(jax_e2e.make_audio_loss_fn(jp))(
        state.params, jnp.asarray(mix), jnp.asarray(stems))
    params = _bridged_params(state.params, cfg)
    loss = e2e.make_audio_loss_fn(port(jp))(params, *args)
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    want = from_jax_params(j_grads, cfg)
    assert set(want) == set(grads)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, g in grads.items():
        # every leaf, the tied conv kernels included, gets a gradient
        assert float(g.abs().max()) > 1e-3 * scale, k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_fused_trajectory_matches_jax(rng, name):
    """One JAX step makes the adadelta state nontrivial; the state is
    bridged and both packages take 3 more steps on the same batches, each
    on its own state. Every step's loss and the first bridged step's grad
    norm within 1e-4 relative (the reference's own float32 grad norm errs
    by up to 2.6e-5 relative against its float64 evaluation at these
    sizes, so two float32 evaluations may part by twice that).

    The parameters are held step by step: before each step the port's
    state is also bridged afresh from the JAX state, and that one port
    step must land within 1e-6 of the JAX step, or within ten times the
    witness where that is larger. The witness is the reference's own step
    from the same state on its matmul STFT route: the same step summed in
    another order, whose gap grows with the step (1.7e-7, 6.7e-8, 3.8e-6
    at dsd100_tiny; ``tests/parity_witness.py``). The port's step differs from the reference's in the
    order of every product, not the STFT's alone; its gap reached 4.5
    times the witness's over default, AVX2 and MKL_CBWR=COMPATIBLE
    settings at 1 and 6 threads. An update moves a weight by up to ~6e-3.
    The two free
    runs' final parameters are not compared: they part chaotically (f32
    noise flips ReLU gates and moves outputs near 0, where the Wiener
    ratio's derivative is ~1/eps), by up to 3e-2 of the three steps'
    movement at this seed and up to 0.38 of it at others, about half of
    what a run that skipped two updates would read."""
    jp = _with(PRESETS[name]())
    pp = port(jp)
    cfg = trainable_config(pp.model)
    jstate, jopt = jax_loop.create_train_state(jp, 1)
    jstep = jax_e2e.make_audio_train_step(jp, jopt)
    witness_step = jax_e2e.make_audio_train_step(_with(PRESETS[name](), fft_impl="matmul"), jopt)
    batches = [_batch(rng, jp, 4) for _ in range(4)]
    jstate, _ = jstep(jstate, *map(jnp.asarray, batches[0]))

    def bridged(js):
        s, opt = loop.create_train_state(pp, params=from_jax_params(js.params, cfg),
                                         device="cpu")
        return loop.TrainState(step=int(js.step), params=s.params,
                               opt_state=opt_state_from_jax(js.opt_state, cfg)), opt

    tstate, topt = bridged(jstate)
    tstep = e2e.make_audio_train_step(pp, topt)
    for i, (mix, stems) in enumerate(batches[1:]):
        args = torch.from_numpy(mix), torch.from_numpy(stems)
        fstate, fm = tstep(bridged(jstate)[0], *args)
        wstate, _ = witness_step(jax.tree.map(jnp.copy, jstate), jnp.asarray(mix),
                                 jnp.asarray(stems))
        jstate, jm = jstep(jstate, jnp.asarray(mix), jnp.asarray(stems))
        tstate, tm = tstep(tstate, *args)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        if i == 0:
            np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-4)
        want = from_jax_params(jstate.params, cfg)
        witness = from_jax_params(wstate.params, cfg)
        atol = max(1e-6, 10 * max(float((witness[k] - w).abs().max()) for k, w in want.items()))
        for k, p in fstate.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), atol=atol,
                                       rtol=0, err_msg=f"step {i}: {k}")
    assert tstate.step == fstate.step == int(jstate.step) == 4


def test_multi_step_equals_single_steps(rng):
    pp = port(_with(tiny_dsd_preset()))
    batches = [_batch(rng, tiny_dsd_preset(), 4) for _ in range(2)]
    s1, opt = loop.create_train_state(pp, 5, "cpu")
    s2, _ = loop.create_train_state(pp, 5, "cpu")
    single = e2e.make_audio_train_step(pp, opt)
    losses = []
    for mix, stems in batches:
        s1, m = single(s1, torch.from_numpy(mix), torch.from_numpy(stems))
        losses.append(m["loss"])
    xs = torch.from_numpy(np.stack([b[0] for b in batches]))
    ys = torch.from_numpy(np.stack([b[1] for b in batches]))
    s2, m2 = e2e.make_audio_train_step_multi(pp, opt)(s2, xs, ys)
    torch.testing.assert_close(m2["loss"], torch.stack(losses), rtol=0, atol=0)
    for k in s1.params:
        torch.testing.assert_close(s1.params[k], s2.params[k], rtol=0, atol=0)
    assert s1.step == s2.step == 2
    with pytest.raises(ValueError, match="segment length"):
        single(s1, torch.zeros(2, 100), torch.zeros(2, 4, 100))


@pytest.fixture(scope="module")
def audio_root(tmp_path_factory):
    """3 tracks of 4 synthetic stems, 3 s at 8 kHz, written by the port."""
    root = tmp_path_factory.mktemp("audio")
    names = tiny_dsd_preset().sources
    for i in range(3):
        d = root / f"t{i}"
        d.mkdir()
        stems, _ = sine_mixture(4, 3 * FS, fs=FS, seed=i)
        for s, name in enumerate(names):
            write_wav(d / f"{name}.wav", FS, stems[s])
    return str(root)


def test_data_layer_matches_jax(audio_root):
    stems, mix = sine_mixture(4, 5000, fs=FS, seed=7)
    j_stems, j_mix = jax_sine_mixture(4, 5000, fs=FS, seed=7)
    np.testing.assert_array_equal(stems, j_stems)
    np.testing.assert_array_equal(mix, j_mix)
    fs, a = read_wav(os.path.join(audio_root, "t0", "vocals.wav"))
    assert fs == FS and a.dtype == np.float32 and a.shape == (3 * FS,)
    jp = tiny_dsd_preset()
    seg = segment_samples(port(jp))
    assert seg == (10 - 2) * 128
    ds = AudioSegmentDataset(audio_root, jp.sources, seg, overlap_samples=seg // 2, fs=FS)
    jds = JaxAudioSegmentDataset(audio_root, jp.sources, seg, overlap_samples=seg // 2, fs=FS)
    assert len(ds) == len(jds) > 4
    for (x, y), (jx, jy) in zip(ds.batches(4, seed=3), jds.batches(4, seed=3)):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    # stereo segments of mono stems: centre-panned, as the reference's
    st = AudioSegmentDataset(audio_root, jp.sources, seg, fs=FS, stereo=True)
    jst = JaxAudioSegmentDataset(audio_root, jp.sources, seg, fs=FS, stereo=True)
    (x, y), (jx, jy) = next(st.batches(4, seed=3)), next(jst.batches(4, seed=3))
    assert x.shape == (4, 2, seg) and y.shape == (4, 4, 2, seg)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(x[:, 0], x[:, 1])
    out = list(prefetch_to_device([("single", (np.ones(3), np.zeros(2)), None)] * 3, "cpu"))
    assert len(out) == 3 and isinstance(out[0][1][0], torch.Tensor) and out[0][2] is None


def test_trainer_fit_logs_and_evaluates(audio_root, tmp_path):
    pp = port(_with(tiny_dsd_preset(), log_every_steps=1, steps_per_dispatch=2))
    ds = AudioSegmentDataset(audio_root, pp.sources, segment_samples(pp), fs=FS)
    trainer = loop.Trainer(pp, from_audio=True, device="cpu")
    metrics = tmp_path / "m.jsonl"
    epoch_losses = trainer.fit(ds, num_epochs=2, metrics_path=str(metrics), val_dataset=ds)
    assert len(epoch_losses) == 2 and np.isfinite(epoch_losses).all()
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    assert steps and all(r["step_time_ms"] > 0 and r["rtf_train"] > 0 for r in steps)
    assert [r["epoch"] for r in recs if "epoch_loss" in r] == [0, 1]
    assert all(np.isfinite(r["val_loss"]) for r in recs if "epoch_loss" in r)
    n = trainer.state.step
    assert trainer.fit(ds, max_steps=n + 4) == [] and trainer.state.step == n + 4
    assert np.isfinite(trainer.evaluate(ds, max_batches=2))


def test_trainer_debug_nans_raises(audio_root):
    pp = port(_with(tiny_dsd_preset(debug_nans=True)))
    trainer = loop.Trainer(pp, from_audio=True, device="cpu")
    with torch.no_grad():  # inf outputs make the Wiener ratio inf / inf
        trainer.state.params["out_bias"].fill_(float("inf"))
    ds = AudioSegmentDataset(audio_root, pp.sources, segment_samples(pp), fs=FS)
    with pytest.raises(FloatingPointError, match="step 1"):
        trainer.fit(ds, max_steps=3)


def test_trainer_refuses_what_is_not_ported(audio_root, tmp_path):
    """What was refused before and is ported now. A mesh of one rank
    trains as one process does, bit for bit, on the same fused update
    (each rank's leaves are whole: the kernel updates them after the
    all-reduce); ``use_grain`` feeds grain's order and
    keeps grain's state in the data position (``tests/test_torch_grain.py``
    holds both to grain); tensorboard, stereo and multires losses
    (``tests/test_torch_train_stereo.py`` holds them to JAX)."""
    pp = port(_with(tiny_dsd_preset()))
    ds = AudioSegmentDataset(audio_root, pp.sources, segment_samples(pp), fs=FS)
    alone = loop.Trainer(pp, from_audio=True, device="cpu")
    alone.fit(ds, max_steps=2)
    with one_rank_mesh(str(tmp_path / "store")) as mesh:
        meshed = loop.Trainer(pp, from_audio=True, mesh=mesh)
        assert meshed.preset.train.optimizer_impl == "fused"
        meshed.fit(ds, max_steps=2)
    for k, p in alone.state.params.items():
        torch.testing.assert_close(meshed.state.params[k], p, rtol=0, atol=0)
    trainer = loop.Trainer(pp, from_audio=True, device="cpu")
    trainer.fit(ds, use_grain=True, max_steps=2)
    pos = trainer.data_position
    assert pos["batch_in_epoch"] == 2 and json.loads(pos["grain"])["version"] == 2
    logger = loop.MetricsLogger(tensorboard_dir=str(tmp_path / "tb"))
    logger.log(step=3, loss=0.5)
    logger.close()
    assert [f for f in os.listdir(tmp_path / "tb") if ".tfevents." in f]
    stereo = dataclasses.replace(pp, model=dataclasses.replace(pp.model, channels_in=2,
                                                               decoder_reduce="all"))
    assert e2e.make_audio_loss_fn(stereo).__name__ == "stereo_loss_fn"
    multires = dataclasses.replace(pp, transform=dataclasses.replace(pp.transform,
                                                                     multires=(64, 128)))
    assert callable(e2e.make_audio_loss_fn(multires))


def test_training_never_imports_jax():
    """A from-audio training step through the kernel routes' wrappers, a
    stereo and a multires step, bf16 optimizer state, a K-step dispatch, a
    Trainer fit with tensorboard and asynchronous checkpoints, and every
    optimizer of the registry leave jax, flax, the JAX package, tensorflow
    and tensorboard out of sys.modules."""
    script = textwrap.dedent(
        """
        import dataclasses, os, sys, tempfile
        import numpy as np, torch
        from convsep_tpu_torch.configs import TransformConfig, get_preset
        from convsep_tpu_torch.configs.presets import stereo_preset
        from convsep_tpu_torch.train.e2e import (make_audio_train_step,
                                                 make_audio_train_step_multi)
        from convsep_tpu_torch.train.loop import MetricsLogger, create_train_state
        from convsep_tpu_torch.train.optim import make_optimizer
        from convsep_tpu_torch.ckpt import CheckpointManager

        p = get_preset("dsd100")
        t = TransformConfig(fs=8000, frame_size=256, hop_size=128, fft_impl="pallas")
        m = dataclasses.replace(p.model, time_context=10, feat_size=t.bins, conv1_freq=8,
                                conv1_filters=4, conv2_filters=4, bottleneck=16)
        p = dataclasses.replace(p, transform=t, model=m,
                                train=dataclasses.replace(p.train, optimizer_impl="fused"))
        state, opt = create_train_state(p, 0, "cpu")
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4, 1024))
                             .astype(np.float32))
        state, m = make_audio_train_step(p, opt)(state, x.sum(1), x)
        assert np.isfinite(float(m["loss"])) and state.step == 1
        # K steps a dispatch
        state, m = make_audio_train_step_multi(p, opt)(state, x.sum(1)[None].repeat(2, 1, 1),
                                                       x[None].repeat(2, 1, 1, 1))
        assert state.step == 3 and m["loss"].shape == (2,)
        # stereo: (B, 2, seg) mixtures
        st = stereo_preset(p)
        s2, o2 = create_train_state(st, 0, "cpu")
        xs = x[:, :, None].repeat(1, 1, 2, 1)
        s2, m = make_audio_train_step(st, o2)(s2, xs.sum(1), xs)
        assert np.isfinite(float(m["loss"]))
        # multires channels in the step, bf16 adadelta state on the plain update
        mr = dataclasses.replace(
            p, transform=dataclasses.replace(t, multires=(64, 128)),
            model=dataclasses.replace(p.model, channels_in=3),
            train=dataclasses.replace(p.train, optimizer_impl="xla",
                                      optimizer_state_dtype="bfloat16"))
        s3, o3 = create_train_state(mr, 0, "cpu")
        s3, m = make_audio_train_step(mr, o3)(s3, x.sum(1), x)
        assert np.isfinite(float(m["loss"]))
        assert s3.opt_state.accu["fc_bias"].dtype == torch.bfloat16
        for name in ("adam", "adamw", "sgd", "rmsprop"):
            o = make_optimizer(name, learning_rate=0.1)
            o.update(dict(state.params), o.init(state.params), state.params)
        with tempfile.TemporaryDirectory() as d:
            log = MetricsLogger(None, tensorboard_dir=os.path.join(d, "tb"))
            log.log(step=1, loss=0.5)
            log.close()
            ck = CheckpointManager(os.path.join(d, "ck"))
            assert ck.save(3, state) and ck.wait() and ck.all_steps() == [3]
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "convsep_tpu",
                                      "tensorflow", "tensorboard")]
        assert not bad, bad
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
