"""``steps_per_dispatch``, port against reference, on CPU: the port's
``Trainer`` and the JAX package's, both with K = 3, from one bridged
initial state on the same batches, on feature files and from audio. An
epoch of 7 batches gives two groups of 3 (the multi step) and a tail of
one (a single step).

Held exactly: the batches of every dispatch, the checkpoint steps and the
data position saved with each (``step // every > prev_step // every`` at
dispatch boundaries), the logged steps (each the previous dispatch's last
step), the multi step used twice and the single step once. Held in
numbers: the first step's loss and grad norm within ``TOL_FIRST_STEP``
(1e-4) relative, set from a witness: the reference's own float32 grad norm
against the same function in float64 (``compute_dtype="float64"`` under
``jax.enable_x64``) errs by 5.5e-7 to 2.6e-5 relative at this size
(``tests/parity_witness.py``), so two float32 evaluations may part
by twice that. Each of the 7 steps, taken by the port from the
reference's state before it (bridged) on the batch the Trainers fed,
within 1e-5 of the largest parameter magnitude of the reference's step (a
bias that one update moved by 4e-3 differs by 1.4e-7: float32 gradients
summed in another order pass through adadelta's slope-1 start unchanged),
or on feature files within five times the reference's own float32 error on
that step against its float64 evaluation where that is larger (the first
feature step's reads 3.8e-6 of the peak, the port's gap 1.2e-5 of it under
MKL_CBWR=COMPATIBLE, whose products stray further from float64 than by
default). And the port's K = 3 run equal
bit for bit to its K = 1 run (the same operations in the same order).

The two packages' free runs are not compared past the first step: from
one state they part chaotically (float32 sums in another order flip ReLU
units, whose gradients then differ entirely). Measured at these sizes:
within one dispatch of 3 steps from a bridged state the parameters part
by up to 0.14 of a leaf's largest magnitude at ``wiener_eps`` 1e-8 and
1e-2 alike, the third step's grad norm by 1e-3, and after the 7 steps by
up to 0.27. On CPU the multi step is K eager steps; the CUDA graph is held
to eager steps in ``tests/test_torch_cuda.py``."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.data.audio_dataset import AudioSegmentDataset as JaxAudioSegmentDataset
from convsep_tpu.data.pipeline import SegmentDataset as JaxSegmentDataset
from convsep_tpu.train import e2e as jax_e2e
from convsep_tpu.train import loop as jax_loop
from convsep_tpu_torch.ckpt import from_jax_params, opt_state_from_jax
from convsep_tpu_torch.data import io, synth
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples
from convsep_tpu_torch.data.pipeline import SegmentDataset
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.train import e2e, loop
from tests.test_torch_chunked import one_intraop_thread  # noqa: F401
from tests.test_torch_train_model import PRESETS, port, tiny_dsd_preset

FS = 8000
K = 3
BATCHES = 7
TOL_FIRST_STEP = 1e-4


def _batch_size(n: int) -> int:
    """A batch size giving exactly BATCHES batches of ``n`` segments."""
    return next(b for b in range(1, n + 1) if n // b == BATCHES)


def _preset(jp, batch_size: int):
    return dataclasses.replace(
        jp, sep=dataclasses.replace(jp.sep, wiener_eps=1e-2),
        train=dataclasses.replace(jp.train, steps_per_dispatch=K, batch_size=batch_size,
                                  log_every_steps=1, checkpoint_every_steps=2, num_epochs=1))


def _record_saves(trainer) -> list:
    seen = []
    orig = trainer._save

    def save(step):
        seen.append((int(step), dict(trainer._data_pos)))
        return orig(step)

    trainer._save = save
    return seen


def _record_dispatches(trainer, snapshot) -> list:
    """Wrap the trainer's single and multi steps: each call records
    (kind, the batch as numpy, ``snapshot(state)`` before it, metrics)."""
    seen = []
    single, build = trainer.train_step, trainer._train_step_multi_builder

    def wrap(kind, fn):
        def call(state, x, y):
            pre = snapshot(state)
            state, m = fn(state, x, y)
            seen.append((kind, np.array(x), np.array(y), pre, m))
            return state, m

        return call

    trainer.train_step = wrap("single", single)
    trainer._train_step_multi_builder = lambda: wrap("multi", build())
    return seen


def _float64_step(jp, opt):
    """The reference's feature step evaluated in float64
    (``compute_dtype="float64"`` under ``jax.enable_x64``):
    ``(state, x, y) → params`` as float64 numpy."""
    p64 = dataclasses.replace(jp, model=dataclasses.replace(jp.model, compute_dtype="float64"))
    with jax.enable_x64(True):
        step = jax_loop.make_train_step(p64, opt)

    def run(state, x, y):
        with jax.enable_x64(True):
            wide = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), state)
            new, _ = step(wide, jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64))
            return jax.tree.map(lambda a: np.asarray(a, np.float64), new.params)

    return run


def _logged(path) -> list[int]:
    return [json.loads(line)["step"] for line in open(path) if '"loss"' in line]


def _run_both(jp, jds, pds, tmp_path, from_audio: bool):
    jt = jax_loop.Trainer(jp, workdir=str(tmp_path / "jax"), from_audio=from_audio)
    pp = port(jp)
    cfg = trainable_config(pp.model)
    init = from_jax_params(jt.state.params, cfg)

    def port_trainer(name, k):
        p = dataclasses.replace(pp, train=dataclasses.replace(pp.train, steps_per_dispatch=k))
        t = loop.Trainer(p, workdir=str(tmp_path / name), from_audio=from_audio, device="cpu")
        with torch.no_grad():
            for key, v in init.items():
                t.state.params[key].copy_(v)
        return t

    pt = port_trainer("port", K)
    j_saves, p_saves = _record_saves(jt), _record_saves(pt)
    j_seen = _record_dispatches(jt, lambda st: jax.tree.map(np.array, st))
    p_seen = _record_dispatches(pt, lambda st: None)
    jt.fit(jds)
    pt.fit(pds)
    assert [k for k, *_ in p_seen] == [k for k, *_ in j_seen] == ["multi", "multi", "single"]
    for (_, px, py, *_), (_, jx, jy, *_) in zip(p_seen, j_seen):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
    assert int(jt.state.step) == pt.state.step == BATCHES
    assert p_saves == j_saves
    assert [s for s, _ in p_saves] == [3, 6, 7]
    assert p_saves[0][1] == {"epoch": 0, "batch_in_epoch": 3, "grain": None}
    assert pt._ckpt.all_steps() == [3, 6, 7]
    assert _logged(tmp_path / "port" / "metrics.jsonl") == _logged(
        tmp_path / "jax" / "metrics.jsonl") == [3, 6]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(p_seen[0][4][key][0]), float(j_seen[0][4][key][0]),
                                   rtol=TOL_FIRST_STEP)
    # the same math as K single steps: the port's K = 1 run, bit for bit
    single = port_trainer("port1", 1)
    single.fit(pds)
    for key, p in pt.state.params.items():
        torch.testing.assert_close(p, single.state.params[key], rtol=0, atol=0)
    # every step, from the reference's state before it
    make = jax_e2e.make_audio_train_step if from_audio else jax_loop.make_train_step
    j_step = make(jp, jt.opt)
    witness = None if from_audio else _float64_step(jp, jt.opt)
    p_step = (e2e.make_audio_train_step if from_audio else loop.make_train_step)(pp, pt.opt)
    checked = 0
    for kind, xs, ys, pre, _ in j_seen:
        js = jax.tree.map(jnp.asarray, pre)
        for x, y in (zip(xs, ys) if kind == "multi" else [(xs, ys)]):
            ps, _ = loop.create_train_state(pp, 0, "cpu", params=from_jax_params(js.params, cfg))
            ps.opt_state = opt_state_from_jax(js.opt_state, cfg)
            ps, _ = p_step(ps, torch.from_numpy(x), torch.from_numpy(y))
            truth = None if witness is None else witness(js, x, y)
            js, _ = j_step(js, jnp.asarray(x), jnp.asarray(y))
            want = from_jax_params(js.params, cfg)
            scale = max(float(w.abs().max()) for w in want.values())
            atol = 1e-5 * scale
            if truth is not None:
                truth = from_jax_params(truth, cfg)
                atol = max(atol, 5 * max(float((truth[k] - w.double()).abs().max())
                                         for k, w in want.items()))
            for key, p in ps.params.items():
                np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(), rtol=0,
                                           atol=atol, err_msg=f"step {checked + 1}: {key}")
            checked += 1
    assert checked == BATCHES


def test_k_steps_match_the_reference_on_features(tmp_path):
    jp0 = PRESETS["ikala_tiny"]()
    d = str(tmp_path / "feats")
    synth.synth_feature_dir(d, jp0.sources, num_tracks=3, seconds=2.0, fs=FS, frame_size=256,
                            hop_size=128, device="cpu")
    tr = jp0.train
    kw = dict(time_context=tr.time_context, overlap=tr.overlap,
              mult_factor_in=tr.mult_factor_in, mult_factor_out=tr.mult_factor_out)
    pds = SegmentDataset(d, jp0.sources, **kw)
    jds = JaxSegmentDataset(d, jp0.sources, **kw)
    assert len(pds) == len(jds)
    jp = _preset(jp0, _batch_size(len(pds)))
    _run_both(jp, jds, pds, tmp_path, from_audio=False)


def test_k_steps_match_the_reference_from_audio(tmp_path):
    jp0 = tiny_dsd_preset()
    root = tmp_path / "audio"
    for i in range(3):
        (root / f"t{i}").mkdir(parents=True)
        stems, _ = synth.sine_mixture(4, 2 * FS, fs=FS, seed=20 + i)
        for s, name in enumerate(jp0.sources):
            io.write_wav(root / f"t{i}" / f"{name}.wav", FS, stems[s])
    seg = segment_samples(port(jp0))
    pds = AudioSegmentDataset(str(root), jp0.sources, seg, overlap_samples=seg // 2, fs=FS)
    jds = JaxAudioSegmentDataset(str(root), jp0.sources, seg, overlap_samples=seg // 2, fs=FS)
    assert len(pds) == len(jds)
    jp = _preset(jp0, _batch_size(len(pds)))
    _run_both(jp, jds, pds, tmp_path, from_audio=True)


def test_debug_nans_names_the_step_inside_a_group(tmp_path):
    """A non-finite loss at the second step of a group names that step."""
    jp = _preset(PRESETS["ikala_tiny"](debug_nans=True), 2)
    pp = port(jp)
    trainer = loop.Trainer(pp, device="cpu")
    xs = np.abs(np.random.default_rng(0).standard_normal(
        (8, pp.model.time_context, pp.model.feat_size, 1))).astype(np.float32)
    ys = np.abs(np.random.default_rng(1).standard_normal(
        (8, pp.model.num_sources, pp.model.time_context, pp.model.feat_size))).astype(np.float32)
    xs[2:4] = np.nan  # the second batch of the first group

    class Batches:
        def batches(self, batch_size, shuffle=True, seed=0, start=0):
            for b in range(start, 4):
                yield xs[2 * b: 2 * b + 2], ys[2 * b: 2 * b + 2]

    with pytest.raises(FloatingPointError, match="step 2"):
        trainer.fit(Batches(), max_steps=4)
