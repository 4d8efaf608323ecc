"""Checkpoints, on CPU: the port's ``CheckpointManager`` (atomic saves,
``max_to_keep``, the metadata, refusing a prepared state), the
``Trainer``'s saves, ``restore`` and mid-epoch resume on the feature and
from-audio paths (mirroring ``tests/test_train.py``), and the reference
checkpoint converter held against ``convsep_tpu.ckpt.convert_reference``
(mirroring ``tests/test_convert.py``).

Tolerances: restored states, converted parameters and the batches a
resumed run sees bit for bit; the resumed run's final parameters within
1e-5 of the uninterrupted run's (``tests/test_train.py``'s bound); the
converted model against the Theano-semantics oracle 2e-4
(``tests/test_convert.py``'s)."""

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import pytest
import torch

from convsep_tpu.ckpt import convert_reference as jax_convert
from convsep_tpu_torch.ckpt import CheckpointManager, from_jax_params
from convsep_tpu_torch.ckpt import convert_reference as convert
from convsep_tpu_torch.data import io, synth
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples
from convsep_tpu_torch.data.pipeline import SegmentDataset
from convsep_tpu_torch.models import ConvSep
from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.train import loop
from tests.oracle_reference_net import reference_forward_np
from tests.test_convert import CFG as JAX_CFG
from tests.test_convert import _random_reference_values, _repack
from tests.test_torch_chunked import one_intraop_thread  # noqa: F401
from tests.test_torch_train_model import PRESETS, port

FS = 8000
SOURCES = ("vocals", "accompaniment")


def tiny(**train_kw):
    """tests/test_train.py::tiny_train_preset on the port, fused adadelta."""
    jp = PRESETS["ikala_tiny"]()
    kw = dict(batch_size=8, time_context=10, overlap=5, checkpoint_every_steps=5,
              optimizer_impl="fused")
    kw.update(train_kw)
    return port(dataclasses.replace(jp, train=dataclasses.replace(jp.train, **kw)))


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("feats"))
    synth.synth_feature_dir(d, SOURCES, num_tracks=3, seconds=2.0, fs=FS, frame_size=256,
                            hop_size=128, device="cpu")
    return d


@pytest.fixture(scope="module")
def audio_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    for i in range(3):
        d = root / f"t{i}"
        d.mkdir()
        stems, _ = synth.sine_mixture(2, 2 * FS, fs=FS, seed=i)
        for s, name in enumerate(SOURCES):
            io.write_wav(d / f"{name}.wav", FS, stems[s])
    return str(root)


def _dataset(feature_dir, pp):
    return SegmentDataset(feature_dir, SOURCES, time_context=pp.train.time_context,
                          overlap=pp.train.overlap)


def _record_batches(trainer):
    """Wrap the trainer's step to record a digest of every batch it takes."""
    seen = []
    orig = trainer.train_step

    def wrapped(state, x, y):
        seen.append(hashlib.sha1(x.numpy().tobytes() + y.numpy().tobytes()).hexdigest())
        return orig(state, x, y)

    trainer.train_step = wrapped
    return seen


def _assert_states_equal(a, b):
    assert a.step == b.step
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)
        assert b.params[k].requires_grad and b.params[k].is_leaf
        torch.testing.assert_close(a.opt_state.accu[k], b.opt_state.accu[k], rtol=0, atol=0)
        torch.testing.assert_close(a.opt_state.delta_accu[k], b.opt_state.delta_accu[k],
                                   rtol=0, atol=0)


# -- the manager -----------------------------------------------------------

def test_manager_round_trip_keep_and_skip(tmp_path):
    pp = tiny()
    state, opt = loop.create_train_state(pp, 3, "cpu")
    with torch.no_grad():
        for k in state.params:
            state.opt_state.accu[k].uniform_(0, 1)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(state) is None
    for step in (1, 2, 3):
        state.step = step
        assert mgr.save(step, state, extra={"epoch": 0, "batch_in_epoch": step})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert not mgr.save(3, state) and not mgr.save(2, state)  # an existing or older step
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]  # no temporary left behind
    fresh, _ = loop.create_train_state(pp, 4, "cpu")
    got, meta = mgr.restore_latest(fresh)
    assert meta == {"epoch": 0, "batch_in_epoch": 3}
    _assert_states_equal(state, got)
    got2, meta2 = mgr.restore(2, fresh)
    assert got2.step == 2 and meta2["batch_in_epoch"] == 2
    assert mgr.wait() is True
    mgr.close()
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path / "x"), max_to_keep=0)


def test_manager_refuses_prepared_state(tmp_path):
    pp = port(PRESETS["ikala_tiny"]())
    state, _ = loop.create_train_state(pp, 0, "cpu")
    model = ConvSep(pp.model, {k: v.detach() for k, v in state.params.items()},
                    device="cpu").prepare_inference()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    for bad in (model, model.state_dict(), {"step": 1, "params": dict(model.state_dict())}):
        with pytest.raises(ValueError, match="inference-prepared"):
            mgr.save(1, bad)
    assert mgr.latest_step() is None
    assert mgr.save(1, {"step": 1, "params": state.params})  # the trainable dict is fine


def test_manager_restore_checks_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"step": 1, "params": {"a": torch.ones(3)}})
    with pytest.raises(KeyError, match="params/b"):
        mgr.restore_latest({"step": 0, "params": {"b": torch.zeros(3)}})
    with pytest.raises(ValueError, match="params/a"):
        mgr.restore_latest({"step": 0, "params": {"a": torch.zeros(4)}})


# -- the Trainer -----------------------------------------------------------

def test_checkpoint_resume(feature_dir, tmp_path):
    pp = tiny(num_epochs=2)
    wd = str(tmp_path / "run")
    t1 = loop.Trainer(pp, workdir=wd, device="cpu")
    t1.fit(_dataset(feature_dir, pp))
    assert t1.state.step > 0
    t2 = loop.Trainer(pp, workdir=wd, device="cpu")
    assert t2.state.step == 0
    assert t2.restore() == t1.state.step
    assert t2.data_position["epoch"] == 2 and t2.data_position["batch_in_epoch"] == 0
    _assert_states_equal(t1.state, t2.state)
    more = t2.fit(_dataset(feature_dir, pp), num_epochs=3)  # the total budget
    assert t2.state.step > t1.state.step and np.isfinite(more[0])


def test_params_only_checkpointing(feature_dir, tmp_path):
    pp = tiny(num_epochs=1, checkpoint_optimizer_state=False)
    wd = str(tmp_path / "run")
    t1 = loop.Trainer(pp, workdir=wd, device="cpu")
    t1.fit(_dataset(feature_dir, pp))
    t2 = loop.Trainer(pp, workdir=wd, device="cpu")
    assert t2.restore() == t1.state.step
    for k in t1.state.params:
        torch.testing.assert_close(t1.state.params[k], t2.state.params[k], rtol=0, atol=0)
        assert not t2.state.opt_state.accu[k].any() and not t2.state.opt_state.delta_accu[k].any()
    ck = os.path.join(wd, "checkpoints", str(t1.state.step), "state.pt")
    assert not any("accu" in k for k in torch.load(ck, weights_only=True))


def _audio_trainer_kw(audio_root):
    pp = tiny(num_epochs=2, checkpoint_every_steps=3)
    assert tuple(pp.sources) == SOURCES
    return pp, AudioSegmentDataset(audio_root, SOURCES, segment_samples(pp),
                                   overlap_samples=segment_samples(pp) // 2, fs=FS)


@pytest.mark.parametrize("from_audio", [False, True], ids=["features", "audio"])
def test_mid_epoch_resume_sees_exactly_unseen_batches(feature_dir, audio_root, tmp_path,
                                                      from_audio):
    """Stop mid-epoch 0 at step 4 (a periodic checkpoint at 3, one at
    max_steps); the resumed run trains on exactly the batches after it."""
    if from_audio:
        pp, ds = _audio_trainer_kw(audio_root)
    else:
        pp = tiny(num_epochs=2, checkpoint_every_steps=3)
        ds = _dataset(feature_dir, pp)
    assert len(ds) // pp.train.batch_size >= 5
    kw = dict(from_audio=from_audio, device="cpu")
    ref = loop.Trainer(pp, **kw)
    ref_seen = _record_batches(ref)
    ref.fit(ds)

    wd = str(tmp_path / "run")
    t1 = loop.Trainer(pp, workdir=wd, **kw)
    t1_seen = _record_batches(t1)
    t1.fit(ds, max_steps=4)
    assert len(t1_seen) == 4
    assert CheckpointManager(os.path.join(wd, "checkpoints")).all_steps() == [3, 4]

    t2 = loop.Trainer(pp, workdir=wd, **kw)
    t2_seen = _record_batches(t2)
    assert t2.restore() == 4
    assert t2.data_position == {"epoch": 0, "batch_in_epoch": 4, "grain": None}
    t2.fit(ds)
    assert t1_seen + t2_seen == ref_seen
    for k, p in ref.state.params.items():
        np.testing.assert_allclose(t2.state.params[k].detach().numpy(),
                                   p.detach().numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_resume_from_mid_epoch_checkpoint_not_max_steps(feature_dir, tmp_path):
    """Resume from a periodic (step 3) checkpoint: the replay starts at
    batch 3 although the interrupted run went on to step 4."""
    pp = tiny(num_epochs=1, checkpoint_every_steps=3)
    ds = _dataset(feature_dir, pp)
    ref = loop.Trainer(pp, device="cpu")
    ref_seen = _record_batches(ref)
    ref.fit(ds)
    wd = str(tmp_path / "run")
    t1 = loop.Trainer(pp, workdir=wd, device="cpu")
    t1.fit(ds, max_steps=3)  # stops exactly at the periodic save
    t2 = loop.Trainer(pp, workdir=wd, device="cpu")
    t2_seen = _record_batches(t2)
    assert t2.restore() == 3
    t2.fit(ds)
    assert t2_seen == ref_seen[3:]


def test_checkpoint_every_epochs_throttle(tmp_path):
    """checkpoint_every_epochs=K saves every Kth epoch and the final one."""
    pp = tiny(num_epochs=5, checkpoint_every_epochs=3, checkpoint_every_steps=10**9)
    d = tmp_path / "feats"
    synth.synth_feature_dir(str(d), SOURCES, num_tracks=1, seconds=1.5, fs=FS,
                            frame_size=256, hop_size=128, device="cpu")
    ds = SegmentDataset(str(d), SOURCES, time_context=10, overlap=5)
    wd = str(tmp_path / "run")
    tr = loop.Trainer(pp, workdir=wd, device="cpu")
    tr.fit(ds)
    steps = CheckpointManager(os.path.join(wd, "checkpoints"), max_to_keep=None).all_steps()
    per_epoch = len(ds) // pp.train.batch_size
    assert steps == [3 * per_epoch, 5 * per_epoch], steps


# -- the reference checkpoint converter --------------------------------------

# tests/test_convert.py's CFG
CFG = ConvSepConfig(time_context=12, feat_size=33, channels_in=1, num_sources=2,
                    conv1_filters=3, conv1_freq=5, conv1_freq_stride=1, conv2_filters=4,
                    conv2_time=6, bottleneck=8)


@pytest.mark.parametrize("stride", [1, 2])
def test_converted_params_equal_jax_and_the_theano_oracle(rng, stride):
    jcfg = dataclasses.replace(JAX_CFG, conv1_freq_stride=stride)
    cfg = dataclasses.replace(CFG, conv1_freq_stride=stride)
    vals = _random_reference_values(jcfg, rng)
    got = convert.convert_reference_params(vals, cfg)
    want = from_jax_params(jax_convert.convert_reference_params(vals, jcfg), cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    x = (0.5 * np.abs(rng.standard_normal((2, 1, cfg.time_context, cfg.feat_size))))
    x = x.astype(np.float32)
    oracle = reference_forward_np(vals, x.astype(np.float64), conv1_stride=stride)
    model = ConvSep(cfg, got, device="cpu").prepare_inference()
    with torch.no_grad():
        y = model.sources(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_allclose(y, oracle, atol=2e-4)


def test_export_roundtrip(rng):
    vals = _random_reference_values(JAX_CFG, rng)
    params = convert.convert_reference_params(vals, CFG)
    back = convert.export_reference_params(params, CFG)
    want = jax_convert.export_reference_params(
        jax_convert.convert_reference_params(vals, JAX_CFG), JAX_CFG)
    assert len(back) == len(vals) == len(want)
    for a, b, w in zip(vals, back, want):
        np.testing.assert_array_equal(b, w)
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("merge,interleaved,chw",
                         [(True, True, False), (False, True, False), (True, False, False),
                          (True, True, True)])
def test_detect_layout_variants(rng, merge, interleaved, chw):
    vals = _random_reference_values(JAX_CFG, rng)
    packed = _repack(vals, JAX_CFG, merge=merge, interleaved=interleaved, chw=chw)
    layout = convert.detect_layout(packed, CFG)
    jlayout = jax_convert.detect_layout(packed, JAX_CFG)
    assert dataclasses.asdict(layout) == dataclasses.asdict(jlayout)
    got = convert.convert_reference_params(packed, CFG, layout)
    want = convert.convert_reference_params(vals, CFG)
    if not merge:  # an absent merge bias is zero
        want["out_bias"] = torch.zeros_like(want["out_bias"])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    for a, b in zip(packed, convert.export_reference_params(got, CFG, layout)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_pickle_files_and_errors(tmp_path, rng):
    vals = _repack(_random_reference_values(JAX_CFG, rng), JAX_CFG, merge=False,
                   interleaved=False)
    p = tmp_path / "variant.pkl"
    with open(p, "wb") as f:
        pickle.dump(vals, f, protocol=2)  # the reference's Python 2 era pickles
    for a, b in zip(vals, convert.load_reference_pickle(str(p))):
        np.testing.assert_array_equal(a, b)
    got = convert.convert_reference_checkpoint(str(p), CFG)  # the layout detected
    want = from_jax_params(jax_convert.convert_reference_checkpoint(str(p), JAX_CFG), CFG)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="expected 11"):
        convert.convert_reference_params(_random_reference_values(JAX_CFG, rng)[:-2], CFG)
    bad = _random_reference_values(JAX_CFG, rng)
    bad[0] = bad[0][..., :-1]
    with pytest.raises(ValueError, match="no known reference layout"):
        convert.detect_layout(bad, CFG)
    with pytest.raises(NotImplementedError, match="expand_order"):
        convert.convert_reference_params(vals, dataclasses.replace(CFG, expand_order="tmajor"))


def test_restricted_unpickler_blocks_code_objects(tmp_path):
    p = tmp_path / "evil.pkl"
    with open(p, "wb") as f:
        pickle.dump([np.zeros(3), os.path.join], f)  # a function reference runs code
    with pytest.raises(pickle.UnpicklingError, match="only plain"):
        convert.load_reference_pickle(str(p))
    assert len(convert.load_reference_pickle(str(p), allow_unsafe=True)) == 2
