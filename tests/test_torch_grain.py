"""Grain-order loading, port against grain and the reference, on CPU:
``convsep_tpu_torch.data.grain_pipeline`` against grain's own C++
``index_shuffle``, its ``IndexSampler`` and ``NoSharding`` reprs, and the
reference's ``convsep_tpu.data.grain_pipeline`` loader (grain's
``DataLoader``) on the same feature files, with and without worker
processes; its iterator state (JSON, byte for byte) resumes across the two
packages; and ``Trainer.fit(use_grain=True)`` feeds the reference Trainer's
batches and data positions and resumes mid-epoch on the unseen batches.
Everything is held exactly: the port computes grain's integers."""

import dataclasses
import json

import numpy as np
import pytest
import torch

grain = pytest.importorskip("grain.python")

from grain._src.python.experimental.index_shuffle.python import (  # noqa: E402
    index_shuffle_module as grain_shuffle,
)

from convsep_tpu.data import grain_pipeline as jax_grain  # noqa: E402
from convsep_tpu.data.pipeline import SegmentDataset as JaxSegmentDataset  # noqa: E402
from convsep_tpu.train import loop as jax_loop  # noqa: E402
from convsep_tpu_torch.ckpt import from_jax_params  # noqa: E402
from convsep_tpu_torch.data import grain_pipeline, synth  # noqa: E402
from convsep_tpu_torch.data.pipeline import SegmentDataset  # noqa: E402
from convsep_tpu_torch.models.convsep import trainable_config  # noqa: E402
from convsep_tpu_torch.train import loop  # noqa: E402
from tests.test_torch_chunked import one_intraop_thread  # noqa: E402,F401
from tests.test_torch_train_model import PRESETS, port  # noqa: E402

SEEDS = [0, 1, 7, 12345, 2**31, 2**32 - 1]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 100, 1000, 2**16 - 1, 2**16, 2**16 + 1, 2**16 + 2,
                               70_001, 2**20 + 3])
def test_index_shuffle_equals_grains(n):
    """Every index below 5000 (else 3000 drawn ones) at each seed; n =
    2**16 + 1 is grain's truncated case (index 2**16 reads as 0)."""
    for seed in SEEDS:
        idx = (np.arange(n) if n < 5000 else
               np.random.default_rng(seed % 97).integers(0, n, 3000))
        want = [grain_shuffle.index_shuffle(int(i), max_index=n - 1, seed=seed, rounds=4)
                for i in idx]
        np.testing.assert_array_equal(grain_pipeline.index_shuffle(idx, n - 1, seed), want)
        assert grain_pipeline.index_shuffle(int(idx[-1]), n - 1, seed) == want[-1]


def test_index_shuffle_rounds():
    want = [grain_shuffle.index_shuffle(i, max_index=999, seed=3, rounds=8) for i in range(1000)]
    np.testing.assert_array_equal(grain_pipeline.index_shuffle(np.arange(1000), 999, 3, 8), want)
    with pytest.raises(ValueError):
        grain_pipeline.index_shuffle(0, 9, 3, rounds=3)


@pytest.mark.parametrize("shuffle,num_epochs,seed", [(True, 1, 7), (False, None, 0),
                                                     (True, 3, 2**32 - 1)])
def test_sampler_equals_grains(shuffle, num_epochs, seed):
    n = 37
    want = grain.IndexSampler(num_records=n, shard_options=grain.NoSharding(), shuffle=shuffle,
                              num_epochs=num_epochs, seed=seed)
    got = grain_pipeline.IndexSampler(n, shuffle=shuffle, num_epochs=num_epochs, seed=seed)
    assert repr(got) == repr(want)
    for i in range(3 * n):
        if num_epochs is not None and i >= len(want):
            assert not got.in_range(i)
            continue
        assert got.record_key(i) == want[i].record_key


@pytest.fixture(scope="module")
def feats(tmp_path_factory):
    jp = PRESETS["ikala_tiny"]()
    d = str(tmp_path_factory.mktemp("grain") / "feats")
    synth.synth_feature_dir(d, jp.sources, num_tracks=3, seconds=2.0, fs=8000, frame_size=256,
                            hop_size=128, device="cpu")
    tr = jp.train
    kw = dict(time_context=tr.time_context, overlap=tr.overlap,
              mult_factor_in=tr.mult_factor_in, mult_factor_out=tr.mult_factor_out)
    return jp, SegmentDataset(d, jp.sources, **kw), JaxSegmentDataset(d, jp.sources, **kw)


def _epoch(mod, ds, b, workers, state=None):
    return list(mod.stateful_batches(
        mod.make_loader(ds, b, seed=11, num_epochs=1, worker_count=workers), state=state))


def _same(got, want):
    assert len(got) == len(want) > 0
    for ((gx, gy), gs), ((wx, wy), ws) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gs == ws


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_equals_the_reference(feats, workers):
    """One epoch, and the epoch resumed from two of its states, batch for
    batch and state string for state string (worker processes: grain's on
    the reference's side, ``torch.utils.data``'s on the port's)."""
    _, pds, jds = feats
    want = _epoch(jax_grain, jds, 3, workers)
    _same(_epoch(grain_pipeline, pds, 3, workers), want)
    for k in (0, len(want) // 2):
        _same(_epoch(grain_pipeline, pds, 3, workers, state=want[k][1]), want[k + 1:])


def test_state_resumes_across_packages(feats):
    """A state the port wrote resumes the reference's loader, and the
    reverse; a state for another loader is refused."""
    _, pds, jds = feats
    mine = _epoch(grain_pipeline, pds, 4, 0)
    theirs = _epoch(jax_grain, jds, 4, 0, state=mine[1][1])
    _same(_epoch(grain_pipeline, pds, 4, 0, state=mine[1][1]), theirs)
    state = json.loads(mine[0][1])
    assert list(state) == ["version", "last_seen_indices", "last_worker_index", "worker_count",
                           "sampler", "data_source"]
    assert state["data_source"].startswith("_Source(SegmentDataset, root=")
    with pytest.raises(ValueError, match="sampler"):
        list(grain_pipeline.stateful_batches(
            grain_pipeline.make_loader(pds, 4, seed=12, num_epochs=1), state=mine[0][1]))
    assert [s for _, s in grain_pipeline.stateful_batches(
        grain_pipeline.make_loader(pds, 4, seed=11, num_epochs=1), state=mine[-1][1])] == []
    assert len(list(grain_pipeline.batches(pds, 4, seed=11))) == len(mine)


def test_trainer_fit_with_grain(feats, tmp_path):
    """``fit(use_grain=True)`` feeds the reference Trainer's batches and
    saves its data positions (grain's state string under "grain"); a run
    stopped mid-epoch, restored and resumed trains on exactly the batches
    the uninterrupted run took after that point."""
    jp0, pds, jds = feats
    jp = dataclasses.replace(jp0, train=dataclasses.replace(
        jp0.train, batch_size=4, num_epochs=2, checkpoint_every_steps=3))
    pp = port(jp)

    def record(t):
        seen, step = [], t.train_step

        def spy(state, x, y):
            seen.append(np.array(x))
            return step(state, x, y)

        t.train_step = spy
        return seen

    jt = jax_loop.Trainer(jp, workdir=str(tmp_path / "jax"))
    j_seen = record(jt)
    jt.fit(jds, use_grain=True)
    init = from_jax_params(jax_loop.create_train_state(jp, jp.train.seed)[0].params,
                           trainable_config(pp.model))

    def port_trainer(name):
        t = loop.Trainer(pp, workdir=str(tmp_path / name), device="cpu")
        with torch.no_grad():
            for k, v in init.items():
                t.state.params[k].copy_(v)
        return t

    full = port_trainer("full")
    p_seen = record(full)
    full.fit(pds, use_grain=True)
    assert len(p_seen) == len(j_seen) == int(jt.state.step) > 4
    for a, b in zip(p_seen, j_seen):
        np.testing.assert_array_equal(a, b)
    assert full.data_position == jt._data_pos
    half = port_trainer("half")
    record(half)
    stop = len(j_seen) // 2 - 1  # mid-epoch of the first epoch
    half.fit(pds, use_grain=True, max_steps=stop)
    pos = half.data_position
    assert pos["epoch"] == 0 and pos["batch_in_epoch"] == stop
    assert json.loads(pos["grain"])["last_seen_indices"] == {"0": 4 * stop - 1}
    again = port_trainer("half")
    assert again.restore() == stop
    rest = record(again)
    again.fit(pds, use_grain=True)
    assert len(rest) == len(j_seen) - stop
    for a, b in zip(rest, j_seen[stop:]):
        np.testing.assert_array_equal(a, b)
