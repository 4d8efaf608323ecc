"""The tensorboard event file, port against reference, on CPU: the same
rows through the port's ``MetricsLogger(tensorboard_dir=)`` (its own
writer, ``utils/tb_events.py``) and the reference's (``tf.summary``), both
files read back with tensorboard's ``EventAccumulator``: the same tags,
steps and values (float32, bit for bit), and a file the reader takes as
the reference's. ``Trainer.fit(tensorboard=True)`` writes to
``<workdir>/tb``. The port itself never imports tensorboard or
tensorflow (``tests/test_torch_train_e2e.py::test_training_never_imports_jax``)."""

import dataclasses
import os
import struct

import numpy as np
import pytest

from convsep_tpu.train import loop as jax_loop
from convsep_tpu_torch.train import loop
from convsep_tpu_torch.utils import tb_events
from tests.test_torch_train_model import PRESETS, port

ROWS = [dict(step=0, epoch=0, loss=0.7512, grad_norm=3.25, step_time_ms=12.5, rtf_train=901.2),
        dict(step=1, epoch=0, loss=0.5, grad_norm=2.0, step_time_ms=11.0, rtf_train=1000.0),
        dict(step=7, epoch=0, epoch_loss=0.61, epoch_seconds=1.5, debug=True, name="x"),
        dict(step=8, epoch=1, loss=float(np.float32(1 / 3)), val_loss=0.25)]


def _read(logdir: str) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from tensorboard.util import tensor_util

    acc = EventAccumulator(logdir, size_guidance={"tensors": 0})
    acc.Reload()
    out = {}
    for tag in acc.Tags()["tensors"]:
        out[tag] = [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                    for e in acc.Tensors(tag)]
        meta = acc.SummaryMetadata(tag)
        assert meta.plugin_data.plugin_name == "scalars", tag
    assert acc.Tags()["scalars"] == []
    return out


def test_event_file_matches_tf_summary(tmp_path):
    pytest.importorskip("tensorflow")
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    for cls, d in ((loop.MetricsLogger, mine), (jax_loop.MetricsLogger, ref)):
        logger = cls(None, print_every=1000, tensorboard_dir=d)
        for row in ROWS:
            logger.log(**row)
        logger.close()
    got, want = _read(mine), _read(ref)
    assert sorted(got) == sorted(want) == sorted(
        {"epoch", "loss", "grad_norm", "step_time_ms", "rtf_train", "epoch_loss",
         "epoch_seconds", "debug", "val_loss"})
    assert got == want
    assert got["loss"] == [(0, float(np.float32(0.7512))), (1, 0.5), (8, float(np.float32(1 / 3)))]


def test_records_are_framed_and_checksummed(tmp_path):
    w = tb_events.EventWriter(str(tmp_path))
    w.scalars(3, {"loss": 0.5})
    w.close()
    raw = open(w.path, "rb").read()
    records = []
    while raw:
        n = struct.unpack("<Q", raw[:8])[0]
        assert struct.unpack("<I", raw[8:12])[0] == tb_events.masked_crc32c(raw[:8])
        data = raw[12:12 + n]
        assert struct.unpack("<I", raw[12 + n:16 + n])[0] == tb_events.masked_crc32c(data)
        records.append(data)
        raw = raw[16 + n:]
    assert len(records) == 2 and b"brain.Event:2" in records[0]
    # the known CRC-32C check value
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    assert os.path.basename(w.path).startswith("events.out.tfevents.")


def test_trainer_writes_tensorboard_under_the_workdir(tmp_path):
    from convsep_tpu_torch.data import synth
    from convsep_tpu_torch.data.pipeline import SegmentDataset

    jp = PRESETS["ikala_tiny"]()
    pp = port(dataclasses.replace(jp, train=dataclasses.replace(jp.train, log_every_steps=1,
                                                                batch_size=4)))
    d = str(tmp_path / "feats")
    synth.synth_feature_dir(d, pp.sources, num_tracks=1, seconds=2.0, fs=8000, frame_size=256,
                            hop_size=128, device="cpu")
    ds = SegmentDataset(d, pp.sources, time_context=pp.train.time_context,
                        overlap=pp.train.overlap)
    wd = tmp_path / "run"
    trainer = loop.Trainer(pp, workdir=str(wd), device="cpu")
    trainer.fit(ds, max_steps=3, tensorboard=True)
    got = _read(str(wd / "tb"))
    assert [s for s, _ in got["loss"]] == [1, 2]
    assert all(np.isfinite(v) for _, v in got["grad_norm"])
