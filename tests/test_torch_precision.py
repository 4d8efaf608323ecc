"""The float32 contract inside the package (``utils/precision.py``): the
training forward and backward run their convolutions with cuDNN's TF32 off
and float32 products at "highest" precision, and the separation entry points
their products, whatever the caller set; the caller's flags come back after
the call. On CPU the flags do not change any number, so the test reads them
where the convolutions run: ``conv2d`` is patched to record them in the
forward and, through an identity autograd function on its output, in the
backward."""

import numpy as np
import pytest
import torch

from convsep_tpu_torch.ckpt import init_params
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset
from convsep_tpu_torch.models.convsep import train_sources, trainable_config
from convsep_tpu_torch.separate import Separator
from convsep_tpu_torch.train import loop
from convsep_tpu_torch.utils.precision import float32_exact
from tests.test_torch_train_e2e import FS, audio_root  # noqa: F401 (fixture)
from tests.test_torch_train_model import port, tiny_dsd_preset


def flags():
    return torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()


@pytest.fixture
def lowered():
    """The caller's flags lowered (TF32 allowed everywhere), restored after."""
    saved = flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    yield (True, "medium")
    torch.backends.cudnn.allow_tf32 = saved[0]
    torch.set_float32_matmul_precision(saved[1])


@pytest.fixture
def probe(monkeypatch):
    """Record the flags at every conv2d call and in its backward."""
    seen = {"forward": [], "backward": []}
    real = torch.nn.functional.conv2d

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen["backward"].append(flags())
            return g

    def conv2d(*args, **kwargs):
        seen["forward"].append(flags())
        return Probe.apply(real(*args, **kwargs))

    monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d)
    return seen


def test_context_restores_also_on_raise(lowered):
    with float32_exact():
        assert flags() == (False, "highest")
        with float32_exact():
            assert flags() == (False, "highest")
        assert flags() == (False, "highest")
    assert flags() == lowered
    with pytest.raises(RuntimeError):
        with float32_exact():
            raise RuntimeError("boom")
    assert flags() == lowered


def test_train_sources_convolves_without_tf32(lowered, probe):
    cfg = trainable_config(port(tiny_dsd_preset()).model)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in params.values():
        p.requires_grad_(True)
    x = torch.rand(2, cfg.time_context, cfg.feat_size, cfg.channels_in)
    y = train_sources(params, x, cfg)
    assert probe["forward"] == [(False, "highest")] * 2
    assert flags() == lowered
    y.sum().backward()  # the caller's own backward: outside the package's scope
    assert probe["backward"] == [lowered] * 2


def test_trainer_step_convolves_without_tf32_both_ways(lowered, probe, audio_root):  # noqa: F811
    pp = port(tiny_dsd_preset())
    trainer = loop.Trainer(pp, from_audio=True, device="cpu")
    ds = AudioSegmentDataset(audio_root, pp.sources, (10 - 2) * 128, fs=FS)
    trainer.fit(ds, max_steps=2)
    assert trainer.state.step == 2
    assert probe["forward"] and set(probe["forward"]) == {(False, "highest")}
    assert probe["backward"] and set(probe["backward"]) == {(False, "highest")}
    assert flags() == lowered
    probe["forward"].clear()
    assert np.isfinite(trainer.evaluate(ds, max_batches=1))
    assert set(probe["forward"]) == {(False, "highest")} and flags() == lowered


def test_separator_multiplies_at_highest(lowered, monkeypatch):
    from convsep_tpu_torch.configs import get_preset

    p = get_preset("dsd100")
    cfg = p.model
    state = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    seen = []
    real = torch.Tensor.__matmul__

    def matmul(a, b):
        seen.append(flags())
        return real(a, b)

    sep = Separator(p, state, device="cpu")
    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    stems = sep(np.zeros(4 * p.transform.hop_size * cfg.time_context, np.float32))
    assert stems.shape[0] == cfg.num_sources and seen
    assert set(seen) == {(False, "highest")} and flags() == lowered
