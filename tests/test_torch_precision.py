"""The float32 contract inside the package (``utils/precision.py``): the
training forward and backward run their convolutions with cuDNN's TF32 off
and float32 products at "highest" precision, and the separation and public
DSP entry points their products, whatever the caller set; the caller's flags
come back after the call, also when scopes overlap from two threads. On CPU the flags do not change any number, so the test reads them
where the convolutions run: ``conv2d`` is patched to record them in the
forward and, through an identity autograd function on its output, in the
backward."""

import threading

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


@pytest.fixture
def products(monkeypatch):
    """Record the flags at every float32 product (``@`` and ``einsum``)."""
    seen = []
    real_matmul, real_einsum = torch.Tensor.__matmul__, torch.einsum

    def matmul(a, b):
        seen.append(flags())
        return real_matmul(a, b)

    def einsum(*args, **kwargs):
        seen.append(flags())
        return real_einsum(*args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "__matmul__", matmul)
    monkeypatch.setattr(torch, "einsum", einsum)
    return seen


def test_prepare_inference_multiplies_at_highest(lowered, products):
    """The composed encoder weight and decode operands, built once when a
    separator is made, are float32 products too: at a lowered precision
    they were computed in bf16 on a CPU with bf16 matrix units (the stems
    then 2e-2 off)."""
    from convsep_tpu_torch.configs import get_preset

    p = get_preset("dsd100")
    Separator(p, init_params(p.model, torch.Generator().manual_seed(1), "cpu"), device="cpu")
    assert products and set(products) == {(False, "highest")} and flags() == lowered


@pytest.mark.parametrize("nfft", [256, 4096])  # the direct and the factored DFT
def test_transform_fft_multiplies_at_highest(lowered, products, nfft):
    from convsep_tpu_torch.configs.presets import TransformConfig
    from convsep_tpu_torch.dsp.transform import TransformFFT

    t = TransformFFT(TransformConfig(frame_size=nfft, hop_size=nfft // 4), device="cpu")
    audio = np.random.default_rng(0).standard_normal(3 * nfft).astype(np.float32)
    mag, phase = t.compute_file(audio, phase=True)
    assert products and set(products) == {(False, "highest")} and flags() == lowered
    products.clear()
    assert t.compute_inverse(mag, phase, length=len(audio)).shape == audio.shape
    assert products and set(products) == {(False, "highest")} and flags() == lowered


def test_dsp_entry_points_multiply_at_highest(lowered, products):
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.dsp.dft import istft_matmul, istft_wiener, stft_matmul
    from convsep_tpu_torch.dsp.multires import multires_channels
    from convsep_tpu_torch.dsp.windows import sinebell

    w = sinebell(512)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    re, im = stft_matmul(x, w, 128)
    out = istft_matmul(re, im, w, 128, 4096)
    y = torch.rand(2, *re.shape)
    stems = istft_wiener(y, re, im, w, 128, 4096)
    t = get_preset("multires4096").transform
    chans = multires_channels(torch.zeros(4 * t.hop_size), t)
    assert out.shape == (4096,) and stems.shape == (2, 4096) and chans.shape[-1] == len(t.multires)
    assert products and set(products) == {(False, "highest")} and flags() == lowered


def test_scopes_overlapping_from_two_threads_restore_the_callers_flags(lowered):
    """Thread a opens a scope, thread b opens one, a closes first: b's body
    still runs at "highest", and the caller's flags come back only when b
    closes (a save and restore per scope gave b the lowered flags)."""
    a_open, b_open, a_closed, b_checked = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with float32_exact():
            a_open.set()
            b_open.wait(10)
        a_closed.set()

    def b():
        a_open.wait(10)
        with float32_exact():
            b_open.set()
            a_closed.wait(10)
            seen["b after a closed"] = flags()
        b_checked.set()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(20)
    assert b_checked.is_set()
    assert seen["b after a closed"] == (False, "highest")
    assert flags() == lowered
