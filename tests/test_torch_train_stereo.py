"""Stereo and multires training from audio, port against reference, on CPU:
``AudioSegmentDataset(stereo=True)`` batches against the JAX dataset's,
the joint-channel loss (``decoder_reduce="all"``) and the multires loss
(extra channels computed in the step) with every gradient leaf against
``convsep_tpu.train.e2e.make_audio_loss_fn`` and ``jax.grad``, the in-step
multires channels against the reference's own ``extra_of``, and the
cached interpolation matrix against a fresh one.

Tolerances: batches bit for bit (the same numpy); the loss within 1e-5
relative; every gradient leaf within 1e-5 × the largest gradient (float32
sums in another order), at ``wiener_eps = 1e-2`` as
``tests/test_torch_train_e2e.py`` says why; multires channels within 1e-5
× their peak."""

import dataclasses
import inspect
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs.presets import stereo_preset as jax_stereo_preset
from convsep_tpu.data.audio_dataset import AudioSegmentDataset as JaxAudioSegmentDataset
from convsep_tpu.train import e2e as jax_e2e
from convsep_tpu.train import loop as jax_loop
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples
from convsep_tpu_torch.data.io import write_wav
from convsep_tpu_torch.data.synth import sine_mixture
from convsep_tpu_torch.dsp import multires as tmr
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.train import e2e, loop
from tests.test_torch_multires import tiny_multires4096
from tests.test_torch_train_model import port, tiny_dsd_preset

FS = 8000


def _with(jp, fft_impl="pallas"):
    return dataclasses.replace(jp, transform=dataclasses.replace(jp.transform, fft_impl=fft_impl))


def tiny_stereo_preset(**train_kw):
    """dsd100-stereo at the tiny train size: 4 stems, two channels in, the
    decoder keeping both."""
    return jax_stereo_preset(tiny_dsd_preset(**train_kw))


def tiny_multires_preset(**train_kw):
    """The tiny dsd100 with multires channels at 64 and 128 points (W 256,
    hop 128), as ``tests/test_torch_multires.py``'s golden case."""
    p = tiny_dsd_preset(**train_kw)
    return dataclasses.replace(
        p, transform=dataclasses.replace(p.transform, multires=(64, 128)),
        model=dataclasses.replace(p.model, channels_in=3))


@pytest.fixture(scope="module")
def stereo_root(tmp_path_factory):
    """2 tracks of 4 stems, 2 s at 8 kHz: two stereo stems, a mono stem and
    an (n, 1) stem, a three-channel mixture in one track and none in the
    other (the stems' sum)."""
    root = tmp_path_factory.mktemp("stereo")
    names = tiny_dsd_preset().sources
    for i in range(2):
        d = root / f"t{i}"
        d.mkdir()
        stems, _ = sine_mixture(4, 2 * FS, fs=FS, seed=10 + i)
        pan = np.stack([0.8 * stems, 0.4 * stems], axis=-1)  # (4, n, 2)
        write_wav(d / f"{names[0]}.wav", FS, pan[0])
        write_wav(d / f"{names[1]}.wav", FS, pan[1][:, ::-1].copy())
        write_wav(d / f"{names[2]}.wav", FS, stems[2])
        write_wav(d / f"{names[3]}.wav", FS, stems[3][:, None])
        if i == 0:
            mix = pan.sum(axis=0)
            write_wav(d / "mixture.wav", FS, np.concatenate([mix, mix[:, :1]], axis=1))
    return str(root)


def test_stereo_dataset_matches_jax(stereo_root):
    jp = tiny_stereo_preset()
    seg = segment_samples(port(jp))
    ds = AudioSegmentDataset(stereo_root, jp.sources, seg, overlap_samples=seg // 3, fs=FS,
                             stereo=True)
    jds = JaxAudioSegmentDataset(stereo_root, jp.sources, seg, overlap_samples=seg // 3, fs=FS,
                                 stereo=True)
    assert len(ds) == len(jds) > 8
    n = 0
    for (x, y), (jx, jy) in zip(ds.batches(4, seed=5), jds.batches(4, seed=5)):
        assert x.shape == (4, 2, seg) and y.shape == (4, 4, 2, seg) and x.dtype == np.float32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        n += 1
    assert n == len(ds) // 4
    # mono stems are centre-panned: both ears equal
    _, stems = ds.get(0)
    np.testing.assert_array_equal(stems[2, 0], stems[2, 1])
    np.testing.assert_array_equal(stems[3, 0], stems[3, 1])
    mono = AudioSegmentDataset(stereo_root, jp.sources, seg, fs=FS)
    jmono = JaxAudioSegmentDataset(stereo_root, jp.sources, seg, fs=FS)
    np.testing.assert_array_equal(mono.get(3)[0], jmono.get(3)[0])


def _grads_match(jp, mix, stems, ref=None):
    """The port's loss and gradients against the reference's (``ref``, by
    default ``jp`` itself) at the preset's wiener_eps (the loss) and at
    1e-2 (loss and gradients)."""
    ref = jp if ref is None else ref
    state, _ = jax_loop.create_train_state(ref, 0)
    cfg = trainable_config(port(jp).model)
    args = (torch.from_numpy(mix), torch.from_numpy(stems))
    loss = e2e.make_audio_loss_fn(port(jp))(from_jax_params(state.params, cfg), *args)
    j_loss = jax_e2e.make_audio_loss_fn(ref)(state.params, jnp.asarray(mix), jnp.asarray(stems))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)

    def at_1e2(p):
        return dataclasses.replace(p, sep=dataclasses.replace(p.sep, wiener_eps=1e-2))

    j_loss, j_grads = jax.value_and_grad(jax_e2e.make_audio_loss_fn(at_1e2(ref)))(
        state.params, jnp.asarray(mix), jnp.asarray(stems))
    params = {k: v.requires_grad_() for k, v in from_jax_params(state.params, cfg).items()}
    loss = e2e.make_audio_loss_fn(port(at_1e2(jp)))(params, *args)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    want = from_jax_params(j_grads, cfg)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, g in grads.items():
        assert float(g.abs().max()) > 1e-3 * scale, k
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("fft_impl", ["pallas", "matmul"])
def test_stereo_loss_and_grads_match_jax(rng, fft_impl):
    """Both routes against the reference's matmul route: the reference's
    stereo loss on ``fft_impl="pallas"`` hands its (B, 2, seg) mixture to
    ``stft_pallas``, which takes (L,) or (B, L) only and raises; the port
    flattens the ears into rows, (B·2, seg), before the kernel."""
    jp = _with(tiny_stereo_preset(), fft_impl)
    seg = segment_samples(port(jp))
    stems = (0.1 * rng.standard_normal((3, 4, 2, seg))).astype(np.float32)
    _grads_match(jp, stems.sum(axis=1), stems, ref=_with(jp, "matmul"))
    if fft_impl == "pallas":
        with pytest.raises(ValueError, match=r"expects \(L,\) or \(B, L\)"):
            jax_e2e.make_audio_loss_fn(jp)(jax_loop.create_train_state(jp, 0)[0].params,
                                           jnp.asarray(stems.sum(axis=1)), jnp.asarray(stems))
    with pytest.raises(ValueError, match="segment length"):
        e2e.make_audio_loss_fn(port(jp))({}, torch.zeros(2, 2, 100), torch.zeros(2, 4, 2, 100))


@pytest.mark.parametrize("fft_impl", ["pallas", "matmul"])
def test_multires_loss_and_grads_match_jax(rng, fft_impl):
    jp = _with(tiny_multires_preset(), fft_impl)
    seg = segment_samples(port(jp))
    stems = (0.1 * rng.standard_normal((3, 4, seg))).astype(np.float32)
    _grads_match(jp, stems.sum(axis=1), stems)


def _jax_extra_of(jp):
    """The reference's in-step ``extra_of`` (a closure of its loss)."""
    return inspect.getclosurevars(jax_e2e.make_audio_loss_fn(jp)).nonlocals["extra_of"]


def _port_extra_of(pp):
    return inspect.getclosurevars(e2e.make_audio_loss_fn(pp)).nonlocals["extra_of"]


@pytest.mark.parametrize("make", [tiny_multires_preset, tiny_multires4096])
def test_extra_of_matches_the_reference(rng, make):
    """The port's in-step channels (``multires_channels``, scaled) against
    the reference's ``extra_of`` on the same mixtures."""
    jp = make()
    pp = port(jp)
    mix = (0.2 * rng.standard_normal((2, segment_samples(pp)))).astype(np.float32)
    want = np.asarray(_jax_extra_of(jp)(jnp.asarray(mix)))
    got = _port_extra_of(pp)(torch.from_numpy(mix)).numpy()
    T = pp.model.time_context
    assert got.shape == want.shape == (2, T, pp.transform.bins, len(pp.transform.multires))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_interp_is_cached_and_bit_equal():
    """The interpolation matrix is made once per (sizes, device): the same
    tensor on every call, equal bit for bit to a fresh one."""
    a = tmr._interp(65, 129, "cpu")
    assert tmr._interp(65, 129, "cpu") is a
    np.testing.assert_array_equal(a.numpy(), tmr.freq_interp_matrix.__wrapped__(65, 129))
    t = port(tiny_multires_preset()).transform
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 2048)).astype(np.float32))
    before = tmr._interp.cache_info().misses
    first = tmr.multires_channels(x, t)
    again = tmr.multires_channels(x, t)
    assert tmr._interp.cache_info().misses - before <= len(t.multires)
    assert torch.equal(first, again)


def test_trainer_fits_stereo_and_multires(stereo_root, tmp_path):
    """``Trainer(from_audio=True)`` runs both kinds a few steps on the
    CPU: finite losses, the step count, a checkpoint."""
    for jp in (tiny_stereo_preset(log_every_steps=1), tiny_multires_preset(log_every_steps=1)):
        pp = port(_with(jp))
        stereo = pp.model.decoder_reduce == "all"
        ds = AudioSegmentDataset(stereo_root, pp.sources, segment_samples(pp), fs=FS,
                                 stereo=stereo)
        wd = tmp_path / pp.name / ("st" if stereo else "mr")
        trainer = loop.Trainer(pp, workdir=str(wd), from_audio=True, device="cpu")
        trainer.fit(ds, max_steps=3)
        assert trainer.state.step == 3
        assert sorted(os.listdir(wd / "checkpoints")) == ["3"]
        assert np.isfinite(trainer.evaluate(ds, max_batches=1))

