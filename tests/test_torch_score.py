"""Score-informed separation (bach10), port against reference, on CPU:
the score modules (copies of numpy code: equal, NMF to 1e-6 relative),
``TransformFFT.compute_file`` / ``compute_inverse`` (1e-5 × peak: f32 DFT
sums in another order), the score gate's two modes (1e-6 relative), and
the whole separation against the committed bach10 golden (atol 2e-4, as
tests/test_golden.py) and the JAX ``Separator`` with the gate on (1e-5
absolute)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu import score as jscore
from convsep_tpu.data import sine_mixture
from convsep_tpu.data.features import score_channels as jax_score_channels
from convsep_tpu.dsp.transform import TransformFFT as JaxTransformFFT
from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.separate import Separator as JaxSeparator
from convsep_tpu.separate.pipeline import _score_gate as jax_score_gate
from convsep_tpu_torch import score as tscore
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.data.features import score_channels
from convsep_tpu_torch.dsp.transform import TransformFFT
from convsep_tpu_torch.separate.pipeline import Separator, score_gate
from tests.test_separate import tiny_preset

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NOTES = [[tscore.Note(57.0, 0.0, 0.6)], [tscore.Note(64.0, 0.2, 0.8)],
         [tscore.Note(69.0, 0.0, 1.0)], [tscore.Note(76.0, 0.4, 1.0)]]


def _jnotes(notes):
    return [[jscore.Note(n.pitch_midi, n.start_sec, n.end_sec) for n in ns] for ns in notes]


def _port(jax_preset):
    return preset_from_dict(dataclasses.asdict(jax_preset))


def _params(preset, seed=42):
    cfg = preset.model
    return JaxConvSep(cfg).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.time_context, cfg.feat_size, cfg.channels_in)),
    )


@pytest.mark.parametrize("kw", [{}, {"n_harmonics": 5, "semitone_width": 0.5},
                                {"onset_pad_sec": 0.0, "floor": 0.1}])
def test_score_mask_and_channels_equal_jax(rng, kw):
    mix = np.abs(rng.standard_normal((70, 129))).astype(np.float32)
    for ns, jns in zip(NOTES, _jnotes(NOTES)):
        np.testing.assert_array_equal(tscore.score_mask(ns, 70, 129, 8000, 128, **kw),
                                      jscore.score_mask(jns, 70, 129, 8000, 128, **kw))
    np.testing.assert_array_equal(
        tscore.score_filtered_channels(mix, NOTES, 8000, 128, **kw),
        jscore.score_filtered_channels(mix, _jnotes(NOTES), 8000, 128, **kw))


def test_score_nmf_and_features_equal_jax(rng):
    mix = np.abs(rng.standard_normal((70, 129))).astype(np.float32)
    want = jscore.score_nmf_channels(mix, _jnotes(NOTES), 8000, 128, n_iter=10)
    got = tscore.score_nmf_channels(mix, NOTES, 8000, 128, n_iter=10)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    jp = tiny_preset("bach10")
    for kind in ("comb", "nmf"):
        np.testing.assert_allclose(score_channels(mix, NOTES, _port(jp), kind),
                                   jax_score_channels(mix, _jnotes(NOTES), jp, kind),
                                   rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="score_filter"):
        score_channels(mix, NOTES, _port(jp), "wiener")


def test_note_helpers_equal_jax(tmp_path):
    ann = tmp_path / "violin.notes.txt"
    ann.write_text("# onset offset pitch\n0.0 0.5 60\n0.25 1.0 64.5\n")
    got, want = tscore.parse_note_annotations(str(ann)), jscore.parse_note_annotations(str(ann))
    assert [(n.pitch_midi, n.start_sec, n.end_sec) for n in got] == \
        [(n.pitch_midi, n.start_sec, n.end_sec) for n in want]
    for fn in ("shift_notes", "stretch_notes"):
        a = getattr(tscore, fn)(got, 0.3)
        b = getattr(jscore, fn)(want, 0.3)
        assert [(n.start_sec, n.end_sec) for n in a] == [(n.start_sec, n.end_sec) for n in b]
    with pytest.raises(ValueError):
        tscore.Note(60.0, 1.0, 0.5)


@pytest.mark.parametrize("iscale", ["lin", "log"])
def test_transform_fft_matches_jax(rng, iscale):
    jp = tiny_preset("bach10")
    jt = dataclasses.replace(jp.transform, iscale=iscale)
    audio = (0.3 * rng.standard_normal(5000)).astype(np.float32)
    jfft = JaxTransformFFT(jt)
    tfft = TransformFFT(_port(dataclasses.replace(jp, transform=jt)).transform, device="cpu")
    jm, jph = jfft.compute_file(audio, phase=True)
    tm, tph = tfft.compute_file(audio, phase=True)
    assert tm.shape == jm.shape and tm.dtype == np.float32
    np.testing.assert_allclose(tm, jm, atol=1e-5 * np.abs(jm).max(), rtol=0)
    np.testing.assert_allclose(tfft.compute_file(audio), tm, atol=0, rtol=0)
    # phases agree where the bins carry energy (atan2 of near-zero bins is noise)
    live = jm > 1e-3 * jm.max()
    np.testing.assert_allclose(np.cos(tph[live] - jph[live]), 1.0, atol=1e-6)
    back = tfft.compute_inverse(tm, tph, length=5000)
    np.testing.assert_allclose(back, jfft.compute_inverse(jm, jph, length=5000), atol=1e-5)
    if iscale == "lin":
        np.testing.assert_allclose(back, audio, atol=1e-5)


@pytest.mark.parametrize("iscale", ["lin", "log"])
def test_transform_fft_matches_jax_at_lowered_precision(rng, iscale):
    """The same bounds with the caller's float32 matmul precision lowered to
    "medium" (on a CPU with bf16 matrix units a float32 product then runs in
    bf16): TransformFFT computes at "highest" whatever the caller set, and
    gives the caller's setting back."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        test_transform_fft_matches_jax(rng, iscale)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)


@pytest.mark.parametrize("mode,g", [("mult", 0.5), ("mult", 1.0), ("blend", 0.3),
                                    ("blend", 1.0), ("mult", 0.0)])
def test_score_gate_matches_jax(rng, mode, g):
    jp = tiny_preset("bach10", score_gate=g, score_gate_mode=mode)
    pp = _port(jp)
    y = np.abs(rng.standard_normal((2, 4, 30, 129))).astype(np.float32)
    mag = np.abs(rng.standard_normal((2, 30, 129))).astype(np.float32)
    extra = (mag[..., None] * rng.uniform(0, 1.2, (2, 30, 129, 4))).astype(np.float32)
    want = np.asarray(jax_score_gate(jnp.asarray(y), jnp.asarray(extra), jnp.asarray(mag), jp, 1))
    got = score_gate(torch.from_numpy(y), torch.from_numpy(extra), torch.from_numpy(mag), pp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if g == 0.0:
        np.testing.assert_array_equal(got.numpy(), y)
    bad = dataclasses.replace(pp, sep=dataclasses.replace(pp.sep, score_gate_mode="max"))
    if g > 0:
        with pytest.raises(ValueError, match="score_gate_mode"):
            score_gate(torch.from_numpy(y), torch.from_numpy(extra), torch.from_numpy(mag), bad)


def _bach10_extra(preset, mix, device="cpu"):
    """tests/golden_cases.py::case_bach10_score's extra channels, with the
    port's TransformFFT and score_channels."""
    mag = TransformFFT(preset.transform, device=device).compute_file(np.asarray(mix))
    return score_channels(mag, NOTES, preset, "comb") * preset.train.mult_factor_in


def test_bach10_tiny_matches_golden():
    jp = tiny_preset("bach10")
    golden = np.load(os.path.join(GOLDEN, "bach10_score_tiny_stems.npz"))
    _, mix = sine_mixture(4, 8000, fs=8000, seed=23)
    np.testing.assert_allclose(mix, golden["mix"], atol=1e-7, err_msg="fixture drifted")
    pp = _port(jp)
    stems = Separator(pp, from_jax_params(_params(jp), pp.model), device="cpu")(
        mix, extra=_bach10_extra(pp, mix))
    assert stems.dtype == np.float32 and stems.shape == golden["stems"].shape
    np.testing.assert_allclose(stems, golden["stems"], atol=2e-4)


@pytest.mark.parametrize("mode,g", [("mult", 0.5), ("blend", 1.0)])
def test_bach10_gated_matches_jax(mode, g):
    jp = tiny_preset("bach10", score_gate=g, score_gate_mode=mode)
    params = _params(jp, seed=5)
    _, mix = sine_mixture(4, 9000, fs=8000, seed=31)
    mag = JaxTransformFFT(jp.transform).compute_file(np.asarray(mix))
    extra = jax_score_channels(mag, _jnotes(NOTES), jp, "comb") * jp.train.mult_factor_in
    want = np.asarray(JaxSeparator(jp, params)(mix, extra=extra))
    pp = _port(jp)
    sep = Separator(pp, from_jax_params(params, pp.model), device="cpu")
    got = sep(mix, extra=extra)
    assert got.shape == want.shape == (4, 9000)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # frames past the track are padded with zeros, extra ones trimmed
    short = sep(mix, extra=extra[:40])
    want_short = np.asarray(JaxSeparator(jp, params)(mix, extra=extra[:40]))
    np.testing.assert_allclose(short, want_short, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(sep(mix, extra=np.pad(extra, ((0, 9), (0, 0), (0, 0)))), got)
