"""Evaluation, port against reference, on CPU: ``convsep_tpu_torch.eval``
(BSS Eval in torch float64, the ideal-soft-mask oracle) against
``convsep_tpu.eval`` on the same numpy inputs, the fixtures of
``tests/test_bss_eval.py`` and ``tests/test_bss_known_answer.py``.

Tolerances: the metrics within 1e-6 dB (both solve the same Gram system
in float64, by Cholesky or, where the Gram is singular to rounding, by
LAPACK's SVD least squares; the filter-and-sum is an FFT convolution here
and a direct one there; measured 4.1e-10 dB). Where the Gram is singular
to rounding, 1e-4 dB: the least squares' rank cutoff meets singular values
within rounding of it, so correlations summed in another order move the
solution (measured 8.0e-8 to 6.3e-6 dB over six seeds). Every estimate carries
a small noise floor, so that no ratio is set by rounding alone (a perfect
estimate's SDR is 10 log10 of a rounding residue, ~300 dB in either
package, equal only in being huge; those are held to the JAX tests'
properties). The oracle's stems within 1e-5 × peak (float32 STFTs of the
same frames, sums in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from convsep_tpu import eval as jax_eval
from convsep_tpu.configs import get_preset as jax_get_preset
from convsep_tpu.configs.presets import TransformConfig as JaxTransformConfig
from convsep_tpu_torch import eval as port_eval
from convsep_tpu_torch.configs import TransformConfig, get_preset
from convsep_tpu_torch.eval import bss_eval as bss

TOL_DB = 1e-6
TOL_DB_SINGULAR = 1e-4
TOL_ORACLE = 1e-5  # × peak


def _tone_noise(rng, n=4000):
    """tests/test_bss_eval.py::sources."""
    s1 = np.sin(2 * np.pi * 440 * np.arange(n) / 8000)
    s2 = rng.standard_normal(n) * 0.3
    return np.stack([s1, s2])


def _known_refs(rng, flen=16, n=4000):
    """tests/test_bss_known_answer.py::refs."""
    r = rng.standard_normal((2, n))
    r[:, -(flen - 1):] = 0.0
    return r


def _am_tones(rng, n=8000):
    """Three amplitude-modulated tones and noise: the delayed copies of a
    tone span a few dimensions, so the Gram is singular to rounding and
    both packages take the least-squares branch."""
    t = np.arange(n) / 8000
    refs = np.stack([np.sin(2 * np.pi * f * t) * (1 + 0.3 * np.sin(2 * np.pi * 0.7 * t))
                     for f in (220.0, 440.0, 1760.0)] + [0.2 * rng.standard_normal(n)])
    mix = np.array([[0.8, 0.1, 0.05, 0.1], [0.1, 0.7, 0.1, 0.0], [0.0, 0.2, 0.9, 0.1],
                    [0.1, 0.0, 0.0, 0.6]])
    return refs, mix @ refs + 0.02 * rng.standard_normal(refs.shape)


def _case(name, rng):
    """(refs, ests, flen, compute_permutation) of one fixture."""
    if name == "singular_gram":
        return (*_am_tones(rng), 128, False)
    if name in ("known_answer", "known_answer_three"):
        S = 2 if name == "known_answer" else 3
        refs = np.concatenate([_known_refs(rng), _known_refs(rng)[:1]])[:S]
        mix = np.array([[0.5, 0.2, 0.1], [0.1, 0.7, 0.3], [0.2, 0.0, 0.9]])[:S, :S]
        return refs, mix @ refs + 0.05 * rng.standard_normal(refs.shape), 16, False
    src = _tone_noise(rng)
    floor = 0.01 * rng.standard_normal(src.shape)
    if name == "interference":
        ests = np.stack([src[0] + 0.3 * src[1], src[1]])
    elif name == "filtered":
        ests = np.stack([np.convolve(src[0], [0.8, 0.15, -0.05])[: src.shape[1]], src[1]])
    elif name == "noise":
        ests = np.stack([src[0] + 0.1 * rng.standard_normal(src.shape[1]), src[1]])
    else:  # "permutation": swapped estimates, the assignment searched
        ests = src[::-1].copy()
    return src, ests + floor, 32, name == "permutation"


@pytest.mark.parametrize("name", ["interference", "filtered", "noise", "permutation",
                                  "known_answer", "known_answer_three", "singular_gram"])
def test_bss_eval_sources_matches_jax(rng, name):
    refs, ests, flen, perm = _case(name, rng)
    if name == "singular_gram":  # the fixture reaches the least-squares branch
        sf = torch.fft.rfft(torch.from_numpy(refs), n=bss._nfft(refs.shape[1], flen))
        G = bss._autocorr_gram(sf, flen, bss._nfft(refs.shape[1], flen))
        assert int(torch.linalg.cholesky_ex(G)[1]) != 0
    want = jax_eval.bss_eval_sources(refs, ests, flen=flen, compute_permutation=perm)
    bss.SOLVES.clear()
    got = port_eval.bss_eval_sources(refs, ests, flen=flen, compute_permutation=perm,
                                     device="cpu")
    # the shared Gram and one block per (estimate, source) pair, each counted once
    S = refs.shape[0]
    assert sum(bss.SOLVES.values()) == 1 + (S * S if perm else S)
    assert bool(bss.SOLVES["lstsq_host"]) == (name == "singular_gram")
    for w, g in zip(want[:3], got[:3]):
        assert np.all(np.abs(w) < 100)  # every ratio set by the signals, not rounding
        np.testing.assert_allclose(
            g, w, rtol=0, atol=TOL_DB_SINGULAR if name == "singular_gram" else TOL_DB)
    np.testing.assert_array_equal(got[3], want[3])


def test_bss_eval_sources_properties(rng):
    """tests/test_bss_eval.py's properties on the port: a perfect estimate
    scores huge; the errors of the reference's checks."""
    src = _tone_noise(rng)
    sdr, sir, _, perm = port_eval.bss_eval_sources(src, src.copy(), flen=32, device="cpu")
    assert (sdr > 50).all() and (sir > 50).all()
    np.testing.assert_array_equal(perm, [0, 1])
    with pytest.raises(ValueError):
        port_eval.bss_eval_sources(src, src[:, :-5], device="cpu")
    bad = src.copy()
    bad[1] = 0
    with pytest.raises(ValueError, match="zero energy"):
        port_eval.bss_eval_sources(bad, src, device="cpu")


@pytest.mark.parametrize("case", ["degraded_tail", "silent_window"])
def test_bss_eval_windowed_matches_jax(rng, case):
    fs = 8000
    if case == "degraded_tail":
        n = fs * 4
        refs = np.stack([np.sin(2 * np.pi * 440 * np.arange(n) / fs),
                         rng.standard_normal(n) * 0.3])
        ests = refs + 0.01 * rng.standard_normal(refs.shape)
        ests[0, 3 * n // 4:] += 0.5 * refs[1, 3 * n // 4:]
        kw = dict(window_s=1.0, hop_s=0.5, flen=32)
    else:
        n = fs * 3
        s1 = np.zeros(n)
        s1[: fs * 2] = np.sin(2 * np.pi * 220 * np.arange(fs * 2) / fs)
        refs = np.stack([s1, rng.standard_normal(n) * 0.2])
        ests = refs + 0.01 * rng.standard_normal(refs.shape)
        kw = dict(window_s=1.0, hop_s=1.0, flen=16)
    want = jax_eval.bss_eval_windowed(refs, ests, fs, **kw)
    got = port_eval.bss_eval_windowed(refs, ests, fs, device="cpu", **kw)
    assert got["windows"] == want["windows"]
    np.testing.assert_allclose(got["per_window"], want["per_window"], rtol=0, atol=TOL_DB)
    for k in ("SDR", "SIR", "SAR"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL_DB)


@pytest.mark.parametrize("panned", [True, False])
def test_bss_eval_stereo_matches_jax(rng, panned):
    fs, n = 8000, 8000 * 2
    v = np.sin(2 * np.pi * 330 * np.arange(n) / fs)
    a = rng.standard_normal(n) * 0.3
    refs = np.zeros((2, 2, n))
    if panned:  # vocals hard-left, accompaniment hard-right
        refs[0, 0], refs[1, 1] = v, a
    else:
        refs[0] = [0.9 * v, 0.4 * v]
        refs[1] = [0.3 * a, 0.8 * a]
    ests = refs + 0.01 * rng.standard_normal(refs.shape)
    ests[0, 0] += 0.3 * a
    want = jax_eval.bss_eval_stereo(refs, ests, flen=32)
    got = port_eval.bss_eval_stereo(refs, ests, flen=32, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_DB)


def test_sdr_only_matches_jax(rng):
    src = _tone_noise(rng)
    for ref, est in ((src[0], src[0] + 0.1 * src[1]), (src[1], 0.5 * src[1])):
        assert abs(port_eval.sdr_only(ref, est, device="cpu")
                   - jax_eval.sdr_only(ref, est)) <= TOL_DB
    assert port_eval.sdr_only(np.zeros(100), np.ones(100), device="cpu") == float("-inf")


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_oracle_stems_matches_jax(rng, p):
    t = dict(fs=8000, frame_size=256, hop_size=128)
    jp = jax_get_preset("ikala")
    jp = dataclasses.replace(jp, transform=JaxTransformConfig(**t))
    pp = get_preset("ikala")
    pp = dataclasses.replace(pp, transform=TransformConfig(**t))
    n = 8000 * 2
    stems = np.stack([np.sin(2 * np.pi * 440 * np.arange(n) / 8000),
                      0.3 * rng.standard_normal(n)]).astype(np.float32)
    mix = stems.sum(0)
    want = jax_eval.oracle_stems(mix, stems, jp, p=p)
    got = port_eval.oracle_stems(mix, stems, pp, p=p, device="cpu")
    assert got.shape == want.shape == (2, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_ORACLE * np.abs(want).max())
