"""The STFT and iSTFT past 8192 points, port against reference, on CPU: the
port's ``stft_pallas`` and ``istft_pallas`` (their plain versions, as CPU
tensors take; on a card these sizes run Bluestein on a thread-block
cluster, ``stft_cluster`` / ``istft_cluster``, or the iSTFT's mixed
cluster at its 7-smooth sizes) against the JAX package's ``stft_pallas``
and ``istft_pallas`` in Pallas interpret mode, or its factored
``istft_matmul`` where the reference kernel takes no such window, on the
same numpy inputs.

Tolerances: spectra 1e-5 × the peak magnitude (float32 sums of an
8000-long DFT in another order), signals 2e-5 × the peak sample (the
inverse's sums of 4000 bins, then the overlap-add)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convsep_tpu.dsp.pallas import stft_pallas as jax_stft_pallas
from convsep_tpu.dsp.pallas.istft_kernel import istft_pallas as jax_istft_pallas
from convsep_tpu.dsp.windows import sinebell
from convsep_tpu_torch.dsp.cuda.fft_plan import cluster_blocks, cluster_supported
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas


@pytest.mark.parametrize("nfft,hop,lead,length", [
    (8200, 2050, (2,), 9000),   # M 32 768: a cluster of 4
    (8193, 8193, (), 12000),    # odd, the cluster's smallest size
    (8448, 2816, (2,), 9000),   # 33 · 256
])
def test_stft_past_8192_matches_jax(rng, nfft, hop, lead, length):
    assert cluster_supported(nfft) and cluster_blocks(nfft) == 4
    x = (0.3 * rng.standard_normal((*lead, length))).astype(np.float32)
    w = sinebell(nfft)
    re_j, im_j = (np.asarray(a) for a in jax_stft_pallas(jnp.asarray(x), w, hop,
                                                         interpret=True))
    re_t, im_t = stft_pallas(torch.from_numpy(x), w, hop)
    assert re_t.shape == re_j.shape == (*lead, -(-length // hop) + 2, nfft // 2 + 1)
    peak = max(np.abs(re_j).max(), np.abs(im_j).max())
    np.testing.assert_allclose(re_t.numpy(), re_j, atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(im_t.numpy(), im_j, atol=1e-5 * peak, rtol=0)


def test_istft_past_8192_matches_jax(rng):
    """W 8448 = 33 · 256, hop 2816: the reference kernel's large path takes
    a window and hop in whole 256-sample blocks; the port's kernel takes it
    on a cluster of 4 blocks."""
    nfft, hop, length = 8448, 2816, 12000
    assert cluster_supported(nfft) and cluster_blocks(nfft) == 4
    w = sinebell(nfft)
    x = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    re, im = (np.asarray(a) for a in jax_stft_pallas(jnp.asarray(x), w, hop, interpret=True))
    mask = rng.uniform(0.0, 1.0, re.shape).astype(np.float32)
    re, im = re * mask, im * mask
    want = np.asarray(jax_istft_pallas(jnp.asarray(re), jnp.asarray(im), w, hop, length,
                                       interpret=True))
    got = istft_pallas(torch.from_numpy(re), torch.from_numpy(im), w, hop, length).numpy()
    assert got.shape == want.shape == (2, length)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=0)


def _istft_mixed_matches_jax(rng, re, im, nfft, hop, length, algorithm):
    """The port's ``istft_pallas`` (its plain version, as CPU tensors take)
    against the JAX package's ``dft.istft_matmul`` on ``algorithm``'s chain,
    on the same masked spectra, within 1e-5 × the peak sample."""
    from convsep_tpu.dsp import dft as jdft

    w = sinebell(nfft)
    mask = rng.uniform(0.0, 1.0, re.shape).astype(np.float32)
    re, im = re * mask, im * mask
    want = np.asarray(jdft.istft_matmul(jnp.asarray(re), jnp.asarray(im), w, hop, length,
                                        nfft=nfft, algorithm=algorithm))
    got = istft_pallas(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                       nfft=nfft).numpy()
    assert got.shape == want.shape == (re.shape[0], length)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_istft_5smooth_past_8192_matches_jax(rng):
    """W 10 000, hop 2500: a 5-smooth size past 8192 (10 000 = 2 · 5000,
    5000 = 2^3 · 5^4), which the card runs on the mixed cluster where
    ``fft_plan.ISTFT_MIXED_WON`` holds it (else Bluestein's). The reference's
    ``istft_pallas`` takes no such window (its large path wants the window
    and hop in whole 256-sample blocks), so the JAX side is its
    ``dft.istft_matmul`` on the factored chain; the port's ``istft_pallas``
    (its plain version, as CPU tensors take) on the same masked spectra of
    2 signals of 12 000 samples, within 1e-5 × the peak sample."""
    from convsep_tpu.dsp import dft as jdft
    from convsep_tpu_torch.dsp.cuda.fft_plan import mixed_factors

    nfft, hop, length = 10_000, 2500, 12_000
    assert mixed_factors(nfft) == (2, 5000)
    x = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    re, im = (np.asarray(a) for a in jdft.stft_matmul(x, sinebell(nfft), hop,
                                                     precision="highest", algorithm="factored"))
    _istft_mixed_matches_jax(rng, re, im, nfft, hop, length, "factored")


@pytest.mark.parametrize("nfft,hop,length,factors", [
    (14_000, 3500, 16_000, (2, 7000)),  # 7000 = 2^3 · 5^3 · 7: a radix-7 pass
    (11_025, 2205, 16_000, (3, 3675)),  # 250 ms at 44.1 kHz: odd, a cluster of 3
])
def test_istft_7smooth_past_8192_matches_jax(rng, nfft, hop, length, factors):
    """The same at a 7-smooth size past 8192 (W 14 000, hop 3500; the odd W
    11 025, hop 2205, on a cluster of 3), which the card runs on the mixed
    cluster's radix-7 pass where ``fft_plan.ISTFT_MIXED_WON`` holds it. The
    JAX package's factored chain refuses 14 000 (its balanced factor 112
    does not divide 7000) and odd sizes, so its "auto" takes the direct one,
    as its ``istft_wiener`` does there; the
    spectra are numpy's FFT of the centred, windowed frames of 2 signals of
    16 000 samples (``stft_matmul``'s direct matrices are not needed),
    within 1e-5 × the peak sample."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import mixed_factors
    from convsep_tpu_torch.dsp.stft import num_frames

    assert mixed_factors(nfft) == factors
    x = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    nf = num_frames(length, hop)
    padded = np.concatenate([np.zeros((2, nfft // 2)), x, np.zeros((2, nfft))], axis=-1)
    spec = np.fft.rfft(np.stack([padded[:, f * hop:f * hop + nfft] for f in range(nf)], 1)
                       * sinebell(nfft))
    _istft_mixed_matches_jax(rng, spec.real.astype(np.float32), spec.imag.astype(np.float32),
                             nfft, hop, length, "auto")


def test_istft_on_three_blocks_matches_jax(rng):
    """W 22 050, hop 4410 (500 ms at 44.1 kHz): a 7-smooth size that the
    card runs on a cluster of 3 blocks of n 7350 where
    ``fft_plan.ISTFT_MIXED_WON`` holds it. The port's inverse DFT chain
    (``dsp.dft.istft_matmul``, the factored products its "auto" takes at
    this size; ``istft_pallas``'s plain version builds the direct matrices,
    twice 11 026 × 22 050 floats) against the JAX package's
    ``dft.istft_matmul`` on the same chain, on numpy's FFT of the centred,
    windowed frames of 2 signals of 24 000 samples, masked, within 1e-5 ×
    the peak sample."""
    from convsep_tpu.dsp import dft as jdft
    from convsep_tpu_torch.dsp.cuda.fft_plan import mixed_factors
    from convsep_tpu_torch.dsp.dft import istft_matmul
    from convsep_tpu_torch.dsp.stft import num_frames

    nfft, hop, length = 22_050, 4410, 24_000
    assert mixed_factors(nfft) == (3, 7350)
    x = (0.3 * rng.standard_normal((2, length))).astype(np.float32)
    nf = num_frames(length, hop)
    padded = np.concatenate([np.zeros((2, nfft // 2)), x, np.zeros((2, nfft))], axis=-1)
    spec = np.fft.rfft(np.stack([padded[:, f * hop:f * hop + nfft] for f in range(nf)], 1)
                       * sinebell(nfft))
    mask = rng.uniform(0.0, 1.0, spec.shape)
    re, im = (a.astype(np.float32) for a in (spec.real * mask, spec.imag * mask))
    w = sinebell(nfft)
    want = np.asarray(jdft.istft_matmul(jnp.asarray(re), jnp.asarray(im), w, hop, length,
                                        algorithm="factored"))
    got = istft_matmul(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                       algorithm="factored").numpy()
    assert got.shape == want.shape == (2, length)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
