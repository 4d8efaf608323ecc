"""The fused forward STFT (``analysis="ct_pallas"``), port against
reference, on CPU: the port's ``stft_ct_pallas`` on CPU tensors (its plain
version) against JAX's ``stft_ct_pallas`` in Pallas interpret mode, the
shape rule ``ct_stft_supported`` and the routing rule ``resolve_analysis``.

Tolerance: 2e-5 × max|X| (the reference kernel's own test against the
matmul chain): the two sum in other orders, and at 4096 points the spectra
reach |X| ≈ 40."""

import numpy as np
import pytest
import torch

from convsep_tpu.dsp.pallas import ct_stft_kernel as jct
from convsep_tpu_torch.dsp.cuda import ct_stft_kernel as tct
from convsep_tpu_torch.dsp.windows import sinebell


@pytest.mark.parametrize("nfft,L,B", [(4096, 3 * 4096, 1), (4096, 12 * 4096 - 5, 2),
                                      (2048, 5 * 4096 + 17, 1), (2048, 9 * 4096, 3)])
def test_plain_matches_jax_interpret(rng, nfft, L, B):
    w = sinebell(nfft)
    sig = (0.1 * rng.standard_normal((B, L))).astype(np.float32)
    want = [np.asarray(a) for a in jct.stft_ct_pallas(sig, w, 1024, nfft=nfft, interpret=True)]
    got = [a.numpy() for a in tct.stft_ct_pallas(torch.from_numpy(sig), w, 1024, nfft=nfft)]
    nf = -(-L // 1024) + 2
    assert got[0].shape == want[0].shape == (B, nf, nfft // 2)
    assert got[2].shape == want[2].shape == (B, nf)
    scale = np.abs(want[0]).max()
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, x, atol=2e-5 * scale, rtol=0)
    r1, i1, n1 = tct.stft_ct_pallas(torch.from_numpy(sig[0]), w, 1024, nfft=nfft)
    assert r1.shape == (nf, nfft // 2) and n1.shape == (nf,)
    np.testing.assert_array_equal(r1.numpy(), got[0][0])


def test_split_is_the_matmul_spectrum(rng):
    """re/im are stft_matmul's bins below Nyquist, ny its Nyquist bin."""
    from convsep_tpu_torch.dsp.dft import stft_matmul

    w = sinebell(4096)
    x = torch.from_numpy((0.1 * rng.standard_normal(20000)).astype(np.float32))
    re, im, ny = tct.stft_ct_pallas(x, w, 1024)
    fr, fi = stft_matmul(x, w, 1024)
    assert torch.equal(re, fr[..., :2048]) and torch.equal(im, fi[..., :2048])
    assert torch.equal(ny, fr[..., 2048])


@pytest.mark.parametrize("nfft", [512, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("hop", [128, 256, 512, 1024, 2048, 3072])
@pytest.mark.parametrize("win", ["same", "half"])
def test_supported_matches_jax(nfft, hop, win):
    w = nfft if win == "same" else nfft // 2
    assert tct.ct_stft_supported(nfft, w, hop) == jct.ct_stft_supported(nfft, w, hop)


@pytest.mark.parametrize("analysis", ["auto", "matmul", "ct_pallas"])
def test_resolve_analysis_matches_jax(analysis):
    want = jct.resolve_analysis(analysis, "auto", 4096, 4096, 1024, 1.0)
    assert tct.resolve_analysis(analysis) == want


def test_refusals():
    with pytest.raises(ValueError, match="unknown analysis"):
        tct.resolve_analysis("fft")
    with pytest.raises(ValueError, match="unsupported"):
        tct.stft_ct_pallas(torch.zeros(4096), sinebell(1024), 256)
    with pytest.raises(ValueError, match="unsupported"):
        tct.stft_ct_pallas(torch.zeros(9000), sinebell(4096), 512)
    assert tct.kernel_supported(4096, 1024) and tct.kernel_supported(8192, 1024)
    assert tct.kernel_supported(16384, 1024)  # the reference's largest: a thread-block cluster
    assert not tct.kernel_supported(32768, 1024) and not tct.kernel_supported(12288, 1024)


@pytest.mark.parametrize("hop,B,L", [(4096, 1, 5 * 4096 + 7), (2048, 2, 3 * 4096)])
def test_plain_matches_jax_interpret_at_16384(rng, hop, B, L):
    """At the reference kernel's largest size, 16 384 points (on the card a
    thread-block cluster of 4 blocks), within 1e-5 × max|X| of JAX's
    stft_ct_pallas in interpret mode."""
    nfft = 16384
    w = sinebell(nfft)
    sig = (0.1 * rng.standard_normal((B, L))).astype(np.float32)
    want = [np.asarray(a) for a in jct.stft_ct_pallas(sig, w, hop, nfft=nfft, interpret=True)]
    got = [a.numpy() for a in tct.stft_ct_pallas(torch.from_numpy(sig), w, hop, nfft=nfft)]
    nf = -(-L // hop) + 2
    assert got[0].shape == want[0].shape == (B, nf, nfft // 2)
    assert got[2].shape == want[2].shape == (B, nf)
    scale = max(np.abs(a).max() for a in want)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, x, atol=1e-5 * scale, rtol=0)
