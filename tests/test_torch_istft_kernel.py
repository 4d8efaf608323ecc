"""The iSTFT kernel's two wrappers, port against reference, on CPU: the
port's ``istft_ct_pallas`` and ``istft_pallas`` (their plain versions, as
CPU tensors take) against the JAX Pallas kernels in interpret mode, on the
same numpy spectra; and which route ``istft_matmul`` and the masked
synthesis take on each device and shape.

Tolerances: float32 1e-5 absolute on signals in [-1, 1] (the reference
kernel tests' bound), int16 within ±1 LSB (round-to-nearest of float32
values that differ in the last bits)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.dsp import dft as jdft
from convsep_tpu.dsp.pallas.ct_istft_kernel import ct_pallas_supported as jax_ct_supported
from convsep_tpu.dsp.pallas.ct_istft_kernel import istft_ct_pallas as jax_istft_ct_pallas
from convsep_tpu.dsp.pallas.istft_kernel import istft_pallas as jax_istft_pallas
from convsep_tpu.dsp.windows import sinebell
from convsep_tpu_torch.dsp import dft as tdft
from convsep_tpu_torch.dsp.cuda import ct_istft_kernel as tct
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas, istft_supported
from convsep_tpu_torch.dsp.stft import num_frames

CUDA = torch.device("cuda")  # a device name only: routing is decided from it
CPU = torch.device("cpu")


def _spectra(rng, lead, length, nfft, hop, win=None):
    """Masked STFT halves of a random signal, (*lead, nf, nfft//2 + 1)."""
    w = sinebell(win or nfft)
    x = (0.3 * rng.standard_normal((*lead, length))).astype(np.float32)
    re, im = jdft.stft_matmul(x, w, hop, nfft=nfft, precision="highest")
    mask = rng.uniform(0.0, 1.0, re.shape).astype(np.float32)
    return w, np.asarray(re) * mask, np.asarray(im) * mask


def _check(got, want, out):
    assert got.shape == want.shape and got.dtype == want.dtype
    if out == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("lead", [(3,), (2, 2), ()])
@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_ct_pallas_matches_jax(rng, lead, out):
    length, nfft, hop = 3000, 256, 64
    w, re, im = _spectra(rng, lead, length, nfft, hop)
    want = np.asarray(jax_istft_ct_pallas(re, im, w, hop, length, interpret=True,
                                          output_dtype=out))
    got = tct.istft_ct_pallas(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                              output_dtype=out).numpy()
    assert got.shape == (*lead, length)
    _check(got, want, out)


@pytest.mark.parametrize(
    "lead,nfft,win,hop",
    [((3,), 256, 256, 64), ((), 128, 128, 64), ((2,), 256, 128, 32), ((4,), 64, 64, 8),
     ((2,), 768, 768, 256),     # 3 · 256: the split run backwards on the card
     ((2,), 1000, 1000, 250),   # Bluestein run backwards on the card
     # the same on the 16 384-point level: 7 · 1024 (the reference's
     # large-window path needs win and hop multiples of 256, so not 6000)
     ((2,), 7168, 7168, 1792)],
)
def test_istft_pallas_matches_jax(rng, lead, nfft, win, hop):
    length = 2500
    w, re, im = _spectra(rng, lead, length, nfft, hop, win)
    want = np.asarray(jax_istft_pallas(re, im, w, hop, length, nfft=nfft, interpret=True))
    got = istft_pallas(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                       nfft=nfft).numpy()
    assert got.shape == (*lead, length)
    _check(got, want, "float32")


@pytest.mark.parametrize("nfft,hop,out", [(16384, 2048, "float32"), (32768, 4096, "int16")])
def test_istft_ct_pallas_matches_jax_past_8192(rng, nfft, hop, out):
    """The reference's two sizes past the FFT core, which the card runs on
    the direct transform over a cluster of 2 and 4 blocks: the port's
    ``istft_ct_pallas`` (its plain version, as CPU tensors take) against
    the JAX kernel in interpret mode on the same random spectra of 2
    signals of 3 · nfft samples, float32 within 1e-5 × max|out|, PCM16
    within ±1 LSB."""
    length = 3 * nfft
    nf = num_frames(length, hop)
    bins = nfft // 2 + 1
    re = (0.01 * rng.standard_normal((2, nf, bins))).astype(np.float32)
    im = (0.01 * rng.standard_normal((2, nf, bins))).astype(np.float32)
    w = sinebell(nfft)
    assert tct.ct_pallas_supported(nfft, nfft, hop) and jax_ct_supported(nfft, nfft, hop)
    want = np.asarray(jax_istft_ct_pallas(re, im, w, hop, length, interpret=True,
                                          output_dtype=out))
    got = tct.istft_ct_pallas(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                              output_dtype=out).numpy()
    assert got.shape == want.shape == (2, length) and got.dtype == want.dtype
    if out == "int16":
        assert (want != 0).any()
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_istft_wrappers_refuse_like_jax():
    w = sinebell(128)
    z = np.zeros((10, 65), np.float32)
    with pytest.raises(ValueError, match="unsupported"):
        jax_istft_ct_pallas(z, z, w, 64, 500, interpret=True)
    with pytest.raises(ValueError, match="unsupported"):
        tct.istft_ct_pallas(torch.from_numpy(z), torch.from_numpy(z), w, 64, 500)
    zt = torch.zeros(10, 129)
    with pytest.raises(ValueError, match="win % hop"):
        istft_pallas(zt, zt, sinebell(256), 100, 1000)
    with pytest.raises(ValueError, match="up to 9"):
        istft_pallas(zt, zt, sinebell(256), 16, 1000)
    with pytest.raises(ValueError, match="frames"):
        istft_pallas(torch.zeros(5, 129), torch.zeros(5, 129), sinebell(256), 128, 44100)
    with pytest.raises(ValueError, match="frames"):
        tct.istft_ct_pallas(torch.zeros(5, 129), torch.zeros(5, 129), sinebell(256), 64, 44100)


@pytest.mark.parametrize("nfft", [64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                                  1000, 3072])
@pytest.mark.parametrize("ratio", [1, 2, 4, 8, 9, 16])
def test_ct_pallas_supported_equals_jax(nfft, ratio):
    hop = max(1, nfft // ratio)
    assert tct.ct_pallas_supported(nfft, nfft, hop) == jax_ct_supported(nfft, nfft, hop)
    assert not tct.ct_pallas_supported(nfft, nfft // 2, hop)


def test_istft_routes():
    """"auto" takes the iSTFT kernel only for CUDA tensors where the
    reference's TPU rule holds (factored, ct_pallas_supported); the masked
    synthesis names the iSTFT its plain chain will reach."""
    r = tdft.resolve_istft
    assert r("auto", 4096, 4096, 1024, CPU) == "factored"
    assert r("auto", 4096, 4096, 1024, CUDA) == "ct_pallas"
    assert r("auto", 2048, 2048, 1024, CUDA) == "ct_pallas"
    assert r("auto", 4096, 4096, 1000, CUDA) == "factored"  # win % hop != 0
    assert r("auto", 1024, 1024, 512, CUDA) == "direct"      # the reference's factored switch
    assert r("factored", 4096, 4096, 1024, CUDA) == "factored"
    assert r("direct", 4096, 4096, 1024, CUDA) == "direct"
    assert r("ct_pallas", 256, 256, 64, CPU) == "ct_pallas"
    with pytest.raises(ValueError):
        r("bogus", 4096, 4096, 1024, CUDA)
    m = tdft.resolve_masked_synthesis
    assert m("auto", 4096, 4096, 1024, 1.0, CUDA) == "ct_pallas_wiener"
    assert m("auto", 4096, 4096, 1024, 1.5, CUDA) == "ct_pallas"  # p outside {1, 2}
    assert m("auto", 4096, 4096, 1024, 1.5, CPU) == "factored"
    assert m("auto", 1024, 1024, 512, 1.5, CUDA) == "direct"
    assert m("ct_pallas", 4096, 4096, 1024, 1.0, CPU) == "ct_pallas"
    assert istft_supported(4096, 4096, 1024) and istft_supported(1024, 1024, 512)
    assert istft_supported(384, 384, 96)  # 3 · 128: the split run backwards
    assert istft_supported(1000, 1000, 250)  # even, off the split: Bluestein
    assert istft_supported(10_000, 10_000, 2500)  # past 8192: Bluestein on a cluster
    assert istft_supported(255, 255, 85)  # odd: Bluestein run backwards, no Nyquist bin
    assert not istft_supported(256, 512, 128)  # a window past nfft
    assert not istft_supported(4096, 4096, 1000)


@pytest.mark.parametrize("out", ["float32", "int16"])
def test_istft_matmul_ct_pallas_matches_jax(rng, out):
    """An explicit "ct_pallas" through ``istft_matmul``: the JAX package
    runs its kernel (interpret mode on CPU), the port its wrapper."""
    length, nfft, hop = 2000, 256, 64
    w, re, im = _spectra(rng, (2,), length, nfft, hop)
    want = np.asarray(jdft.istft_matmul(jnp.asarray(re), jnp.asarray(im), w, hop, length,
                                        algorithm="ct_pallas", output_dtype=out))
    got = tdft.istft_matmul(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                            algorithm="ct_pallas", output_dtype=out).numpy()
    _check(got, want, out)


@pytest.mark.parametrize("nfft,hop,lead", [(1001, 143, (2,)), (999, 333, ())])
def test_odd_istft_pallas_matches_jax(rng, nfft, hop, lead):
    """An odd nfft (no Nyquist bin: the reference's inverse matrices weight
    the last bin 2, as every bin but DC), which the reference's
    ``istft_pallas`` admits (win % hop == 0, win/hop <= 9) and whose card
    route is Bluestein run backwards: the port's plain version against the
    JAX kernel in interpret mode on the same spectra, within 2e-6 ×
    max|y|, and the card's envelope takes the shape."""
    length = 4 * nfft
    w, re, im = _spectra(rng, lead, length, nfft, hop)
    assert re.shape[-1] == nfft // 2 + 1
    want = np.asarray(jax_istft_pallas(re, im, w, hop, length, nfft=nfft, interpret=True))
    got = istft_pallas(torch.from_numpy(re), torch.from_numpy(im), w, hop, length,
                       nfft=nfft).numpy()
    assert got.shape == want.shape == (*lead, length)
    np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(want).max(), rtol=0)
    assert istft_supported(nfft, nfft, hop)
