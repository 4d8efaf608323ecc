"""Fused Wiener+iSTFT (kernel A): the port's plain version against the JAX
Pallas kernel ``istft_ct_pallas_wiener`` in interpret mode, over the JAX
test's cases (tests/test_ct_istft_wiener.py, with shorter tracks that
still span two of its 64-frame blocks), at its atol 1e-5; int16 and bf16 y
are in tests/test_torch_wiener_kernel_bf16.py (a separate file so the two
interpret-mode sets run on separate test workers). The CUDA kernel itself is held against this plain version on a card
(tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.dsp.dft import stft_matmul as jax_stft
from convsep_tpu.dsp.pallas.ct_istft_kernel import istft_ct_pallas_wiener
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_supported
from convsep_tpu_torch.dsp.cuda.fft_plan import wiener_plan
from convsep_tpu_torch.dsp.windows import sinebell


def _mk(rng, S, length, nfft, hop, lead=()):
    w = sinebell(nfft)
    x = (0.3 * rng.standard_normal((*lead, length))).astype(np.float32)
    re, im = jax_stft(x, w, hop, nfft)
    nf = re.shape[-2]
    y = np.abs(rng.standard_normal((*lead, S, nf, nfft // 2 + 1))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0  # ReLU-dead patches: eps shortfall paths
    return w, np.array(re), np.array(im), y


def _mk_rfft(rng, S, length, nfft, hop):
    """_mk with the mixture's spectra from numpy's FFT of the centred,
    windowed frames: past 8192 points the JAX package's stft_matmul builds
    an nfft × (nfft/2 + 1) DFT matrix (about 7 s at 11 250 on one CPU
    core), which the test of the synthesis does not need."""
    from convsep_tpu_torch.dsp.stft import num_frames

    w = sinebell(nfft)
    x = (0.3 * rng.standard_normal(length)).astype(np.float32)
    nf = num_frames(length, hop)
    padded = np.concatenate([np.zeros(nfft // 2), x, np.zeros(nfft)])
    spec = np.fft.rfft(np.stack([padded[f * hop:f * hop + nfft] for f in range(nf)]) * w)
    y = np.abs(rng.standard_normal((S, nf, nfft // 2 + 1))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0  # ReLU-dead patches: eps shortfall paths
    return w, spec.real.astype(np.float32), spec.imag.astype(np.float32), y


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = [
    (256, 64, 4000, 4, {}),
    (256, 128, 7000, 2, {"p": 2.0}),
    (512, 128, 9000, 3, {"conserve_last": True}),
    (256, 64, 4000, 4, {"eps": 1e-4}),
]


@pytest.mark.parametrize("nfft,hop,length,S,kw", CASES)
def test_plain_matches_jax_kernel(rng, nfft, hop, length, S, kw):
    w, re, im, y = _mk(rng, S, length, nfft, hop)
    want = np.asarray(istft_ct_pallas_wiener(
        jnp.asarray(y), re, im, w, hop, length, nfft=nfft, interpret=True, **kw))
    got = wiener_istft(*_torch(y, re, im), w, hop, length, **kw).numpy()
    assert got.shape == (S, length) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_conserve_last_sums_to_mixture(rng):
    from convsep_tpu_torch.dsp.dft import istft_matmul

    w, re, im, y = _mk(rng, 4, 8000, 256, 64)
    tre, tim = _torch(re, im)
    stems = wiener_istft(torch.from_numpy(y), tre, tim, w, 64, 8000, conserve_last=True)
    mix = istft_matmul(tre, tim, w, 64, 8000)
    np.testing.assert_allclose(stems.sum(0).numpy(), mix.numpy(), atol=1e-4)


def test_rejects_bad_shapes(rng):
    w, re, im, y = _mk(rng, 2, 6000, 256, 64)
    ty, tre, tim = _torch(y, re, im)
    with pytest.raises(ValueError, match="sources axis"):
        wiener_istft(ty[..., :-1], tre, tim, w, 64, 6000)
    with pytest.raises(ValueError, match="frames"):
        wiener_istft(ty, tre, tim, w, 64, 7000)
    assert wiener_istft_supported(4096, 4096, 1024) and wiener_istft_supported(1024, 1024, 512)
    assert wiener_istft_supported(1000, 1000, 250)      # even, not a power of two
    assert not wiener_istft_supported(1001, 1001, 91)   # odd
    assert not wiener_istft_supported(1000, 1000, 300)  # nfft % hop != 0
    assert not wiener_istft_supported(1024, 512, 256)   # win != nfft
    assert wiener_plan(1, 4, 1442, 4096, 1024).groups == 2      # the FFT core
    assert wiener_plan(1, 4, 2882, 1000, 250).route == "bluestein"  # M 2048, one group
    assert wiener_plan(1, 4, 2882, 1000, 250).groups == 1
    assert wiener_plan(1, 4, 5170, 768, 256).route == "split"      # 3 · 256, two groups
    assert wiener_plan(1, 4, 5170, 768, 256).groups == 2
    assert wiener_istft_supported(8192, 8192, 8192)  # a block holds two sources, any S
    assert wiener_istft_supported(16384, 16384, 4096)  # past the core: a thread-block cluster
    assert wiener_istft_supported(32768, 32768, 4096) and wiener_istft_supported(10000, 10000, 2500)
    assert not wiener_istft_supported(65536, 65536, 16384)  # past the reference's 32 768
    assert wiener_plan(1, 4, 648, 16384, 2048).cluster == 2  # the direct transform's
    assert wiener_plan(1, 4, 648, 16384, 2048).route == "cluster_dit"
    assert wiener_plan(1, 4, 648, 10000, 2500).route == "cluster_mixed"  # C 2 of n 5000
    assert wiener_plan(1, 4, 648, 10000, 2500).cluster == 2
    assert wiener_plan(1, 4, 648, 14000, 3500).route == "cluster_mixed"  # C 2 of n 7000
    assert wiener_plan(1, 4, 648, 14000, 3500).cluster == 2
    assert wiener_plan(1, 4, 648, 22000, 5500).route == "cluster"  # a prime past 7: Bluestein's
    assert wiener_plan(1, 4, 648, 22000, 5500).cluster == 8


@pytest.mark.parametrize("nfft,hop,kw", [
    (768, 256, {}),                                   # the split's size (3 · 256)
    (768, 256, {"p": 2.0, "conserve_last": True}),
    (1000, 250, {}),                                  # Bluestein's (8 · 125)
    (1000, 250, {"p": 2.0, "conserve_last": True}),
    (10000, 2500, {}),                                # the mixed cluster's (C 2 of 5000)
    (10000, 2500, {"p": 2.0, "conserve_last": True}),
    (11250, 2250, {}),                                # an odd n: C 2 of 5625
    (11250, 2250, {"p": 2.0, "conserve_last": True}),
    (14000, 3500, {}),                                # a radix-7 pass: C 2 of 7000
    (14000, 3500, {"p": 2.0, "conserve_last": True}),
    (22050, 4410, {}),                                # 500 ms at 44.1 kHz: C 3 of 7350
    (22050, 4410, {"p": 2.0, "conserve_last": True}),
])
def test_istft_wiener_matches_jax_off_the_core(rng, nfft, hop, kw):
    """At the sizes the card takes on the split, on Bluestein and on the
    mixed cluster, which the reference kernel does not take (its own "auto"
    runs the XLA chain), the
    port's istft_wiener on CPU tensors against the JAX package's
    istft_wiener within 2e-4, float32 and PCM16 (±1 LSB)."""
    from convsep_tpu.dsp.dft import istft_wiener as jax_istft_wiener
    from convsep_tpu_torch.dsp.dft import istft_wiener

    S, length = 4, 12 * hop
    w, re, im, y = (_mk_rfft if nfft > 8192 else _mk)(rng, S, length, nfft, hop)
    for out in ("float32", "int16"):
        want = np.asarray(jax_istft_wiener(jnp.asarray(y), re, im, w, hop, length,
                                           output_dtype=out, **kw))
        got = istft_wiener(*_torch(y, re, im), w, hop, length, output_dtype=out, **kw).numpy()
        assert got.shape == want.shape == (S, length) and got.dtype == want.dtype
        if out == "int16":
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=2e-4)


# (kw, output dtype, through the ny input): the reference kernel at its
# 16 384 points, about 6 frames, 4 sources
CASES_16K = [({"p": 1.0}, "float32", False), ({"p": 2.0}, "int16", False),
             ({"p": 1.0, "conserve_last": True}, "float32", False),
             ({"p": 2.0, "conserve_last": True}, "float32", True)]


@pytest.mark.parametrize("kw,out,has_ny", CASES_16K)
def test_plain_matches_jax_kernel_at_16384(rng, kw, out, has_ny):
    """At the reference kernel's 16 384 points (which the port's card runs on
    a thread-block cluster), the port's wiener_istft on CPU tensors against
    istft_ct_pallas_wiener in interpret mode: float32 at the JAX tests' atol
    1e-5, PCM16 within one LSB; with ``ny`` both take the Nyquist-separate
    pair."""
    nfft, hop, length, S = 16384, 2048, 4 * 2048, 4
    w, re, im, y = _mk(rng, S, length, nfft, hop)
    assert re.shape[-2] == 6
    ny = None
    if has_ny:
        re, im, ny = re[..., :-1], im[..., :-1], re[..., -1]
    want = np.asarray(istft_ct_pallas_wiener(
        jnp.asarray(y), re, im, w, hop, length, nfft=nfft, interpret=True, output_dtype=out,
        ny=None if ny is None else jnp.asarray(ny), **kw))
    got = wiener_istft(*_torch(y, re, im), w, hop, length, output_dtype=out,
                       ny=None if ny is None else torch.from_numpy(np.ascontiguousarray(ny)),
                       **kw).numpy()
    assert got.shape == want.shape == (S, length) and got.dtype == want.dtype
    if out == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)

