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
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import (
    rows_per_block,
    wiener_istft,
    wiener_istft_supported,
)
from convsep_tpu_torch.dsp.windows import sinebell


def _mk(rng, S, length, nfft, hop, lead=()):
    w = sinebell(nfft)
    x = (0.3 * rng.standard_normal((*lead, length))).astype(np.float32)
    re, im = jax_stft(x, w, hop, nfft)
    nf = re.shape[-2]
    y = np.abs(rng.standard_normal((*lead, S, nf, nfft // 2 + 1))).astype(np.float32)
    y[..., : nf // 3, :8] = 0.0  # ReLU-dead patches: eps shortfall paths
    return w, np.array(re), np.array(im), y


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
    assert rows_per_block(4096, 1024, 4) == 8 and rows_per_block(1024, 512, 4) == 16
    assert rows_per_block(1000, 250, 4) == 16
    assert not wiener_istft_supported(8192, 8192, 8192, S=4)  # one row exceeds shared memory

