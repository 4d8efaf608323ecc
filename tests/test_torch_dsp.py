"""convsep_tpu_torch DSP, masks, segmentation and PCM against convsep_tpu
on the same numpy inputs. Bound: 1e-5, the JAX package's own stage bound
(BASELINE.json "Stage-level numerical fidelity"), in float32 on both."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.data import segment as jseg
from convsep_tpu.dsp import dft as jdft
from convsep_tpu.dsp import windows as jwin
from convsep_tpu.models import masks as jmasks
from convsep_tpu.utils import pcm as jpcm
from convsep_tpu_torch.data import segment as tseg
from convsep_tpu_torch.dsp import dft as tdft
from convsep_tpu_torch.dsp import istft as tistft
from convsep_tpu_torch.dsp import stft as tstft
from convsep_tpu_torch.dsp import windows as twin
from convsep_tpu_torch.models import masks as tmasks
from convsep_tpu_torch.utils import pcm as tpcm

# convsep_tpu.dsp re-exports functions named stft / istft over its modules
jistft = importlib.import_module("convsep_tpu.dsp.istft")
jstft = importlib.import_module("convsep_tpu.dsp.stft")

# time-domain signals: absolute; spectra: relative to the spectrum's peak
# (|X| reaches ~40 at 4096 points, where f32 sums differ by ~1 ulp)
ATOL = 1e-5


def _sig(rng, *shape):
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 256, 1024, 4096])
def test_windows_equal(n):
    np.testing.assert_array_equal(twin.sinebell(n), jwin.sinebell(n))
    np.testing.assert_array_equal(twin.hann(n), jwin.hann(n))


@pytest.mark.parametrize("length,win,hop", [(1000, 256, 64), (1023, 256, 128), (4097, 512, 128)])
def test_framing_equal(rng, length, win, hop):
    x = _sig(rng, 2, length)
    assert tstft.num_frames(length, hop) == jstft.num_frames(length, hop)
    assert tstft.padded_length(length, win, hop) == jstft.padded_length(length, win, hop)
    nf = tstft.num_frames(length, hop)
    got = tstft.frame_signal(tstft._pad_signal(torch.from_numpy(x), win, hop), win, hop, nf)
    want = jstft.frame_signal(jstft._pad_signal(jnp.asarray(x), win, hop), win, hop, nf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("iscale", ["lin", "log"])
def test_scale_magnitude(rng, iscale):
    m = np.abs(_sig(rng, 50))
    np.testing.assert_allclose(
        tstft.scale_magnitude(torch.from_numpy(m), iscale).numpy(),
        np.asarray(jstft.scale_magnitude(jnp.asarray(m), iscale)), rtol=1e-6,
    )


@pytest.mark.parametrize(
    "nfft,hop,algorithm",
    [(256, 64, "direct"), (256, 64, "factored"), (1024, 512, "auto"),
     (2048, 512, "auto"), (4096, 1024, "factored"), (512, 128, "direct")],
)
def test_stft_matmul(rng, nfft, hop, algorithm):
    x = _sig(rng, 2, 3 * nfft + 17)
    w = twin.sinebell(nfft)
    tre, tim = tdft.stft_matmul(torch.from_numpy(x), w, hop, algorithm=algorithm)
    jre, jim = jdft.stft_matmul(x, w, hop, precision="highest", algorithm=algorithm)
    scale = float(np.abs(np.asarray(jre)).max())
    np.testing.assert_allclose(tre.numpy(), np.asarray(jre), atol=ATOL * scale)
    np.testing.assert_allclose(tim.numpy(), np.asarray(jim), atol=ATOL * scale)


@pytest.mark.parametrize(
    "nfft,hop,algorithm,out",
    [(256, 64, "direct", "float32"), (256, 64, "factored", "float32"),
     (2048, 512, "auto", "float32"), (1024, 512, "auto", "int16"),
     (4096, 1024, "factored", "int16")],
)
def test_istft_matmul(rng, nfft, hop, algorithm, out):
    L = 3 * nfft + 17
    x = _sig(rng, 2, L)
    w = twin.sinebell(nfft)
    re, im = jdft.stft_matmul(x, w, hop, precision="highest")
    re, im = np.array(re), np.array(im)
    got = tdft.istft_matmul(torch.from_numpy(re), torch.from_numpy(im), w, hop, L,
                            algorithm=algorithm, output_dtype=out).numpy()
    want = np.asarray(jdft.istft_matmul(re, im, w, hop, L, precision="highest",
                                        algorithm=algorithm, output_dtype=out))
    assert got.dtype == want.dtype
    if out == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(got, x, atol=1e-5)  # perfect reconstruction


def test_ola_norm_and_overlap_add(rng):
    w = twin.sinebell(256)
    np.testing.assert_array_equal(tistft.ola_norm(w, w, 64, 37), jistft.ola_norm(w, w, 64, 37))
    frames = _sig(rng, 3, 11, 200)
    for hop in (50, 64, 200):
        np.testing.assert_allclose(
            tistft.overlap_add(torch.from_numpy(frames), hop).numpy(),
            np.asarray(jistft.overlap_add(jnp.asarray(frames), hop)), atol=1e-6,
        )


def test_segment_roundtrip(rng):
    m = _sig(rng, 2, 73, 9)
    got = tseg.segment_frames(torch.from_numpy(m), 10)
    want = jseg.segment_frames(jnp.asarray(m), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tseg.unsegment_frames(got, 73).numpy(), m)
    assert tseg.segment_count(5, 10) == jseg.segment_count(5, 10) == 1


@pytest.mark.parametrize("p,conserve", [(1.0, False), (2.0, False), (1.0, True), (1.5, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wiener_mask(rng, p, conserve, dtype):
    y = rng.standard_normal((3, 4, 20, 9)).astype(np.float32)
    y[:, :, :5] = 0.0
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    jy = jnp.asarray(y).astype(getattr(jnp, dtype))
    got = tmasks.wiener_mask(ty, p=p, axis=1, conserve_last=conserve)
    want = jmasks.wiener_mask(jy, p=p, axis=1, conserve_last=conserve)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    if conserve:
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-6)


def test_pcm16_round_to_nearest():
    x = np.array([0.0, 0.5 / 32768, 1.5 / 32768, -0.5 / 32768, 1.0, -1.0, 2.0,
                  -2.0, 0.3, -0.7], np.float32)
    got = tpcm.quantize_pcm16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpcm.quantize_pcm16(jnp.asarray(x))))
    np.testing.assert_array_equal(tpcm.quantize_pcm16_host(x), jpcm.quantize_pcm16_host(x))


def test_dispatch_rules():
    cpu = torch.device("cpu")
    assert tdft.resolve_masked_synthesis("auto", 4096, 4096, 1024, 1.0, cpu) == "factored"
    assert tdft.resolve_masked_synthesis("auto", 1024, 1024, 512, 1.0, cpu) == "direct"
    assert tdft.resolve_masked_synthesis("ct_pallas_wiener", 1024, 1024, 512, 1.0, cpu) == "ct_pallas_wiener"
    for n in (256, 1024, 2048, 4096):
        assert tdft._use_factored("auto", n) == jdft._use_factored("auto", n)
    with pytest.raises(NotImplementedError):
        tdft.check_precision("default")
    with pytest.raises(ValueError):
        tdft.resolve_masked_synthesis("bogus", 1024, 1024, 512, 1.0, cpu)
