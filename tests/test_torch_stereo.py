"""Stereo separation, port against reference, on CPU: the port's
``StereoSeparator`` (device="cpu", so every kernel wrapper takes its plain
version) against the JAX ``StereoSeparator`` with the same weights, on two
tiny stereo presets: the highres4096 shape (frame 256, hop 64, T 30,
stride 4; the fused decode's geometry at TM 240) and the tiny ikala one of
``tests/test_stereo.py``.

Tolerances: float32 stems 1e-5 absolute on a float32 mask tail (the
slice's stage bound), int16 within ±1 LSB; a stem derived on the host
(``complement_last``) within 1e-4 of the reference's conservative stem
(the STFT round trip)."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs.presets import stereo_preset
from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.separate.stereo import StereoSeparator as JaxStereoSeparator
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.separate import Separator, StereoSeparator, separate_fused_stereo, stereo
from tests.test_stereo import stereo_mix, tiny_stereo_preset
from tests.test_torch_slice import tiny_highres


def _jax_preset(name):
    if name == "highres":
        return stereo_preset(tiny_highres())
    p = tiny_stereo_preset()
    return dataclasses.replace(p, model=dataclasses.replace(p.model, mask_dtype="float32"))


@pytest.fixture(scope="module", params=["highres", "ikala"])
def case(request):
    jp = _jax_preset(request.param)
    cfg = jp.model
    params = JaxConvSep(cfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, cfg.time_context, cfg.feat_size, 2))
    )
    pp = preset_from_dict(dataclasses.asdict(jp))
    return jp, params, pp, from_jax_params(params, pp.model)


@pytest.fixture(scope="module")
def mix():
    return stereo_mix(seconds=1.1, seed=3)[1]  # (2, L)


def test_stereo_separator_matches_jax_f32(case, mix):
    jp, params, pp, state = case
    want = np.asarray(JaxStereoSeparator(jp, params)(mix.T))
    sep = StereoSeparator(pp, state, device="cpu")
    got = sep(mix.T)  # (L, 2) wav layout
    assert got.shape == want.shape == (pp.model.num_sources, mix.shape[1], 2)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(sep(mix), got)  # (2, L) layout


def test_stereo_separator_matches_jax_int16(case, mix):
    jp, params, pp, state = case
    kw = dict(output_dtype="int16", input_dtype="int16")
    want = np.asarray(JaxStereoSeparator(jp, params, **kw)(mix))
    got = StereoSeparator(pp, state, device="cpu", **kw)(mix)
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_stereo_kernel_route_wrapper_matches_jax(case, mix):
    """The iSTFT kernel's wrapper forced (``istft_matmul``'s "ct_pallas",
    its plain factored version on CPU) against the reference's default
    route."""
    jp, params, pp, state = case
    want = np.asarray(JaxStereoSeparator(jp, params)(mix))
    forced = functools.partial(stereo.istft_matmul, algorithm="ct_pallas")
    with mock.patch.object(stereo, "istft_matmul", forced):
        got = StereoSeparator(pp, state, device="cpu")(mix)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_stereo_ignores_masked_synthesis(case, mix):
    """As in the reference, ``masked_synthesis`` chooses the mono path's
    synthesis only: the stereo entry takes ``istft_matmul``'s "auto"."""
    _, _, pp, state = case
    want = StereoSeparator(pp, state, device="cpu")(mix)
    for algorithm in ("factored", "ct_pallas"):
        other = dataclasses.replace(
            pp, transform=dataclasses.replace(pp.transform, masked_synthesis=algorithm))
        np.testing.assert_array_equal(StereoSeparator(other, state, device="cpu")(mix), want)


def test_stereo_complement_last_against_conserve_last(case, mix):
    jp, params, pp, state = case
    conserve = np.asarray(JaxStereoSeparator(jp, params, conserve_last=True)(mix))
    complement = np.asarray(JaxStereoSeparator(jp, params, complement_last=True)(mix))
    got = StereoSeparator(pp, state, device="cpu", complement_last=True)(mix)
    np.testing.assert_allclose(got, complement, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:-1], conserve[:-1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[-1], conserve[-1], atol=1e-4, rtol=0)
    # the stems add back to the mixture (masks sum to 1)
    np.testing.assert_allclose(got.sum(0), mix.T, atol=1e-4)
    i16 = StereoSeparator(pp, state, device="cpu", complement_last=True,
                          output_dtype="int16", input_dtype="int16")(mix)
    want16 = np.asarray(JaxStereoSeparator(jp, params, complement_last=True,
                                           output_dtype="int16", input_dtype="int16")(mix))
    assert np.abs(i16.astype(np.int32) - want16.astype(np.int32)).max() <= 1


def test_stereo_entry_refuses_mono_and_mono_entry_refuses_stereo(case, mix):
    _, _, pp, state = case
    mono = dataclasses.replace(pp, model=dataclasses.replace(
        pp.model, channels_in=1, decoder_reduce="first"))
    with pytest.raises(ValueError, match="stereo preset"):
        StereoSeparator(mono, {}, device="cpu")
    sep = StereoSeparator(pp, state, device="cpu")
    with pytest.raises(ValueError, match="stereo preset"):
        separate_fused_stereo(sep.model, torch.zeros(2, 1024), mono, 1024)
    with pytest.raises(NotImplementedError, match="StereoSeparator"):
        Separator(pp, state, device="cpu")
    with pytest.raises(ValueError, match="2-channel"):
        sep(np.zeros((3, 500), np.float32))
    with pytest.raises(ValueError, match="stereo audio"):
        sep(np.zeros(500, np.float32))
    with pytest.raises(ValueError, match=">= 2 sources"):
        one = dataclasses.replace(pp, model=dataclasses.replace(pp.model, num_sources=1))
        StereoSeparator(one, {}, device="cpu", complement_last=True)
