"""The ``fft_impl="pallas"`` separation route, port against reference, on
CPU: the port's ``Separator`` (device="cpu": the STFT, Wiener mask and
iSTFT wrappers take their plain versions) against the JAX ``Separator``,
which runs the three Pallas kernels in interpret mode, on a tiny dsd100
preset with a float32 mask tail; the options the route refuses; and mono
``complement_last`` on the matmul route against the reference.

Tolerances: float32 stems 1e-5 absolute, int16 within ±1 LSB."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.data import sine_mixture
from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.separate import Separator as JaxSeparator
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.separate import Separator, bucket_length, separate_fused_batch
from tests.test_separate import tiny_preset


def _preset(fft_impl):
    p = tiny_preset("dsd100")
    return dataclasses.replace(
        p, transform=dataclasses.replace(p.transform, fft_impl=fft_impl),
        model=dataclasses.replace(p.model, mask_dtype="float32"),
    )


@pytest.fixture(scope="module")
def params():
    cfg = _preset("pallas").model
    return JaxConvSep(cfg).init(
        jax.random.PRNGKey(11), jnp.zeros((1, cfg.time_context, cfg.feat_size, 1))
    )


@pytest.fixture(scope="module")
def mix():
    return sine_mixture(4, 9000, fs=8000, seed=17)[1]


def _port(jp, params):
    pp = preset_from_dict(dataclasses.asdict(jp))
    return pp, from_jax_params(params, pp.model)


def test_pallas_route_matches_jax_f32(params, mix):
    jp = _preset("pallas")
    want = np.asarray(JaxSeparator(jp, params)(mix))
    pp, state = _port(jp, params)
    got = Separator(pp, state, device="cpu")(mix)
    assert got.shape == want.shape == (4, len(mix)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the same stems as the port's matmul route
    mm = Separator(*_port(_preset("matmul"), params), device="cpu")(mix)
    np.testing.assert_allclose(got, mm, atol=1e-5, rtol=0)


def test_pallas_route_matches_jax_int16(params, mix):
    jp = _preset("pallas")
    kw = dict(output_dtype="int16", input_dtype="int16")
    want = np.asarray(JaxSeparator(jp, params, **kw)(mix))
    got = Separator(*_port(jp, params), device="cpu", **kw)(mix)
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_pallas_route_refuses_conservative_masks(params):
    jp = _preset("pallas")
    pp, state = _port(jp, params)
    for kw in ({"conserve_last": True}, {"complement_last": True}):
        with pytest.raises(ValueError, match="conserve_last"):
            JaxSeparator(jp, params, **kw)
        with pytest.raises(ValueError, match="conserve_last"):
            Separator(pp, state, device="cpu", **kw)
    sep = Separator(pp, state, device="cpu")
    L = bucket_length(3000, pp)
    with pytest.raises(ValueError, match="separate_fused"):
        separate_fused_batch(sep.model, torch.zeros(1, L), pp, L)
    fft = dataclasses.replace(pp, transform=dataclasses.replace(pp.transform, fft_impl="fft"))
    with pytest.raises(NotImplementedError, match="fft_impl"):
        Separator(fft, state, device="cpu")


@pytest.mark.parametrize("out", ["float32", "int16"])
def test_mono_complement_last_matches_jax(params, mix, out):
    jp = _preset("matmul")
    kw = dict(output_dtype=out, input_dtype=out, complement_last=True)
    want = np.asarray(JaxSeparator(jp, params, **kw)(mix))
    got = Separator(*_port(jp, params), device="cpu", **kw)(mix)
    assert got.dtype == want.dtype and got.shape == want.shape
    if out == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.sum(0), mix, atol=1e-4)
