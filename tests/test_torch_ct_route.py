"""The ``analysis="ct_pallas"`` separation route, port against reference,
on CPU: a 4096-point, hop-1024 preset cut in width (as
tests/test_ct_stft_pallas.py builds it) through ``separate_fused_batch``
with the forward STFT kernel and the Nyquist-separate Wiener+iSTFT kernel
(their plain versions here; Pallas interpret mode in JAX), within 1e-5
absolute on the stems; and the ``ny`` input of the masked synthesis equal
to the concatenated spectrum's.

The preset runs at ``wiener_eps`` 1e-3: with random weights some bins
have every source's y near 0, where the ratio at the default 1e-8 turns
the two packages' f32 rounding into O(1) mask changes (up to 2.7e-5 on
the stems with both fed the very same spectra); at 1e-3 the routes read
1e-6 apart over five seeds, and the test reads the route, not that
chaos."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs.presets import get_preset as jax_get_preset
from convsep_tpu.models.convsep import ConvSep as JaxConvSep
from convsep_tpu.separate.pipeline import separate_fused_batch as jax_separate_fused_batch
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain
from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas
from convsep_tpu_torch.dsp.dft import istft_wiener
from convsep_tpu_torch.dsp.windows import sinebell
from convsep_tpu_torch.models import ConvSep
from convsep_tpu_torch.separate import separate_fused_batch, source_magnitudes


def _preset(analysis, synth):
    base = jax_get_preset("highres4096")
    model = dataclasses.replace(
        base.model, conv1_filters=4, conv1_freq=8, conv2_filters=4,
        bottleneck=8, time_context=10, mask_dtype="float32",
        decoder_impl="bandconv",
    )
    return dataclasses.replace(
        base, model=model, sep=dataclasses.replace(base.sep, segment_bucket=1, wiener_eps=1e-3),
        transform=dataclasses.replace(base.transform, analysis=analysis,
                                      masked_synthesis=synth),
    )


@pytest.fixture(scope="module")
def case():
    jp = _preset("ct_pallas", "ct_pallas_wiener")
    L = 10 * jp.model.time_context * jp.transform.hop_size
    mix = (0.1 * np.random.default_rng(0).standard_normal((2, L))).astype(np.float32)
    params = JaxConvSep(jp.model).init(
        jax.random.PRNGKey(0),
        np.zeros((1, jp.model.time_context, jp.model.feat_size, 1), np.float32),
    )
    return jp, params, mix, L


@pytest.mark.parametrize("out", ["float32", "int16"])
def test_ct_route_matches_jax(case, out):
    jp, params, mix, L = case
    want = np.asarray(jax_separate_fused_batch(params, jnp.asarray(mix), None, jp, L, None,
                                               out, False))
    pp = preset_from_dict(dataclasses.asdict(jp))
    model = ConvSep(pp.model, from_jax_params(params, pp.model)).prepare_inference()
    got = separate_fused_batch(model, torch.from_numpy(mix), pp, L, output_dtype=out).numpy()
    assert got.shape == want.shape == (2, 4, L) and got.dtype == want.dtype
    if out == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_ct_route_matches_matmul_route(case):
    """The route's stems against the port's matmul route (the same
    function; the reference's own pipeline test holds it at 5e-4 × peak)."""
    jp, params, mix, L = case
    stems = {}
    for analysis, synth in (("ct_pallas", "ct_pallas_wiener"), ("matmul", "factored")):
        pp = preset_from_dict(dataclasses.asdict(_preset(analysis, synth)))
        model = ConvSep(pp.model, from_jax_params(params, pp.model)).prepare_inference()
        stems[analysis] = separate_fused_batch(model, torch.from_numpy(mix), pp, L).numpy()
        y, re, im, ny = source_magnitudes(model, torch.from_numpy(mix), pp)
        assert (ny is None) == (analysis == "matmul")
        assert re.shape[-1] == (2048 if ny is not None else 2049) and y.shape[-1] == 2049
    scale = np.abs(stems["matmul"]).max()
    np.testing.assert_allclose(stems["ct_pallas"], stems["matmul"], atol=5e-4 * scale, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"p": 2.0}, {"conserve_last": True},
                                {"output_dtype": "int16"}])
def test_ny_input_equals_concatenated(rng, kw):
    w = sinebell(4096)
    x = torch.from_numpy((0.1 * rng.standard_normal((2, 30000))).astype(np.float32))
    re, im, ny = stft_ct_pallas(x, w, 1024)
    y = torch.from_numpy(np.abs(rng.standard_normal((2, 3, re.shape[1], 2049))).astype(np.float32))
    full_re = torch.cat([re, ny[..., None]], -1)
    full_im = torch.cat([im, torch.zeros_like(ny)[..., None]], -1)
    got = wiener_istft(y, re, im, w, 1024, 30000, ny=ny, **kw)
    want = wiener_istft_plain(y, full_re, full_im, w, 1024, 30000, **kw)
    assert torch.equal(got, want)
    assert torch.equal(istft_wiener(y, re, im, w, 1024, 30000, ny=ny, **kw), want)
    with pytest.raises(ValueError, match="Nyquist"):
        wiener_istft(y[..., :2048], re, im, w, 1024, 30000, ny=ny)
    with pytest.raises(ValueError, match="without bins"):
        wiener_istft(y, re, im, w, 1024, 30000, ny=ny[:, :-1])
