"""The banded time-stage decode (``decoder_impl="band_pallas"``) and the
two-stage ``band`` decode, port against reference, on CPU:

* ``band_tensor`` exactly equal to JAX's;
* the port's ``band_decode_pallas`` on CPU tensors (its plain version)
  against JAX's kernel in Pallas interpret mode on the same z: both round z
  and the band to bf16 and sum in f32, so they differ by the f32 sums'
  order, 1e-5 × max|out|;
* ``ConvSep`` with ``decoder_impl`` "band" and "band_pallas" against the
  JAX model on the same weights and input, 1e-5 × max|y|. "band_pallas"
  rounds the expansion z = relu(fc @ K + b) to bf16, and the two packages'
  f32 z differ in the last bits, so some elements round one bf16 ulp
  apart (~0.4 % of them here, up to 4.6e-4 × max|y| downstream). That
  route is held at 1e-5 with a bf16-exact expansion (K = 0, b in bf16,
  the same z in both), and at 2^-7 × max|y| with random weights."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.models import ConvSepConfig as JaxConfig
from convsep_tpu.models import decoder_pallas as jdp
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.models import ConvSep, ConvSepConfig
from convsep_tpu_torch.models import convsep as tconv
from convsep_tpu_torch.models import decoder_band_cuda as tdb

# (kh, I, O, T): the multires4096 time stage (15, 50, 50, 30) cut in width
BANDS = [(15, 7, 5, 30), (5, 3, 3, 10), (1, 2, 6, 8), (4, 6, 4, 12)]


@pytest.mark.parametrize("kh,I,O,T", BANDS)
def test_band_tensor_equals_jax(rng, kh, I, O, T):
    k = (0.2 * rng.standard_normal((kh, 1, I, O))).astype(np.float32)
    want = np.asarray(jdp.band_tensor(jnp.asarray(k), T))
    got = tdb.band_tensor(torch.from_numpy(k), T).numpy()
    assert got.shape == want.shape == (T - kh + 1, O, T * I)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kh,I,O,T", BANDS)
@pytest.mark.parametrize("N,W", [(3, 13), (2, 8)])
def test_plain_matches_jax_interpret(rng, kh, I, O, T, N, W):
    Tp = T - kh + 1
    z = np.maximum(rng.standard_normal((N, Tp, W, O)), 0).astype(np.float32)
    k = (0.2 * rng.standard_normal((kh, 1, I, O))).astype(np.float32)
    want = np.asarray(jdp.band_decode_pallas(jnp.asarray(z), jnp.asarray(k), T, interpret=True))
    got = tdb.band_decode_pallas(torch.from_numpy(z), torch.from_numpy(k), T)
    assert got.dtype == torch.float32 and got.shape == want.shape == (N, W, T * I)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_plain_rounds_operands_to_bf16(rng):
    """The plain version is the f32 product of bf16-rounded operands (so a
    float32 decode differs from it at bf16 resolution)."""
    z = torch.from_numpy(rng.standard_normal((2, 9, 4 * 3)).astype(np.float32))
    band = tdb.band_tensor(torch.from_numpy(rng.standard_normal((3, 1, 2, 3)).astype(np.float32)), 6)
    got = tdb.band_decode_wmajor(z, band, 6)
    want = z.to(torch.bfloat16).double() @ band.to(torch.bfloat16).double().reshape(12, 12)
    torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=0)
    assert (got - z @ band.reshape(12, 12)).abs().max() > 1e-4
    with pytest.raises(ValueError, match="align"):
        tdb.band_decode_wmajor(z, band, 5)


# tests/test_model.py's band configs, and the multires4096 geometry cut in
# width (3 input channels, stride 4, T 30, Tp 16)
MODELS = {
    "s2": dict(time_context=12, feat_size=65, channels_in=1, num_sources=3, conv1_filters=6,
               conv1_freq=9, conv1_freq_stride=2, conv2_filters=5, conv2_time=5, bottleneck=16),
    "s3": dict(time_context=12, feat_size=64, channels_in=1, num_sources=3, conv1_filters=6,
               conv1_freq=9, conv1_freq_stride=3, conv2_filters=5, conv2_time=5, bottleneck=16),
    "multires": dict(time_context=30, feat_size=129, channels_in=3, num_sources=4,
                     conv1_filters=6, conv1_freq=9, conv1_freq_stride=4, conv2_filters=5,
                     bottleneck=16),
}


def _run_both(rng, shape, impl, mask_dtype, exact_z):
    """(port outputs unprepared and prepared, JAX output) on one input."""
    kw = dict(MODELS[shape], decoder_impl=impl, mask_dtype=mask_dtype)
    jcfg, tcfg = JaxConfig(**kw), ConvSepConfig(**kw)
    x = np.abs(rng.standard_normal((3, jcfg.time_context, jcfg.feat_size,
                                    jcfg.channels_in))).astype(np.float32)
    params = JaxConvSep(jcfg).init(jax.random.PRNGKey(1), jnp.asarray(x))
    if exact_z:
        fe = params["params"]["fc_expand"]
        bias = np.asarray(fe["bias"]) + rng.standard_normal(fe["bias"].shape).astype(np.float32)
        bias = np.asarray(jnp.asarray(bias).astype(jnp.bfloat16).astype(jnp.float32))
        fe = {"kernel": jnp.zeros_like(fe["kernel"]), "bias": jnp.asarray(bias)}
        params = {**params, "params": {**params["params"], "fc_expand": fe}}
    want = np.asarray(JaxConvSep(jcfg).apply(params, jnp.asarray(x), method=JaxConvSep.sources)
                      .astype(jnp.float32))
    model = ConvSep(tcfg, from_jax_params(params, tcfg))
    unprepared = model.sources(torch.from_numpy(x))
    got = model.prepare_inference().sources(torch.from_numpy(x))
    assert "fc_expand_kernel" in dict(model.named_parameters())
    assert not hasattr(model, "k4")
    for out in (unprepared, got):
        assert out.dtype == getattr(torch, mask_dtype) and out.shape == want.shape
    return (unprepared, got), want


@pytest.mark.parametrize("shape", sorted(MODELS))
@pytest.mark.parametrize("impl", ["band", "band_pallas"])
@pytest.mark.parametrize("mask_dtype", ["float32", "bfloat16"])
def test_convsep_band_routes_match_jax(rng, shape, impl, mask_dtype):
    outs, want = _run_both(rng, shape, impl, mask_dtype, exact_z=impl == "band_pallas")
    scale = float(np.abs(want).max())
    assert scale > 0
    for out in outs:
        if mask_dtype == "float32":
            np.testing.assert_allclose(out.numpy(), want, atol=1e-5 * scale, rtol=0)
        else:  # rounded to bf16 twice (cast, + out_bias): one ulp apart at most
            np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                                       atol=1e-6 * scale)


@pytest.mark.parametrize("shape", sorted(MODELS))
def test_convsep_band_pallas_random_expansion_matches_jax(rng, shape):
    outs, want = _run_both(rng, shape, "band_pallas", "float32", exact_z=False)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, atol=2 ** -7 * np.abs(want).max(), rtol=0)


def test_band_routes_resolve_and_refuse_training():
    cfg = ConvSepConfig(**MODELS["s2"])
    for impl in ("band", "band_pallas"):
        c = dataclasses.replace(cfg, decoder_impl=impl)
        assert tconv.resolve_decoder_impl(c, torch.device("cpu")) == impl
        assert tconv.trainable_config(c).decoder_impl in ("band", "bandconv")
        with pytest.raises(NotImplementedError, match="bandconv"):
            ConvSep(tconv.trainable_config(c))
