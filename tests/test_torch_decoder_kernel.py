"""Fused decode (kernel B): the port's plain version against the JAX Pallas
kernel ``band_freq_decode_pallas`` in interpret mode, at the JAX test's
config (tests/test_decoder_fused_pallas.py) for B in {1, 7, 16} and
conv1_freq in {37, 65}, at its atol 1e-4. The CUDA kernel itself is held
against this plain version on a card (tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.models.convsep import band_freq_conv_kernel as jax_bfck
from convsep_tpu.models.decoder_fused_pallas import band_freq_decode_pallas
from convsep_tpu_torch.models.config import ConvSepConfig
from convsep_tpu_torch.models.decoder_fused_cuda import (
    band_freq_decode,
    fused_decode_supported,
    kernel_supported,
    prepare_operands,
    w_pad_rows,
)

CFG = ConvSepConfig(
    time_context=30, feat_size=129, channels_in=1, num_sources=3,
    conv1_filters=6, conv1_freq=9, conv1_freq_stride=4,
    conv2_filters=5, conv2_time=15, bottleneck=16,
)


def _operands(rng, cfg, B):
    """Random fc, fc_expand params and conv kernels → (numpy operands for
    JAX, the composed KC, W, TpC)."""
    S, J, W = cfg.num_sources, cfg.bottleneck, cfg.enc_freq
    TpC = cfg.enc_time * cfg.conv2_filters
    f32 = np.float32
    fc = np.maximum(rng.standard_normal((B, J)), 0).astype(f32)
    kernel = (0.2 * rng.standard_normal((J, S * W * TpC))).astype(f32)
    bias = (0.1 * rng.standard_normal(S * W * TpC)).astype(f32)
    k1 = (0.3 * rng.standard_normal((1, cfg.conv1_freq, 1, cfg.conv1_filters))).astype(f32)
    k2 = (0.3 * rng.standard_normal((cfg.conv2_time_eff, 1, cfg.conv1_filters,
                                     cfg.conv2_filters))).astype(f32)
    KC, ktaps, _, _ = jax_bfck(jnp.asarray(k2), jnp.asarray(k1), cfg.enc_time,
                               cfg.conv1_freq_stride)
    return fc, kernel, bias, np.asarray(KC), ktaps, W, TpC


@pytest.mark.parametrize("conv1_freq", [37, 65])
@pytest.mark.parametrize("B", [1, 7, 16])
def test_plain_matches_jax_kernel(rng, B, conv1_freq):
    cfg = dataclasses.replace(CFG, conv1_freq=conv1_freq)
    fc, kernel, bias, KC, ktaps, W, TpC = _operands(rng, cfg, B)
    S = cfg.num_sources
    want, W_pad = band_freq_decode_pallas(
        jnp.asarray(fc), jnp.asarray(kernel), jnp.asarray(bias), jnp.asarray(KC),
        ktaps, S, W, TpC, jnp.float32, interpret=True,
    )
    k4, b3, kcat = prepare_operands(*map(torch.from_numpy, (kernel, bias, KC)), S, W, TpC)
    assert W_pad == w_pad_rows(W, ktaps) == k4.shape[2]
    got = band_freq_decode(torch.from_numpy(fc), k4, b3, kcat)
    assert tuple(got.shape) == tuple(want.shape) == (B, S, W_pad, KC.shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_envelopes():
    # "auto" routes as the TPU did: highres geometry yes, dsd100 / ikala no
    assert fused_decode_supported(16 * 50, 120, 8)      # highres4096
    assert not fused_decode_supported(16 * 50, 90, 10)  # dsd100
    assert not fused_decode_supported(16 * 50, 30, 30)  # ikala
    assert kernel_supported(128, 8) and kernel_supported(128, 30)
    assert not kernel_supported(8192, 8)  # fc rows exceed shared memory

