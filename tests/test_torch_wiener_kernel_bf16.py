"""Fused Wiener+iSTFT (kernel A), bf16 y and int16 output: the port's
plain version against the JAX Pallas kernel ``istft_ct_pallas_wiener`` in
interpret mode, in the batched layout, float atol 1e-5 and PCM16 ±1 LSB."""

import numpy as np
import jax.numpy as jnp
import torch

from convsep_tpu.dsp.pallas.ct_istft_kernel import istft_ct_pallas_wiener
from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft
from tests.test_torch_wiener_kernel import _mk, _torch


def test_plain_matches_jax_kernel_batched_int16_bf16(rng):
    """(B, S, nf, bins) bf16 y with int16 output: the separate_fused_batch
    layout and the bf16 mask tail; PCM16 within ±1 LSB. The JAX kernel's
    int16 epilogue equals quantize_pcm16 of its float output
    (tests/test_ct_istft_wiener.py), so one interpret run serves both."""
    from convsep_tpu.utils.pcm import quantize_pcm16

    w, re, im, y = _mk(rng, 3, 4500, 256, 64, lead=(2,))
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    f32 = istft_ct_pallas_wiener(yb, re, im, w, 64, 4500, nfft=256, interpret=True)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    for out in ("float32", "int16"):
        want = np.asarray(quantize_pcm16(f32) if out == "int16" else f32)
        got = wiener_istft(ty, *_torch(re, im), w, 64, 4500, output_dtype=out).numpy()
        assert got.shape == (2, 3, 4500) and got.dtype == want.dtype
        if out == "int16":
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=1e-5)
