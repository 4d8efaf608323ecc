"""The Wiener mask kernel's wrapper, port against reference, on CPU: the
port's ``wiener_apply_pallas`` (its plain version, as CPU tensors take)
against the JAX Pallas kernel in interpret mode, on the same numpy inputs,
at shapes that are not multiples of the reference's 128 × 128 tiles.

Tolerance: 1e-6 relative. The reference multiplies by the reciprocal of
the denominator, the port divides by it: each rounds the ratio once, so
they part by about one float32 ulp."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.dsp.pallas.wiener_kernel import wiener_apply_pallas as jax_wiener_apply
from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_pallas, wiener_apply_plain
from convsep_tpu_torch.models.masks import wiener_mask


def _inputs(rng, S, F, B):
    y = np.abs(rng.standard_normal((S, F, B))).astype(np.float32)
    y[:, : F // 3, :5] = 0.0  # dead bins: the eps paths
    y[0, F // 2:, :3] = -1.0  # negative estimates: relu
    re = rng.standard_normal((F, B)).astype(np.float32)
    im = rng.standard_normal((F, B)).astype(np.float32)
    return y, re, im


@pytest.mark.parametrize("p", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 130, 257), (3, 7, 9), (1, 33, 129)])
def test_wiener_apply_matches_jax(rng, p, dtype, shape):
    y, re, im = _inputs(rng, *shape)
    jy = jnp.asarray(y).astype(getattr(jnp, dtype))
    want_re, want_im = jax_wiener_apply(jy, jnp.asarray(re), jnp.asarray(im), p=p,
                                        interpret=True)
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    got_re, got_im = wiener_apply_pallas(ty, torch.from_numpy(re), torch.from_numpy(im), p=p)
    assert got_re.dtype == torch.float32 and got_re.shape == shape
    np.testing.assert_allclose(got_re.numpy(), np.asarray(want_re), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_im.numpy(), np.asarray(want_im), rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_wiener_apply_plain_is_the_mask_times_the_mixture(rng, p):
    """The plain version is ``wiener_mask`` followed by the multiply, with
    its sum over the sources in a fixed order."""
    y, re, im = _inputs(rng, 4, 20, 33)
    ty, tre = torch.from_numpy(y), torch.from_numpy(re)
    got, _ = wiener_apply_plain(ty, tre, torch.from_numpy(im), p=p, eps=1e-4)
    want = wiener_mask(ty, p=p, eps=1e-4, axis=0) * tre
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


def test_wiener_apply_refuses_mismatched_mixture():
    with pytest.raises(ValueError, match="does not match"):
        wiener_apply_pallas(torch.zeros(2, 10, 16), torch.zeros(9, 16), torch.zeros(9, 16))
    with pytest.raises(ValueError, match="does not match"):
        wiener_apply_pallas(torch.zeros(10, 16), torch.zeros(10, 16), torch.zeros(10, 16))
