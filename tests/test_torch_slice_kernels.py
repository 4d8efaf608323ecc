"""The tiny highres4096-shaped slice with BOTH kernel routes forced: the
JAX ``Separator`` runs its two Pallas kernels in interpret mode
(decoder_impl="bandconv_pallas", masked_synthesis="ct_pallas_wiener") and
the port runs the same routing through its kernel wrappers, which on CPU
tensors take the plain versions. Bound 1e-5, f32 tail."""

import dataclasses

import numpy as np

from convsep_tpu.data import sine_mixture
from convsep_tpu.separate import Separator as JaxSeparator
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.separate import Separator
from tests.test_torch_slice import _params, _port, tiny_highres


def test_tiny_highres_forced_kernels_match_jax_interpret():
    base = tiny_highres(decoder_impl="bandconv_pallas")
    jp = dataclasses.replace(
        base, transform=dataclasses.replace(base.transform, masked_synthesis="ct_pallas_wiener")
    )
    params = _params(jp, seed=3)
    _, mix = sine_mixture(4, 9000, fs=8000, seed=5)
    want = np.asarray(JaxSeparator(jp, params)(mix))
    pp = _port(jp)
    got = Separator(pp, from_jax_params(params, pp.model), device="cpu")(mix)
    assert got.shape == want.shape == (4, 9000)
    np.testing.assert_allclose(got, want, atol=1e-5)
