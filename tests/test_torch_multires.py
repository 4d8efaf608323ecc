"""Multi-resolution input channels (multires4096), port against reference,
on CPU: the interpolation matrix exactly, the channels within 1e-5 × their
peak (f32 DFT sums in another order), the whole separation against the
committed multires golden (atol 2e-4, as tests/test_golden.py) and
against the JAX ``Separator`` on a 4096-point preset cut in width
(1e-5 absolute on the stems)."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs import get_preset as jax_get_preset
from convsep_tpu.configs.presets import TransformConfig as JaxTransform
from convsep_tpu.data import sine_mixture
from convsep_tpu.dsp import multires as jmr
from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.separate import Separator as JaxSeparator
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.dsp import multires as tmr
from convsep_tpu_torch.separate import Separator, bucket_length, separate_fused_batch
from tests.test_separate import tiny_preset

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _params(preset, seed=42):
    cfg = preset.model
    return JaxConvSep(cfg).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.time_context, cfg.feat_size, cfg.channels_in)),
    )


def _port(jax_preset):
    return preset_from_dict(dataclasses.asdict(jax_preset))


@pytest.mark.parametrize("src,dst", [(33, 129), (65, 129), (513, 2049), (1025, 2049), (129, 65)])
def test_freq_interp_matrix_equals_jax(src, dst):
    np.testing.assert_array_equal(tmr.freq_interp_matrix(src, dst),
                                  jmr.freq_interp_matrix(src, dst))


@pytest.mark.parametrize("sizes,frame,hop,window", [((1024, 2048), 4096, 1024, "sinebell"),
                                                    ((64, 128), 256, 128, "sinebell"),
                                                    ((256,), 512, 128, "hann")])
def test_multires_channels_match_jax(rng, sizes, frame, hop, window):
    jt = JaxTransform(frame_size=frame, hop_size=hop, multires=sizes, window=window)
    x = (0.2 * rng.standard_normal((2, 6 * frame + 11))).astype(np.float32)
    want = np.stack([np.asarray(jmr.multires_channels(jnp.asarray(a), jt)) for a in x])
    got = tmr.multires_channels(torch.from_numpy(x), _port_transform(jt)).numpy()
    assert got.shape == want.shape == (2, -(-x.shape[1] // hop) + 2, frame // 2 + 1, len(sizes))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    with pytest.raises(ValueError, match="multires"):
        tmr.multires_channels(torch.from_numpy(x), dataclasses.replace(_port_transform(jt),
                                                                        multires=()))


def _port_transform(jt):
    from convsep_tpu_torch.configs import TransformConfig

    return TransformConfig(**{**dataclasses.asdict(jt), "multires": tuple(jt.multires)})


def _golden_multires_preset():
    """tests/golden_cases.py::case_multires's preset."""
    p = tiny_preset("ikala")
    return dataclasses.replace(
        p,
        transform=dataclasses.replace(p.transform, multires=(64, 128)),
        model=dataclasses.replace(p.model, channels_in=3),
    )


def test_multires_tiny_matches_golden():
    jp = _golden_multires_preset()
    golden = np.load(os.path.join(GOLDEN, "multires_tiny_stems.npz"))
    _, mix = sine_mixture(2, 8000, fs=8000, seed=19)
    np.testing.assert_allclose(mix, golden["mix"], atol=1e-7, err_msg="fixture drifted")
    pp = _port(jp)
    stems = Separator(pp, from_jax_params(_params(jp), pp.model), device="cpu")(mix)
    assert stems.dtype == np.float32 and stems.shape == golden["stems"].shape
    np.testing.assert_allclose(stems, golden["stems"], atol=2e-4)


def tiny_multires4096():
    """multires4096's transform (4096 pt, hop 1024, channels at 1024 and
    2048 points) and model geometry (stride 4, T 30), cut in width."""
    p = jax_get_preset("multires4096")
    model = dataclasses.replace(p.model, conv1_freq=9, conv1_filters=4, conv2_filters=4,
                                bottleneck=8, mask_dtype="float32")
    return dataclasses.replace(p, model=model, sep=dataclasses.replace(p.sep, segment_bucket=1))


def test_multires4096_tiny_matches_jax(rng):
    jp = tiny_multires4096()
    params = _params(jp, seed=3)
    mix = (0.1 * rng.standard_normal(40000)).astype(np.float32)
    want = np.asarray(JaxSeparator(jp, params)(mix))
    pp = _port(jp)
    sep = Separator(pp, from_jax_params(params, pp.model), device="cpu")
    got = sep(mix)
    assert got.shape == want.shape == (4, 40000)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # extra=None computes the channels; passing them gives the same stems
    L = bucket_length(len(mix), pp)
    x = torch.from_numpy(np.pad(mix, (0, L - len(mix))))[None]
    ex = tmr.multires_channels(x, pp.transform) * pp.train.mult_factor_in
    both = separate_fused_batch(sep.model, x, pp, L, extra=ex[0])
    np.testing.assert_array_equal(both[0, :, : len(mix)].numpy(), got)
