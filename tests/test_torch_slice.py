"""The whole separation slice, port against reference, on CPU:

* the tiny dsd100 preset against the committed golden stems (float atol
  2e-4, tests/test_golden.py) and the JAX ``Separator`` in int16 (±1 LSB);
* a tiny highres4096-shaped preset (frame 256, hop 64, T 30, stride 4)
  against the JAX ``Separator``'s default CPU route at 1e-5, f32 tail;
* the written-out batch axis against per-track calls."""

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
from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.separate import Separator as JaxSeparator
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
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


def tiny_highres(mask_dtype="float32", **model_kw):
    p = jax_get_preset("highres4096")
    t = JaxTransform(fs=8000, frame_size=256, hop_size=64)
    model = dataclasses.replace(
        p.model, feat_size=t.bins, conv1_freq=9, conv1_filters=6,
        conv2_filters=5, bottleneck=16, mask_dtype=mask_dtype, **model_kw,
    )
    return dataclasses.replace(
        p, transform=t, model=model, sep=dataclasses.replace(p.sep, segment_bucket=2)
    )


def test_dsd100_tiny_matches_golden():
    jp = tiny_preset("dsd100")
    golden = np.load(os.path.join(GOLDEN, "dsd100_tiny_stems.npz"))
    _, mix = sine_mixture(4, 8000, fs=8000, seed=13)
    np.testing.assert_allclose(mix, golden["mix"], atol=1e-7, err_msg="fixture drifted")
    pp = _port(jp)
    stems = Separator(pp, from_jax_params(_params(jp), pp.model), device="cpu")(mix)
    assert stems.dtype == np.float32 and stems.shape == golden["stems"].shape
    np.testing.assert_allclose(stems, golden["stems"], atol=2e-4)


def test_dsd100_tiny_int16_matches_jax():
    jp = tiny_preset("dsd100")
    params = _params(jp)
    _, mix = sine_mixture(4, 9000, fs=8000, seed=29)
    want = np.asarray(JaxSeparator(jp, params, output_dtype="int16", input_dtype="int16")(mix))
    pp = _port(jp)
    got = Separator(pp, from_jax_params(params, pp.model), device="cpu",
                    output_dtype="int16", input_dtype="int16")(mix)
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("conserve_last", [False, True])
def test_tiny_highres_matches_jax(conserve_last):
    jp = tiny_highres()
    params = _params(jp, seed=3)
    _, mix = sine_mixture(4, 9000, fs=8000, seed=5)
    want = np.asarray(JaxSeparator(jp, params, conserve_last=conserve_last)(mix))
    pp = _port(jp)
    got = Separator(pp, from_jax_params(params, pp.model), device="cpu",
                    conserve_last=conserve_last)(mix)
    assert got.shape == want.shape == (4, 9000)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if conserve_last:  # masks sum to 1: the stems add back to the mixture
        np.testing.assert_allclose(got.sum(0), mix, atol=1e-4)


def test_batch_axis_equals_per_track():
    jp = tiny_highres("bfloat16")
    pp = _port(jp)
    sep = Separator(pp, from_jax_params(_params(jp), pp.model), device="cpu")
    rng = np.random.default_rng(0)
    L = bucket_length(5000, pp)
    tracks = (0.2 * rng.standard_normal((2, L))).astype(np.float32)
    both = separate_fused_batch(sep.model, torch.from_numpy(tracks), pp, L).numpy()
    for b in range(2):
        np.testing.assert_allclose(both[b], sep(tracks[b]), atol=1e-6)
    with pytest.raises(NotImplementedError):
        Separator(_port(tiny_preset("bach10")), {}, device="cpu")
