"""The trainable model, the losses and the optimizer routing, port against
reference, on CPU, at ``tests/test_train.py::tiny_train_preset`` size (2
sources) and a 4-source dsd100-shaped variant (stride 3, beta/other_idx).

Tolerances: model outputs within 1e-5 × max|y| (float32 sums in another
order); losses within 1e-6 relative; masked estimates within 1e-6 × max."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs import get_preset as jax_get_preset
from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.models.convsep import trainable_config as jax_trainable_config
from convsep_tpu.models.masks import wiener_filter as jax_wiener_filter
from convsep_tpu.train import loop as jax_loop
from convsep_tpu.train.losses import interference_matrix as jax_interference
from convsep_tpu.train.losses import separation_loss as jax_separation_loss
from convsep_tpu_torch.ckpt import from_jax_params, opt_state_from_jax, opt_state_to_jax
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.models import ConvSep
from convsep_tpu_torch.models.convsep import param_shapes, trainable_config
from convsep_tpu_torch.models.masks import wiener_filter
from convsep_tpu_torch.train import loop
from convsep_tpu_torch.train.losses import interference_matrix, separation_loss
from tests.test_train import tiny_train_preset


def tiny_dsd_preset(**train_kw):
    """dsd100 cut to the tiny train size: 4 stems, stride 3, its
    alpha/beta/beta_voc/other_idx weights."""
    p = jax_get_preset("dsd100")
    t = tiny_train_preset().transform
    model = dataclasses.replace(p.model, time_context=10, feat_size=t.bins, conv1_filters=4,
                                conv1_freq=8, conv2_filters=4, bottleneck=16)
    train = dataclasses.replace(p.train, batch_size=4, time_context=10, **train_kw)
    return dataclasses.replace(p, transform=t, model=model, train=train)


PRESETS = {"ikala_tiny": tiny_train_preset, "dsd100_tiny": tiny_dsd_preset}


def port(jax_preset):
    return preset_from_dict(dataclasses.asdict(jax_preset))


def _x(rng, cfg, B):
    shape = (B, cfg.time_context, cfg.feat_size, cfg.channels_in)
    return np.abs(rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_trainable_sources_match_jax(rng, name):
    jp = PRESETS[name]()
    jcfg = jax_trainable_config(jp.model)
    tcfg = trainable_config(port(jp).model)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.encoder_impl, tcfg.decoder_impl, tcfg.expand_pad, tcfg.mask_dtype) == (
        "conv", "bandconv", "output", "float32")
    params = JaxConvSep(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 10, jcfg.feat_size, 1)))
    x = _x(rng, jcfg, 3)
    want = np.asarray(JaxConvSep(jcfg).apply(params, jnp.asarray(x), method=JaxConvSep.sources))
    model = ConvSep(tcfg, from_jax_params(params, tcfg))
    assert all(p.requires_grad for p in model.parameters())
    got = model.sources(torch.from_numpy(x))
    assert got.requires_grad and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * scale, rtol=0)
    # the same weights on the inference (collapsed-encoder) model, f32 tail:
    # the conv chain's flatten order must be the collapsed GEMM's row order
    inf_cfg = dataclasses.replace(port(jp).model, mask_dtype="float32")
    inf = ConvSep(inf_cfg, from_jax_params(params, inf_cfg)).sources(torch.from_numpy(x))
    np.testing.assert_allclose(inf.numpy(), want, atol=1e-5 * scale, rtol=0)
    with pytest.raises(ValueError, match="collapsed encoder"):
        model.prepare_inference()


def test_conv_encoder_needs_bandconv():
    cfg = trainable_config(port(tiny_train_preset()).model)
    with pytest.raises(NotImplementedError, match="bandconv"):
        ConvSep(dataclasses.replace(cfg, decoder_impl="auto"))
    with pytest.raises(ValueError, match="encoder_impl"):
        ConvSep(dataclasses.replace(cfg, encoder_impl="nope"))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_losses_match_jax(rng, name):
    tr = PRESETS[name]().train
    S = 2 if name == "ikala_tiny" else 4
    kw = dict(alpha=tr.alpha, beta=tr.beta, beta_voc=tr.beta_voc, vocals_idx=tr.vocals_idx,
              other_idx=tr.other_idx)
    w = interference_matrix(S, **kw)
    np.testing.assert_array_equal(w, jax_interference(S, **kw))
    if name == "dsd100_tiny":  # beta on the 'other' column, beta_voc on vocals
        assert w[1, 3] == tr.beta and w[1, 0] == tr.beta_voc and w[2, 1] == tr.alpha
    y = np.abs(rng.standard_normal((3, S, 10, 129))).astype(np.float32)
    y[:, :, :2] = 0.0  # dead bins: the eps floor of the mask
    mix = np.abs(rng.standard_normal((3, 10, 129))).astype(np.float32)
    tgt = np.abs(rng.standard_normal((3, S, 10, 129))).astype(np.float32)
    est_j = np.array(jax_wiener_filter(jnp.asarray(y), jnp.asarray(mix), eps=1e-8, axis=1))
    est_t = wiener_filter(torch.from_numpy(y), torch.from_numpy(mix), eps=1e-8, axis=1)
    np.testing.assert_allclose(est_t.numpy(), est_j, atol=1e-6 * np.abs(est_j).max(), rtol=0)
    for interf in (w, None):
        want = float(jax_separation_loss(jnp.asarray(est_j), jnp.asarray(tgt), interf, 1))
        got = float(separation_loss(torch.from_numpy(est_j), torch.from_numpy(tgt), interf, 1))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError, match="targets"):
        separation_loss(torch.zeros(2, 3), torch.zeros(3, 2))


def _messages(fn, preset):
    try:
        fn(preset)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize(
    "train_kw",
    [
        dict(optimizer_impl="typo"),
        dict(optimizer="adam", optimizer_impl="fused"),
        dict(optimizer_impl="fused", optimizer_state_dtype="bfloat16"),
    ],
)
def test_preset_apply_fn_errors_match_jax(train_kw):
    jp = tiny_train_preset(**train_kw)
    want = _messages(jax_loop._preset_apply_fn, jp)
    got = _messages(loop._preset_apply_fn, port(jp))
    assert want is not None and got is not None
    # the same sentence; the reference's parenthetical names its Pallas kernel
    assert got.split(" (")[0] == want.split(" (")[0]


def test_preset_apply_fn_routes():
    assert loop._preset_apply_fn(port(tiny_train_preset())) is None
    fused = loop._preset_apply_fn(port(tiny_train_preset(optimizer_impl="fused",
                                                         learning_rate=0.5)))
    assert fused.func.__name__ == "fused_adadelta_apply"
    assert fused.keywords == {"learning_rate": 0.5}


def test_opt_state_bridge_roundtrip():
    jp = tiny_dsd_preset()
    st, _ = jax_loop.create_train_state(jp, 0)
    tcfg = trainable_config(port(jp).model)
    # make the accumulators distinct from each other and from zero
    jst = type(st.opt_state)(
        jax.tree.map(lambda a: a + 0.25, st.opt_state.accu),
        jax.tree.map(lambda a: a + 0.5, st.opt_state.delta_accu),
    )
    ts = opt_state_from_jax(jst, tcfg)
    assert set(ts.accu) == set(param_shapes(tcfg)) and float(ts.accu["fc_bias"][0]) == 0.25
    back = type(st.opt_state)(**opt_state_to_jax(ts))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a, np.asarray(b))
