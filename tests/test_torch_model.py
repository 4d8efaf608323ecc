"""ConvSep inference and the weight bridge: the port's model with bridged
weights against the JAX ``ConvSep.sources`` on the same numpy input, for
the float32 and the bfloat16 mask tail."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.models import ConvSep as JaxConvSep
from convsep_tpu.models import ConvSepConfig as JaxConfig
from convsep_tpu.models import convsep as jconv
from convsep_tpu_torch.ckpt import from_jax_params, init_params, to_jax_params
from convsep_tpu_torch.models import ConvSep, ConvSepConfig
from convsep_tpu_torch.models import convsep as tconv

# the tiny highres-shaped model (4096-pt geometry cut down: 129 bins,
# stride 4, TM = 120) and a tiny dsd100-shaped one (stride 3, TM = 90)
HIGHRES = dict(time_context=30, feat_size=129, channels_in=1, num_sources=4,
               conv1_filters=6, conv1_freq=9, conv1_freq_stride=4,
               conv2_filters=5, bottleneck=16, decoder_impl="auto")
DSD = dict(time_context=10, feat_size=129, channels_in=1, num_sources=4,
           conv1_filters=4, conv1_freq=8, conv1_freq_stride=3,
           conv2_filters=4, bottleneck=16)
# the joint-channel stereo model (channels_in 2, per-channel estimates)
STEREO = dict(DSD, channels_in=2, decoder_reduce="all")
SHAPES = {"highres": HIGHRES, "dsd": DSD, "stereo": STEREO}


def _jax_params(cfg, seed=0):
    return JaxConvSep(cfg).init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, cfg.time_context, cfg.feat_size, cfg.channels_in)),
    )


def _x(rng, cfg, B):
    shape = (B, cfg.time_context, cfg.feat_size, cfg.channels_in)
    return np.abs(rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mask_dtype", ["float32", "bfloat16"])
def test_sources_match_jax(rng, shape, mask_dtype):
    kw = dict(SHAPES[shape], mask_dtype=mask_dtype)
    jcfg, tcfg = JaxConfig(**kw), ConvSepConfig(**kw)
    params = _jax_params(jcfg)
    x = _x(rng, jcfg, 5)
    want = np.asarray(
        JaxConvSep(jcfg).apply(params, jnp.asarray(x), method=JaxConvSep.sources)
        .astype(jnp.float32)
    )
    model = ConvSep(tcfg, from_jax_params(params, tcfg))
    unprepared = model.sources(torch.from_numpy(x))
    got = model.prepare_inference().sources(torch.from_numpy(x))
    assert got.dtype == getattr(torch, mask_dtype)
    C = tcfg.channels_in
    assert tuple(got.shape) == want.shape == (5, 4, tcfg.time_context, tcfg.feat_size) + (
        (C,) if tcfg.decoder_reduce == "all" else ())
    scale = float(np.abs(want).max())
    for out in (unprepared, got):
        if mask_dtype == "float32":
            np.testing.assert_allclose(out.numpy(), want, atol=1e-5 * scale)
        else:
            # the same f32 decode rounded to bf16 twice (cast, then + out_bias):
            # sums that differ in the last f32 bits may round one bf16 ulp apart
            np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -7,
                                       atol=1e-6 * scale)


@pytest.mark.parametrize("shape", ["highres", "dsd"])
def test_bf16_compute_matches_jax(rng, shape):
    """compute_dtype="bfloat16": the reference composes the operands in
    bf16, the port in float32 and rounds them, and both run the products
    on bf16 operands; held at 3e-2 × max|y| (a few bf16 ulps of the
    largest outputs)."""
    kw = dict(SHAPES[shape], compute_dtype="bfloat16", mask_dtype="bfloat16")
    jcfg, tcfg = JaxConfig(**kw), ConvSepConfig(**kw)
    params = _jax_params(jcfg)
    x = _x(rng, jcfg, 5)
    want = np.asarray(
        JaxConvSep(jcfg).apply(params, jnp.asarray(x), method=JaxConvSep.sources)
        .astype(jnp.float32)
    )
    model = ConvSep(tcfg, from_jax_params(params, tcfg)).prepare_inference()
    assert model.k4.dtype == model.w_eff.dtype == torch.bfloat16
    f32 = dataclasses.replace(tcfg, compute_dtype="float32")
    for B in (8, 49):  # "auto" routes bf16 as float32: the fused kernel where it won
        assert (tconv.resolve_decoder_impl(tcfg, torch.device("cuda"), B)
                == tconv.resolve_decoder_impl(f32, torch.device("cuda"), B))
    got = model.sources(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max())
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        ConvSep(dataclasses.replace(tcfg, decoder_impl="band_pallas"))


@pytest.mark.parametrize("shape", ["highres", "dsd"])
def test_bf16_compute_fused_route_matches_jax(rng, shape):
    """compute_dtype="bfloat16" on the fused route: the kernel's wrapper
    gets the bf16 operands as float32 (on CPU tensors its plain version,
    the expansion unrounded); held to the JAX model and to the plain bf16
    decode at 3e-2 × max|y|, as the plain route."""
    kw = dict(SHAPES[shape], compute_dtype="bfloat16", mask_dtype="bfloat16")
    jcfg = JaxConfig(**kw)
    params = _jax_params(jcfg)
    x = _x(rng, jcfg, 5)
    want = np.asarray(
        JaxConvSep(jcfg).apply(params, jnp.asarray(x), method=JaxConvSep.sources)
        .astype(jnp.float32)
    )
    got = {}
    for impl in ("bandconv_pallas", "bandconv"):
        tcfg = ConvSepConfig(**{**kw, "decoder_impl": impl})
        model = ConvSep(tcfg, from_jax_params(params, tcfg)).prepare_inference()
        got[impl] = model.sources(torch.from_numpy(x)).float().numpy()
    tol = 3e-2 * np.abs(want).max()
    np.testing.assert_allclose(got["bandconv_pallas"], want, rtol=0, atol=tol)
    np.testing.assert_allclose(got["bandconv_pallas"], got["bandconv"], rtol=0, atol=tol)


def test_composition_pieces_match_jax(rng):
    jcfg, tcfg = JaxConfig(**HIGHRES), ConvSepConfig(**HIGHRES)
    p = _jax_params(jcfg)["params"]
    k1, k2 = np.array(p["conv1_kernel"]), np.array(p["conv2_kernel"])
    KCj, ktj, Tj, Mj = jconv.band_freq_conv_kernel(
        jnp.asarray(k2), jnp.asarray(k1), jcfg.enc_time, jcfg.conv1_freq_stride)
    KCt, ktt, Tt, Mt = tconv.band_freq_conv_kernel(
        torch.from_numpy(k2), torch.from_numpy(k1), tcfg.enc_time, tcfg.conv1_freq_stride)
    assert (ktj, Tj, Mj) == (ktt, Tt, Mt) == (tcfg.ktaps, 30, 4)
    np.testing.assert_allclose(KCt.numpy(), np.asarray(KCj), atol=1e-6)
    b1 = rng.standard_normal(jcfg.conv1_filters).astype(np.float32)
    b2 = rng.standard_normal(jcfg.conv2_filters).astype(np.float32)
    fk, fb = np.array(p["fc"]["kernel"]), np.asarray(p["fc"]["bias"]) + 0.1
    wj, cj = jconv._compose_collapsed_fc(fk, fb, k1, b1, k2, b2, jcfg, jnp.float32)
    wt, ct = tconv.compose_collapsed_fc(*map(torch.from_numpy, (fk, fb, k1, b1, k2, b2)), tcfg)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)


def test_bridge_roundtrip_and_prepared_tree_refused():
    jcfg, tcfg = JaxConfig(**DSD), ConvSepConfig(**DSD)
    params = _jax_params(jcfg)
    back = to_jax_params(from_jax_params(params, tcfg))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back)) == 9
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    prepared = jconv.prepare_inference(dataclasses.replace(jcfg, decoder_impl="bandconv_pallas"), params)
    with pytest.raises(KeyError, match="fc_expand/kernel"):
        from_jax_params(prepared, tcfg)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(params, dataclasses.replace(tcfg, bottleneck=8))


def test_prepare_inference_drops_raw_expansion():
    cfg = ConvSepConfig(**HIGHRES)
    model = ConvSep(cfg, init_params(cfg, torch.Generator().manual_seed(1)))
    model.prepare_inference()
    names = dict(model.named_parameters())
    assert "fc_expand_kernel" not in names and model.k4.shape[2] == 40  # W=31 + 8 - 1 → 40
    assert model.prepare_inference() is model


def test_init_params_distributions():
    cfg = ConvSepConfig(**dict(HIGHRES, bottleneck=64, conv1_filters=20))
    st = init_params(cfg, torch.Generator().manual_seed(0))
    for name, shape in tconv.param_shapes(cfg).items():
        assert tuple(st[name].shape) == shape
        if name.endswith("bias"):
            assert not st[name].any()
    k1 = st["conv1_kernel"]  # glorot_uniform: |w| <= sqrt(6 / (fan_in + fan_out))
    lim = np.sqrt(6.0 / (9 * 1 + 9 * 20))
    assert k1.abs().max() <= lim and k1.abs().max() > 0.8 * lim
    fe = st["fc_expand_kernel"]  # truncated lecun_normal: var 1 / fan_in, |w| < 2 σ_raw
    assert abs(fe.var().item() * 64 - 1.0) < 0.02
    assert fe.abs().max() < 2 * np.sqrt(1 / 64) / 0.87962566103423978 + 1e-6
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(st[k], again[k]) for k in st)


def test_decoder_routing():
    cfg = ConvSepConfig(**HIGHRES)
    cpu = torch.device("cpu")
    assert tconv.resolve_decoder_impl(cfg, cpu) == "bandconv"
    assert tconv.resolve_decoder_impl(dataclasses.replace(cfg, decoder_impl="bandconv_pallas"), cpu) == "bandconv_pallas"
    with pytest.raises(NotImplementedError):
        tconv.resolve_decoder_impl(dataclasses.replace(cfg, decoder_impl="band_einsum"), cpu)
    with pytest.raises(NotImplementedError):
        ConvSep(dataclasses.replace(cfg, encoder_impl="conv"))
