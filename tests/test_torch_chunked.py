"""Chunked separation, port against reference, on CPU: the port's
``ChunkedSeparator`` (device="cpu", so every kernel wrapper takes its plain
version) against the JAX ``ChunkedSeparator`` with the same weights
(carried across by ``ckpt/bridge.py``) and against the port's own
whole-track ``Separator``, at the JAX tests' tiny geometry
(``tests/test_chunked.py::tiny_preset``: 8 kHz, W 256, hop 128,
time_context 10, narrow convolutions).

Tolerances: float32 stems 2e-5 absolute, the reference's chunked ≡
whole-track bound (``tests/test_chunked.py``: float reassociation and the
bf16 mask tail's rounding, under PCM16's 3e-5 step); int16 stems ±1 LSB;
a stem derived on the host (``complement_last``) 1e-4 from the direct
conservative stem (the STFT round trip), in int16 2 LSB (the other stems'
rounding, as the reference's test); one chunk's source magnitudes 1e-5 ×
max|y| of the whole-track chain's (the same products at another batch)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs.presets import stereo_preset
from convsep_tpu.dsp.stft import num_frames
from convsep_tpu.separate import ChunkedSeparator as JaxChunked
from convsep_tpu.separate.chunked import inv_norm_slice as jax_inv_norm_slice
from convsep_tpu.separate.chunked import separate_chunk as jax_separate_chunk
from convsep_tpu_torch.ckpt import from_jax_params
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.models import ConvSep
from convsep_tpu_torch.separate import (
    ChunkedSeparator,
    Separator,
    StereoSeparator,
    separate_chunk,
    source_magnitudes,
)
from convsep_tpu_torch.separate.chunked import chunk_source_magnitudes, inv_norm_slice
from tests.test_chunked import _params, tiny_preset

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_intraop_thread():
    """torch's CPU operations on one thread while this module runs, the
    caller's count restored after: the bit-for-bit comparisons between two
    separators then hold their arithmetic to one partition of the work,
    whatever the load on the machine. Modules that import this fixture
    get it too."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def port(jax_preset, params):
    """The port's preset and bridged weights for a JAX preset and tree."""
    pp = preset_from_dict(dataclasses.asdict(jax_preset))
    return pp, from_jax_params(params, pp.model)


def noise(rng, shape):
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def base():
    jp = tiny_preset()
    params = _params(jp)
    return (jp, params, *port(jp, params))


@pytest.mark.parametrize("seconds", [0.4, 1.0, 2.37])
@pytest.mark.parametrize("chunk_segments", [1, 3])
def test_chunked_matches_jax_and_whole_track(rng, base, seconds, chunk_segments):
    jp, params, pp, state = base
    L = int(seconds * pp.transform.fs)
    audio = noise(rng, L)
    want = np.asarray(JaxChunked(jp, params, chunk_segments=chunk_segments)(audio))
    got = ChunkedSeparator(pp, state, chunk_segments=chunk_segments, device="cpu")(audio)
    whole = Separator(pp, state, device="cpu")(audio)
    assert got.shape == want.shape == (4, L) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, whole, atol=TOL, rtol=0)


@pytest.mark.parametrize("frame,hop,L,cs", [(256, 64, 11_111, 2), (2048, 512, 20_000, 2)],
                         ids=["hop_quarter_window", "factored_dft"])
def test_chunked_geometry_matches_jax(rng, frame, hop, L, cs):
    """hop = W/4 (the spill spans three hops) and the factored DFT at 2048
    points (both directions of the chunk program)."""
    jp = tiny_preset(frame_size=frame, hop_size=hop)
    params = _params(jp)
    pp, state = port(jp, params)
    audio = noise(rng, L)
    want = np.asarray(JaxChunked(jp, params, chunk_segments=cs)(audio))
    got = ChunkedSeparator(pp, state, chunk_segments=cs, device="cpu")(audio)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, Separator(pp, state, device="cpu")(audio), atol=TOL, rtol=0)


def test_chunked_pcm16_matches_jax(rng):
    jp = tiny_preset(name="ikala")
    params = _params(jp)
    pp, state = port(jp, params)
    audio = noise(rng, 9_000)
    kw = dict(output_dtype="int16", input_dtype="int16")
    want = np.asarray(JaxChunked(jp, params, chunk_segments=2, **kw)(audio))
    got = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu", **kw)(audio)
    whole = Separator(pp, state, device="cpu", **kw)(audio)
    assert got.dtype == np.int16 and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert np.abs(got.astype(np.int32) - whole.astype(np.int32)).max() <= 1


def test_chunked_multires_matches_jax(rng):
    """Multi-resolution channels computed inside each chunk from its slice."""
    jp = tiny_preset()
    jp = dataclasses.replace(
        jp, transform=dataclasses.replace(jp.transform, multires=(64, 128)),
        model=dataclasses.replace(jp.model, channels_in=3))
    params = _params(jp)
    pp, state = port(jp, params)
    audio = noise(rng, 10_000)
    want = np.asarray(JaxChunked(jp, params, chunk_segments=2)(audio))
    got = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, Separator(pp, state, device="cpu")(audio), atol=TOL, rtol=0)


def test_chunked_score_informed_matches_jax(rng):
    jp = tiny_preset(name="bach10")
    jp = dataclasses.replace(jp, model=dataclasses.replace(jp.model, channels_in=5))
    params = _params(jp)
    pp, state = port(jp, params)
    L = 10_000
    audio = noise(rng, L)
    extra = rng.random((num_frames(L, jp.transform.hop_size), jp.model.feat_size, 4)
                       ).astype(np.float32)
    want = np.asarray(JaxChunked(jp, params, chunk_segments=2)(audio, extra=extra))
    sep = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")
    got = sep(audio, extra=extra)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    whole = Separator(pp, state, device="cpu")(audio, extra=extra)
    np.testing.assert_allclose(got, whole, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="extra"):
        sep(audio)
    with pytest.raises(ValueError, match="extra must be"):
        sep(audio, extra=extra[..., :2])


def test_chunked_stereo_matches_jax(rng):
    base_p = tiny_preset(name="ikala")
    jp = stereo_preset(dataclasses.replace(
        base_p, model=dataclasses.replace(base_p.model, channels_in=1)))
    params = _params(jp)
    pp, state = port(jp, params)
    L = 9_321
    audio = noise(rng, (2, L))
    audio[1] *= 0.3  # unequal channels exercise the per-channel masks
    want = np.asarray(JaxChunked(jp, params, chunk_segments=2)(audio))
    got = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio)
    whole = StereoSeparator(pp, state, device="cpu")(audio)
    assert got.shape == want.shape == whole.shape == (2, L, 2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, whole, atol=TOL, rtol=0)
    wav = ChunkedSeparator(pp, state, chunk_segments=3, device="cpu")(audio.T)
    np.testing.assert_allclose(wav, whole, atol=TOL, rtol=0)


def test_conserve_last_matches_jax_and_sums_to_mixture(rng, base):
    jp, params, pp, state = base
    audio = noise(rng, int(1.3 * pp.transform.fs))
    want = np.asarray(JaxChunked(jp, params, chunk_segments=3, conserve_last=True)(audio))
    cons = ChunkedSeparator(pp, state, chunk_segments=3, conserve_last=True, device="cpu")(audio)
    plain = ChunkedSeparator(pp, state, chunk_segments=3, device="cpu")(audio)
    np.testing.assert_allclose(cons, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(cons[:-1], plain[:-1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(cons.sum(0), audio, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["dsd100", "ikala-stereo"])
def test_complement_last_matches_jax(rng, name):
    jp = tiny_preset(name=name)
    params = _params(jp)
    pp, state = port(jp, params)
    shape = (2, int(1.1 * pp.transform.fs)) if "stereo" in name else int(1.3 * pp.transform.fs)
    audio = noise(rng, shape)
    want = np.asarray(JaxChunked(jp, params, chunk_segments=2, complement_last=True)(audio))
    comp = ChunkedSeparator(pp, state, chunk_segments=2, complement_last=True,
                            device="cpu")(audio)
    direct = ChunkedSeparator(pp, state, chunk_segments=2, conserve_last=True,
                              device="cpu")(audio)
    np.testing.assert_allclose(comp, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(comp[:-1], direct[:-1], atol=1e-6, rtol=0)
    np.testing.assert_allclose(comp[-1], direct[-1], atol=1e-4, rtol=0)


def test_complement_last_int16(rng, base):
    jp, params, pp, state = base
    audio = noise(rng, int(0.9 * pp.transform.fs))
    kw = dict(chunk_segments=2, output_dtype="int16", input_dtype="int16")
    want = np.asarray(JaxChunked(jp, params, complement_last=True, **kw)(audio))
    comp = ChunkedSeparator(pp, state, complement_last=True, device="cpu", **kw)(audio)
    direct = ChunkedSeparator(pp, state, conserve_last=True, device="cpu", **kw)(audio)
    assert comp.dtype == np.int16
    assert np.abs(comp.astype(np.int32) - want.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(comp[:-1], direct[:-1])
    assert np.abs(comp[-1].astype(np.int32) - direct[-1].astype(np.int32)).max() <= 2


def test_chunked_rejects_what_the_reference_rejects(base):
    jp, params, pp, state = base
    multires = dataclasses.replace(
        pp, transform=dataclasses.replace(pp.transform, multires=(512,)),
        model=dataclasses.replace(pp.model, channels_in=2))
    with pytest.raises(ValueError, match="multires"):
        ChunkedSeparator(multires, state, device="cpu")
    bad_hop = preset_from_dict(dataclasses.asdict(tiny_preset(frame_size=256, hop_size=32)))
    with pytest.raises(ValueError, match="hop"):
        ChunkedSeparator(bad_hop, state, device="cpu")
    one = dataclasses.replace(pp, model=dataclasses.replace(pp.model, num_sources=1))
    with pytest.raises(ValueError, match="complement_last requires"):
        ChunkedSeparator(one, None, complement_last=True, device="cpu")
    for kw in ({"output_dtype": "float16"}, {"input_dtype": "int8"}):
        with pytest.raises(ValueError, match="dtype"):
            ChunkedSeparator(pp, state, device="cpu", **kw)
    fft = dataclasses.replace(pp, transform=dataclasses.replace(pp.transform, fft_impl="fft"))
    with pytest.raises(NotImplementedError, match="fft_impl"):
        ChunkedSeparator(fft, state, device="cpu")


def test_chunked_norm_cache_and_slices_match_jax(rng, base):
    jp, params, pp, state = base
    sep = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")
    for L in (6_000, 9_000, 12_345):
        out = sep(noise(rng, L))
        assert out.shape == (4, L) and np.isfinite(out).all()
    assert "first" in sep._norm_cache and "mid" in sep._norm_cache
    # 2e-7 relative: the port sums the window product of the float32
    # window, as its whole-track normalization does (one float32 ulp)
    for i, nc, nf in ((0, 1, 30), (0, 3, 55), (1, 3, 55), (2, 3, 55)):
        want = np.asarray(jax_inv_norm_slice(jp, 2, i, nc, nf, {}))
        np.testing.assert_allclose(inv_norm_slice(pp, 2, i, nc, nf, {}).numpy(), want,
                                   rtol=2e-7, atol=0)


def test_separate_chunk_matches_jax(rng, base):
    """One chunk with a spill carried in: stems and the new spill."""
    jp, params, pp, state = base
    t = pp.transform
    W, hop = t.frame_size, t.hop_size
    cs, S = 2, pp.model.num_sources
    Fc = pp.model.time_context * cs
    sl = noise(rng, Fc * hop + W - hop)
    spill = noise(rng, (S, W - hop))
    norm = inv_norm_slice(pp, cs, 1, 3, 3 * Fc, {})
    want_out, want_spill = jax_separate_chunk(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(sl), jnp.asarray(spill),
        jnp.asarray(norm.numpy()), jp, cs)
    model = ConvSep(pp.model, state).prepare_inference()
    out, new_spill = separate_chunk(model, torch.from_numpy(sl), torch.from_numpy(spill),
                                    norm, pp, cs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL, rtol=0)
    np.testing.assert_allclose(new_spill.numpy(), np.asarray(want_spill), atol=TOL, rtol=0)


def test_chunk_source_magnitudes_equal_whole_track(rng, base):
    """A middle chunk's y is the whole-track chain's y on the same frames."""
    _, _, pp, state = base
    t = pp.transform
    W, hop = t.frame_size, t.hop_size
    cs = 2
    Fc = pp.model.time_context * cs
    model = ConvSep(pp.model, state).prepare_inference()
    length = 3 * Fc * hop
    audio = noise(rng, length)
    y_whole = source_magnitudes(model, torch.from_numpy(audio)[None], pp)[0][0].float()
    padded = np.pad(audio, (W // 2, 0))
    sl = padded[Fc * hop: Fc * hop + Fc * hop + W - hop]
    y, re, im = chunk_source_magnitudes(model, torch.from_numpy(np.ascontiguousarray(sl)),
                                        pp, cs)
    assert y.shape == (pp.model.num_sources, Fc, t.bins) and re.shape == (Fc, t.bins)
    ref = y_whole[:, Fc:2 * Fc]
    scale = ref.abs().max().item()
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), atol=1e-5 * scale, rtol=0)


def test_separate_chunk_at_lowered_precision(rng, base):
    """The chunk program runs its products at "highest" whatever the caller
    set (on a CPU with bf16 matrix units "medium" runs float32 products in
    bf16), and gives the caller's setting back."""
    jp, params, pp, state = base
    audio = noise(rng, int(1.0 * pp.transform.fs))
    want = np.asarray(JaxChunked(jp, params, chunk_segments=3)(audio))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = ChunkedSeparator(pp, state, chunk_segments=3, device="cpu")(audio)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_chunked_device_none_means_cuda(base):
    _, _, pp, state = base
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChunkedSeparator(pp, state)
