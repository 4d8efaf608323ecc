"""Batched separation, port against reference, on CPU: the port's
``StreamSeparator`` and batch functions (device="cpu") against the JAX
``StreamSeparator`` with the same weights and against the port's own
whole-track separators, at the JAX tests' tiny geometry
(``tests/test_chunked.py::tiny_preset``).

Tolerances: stems 1e-4 absolute against one track at a time and against
the reference (``tests/test_stream.py``'s stream ≡ single-track bound: a
batch runs the model on B · nseg segments at once); batch functions 1e-5
against their per-track counterpart (the reference's scan ≡ vmap bound),
1e-6 across groupings (a pure batching reassociation); PCM16 input 2e-3
against float input (the reference's); int16 stems ±1 LSB; a stem derived
on the host (``complement_last``) 1e-4 from the direct conservative stem
(the STFT round trip). The ``fft_impl="pallas"`` and stereo routes run one
track at a time, so they equal their whole-track separators bit for bit."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from convsep_tpu.configs.presets import stereo_preset
from convsep_tpu.data import sine_mixture
from convsep_tpu.dsp.stft import num_frames
from convsep_tpu.separate import StreamSeparator as JaxStream
from convsep_tpu.separate.stream import separate_batch as jax_separate_batch
from convsep_tpu_torch.models import ConvSep
from convsep_tpu_torch.separate import (
    Separator,
    StereoSeparator,
    StreamSeparator,
    bucket_length,
    separate_batch,
    separate_batch_scan,
    separate_batch_scan_stereo,
    separate_batch_stereo,
    separate_fused,
)
from convsep_tpu_torch.separate.stream import separate_batch_vmap
from tests.torch_ranks import one_rank_mesh
from tests.test_chunked import _params, tiny_preset
from tests.test_torch_chunked import noise, one_intraop_thread, port  # noqa: F401

TOL = 1e-4


def tracks_of(n, fs=8000, seed=0):
    return [sine_mixture(2, fs + 137 * i, fs=fs, freqs=(220.0, 1400.0), seed=seed + i)[1]
            for i in range(n)]


def stacked(tracks, preset):
    Lb = bucket_length(max(len(t) for t in tracks), preset)
    return torch.from_numpy(np.stack([np.pad(t, (0, Lb - len(t))) for t in tracks])), Lb


@pytest.fixture(scope="module")
def ikala():
    jp = tiny_preset(name="ikala")
    params = _params(jp)
    pp, state = port(jp, params)
    return jp, params, pp, state, ConvSep(pp.model, state).prepare_inference()


def test_separate_many_matches_single_track_and_jax(ikala):
    jp, params, pp, state, _ = ikala
    tracks = tracks_of(3)
    outs = StreamSeparator(pp, state, device="cpu").separate_many(tracks)
    want = JaxStream(jp, params).separate_many(tracks)
    single = Separator(pp, state, device="cpu")
    for t, o, w in zip(tracks, outs, want):
        assert o.shape == (2, len(t))
        np.testing.assert_allclose(o, single(t), atol=TOL, rtol=0)
        np.testing.assert_allclose(o, np.asarray(w), atol=TOL, rtol=0)


def test_stream_batches_and_matches_jax(ikala):
    jp, params, pp, state, _ = ikala
    tracks = tracks_of(5)
    got = [o for b in StreamSeparator(pp, state, device="cpu").stream(iter(tracks), 2)
           for o in b]
    sizes = [len(b) for b in StreamSeparator(pp, state, device="cpu").stream(iter(tracks), 2)]
    want = [o for b in JaxStream(jp, params).stream(iter(tracks), 2) for o in b]
    assert sizes == [2, 2, 1] and len(got) == 5
    single = Separator(pp, state, device="cpu")
    for t, o, w in zip(tracks, got, want):
        np.testing.assert_allclose(o, single(t), atol=TOL, rtol=0)
        np.testing.assert_allclose(o, np.asarray(w), atol=TOL, rtol=0)


def test_stream_propagates_errors(ikala):
    _, _, pp, state, _ = ikala

    def bad():
        yield tracks_of(1)[0]
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(StreamSeparator(pp, state, device="cpu").stream(bad(), batch_size=4))


def test_stream_int16_input_not_requantized(ikala):
    """PCM16 tracks stay as they are (a float32 copy of PCM16 values would
    be quantized a second time, ×32768, saturated)."""
    _, _, pp, state, _ = ikala
    tracks = tracks_of(3)
    pcm = [np.clip(t * 32768.0, -32768, 32767).astype(np.int16) for t in tracks]
    f32 = [o for b in StreamSeparator(pp, state, device="cpu").stream(iter(tracks), 2) for o in b]
    i16 = [o for b in StreamSeparator(pp, state, input_dtype="int16", device="cpu").stream(
        iter(pcm), 2) for o in b]
    for g, w in zip(i16, f32):
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=0)


def test_stream_int16_out_matches_jax(ikala):
    jp, params, pp, state, _ = ikala
    tracks = tracks_of(3)
    kw = dict(output_dtype="int16", input_dtype="int16")
    got = StreamSeparator(pp, state, device="cpu", **kw).separate_many(tracks)
    want = JaxStream(jp, params, **kw).separate_many(tracks)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        assert np.abs(g.astype(np.int32) - np.asarray(w).astype(np.int32)).max() <= 1


def test_separate_batch_scan_matches_batch(ikala):
    jp, params, pp, state, model = ikala
    x, Lb = stacked(tracks_of(4), pp)
    a = separate_batch(model, x, pp, Lb)
    want = np.asarray(jax_separate_batch(params, jnp.asarray(x.numpy()), jp, Lb))
    np.testing.assert_allclose(a.numpy(), want, atol=TOL, rtol=0)
    b = separate_batch_scan(model, x, pp, Lb)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=0)
    for g in (2, 3):  # 3 does not divide 4: a short last group
        c = separate_batch_scan(model, x, pp, Lb, group=g)
        np.testing.assert_allclose(c.numpy(), b.numpy(), atol=1e-6, rtol=0)
    v = separate_batch_vmap(model, x, pp, Lb)
    np.testing.assert_allclose(v.numpy(), a.numpy(), atol=1e-5, rtol=0)
    ai = separate_batch(model, x, pp, Lb, None, "int16")
    vi = separate_batch_vmap(model, x, pp, Lb, None, "int16")
    assert ai.dtype == torch.int16
    assert (ai.int() - vi.int()).abs().max().item() <= 1
    with pytest.raises(ValueError, match="group"):
        separate_batch_scan(model, x, pp, Lb, group=0)


def test_separate_batch_extra_channels_shared_and_per_track(rng):
    jp = tiny_preset(name="bach10")
    params = _params(jp)
    pp, state = port(jp, params)
    model = ConvSep(pp.model, state).prepare_inference()
    L = bucket_length(4000, pp)
    B, C = 3, pp.model.channels_in - 1
    x = torch.from_numpy(noise(rng, (B, L)))
    nf = num_frames(L, pp.transform.hop_size)
    ex1 = torch.from_numpy(np.abs(rng.standard_normal((nf, pp.model.feat_size, C)))
                           .astype(np.float32))
    exB = torch.from_numpy(np.abs(rng.standard_normal((B, nf, pp.model.feat_size, C)))
                           .astype(np.float32))
    want_shared = torch.stack([separate_fused(model, x[i], pp, L, extra=ex1) for i in range(B)])
    want_per = torch.stack([separate_fused(model, x[i], pp, L, extra=exB[i]) for i in range(B)])
    for fn in (separate_batch, separate_batch_scan):
        np.testing.assert_allclose(fn(model, x, pp, L, extra=ex1).numpy(), want_shared.numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(fn(model, x, pp, L, extra=exB).numpy(), want_per.numpy(),
                                   atol=1e-5, rtol=0)
    jwant = np.asarray(jax_separate_batch(params, jnp.asarray(x.numpy()), jp, L,
                                          extra=jnp.asarray(exB.numpy())))
    np.testing.assert_allclose(want_per.numpy(), jwant, atol=TOL, rtol=0)


def test_separate_many_with_score_extras(rng):
    jp = tiny_preset(name="bach10")
    params = _params(jp)
    pp, state = port(jp, params)
    fs, C = pp.transform.fs, pp.model.channels_in - 1
    tracks = [noise(rng, fs + 99 * i) for i in range(3)]
    extras = [np.abs(rng.standard_normal((num_frames(len(t), pp.transform.hop_size),
                                          pp.model.feat_size, C))).astype(np.float32)
              for t in tracks]
    outs = StreamSeparator(pp, state, device="cpu").separate_many(tracks, extras=extras)
    want = JaxStream(jp, params).separate_many(tracks, extras=extras)
    single = Separator(pp, state, device="cpu")
    for t, e, o, w in zip(tracks, extras, outs, want):
        np.testing.assert_allclose(o, single(t, extra=e), atol=TOL, rtol=0)
        np.testing.assert_allclose(o, np.asarray(w), atol=TOL, rtol=0)
    streamed = [o for b in StreamSeparator(pp, state, device="cpu").stream(
        iter(tracks), 2, extras=iter(extras)) for o in b]
    for o, s in zip(outs, streamed):
        np.testing.assert_allclose(s, o, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="extras"):
        StreamSeparator(pp, state, device="cpu").separate_many(tracks, extras=extras[:1])


def test_pallas_route_loops_one_track_at_a_time(rng):
    jp = tiny_preset()
    jp = dataclasses.replace(jp, transform=dataclasses.replace(jp.transform, fft_impl="pallas"))
    params = _params(jp)
    pp, state = port(jp, params)
    model = ConvSep(pp.model, state).prepare_inference()
    tracks = [noise(rng, 5000 + 300 * i) for i in range(3)]
    x, Lb = stacked(tracks, pp)
    got = separate_batch(model, x, pp, Lb)
    want = torch.stack([separate_fused(model, x[i], pp, Lb) for i in range(3)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    outs = StreamSeparator(pp, state, device="cpu").separate_many(tracks)
    single = Separator(pp, state, device="cpu")
    for t, o in zip(tracks, outs):
        np.testing.assert_array_equal(o, single(t))
    jwant = JaxStream(jp, params).separate_many(tracks)
    for o, w in zip(outs, jwant):
        np.testing.assert_allclose(o, np.asarray(w), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="conserve_last"):
        StreamSeparator(pp, state, complement_last=True, device="cpu")


@pytest.mark.parametrize("out", ["float32", "int16"])
def test_complement_last_matches_conserve(ikala, out):
    jp, params, pp, state, _ = ikala
    tracks = tracks_of(3)
    kw = dict(output_dtype=out, input_dtype=out, device="cpu")
    if out == "int16":
        tracks = [np.clip(np.rint(t * 32768), -32768, 32767).astype(np.int16) for t in tracks]
    comp = StreamSeparator(pp, state, complement_last=True, **kw).separate_many(tracks)
    direct = StreamSeparator(pp, state, conserve_last=True, **kw).separate_many(tracks)
    jwant = JaxStream(jp, params, complement_last=True, output_dtype=out,
                      input_dtype=out).separate_many(tracks)
    for c, d, w in zip(comp, direct, jwant):
        if out == "int16":
            np.testing.assert_array_equal(c[:-1], d[:-1])
            assert np.abs(c.astype(np.int32) - np.asarray(w).astype(np.int32)).max() <= 1
            assert np.abs(c[-1].astype(np.int32) - d[-1].astype(np.int32)).max() <= 2
        else:
            np.testing.assert_allclose(c[:-1], d[:-1], atol=1e-6, rtol=0)
            np.testing.assert_allclose(c[-1], d[-1], atol=1e-4, rtol=0)
            np.testing.assert_allclose(c, np.asarray(w), atol=TOL, rtol=0)


def test_stereo_stream_matches_stereo_separator(rng):
    base_p = tiny_preset(name="ikala")
    jp = stereo_preset(dataclasses.replace(
        base_p, model=dataclasses.replace(base_p.model, channels_in=1)))
    params = _params(jp)
    pp, state = port(jp, params)
    tracks = [noise(rng, (2, 6000 + 500 * i)) for i in range(3)]
    outs = [o for b in StreamSeparator(pp, state, device="cpu").stream(iter(tracks), 2)
            for o in b]
    single = StereoSeparator(pp, state, device="cpu")
    for t, o in zip(tracks, outs):
        assert o.shape == (2, 2, t.shape[1])
        np.testing.assert_array_equal(o, single(t).transpose(0, 2, 1))
    want = JaxStream(jp, params).separate_many(tracks)
    for o, w in zip(outs, want):
        np.testing.assert_allclose(o, np.asarray(w), atol=TOL, rtol=0)
    model = ConvSep(pp.model, state).prepare_inference()
    Lb = bucket_length(max(t.shape[1] for t in tracks), pp)
    x = torch.from_numpy(np.stack([np.pad(t, ((0, 0), (0, Lb - t.shape[1]))) for t in tracks]))
    assert separate_batch_scan_stereo is separate_batch_stereo
    assert separate_batch_stereo(model, x, pp, Lb).shape == (3, 2, 2, Lb)
    with pytest.raises(ValueError, match="stereo preset expects"):
        StreamSeparator(pp, state, device="cpu").separate_many([tracks[0][0]])


def test_unported_options_raise(ikala, tmp_path):
    """``apply_fn=`` raises; ``mesh=``, refused until distributed was
    ported, separates: on a mesh of one rank the stems equal the unsharded
    ones bit for bit (the same batch on the same device)."""
    _, _, pp, state, model = ikala
    tracks = tracks_of(3)
    with one_rank_mesh(str(tmp_path / "store")) as mesh:
        meshed = StreamSeparator(pp, state, mesh=mesh, device="cpu").separate_many(tracks)
    for got, want in zip(meshed, StreamSeparator(pp, state, device="cpu").separate_many(tracks)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match="Also left out"):
        StreamSeparator(pp, state, apply_fn=lambda *a: a, device="cpu")
    x, Lb = stacked(tracks_of(1), pp)
    with pytest.raises(NotImplementedError, match="Also left out"):
        separate_batch(model, x, pp, Lb, apply_fn=lambda *a: a)
    if not torch.cuda.is_available():  # device None means "cuda", never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            StreamSeparator(pp, state)


@pytest.mark.parametrize("S,stereo", [(2, False), (4, False), (4, True)])
def test_derive_last_stem_matches_reference(rng, S, stereo):
    """The PCM16 integer path of the host complement against the
    reference's float32 arithmetic, bit for bit, clipping included; the
    other dtype pairs take the float path."""
    from convsep_tpu.separate.complement import derive_last_stem as jax_derive
    from convsep_tpu_torch.separate import derive_last_stem

    lead = (2,) if stereo else ()
    others = rng.integers(-32768, 32768, size=(S - 1, *lead, 50_000)).astype(np.int16)
    mix = rng.integers(-32768, 32768, size=(*lead, 50_000)).astype(np.int16)
    got = derive_last_stem(others, mix, "int16", "int16")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, jax_derive(others, mix, "int16", "int16"))
    for i, o in (("int16", "float32"), ("float32", "int16"), ("float32", "float32")):
        x = mix if i == "int16" else mix.astype(np.float32) / 32768
        y = others if o == "int16" else others.astype(np.float32) / 32768
        np.testing.assert_array_equal(derive_last_stem(y, x, i, o), jax_derive(y, x, i, o))
