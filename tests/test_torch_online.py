"""Online separation, port against reference, on CPU: the port's
``OnlineSeparator`` (device="cpu") against its own ``ChunkedSeparator``
(bit for bit: the same chunk program on the same slices and normalization)
and against the JAX ``OnlineSeparator`` with the same weights, at the JAX
tests' tiny geometry (``tests/test_chunked.py::tiny_preset``).

Tolerances: bit for bit against the port's chunked stems; 2e-5 absolute
against the reference's online stems (its chunked ≡ whole-track bound;
multi-resolution stems ``test_torch_chunked.TOL_MULTIRES``, set there
from a witness);
int16 ±1 LSB against the reference; a stem derived on the host
(``complement_last``) 2e-4 from the whole-track conservative stem (the
reference's online complement bound)."""

import dataclasses

import numpy as np
import pytest

from convsep_tpu.configs.presets import stereo_preset
from convsep_tpu.dsp.stft import num_frames
from convsep_tpu.separate import OnlineSeparator as JaxOnline
from convsep_tpu_torch.separate import ChunkedSeparator, OnlineSeparator, Separator
from tests.test_chunked import _params, tiny_preset
from tests.test_torch_chunked import TOL_MULTIRES, noise, one_intraop_thread, port  # noqa: F401

TOL = 2e-5


def push_all(osep, audio, block_sizes, extra=None):
    """Push ``audio`` in blocks cycling through ``block_sizes``, then flush."""
    outs, pos = [], 0
    while pos < audio.shape[-1]:
        n = int(block_sizes[len(outs) % len(block_sizes)])
        outs.append(osep.push(audio[..., pos: pos + n]))
        pos += n
    outs.append(osep.flush())
    return np.concatenate(outs, axis=-1)


@pytest.fixture(scope="module")
def base():
    jp = tiny_preset()
    params = _params(jp)
    return (jp, params, *port(jp, params))


@pytest.mark.parametrize("seconds", [0.4, 1.0, 2.37])
@pytest.mark.parametrize("blocks", [(160,), (7, 311, 64), (100_000,), "random"])
def test_online_equals_chunked_bit_for_bit(rng, base, seconds, blocks):
    jp, params, pp, state = base
    L = int(seconds * pp.transform.fs)
    audio = noise(rng, L)
    if blocks == "random":
        blocks = rng.integers(1, 3000, size=17)
    got = push_all(OnlineSeparator(pp, state, chunk_segments=2, device="cpu"), audio, blocks)
    ref = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio)
    assert got.shape == ref.shape == (4, L)
    np.testing.assert_array_equal(got, ref)
    want = push_all(JaxOnline(jp, params, chunk_segments=2), audio, blocks)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_online_emits_progressively(rng, base):
    """Stems come out mid-stream once the latency window passes."""
    _, _, pp, state = base
    osep = OnlineSeparator(pp, state, chunk_segments=2, device="cpu")
    lat = osep.latency_samples
    assert lat == osep.chunk_samples + pp.transform.frame_size
    audio = noise(rng, 4 * lat)
    early = osep.push(audio)
    assert early.shape[-1] >= audio.shape[-1] - lat > 0
    full = np.concatenate([early, osep.flush()], axis=-1)
    np.testing.assert_allclose(full, Separator(pp, state, device="cpu")(audio), atol=TOL, rtol=0)


@pytest.mark.parametrize("max_pending", [1, 3])
def test_online_pipelined_equals_chunked(rng, base, max_pending):
    """max_pending > 0: a chunk's emission may slide to a later push."""
    _, _, pp, state = base
    osep = OnlineSeparator(pp, state, chunk_segments=2, max_pending=max_pending, device="cpu")
    audio = noise(rng, 6 * osep.latency_samples)
    got = push_all(osep, audio, (501, 1733))
    np.testing.assert_array_equal(
        got, ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio))


def test_online_multires_matches_jax(rng):
    jp = tiny_preset()
    jp = dataclasses.replace(
        jp, transform=dataclasses.replace(jp.transform, multires=(64, 128)),
        model=dataclasses.replace(jp.model, channels_in=3))
    params = _params(jp)
    pp, state = port(jp, params)
    audio = noise(rng, 10_000)
    got = push_all(OnlineSeparator(pp, state, chunk_segments=2, device="cpu"), audio, (999,))
    np.testing.assert_array_equal(
        got, ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio))
    want = push_all(JaxOnline(jp, params, chunk_segments=2), audio, (999,))
    np.testing.assert_allclose(got, want, atol=TOL_MULTIRES, rtol=0)


def test_online_stereo_matches_jax(rng):
    base_p = tiny_preset(name="ikala")
    jp = stereo_preset(dataclasses.replace(
        base_p, model=dataclasses.replace(base_p.model, channels_in=1)))
    params = _params(jp)
    pp, state = port(jp, params)
    audio = noise(rng, (2, 9_321))
    got = push_all(OnlineSeparator(pp, state, chunk_segments=2, device="cpu"), audio, (1000,))
    assert got.shape == (2, 2, 9_321)
    chunked = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio)
    np.testing.assert_array_equal(got, chunked.transpose(0, 2, 1))
    want = push_all(JaxOnline(jp, params, chunk_segments=2), audio, (1000,))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="stereo push"):
        OnlineSeparator(pp, state, device="cpu").push(audio[0])


def test_online_pcm16_matches_jax(rng):
    jp = tiny_preset(name="ikala")
    params = _params(jp)
    pp, state = port(jp, params)
    pcm = (1000 * rng.standard_normal(9_000)).clip(-32768, 32767).astype(np.int16)
    kw = dict(chunk_segments=2, output_dtype="int16", input_dtype="int16")
    got = push_all(OnlineSeparator(pp, state, device="cpu", **kw), pcm, (999,))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ChunkedSeparator(pp, state, device="cpu", **kw)(pcm))
    want = push_all(JaxOnline(jp, params, **kw), pcm, (999,))
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_online_score_informed_matches_jax(rng):
    """Conditioning frames pushed at their own cadence."""
    jp = tiny_preset(name="bach10")
    params = _params(jp)
    pp, state = port(jp, params)
    L = 9_000
    audio = noise(rng, L)
    nf = num_frames(L, jp.transform.hop_size)
    extra = rng.standard_normal((nf, jp.model.feat_size, 4)).astype(np.float32)

    def run(osep):
        outs, pos, fpos = [], 0, 0
        blocks = (311, 1024, 97)
        while pos < L or fpos < nf:
            n = blocks[len(outs) % len(blocks)]
            k = min(nf - fpos, 1 + n // jp.transform.hop_size)
            outs.append(osep.push(audio[pos: pos + n], extra=extra[fpos: fpos + k]))
            pos += n
            fpos += k
        outs.append(osep.flush())
        return np.concatenate(outs, axis=-1)

    got = run(OnlineSeparator(pp, state, chunk_segments=2, device="cpu"))
    ref = ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio, extra=extra)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, run(JaxOnline(jp, params, chunk_segments=2)), atol=TOL,
                               rtol=0)
    osep = OnlineSeparator(pp, state, chunk_segments=2, device="cpu")
    with pytest.raises(ValueError, match="extra must be"):
        osep.push(audio[:100], extra=np.zeros((2, 3, 4), np.float32))


@pytest.mark.parametrize("out", ["float32", "int16"])
def test_online_complement_last_matches_chunked(rng, base, out):
    jp, params, pp, state = base
    kw = dict(chunk_segments=2, complement_last=True, output_dtype=out, input_dtype=out)
    osep = OnlineSeparator(pp, state, max_pending=2, device="cpu", **kw)
    audio = noise(rng, 5 * osep.latency_samples)
    if out == "int16":
        audio = np.clip(np.rint(audio * 32768), -32768, 32767).astype(np.int16)
    got = push_all(osep, audio, (999,))
    np.testing.assert_array_equal(got, ChunkedSeparator(pp, state, device="cpu", **kw)(audio))
    want = push_all(JaxOnline(jp, params, max_pending=2, **kw), audio, (999,))
    if out == "int16":
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        whole = Separator(pp, state, conserve_last=True, device="cpu")(audio)
        np.testing.assert_allclose(got, whole, atol=2e-4, rtol=0)


def test_online_reset_drains_and_errors(rng, base):
    _, _, pp, state = base
    osep = OnlineSeparator(pp, state, chunk_segments=2, max_pending=3, device="cpu")
    audio = noise(rng, 3 * osep.latency_samples)
    first = osep.push(audio)
    assert first.shape[-1] == 0 and osep._pending  # chunks in flight across pushes
    osep.reset()  # waits for them, then forgets the stream
    assert not osep._pending and osep._chunk == 0
    got = push_all(osep, audio, (777,))
    np.testing.assert_array_equal(
        got, ChunkedSeparator(pp, state, chunk_segments=2, device="cpu")(audio))
    with pytest.raises(RuntimeError, match="flush"):
        osep.push(audio)
    with pytest.raises(RuntimeError, match="flush"):
        osep.flush()
    osep.reset()
    again = push_all(osep, audio, (777,))
    np.testing.assert_array_equal(again, got)
    osep.reset()
    with pytest.raises(ValueError, match="no extra channels"):
        osep.push(audio[:10], extra=np.zeros((1, pp.model.feat_size, 1), np.float32))
    with pytest.raises(ValueError, match="mono push"):
        osep.push(np.zeros((2, 10), np.float32))


def test_online_close_releases(rng, base):
    _, _, pp, state = base
    osep = OnlineSeparator(pp, state, chunk_segments=2, max_pending=2, device="cpu")
    osep.push(noise(rng, 3 * osep.latency_samples))
    osep.close()
    assert not osep._pending and osep._copy is None and osep._spill is None
    osep.close()  # twice is allowed
    for call in (lambda: osep.push(np.zeros(10, np.float32)), osep.flush, osep.reset):
        with pytest.raises(RuntimeError, match="closed"):
            call()
