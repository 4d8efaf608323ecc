"""Feature files, port against reference, on CPU: tensor and pickle files,
segmentation, the complex-spectrum STFT API, the synthetic fixtures,
``compute_features`` and ``SegmentDataset`` (native gather and numpy),
each held against its ``convsep_tpu`` counterpart at the JAX tests' tiny
geometry (``tests/test_separate.py::tiny_preset``: 8 kHz, W 256, hop 128;
``tests/test_train.py``'s feature directory: 3 tracks of 2 s).

Tolerances: files, segmentation, ``note_mixture`` and batches bit for bit;
spectra, feature files and the iSTFT within 1e-5 of the peak (float32
sums of the same products in another order)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from convsep_tpu.data import io as jax_io
from convsep_tpu.data import segment as jax_segment
from convsep_tpu.data import synth as jax_synth
from convsep_tpu.data.features import compute_features as jax_compute_features
from convsep_tpu.data.pipeline import SegmentDataset as JaxSegmentDataset
from convsep_tpu.dsp import istft as jax_istft
from convsep_tpu.dsp import magphase as jax_magphase
from convsep_tpu.dsp import stft as jax_stft_fn
from convsep_tpu_torch.configs import preset_from_dict
from convsep_tpu_torch.data import fastbatch, io, segment, synth
from convsep_tpu_torch.data.features import compute_features
from convsep_tpu_torch.data.pipeline import SegmentDataset
from convsep_tpu_torch.dsp.istft import istft
from convsep_tpu_torch.dsp.stft import magphase, stft
from convsep_tpu_torch.dsp.transform import TransformFFT
from convsep_tpu_torch.dsp.windows import sinebell
from tests.test_separate import tiny_preset
from tests.test_torch_chunked import one_intraop_thread  # noqa: F401

FS = 8000
TOL = 1e-5  # × the peak
SOURCES = ("vocals", "accompaniment")


def port(jp):
    return preset_from_dict(dataclasses.asdict(jp))


def assert_peak_close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape, msg)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{msg}: max err {err:.3e} > {tol} × peak {peak:.3e}"


def same_feature_dirs(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for n in names:
        if n.endswith(".data"):
            assert_peak_close(io.load_tensor(os.path.join(got_dir, n)),
                              jax_io.load_tensor(os.path.join(want_dir, n)), msg=n)
        else:  # .shape sidecars: the same text
            with open(os.path.join(got_dir, n)) as a, open(os.path.join(want_dir, n)) as b:
                assert a.read() == b.read(), n


# -- files -----------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tensor_files_cross_load_byte_for_byte(rng, tmp_path, writer):
    arr = rng.standard_normal((37, 13)).astype(np.float32)
    save, load = (io.save_tensor, jax_io.load_tensor) if writer == "port" else (
        jax_io.save_tensor, io.load_tensor)
    path = str(tmp_path / "t.mix.data")
    save(arr, path)
    for mmap in (True, False):
        got = load(path, mmap=mmap)
        assert got.dtype == np.float32 and got.shape == arr.shape
        assert np.asarray(got).tobytes() == arr.tobytes()
    other = str(tmp_path / "u.mix.data")
    (jax_io.save_tensor if writer == "port" else io.save_tensor)(arr, other)
    for ext in (".data", ".shape"):
        with open(path[:-5] + ext, "rb") as a, open(other[:-5] + ext, "rb") as b:
            assert a.read() == b.read()
    with pytest.raises(ValueError, match=".data"):
        io.save_tensor(arr, str(tmp_path / "bad.bin"))


def test_pickle_roundtrip_both_ways(tmp_path):
    obj = {"a": np.arange(3), "b": "x", "c": [1.5, None]}
    io.save_obj(obj, tmp_path / "p.pkl")
    jax_io.save_obj(obj, tmp_path / "j.pkl")
    for got in (jax_io.load_obj(tmp_path / "p.pkl"), io.load_obj(tmp_path / "j.pkl"),
                io.load_obj(tmp_path / "p.pkl")):
        assert got["b"] == "x" and got["c"] == [1.5, None]
        np.testing.assert_array_equal(got["a"], obj["a"])


# -- segmentation ----------------------------------------------------------

@pytest.mark.parametrize("n,T,step,want", [(90, 30, 30, 3), (91, 30, 30, 4), (30, 30, 30, 1),
                                           (10, 30, 30, 1), (100, 30, 10, 8), (100, 30, 7, 11)])
def test_segment_count_matches_jax(n, T, step, want):
    assert segment.segment_count(n, T, step) == jax_segment.segment_count(n, T, step) == want


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("n,step", [(71, None), (71, 30), (100, 10), (100, 7), (30, 10), (5, 7)])
def test_segment_frames_match_jax(rng, kind, n, step):
    x = rng.standard_normal((2, n, 13)).astype(np.float32)
    want = np.asarray(jax_segment.segment_frames(x, 30, step))
    want_pad, want_n = jax_segment.pad_frames_to_segments(x, 30, step)
    arg = x if kind == "numpy" else torch.from_numpy(x)
    got = segment.segment_frames(arg, 30, step)
    pad, nseg = segment.pad_frames_to_segments(arg, 30, step)
    assert isinstance(got, type(arg)) and isinstance(pad, type(arg))
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(pad), np.asarray(want_pad))
    assert nseg == want_n
    if step in (None, 30):
        np.testing.assert_array_equal(np.asarray(segment.unsegment_frames(got, n)), x)


# -- the complex-spectrum API ----------------------------------------------

@pytest.mark.parametrize("W,hop,nfft,L", [(256, 128, None, 3001), (256, 64, 512, 2000),
                                          (1024, 512, None, 8192)])
def test_stft_magphase_istft_match_jax(rng, W, hop, nfft, L):
    x = (0.3 * rng.standard_normal((2, L))).astype(np.float32)
    win = sinebell(W)
    spec = stft(torch.from_numpy(x), win, hop, nfft)
    want = np.asarray(jax_stft_fn(x, win, hop, nfft))
    assert spec.dtype == torch.complex64
    assert_peak_close(spec.numpy().real, want.real, msg="re")
    assert_peak_close(spec.numpy().imag, want.imag, msg="im")
    mag, ph = magphase(spec)
    jmag, jph = jax_magphase(want)
    assert mag.dtype == ph.dtype == torch.float32
    assert_peak_close(mag.numpy(), np.asarray(jmag), msg="mag")
    # the phase where the magnitude is not negligible (angle of ~0 is noise)
    big = np.asarray(jmag) > 1e-3 * float(np.asarray(jmag).max())
    d = np.angle(np.exp(1j * (ph.numpy() - np.asarray(jph))))[big]
    assert np.abs(d).max() < 1e-3
    y = istft(spec, win, hop, L, nfft=nfft)
    want_y = np.asarray(jax_istft(want, win, hop, L, nfft=nfft))
    assert_peak_close(y.numpy(), want_y, msg="istft")
    assert_peak_close(y.numpy(), x, tol=1e-5, msg="round trip")
    with pytest.raises(ValueError, match="frames"):
        istft(spec, win, hop, L + 10 * hop, nfft=nfft)


# -- synthetic fixtures ----------------------------------------------------

@pytest.mark.parametrize("S,seed,notes", [(4, 0, 6), (2, 3, 4), (3, 7, 9)])
def test_note_mixture_bit_for_bit(S, seed, notes):
    got = synth.note_mixture(S, 2 * FS, fs=FS, notes_per_source=notes, seed=seed)
    want = jax_synth.note_mixture(S, 2 * FS, fs=FS, notes_per_source=notes, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [[dataclasses.astuple(n) for n in ns] for ns in got[2]] == \
        [[dataclasses.astuple(n) for n in ns] for ns in want[2]]


def test_synth_feature_dir_matches_jax(tmp_path):
    kw = dict(num_tracks=3, seconds=2.0, fs=FS, frame_size=256, hop_size=128, seed=4)
    got = synth.synth_feature_dir(str(tmp_path / "p"), SOURCES, device="cpu", **kw)
    want = jax_synth.synth_feature_dir(str(tmp_path / "j"), SOURCES, **kw)
    assert got == want == ["track000", "track001", "track002"]
    same_feature_dirs(tmp_path / "p", tmp_path / "j")


# -- compute_features ------------------------------------------------------

def _trackdirs(root, n=2, seconds=1.0, freqs=(220.0, 1400.0), notes=None):
    for i in range(n):
        d = root / f"t{i}"
        d.mkdir(parents=True)
        stems, _ = synth.sine_mixture(2, int(seconds * FS), fs=FS, freqs=freqs, seed=i)
        io.write_wav(d / "vocals.wav", FS, stems[0])
        io.write_wav(d / "accompaniment.wav", FS, stems[1])
        for s, text in (notes or {}).items():
            (d / f"{s}.notes.txt").write_text(text)


CASES = {
    "trackdirs": dict(),
    "multires": dict(multires=True),
    "score": dict(score_informed=True),
    "score_augment2": dict(score_informed=True, augment=2),
    "ikala_stereo": dict(layout="ikala-stereo"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_features_matches_jax(tmp_path, case):
    kw = dict(CASES[case])
    jp = tiny_preset("ikala")
    if kw.pop("multires", False):
        jp = dataclasses.replace(jp, transform=dataclasses.replace(jp.transform,
                                                                   multires=(64, 128)))
    adir = tmp_path / "audio"
    if kw.get("layout") == "ikala-stereo":
        adir.mkdir()
        for i in range(2):
            stems, _ = synth.sine_mixture(2, FS, fs=FS, seed=i)
            io.write_wav(adir / f"clip{i}.wav", FS, np.stack([stems[1], stems[0]], axis=1))
    else:
        notes = ({"vocals": "0.0 0.6 57\n0.6 1.0 59\n", "accompaniment": "0.0 1.0 89\n"}
                 if kw.get("score_informed") else None)
        _trackdirs(adir, notes=notes)
    got = compute_features(str(adir), str(tmp_path / "p"), port(jp), device="cpu", **kw)
    want = jax_compute_features(str(adir), str(tmp_path / "j"), jp, **kw)
    assert got == want
    same_feature_dirs(tmp_path / "p", tmp_path / "j")
    if "multires" in case:
        assert os.path.exists(tmp_path / "p" / "t0.res64.data")


def test_compute_features_rejects_like_jax(tmp_path):
    pp = port(tiny_preset("ikala"))
    with pytest.raises(ValueError, match="unknown layout"):
        compute_features(str(tmp_path), str(tmp_path), pp, layout="x", device="cpu")
    adir = tmp_path / "mono"
    adir.mkdir()
    io.write_wav(adir / "m.wav", FS, np.zeros(FS, np.float32))
    with pytest.raises(ValueError, match="stereo"):
        compute_features(str(adir), str(tmp_path / "f"), pp, layout="ikala-stereo",
                         device="cpu")
    _trackdirs(tmp_path / "a", n=1)
    with pytest.raises(FileNotFoundError, match="notes.txt"):
        compute_features(str(tmp_path / "a"), str(tmp_path / "g"), pp, score_informed=True,
                         device="cpu")


def test_compute_transform_matches_compute_file(rng, tmp_path):
    t = TransformFFT(port(tiny_preset("ikala")).transform, device="cpu")
    audio = (0.2 * rng.standard_normal(3000)).astype(np.float32)
    t.compute_transform(audio, str(tmp_path / "sub" / "x"), phase=True)
    mag, ph = t.compute_file(audio, phase=True)
    np.testing.assert_array_equal(io.load_tensor(str(tmp_path / "sub" / "x.data")), mag)
    np.testing.assert_array_equal(io.load_tensor(str(tmp_path / "sub" / "x.phase.data")), ph)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None is valid here")
    pp = port(tiny_preset("ikala"))
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_features(str(tmp_path), str(tmp_path / "f"), pp)
    with pytest.raises(RuntimeError, match="CUDA"):
        synth.synth_feature_dir(str(tmp_path / "s"), SOURCES, num_tracks=1, seconds=0.1, fs=FS)


# -- SegmentDataset --------------------------------------------------------

@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    """tests/test_train.py's feature directory (3 tracks of 2 s), written by
    the JAX package, plus a score channel per source."""
    d = str(tmp_path_factory.mktemp("feats"))
    jax_synth.synth_feature_dir(d, SOURCES, num_tracks=3, seconds=2.0, fs=FS,
                                frame_size=256, hop_size=128)
    for name in ("track000", "track001", "track002"):
        mix = jax_io.load_tensor(os.path.join(d, f"{name}.mix.data"))
        jax_io.save_tensor(0.5 * np.asarray(mix), os.path.join(d, f"{name}.score_v.data"))
    return d


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kw", [dict(time_context=10, overlap=5),
                                dict(time_context=30, overlap=20, extra_channels=("score_v",)),
                                dict(time_context=10, overlap=3, mult_factor_in=0.7)],
                         ids=["T10", "T30_extra", "T10_step7"])
def test_segment_dataset_matches_jax(feature_dir, native, kw):
    if native and not fastbatch.available():
        pytest.skip("no C++ compiler: the native gather cannot be built")
    ds = SegmentDataset(feature_dir, SOURCES, **kw)
    jds = JaxSegmentDataset(feature_dir, SOURCES, **kw)
    assert ds._tracks == jds._tracks and ds._index == jds._index
    assert len(ds) == len(jds) and ds.num_channels == jds.num_channels
    idx = np.random.default_rng(1).permutation(len(ds))[:9]
    x, y = ds._assemble(idx, native=native)
    jx, jy = jds._assemble(idx)  # the JAX package's own choice of path
    assert x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    gx, gy = ds.get(int(idx[0]))
    np.testing.assert_array_equal(gx, x[0])
    np.testing.assert_array_equal(gy, y[0])


@pytest.mark.parametrize("start,drop", [(0, True), (2, True), (1, False)])
def test_segment_dataset_batches_match_jax(feature_dir, start, drop):
    kw = dict(time_context=10, overlap=5, extra_channels=("score_v",))
    ds, jds = SegmentDataset(feature_dir, SOURCES, **kw), JaxSegmentDataset(feature_dir,
                                                                           SOURCES, **kw)
    B = 7
    got = list(ds.batches(B, seed=3, drop_remainder=drop, start=start))
    want = list(jds.batches(B, seed=3, drop_remainder=drop, start=start))
    assert len(got) == len(want) > 0
    for (x, y), (jx, jy) in zip(got, want):
        assert x.shape == (B, 10, 129, 2) and y.shape == (B, 2, 10, 129)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    idx = list(ds.batch_indices(B, seed=3, drop_remainder=drop, start=start))
    assert [len(i) for i in idx] == [min(B, len(ds) - (start + k) * B) for k in range(len(idx))]


def test_segment_dataset_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="mix.data"):
        SegmentDataset(str(tmp_path), SOURCES)
    io.save_tensor(np.zeros((20, 129), np.float32), str(tmp_path / "a.mix.data"))
    with pytest.raises(FileNotFoundError, match="vocals"):
        SegmentDataset(str(tmp_path), SOURCES)
    with pytest.raises(ValueError, match="overlap"):
        SegmentDataset(str(tmp_path), SOURCES, time_context=10, overlap=10)
