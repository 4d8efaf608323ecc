"""The watch-folder service, port against reference, on CPU: the port's
``WatchService`` (device="cpu") on a ``tmp_path`` folder against the JAX
``WatchService`` with the same weights on a copy of the same folder, at the
JAX tests' tiny geometry (``tests/test_chunked.py::tiny_preset``): the done
rule (a track is done when every stem wav exists), the stable-file rule (a
file is taken once its size held between two sweeps), the score rule (a
wav waits for its notes), and the stems.

Tolerance: PCM16 stem wavs ±1 LSB against the reference's (the same
float stems, rounded after sums in another order); bit for bit against the
port's ``StreamSeparator`` on the same batch."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from convsep_tpu.configs.presets import stereo_preset
from convsep_tpu.data.synth import note_mixture
from convsep_tpu.separate.service import WatchService as JaxWatch
from convsep_tpu_torch.data.io import read_wav, write_wav
from convsep_tpu_torch.separate import StereoSeparator, StreamSeparator, WatchService
from tests.test_chunked import _params, tiny_preset
from tests.test_torch_chunked import noise, port
from tests.torch_ranks import one_rank_mesh

FS = 8000


def pcm_of(path):
    fs, x = read_wav(path)
    return fs, np.rint(x * 32768.0).astype(np.int16)


def assert_same_stems(preset, out_a, out_b, names, lsb=1):
    for n in names:
        for s in preset.sources:
            fa, a = pcm_of(os.path.join(out_a, n, f"{s}.wav"))
            fb, b = pcm_of(os.path.join(out_b, n, f"{s}.wav"))
            assert fa == fb == preset.transform.fs and a.shape == b.shape
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= lsb


@pytest.fixture(scope="module")
def ikala():
    jp = tiny_preset(name="ikala")
    params = _params(jp)
    return (jp, params, *port(jp, params))


def test_sweeps_follow_the_done_and_stable_rules(rng, ikala, tmp_path):
    jp, params, pp, state = ikala
    incoming, out, jout = (str(tmp_path / d) for d in ("incoming", "done", "jax"))
    os.makedirs(incoming)
    for i in range(3):
        write_wav(os.path.join(incoming, f"t{i}.wav"), FS, noise(rng, FS + 500 * i))
    open(os.path.join(incoming, "notes.txt"), "w").close()  # not a wav: ignored
    svc = WatchService(pp, state, incoming, out, batch_size=2, poll_s=0.0, device="cpu")
    assert svc.pending() == []  # no size known yet: nothing is stable
    assert svc.pending() == ["t0", "t1", "t2"]
    assert svc.sweep() == 3  # batches of 2 and 1
    for i in range(3):
        assert sorted(os.listdir(os.path.join(out, f"t{i}"))) == sorted(
            f"{s}.wav" for s in pp.sources)
    assert svc.sweep() == 0 and svc.pending() == []  # all done
    # the stems: the reference's service on the same files, and the port's
    # stream separator on the same batches
    jsvc = JaxWatch(jp, params, incoming, jout, batch_size=2, poll_s=0.0)
    jsvc.pending()
    assert jsvc.sweep() == 3
    assert_same_stems(pp, out, jout, ["t0", "t1", "t2"])
    ss = StreamSeparator(pp, state, output_dtype="int16", input_dtype="int16", device="cpu")
    for batch in (["t0", "t1"], ["t2"]):
        tracks = [read_wav(os.path.join(incoming, n + ".wav"))[1] for n in batch]
        for n, stems in zip(batch, ss.separate_many(tracks)):
            for s, stem in zip(pp.sources, stems):
                np.testing.assert_array_equal(pcm_of(os.path.join(out, n, f"{s}.wav"))[1], stem)
    # a partly written output is separated again (crash-safe resume)
    os.remove(os.path.join(out, "t1", f"{pp.sources[0]}.wav"))
    svc2 = WatchService(pp, state, incoming, out, poll_s=0.0, device="cpu")
    assert svc2.run(max_sweeps=2) == 1 and svc2._done("t1")


def test_a_growing_file_waits(rng, ikala, tmp_path):
    _, _, pp, state = ikala
    incoming, out = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(incoming)
    path = os.path.join(incoming, "late.wav")
    audio = noise(rng, 3 * FS)
    write_wav(path, FS, audio[:FS])
    svc = WatchService(pp, state, incoming, out, poll_s=0.0, device="cpu")
    assert svc.sweep() == 0
    write_wav(path, FS, audio[: 2 * FS])  # still being written
    assert svc.sweep() == 0
    assert svc.sweep() == 1 and svc._done("late")
    assert read_wav(os.path.join(out, "late", f"{pp.sources[0]}.wav"))[1].shape == (2 * FS,)


def test_run_stops_and_reports(rng, ikala, tmp_path):
    _, _, pp, state = ikala
    incoming, out = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(incoming)
    write_wav(os.path.join(incoming, "a.wav"), FS, noise(rng, FS))
    svc = WatchService(pp, state, incoming, out, poll_s=0.0, device="cpu")
    seen = []
    stops = iter([False, False, True])
    assert svc.run(should_stop=lambda: next(stops), on_sweep=seen.append) == 1
    assert seen == [0, 1, 0]
    assert svc.run(max_sweeps=1) == 0


def test_score_dir_waits_for_the_notes_and_matches_jax(tmp_path):
    jp = tiny_preset(name="bach10")
    params = _params(jp)
    pp, state = port(jp, params)
    S = pp.model.num_sources
    wavs, scores, out, jout = (tmp_path / d for d in ("in", "scores", "out", "jax"))
    wavs.mkdir()
    notes = {}
    for i in range(2):
        _, mix, ns = note_mixture(S, FS, fs=FS, notes_per_source=2, seed=i)
        write_wav(wavs / f"p{i}.wav", FS, mix)
        notes[f"p{i}"] = ns

    def put_score(name):
        (scores / name).mkdir(parents=True)
        for s, src_notes in zip(pp.sources, notes[name]):
            with open(scores / name / f"{s}.notes.txt", "w") as f:
                for n in src_notes:
                    f.write(f"{n.start_sec} {n.end_sec} {n.pitch_midi}\n")

    put_score("p0")
    kw = dict(batch_size=2, poll_s=0.0, score_dir=str(scores), score_filter="comb")
    svc = WatchService(pp, state, str(wavs), str(out), device="cpu", **kw)
    svc.pending()
    assert svc.sweep() == 1  # p1's score has not arrived
    assert (out / "p0").is_dir() and not (out / "p1").exists()
    put_score("p1")
    svc.pending()
    assert svc.sweep() == 1
    jsvc = JaxWatch(jp, params, str(wavs), str(jout), **kw)
    jsvc.pending()
    jsvc.pending()
    assert jsvc.sweep() == 2
    assert_same_stems(pp, str(out), str(jout), ["p0", "p1"])


def test_stereo_service_and_refusals(rng, tmp_path):
    base_p = tiny_preset(name="ikala")
    jp = stereo_preset(dataclasses.replace(
        base_p, model=dataclasses.replace(base_p.model, channels_in=1)))
    pp, state = port(jp, _params(jp))
    incoming, out = str(tmp_path / "in"), str(tmp_path / "out")
    os.makedirs(incoming)
    audio = noise(rng, (FS + 300, 2))  # the wav layout
    write_wav(os.path.join(incoming, "st.wav"), FS, audio)
    svc = WatchService(pp, state, incoming, out, poll_s=0.0, device="cpu")
    assert svc.run(max_sweeps=2) == 1
    want = StereoSeparator(pp, state, output_dtype="int16", input_dtype="int16",
                           device="cpu")(read_wav(os.path.join(incoming, "st.wav"))[1])
    for s, stem in zip(pp.sources, want):
        np.testing.assert_array_equal(pcm_of(os.path.join(out, "st", f"{s}.wav"))[1], stem)
    with pytest.raises(ValueError, match="mono-preset only"):
        WatchService(pp, state, incoming, out, score_dir=incoming, device="cpu")
    # a mesh of one rank (refused until distributed was ported) writes the same stems
    meshed = str(tmp_path / "meshed")
    with one_rank_mesh(str(tmp_path / "store")) as mesh:
        assert WatchService(pp, state, incoming, meshed, poll_s=0.0, mesh=mesh).run(
            max_sweeps=2) == 1
    for s in pp.sources:
        np.testing.assert_array_equal(pcm_of(os.path.join(meshed, "st", f"{s}.wav"))[1],
                                      pcm_of(os.path.join(out, "st", f"{s}.wav"))[1])
    mono = port(tiny_preset(name="ikala"), _params(tiny_preset(name="ikala")))
    shutil.rmtree(out)
    bad = WatchService(dataclasses.replace(
        mono[0], transform=dataclasses.replace(mono[0].transform, fs=16000)), mono[1],
        incoming, out, poll_s=0.0, device="cpu")
    bad.pending()
    with pytest.raises(ValueError, match="fs 8000"):
        bad.sweep()
