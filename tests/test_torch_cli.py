"""The port's CLI on CPU (``convsep_tpu_torch.cli.main`` with ``--device
cpu``), modelled on ``tests/test_cli.py``: the same tiny preset
(``tests/test_cli.py::_tiny_ikala``, 8 kHz, W 256, hop 128, T 10, narrow
convolutions) injected into both packages' ``PRESETS``, every verb's
journey, and the reference CLI beside it.

Tolerances: one seeded reference pickle through ``convsep separate`` and
``convsep-torch separate`` gives int16 stems within ±1 LSB (the
reference's int16 golden bound); feature files from both
``compute-features`` within 1e-5 × peak (float32 DFT products, sums in
another order); chunked and online stems within the reference CLI test's
bounds of the whole-track stems."""

import dataclasses
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from convsep_tpu import cli as jax_cli
from convsep_tpu.configs import presets as jax_presets
from convsep_tpu.configs.presets import stereo_preset as jax_stereo_preset
from convsep_tpu_torch import cli
from convsep_tpu_torch.ckpt import CheckpointManager
from convsep_tpu_torch.configs import presets as port_presets
from convsep_tpu_torch.configs.presets import preset_from_dict
from convsep_tpu_torch.data.io import load_tensor, read_wav, write_wav
from convsep_tpu_torch.data.synth import note_mixture, sine_mixture
from convsep_tpu_torch.utils.pcm import quantize_pcm16_host
from tests.test_cli import _tiny_ikala
from tests.test_convert import _random_reference_values
from tests.test_torch_chunked import one_intraop_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 8000
LSB = 1.0 / 32768.0
CPU = ["--device", "cpu"]


def _port(jax_preset):
    return preset_from_dict(dataclasses.asdict(jax_preset))


def _tiny_bach():
    p = jax_presets.PRESETS["bach10"]()
    t = jax_presets.TransformConfig(fs=FS, frame_size=256, hop_size=128)
    return dataclasses.replace(
        p, name="tinybach", transform=t,
        model=dataclasses.replace(p.model, time_context=10, feat_size=t.bins, conv1_filters=4,
                                  conv1_freq=8, conv2_filters=4, bottleneck=16),
        train=dataclasses.replace(p.train, batch_size=4, num_epochs=1, time_context=10,
                                  overlap=5),
        sep=dataclasses.replace(p.sep, segment_bucket=2),
    )


TINY = {"tinyikala": _tiny_ikala, "tinybach": _tiny_bach,
        "tinyikala-stereo": lambda: jax_stereo_preset(_tiny_ikala())}


@pytest.fixture(autouse=True)
def tiny_presets(monkeypatch):
    for name, make in TINY.items():
        monkeypatch.setitem(jax_presets.PRESETS, name, make)
        monkeypatch.setitem(port_presets.PRESETS, name, lambda make=make: _port(make()))


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    for i in range(2):
        d = root / f"track{i}"
        d.mkdir()
        stems, mix = sine_mixture(2, 2 * FS, fs=FS, freqs=(220.0, 1400.0), seed=i)
        write_wav(d / "vocals.wav", FS, stems[0])
        write_wav(d / "accompaniment.wav", FS, stems[1])
        write_wav(d / "mixture.wav", FS, mix)
    return str(root)


def _pickle(path, preset_name="tinyikala", seed=0) -> str:
    vals = _random_reference_values(TINY[preset_name]().model, np.random.default_rng(seed))
    with open(path, "wb") as f:
        pickle.dump(vals, f, protocol=2)
    return str(path)


def _wavs(d, names):
    return {n: read_wav(os.path.join(d, f"{n}.wav"))[1] for n in names}


def test_full_cli_journey(audio_dir, tmp_path, capsys):
    """compute-features → train (and --resume) → separate from the
    checkpoint → evaluate → bench."""
    feats = str(tmp_path / "feats")
    assert cli.main(["compute-features", "--preset", "tinyikala", "--audio-dir", audio_dir,
                     "--out", feats, *CPU]) == 0
    assert os.path.exists(os.path.join(feats, "track0.mix.data"))
    wd = str(tmp_path / "run")
    assert cli.main(["train", "--preset", "tinyikala", "--features", feats, "--workdir", wd,
                     *CPU]) == 0
    assert os.path.exists(os.path.join(wd, "metrics.jsonl"))
    steps = os.listdir(os.path.join(wd, "checkpoints"))
    capsys.readouterr()
    assert cli.main(["train", "--preset", "tinyikala", "--features", feats, "--workdir", wd,
                     "--epochs", "2", "--resume", *CPU]) == 0
    assert "resumed from step" in capsys.readouterr().out
    assert max(map(int, os.listdir(os.path.join(wd, "checkpoints")))) > max(map(int, steps))

    est = str(tmp_path / "est")
    assert cli.main(["separate", "--preset", "tinyikala", "--params",
                     os.path.join(wd, "checkpoints"), "-i",
                     os.path.join(audio_dir, "track0", "mixture.wav"), "-o", est, *CPU]) == 0
    assert sorted(os.listdir(est)) == ["accompaniment.wav", "vocals.wav"]
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    for s in ("vocals", "accompaniment"):
        shutil.copy(os.path.join(audio_dir, "track0", f"{s}.wav"), ref)
    capsys.readouterr()
    assert cli.main(["evaluate", "--ref-dir", ref, "--est-dir", est, "--flen", "16", *CPU]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"vocals", "accompaniment"}
    assert all(np.isfinite(list(v.values())).all() for v in out.values())

    assert cli.main(["bench", "--preset", "tinyikala", "--seconds", "0.3", "--runs", "1",
                     *CPU]) == 0
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec) and rec["value"] > 0
    assert rec["detail"]["sections_skipped"] == []


def test_convert_roundtrip_and_checkpoint_separation(audio_dir, tmp_path):
    """pkl → checkpoint → pkl; the checkpoint and the pickle separate alike."""
    pkl = _pickle(tmp_path / "ref.pkl", seed=1)
    ck = str(tmp_path / "ck")
    assert cli.main(["convert", "--preset", "tinyikala", "--input", pkl, "--out", ck, *CPU]) == 0
    back = str(tmp_path / "back.pkl")
    assert cli.main(["convert", "--preset", "tinyikala", "--input", ck, "--out", back,
                     "--export", *CPU]) == 0
    with open(pkl, "rb") as f, open(back, "rb") as g:
        for a, b in zip(pickle.load(f), pickle.load(g), strict=True):
            np.testing.assert_allclose(a, b, atol=1e-6)
    mix = os.path.join(audio_dir, "track0", "mixture.wav")
    outs = []
    for params in (ck, pkl):
        outs.append(str(tmp_path / f"est{len(outs)}"))
        assert cli.main(["separate", "--preset", "tinyikala", "--params", params, "-i", mix,
                         "-o", outs[-1], *CPU]) == 0
    for n in ("vocals", "accompaniment"):
        np.testing.assert_array_equal(*(read_wav(os.path.join(o, f"{n}.wav"))[1] for o in outs))


def test_separate_batch_and_stereo_flag(audio_dir, tmp_path):
    pkl = _pickle(tmp_path / "m.pkl", seed=2)
    indir = str(tmp_path / "mixes")
    os.makedirs(indir)
    for i in range(3):
        shutil.copy(os.path.join(audio_dir, f"track{i % 2}", "mixture.wav"),
                    os.path.join(indir, f"m{i}.wav"))
    out = str(tmp_path / "out")
    assert cli.main(["separate-batch", "--preset", "tinyikala", "--params", pkl,
                     "--input-dir", indir, "-o", out, "--batch-size", "2", *CPU]) == 0
    assert sorted(os.listdir(out)) == ["m0", "m1", "m2"]
    # each track as the whole-track verb separates it
    one = str(tmp_path / "one")
    assert cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i",
                     os.path.join(indir, "m1.wav"), "-o", one, *CPU]) == 0
    for n in ("vocals", "accompaniment"):
        a = read_wav(os.path.join(out, "m1", f"{n}.wav"))[1]
        b = read_wav(os.path.join(one, f"{n}.wav"))[1]
        assert np.abs(a - b).max() <= 1.001 * LSB

    stems, _ = sine_mixture(2, 2 * FS, fs=FS, seed=9)
    st = str(tmp_path / "st.wav")
    write_wav(st, FS, np.stack([stems[0], stems[1]], axis=1))
    est = str(tmp_path / "est")
    assert cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i", st, "-o", est,
                     "--stereo", *CPU]) == 0
    v = read_wav(os.path.join(est, "vocals.wav"))[1]
    assert v.ndim == 2 and v.shape[1] == 2


def test_stereo_preset_cli(audio_dir, tmp_path):
    """A *-stereo preset separates through StereoSeparator (and --chunked)
    to stereo stems, and trains from audio on both channels: one epoch
    ends in a checkpoint whose state holds the joint-channel model's
    parameters."""
    root = tmp_path / "audio"
    d = root / "track0"
    d.mkdir(parents=True)
    stems, _ = sine_mixture(2, 2 * FS, fs=FS, freqs=(220.0, 1400.0), seed=0)
    v = np.stack([0.9 * stems[0], 0.3 * stems[0]], axis=1)
    a = np.stack([0.3 * stems[1], 0.9 * stems[1]], axis=1)
    write_wav(d / "vocals.wav", FS, v)
    write_wav(d / "accompaniment.wav", FS, a)
    write_wav(d / "mixture.wav", FS, v + a)
    run = tmp_path / "run"
    assert cli.main(["train", "--preset", "tinyikala-stereo", "--features", str(root),
                     "--workdir", str(run), "--from-audio", "--epochs", "1", *CPU]) == 0
    ck = CheckpointManager(str(run / "checkpoints"))
    step = ck.latest_step()
    assert step is not None and step > 0
    leaves = torch.load(run / "checkpoints" / str(step) / "state.pt", weights_only=True)
    assert leaves["step"] == step and all(torch.isfinite(v).all() for k, v in leaves.items()
                                          if k.startswith("params/"))
    pkl = _pickle(tmp_path / "m.pkl", "tinyikala-stereo", seed=3)
    whole, chunked = str(tmp_path / "whole"), str(tmp_path / "chunked")
    for out, extra in ((whole, []), (chunked, ["--chunked", "--chunk-segments", "2"])):
        assert cli.main(["separate", "--preset", "tinyikala-stereo", "--params", pkl, "-i",
                         str(d / "mixture.wav"), "-o", out, *extra, *CPU]) == 0
    for n in ("vocals", "accompaniment"):
        w = read_wav(os.path.join(whole, f"{n}.wav"))[1]
        c = read_wav(os.path.join(chunked, f"{n}.wav"))[1]
        assert w.shape == (2 * FS, 2) and np.abs(w - c).max() <= 1.001 * LSB


def test_train_from_audio_and_profile(audio_dir, tmp_path, capsys):
    wd = str(tmp_path / "run")
    assert cli.main(["train", "--preset", "tinyikala", "--features", audio_dir, "--workdir", wd,
                     "--epochs", "1", "--from-audio", "--optimizer-impl", "fused", *CPU]) == 0
    assert os.path.isdir(os.path.join(wd, "checkpoints"))
    ld = str(tmp_path / "trace")
    capsys.readouterr()
    assert cli.main(["profile", "--preset", "tinyikala", "--seconds", "0.5", "--logdir", ld,
                     "--top", "5", "--params", os.path.join(wd, "checkpoints"), *CPU]) == 0
    out = capsys.readouterr().out
    rows = json.loads(out[: out.rindex("]") + 1])
    assert 0 < len(rows) <= 5 and "trace ->" in out


def test_chunked_online_and_complement(audio_dir, tmp_path, capsys, monkeypatch):
    """--chunked and --online (a wav, and raw PCM16 on stdin) within the
    reference CLI test's bounds of the whole-track stems; --complement-last
    stems sum back to the mixture."""
    pkl = _pickle(tmp_path / "model.pkl", seed=4)
    mix = os.path.join(audio_dir, "track0", "mixture.wav")
    names = ("vocals", "accompaniment")
    run = {}
    for key, extra in (("whole", []), ("chunked", ["--chunked", "--chunk-segments", "2"]),
                       ("comp", ["--complement-last"]),
                       ("online", ["--online", "--chunk-segments", "4", "--block-samples",
                                   "1000"])):
        run[key] = str(tmp_path / key)
        capsys.readouterr()
        assert cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i", mix,
                         "-o", run[key], *extra, *CPU]) == 0
        if key == "online":
            stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert stats["mode"] == "online" and stats["pushed_samples"] == 2 * FS
            assert stats["rtf_steady"] > 0 and stats["latency_algo_s"] > 0
    whole = _wavs(run["whole"], names)
    for key in ("chunked", "online"):
        for n, w in _wavs(run[key], names).items():
            assert np.abs(w - whole[n]).max() <= 1.5 * LSB, (key, n)
    _, m = read_wav(mix)
    total = sum(s.astype(np.float64) for s in _wavs(run["comp"], names).values())
    assert np.abs(total - m).max() <= 2.5 * LSB

    class _Stdin:
        buffer = io.BytesIO(quantize_pcm16_host(np.asarray(m, np.float32)).tobytes())

    monkeypatch.setattr(sys, "stdin", _Stdin())
    est = str(tmp_path / "stdin")
    capsys.readouterr()
    assert cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i", "-", "-o", est,
                     "--online", "--chunk-segments", "4", *CPU]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["pushed_samples"] == len(m)
    for n, w in _wavs(est, names).items():
        np.testing.assert_array_equal(w, _wavs(run["online"], names)[n])


def test_evaluate_windowed_oracle_and_serve(audio_dir, tmp_path, capsys):
    ref, est = str(tmp_path / "ref"), str(tmp_path / "est")
    os.makedirs(ref)
    os.makedirs(est)
    for s in ("vocals", "accompaniment"):
        shutil.copy(os.path.join(audio_dir, "track0", f"{s}.wav"), ref)
        shutil.copy(os.path.join(audio_dir, "track0", f"{s}.wav"), est)
    capsys.readouterr()
    assert cli.main(["evaluate", "--ref-dir", ref, "--est-dir", est, "--flen", "16",
                     "--windowed", "--oracle", "--mix",
                     os.path.join(audio_dir, "track0", "mixture.wav"), "--preset", "tinyikala",
                     *CPU]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["_windows"] >= 1
    for s in ("vocals", "accompaniment"):
        assert out[s]["SDR"] > 40 and np.isfinite(out[s]["oracle_SDR"])

    pkl = _pickle(tmp_path / "model.pkl", seed=5)
    incoming = str(tmp_path / "incoming")
    os.makedirs(incoming)
    shutil.copy(os.path.join(audio_dir, "track0", "mixture.wav"), os.path.join(incoming, "t.wav"))
    served = str(tmp_path / "served")
    assert cli.main(["serve", "--preset", "tinyikala", "--params", pkl, "--input-dir", incoming,
                     "-o", served, "--poll", "0.01", "--max-sweeps", "2", *CPU]) == 0
    assert sorted(os.listdir(os.path.join(served, "t"))) == ["accompaniment.wav", "vocals.wav"]


@pytest.mark.parametrize("score_filter", ["comb", "nmf"])
def test_score_informed_journey(tmp_path, score_filter):
    """compute-features --score-informed → train --score-informed →
    separate --score, and separate-batch --score-dir, for both filters."""
    preset = _tiny_bach()
    root, scores, wavs = tmp_path / "audio", tmp_path / "scores", tmp_path / "wavs"
    wavs.mkdir()
    for i in range(2):
        d = root / f"piece{i}"
        d.mkdir(parents=True)
        stems, mix, notes = note_mixture(4, 2 * FS, fs=FS, notes_per_source=3, seed=i)
        for name, stem, src_notes in zip(preset.sources, stems, notes):
            write_wav(d / f"{name}.wav", FS, stem)
            for where in (d, scores / f"piece{i}"):
                where.mkdir(parents=True, exist_ok=True)
                with open(where / f"{name}.notes.txt", "w") as f:
                    f.writelines(f"{n.start_sec} {n.end_sec} {n.pitch_midi}\n"
                                 for n in src_notes)
        write_wav(d / "mixture.wav", FS, mix)
        write_wav(wavs / f"piece{i}.wav", FS, mix)
    feats, wd = str(tmp_path / "feats"), str(tmp_path / "run")
    assert cli.main(["compute-features", "--preset", "tinybach", "--audio-dir", str(root),
                     "--out", feats, "--score-informed", "--score-filter", score_filter,
                     *CPU]) == 0
    assert cli.main(["train", "--preset", "tinybach", "--features", feats, "--workdir", wd,
                     "--score-informed", *CPU]) == 0
    ck = os.path.join(wd, "checkpoints")
    est = str(tmp_path / "est")
    assert cli.main(["separate", "--preset", "tinybach", "--params", ck, "-i",
                     str(root / "piece0" / "mixture.wav"), "-o", est, "--score",
                     str(root / "piece0"), "--score-filter", score_filter, *CPU]) == 0
    assert sorted(os.listdir(est)) == sorted(f"{s}.wav" for s in preset.sources)
    batch = str(tmp_path / "batch")
    assert cli.main(["separate-batch", "--preset", "tinybach", "--params", ck, "--input-dir",
                     str(wavs), "-o", batch, "--batch-size", "2", "--score-dir", str(scores),
                     "--score-filter", score_filter, *CPU]) == 0
    for s in preset.sources:
        a = read_wav(os.path.join(est, f"{s}.wav"))[1]
        b = read_wav(os.path.join(batch, "piece0", f"{s}.wav"))[1]
        assert np.abs(a - b).max() <= 1.001 * LSB


def test_separate_flags_reach_the_preset(audio_dir, tmp_path, monkeypatch):
    """--mask-dtype, --analysis, --decoder-impl reach the preset;
    --score-gate-mode falls back to the preset's own mode."""
    import convsep_tpu_torch.separate as sep_mod

    pkl = _pickle(tmp_path / "model.pkl")
    captured = []
    orig = sep_mod.Separator

    class Spy(orig):
        def __init__(self, p, params, **kw):
            captured.append((p.model.mask_dtype, p.transform.analysis, p.model.decoder_impl,
                             p.sep.score_gate_mode))
            super().__init__(p, params, **kw)

    monkeypatch.setattr(sep_mod, "Separator", Spy)
    monkeypatch.setitem(port_presets.PRESETS, "tinyblend", lambda: dataclasses.replace(
        _port(_tiny_ikala()), sep=dataclasses.replace(_port(_tiny_ikala()).sep,
                                                      score_gate_mode="blend")))
    mix = os.path.join(audio_dir, "track0", "mixture.wav")
    assert cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i", mix, "-o",
                     str(tmp_path / "a"), "--mask-dtype", "bfloat16", "--analysis", "matmul",
                     "--decoder-impl", "band", *CPU]) == 0
    assert cli.main(["separate", "--preset", "tinyblend", "--params", pkl, "-i", mix, "-o",
                     str(tmp_path / "b"), *CPU]) == 0
    assert cli.main(["separate", "--preset", "tinyblend", "--params", pkl, "-i", mix, "-o",
                     str(tmp_path / "c"), "--score-gate-mode", "mult", *CPU]) == 0
    assert captured == [("bfloat16", "matmul", "band", "mult"),
                        ("float32", "auto", "bandconv", "blend"),
                        ("float32", "auto", "bandconv", "mult")]


def test_matches_the_reference_cli(audio_dir, tmp_path):
    """One seeded pickle through ``convsep separate`` and ``convsep-torch
    separate``: int16 stems within ±1 LSB. Both ``compute-features``: the
    same files within 1e-5 × peak."""
    pkl = _pickle(tmp_path / "model.pkl", seed=7)
    mix = os.path.join(audio_dir, "track1", "mixture.wav")
    jx, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i", mix,
                         "-o", jx]) == 0
    assert cli.main(["separate", "--preset", "tinyikala", "--params", pkl, "-i", mix, "-o", pt,
                     *CPU]) == 0
    for n in ("vocals", "accompaniment"):
        a, b = (read_wav(os.path.join(d, f"{n}.wav"))[1] for d in (jx, pt))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1.001 * LSB
    fj, fp = str(tmp_path / "fj"), str(tmp_path / "fp")
    assert jax_cli.main(["compute-features", "--preset", "tinyikala", "--audio-dir", audio_dir,
                         "--out", fj]) == 0
    assert cli.main(["compute-features", "--preset", "tinyikala", "--audio-dir", audio_dir,
                     "--out", fp, *CPU]) == 0
    assert sorted(os.listdir(fj)) == sorted(os.listdir(fp))
    for f in (f for f in os.listdir(fj) if f.endswith(".data")):
        a, b = load_tensor(os.path.join(fj, f)), load_tensor(os.path.join(fp, f))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("argv", [
    ["train", "--mesh-data", "2"], ["train", "--grain"], ["train", "--tensorboard"],
    ["train", "--optimizer-state-dtype", "bfloat16"], ["separate-batch", "--mesh-data", "2"],
    ["serve", "--mesh-data", "2"],
], ids=["train-mesh", "grain", "tensorboard", "state-bf16", "batch-mesh", "serve-mesh"])
def test_unported_flags_raise(audio_dir, tmp_path, argv, monkeypatch):
    """Flags refused until they were ported. ``--mesh-data 2`` without a
    launcher raises the error that names ``torchrun`` (the ranks are
    processes a launcher starts); ``--grain`` trains and saves grain's
    iterator state in the checkpoint's data position; ``--tensorboard``
    and ``--optimizer-state-dtype bfloat16`` train: the event file under
    ``<workdir>/tb``, the bf16 accumulators in the checkpoint."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    feats = str(tmp_path / "feats")
    cli.main(["compute-features", "--preset", "tinyikala", "--audio-dir", audio_dir, "--out",
              feats, *CPU])
    pkl = _pickle(tmp_path / "m.pkl")
    rest = {"train": ["--features", feats, "--workdir", str(tmp_path / "run")],
            "separate-batch": ["--params", pkl, "--input-dir", os.path.join(audio_dir, "track0"),
                               "-o", str(tmp_path / "o")],
            "serve": ["--params", pkl, "--input-dir", os.path.join(audio_dir, "track0"),
                      "-o", str(tmp_path / "o"), "--max-sweeps", "1"]}[argv[0]]
    loaders = []
    if argv[1] == "--grain":
        from convsep_tpu_torch.train import loop

        make = loop.make_loader
        monkeypatch.setattr(loop, "make_loader",
                            lambda *a, **kw: loaders.append(kw) or make(*a, **kw))
    if argv[1] in ("--tensorboard", "--optimizer-state-dtype", "--grain"):
        assert cli.main([argv[0], "--preset", "tinyikala", *rest, *argv[1:], *CPU]) == 0
        run = tmp_path / "run"
        if argv[1] == "--tensorboard":
            assert [f for f in os.listdir(run / "tb") if ".tfevents." in f]
        elif argv[1] == "--grain":
            # one grain-order loader an epoch; an epoch's end keeps no grain state
            assert loaders and all(kw["num_epochs"] == 1 for kw in loaders)
            step = CheckpointManager(str(run / "checkpoints")).latest_step()
            meta = json.loads((run / "checkpoints" / str(step) / "meta.json").read_text())
            assert meta["grain"] is None and meta["batch_in_epoch"] == 0
        else:
            step = CheckpointManager(str(run / "checkpoints")).latest_step()
            leaves = torch.load(run / "checkpoints" / str(step) / "state.pt", weights_only=True)
            accu = [v for k, v in leaves.items() if k.startswith("opt_state/")]
            assert accu and all(v.dtype == torch.bfloat16 for v in accu)
        return
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        cli.main([argv[0], "--preset", "tinyikala", *rest, *argv[1:], *CPU])


@pytest.mark.parametrize("verb", ["train", "separate-batch", "serve"])
def test_mesh_data_under_a_launcher(audio_dir, tmp_path, monkeypatch, verb):
    """``--mesh-data 1`` with a launcher's environment (one rank, gloo on
    ``--device cpu``, a free localhost port): the verb builds the mesh,
    runs on it and destroys the process group it initialized."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    pkl = _pickle(tmp_path / "m.pkl")
    feats = str(tmp_path / "feats")
    if verb == "train":
        cli.main(["compute-features", "--preset", "tinyikala", "--audio-dir", audio_dir,
                  "--out", feats, *CPU])
    rest = {"train": ["--features", feats, "--workdir", str(tmp_path / "run"), "--grain"],
            "separate-batch": ["--params", pkl, "--input-dir",
                               os.path.join(audio_dir, "track0"), "-o", str(tmp_path / "o")],
            "serve": ["--params", pkl, "--input-dir", os.path.join(audio_dir, "track0"),
                      "-o", str(tmp_path / "o"), "--max-sweeps", "2", "--poll", "0"]}[verb]
    assert cli.main([verb, "--preset", "tinyikala", *rest, "--mesh-data", "1", *CPU]) == 0
    assert not dist.is_initialized()
    if verb == "train":
        assert CheckpointManager(str(tmp_path / "run" / "checkpoints")).latest_step()
    else:
        assert os.listdir(tmp_path / "o")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        cli.main([verb, "--preset", "tinyikala", *rest, "--mesh-data", "2", *CPU])
    assert not dist.is_initialized()


def test_orbax_directory_refused(tmp_path):
    d = tmp_path / "orbax" / "0" / "default"
    d.mkdir(parents=True)
    (d / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="convsep convert --export"):
        cli.main(["separate", "--preset", "tinyikala", "--params", str(tmp_path / "orbax"),
                  "-i", "x.wav", "-o", str(tmp_path / "o"), *CPU])


def test_default_device_is_cuda_and_no_jax(audio_dir, tmp_path):
    """In a fresh interpreter: without --device, on a machine with no GPU,
    a verb exits non-zero with the CUDA error (no quiet move to the CPU);
    with --device cpu the CLI, bench, eval and flops modules run and leave
    jax, grain and the JAX package out of sys.modules."""
    import torch

    pkl = _pickle(tmp_path / "m.pkl")
    mix = os.path.join(audio_dir, "track0", "mixture.wav")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "-m", "convsep_tpu_torch.cli", "separate",
                              "--preset", "ikala", "--params", pkl, "-i", mix, "-o",
                              str(tmp_path / "o")], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr, out.stderr[-2000:]
    script = textwrap.dedent(f"""
        import sys
        import convsep_tpu_torch.benchmark, convsep_tpu_torch.eval, convsep_tpu_torch.utils.flops
        from convsep_tpu_torch import cli
        import numpy as np
        assert cli.main(["evaluate", "--ref-dir", {os.path.join(audio_dir, "track0")!r},
                         "--est-dir", {os.path.join(audio_dir, "track1")!r}, "--flen", "8",
                         "--device", "cpu"]) == 0
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "grain",
                                      "convsep_tpu")]
        assert not bad, bad
        print("ok")
        """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
