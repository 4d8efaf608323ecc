"""Offline feature computation: dataset audio → feature files.

Mirror of ``convsep_tpu.data.features``: walk a dataset directory, read
the stems, build the mixture (the sum of the stems where no mixture file
exists), take each signal's magnitude spectrogram with
:class:`~convsep_tpu_torch.dsp.transform.TransformFFT` on the caller's
device and write ``<track>.<stem>.data`` feature files (data/io.py), plus
the multires channels (``<track>.res<size>.data``) and the score-filtered
channels (``<track>.score_<source>.data``) where the preset or the caller
asks for them.

Layouts: ``trackdirs`` (``<audio_dir>/<track>/<source>.wav`` and an
optional ``mixture.wav``; stereo averaged to mono) and ``ikala-stereo``
(flat stereo wavs, the accompaniment in channel 0 and the voice in
channel 1). Score-informed runs read ``<track>/<source>.notes.txt``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.io import read_wav, save_tensor
from convsep_tpu_torch.dsp.transform import TransformFFT
from convsep_tpu_torch.score.masks import (
    augment_track,
    augmentation_plan,
    parse_note_annotations,
    score_filtered_channels,
)


def _mono(audio: np.ndarray) -> np.ndarray:
    return audio.mean(axis=1) if audio.ndim == 2 else audio


def _tracks_trackdirs(audio_dir: str, preset: Preset):
    """``<dir>/<track>/<stem>.wav`` layout (DSD100 / Bach10 style)."""
    tracks = sorted(
        d for d in os.listdir(audio_dir) if os.path.isdir(os.path.join(audio_dir, d))
    )
    if not tracks:
        raise FileNotFoundError(f"no track directories under {audio_dir}")
    for track in tracks:
        tdir = os.path.join(audio_dir, track)
        stems = {}
        for s in preset.sources:
            p = os.path.join(tdir, f"{s}.wav")
            if not os.path.exists(p):
                raise FileNotFoundError(f"missing stem {p}")
            fs, audio = read_wav(p)
            if fs != preset.transform.fs:
                raise ValueError(f"{p}: sample rate {fs} != preset {preset.transform.fs}")
            stems[s] = _mono(audio)
        n = min(len(a) for a in stems.values())
        stems = {s: a[:n] for s, a in stems.items()}
        mix_path = os.path.join(tdir, "mixture.wav")
        if os.path.exists(mix_path):
            _, mix = read_wav(mix_path)
            mix = _mono(mix)[:n]
        else:  # the reference's rule: the mixture is the sum of the stems
            mix = np.sum(list(stems.values()), axis=0)
        yield track, tdir, stems, mix


def _tracks_ikala_stereo(audio_dir: str, preset: Preset):
    """iKala layout: flat stereo wavs, the accompaniment in channel 0 and
    the voice in channel 1; the mixture is the channels' sum."""
    wavs = sorted(f for f in os.listdir(audio_dir) if f.endswith(".wav"))
    if not wavs:
        raise FileNotFoundError(f"no wav files under {audio_dir}")
    chan = {"vocals": 1, "accompaniment": 0}
    for f in wavs:
        p = os.path.join(audio_dir, f)
        fs, audio = read_wav(p)
        if fs != preset.transform.fs:
            raise ValueError(f"{p}: sample rate {fs} != preset {preset.transform.fs}")
        if audio.ndim != 2 or audio.shape[1] != 2:
            raise ValueError(f"{p}: ikala-stereo layout needs stereo wavs, got {audio.shape}")
        stems = {s: audio[:, chan[s]] for s in preset.sources}
        yield f[:-4], audio_dir, stems, audio.sum(axis=1)


_LAYOUTS = {"trackdirs": _tracks_trackdirs, "ikala-stereo": _tracks_ikala_stereo}


def _emit_track(
    out_dir: str,
    name: str,
    stems: dict[str, np.ndarray],
    mix: np.ndarray,
    notes: list | None,
    preset: Preset,
    t: TransformFFT,
    score_filter: str = "comb",
) -> None:
    """Write one track's feature files (mixture and stems, multires
    channels, score channels)."""
    mix_mag = t.compute_file(mix)
    save_tensor(mix_mag, os.path.join(out_dir, f"{name}.mix.data"))
    for s, audio in stems.items():
        save_tensor(t.compute_file(audio), os.path.join(out_dir, f"{name}.{s}.data"))

    if preset.transform.multires:
        from convsep_tpu_torch.dsp.multires import multires_channels
        from convsep_tpu_torch.dsp.stft import scale_magnitude

        with torch.inference_mode():
            x = torch.from_numpy(np.asarray(mix, np.float32)).to(t.device)
            ex = scale_magnitude(multires_channels(x, preset.transform),
                                 preset.transform.iscale).cpu().numpy()
        for i, size in enumerate(preset.transform.multires):
            save_tensor(ex[..., i], os.path.join(out_dir, f"{name}.res{size}.data"))

    if notes is not None:
        chans = score_channels(mix_mag, notes, preset, score_filter)
        for i, s in enumerate(preset.sources):
            save_tensor(chans[..., i], os.path.join(out_dir, f"{name}.score_{s}.data"))


def score_channels(
    mix_mag: np.ndarray, notes: list, preset, score_filter: str = "comb"
) -> np.ndarray:
    """Score-filtered extra input channels (n_frames, bins, S) by filter
    kind: "comb" = harmonic-comb gating (score/masks.py), "nmf" =
    score-constrained KL-NMF refinement (score/nmf.py). ``preset`` is a
    ``Preset``; ``mix_mag`` the mixture magnitude (n_frames, bins)."""
    kw = dict(fs=preset.transform.fs, hop=preset.transform.hop_size)
    if score_filter == "comb":
        return score_filtered_channels(mix_mag, notes, **kw)
    if score_filter == "nmf":
        from convsep_tpu_torch.score.nmf import score_nmf_channels

        return score_nmf_channels(mix_mag, notes, **kw)
    raise ValueError(f"unknown score_filter {score_filter!r}; have comb | nmf")


def compute_features(
    audio_dir: str,
    out_dir: str,
    preset: Preset,
    score_informed: bool = False,
    layout: str = "trackdirs",
    augment: int = 0,
    score_filter: str = "comb",
    device: str | torch.device | None = None,
) -> list[str]:
    """Compute feature files for every track; returns the track names.

    ``augment=N`` also writes N augmented copies of each track
    (``<track>.aug<i>``), cycling time shifts and stretches applied alike
    to the audio, the mixture and the score (``score.masks.augment_track``).
    The transforms run on ``device`` (``None`` means "cuda", which raises
    without a GPU)."""
    t = TransformFFT(preset.transform, device=device)
    try:
        walker = _LAYOUTS[layout]
    except KeyError:
        raise ValueError(f"unknown layout {layout!r}; have {sorted(_LAYOUTS)}") from None
    os.makedirs(out_dir, exist_ok=True)
    plan = augmentation_plan(augment)
    done = []
    for track, tdir, stems, mix in walker(audio_dir, preset):
        notes = None
        if score_informed:
            notes = []
            for s in preset.sources:
                ann = os.path.join(tdir, f"{s}.notes.txt")
                if not os.path.exists(ann):
                    raise FileNotFoundError(f"score-informed run missing {ann}")
                notes.append(parse_note_annotations(ann))

        _emit_track(out_dir, track, stems, mix, notes, preset, t, score_filter)
        done.append(track)
        for i, (kind, value) in enumerate(plan, 1):
            a_stems, a_mix, a_notes = augment_track(
                stems, mix, notes, preset.transform.fs, kind, value
            )
            name = f"{track}.aug{i}"
            _emit_track(out_dir, name, a_stems, a_mix, a_notes, preset, t, score_filter)
            done.append(name)
    return done
