"""Synthetic fixtures: deterministic mixtures with known stems.

Mirror of ``convsep_tpu.data.synth`` (the same numbers from the same
seed): ``sine_mixture`` (vibrato sines), ``note_mixture`` (harmonic notes
with their score) and ``synth_feature_dir`` (magnitude feature files of
sine mixtures, through :func:`~convsep_tpu_torch.dsp.stft.stft`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from convsep_tpu_torch.data.io import save_tensor
from convsep_tpu_torch.utils.device import resolve_device

DEFAULT_FREQS = (220.0, 440.0, 1760.0, 3520.0)


def sine_mixture(
    num_sources: int,
    length: int,
    fs: int = 44100,
    freqs: tuple[float, ...] = DEFAULT_FREQS,
    amp: float = 0.2,
    vibrato: float = 5.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Stems (S, length) + mixture (length,), float32: each stem a
    frequency-modulated sine at a well-separated carrier, under a slow
    amplitude envelope."""
    if num_sources > len(freqs):
        raise ValueError(f"need ≤{len(freqs)} sources, got {num_sources}")
    rng = np.random.default_rng(seed)
    t = np.arange(length) / float(fs)
    stems = []
    for s in range(num_sources):
        f0 = freqs[s]
        phase = rng.uniform(0, 2 * np.pi)
        mod = np.sin(2 * np.pi * vibrato * t + phase)
        inst_phase = 2 * np.pi * f0 * t + 0.5 * mod
        env = 0.5 * (1 + np.sin(2 * np.pi * (0.5 + 0.25 * s) * t))
        stems.append((amp * env * np.sin(inst_phase)).astype(np.float32))
    stems = np.stack(stems)
    return stems, stems.sum(axis=0)


def note_mixture(
    num_sources: int,
    length: int,
    fs: int = 44100,
    notes_per_source: int = 6,
    n_harmonics: int = 5,
    amp: float = 0.2,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, list]:
    """Score-informed fixture → (stems (S, length), mix (length,),
    per-source notes as ``score.masks.Note``): each source walks its own
    register (one octave apart) in ``notes_per_source`` legato notes, a
    1/k-rolloff harmonic stack under a raised-cosine 2 % attack/release."""
    from convsep_tpu_torch.score.masks import Note, midi_to_hz

    rng = np.random.default_rng(seed)
    t = np.arange(length) / float(fs)
    seconds = length / float(fs)
    base_pitch = (64, 57, 50, 43)  # E4, A3, D3, G2 — one register per source
    if num_sources > len(base_pitch):
        raise ValueError(f"need ≤{len(base_pitch)} sources, got {num_sources}")
    note_dur = seconds / notes_per_source
    stems, all_notes = [], []
    for s in range(num_sources):
        audio = np.zeros(length, np.float64)
        notes = []
        pitch = base_pitch[s]
        for i in range(notes_per_source):
            pitch = int(np.clip(pitch + rng.integers(-3, 4), base_pitch[s] - 4, base_pitch[s] + 7))
            on = round(i * note_dur, 4)
            off = round(min(seconds, on + note_dur * rng.uniform(0.7, 0.98)), 4)
            notes.append(Note(float(pitch), on, off))
            f0 = midi_to_hz(pitch)
            gate = (t >= on) & (t < off)
            seg_t = t[gate] - on
            dur = max(off - on, 1e-3)
            ramp = 0.02 * dur
            env = np.minimum(1.0, np.minimum(seg_t, dur - seg_t) / max(ramp, 1e-4))
            env = 0.5 - 0.5 * np.cos(np.pi * np.clip(env, 0.0, 1.0))
            tone = sum(
                np.sin(2 * np.pi * k * f0 * seg_t + rng.uniform(0, 2 * np.pi)) / k
                for k in range(1, n_harmonics + 1)
                if k * f0 < fs / 2
            )
            audio[gate] += amp * env * tone
        stems.append(audio.astype(np.float32))
        all_notes.append(notes)
    stems = np.stack(stems)
    return stems, stems.sum(axis=0), all_notes


def synth_feature_dir(
    out_dir: str,
    sources: tuple[str, ...],
    num_tracks: int = 2,
    seconds: float = 2.0,
    fs: int = 44100,
    frame_size: int = 1024,
    hop_size: int = 512,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> list[str]:
    """Write ``track<i>.mix.data`` and ``track<i>.<source>.data`` magnitude
    feature files (sinebell window) of ``num_tracks`` sine mixtures, seeds
    ``seed + i``; returns the track names. The STFTs run on ``device``
    (``None`` means "cuda", which raises without a GPU)."""
    from convsep_tpu_torch.dsp.stft import magphase, stft
    from convsep_tpu_torch.dsp.windows import sinebell

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    win = sinebell(frame_size)

    def mag(x: np.ndarray) -> np.ndarray:
        return magphase(stft(torch.from_numpy(x).to(device), win, hop_size))[0].cpu().numpy()

    names = []
    for i in range(num_tracks):
        stems, mix = sine_mixture(len(sources), int(seconds * fs), fs=fs, seed=seed + i)
        name = f"track{i:03d}"
        save_tensor(mag(mix), os.path.join(out_dir, f"{name}.mix.data"))
        for s, sname in enumerate(sources):
            save_tensor(mag(stems[s]), os.path.join(out_dir, f"{name}.{sname}.data"))
        names.append(name)
    return names
