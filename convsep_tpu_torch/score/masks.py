"""Score → time-frequency masks → score-filtered input channels.

A copy of ``convsep_tpu.score.masks`` (plain numpy; this package imports
nothing of the reference). Reference parity: the Bach10 score-informed
pipeline (SURVEY.md §2.1 #9/#10, §3.4): aligned note annotations per
instrument yield per-source soft TF masks around each note's harmonics;
`mask_i * mix_mag` becomes an extra input channel per source,
conditioning the CNN at train AND separation time. Augmentation =
note-level time shifts/stretches [M].

This is host-side feature computation (numpy): masks are built once per
track and passed as ``extra`` to ``Separator.__call__``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Note:
    pitch_midi: float
    start_sec: float
    end_sec: float

    def __post_init__(self):
        if self.end_sec < self.start_sec:
            raise ValueError(f"note ends before it starts: {self}")


def midi_to_hz(pitch: float) -> float:
    return 440.0 * 2.0 ** ((pitch - 69.0) / 12.0)


def parse_note_annotations(path: str) -> list[Note]:
    """Parse a text annotation: one `onset_sec offset_sec midi_pitch` per
    line (Bach10-style ASCII annotations; '#' comments allowed)."""
    notes = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) != 3:
                raise ValueError(f"{path}:{ln}: expected 'onset offset pitch', got {line!r}")
            on, off, pitch = (float(p) for p in parts)
            notes.append(Note(pitch_midi=pitch, start_sec=on, end_sec=off))
    return notes


def shift_notes(notes: list[Note], dt: float) -> list[Note]:
    """Time-shift augmentation (clamps at 0)."""
    return [
        Note(n.pitch_midi, max(0.0, n.start_sec + dt), max(0.0, n.end_sec + dt))
        for n in notes
    ]


def stretch_notes(notes: list[Note], factor: float) -> list[Note]:
    """Time-stretch augmentation."""
    if factor <= 0:
        raise ValueError("stretch factor must be positive")
    return [
        Note(n.pitch_midi, n.start_sec * factor, n.end_sec * factor) for n in notes
    ]


def shift_audio(audio: np.ndarray, dt: float, fs: int) -> np.ndarray:
    """Shift audio to match `shift_notes(notes, dt)`: positive dt delays
    the signal (front zero-pad), negative dt crops the head."""
    n = int(round(dt * fs))
    if n >= 0:
        return np.concatenate([np.zeros(n, np.float32), np.asarray(audio, np.float32)])
    return np.asarray(audio[-n:], np.float32)


def stretch_audio(audio: np.ndarray, factor: float) -> np.ndarray:
    """Linear-interpolation time-stretch matching `stretch_notes(notes,
    factor)` — an event at t seconds lands at factor·t seconds (pitch
    shifts with it, as in naive time-scaling augmentation [M])."""
    if factor <= 0:
        raise ValueError("stretch factor must be positive")
    n = len(audio)
    n_out = max(1, int(round(n * factor)))
    x_new = np.linspace(0.0, n - 1.0, n_out)
    return np.interp(x_new, np.arange(n), np.asarray(audio, np.float64)).astype(np.float32)


def augmentation_plan(n: int) -> list[tuple[str, float]]:
    """Deterministic cycle of n augmentation variants: alternating note/audio
    time shifts and time stretches (reference Bach10 augmentation [M])."""
    base = [("shift", 0.1), ("shift", -0.1), ("stretch", 0.9), ("stretch", 1.1)]
    out = []
    round_ = 0
    while len(out) < n:
        for kind, v in base:
            if len(out) >= n:
                break
            scale = 1.0 + round_
            out.append((kind, v * scale if kind == "shift" else 1.0 + (v - 1.0) * scale))
        round_ += 1
    return out


def augment_track(
    stems: dict[str, np.ndarray],
    mix: np.ndarray,
    notes: list[list[Note]] | None,
    fs: int,
    kind: str,
    value: float,
) -> tuple[dict[str, np.ndarray], np.ndarray, list[list[Note]] | None]:
    """Apply one augmentation variant consistently to audio AND score."""
    if kind == "shift":
        f = lambda a: shift_audio(a, value, fs)  # noqa: E731
        g = lambda ns: shift_notes(ns, value)  # noqa: E731
    elif kind == "stretch":
        f = lambda a: stretch_audio(a, value)  # noqa: E731
        g = lambda ns: stretch_notes(ns, value)  # noqa: E731
    else:
        raise ValueError(f"unknown augmentation kind {kind!r}")
    return (
        {s: f(a) for s, a in stems.items()},
        f(mix),
        None if notes is None else [g(ns) for ns in notes],
    )


def score_mask(
    notes: list[Note],
    n_frames: int,
    bins: int,
    fs: int,
    hop: int,
    n_harmonics: int = 20,
    semitone_width: float = 1.0,
    onset_pad_sec: float = 0.05,
    floor: float = 0.0,
) -> np.ndarray:
    """Soft harmonic-comb TF mask (n_frames, bins) in [floor, 1].

    For each active note and harmonic k ≤ n_harmonics, a Gaussian bump
    centred at k·f0 whose width is ±`semitone_width` semitones of the
    harmonic (matching the score-filtering idea of the ISMIR 2017 pipeline
    [M]); `onset_pad_sec` widens note boundaries to absorb alignment slack.
    """
    nfft_bins = bins - 1
    freq_per_bin = fs / (2.0 * nfft_bins)
    freqs = np.arange(bins) * freq_per_bin  # (bins,)
    mask = np.full((n_frames, bins), float(floor), dtype=np.float32)
    # frame n covers samples around n*hop (analysis front pad centers frames)
    frame_times = np.arange(n_frames) * hop / float(fs)
    nyquist = fs / 2.0
    for note in notes:
        active = (frame_times >= note.start_sec - onset_pad_sec) & (
            frame_times <= note.end_sec + onset_pad_sec
        )
        if not active.any():
            continue
        f0 = midi_to_hz(note.pitch_midi)
        comb = np.zeros(bins, dtype=np.float32)
        for k in range(1, n_harmonics + 1):
            fk = k * f0
            if fk > nyquist:
                break
            sigma = fk * (2.0 ** (semitone_width / 12.0) - 1.0)
            comb = np.maximum(comb, np.exp(-0.5 * ((freqs - fk) / sigma) ** 2))
        mask[active] = np.maximum(mask[active], comb[None, :])
    return mask


def score_filtered_channels(
    mix_mag: np.ndarray, per_source_notes: list[list[Note]], fs: int, hop: int, **mask_kw
) -> np.ndarray:
    """Mixture magnitude (n_frames, bins) + per-source scores →
    score-filtered channels (n_frames, bins, S)."""
    n_frames, bins = mix_mag.shape
    chans = [
        score_mask(notes, n_frames, bins, fs, hop, **mask_kw) * mix_mag
        for notes in per_source_notes
    ]
    return np.stack(chans, axis=-1).astype(np.float32)
