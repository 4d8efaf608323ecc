"""Score-initialized NMF refinement of score-filtered channels.

A copy of ``convsep_tpu.score.nmf`` (plain numpy). Reference parity: the
Bach10 pipeline's score-informed excitation model (SURVEY.md §2.1 #9 —
"per-source time-frequency note masks derived from aligned MIDI (and/or a
source-filter NMF model excitation template [M])").
The plain harmonic-comb filter (`score/masks.py::score_filtered_channels`)
gates the mixture by where the score SAYS energy is; this module instead
LEARNS per-pitch spectral templates and per-frame gains from the mixture
itself, constrained by the score:

  * one spectral template per (source, distinct pitch), initialized as the
    pitch's harmonic comb and supported ONLY on its harmonic bumps;
  * one activation row per template, initialized from the note on/off
    gates (± onset pad).

Both are refined by KL-divergence multiplicative updates on the mixture
magnitude. Multiplicative updates preserve zeros, so the score constraint
(a pitch can only sound while its notes are active; a template can only
have energy near its harmonics) holds for free through the iterations —
the classic score-informed NMF construction (Ewert & Müller-style).

Per-source estimates V_s = W_s H_s then soft-mask the mixture into
score-filtered channels exactly like the comb path, so the two filters are
drop-in interchangeable (``data/features.py::score_channels(...,
"nmf")``).

Host-side numpy by design: this runs once per track at feature time —
30 multiplicative updates on a 30 s bach10-config track (1291×2049, 4
sources) measure ~4.7 s on one CPU core — and a jitted variant would pay
a per-track-shape compile that never amortizes (same reasoning as the
reference's offline feature pass). The port keeps it on the host.
"""

from __future__ import annotations

import numpy as np

from convsep_tpu_torch.score.masks import Note, midi_to_hz

__all__ = ["score_nmf", "score_nmf_channels", "pitch_templates", "pitch_gates"]


def _harmonic_comb(
    f0: float, bins: int, freq_per_bin: float, n_harmonics: int, semitone_width: float
) -> np.ndarray:
    """Gaussian harmonic comb (bins,), hard-zeroed outside ±3σ of each
    harmonic so multiplicative updates keep the template harmonic."""
    freqs = np.arange(bins) * freq_per_bin
    nyquist = (bins - 1) * freq_per_bin
    comb = np.zeros(bins, dtype=np.float64)
    for k in range(1, n_harmonics + 1):
        fk = k * f0
        if fk > nyquist:
            break
        sigma = fk * (2.0 ** (semitone_width / 12.0) - 1.0)
        bump = np.exp(-0.5 * ((freqs - fk) / sigma) ** 2) / k  # 1/k rolloff init
        bump[np.abs(freqs - fk) > 3.0 * sigma] = 0.0
        comb = np.maximum(comb, bump)
    return comb


def pitch_templates(
    notes: list[Note],
    bins: int,
    fs: int,
    n_harmonics: int = 20,
    semitone_width: float = 1.0,
) -> tuple[list[float], np.ndarray]:
    """Distinct pitches (rounded to the semitone) of a source's notes →
    (pitches, W) with W (bins, P) the comb-initialized templates."""
    freq_per_bin = fs / (2.0 * (bins - 1))
    pitches = sorted({round(n.pitch_midi) for n in notes})
    if not pitches:
        return [], np.zeros((bins, 0), dtype=np.float64)
    W = np.stack(
        [
            _harmonic_comb(midi_to_hz(p), bins, freq_per_bin, n_harmonics, semitone_width)
            for p in pitches
        ],
        axis=1,
    )
    return [float(p) for p in pitches], W


def pitch_gates(
    notes: list[Note],
    pitches: list[float],
    n_frames: int,
    fs: int,
    hop: int,
    onset_pad_sec: float = 0.05,
) -> np.ndarray:
    """Score on/off gates (P, n_frames): 1 while any note of that pitch is
    active (± onset pad), else 0. Zeros persist through the updates."""
    frame_times = np.arange(n_frames) * hop / float(fs)
    H = np.zeros((len(pitches), n_frames), dtype=np.float64)
    index = {p: i for i, p in enumerate(pitches)}
    for note in notes:
        i = index[float(round(note.pitch_midi))]
        active = (frame_times >= note.start_sec - onset_pad_sec) & (
            frame_times <= note.end_sec + onset_pad_sec
        )
        H[i, active] = 1.0
    return H


def score_nmf(
    mix_mag: np.ndarray,
    per_source_notes: list[list[Note]],
    fs: int,
    hop: int,
    n_iter: int = 30,
    n_harmonics: int = 20,
    semitone_width: float = 1.0,
    onset_pad_sec: float = 0.05,
    eps: float = 1e-9,
) -> np.ndarray:
    """Score-constrained KL-NMF of the mixture → per-source magnitude
    estimates (S, n_frames, bins).

    All sources' templates factor the mixture JOINTLY (one W, one H,
    partitioned by source), so overlapping harmonics are split by the
    learned gains rather than double-counted as in the comb filter.
    """
    V = np.asarray(mix_mag, np.float64).T  # (bins, frames)
    bins, n_frames = V.shape
    S = len(per_source_notes)
    Ws, Hs, owner = [], [], []
    for s, notes in enumerate(per_source_notes):
        pitches, W = pitch_templates(notes, bins, fs, n_harmonics, semitone_width)
        Ws.append(W)
        Hs.append(pitch_gates(notes, pitches, n_frames, fs, hop, onset_pad_sec))
        owner.extend([s] * len(pitches))
    W = np.concatenate(Ws, axis=1) if owner else np.zeros((bins, 0))
    H = np.concatenate(Hs, axis=0) if owner else np.zeros((0, n_frames))
    owner = np.asarray(owner, dtype=np.int64)

    out = np.zeros((S, n_frames, bins), dtype=np.float32)
    if W.shape[1] == 0:
        return out
    # scale H so the initial model matches the mixture's energy
    model = W @ H
    scale = (V.sum() + eps) / (model.sum() + eps)
    H *= scale

    ones = np.ones_like(V)
    for _ in range(n_iter):
        model = W @ H + eps
        ratio = V / model
        H *= (W.T @ ratio) / (W.T @ ones + eps)
        model = W @ H + eps
        ratio = V / model
        W *= (ratio @ H.T) / (ones @ H.T + eps)

    for s in range(S):
        sel = owner == s
        if sel.any():
            out[s] = (W[:, sel] @ H[sel]).T.astype(np.float32)
    return out


def score_nmf_channels(
    mix_mag: np.ndarray,
    per_source_notes: list[list[Note]],
    fs: int,
    hop: int,
    eps: float = 1e-9,
    **nmf_kw,
) -> np.ndarray:
    """Drop-in alternative to `score_filtered_channels`: NMF-refined soft
    masks × mixture magnitude → (n_frames, bins, S) float32 channels."""
    est = score_nmf(mix_mag, per_source_notes, fs=fs, hop=hop, **nmf_kw)
    denom = est.sum(axis=0) + eps
    mask = est / denom
    return np.moveaxis(mask, 0, -1).astype(np.float32) * np.asarray(
        mix_mag, np.float32
    )[..., None]
