"""Synthetic fixtures: deterministic mixtures with known stems.

Mirror of ``sine_mixture`` in ``convsep_tpu.data.synth`` (the same numbers
from the same seed). The feature-file and score fixtures are not ported.
"""

from __future__ import annotations

import numpy as np

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
