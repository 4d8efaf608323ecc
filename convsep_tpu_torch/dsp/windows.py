"""Analysis/synthesis windows (float64 numpy; cast at use sites).

Mirror of ``convsep_tpu.dsp.windows``: the reference's sine-bell
``sin(pi * n / N)`` and the periodic Hann window.
"""

from __future__ import annotations

import numpy as np


def sinebell(length: int) -> np.ndarray:
    """Sine-bell window ``w[n] = sin(pi * n / length)`` (first sample 0)."""
    if length <= 0:
        raise ValueError(f"window length must be positive, got {length}")
    return np.sin(np.pi * np.arange(length) / float(length))


def hann(length: int) -> np.ndarray:
    """Periodic Hann window (sinebell squared)."""
    if length <= 0:
        raise ValueError(f"window length must be positive, got {length}")
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(length) / float(length))
