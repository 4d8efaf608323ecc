"""Host-side complement derivation of the last stem.

Mirror of ``convsep_tpu.separate.complement``. Under conservative Wiener
masks (``wiener_mask(..., conserve_last=True)``) the masks sum to exactly
1, so the stems sum to the iSTFT∘STFT round trip of the mixture, and the
last stem can be derived on the host as ``mixture − Σ other stems``: the
device copies S − 1 stems instead of S.
"""

from __future__ import annotations

import numpy as np

from convsep_tpu_torch.utils.pcm import quantize_pcm16_host


def derive_last_stem(
    others: np.ndarray, mixture: np.ndarray, input_dtype: str, output_dtype: str
) -> np.ndarray:
    """last stem = mixture − Σ fetched stems (host arithmetic, float32).

    ``others``: ((S−1)[, 2], L) fetched stems in ``output_dtype``;
    ``mixture``: ([2,] L) the samples the separation saw, in
    ``input_dtype``, aligned sample for sample with the stems.

    PCM16 in and out takes an integer path with the same result: every
    float32 value of the float path is a multiple of 2^-15 below S in
    magnitude, so each of its operations is exact, and the derived stem is
    the clipped integer difference (a third of the host time)."""
    if input_dtype == output_dtype == "int16":
        acc = mixture.astype(np.int32)
        for stem in others:
            acc -= stem
        return np.clip(acc, -32768, 32767).astype(np.int16)
    mix = mixture.astype(np.float32)
    if input_dtype == "int16":
        mix *= 1.0 / 32768.0
    rest = others.astype(np.float32)
    if output_dtype == "int16":
        rest *= 1.0 / 32768.0
    derived = mix - rest.sum(axis=0)
    if output_dtype == "int16":
        return quantize_pcm16_host(derived)
    return derived.astype(np.float32)
