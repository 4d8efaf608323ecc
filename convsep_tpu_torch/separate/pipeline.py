"""Whole-track separation.

Mirror of ``convsep_tpu.separate.pipeline``: the chain

    PCM in → framing + window + DFT → |X|·mult_factor_in → 30-frame
    segments → ConvSep.sources → unsegment → Wiener mask × mixture →
    inverse DFT + overlap-add → stems

runs on one device with segments as the model's batch axis; track lengths
are bucketed like the reference's, so a model sees a bounded set of shapes.
On CUDA the two hand-written kernels carry the decode (highres-class
geometry) and the masked resynthesis.

Not ported yet: score gating and extra input channels (bach10, multires),
``complement_last``, and the ``fft``/``pallas`` transform routes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.segment import segment_frames, unsegment_frames
from convsep_tpu_torch.dsp.dft import check_precision, istft_wiener, stft_matmul
from convsep_tpu_torch.dsp.stft import scale_magnitude
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.pcm import quantize_pcm16_host


def window_of(preset: Preset) -> np.ndarray:
    if preset.transform.window == "sinebell":
        return sinebell(preset.transform.frame_size)
    if preset.transform.window == "hann":
        return hann(preset.transform.frame_size)
    raise ValueError(f"unknown window {preset.transform.window!r}")


def bucket_length(length: int, preset: Preset) -> int:
    """Round a sample count up to a multiple of hop · time_context ·
    segment_bucket (a whole number of segment groups)."""
    unit = preset.transform.hop_size * preset.model.time_context * preset.sep.segment_bucket
    return max(unit, int(math.ceil(length / unit)) * unit)


def check_supported(preset: Preset) -> None:
    """Raise for preset features this package does not run yet."""
    t, m = preset.transform, preset.model
    if t.fft_impl != "matmul":
        raise NotImplementedError(
            f"fft_impl={t.fft_impl!r} is not ported for separation; have matmul "
            "(its mask and iSTFT kernels are ROADMAP queue 2)"
        )
    if t.analysis not in ("auto", "matmul"):
        raise NotImplementedError(f"analysis={t.analysis!r} is not ported; have auto | matmul")
    if t.multires or m.channels_in != 1:
        raise NotImplementedError("extra input channels (multires, score, stereo) are not ported")
    check_precision(t.dft_precision)


@torch.inference_mode()
def source_magnitudes(
    model: ConvSep, tracks: torch.Tensor, preset: Preset
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain up to the mask: tracks (B, length) float32 → the model's
    source magnitudes per frame y (B, S, nf, bins) in ``mask_dtype`` and
    the mixture's STFT halves re, im (B, nf, bins)."""
    t, m, tr = preset.transform, preset.model, preset.train
    re, im = stft_matmul(tracks, window_of(preset), t.hop_size, t.nfft)
    B, nf = re.shape[:2]
    mag = scale_magnitude(torch.sqrt(re * re + im * im), t.iscale) * tr.mult_factor_in
    segs = segment_frames(mag, m.time_context)  # (B, nseg, T, F)
    nseg = segs.shape[1]
    y = model.sources(segs.reshape(B * nseg, m.time_context, mag.shape[-1], 1))
    y = y.reshape(B, nseg, *y.shape[1:]).transpose(1, 2)  # (B, S, nseg, T, F)
    return unsegment_frames(y, nf), re, im


@torch.inference_mode()
def separate_fused_batch(
    model: ConvSep,
    tracks: torch.Tensor,
    preset: Preset,
    length: int,
    output_dtype: str = "float32",
    conserve_last: bool = False,
) -> torch.Tensor:
    """tracks (B, length) float32 or int16 → stems (B, S, length) float32
    or int16, on the tracks' device."""
    check_supported(preset)
    t = preset.transform
    if tracks.dim() != 2 or tracks.shape[1] != length:
        raise ValueError(f"tracks {tuple(tracks.shape)} must be (B, {length})")
    if tracks.dtype == torch.int16:
        tracks = tracks.float() * (1.0 / 32768.0)
    y_frames, re, im = source_magnitudes(model, tracks, preset)
    return istft_wiener(
        y_frames, re, im, window_of(preset), t.hop_size, length, nfft=t.nfft,
        precision=t.dft_precision, algorithm=t.masked_synthesis,
        output_dtype=output_dtype, p=preset.sep.wiener_p,
        eps=preset.sep.wiener_eps, conserve_last=conserve_last,
    )


def separate_fused(model: ConvSep, audio: torch.Tensor, preset: Preset, length: int,
                   output_dtype: str = "float32", conserve_last: bool = False) -> torch.Tensor:
    """audio (length,) → stems (S, length): the B = 1 case of
    :func:`separate_fused_batch`."""
    return separate_fused_batch(
        model, audio[None], preset, length, output_dtype, conserve_last
    )[0]


class Separator:
    """Whole-track separator.

    >>> sep = Separator(preset, state, device="cuda")
    >>> stems = sep(audio)   # (num_sources, len(audio)) numpy

    ``state``: a flat parameter dict (:mod:`convsep_tpu_torch.ckpt.bridge`).
    ``device``: where the model and the work live; "cuda" without a GPU
    raises (no CPU fallback).
    """

    def __init__(
        self,
        preset: Preset,
        state: dict[str, torch.Tensor],
        device: str | torch.device | None = None,
        output_dtype: str = "float32",
        input_dtype: str = "float32",
        conserve_last: bool = False,
    ):
        check_supported(preset)
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
        if input_dtype not in ("float32", "int16"):
            raise ValueError(f"input_dtype must be float32|int16, got {input_dtype}")
        self.preset = preset
        self.device = resolve_device(device)
        self.model = ConvSep(preset.model, state, device=self.device).prepare_inference()
        self.output_dtype = output_dtype
        self.input_dtype = input_dtype
        self.conserve_last = bool(conserve_last)

    def _prepare(self, audio: np.ndarray) -> np.ndarray:
        if self.input_dtype == "int16":
            return audio if audio.dtype == np.int16 else quantize_pcm16_host(audio)
        return np.asarray(audio, np.float32)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        """(length,) mono audio → (num_sources, length) stems, float32 in
        [-1, 1] or PCM16 per ``output_dtype``."""
        audio = self._prepare(np.asarray(audio))
        if audio.ndim != 1:
            raise ValueError(f"expected mono (length,) audio, got {audio.shape}")
        L = len(audio)
        Lb = bucket_length(L, self.preset)
        padded = torch.from_numpy(np.pad(audio, (0, Lb - L))).to(self.device)
        stems = separate_fused(
            self.model, padded, self.preset, Lb, self.output_dtype, self.conserve_last
        )
        return stems[:, :L].cpu().numpy()
