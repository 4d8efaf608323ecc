"""Stereo separation: one joint forward for both channels.

Mirror of ``convsep_tpu.separate.stereo``. The model takes both channels'
magnitudes as its input channels (``channels_in=2``) and keeps a
per-channel estimate (``decoder_reduce="all"``):

    STFT of both channels → |X|·mult_factor_in → segments (nseg, T, F, 2)
    → ConvSep.sources (nseg, S, T, F, 2) → (S, 2, nf, F) → float32 Wiener
    masks over the sources × each channel's spectrum → iSTFT → stems

The masked spectra are materialized, as in the reference, and the iSTFT is
:func:`istft_matmul`'s "auto" route whatever ``transform.masked_synthesis``
says (that field chooses the mono path's masked synthesis): on CUDA tensors
at 4096 points, the hand-written iSTFT kernel ``istft_ct_pallas``. Like the
reference, the stereo path takes the plain DFT chain for its analysis
whatever ``fft_impl`` says (the STFT kernel's route is mono).
"""

from __future__ import annotations

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.segment import segment_frames, unsegment_frames
from convsep_tpu_torch.dsp.dft import istft_matmul, stft_matmul
from convsep_tpu_torch.dsp.stft import scale_magnitude
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.models.masks import wiener_mask
from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.separate.pipeline import (
    bucket_length,
    check_options,
    check_supported,
    window_of,
)
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.pcm import quantize_pcm16_host
from convsep_tpu_torch.utils.precision import float32_exact
from convsep_tpu_torch.utils.transfer import fetch


@float32_exact()
@torch.inference_mode()
def stereo_source_magnitudes(
    model: ConvSep, audio: torch.Tensor, preset: Preset
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stereo chain up to the mask: audio (2, length) float32 → the
    model's per-channel source magnitudes y (S, 2, nf, bins) in
    ``mask_dtype`` and both channels' STFT halves re, im (2, nf, bins)."""
    t, m, tr = preset.transform, preset.model, preset.train
    re, im = stft_matmul(audio, window_of(preset), t.hop_size, t.nfft)
    nf = re.shape[-2]
    mag = scale_magnitude(torch.sqrt(re * re + im * im), t.iscale) * tr.mult_factor_in
    segs = segment_frames(mag, m.time_context)  # (2, nseg, T, F)
    y = model.sources(segs.permute(1, 2, 3, 0))  # (nseg, S, T, F, 2)
    return unsegment_frames(y.permute(1, 4, 0, 2, 3), nf), re, im


@float32_exact()
@torch.inference_mode()
def separate_fused_stereo(
    model: ConvSep,
    audio: torch.Tensor,
    preset: Preset,
    length: int,
    output_dtype: str = "float32",
    conserve_last: bool = False,
) -> torch.Tensor:
    """audio (2, length) float32 or int16 → stems (S, 2, length) float32 or
    int16 (PCM16 quantized on the device), on the audio's device."""
    check_supported(preset, stereo=True)
    t = preset.transform
    if tuple(audio.shape) != (2, length):
        raise ValueError(f"audio {tuple(audio.shape)} must be (2, {length})")
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    y_frames, re, im = stereo_source_magnitudes(model, audio, preset)
    mask = wiener_mask(
        y_frames, p=preset.sep.wiener_p, eps=preset.sep.wiener_eps, axis=0,
        conserve_last=conserve_last,
    )
    return istft_matmul(
        mask * re, mask * im, window_of(preset), t.hop_size, length, nfft=t.nfft,
        output_dtype=output_dtype,
    )


class StereoSeparator:
    """Whole-track stereo separator.

    >>> sep = StereoSeparator(get_preset("highres4096-stereo"), state, device="cuda")
    >>> stems = sep(audio)   # (num_sources, length, 2) numpy

    Takes (length, 2) (the wav layout) or (2, length) audio, float32 or
    int16; returns (S, length, 2) stems, float32 or PCM16 per
    ``output_dtype``. ``device``, ``conserve_last``, ``complement_last`` and
    the stems' pinned host memory on a GPU as for
    :class:`~convsep_tpu_torch.separate.pipeline.Separator`.
    """

    def __init__(
        self,
        preset: Preset,
        state: dict[str, torch.Tensor],
        device: str | torch.device | None = None,
        output_dtype: str = "float32",
        input_dtype: str = "float32",
        conserve_last: bool = False,
        complement_last: bool = False,
    ):
        check_supported(preset, stereo=True)
        check_options(preset, output_dtype, input_dtype, conserve_last, complement_last)
        self.preset = preset
        self.device = resolve_device(device)
        self.model = ConvSep(preset.model, state, device=self.device).prepare_inference()
        self.output_dtype = output_dtype
        self.input_dtype = input_dtype
        self.complement_last = bool(complement_last)
        self.conserve_last = bool(conserve_last or complement_last)

    def _prepare(self, audio: np.ndarray) -> np.ndarray:
        """(L, 2) or (2, L) → (2, L) in ``input_dtype`` (the reference's
        rules: a (2, 2) array is taken as (2, L))."""
        if audio.ndim != 2:
            raise ValueError(f"expected stereo audio, got shape {audio.shape}")
        if audio.shape[1] == 2 and audio.shape[0] != 2:
            audio = audio.T
        elif audio.shape[0] != 2:
            raise ValueError(f"expected a 2-channel axis, got shape {audio.shape}")
        if self.input_dtype == "int16":
            return audio if audio.dtype == np.int16 else quantize_pcm16_host(audio)
        return np.asarray(audio, np.float32)

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        audio = self._prepare(np.asarray(audio))
        L = audio.shape[1]
        Lb = bucket_length(L, self.preset)
        padded = np.ascontiguousarray(np.pad(audio, ((0, 0), (0, Lb - L))))
        stems = separate_fused_stereo(
            self.model, torch.from_numpy(padded).to(self.device), self.preset, Lb,
            self.output_dtype, self.conserve_last,
        )
        if self.complement_last:
            others = fetch(stems[:-1])  # (S - 1, 2, Lb)
            last = derive_last_stem(others, padded, self.input_dtype, self.output_dtype)
            stems_h = np.concatenate([others, last[None]], axis=0)
        else:
            stems_h = fetch(stems)
        return stems_h[:, :, :L].transpose(0, 2, 1)
