"""Whole-track separation.

Mirror of ``convsep_tpu.separate.pipeline``: the chain

    PCM in → framing + window + DFT → |X|·mult_factor_in → 30-frame
    segments (+ extra input channels) → ConvSep.sources → unsegment →
    score gate → Wiener mask × mixture → inverse DFT + overlap-add → stems

runs on one device with segments as the model's batch axis; track lengths
are bucketed like the reference's, so a model sees a bounded set of shapes.
On CUDA the hand-written kernels carry the decode (highres-class geometry)
and the masked resynthesis. ``TransformConfig.analysis="ct_pallas"`` takes
the forward STFT kernel, whose Nyquist-separate spectra the Wiener+iSTFT
kernel reads as they are. With ``TransformConfig.fft_impl="pallas"``
:func:`separate_fused` takes the reference's kernel route instead: the
STFT kernel, the Wiener mask kernel and the iSTFT kernel.

Extra input channels: multires presets compute theirs on the device
(:mod:`convsep_tpu_torch.dsp.multires`); score-informed presets (bach10)
take the caller's ``extra`` (:func:`convsep_tpu_torch.data.features.
score_channels`), which can also gate the estimates (:func:`score_gate`).

Not ported yet: the ``fft`` transform route. Stereo presets run through
:mod:`convsep_tpu_torch.separate.stereo`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.segment import segment_frames, unsegment_frames
from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import resolve_analysis, stft_ct_pallas
from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas
from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas
from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_pallas
from convsep_tpu_torch.dsp.dft import check_precision, istft_wiener, stft_matmul
from convsep_tpu_torch.dsp.multires import multires_channels
from convsep_tpu_torch.dsp.stft import num_frames, scale_magnitude
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.models.convsep import ConvSep
from convsep_tpu_torch.separate.complement import derive_last_stem
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.pcm import quantize_pcm16, quantize_pcm16_host
from convsep_tpu_torch.utils.precision import float32_exact
from convsep_tpu_torch.utils.transfer import fetch


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


def check_supported(preset: Preset, stereo: bool = False) -> None:
    """Raise for preset features this package does not run yet, and, at the
    stereo entry (``stereo=True``), for a preset that is not stereo."""
    t, m = preset.transform, preset.model
    if t.fft_impl not in ("matmul", "pallas"):
        raise NotImplementedError(
            f"fft_impl={t.fft_impl!r} is not ported for separation; have matmul | pallas"
        )
    if stereo:
        if m.channels_in != 2 or m.decoder_reduce != "all":
            raise ValueError(
                "separate_fused_stereo needs a stereo preset (channels_in=2, "
                f"decoder_reduce='all'); got channels_in={m.channels_in}, "
                f"decoder_reduce={m.decoder_reduce!r}"
            )
    else:
        resolve_analysis(t.analysis)
        if m.decoder_reduce == "all":
            raise NotImplementedError("stereo presets run through StereoSeparator")
        if t.multires and m.channels_in != 1 + len(t.multires):
            raise ValueError(
                f"multires {t.multires} needs channels_in={1 + len(t.multires)}, "
                f"got {m.channels_in}"
            )
    check_precision(t.dft_precision)


def score_gate(y: torch.Tensor, extra: torch.Tensor | None, mag: torch.Tensor,
               preset: Preset) -> torch.Tensor:
    """Score-gated estimates (the reference's ``_score_gate``,
    ``SepConfig.score_gate`` g and ``score_gate_mode``): y (B, S, nf, F),
    extra (B, nf, F, S) score-filtered channels (mask_i · |mix| ·
    mult_factor_in), mag (B, nf, F) the scaled mixture magnitude.

    "mult": y · ((1 − g) + g · clip(extra_i / (mag + 1e-6), 0, 1));
    "blend": (1 − g) · y + g · extra_i · mult_factor_out / mult_factor_in.
    y as it is unless the preset is score-informed (channels_in = 1 + S, no
    multires), lin iscale and g > 0."""
    g = preset.sep.score_gate
    m, t = preset.model, preset.transform
    if (
        g <= 0
        or extra is None
        or t.multires
        or t.iscale != "lin"
        or m.channels_in != 1 + m.num_sources
    ):
        return y
    prior = extra.movedim(-1, 1)
    if preset.sep.score_gate_mode == "blend":
        prior = prior * (preset.train.mult_factor_out / preset.train.mult_factor_in)
        return (1.0 - g) * y + g * prior
    if preset.sep.score_gate_mode != "mult":
        raise ValueError(
            f"unknown score_gate_mode {preset.sep.score_gate_mode!r}; have mult | blend"
        )
    gate = torch.clamp(prior / (mag[:, None] + 1e-6), 0.0, 1.0)
    return y * ((1.0 - g) + g * gate)


@float32_exact()
@torch.inference_mode()
def source_magnitudes(
    model: ConvSep, tracks: torch.Tensor, preset: Preset, extra: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The chain up to the mask: tracks (B, length) float32 → the model's
    (score-gated) source magnitudes per frame y (B, S, nf, bins) in
    ``mask_dtype`` (float32 once gated), the mixture's STFT halves re, im
    and the Nyquist row ny. ``fft_impl="pallas"`` takes the STFT kernel's
    wrapper; "matmul" the plain DFT chain, or with ``analysis="ct_pallas"``
    the forward STFT kernel, whose re/im (B, nf, nfft/2) leave the Nyquist
    bin to ny (B, nf); ny is None otherwise.

    ``extra``: (B, nf, bins, C − 1) or (nf, bins, C − 1) extra input
    channels, broadcast to every track; None computes a multires preset's
    own on the device."""
    t, m, tr = preset.transform, preset.model, preset.train
    ny = None
    if t.fft_impl == "pallas":
        re, im = stft_pallas(tracks, window_of(preset), t.hop_size, t.nfft)
    elif resolve_analysis(t.analysis) == "ct_pallas":
        re, im, ny = stft_ct_pallas(tracks, window_of(preset), t.hop_size, t.nfft)
    else:
        re, im = stft_matmul(tracks, window_of(preset), t.hop_size, t.nfft)
    B, nf = re.shape[:2]
    mag = torch.sqrt(re * re + im * im)
    if ny is not None:
        mag = torch.cat([mag, ny.abs().unsqueeze(-1)], dim=-1)
    mag = scale_magnitude(mag, t.iscale) * tr.mult_factor_in
    if extra is None and t.multires:
        extra = scale_magnitude(multires_channels(tracks, t), t.iscale) * tr.mult_factor_in
    segs = segment_frames(mag, m.time_context)[..., None]  # (B, nseg, T, F, 1)
    if extra is not None:
        extra = extra.to(device=mag.device, dtype=torch.float32).expand(B, *extra.shape[-3:])
        if tuple(extra.shape[1:3]) != tuple(mag.shape[1:]):
            raise ValueError(f"extra {tuple(extra.shape)} does not match the mixture's "
                             f"frames and bins {tuple(mag.shape[1:])}")
        ex = segment_frames(extra.permute(0, 3, 1, 2), m.time_context)  # (B, C-1, nseg, T, F)
        segs = torch.cat([segs, ex.permute(0, 2, 3, 4, 1)], dim=-1)
    nseg = segs.shape[1]
    y = model.sources(segs.reshape(B * nseg, *segs.shape[2:]))
    y = y.reshape(B, nseg, *y.shape[1:]).transpose(1, 2)  # (B, S, nseg, T, F)
    y = score_gate(unsegment_frames(y, nf), extra, mag, preset)
    return y, re, im, ny


@float32_exact()
@torch.inference_mode()
def separate_fused_batch(
    model: ConvSep,
    tracks: torch.Tensor,
    preset: Preset,
    length: int,
    output_dtype: str = "float32",
    conserve_last: bool = False,
    extra: torch.Tensor | None = None,
) -> torch.Tensor:
    """tracks (B, length) float32 or int16 → stems (B, S, length) float32
    or int16, on the tracks' device. ``extra``: (B, nf, bins, C − 1) or
    (nf, bins, C − 1) extra input channels (:func:`source_magnitudes`).
    The ``fft_impl="pallas"`` route runs one track at a time
    (:func:`separate_fused`), as in the reference."""
    check_supported(preset)
    t = preset.transform
    if t.fft_impl == "pallas":
        raise ValueError("separate_fused_batch: use separate_fused for fft_impl='pallas'")
    if tracks.dim() != 2 or tracks.shape[1] != length:
        raise ValueError(f"tracks {tuple(tracks.shape)} must be (B, {length})")
    if tracks.dtype == torch.int16:
        tracks = tracks.float() * (1.0 / 32768.0)
    y_frames, re, im, ny = source_magnitudes(model, tracks, preset, extra)
    return istft_wiener(
        y_frames, re, im, window_of(preset), t.hop_size, length, nfft=t.nfft,
        precision=t.dft_precision, algorithm=t.masked_synthesis,
        output_dtype=output_dtype, p=preset.sep.wiener_p,
        eps=preset.sep.wiener_eps, conserve_last=conserve_last, ny=ny,
    )


@float32_exact()
@torch.inference_mode()
def separate_fused(model: ConvSep, audio: torch.Tensor, preset: Preset, length: int,
                   output_dtype: str = "float32", conserve_last: bool = False,
                   extra: torch.Tensor | None = None) -> torch.Tensor:
    """audio (length,) → stems (S, length): the B = 1 case of
    :func:`separate_fused_batch`, or with ``fft_impl="pallas"`` the
    reference's kernel route: the STFT kernel, the model, the Wiener mask
    kernel and the iSTFT kernel (each a plain version on CPU tensors), then
    PCM16 if asked. That route has no conservative masks. ``extra``:
    (nf, bins, C − 1) extra input channels."""
    t = preset.transform
    if t.fft_impl != "pallas":
        return separate_fused_batch(
            model, audio[None], preset, length, output_dtype, conserve_last, extra
        )[0]
    check_supported(preset)
    if conserve_last:
        raise ValueError("conserve_last is not supported by the pallas mask kernel")
    if audio.shape != (length,):
        raise ValueError(f"audio {tuple(audio.shape)} must be ({length},)")
    if audio.dtype == torch.int16:
        audio = audio.float() * (1.0 / 32768.0)
    y, re, im, _ = source_magnitudes(model, audio[None], preset, extra)
    est_re, est_im = wiener_apply_pallas(
        y[0], re[0], im[0], p=preset.sep.wiener_p, eps=preset.sep.wiener_eps
    )
    stems = istft_pallas(est_re, est_im, window_of(preset), t.hop_size, length, nfft=t.nfft)
    return quantize_pcm16(stems) if output_dtype == "int16" else stems


def fit_extra(extra: np.ndarray, length: int, preset: Preset) -> np.ndarray:
    """(n_frames, bins, C − 1) extra channels, float32, padded with zero
    frames or trimmed to the frame count of a ``length``-sample track."""
    nf = num_frames(length, preset.transform.hop_size)
    extra = np.asarray(extra, np.float32)
    if extra.shape[0] < nf:
        extra = np.pad(extra, ((0, nf - extra.shape[0]), (0, 0), (0, 0)))
    return np.ascontiguousarray(extra[:nf])


def check_options(preset: Preset, output_dtype: str, input_dtype: str,
                  conserve_last: bool, complement_last: bool) -> None:
    """The separators' option checks (the reference's)."""
    if output_dtype not in ("float32", "int16"):
        raise ValueError(f"output_dtype must be float32|int16, got {output_dtype}")
    if input_dtype not in ("float32", "int16"):
        raise ValueError(f"input_dtype must be float32|int16, got {input_dtype}")
    if complement_last and preset.model.num_sources < 2:
        raise ValueError(
            "complement_last requires a preset with >= 2 sources "
            f"(got num_sources={preset.model.num_sources})"
        )


class Separator:
    """Whole-track separator.

    >>> sep = Separator(preset, state, device="cuda")
    >>> stems = sep(audio)   # (num_sources, len(audio)) numpy

    ``state``: a flat parameter dict (:mod:`convsep_tpu_torch.ckpt.bridge`).
    ``device``: where the model and the work live; ``None`` means "cuda",
    and "cuda" without a GPU raises (the CPU only when asked for).
    ``conserve_last``: conservative masks (they sum to exactly 1, the last
    stem takes the shortfall). ``complement_last`` (implies
    ``conserve_last``): the device copies S − 1 stems and the last is the
    mixture minus their sum, on the host (:mod:`.complement`). Neither
    runs on the ``fft_impl="pallas"`` route.
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
        check_supported(preset)
        check_options(preset, output_dtype, input_dtype, conserve_last, complement_last)
        if (conserve_last or complement_last) and preset.transform.fft_impl == "pallas":
            raise ValueError("conserve_last is not supported by the pallas mask kernel")
        self.preset = preset
        self.device = resolve_device(device)
        self.model = ConvSep(preset.model, state, device=self.device).prepare_inference()
        self.output_dtype = output_dtype
        self.input_dtype = input_dtype
        self.complement_last = bool(complement_last)
        self.conserve_last = bool(conserve_last or complement_last)

    def _prepare(self, audio: np.ndarray) -> np.ndarray:
        if self.input_dtype == "int16":
            return audio if audio.dtype == np.int16 else quantize_pcm16_host(audio)
        return np.asarray(audio, np.float32)

    def __call__(self, audio: np.ndarray, extra: np.ndarray | None = None) -> np.ndarray:
        """(length,) mono audio → (num_sources, length) stems, float32 in
        [-1, 1] or PCM16 per ``output_dtype``. On a GPU the stems are a view
        of pinned host memory (:func:`~convsep_tpu_torch.utils.transfer.fetch`):
        a caller that keeps the stems of many tracks copies them
        (``np.array(stems)``) so that the pinned blocks go back for reuse.

        ``extra``: (n_frames, bins, C − 1) extra input channels aligned with
        the mixture's frames and scaled like the network input (bach10's
        score channels × ``mult_factor_in``); padded with zero frames or
        trimmed to the bucketed track's frame count."""
        audio = self._prepare(np.asarray(audio))
        if audio.ndim != 1:
            raise ValueError(f"expected mono (length,) audio, got {audio.shape}")
        L = len(audio)
        Lb = bucket_length(L, self.preset)
        padded = np.pad(audio, (0, Lb - L))
        if extra is not None:
            extra = torch.from_numpy(fit_extra(extra, Lb, self.preset)).to(self.device)
        stems = separate_fused(
            self.model, torch.from_numpy(padded).to(self.device), self.preset, Lb,
            self.output_dtype, self.conserve_last, extra,
        )
        if self.complement_last:
            others = fetch(stems[:-1])
            last = derive_last_stem(others, padded, self.input_dtype, self.output_dtype)
            return np.concatenate([others, last[None]], axis=0)[:, :L]
        return fetch(stems)[:, :L]
