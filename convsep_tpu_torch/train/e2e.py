"""End-to-end training from raw audio: the STFT inside the train step.

Mirror of ``convsep_tpu.train.e2e`` (mono). The step consumes raw audio
segments, mixture (B, seg) and stems (B, S, seg), takes the STFT of all of
them on the device (the hand-written STFT kernel with
``fft_impl="pallas"``, the matmul DFT otherwise), scales the magnitudes,
runs the trainable model and the Wiener mask, and takes the interference
loss against the stem magnitudes. Segment length must be
:func:`segment_samples` so the framing lands on the model's time_context.

Not ported yet (ROADMAP queue 1): stereo (``decoder_reduce="all"``) and
multires in-step channels.
"""

from __future__ import annotations

from typing import Callable

import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.audio_dataset import segment_samples
from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.stft import scale_magnitude
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.models.convsep import train_sources, trainable_config
from convsep_tpu_torch.models.masks import wiener_filter
from convsep_tpu_torch.train.losses import interference_on_device, separation_loss
from convsep_tpu_torch.train.optim import GradientTransformation


def make_audio_loss_fn(preset: Preset) -> Callable:
    """(params, mix (B, seg), stems (B, S, seg)) → loss; STFT on the
    tensors' device."""
    t, m, tr = preset.transform, trainable_config(preset.model), preset.train
    if m.decoder_reduce == "all":
        raise NotImplementedError(
            "stereo (decoder_reduce='all') training is not ported yet (ROADMAP.md, queue 1)"
        )
    if t.multires:
        raise NotImplementedError(
            "multires in-step channels are not ported yet (ROADMAP.md, queue 1)"
        )
    win = (sinebell if t.window == "sinebell" else hann)(t.frame_size)
    seg = segment_samples(preset)
    interf = interference_on_device(preset)

    def mag_of(audio):  # (..., seg) → (..., T, F) scaled magnitude
        if t.fft_impl == "pallas":
            from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas

            re, im = stft_pallas(audio, win, t.hop_size, t.nfft)
        else:
            re, im = stft_matmul(audio, win, t.hop_size, t.nfft)
        return scale_magnitude(torch.sqrt(re * re + im * im), t.iscale)

    def loss_fn(params, mix, stems):
        B = mix.shape[0]
        if mix.shape[-1] != seg:
            raise ValueError(f"segment length {mix.shape[-1]} != required {seg}")
        x = mag_of(mix) * tr.mult_factor_in  # (B, T, F)
        # stem magnitudes land source-major (B, S, T, F): the model's layout
        y_t = (
            mag_of(stems.reshape(-1, seg)).reshape(B, -1, m.time_context, m.feat_size)
            * tr.mult_factor_out
        )
        out = train_sources(params, x[..., None], m)
        est = wiener_filter(out, x, eps=preset.sep.wiener_eps, axis=1)
        return separation_loss(est, y_t, interf(mix.device), source_axis=1)

    return loss_fn


def make_audio_train_step(preset: Preset, opt: GradientTransformation) -> Callable:
    """(state, mix (B, seg), stems (B, S, seg)) → (state, metrics): STFT +
    forward + backward + update."""
    from convsep_tpu_torch.train.loop import _preset_apply_fn, step_from_loss

    return step_from_loss(make_audio_loss_fn(preset), opt, _preset_apply_fn(preset))


def make_audio_train_step_multi(preset: Preset, opt: GradientTransformation) -> Callable:
    """K steps per call: (state, mix (K, B, seg), stems (K, B, S, seg)) →
    (state, {"loss": (K,), "grad_norm": (K,)})."""
    from convsep_tpu_torch.train.loop import _preset_apply_fn, multi_step_from_loss

    return multi_step_from_loss(make_audio_loss_fn(preset), opt, _preset_apply_fn(preset))
