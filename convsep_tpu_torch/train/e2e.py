"""End-to-end training from raw audio: the STFT inside the train step.

Mirror of ``convsep_tpu.train.e2e``. The step consumes raw audio
segments, mixture (B, seg) and stems (B, S, seg), takes the STFT of all of
them on the device (the hand-written STFT kernel with
``fft_impl="pallas"``, the matmul DFT otherwise), scales the magnitudes,
runs the trainable model and the Wiener mask, and takes the interference
loss against the stem magnitudes. Segment length must be
:func:`segment_samples` so the framing lands on the model's time_context.

Multires presets add the extra channels in the step
(:func:`convsep_tpu_torch.dsp.multires.multires_channels` of the mixture,
scaled like the network input). The joint-channel presets
(``decoder_reduce="all"``, ``*-stereo``) take mixture (B, 2, seg) and stems
(B, S, 2, seg): both ears through the STFT, one model over the (B, T, F,
2) input, its (B, S, T, F, 2) sources masked and held to the stems'.
"""

from __future__ import annotations

from typing import Callable

import torch

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.audio_dataset import segment_samples
from convsep_tpu_torch.dsp.dft import stft_matmul
from convsep_tpu_torch.dsp.multires import multires_channels
from convsep_tpu_torch.dsp.stft import scale_magnitude
from convsep_tpu_torch.dsp.windows import hann, sinebell
from convsep_tpu_torch.models.convsep import train_sources, trainable_config
from convsep_tpu_torch.models.masks import wiener_filter
from convsep_tpu_torch.train.losses import interference_on_device, separation_loss
from convsep_tpu_torch.train.optim import GradientTransformation


def make_audio_loss_fn(preset: Preset) -> Callable:
    """(params, mix (B, seg), stems (B, S, seg)) → loss, the STFT on the
    tensors' device; for a joint-channel preset mix (B, 2, seg) and stems
    (B, S, 2, seg)."""
    t, m, tr = preset.transform, trainable_config(preset.model), preset.train
    win = (sinebell if t.window == "sinebell" else hann)(t.frame_size)
    seg = segment_samples(preset)
    interf = interference_on_device(preset)

    def mag_of(audio):  # (N, seg) → (N, T, F) scaled magnitude
        if t.fft_impl == "pallas":
            from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas

            re, im = stft_pallas(audio, win, t.hop_size, t.nfft)
        else:
            re, im = stft_matmul(audio, win, t.hop_size, t.nfft)
        return scale_magnitude(torch.sqrt(re * re + im * im), t.iscale)

    def extra_of(mix):  # (B, seg) → (B, T, F, n_res): the reference's extra_of
        return scale_magnitude(multires_channels(mix, t), t.iscale) * tr.mult_factor_in

    def check(mix):
        if mix.shape[-1] != seg:
            raise ValueError(f"segment length {mix.shape[-1]} != required {seg}")

    def stereo_loss_fn(params, mix, stems):  # mix (B, 2, seg), stems (B, S, 2, seg)
        check(mix)
        B, T, F = mix.shape[0], m.time_context, m.feat_size
        x = (mag_of(mix.reshape(-1, seg)).reshape(B, 2, T, F) * tr.mult_factor_in
             ).permute(0, 2, 3, 1)  # (B, T, F, 2)
        y_t = (mag_of(stems.reshape(-1, seg)).reshape(B, m.num_sources, 2, T, F)
               * tr.mult_factor_out).permute(0, 1, 3, 4, 2)  # (B, S, T, F, 2)
        out = train_sources(params, x, m)  # (B, S, T, F, 2)
        est = wiener_filter(out, x, eps=preset.sep.wiener_eps, axis=1)
        return separation_loss(est, y_t, interf(mix.device), source_axis=1)

    if m.decoder_reduce == "all":
        return stereo_loss_fn

    def loss_fn(params, mix, stems):
        check(mix)
        B = mix.shape[0]
        x = mag_of(mix) * tr.mult_factor_in  # (B, T, F)
        # stem magnitudes land source-major (B, S, T, F): the model's layout
        y_t = (
            mag_of(stems.reshape(-1, seg)).reshape(B, -1, m.time_context, m.feat_size)
            * tr.mult_factor_out
        )
        xc = x[..., None]
        if t.multires:  # the multires channels, from the mixture in the step
            xc = torch.cat([xc, extra_of(mix)], dim=-1)
        out = train_sources(params, xc, m)
        est = wiener_filter(out, x, eps=preset.sep.wiener_eps, axis=1)
        return separation_loss(est, y_t, interf(mix.device), source_axis=1)

    return loss_fn


def make_audio_train_step(preset: Preset, opt: GradientTransformation,
                          reduce: Callable | None = None) -> Callable:
    """(state, mix (B, seg), stems (B, S, seg)) → (state, metrics) (stereo:
    (B, 2, seg), (B, S, 2, seg)): STFT + forward + backward + update.
    ``reduce``: the loss and gradients across ranks before the update."""
    from convsep_tpu_torch.train.loop import _preset_apply_fn, step_from_loss

    return step_from_loss(make_audio_loss_fn(preset), opt, _preset_apply_fn(preset), reduce)


def make_audio_train_step_multi(preset: Preset, opt: GradientTransformation,
                                reduce: Callable | None = None) -> Callable:
    """K steps per call: (state, mix (K, B, seg), stems (K, B, S, seg)) →
    (state, {"loss": (K,), "grad_norm": (K,)})."""
    from convsep_tpu_torch.train.loop import _preset_apply_fn, multi_step_from_loss

    return multi_step_from_loss(make_audio_loss_fn(preset), opt, _preset_apply_fn(preset),
                                reduce)
