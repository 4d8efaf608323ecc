"""Analytic FLOP accounting for whole-track separation, and MFU against
the card's peaks.

Mirror of ``convsep_tpu.utils.flops``: the same count, multiply-add
FLOPs (1 MAC = 2 FLOPs) of every GEMM-shaped stage of one
``separate_fused`` call, for the decoder the preset's ``decoder_impl``
names:

  * the forward DFT products (re + im, the window folded in; the factored
    chain from 2048 points, ``dsp/dft.py``)
  * the conv1 (frequency) and conv2 (time) encoder convolutions
  * the bottleneck and expansion dense layers
  * the decode: ``bandconv`` ("auto" and the fused kernel compute the same
    composition) as one composed conv along W' over the padded W_pad
    positions, or ``band``: the dense band GEMM and the phase-decomposed
    frequency conv
  * the inverse DFT products (× S sources)

Elementwise work (window, magnitude, Wiener mask, overlap-add) is left
out: bound by bytes, and under 1 % of the total.

``mfu_bf16`` keeps the reference's definition, achieved TFLOP/s ÷ the
card's dense bf16 peak, so the numbers stay comparable across presets
and with the reference's, although the port's products run in float32
(on the CUDA cores, or 3xTF32 in the fused decode). The peaks are the
data sheets' dense figures, keyed on ``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.dsp.dft import _split_factor, _use_factored
from convsep_tpu_torch.dsp.stft import num_frames

# dense peak TFLOP/s by device name (lowercased substring): NVIDIA's data
# sheet for the H100 SXM (80GB HBM3); "cpu" a placeholder so that CPU runs
# do not divide by zero
_PEAK_TFLOPS = {
    "h100 80gb hbm3": {"bf16": 989.4, "tf32": 494.7, "fp32": 66.9},
    "cpu": {"bf16": 0.1, "tf32": 0.1, "fp32": 0.1},
}


def device_peak_tflops(device_kind: str, precision: str = "bf16") -> float | None:
    """The dense peak of ``device_kind`` (a ``torch.cuda.get_device_name``
    or "cpu") at ``precision`` (bf16 | tf32 | fp32); None for a card not
    in the table."""
    dk = device_kind.lower()
    for key, peaks in _PEAK_TFLOPS.items():
        if key in dk:
            return peaks[precision]
    return None


def model_param_count(cfg) -> int:
    """Analytic parameter count of ConvSep."""
    C, S = cfg.channels_in, cfg.num_sources
    N1, N2 = cfg.conv1_filters, cfg.conv2_filters
    conv1 = cfg.conv1_freq * C * N1 + N1
    conv2 = cfg.conv2_time_eff * N1 * N2 + N2
    fc = cfg.enc_flat * cfg.bottleneck + cfg.bottleneck
    fc_expand = cfg.bottleneck * S * cfg.enc_flat + S * cfg.enc_flat
    return conv1 + conv2 + fc + fc_expand


def model_flops_per_segment(cfg) -> dict:
    """MAC-derived FLOPs of one ConvSep forward over one (T, F, C) segment
    with the decoder ``cfg.decoder_impl`` names."""
    T, C, S = cfg.time_context, cfg.channels_in, cfg.num_sources
    N1, N2 = cfg.conv1_filters, cfg.conv2_filters
    Wp, Tp = cfg.enc_freq, cfg.enc_time
    kt = cfg.conv2_time_eff
    stride = cfg.conv1_freq_stride
    ktaps = -(-cfg.conv1_freq // stride)
    out = {
        "conv1": 2 * T * Wp * N1 * (cfg.conv1_freq * C),
        "conv2": 2 * Tp * Wp * N2 * (kt * N1),
        "fc": 2 * cfg.enc_flat * cfg.bottleneck,
        "fc_expand": 2 * cfg.bottleneck * S * cfg.enc_flat,
    }
    if cfg.decoder_impl in ("bandconv", "bandconv_pallas", "bandconv_nlast", "auto"):
        W_pad = -(-Wp // 8) * 8
        out["decode_bandconv"] = (
            S * 2 * (W_pad + ktaps - 1) * (ktaps * Tp * N2) * (T * stride * C)
        )
    else:
        out["decode_band_gemm"] = S * 2 * Wp * (Tp * N2) * (T * N1)
        out["decode_freq_conv"] = S * 2 * (Wp + ktaps - 1) * T * (stride * C) * (ktaps * N1)
    out["total"] = sum(out.values())
    return out


def _fwd_cost(n: int) -> int:
    """Per-frame forward-DFT FLOPs of one channel (re + im)."""
    if _use_factored("auto", n):
        a, b = _split_factor(n)
        return 4 * n * b + 6 * n + 8 * n * a
    return 2 * 2 * n * (n // 2 + 1)


def _inv_cost(n: int) -> int:
    """Per-frame inverse-DFT FLOPs of one stem."""
    if _use_factored("auto", n):
        a, b = _split_factor(n)
        k2n = (n // 2) // a
        return 8 * n * k2n + 6 * n + 4 * n * a + 4 * n
    return 2 * 2 * n * (n // 2 + 1)


def pipeline_flops_per_track(preset: Preset, length: int) -> dict:
    """FLOPs of one ``separate_fused`` call on a ``length``-sample track."""
    t, m = preset.transform, preset.model
    nfft = t.nfft or t.frame_size
    nf = num_frames(length, t.hop_size)
    nseg = -(-nf // m.time_context)
    seg = model_flops_per_segment(m)
    nch = 2 if m.decoder_reduce == "all" else 1  # stereo presets: both ears
    dft_fwd = nch * nf * _fwd_cost(nfft)
    for r in t.multires:
        dft_fwd += nf * _fwd_cost(r)
    dft_inv = nch * m.num_sources * nf * _inv_cost(nfft)
    model = nseg * seg["total"]
    return {
        "length": length,
        "n_frames": nf,
        "n_segments": nseg,
        "dft_forward": dft_fwd,
        "dft_inverse": dft_inv,
        "model": model,
        "model_per_segment": seg,
        "total": dft_fwd + model + dft_inv,
    }


def mfu(preset: Preset, length: int, seconds_per_track: float, device_kind: str) -> dict:
    """Achieved TFLOP/s and the fraction of the bf16 peak for one per-track
    time (``mfu_bf16`` None on a card without a peak in the table)."""
    fl = pipeline_flops_per_track(preset, length)
    tflops = fl["total"] / seconds_per_track / 1e12
    peak = device_peak_tflops(device_kind)
    return {
        "flops_per_track": fl["total"],
        "tflops": round(tflops, 2),
        "mfu_bf16": None if peak is None else round(tflops / peak, 4),
        "peak_bf16_tflops": peak,
    }
