#!/usr/bin/env python3
"""Smoke test of convsep_tpu_torch on one NVIDIA GPU (the quickest proof
that the port still starts and is right on the card).

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then non-zero and no
result line is printed):

1. device: the card's name and power limit (nvidia-smi); build both CUDA
   kernels from ``convsep_tpu_torch/csrc`` and print the build time;
2. fused decode kernel vs its plain PyTorch version at highres4096 shapes
   (B 49, S 4, J 128, W 505, TpC 800, ktaps 8, TM 120), float32 and bf16
   output;
3. Wiener+iSTFT kernel vs its plain version at highres4096 (nfft 4096,
   hop 1024, nf 1442, bf16 y) and dsd100 (nfft 1024, hop 512, nf 2882):
   p = 1 and 2, conserve_last, float32 and int16 output;
4. the slice: ``Separator`` for highres4096 and dsd100 at full width with
   seeded random weights on a 30 s 44.1 kHz mixture: finite stems of the
   right shape, kernel launch counters above zero, the kernel route
   against the plain route in float32 (the model's output elementwise,
   the stems by SNR), conservation of the mixture, the bf16 tail's SNR
   against the f32 tail, ms per track and real-time factor.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
the last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device and when run outside the repository checkout. TF32 is off for
every parity comparison (matmul and cuDNN).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SECONDS = 30.0
FS = 44100

# tolerances, each with its reason
TOL_DECODE_F32 = 1e-5    # × max|plain|: f32 sums of ~7k products in another order
TOL_DECODE_BF16 = 2 ** -7  # × max|plain|: the same f32 sums rounded to bf16, 1 ulp
TOL_WIENER_F32 = 1e-5    # absolute on [-1, 1] stems, the reference kernel test's bound
TOL_WIENER_I16 = 1       # LSB: round-to-nearest of f32 values that differ in the last bits
TOL_SLICE_Y = 1e-5       # × max|y|: the model's f32 source magnitudes, kernel vs plain route
MIN_SNR_SLICE_DB = 70.0  # f32-tail stems, kernel vs plain route (see phase_slice)
TOL_CONSERVE = 1e-4      # Σ stems vs the STFT→iSTFT round-tripped mixture
MIN_SNR_BF16_DB = 40.0   # bf16 tail vs f32 tail (random weights amplify rounding where Σy → 0)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_decode(model, B: int, device, gen) -> dict:
    """Fused decode kernel vs plain at the model's operand shapes."""
    import torch
    from convsep_tpu_torch.models.decoder_fused_cuda import (
        band_freq_decode,
        band_freq_decode_plain,
    )

    J = model.k4.shape[0]
    fc = torch.relu(torch.randn(B, J, generator=gen, device=device))
    ops = (model.k4, model.b3, model.kcat)
    err = {}
    for dt in (torch.float32, torch.bfloat16):
        got = band_freq_decode(fc, *ops, out_dtype=dt).float()
        want = band_freq_decode_plain(fc, *ops, out_dtype=dt).float()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        tol = (TOL_DECODE_F32 if dt == torch.float32 else TOL_DECODE_BF16) * scale
        e = (got - want).abs().max().item()
        log(f"  decode {str(dt)[6:]}: shape {tuple(got.shape)} max_abs_err {e:.3e} "
            f"(tol {tol:.3e}, max|plain| {scale:.3e})")
        if not e <= tol:
            raise AssertionError(f"fused decode {dt} disagrees: {e} > {tol}")
        err[dt] = e
    ms = cuda_ms(lambda: band_freq_decode(fc, *ops, out_dtype=torch.bfloat16))
    plain_ms = cuda_ms(lambda: band_freq_decode_plain(fc, *ops, out_dtype=torch.bfloat16))
    log(f"  decode bf16 out: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (B={B})")
    return {"max_abs_err": err[torch.float32], "ms": ms, "plain_ms": plain_ms}


def wiener_inputs(nfft: int, hop: int, nf: int, S: int, device, gen):
    import torch
    from convsep_tpu_torch.dsp.dft import stft_matmul
    from convsep_tpu_torch.dsp.windows import sinebell

    L = (nf - 2) * hop
    w = sinebell(nfft)
    x = 0.3 * torch.randn(1, L, generator=gen, device=device)
    re, im = stft_matmul(x, w, hop)
    assert re.shape[-2] == nf, (re.shape, nf)
    y = torch.randn(1, S, nf, nfft // 2 + 1, generator=gen, device=device).abs()
    y[..., : nf // 3, :8] = 0.0  # dead bins: the eps shortfall paths
    return w, L, y.to(torch.bfloat16), re, im


def phase_wiener(name: str, nfft: int, hop: int, nf: int, S: int, device, gen) -> dict:
    """Wiener+iSTFT kernel vs plain: p ∈ {1, 2}, conserve_last, f32/int16."""
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain

    w, L, y, re, im = wiener_inputs(nfft, hop, nf, S, device, gen)
    worst = 0.0
    for kw in ({"p": 1.0}, {"p": 2.0}, {"p": 1.0, "conserve_last": True}):
        for out in ("float32", "int16"):
            got = wiener_istft(y, re, im, w, hop, L, output_dtype=out, **kw)
            want = wiener_istft_plain(y, re, im, w, hop, L, output_dtype=out, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"wiener_istft {name} {kw} {out}: non-finite output")
            e = (got.float() - want.float()).abs().max().item()
            tol = TOL_WIENER_I16 if out == "int16" else TOL_WIENER_F32
            unit = "LSB" if out == "int16" else ""
            log(f"  wiener {name} {kw} {out}: max_abs_err {e:.3e}{unit} (tol {tol})")
            if not e <= tol:
                raise AssertionError(f"wiener_istft {name} {kw} {out}: {e} > {tol}")
            if out == "float32":
                worst = max(worst, e)
    ms = cuda_ms(lambda: wiener_istft(y, re, im, w, hop, L))
    plain_ms = cuda_ms(lambda: wiener_istft_plain(y, re, im, w, hop, L))
    log(f"  wiener {name} p=1 f32 out: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def mixture(seed: int = 0):
    """A 30 s 44.1 kHz mixture: four vibrato tones plus noise, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(SECONDS * FS)) / FS
    x = sum(
        0.15 * np.sin(2 * np.pi * f * t + 0.5 * np.sin(2 * np.pi * 5 * t + rng.uniform(0, 6)))
        for f in (110.0, 440.0, 1320.0, 3520.0)
    )
    return (x + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def plain_route(preset):
    """The same preset forced onto plain PyTorch everywhere."""
    from convsep_tpu_torch.dsp.dft import _use_factored

    nfft = preset.transform.nfft or preset.transform.frame_size
    return dataclasses.replace(
        preset,
        model=dataclasses.replace(preset.model, decoder_impl="bandconv"),
        transform=dataclasses.replace(
            preset.transform,
            masked_synthesis="factored" if _use_factored("auto", nfft) else "direct",
        ),
    )


def snr_db(ref, est) -> float:
    import numpy as np

    ref = ref.astype(np.float64)
    err = est.astype(np.float64) - ref
    return float(10 * np.log10((ref ** 2).sum() / max((err ** 2).sum(), 1e-300)))


def time_track(sep, audio, reps: int = 5) -> float:
    """Median host ms of a whole-track call (ends in the stems' host copy)."""
    import torch

    sep(audio)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep(audio)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def phase_slice(name: str, state, preset, device, audio, expect: dict) -> dict:
    """Separator at full width: counters, finiteness, kernel vs plain route,
    conservation, bf16 vs f32 tail, ms per track."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain
    from convsep_tpu_torch.dsp.dft import istft_matmul
    from convsep_tpu_torch.separate import Separator, bucket_length, source_magnitudes
    from convsep_tpu_torch.separate.pipeline import window_of

    sep = Separator(preset, state, device=device)
    sep(audio[: FS])  # first call: kernel build and cuBLAS warm-up
    kernels.reset_launches()
    stems = sep(audio)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  {name}: stems {stems.shape} {stems.dtype}, launches {launches}")
    S = preset.model.num_sources
    if stems.shape != (S, len(audio)) or not np.isfinite(stems).all():
        raise AssertionError(f"{name}: bad stems {stems.shape}, finite={np.isfinite(stems).all()}")
    for k, want in expect.items():
        if (launches[k] > 0) != want:
            raise AssertionError(f"{name}: kernel {k} launched {launches[k]} times, expected "
                                 f"{'>0' if want else '0'}")
    ms = time_track(sep, audio)
    plain = Separator(plain_route(preset), state, device=device)
    plain_ms = time_track(plain, audio)
    log(f"  {name}: {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time); plain route "
        f"{plain_ms:.2f} ms/track ({SECONDS * 1e3 / plain_ms:.1f}x)")
    del plain
    # f32 tail, kernel route vs plain route, elementwise in two halves: the
    # model's source magnitudes y, and the kernel route's stems against the
    # plain synthesis of its own y. The two routes' stems are compared by
    # SNR only: with random weights some bins have every source's y near 0,
    # where the Wiener ratio turns f32 sums taken in another order (~1e-6
    # relative) into O(1) mask changes.
    f32 = dataclasses.replace(preset, model=dataclasses.replace(preset.model, mask_dtype="float32"))
    k32 = Separator(f32, state, device=device)
    p32 = Separator(plain_route(f32), state, device=device)
    Lb = bucket_length(len(audio), preset)
    x = torch.from_numpy(np.pad(audio, (0, Lb - len(audio))))[None].to(device)
    y_k, re, im = source_magnitudes(k32.model, x, f32)
    y_p = source_magnitudes(p32.model, x, plain_route(f32))[0]
    scale = y_p.abs().max().item()
    ey = (y_k - y_p).abs().max().item()
    log(f"  {name} f32 tail: model y kernel route vs plain route max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}, max|y| {scale:.3e})")
    if not ey <= TOL_SLICE_Y * scale:
        raise AssertionError(f"{name}: model output of the kernel route disagrees: {ey}")
    w = window_of(preset)
    hop = preset.transform.hop_size
    stems32, plain32 = k32(audio), p32(audio)
    del k32, p32
    synth = wiener_istft_plain(y_k, re, im, w, hop, Lb, p=preset.sep.wiener_p,
                               eps=preset.sep.wiener_eps)[0, :, : len(audio)].cpu().numpy()
    es = float(np.abs(stems32 - synth).max())
    log(f"  {name} f32 tail: stems vs plain synthesis of the same y max_abs_err {es:.3e} "
        f"(tol {TOL_WIENER_F32})")
    if not es <= TOL_WIENER_F32:
        raise AssertionError(f"{name}: kernel route synthesis disagrees: {es}")
    snr32 = snr_db(plain32, stems32)
    log(f"  {name} f32 tail: stems kernel route vs plain route SNR {snr32:.1f} dB "
        f"(min {MIN_SNR_SLICE_DB}), max_abs_err {np.abs(stems32 - plain32).max():.3e}")
    if not snr32 >= MIN_SNR_SLICE_DB:
        raise AssertionError(f"{name}: kernel route stems disagree with plain route: {snr32} dB")
    snr = snr_db(stems32, stems)
    log(f"  {name} bf16 tail vs f32 tail: SNR {snr:.1f} dB (min {MIN_SNR_BF16_DB})")
    if not snr >= MIN_SNR_BF16_DB:
        raise AssertionError(f"{name}: bf16 tail SNR {snr} dB")
    # conservation: masks sum to 1, so the stems add back to the mixture
    cons = Separator(preset, state, device=device, conserve_last=True)(audio)
    rt = istft_matmul(re, im, w, hop, Lb)[0, : len(audio)].cpu().numpy()
    ce = float(np.abs(cons.sum(0) - rt).max())
    log(f"  {name} conserve_last: |Σ stems − mixture| max {ce:.3e} (tol {TOL_CONSERVE})")
    if not ce <= TOL_CONSERVE:
        raise AssertionError(f"{name}: conserve_last stems do not add up: {ce}")
    return {"ms": ms, "plain_ms": plain_ms, "launches": launches}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    try:
        import convsep_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: convsep_tpu_torch not found beside this script: {e}", file=sys.stderr)
        return 1
    if Path(convsep_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: convsep_tpu_torch is not the checkout's own package", file=sys.stderr)
        return 1
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.models import ConvSep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = smi_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernels.build(verbose=True)
    kernels.library()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")

    hi = get_preset("highres4096")
    dsd = get_preset("dsd100")
    gen = torch.Generator(device=device).manual_seed(0)
    hi_state = init_params(hi.model, gen, device)
    log("phase 2: fused decode kernel vs plain (highres4096 shapes)")
    hi_model = ConvSep(hi.model, hi_state, device=device).prepare_inference()
    assert tuple(hi_model.k4.shape) == (128, 4, 512, 800), tuple(hi_model.k4.shape)
    assert tuple(hi_model.kcat.shape) == (800, 8, 120), tuple(hi_model.kcat.shape)
    dec = phase_decode(hi_model, 49, device, gen)
    del hi_model
    log("phase 3: Wiener+iSTFT kernel vs plain")
    wie = phase_wiener("highres4096", 4096, 1024, 1442, 4, device, gen)
    phase_wiener("dsd100", 1024, 512, 2882, 4, device, gen)
    torch.cuda.empty_cache()

    log("phase 4: separation slice, 30 s 44.1 kHz mixture, seeded random weights")
    audio = mixture(0)
    hi_run = phase_slice("highres4096", hi_state, hi, device, audio,
                         {"fused_decode": True, "wiener_istft": True})
    del hi_state
    torch.cuda.empty_cache()
    dsd_state = init_params(dsd.model, torch.Generator(device=device).manual_seed(1), device)
    phase_slice("dsd100", dsd_state, dsd, device, audio,
                {"fused_decode": False, "wiener_istft": True})

    result = {"kernels": [
        {"name": "fused_decode", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/decoder_fused.cu",
         "replaces": "convsep_tpu/models/decoder_fused_pallas.py:194",
         "launches": hi_run["launches"]["fused_decode"], **dec},
        {"name": "wiener_istft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "launches": hi_run["launches"]["wiener_istft"], **wie},
    ]}
    print(json.dumps(result), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
