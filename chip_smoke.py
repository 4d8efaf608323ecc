#!/usr/bin/env python3
"""Smoke test of convsep_tpu_torch on one NVIDIA GPU (the quickest proof
that the port still starts and is right on the card).

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then non-zero and no
result line is printed):

1. device: the card's name and power limit (nvidia-smi); build every CUDA
   kernel from ``convsep_tpu_torch/csrc`` and print the build time;
2. fused decode kernel (forced) vs its plain PyTorch version at highres4096
   shapes (B 49, S 4, J 128, W 505, TpC 800, ktaps 8, TM 120), float32 and
   bf16 output, with its bound on the tensor cores (3xTF32) beside the
   float32-SIMT one, and the launcher's plan (cluster, active clusters); it
   fails if "auto" routes that TM and batch (``FUSED_DECODE_WON``) where the
   kernel is slower than the plain decode by more than the run-to-run
   spread (``DECODE_SPREAD``);
3. Wiener+iSTFT kernel vs its plain version at highres4096 (nfft 4096,
   hop 1024, nf 1442, bf16 y) and dsd100 (nfft 1024, hop 512, nf 2882):
   p = 1 and 2, conserve_last, float32 and int16 output; at both shapes its
   time, the plain version's, the bound, the wrapper's host time and the
   launch plan (``fft_plan.wiener_plan``); then the same at the stream
   path's batches (phase 17): 2 and 8 tracks a launch, each track its own
   random mixture and magnitudes;
4. the slice: ``Separator`` for highres4096 and dsd100 at full width with
   seeded random weights on a 30 s 44.1 kHz mixture: finite stems of the
   right shape, kernel launch counters above zero, the kernel route
   against the plain route in float32 (the model's output elementwise,
   the stems by SNR), conservation of the mixture, the bf16 tail's SNR
   against the f32 tail, ms per track and real-time factor;
5. the training kernels vs their plain versions at the dsd100 training
   step's shapes: the FFT STFT kernel on (32, 14 336) and (128, 14 336)
   signals (W 1024, hop 512) beside ``torch.stft(center=False)`` on the
   same padded signal, the dense DFT kernel (non-power-of-two sizes) at W
   768, hop 256, each with its device time from ``torch.profiler`` (in a
   child process: a profiler session slows its process's host for good)
   and its wrapper's host time per call; the fused adadelta kernel on
   leaves the size of ``fc_expand_kernel`` and ``fc_kernel``;
6. the training slice: 8 synthetic 4-stem tracks of 20 s written to a
   temporary directory, ``Trainer(dsd100, fft_impl="pallas",
   optimizer_impl="fused", from_audio=True).fit(max_steps=20)`` at full
   width, B 32, with seeded random weights: a finite, falling loss, 40 FFT
   STFT launches and no dense one, the adadelta kernel launched, one step
   of the kernel route against the plain route from the same parameters
   (gated from the seeded init; the fitted ones are measured too), zero
   accumulators and the same batch, at the preset's Wiener eps and at
   1e-2, beside two witnesses (the plain route on the factored STFT, and
   on ``torch.fft.rfft`` of the same frames) that show how far
   float32-correct routes part; ms per step and training real-time factor
   on both routes;
7. the iSTFT kernel vs its plain version at the stereo highres4096 shapes
   (8 signals, nf 1442, 2049 bins, through ``istft_ct_pallas``, float32
   and int16) and the dsd100 pallas-route shapes (4 signals, nf 2882, 513
   bins, through ``istft_pallas``), beside ``torch.istft``, with both
   device times (in a child) and the wrapper's host time;
8. the Wiener mask kernel vs its plain version (bit for bit) at the dsd100
   pallas-route shapes and highres4096's, bf16 y, p = 1 and 2;
9. the stereo slice: ``StereoSeparator(highres4096-stereo)`` at full width
   on a 30 s stereo mixture: the kernel route ("auto": fused decode at TM
   240 where it won, the iSTFT kernel) against the plain route, as phase 4
   gates the mono slice, ``complement_last``, ms per track, and the stems'
   copy to pageable and to pinned host memory; then the fused decode
   (forced) at TM 240 as phase 2;
10. the ``fft_impl="pallas"`` slice: ``Separator(dsd100, fft_impl="pallas")``
   at full width through the STFT (one FFT launch, no dense one), Wiener
   mask and iSTFT kernels, against the plain synthesis of its own y and the
   matmul route's stems, ms per track against the matmul route;
11. the multires4096 kernels vs their plain versions: the forward STFT
   kernel on one track (1, 1 474 560), 4096 pt, hop 1024, beside
   ``torch.stft``, with both device times (as phase 5) and the wrapper's
   host time; the Wiener+iSTFT kernel's Nyquist-row input against its
   plain version and, bit for bit, against the same kernel fed the
   concatenated spectrum; the band decode kernel at N 196, Tp 16, W 505,
   C2 50, T·I 1500 on the operand the model builds once (band and packed
   taps) beside a bf16 ``torch.matmul``, with the operations it runs (its
   plan) beside the band's, and its wrapper's host time; the fused decode
   at TM 360;
12. the multires4096 slice, ``Separator(multires4096)`` at full width on
   the phase 4 mixture, three routes: (a) "auto" (plain multires channels,
   the fused decode at TM 360, the Wiener+iSTFT kernel) against the plain
   route as phase 4; (b) ``analysis="ct_pallas"`` (the forward STFT kernel
   and the Nyquist-row Wiener+iSTFT kernel; one forward STFT launch, no
   dense one) against (a) in the f32 tail; (c)
   ``decoder_impl="band_pallas"`` (the band decode kernel) against its
   plain band decode in the same model and against (a)'s stems by SNR;
13. the bach10 score-informed slice: ``Separator(bach10)(audio, extra=)``
   at full width, the score channels from ``TransformFFT.compute_file`` and
   ``score_channels`` of fixed notes, at score_gate 0, 0.5 "mult" and 1.0
   "blend", each against the plain route as phase 4;
14. device times (``torch.profiler``, in a child) of the fused decode and
   its plain version at TM 120 and 360, and of the Wiener+iSTFT (both phase
   3 shapes), Wiener mask, band decode and fused adadelta kernels;
15. chunked: ``ChunkedSeparator`` (chunk_segments 32) for highres4096 (2
   chunks of 960 frames) and dsd100 (4 chunks) on the phase 4 mixture,
   against ``Separator`` as phase 4 holds two routes (the f32 tail's model
   output elementwise chunk by chunk and its stems by SNR, the bf16 tail by
   SNR), ``complement_last`` stems summing to the mixture, PCM16 in and out,
   the fused decode launched once a chunk where "auto" routes B 32 and no
   Wiener+iSTFT launch (a chunk synthesizes by products, as the reference
   does), ms per track (PCM16, plain and complement) beside the whole
   track's, and the upload and download bytes;
16. online: ``OnlineSeparator(chunk_segments=8)`` for dsd100 and
   highres4096, the mixture pushed in 16 384-sample blocks, then flushed:
   the stems equal ``ChunkedSeparator(chunk_segments=8)``'s bit for bit,
   and again after ``reset()``; the latency and ms per track;
17. stream: ``StreamSeparator`` (PCM16 in and out, plain and
   ``complement_last``) for dsd100 and highres4096 on 6 tracks (the PCM16
   mixture + i % 3), batch_size 2: each track against ``Separator``'s (its
   LSB difference printed; the f32 tail's model output elementwise and its
   stems by SNR, the bf16 tail by SNR), a batch of two clearly different
   tracks (the mixtures of seeds 0 and 1, the second reversed in time)
   against ``Separator`` per track, one Wiener+iSTFT launch a batch and
   the fused decode where "auto" routes B 98, ms per track, and a batch of
   8 tracks (its peak device memory, its stems against the batches of 2); then dsd100
   with ``fft_impl="pallas"`` (the STFT, Wiener mask and iSTFT kernels once
   a track, no dense DFT) and highres4096-stereo (the iSTFT kernel), each
   track against its whole-track separator;
18. the fused decode (forced) against plain at TM 120 with B 8, 32 and 98,
   the batches of the online, chunked and stream paths, as phase 2 (the
   routing check included);
19. service: ``WatchService(dsd100)`` on a temporary directory of 3 wav
   mixtures: a sweep writes every stem wav, equal to ``StreamSeparator``'s
   for the same tracks; a file that is still growing waits for the next
   sweep;
20. feature-file training: the phase 6 tracks through
   ``compute_features(dsd100)`` on the card (ms per track; one mixture
   file against the CPU route of the same ``TransformFFT``), a
   ``SegmentDataset`` (T 30, overlap 20; the native gather's host ms per
   batch against numpy's; it fails unless the native gather is in use),
   ``Trainer(dsd100, optimizer_impl="fused").fit(max_steps=20)`` at full
   width, B 32, seeded random weights: a finite, falling loss, two
   adadelta launches a step and no STFT; a run with a ``workdir`` stopped
   at step 10, restored bit for bit at (epoch 0, batch 10) and resumed on
   exactly the uninterrupted run's batches 10-19, its final weights
   against that run's; a full-state save and restore timed; one feature
   step of the fused route against the plain route from the seeded init
   (the fused update bit for bit on the same gradients); ms per step and
   rtf_train on both routes;
21. the CLI on the card, each verb a subprocess of ``python3 -m
   convsep_tpu_torch.cli --launches`` in a temporary directory (its wall
   time and launch counts logged): seeded reference pickles for
   highres4096 and dsd100 through ``convert``; ``separate --preset
   highres4096`` on the phase 4 mixture from the checkpoint and from the
   pickle, both bit for bit the PCM16 stems of an in-process
   ``Separator``, one fused decode and one Wiener+iSTFT launch each;
   ``evaluate --oracle`` on those stems against the mixture's true stems
   (finite, the oracle's SDR above the model's; the first 5 s on the card
   against ``--device cpu``, and in process within 1e-4 dB);
   ``compute-features`` and ``train --epochs 1 --optimizer-impl fused`` on
   the phase 20 tracks (two adadelta launches a step); ``bench --preset
   dsd100 --seconds 30 --runs 3`` (one JSON line, value > 0, mfu_bf16 in
   (0, 1], no section skipped, the pallas-impl section through the STFT,
   Wiener mask and iSTFT kernels); ``profile --preset highres4096`` (the
   fused decode kernel on top).

Each slice expects the fused decode launched exactly where "auto" routes it
(``models/decoder_fused_cuda.py::FUSED_DECODE_WON``: by TM and batch).

Every kernel's time comes with its bound (bytes over 3.35 TB/s or
operations over 67 TFLOP/s in float32, 989 TFLOP/s for the bf16 band
product, whichever is larger, from this run's shapes) and, where one
PyTorch call computes the same function, that call's time.
Then one JSON line with every kernel's numbers, the nvidia-smi line, and
the last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device and when run outside the repository checkout. TF32 is off for
every parity comparison (matmul and cuDNN).

    python3 chip_smoke.py --device-times stft|ct_stft|istft|decode|others[,...]

is the child that phases 5, 7, 11 and 14 start: it prints one JSON line of
device times, keyed by kind.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
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
TOL_STFT = 1e-5          # × max|X|: an FFT's f32 sums against cuBLAS's DFT sums, another order
TOL_ADADELTA = 1e-6      # × max|·| of p, accu, delta_accu (both round every operation alike)
TOL_SQ = 1e-6            # relative, Σg²: the kernel sums in double, the plain version in f32
TOL_ROUTE = 1e-5         # relative, the loss, kernel route vs plain route, one step, both eps
# The kernel route's one-step gaps where f32-correct routes part by more
# than 1e-5: fixed limits above the larger of what the two witnesses (the
# plain route on the factored STFT, and on torch.fft.rfft of the same
# frames) read at the same seeded init and batch, never set from the
# kernel's own reading (PERF.md; tools/torch_route_study.py gives the
# spread over seeds and batches). Readings on an H100: factored, rfft.
TOL_ROUTE_GN = 3e-5       # relative, grad_norm at wiener_eps 1e-2; witnesses 2.23e-5, 1.37e-5
TOL_ROUTE_GN_EPS = 1e-4   # relative, grad_norm at the preset's wiener_eps; 8.15e-5, 5.93e-5
TOL_ROUTE_WEIGHTS = 3e-5  # × max|g|, weights after one step, both eps; 2.57e-5, 2.57e-5
TOL_WIENER_APPLY = 0.0   # the kernel rounds every operation as the plain version, in its order
MIN_SNR_PALLAS_DB = 70.0  # f32-tail stems, pallas route vs matmul route (their STFTs differ)
TOL_BAND = 1e-5          # × max|out|: f32 sums of the same bf16 products in another order
# band_pallas y vs the f32 decode's: the reference's own bound for its
# bf16-operand band stage against the f32 "band" decode (tests/test_model.py)
TOL_BAND_BF16 = 2e-2     # × max|y|
TOL_BF16_COMPUTE = 3e-2  # × max|y|: compute_dtype bf16, kernel route (expansion unrounded)
#                          vs the plain bf16 decode; the bound tests/test_torch_model.py holds
# band_pallas stems vs the f32 bandconv route's: bf16 operands of an
# 800-deep sum move y by ~3e-3 × max|y| at multires4096, 38.7 dB apart on an
# H100 (PERF.md); y is held above, this catches only a gross break
MIN_SNR_BAND_DB = 30.0
TRAIN_STEPS = 20
TRAIN_TRACKS = 8
TRAIN_SECONDS = 20
# the iSTFT kernel's shapes on the two new paths: (path, nfft, hop, nf,
# signals, through istft_ct_pallas (else istft_pallas))
ISTFT_SHAPES = (("highres4096-stereo", 4096, 1024, 1442, 8, True),
                ("dsd100 pallas route", 1024, 512, 2882, 4, False))
# the Wiener mask kernel's (path, S, nf, bins)
WIENER_APPLY_SHAPES = (("dsd100 pallas route", 4, 2882, 513), ("highres4096", 4, 1442, 2049))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA's data sheet)
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 on the tensor cores, dense
TF32_FLOPS = 495e12        # H100 SXM TF32 on the tensor cores, dense
MR_SAMPLES = 1_474_560     # the phase 4 mixture bucketed at multires4096: 1442 frames
# the band decode at one multires4096 track: (N, Tp, W, C2, kh, I)
BAND_SHAPE = (196, 16, 505, 50, 15, 50)


CHUNK_SEGMENTS = 32       # ChunkedSeparator's default (the reference bench's chunked rows)
ONLINE_SEGMENTS = 8       # OnlineSeparator's default
ONLINE_BLOCK = 16384      # samples a push (the reference bench's capture blocks)
STREAM_TRACKS = 6         # the reference bench's streaming rows: the mixture + i % 3
STREAM_BATCH = 2
TOL_STREAM_LSB_SUM = 1    # LSB: complement_last stems add back to the PCM16 mixture (one rounding)
TOL_FEATURES = 1e-5       # × peak: a feature file vs the CPU route's DFT products, another sum order
TOL_FEATURE_LOSS = 1e-6   # relative, the loss of one feature step, fused vs plain route (one forward)
TOL_FEATURE_WEIGHTS = 1e-5  # × max|g|, weights after one feature step, fused vs plain route
CARD: str | None = None  # the nvidia-smi line, once phase 1 has read it


def log(msg: str) -> None:
    """Print a line; one that reports a time carries the card's name and
    power limit (nvidia-smi) beside it."""
    if CARD and re.search(r"\d ms\b|ms/track|us per call| us\b", msg):
        msg = f"{msg} | {CARD}"
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes (each input read once, each output written once) over the memory
    rate and the operations over the card's rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fft_flops(frames: int, nfft: int) -> float:
    """Operations of real FFTs, forward or inverse: 2.5 nfft log2(nfft) per
    frame (a complex FFT, 5 N log2 N, carries two real frames)."""
    import math

    return frames * 2.5 * nfft * math.log2(nfft)


def cuda_ms(fn, reps: int = 10, rounds: int = 5, warmup: int = 2) -> float:
    """Milliseconds of ``fn()`` on the card: CUDA events around ``reps``
    calls back to back, divided by ``reps``; the median of ``rounds``. A
    call whose host work outlasts its device work still reads its host
    time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call of ``fn``: the time to enqueue ``reps``
    calls back to back. The device keeps up with short kernels and the
    launch queue does not fill, so this is the wrapper's host work."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def profile_ms(fn, reps: int = 10, warmup: int = 3) -> dict:
    """Device time per call of ``fn`` under ``torch.profiler`` over ``reps``
    calls: every kernel's and copy's own device time summed, in all and by
    name. ``device_ms`` is None where the profiler saw no device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / reps
    return {"device_ms": sum(by_name.values()) if by_name else None, "by_kernel": by_name}


def ms_str(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def device_times(kind: str) -> dict:
    """:func:`child_device_times` in a child process, so that the profiler
    does not slow the host of the later phases that time it; ``kind`` may
    name several, comma-separated, measured in one child."""
    out = subprocess.run([sys.executable, str(HERE / "chip_smoke.py"), "--device-times", kind],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"device-time child ({kind}) failed:\n{out.stdout[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def stft_inputs(B: int, win: int, hop: int, device, gen):
    """A (B, 14 336) signal (one training segment each), its window and the
    padded signal ``torch.stft(center=False)`` takes for the same frames."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.stft import _pad_signal
    from convsep_tpu_torch.dsp.windows import sinebell

    w = sinebell(win)
    x = 0.3 * torch.randn(B, 14336, generator=gen, device=device)
    return x, w, _pad_signal(x, win, hop), torch.from_numpy(w.astype(np.float32)).to(device)


def child_device_times(kind: str) -> dict:
    """Device ms of phase 5's ("stft") or phase 11's ("ct_stft") kernels and
    of ``torch.stft`` on the same frames, at their shapes, by
    :func:`profile_ms`."""
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas
    from convsep_tpu_torch.dsp.stft import _pad_signal
    from convsep_tpu_torch.dsp.windows import sinebell

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)

    def pair(kernel, library) -> dict:
        k, lib = profile_ms(kernel), profile_ms(library)
        return {"device_ms": k["device_ms"], "kernels": k["by_kernel"],
                "library_device_ms": lib["device_ms"], "library_kernels": lib["by_kernel"]}

    if kind == "istft":
        return child_istft_times(device, gen, pair)
    if kind == "decode":
        return child_decode_times(device, pair)
    if kind == "others":
        return child_other_times(device, gen)
    if kind == "ct_stft":
        w = sinebell(4096)
        x = 0.3 * torch.randn(1, MR_SAMPLES, generator=gen, device=device)
        padded = _pad_signal(x, 4096, 1024)
        wt = torch.from_numpy(w.astype("float32")).to(device)
        return {"ct_stft": pair(lambda: stft_ct_pallas(x, w, 1024),
                                lambda: torch.stft(padded, 4096, 1024, window=wt, center=False,
                                                   return_complex=True))}
    res = {}
    for name, win, hop, batches in (("stft", 1024, 512, (32, 128)), ("stft_dft", 768, 256, (32,))):
        per_b = {}
        for B in batches:
            x, w, padded, wt = stft_inputs(B, win, hop, device, gen)
            per_b[B] = pair(lambda: stft_pallas(x, w, hop),
                            lambda: torch.stft(padded, win, hop, window=wt, center=False,
                                               return_complex=True))
        total = {k: sum(r[k] for r in per_b.values()) if all(r[k] is not None for r in
                                                              per_b.values()) else None
                 for k in ("device_ms", "library_device_ms")}
        res[name] = {**total, "by_batch": {str(b): r for b, r in per_b.items()}}
    return res


def decode_bounds(fc, ops) -> dict:
    """The decode's bounds: float32 parity on the tensor cores takes three
    TF32 products per product (3xTF32), 3 × operations / 495 TFLOP/s, less
    than the operations over 67 TFLOP/s on the CUDA cores; so the least time
    the card could take is the tensor-core one, and the row's bound. The
    float32-SIMT bound is kept beside it."""
    k4, b3, kcat = ops
    B, J = fc.shape
    _, S, W_pad, TpC = k4.shape
    _, ktaps, TM = kcat.shape
    nbytes = 4 * sum(t.numel() for t in (fc, *ops)) + 2 * B * S * W_pad * TM
    flops = 2.0 * B * S * W_pad * TpC * (J + ktaps * TM)
    simt = bound(nbytes, flops)
    return {**bound(nbytes, 3 * flops, TF32_FLOPS), "operations": flops,
            "f32_simt_bound_ms": simt["bound_ms"]}


def child_istft_times(device, gen, pair) -> dict:
    """Device ms of the iSTFT kernel at phase 7's shapes beside
    ``torch.istft`` on the same spectra."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_pallas
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas

    res = {}
    for name, nfft, hop, nf, N, ct in ISTFT_SHAPES:
        w, L, re, im = istft_inputs(nfft, hop, nf, N, device, gen)
        kern = istft_ct_pallas if ct else istft_pallas
        wt = torch.from_numpy(w.astype(np.float32)).to(device)
        spec = torch.complex(re, im).transpose(-1, -2)
        res[name] = pair(lambda: kern(re, im, w, hop, L),
                         lambda: torch.istft(spec, nfft, hop, window=wt, center=True, length=L))
    return res


def child_decode_times(device, pair) -> dict:
    """Device ms of the fused decode kernel (forced) and of its plain
    version at TM 120 (highres4096) and TM 360 (multires4096), B 49."""
    import torch
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.models import ConvSep
    from convsep_tpu_torch.models.decoder_fused_cuda import (
        band_freq_decode,
        band_freq_decode_plain,
    )

    res = {}
    for preset, seed in (("highres4096", 0), ("multires4096", 4)):
        cfg = get_preset(preset).model
        gen = torch.Generator(device=device).manual_seed(seed)
        model = ConvSep(cfg, init_params(cfg, gen, device), device=device).prepare_inference()
        fc = torch.relu(torch.randn(49, model.k4.shape[0], generator=gen, device=device))
        ops = (model.k4, model.b3, model.kcat)
        r = pair(lambda: band_freq_decode(fc, *ops, out_dtype=torch.bfloat16),
                 lambda: band_freq_decode_plain(fc, *ops, out_dtype=torch.bfloat16))
        res[f"TM {model.kcat.shape[2]}"] = {"device_ms": r["device_ms"], "kernels": r["kernels"],
                                            "plain_device_ms": r["library_device_ms"],
                                            "plain_kernels": r["library_kernels"]}
        del model, ops, fc
        torch.cuda.empty_cache()
    return res


def child_other_times(device, gen) -> dict:
    """Device ms of the kernels whose rows had none: the Wiener+iSTFT kernel
    (highres4096 and dsd100, phase 3's inputs), the Wiener mask kernel (the
    dsd100 pallas route's shape), the band decode kernel (phase 11's shape,
    the prepared operand) and the fused adadelta kernel (phase 5's two
    leaves)."""
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft
    from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_pallas
    from convsep_tpu_torch.models.decoder_band_cuda import band_decode_wmajor, band_operand
    from convsep_tpu_torch.train.fused_optim import fused_adadelta_leaf

    res = {}
    for key, nfft, hop, nf in (("wiener_istft", 4096, 1024, 1442),
                               ("wiener_istft dsd100", 1024, 512, 2882)):
        w, L, y, re, im = wiener_inputs(nfft, hop, nf, 4, device, gen)
        res[key] = profile_ms(lambda: wiener_istft(y, re, im, w, hop, L))["device_ms"]
        del y, re, im
    _, S, nf, bins = WIENER_APPLY_SHAPES[0]
    ya = torch.relu(torch.randn(S, nf, bins, generator=gen, device=device)).to(torch.bfloat16)
    ra = torch.randn(nf, bins, generator=gen, device=device)
    ia = torch.randn(nf, bins, generator=gen, device=device)
    res["wiener_apply"] = profile_ms(lambda: wiener_apply_pallas(ya, ra, ia))["device_ms"]
    N, Tp, W, C2, kh, I = BAND_SHAPE
    T = Tp + kh - 1
    z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=device)).to(torch.bfloat16)
    band = band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=device), T)
    res["band_decode"] = profile_ms(lambda: band_decode_wmajor(z, band, T))["device_ms"]
    del z, band
    total = 0.0
    for shape in ((128, 518400), (129600, 128)):
        p = 0.01 * torch.randn(shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(shape, generator=gen, device=device)
        a = 1e-6 * torch.rand(shape, generator=gen, device=device)
        d = 1e-6 * torch.rand(shape, generator=gen, device=device)
        total += profile_ms(lambda: fused_adadelta_leaf(p, g, a, d, 1.0, 0.95, 1e-6))["device_ms"]
    res["fused_adadelta"] = total
    return res


# The spread of the decode's kernel-over-plain time ratio between runs on
# the H100 (up to 3 % at one TM, by events): "auto" may route a TM where one
# run reads the kernel this much slower.
DECODE_SPREAD = 0.05


def phase_decode(model, B: int, device, gen) -> dict:
    """Fused decode kernel (forced) vs plain at the model's operand shapes."""
    import torch
    from convsep_tpu_torch.models.decoder_fused_cuda import (
        band_freq_decode,
        band_freq_decode_plain,
        card_plan,
        fused_decode_won,
    )

    J = model.k4.shape[0]
    fc = torch.relu(torch.randn(B, J, generator=gen, device=device))
    ops = (model.k4, model.b3, model.kcat)
    TM = model.kcat.shape[2]
    err = {}
    for dt in (torch.float32, torch.bfloat16):
        got = band_freq_decode(fc, *ops, out_dtype=dt).float()
        want = band_freq_decode_plain(fc, *ops, out_dtype=dt).float()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        tol = (TOL_DECODE_F32 if dt == torch.float32 else TOL_DECODE_BF16) * scale
        e = (got - want).abs().max().item()
        log(f"  decode TM {TM} {str(dt)[6:]}: shape {tuple(got.shape)} max_abs_err {e:.3e} "
            f"(tol {tol:.3e}, max|plain| {scale:.3e})")
        if not (e <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"fused decode TM {TM} {dt} disagrees: {e} > {tol}")
        err[dt] = e
    ms = cuda_ms(lambda: band_freq_decode(fc, *ops, out_dtype=torch.bfloat16))
    plain_ms = cuda_ms(lambda: band_freq_decode_plain(fc, *ops, out_dtype=torch.bfloat16))
    b = decode_bounds(fc, ops)
    plan = card_plan(B, J, *model.k4.shape[1:], *model.kcat.shape[1:])
    won = ms < plain_ms
    log(f"  decode TM {TM} bf16 out: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (B={B}; the "
        f"kernel {'wins' if won else 'loses'}); bound {b['bound_ms']:.3f} ms (3xTF32 on the "
        f"tensor cores, {b['bound_by']}), float32-SIMT bound {b['f32_simt_bound_ms']:.3f} ms; "
        f"no single PyTorch call computes it")
    log(f"  decode TM {TM} plan: {plan['mi']} x {plan['ni']} m16 x n8 tiles a warp, clusters of "
        f"{plan['cluster']} blocks, {plan['wb']} output rows a block, "
        f"{plan['active_clusters']} clusters at once, {plan['smem_bytes']} B shared memory")
    # "auto" takes the kernel only at the TMs and batches where it won
    # (models/convsep.py)
    routes = fused_decode_won(TM, B)
    log(f"  decode TM {TM} B {B}: \"auto\" routes {'the kernel' if routes else 'the plain decode'}")
    if routes and ms > (1 + DECODE_SPREAD) * plain_ms:
        raise AssertionError(f"FUSED_DECODE_WON routes TM {TM} B {B}, where the kernel loses: "
                             f"{ms:.3f} ms vs plain {plain_ms:.3f} ms")
    return {"max_abs_err": err[torch.float32], "max_abs_err_bf16": err[torch.bfloat16],
            "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None, "TM": TM, "B": B,
            "won": won, "auto_routes": routes, "plan": plan}


def phase_bf16_compute(state, preset, B: int, device, gen) -> dict:
    """compute_dtype="bfloat16" at B segments: "auto" routes as in float32
    (the fused kernel at highres4096 B 49, its bf16 operands passed as
    float32); the model's sources against the plain bf16 decode's
    (decoder_impl="bandconv") on the same random magnitudes."""
    import dataclasses

    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.models import ConvSep
    from convsep_tpu_torch.models.convsep import resolve_decoder_impl

    cfg = dataclasses.replace(preset.model, compute_dtype="bfloat16")
    route = resolve_decoder_impl(cfg, device, B)
    if route != resolve_decoder_impl(preset.model, device, B) or route != "bandconv_pallas":
        raise AssertionError(f"bf16 compute routes {route} at B {B}, float32 "
                             f"{resolve_decoder_impl(preset.model, device, B)}")
    model = ConvSep(cfg, state, device=device).prepare_inference()
    plain = ConvSep(dataclasses.replace(cfg, decoder_impl="bandconv"), state,
                    device=device).prepare_inference()
    x = torch.rand((B, cfg.time_context, cfg.feat_size, cfg.channels_in), generator=gen,
                   device=device)
    kernels.reset_launches()
    got = model.sources(x).float()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = plain.sources(x).float()
    scale = want.abs().max().item()
    e = (got - want).abs().max().item()
    ms = cuda_ms(lambda: model.sources(x))
    plain_ms = cuda_ms(lambda: plain.sources(x))
    log(f"  bf16 compute B {B}: route {route}, launches {launches['fused_decode']}; sources vs "
        f"the plain bf16 decode max_abs_err {e:.3e} (tol {TOL_BF16_COMPUTE * scale:.3e}); "
        f"forward {ms:.3f} ms, plain bf16 {plain_ms:.3f} ms")
    if launches["fused_decode"] != 1 or not (e <= TOL_BF16_COMPUTE * scale
                                             and torch.isfinite(got).all()):
        raise AssertionError(f"bf16 compute B {B}: launches {launches}, error {e} "
                             f"(tol {TOL_BF16_COMPUTE * scale})")
    return {"launches": launches, "max_abs_err": e, "max_abs_plain": scale, "ms": ms,
            "plain_ms": plain_ms, "B": B}


def wiener_inputs(nfft: int, hop: int, nf: int, S: int, device, gen, B: int = 1):
    """A batch of B tracks, each its own random mixture and magnitudes, so
    a kernel that reads another track's spectrum or y disagrees."""
    import torch
    from convsep_tpu_torch.dsp.dft import stft_matmul
    from convsep_tpu_torch.dsp.windows import sinebell

    L = (nf - 2) * hop
    w = sinebell(nfft)
    x = 0.3 * torch.randn(B, L, generator=gen, device=device)
    re, im = stft_matmul(x, w, hop)
    assert re.shape[-2] == nf, (re.shape, nf)
    y = torch.randn(B, S, nf, nfft // 2 + 1, generator=gen, device=device).abs()
    y[..., : nf // 3, :8] = 0.0  # dead bins: the eps shortfall paths
    return w, L, y.to(torch.bfloat16), re, im


def phase_wiener(name: str, nfft: int, hop: int, nf: int, S: int, device, gen,
                 B: int = 1) -> dict:
    """Wiener+iSTFT kernel vs plain: p ∈ {1, 2}, conserve_last, f32/int16,
    on B tracks at once (the stream path's batches)."""
    import torch
    from convsep_tpu_torch.dsp.cuda import fft_plan
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain

    w, L, y, re, im = wiener_inputs(nfft, hop, nf, S, device, gen, B)
    if B > 1:
        name = f"{name} B {B}"
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
    us = host_us(lambda: wiener_istft(y, re, im, w, hop, L))
    plan = fft_plan.wiener_plan(B, S, nf, nfft, hop)
    b = bound(2 * y.numel() + 8 * re.numel() + 4 * B * S * L,
              fft_flops(B * S * nf, nfft) + 4 * y.numel())
    log(f"  wiener {name} p=1 f32 out: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); no single PyTorch call computes it; "
        f"wrapper host {us:.1f} us per call; plan: {plan.groups} groups x {plan.rounds} rounds, "
        f"{plan.rows} hop rows, {plan.blocks} blocks ({plan.waves} wave(s)), "
        f"{plan.smem_bytes} B shared memory")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None,
            "host_us": us, "B": B, "plan": dataclasses.asdict(plan)}


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


def time_track(sep, audio, reps: int = 5, **kw) -> float:
    """Median host ms of a whole-track call ``sep(audio, **kw)`` (ends in
    the stems' host copy)."""
    import torch

    sep(audio, **kw)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sep(audio, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def phase_slice(name: str, state, preset, device, audio, expect: dict, extra=None) -> dict:
    """Separator at full width: counters, finiteness, kernel vs plain route,
    conservation, bf16 vs f32 tail, ms per track. ``extra``: the extra
    input channels every call takes (bach10's score channels)."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain
    from convsep_tpu_torch.dsp.dft import istft_matmul
    from convsep_tpu_torch.separate import Separator, bucket_length, source_magnitudes
    from convsep_tpu_torch.separate.pipeline import fit_extra, window_of

    sep = Separator(preset, state, device=device)
    sep(audio[: FS], extra=extra)  # first call: kernel build and cuBLAS warm-up
    kernels.reset_launches()
    stems = sep(audio, extra=extra)
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
    ms = time_track(sep, audio, extra=extra)
    plain = Separator(plain_route(preset), state, device=device)
    plain_ms = time_track(plain, audio, extra=extra)
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
    ex = None if extra is None else torch.from_numpy(
        fit_extra(extra, Lb, preset)).to(device)
    y_k, re, im, _ = source_magnitudes(k32.model, x, f32, ex)
    y_p = source_magnitudes(p32.model, x, plain_route(f32), ex)[0]
    scale = y_p.abs().max().item()
    ey = (y_k - y_p).abs().max().item()
    log(f"  {name} f32 tail: model y kernel route vs plain route max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}, max|y| {scale:.3e})")
    if not ey <= TOL_SLICE_Y * scale:
        raise AssertionError(f"{name}: model output of the kernel route disagrees: {ey}")
    w = window_of(preset)
    hop = preset.transform.hop_size
    stems32, plain32 = k32(audio, extra=extra), p32(audio, extra=extra)
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
    cons = Separator(preset, state, device=device, conserve_last=True)(audio, extra=extra)
    rt = istft_matmul(re, im, w, hop, Lb)[0, : len(audio)].cpu().numpy()
    ce = float(np.abs(cons.sum(0) - rt).max())
    log(f"  {name} conserve_last: |Σ stems − mixture| max {ce:.3e} (tol {TOL_CONSERVE})")
    if not ce <= TOL_CONSERVE:
        raise AssertionError(f"{name}: conserve_last stems do not add up: {ce}")
    return {"ms": ms, "plain_ms": plain_ms, "launches": launches}


def phase_stft(device, gen) -> tuple[dict, dict]:
    """The STFT kernels vs plain: the FFT kernel at the training step's
    shapes (mixtures B 32, stems B 128; 14 336 samples, W 1024, hop 512 → 30
    frames × 513 bins) and the dense DFT kernel at W 768, hop 256 (B 32, 58
    frames × 385 bins), each beside ``torch.stft(center=False)`` on the same
    padded signal (the same frames), with device and host times."""
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas, stft_pallas_plain

    out = {}
    for name, win, hop, batches in (("stft", 1024, 512, (32, 128)), ("stft_dft", 768, 256, (32,))):
        worst, ms, plain_ms, lib_ms, us, nbytes, flops = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
        for B in batches:
            x, w, padded, wt = stft_inputs(B, win, hop, device, gen)
            before = dict(kernels.LAUNCHES)
            re, im = stft_pallas(x, w, hop)
            re_p, im_p = stft_pallas_plain(x, w, hop)
            torch.cuda.synchronize()
            moved = {k: kernels.LAUNCHES[k] - before[k] for k in ("stft", "stft_dft")}
            if moved != {"stft": int(name == "stft"), "stft_dft": int(name == "stft_dft")}:
                raise AssertionError(f"{name} B {B}: launched {moved}")
            peak = max(re_p.abs().max().item(), im_p.abs().max().item())
            e = max((re - re_p).abs().max().item(), (im - im_p).abs().max().item())

            def library():
                return torch.stft(padded, win, hop, window=wt, center=False, return_complex=True)

            lib = library().transpose(-1, -2)  # (B, nf, bins)
            e_lib = max((lib.real - re_p).abs().max().item(), (lib.imag - im_p).abs().max().item())
            log(f"  {name} B {B}: re/im {tuple(re.shape)} max_abs_err {e:.3e} "
                f"(tol {TOL_STFT * peak:.3e}, max|X| {peak:.3e}); torch.stft {e_lib:.3e} from "
                f"the plain version")
            if not (e <= TOL_STFT * peak and torch.isfinite(re).all() and torch.isfinite(im).all()):
                raise AssertionError(f"{name} kernel B {B} disagrees: {e} > {TOL_STFT * peak}")
            worst = max(worst, e)
            t = cuda_ms(lambda: stft_pallas(x, w, hop))
            tp = cuda_ms(lambda: stft_pallas_plain(x, w, hop))
            tl = cuda_ms(library)
            h = host_us(lambda: stft_pallas(x, w, hop))
            log(f"  {name} B {B}: kernel {t:.4f} ms, plain {tp:.4f} ms, torch.stft {tl:.4f} ms; "
                f"wrapper host {h:.1f} us per call")
            ms, plain_ms, lib_ms, us = ms + t, plain_ms + tp, lib_ms + tl, us + h
            nf = re.shape[-2]
            nbytes += 4 * x.numel() + 8 * re.numel()
            flops += fft_flops(B * nf, win)  # what the transform needs, whatever the kernel runs
        b = bound(nbytes, flops)
        out[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b,
                     "library_ms": lib_ms, "host_us": us}
    dev = device_times("stft")["stft"]
    for name, what in (("stft", "per training step (B 32 + B 128)"), ("stft_dft", "B 32")):
        r, d = out[name], dev[name]
        r.update(device_ms=d["device_ms"], library_device_ms=d["library_device_ms"])
        log(f"  {name} {what}: kernel {r['ms']:.4f} ms (device {ms_str(d['device_ms'])}), plain "
            f"{r['plain_ms']:.4f} ms, torch.stft {r['library_ms']:.4f} ms (device "
            f"{ms_str(d['library_device_ms'])}); bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); wrapper host {r['host_us']:.1f} us")
    log(f"  device kernels: {json.dumps(dev)}")
    return out["stft"], out["stft_dft"]


def phase_adadelta(device, gen) -> dict:
    """Fused adadelta kernel vs plain on leaves the size of dsd100's
    fc_expand_kernel (128, 518 400) and fc_kernel (129 600, 128), fed copies
    of the same p, g, accu, delta_accu (nonzero state)."""
    import torch
    from convsep_tpu_torch.train.fused_optim import fused_adadelta_leaf, fused_adadelta_plain

    hyper = (1.0, 0.95, 1e-6)
    worst, ms, plain_ms, exact, lib_ms, n = 0.0, 0.0, 0.0, True, 0.0, 0
    for shape in ((128, 518400), (129600, 128)):
        p = 0.01 * torch.randn(shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(shape, generator=gen, device=device)
        a = 1e-6 * torch.rand(shape, generator=gen, device=device)
        d = 1e-6 * torch.rand(shape, generator=gen, device=device)
        k_t = [t.clone() for t in (p, a, d)]
        p_t = [t.clone() for t in (p, a, d)]
        sq = fused_adadelta_leaf(k_t[0], g, k_t[1], k_t[2], *hyper)
        sq_p = fused_adadelta_plain(p_t[0], g, p_t[1], p_t[2], *hyper)
        torch.cuda.synchronize()
        for name, got, want in zip(("p", "accu", "delta_accu"), k_t, p_t):
            e = (got - want).abs().max().item()
            tol = TOL_ADADELTA * want.abs().max().item()
            same = bool(torch.equal(got, want))
            exact = exact and same
            log(f"  adadelta {shape} {name}: max_abs_err {e:.3e} (tol {tol:.3e})"
                f"{', bit-exact' if same else ''}")
            if not e <= tol:
                raise AssertionError(f"fused adadelta {shape} {name} disagrees: {e} > {tol}")
            worst = max(worst, e)
        rel = abs(sq.item() - sq_p.item()) / sq_p.item()
        log(f"  adadelta {shape} Σg²: kernel {sq.item():.9e} plain {sq_p.item():.9e} "
            f"rel {rel:.3e} (tol {TOL_SQ})")
        if not rel <= TOL_SQ:
            raise AssertionError(f"fused adadelta {shape} Σg² disagrees: {rel}")
        t = cuda_ms(lambda: fused_adadelta_leaf(k_t[0], g, k_t[1], k_t[2], *hyper))
        tp = cuda_ms(lambda: fused_adadelta_plain(p_t[0], g, p_t[1], p_t[2], *hyper))
        # the library's Adadelta computes the same (Lasagne) update
        leaf = p.clone().requires_grad_()
        leaf.grad = g
        opt = torch.optim.Adadelta([leaf], lr=hyper[0], rho=hyper[1], eps=hyper[2],
                                   foreach=True)
        tl = cuda_ms(opt.step)
        log(f"  adadelta {shape}: kernel {t:.3f} ms, plain {tp:.3f} ms, "
            f"torch.optim.Adadelta(foreach=True).step {tl:.3f} ms")
        ms, plain_ms, lib_ms, n = ms + t, plain_ms + tp, lib_ms + tl, n + p.numel()
        del p, g, a, d, k_t, p_t, leaf, opt
    # 16 bytes read (p, g, accu, delta_accu) and 12 written per element;
    # about 18 operations each (both running sums, two square roots, the
    # update, Σg²)
    b = bound(28.0 * n, 18.0 * n)
    log(f"  adadelta, both leaves: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
        f"{lib_ms:.3f} ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']}); bit-exact: {exact}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms}


def train_preset(kernels_on: bool):
    """dsd100 on the kernel route (fft_impl "pallas", optimizer_impl
    "fused") or the plain route ("matmul", "xla"); logs every step."""
    from convsep_tpu_torch.configs import get_preset

    p = get_preset("dsd100")
    return dataclasses.replace(
        p,
        transform=dataclasses.replace(p.transform,
                                      fft_impl="pallas" if kernels_on else "matmul"),
        train=dataclasses.replace(p.train, optimizer_impl="fused" if kernels_on else "xla",
                                  log_every_steps=1),
    )


def time_steps(step, state, mix, stems, reps: int = 10) -> float:
    """Median host ms of one train step (ends in a device synchronize)."""
    import torch

    for _ in range(2):
        state, _ = step(state, mix, stems)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, mix, stems)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def write_tracks(root: str, sources, tracks: int = TRAIN_TRACKS,
                 seconds: int = TRAIN_SECONDS) -> None:
    """``tracks`` synthetic tracks of ``seconds`` at 44.1 kHz, one wav per
    stem (the port's ``sine_mixture``, seeded by the track's index), in
    the dataset layout ``root/track<i>/<source>.wav``."""
    from convsep_tpu_torch.data.io import write_wav
    from convsep_tpu_torch.data.synth import sine_mixture

    for i in range(tracks):
        stems, _ = sine_mixture(len(sources), seconds * FS, fs=FS, seed=i)
        os.makedirs(os.path.join(root, f"track{i}"))
        for s, name in enumerate(sources):
            write_wav(os.path.join(root, f"track{i}", f"{name}.wav"), FS, stems[s])


def rfft_stft(signal, window, hop: int, nfft: int | None = None):
    """``stft_matmul``'s function by ``torch.fft.rfft`` (cuFFT) of the same
    zero-padded, windowed frames: an FFT-ordered, float32-correct STFT, used
    here and in ``tools/torch_route_study.py`` only, never by the port."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.stft import _pad_signal, frame_signal, num_frames

    window = np.asarray(window, np.float64)
    win, hop = len(window), int(hop)
    x = signal.float()
    frames = frame_signal(_pad_signal(x, win, hop), win, hop, num_frames(x.shape[-1], hop))
    spec = torch.fft.rfft(frames * torch.from_numpy(window.astype(np.float32)).to(x.device),
                          n=int(nfft or win))
    return spec.real.contiguous(), spec.imag.contiguous()


def witness_stfts() -> dict:
    """The witnesses' STFTs, each a second float32-correct plain route:
    "witness", ``stft_matmul``'s factored algorithm in place of the direct
    one that the plain route runs at nfft 1024, and "rfft", an FFT's sum
    order (:func:`rfft_stft`), the class of the kernel's."""
    import functools

    from convsep_tpu_torch.dsp.dft import stft_matmul

    return {"witness": functools.partial(stft_matmul, algorithm="factored"), "rfft": rfft_stft}


def on_stft(loss_fn, stft):
    """``loss_fn`` with the plain route's STFT replaced by ``stft``."""
    from unittest import mock

    from convsep_tpu_torch.train import e2e

    def loss(*args):
        with mock.patch.object(e2e, "stft_matmul", stft):
            return loss_fn(*args)

    return loss


def route_step(preset, params, mix, stems, device, stft=None) -> dict:
    """One train step of ``preset``'s route from ``params`` with zero
    accumulators: loss, grad_norm, gradients and the parameters after the
    update; ``stft`` replaces the plain route's STFT. On the fused route the
    plain optimizer is also applied to the same gradients (``exact``: the
    fused step equals it bit for bit)."""
    import torch
    from convsep_tpu_torch.train.e2e import make_audio_loss_fn
    from convsep_tpu_torch.train.loop import _apply_from_opt, _preset_apply_fn, create_train_state

    s, opt = create_train_state(preset, 0, device, params=params)
    loss_fn = make_audio_loss_fn(preset)
    if stft is not None:
        loss_fn = on_stft(loss_fn, stft)
    loss = loss_fn(s.params, mix, stems)
    g = dict(zip(s.params, torch.autograd.grad(loss, list(s.params.values()))))
    out = {"loss": loss.item(), "grads": g}
    fused = _preset_apply_fn(preset)
    if fused is not None:
        ref, _ = create_train_state(preset, 0, device, params=s.params)
        _apply_from_opt(opt)(ref.params, g, ref.opt_state)
    _, _, gn = (fused or _apply_from_opt(opt))(s.params, g, s.opt_state)
    out.update(grad_norm=gn.item(), params=s.params)
    if fused is not None:
        out["exact"] = all(torch.equal(s.params[k], ref.params[k]) for k in s.params)
    return out


def route_check(params, mix, stems, wiener_eps: float, device) -> dict:
    """One step of the kernel route, the plain route and the two witnesses
    (:func:`witness_stfts`) from the same parameters, zero accumulators and
    the same batch, at ``wiener_eps``. Returns each of the kernel route's
    and the witnesses' gaps to the plain route: loss and grad_norm
    (relative), gradients and weights after the step (absolute, in units of
    max|g|), the mixture's spectrum (in units of its peak); and whether the
    fused step is bit-exact."""
    import torch
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas
    from convsep_tpu_torch.dsp.dft import stft_matmul
    from convsep_tpu_torch.dsp.windows import sinebell

    def at_eps(p):
        return dataclasses.replace(p, sep=dataclasses.replace(p.sep, wiener_eps=wiener_eps))

    kern, plain = at_eps(train_preset(True)), at_eps(train_preset(False))
    t = plain.transform
    w = sinebell(t.frame_size)
    witnesses = witness_stfts()
    spec = {"plain": stft_matmul(mix, w, t.hop_size, algorithm="direct"),
            "kernel": stft_pallas(mix, w, t.hop_size),
            **{k: f(mix, w, t.hop_size) for k, f in witnesses.items()}}
    runs = {"plain": route_step(plain, params, mix, stems, device),
            "kernel": route_step(kern, params, mix, stems, device),
            **{k: route_step(plain, params, mix, stems, device, stft=f)
               for k, f in witnesses.items()}}
    torch.cuda.synchronize()
    ref = runs["plain"]
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    peak = max(x.abs().max().item() for x in spec["plain"])
    r = {"exact": runs["kernel"]["exact"]}
    for name in ("kernel", *witnesses):
        run = runs[name]
        r[name] = {
            "loss": abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm": abs(run["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            "grads": max((run["grads"][k] - g).abs().max().item()
                         for k, g in ref["grads"].items()) / gmax,
            "weights": max((run["params"][k] - p).abs().max().item()
                           for k, p in ref["params"].items()) / gmax,
            "stft": max((a - b).abs().max().item()
                        for a, b in zip(spec[name], spec["plain"])) / peak,
        }
        log(f"    wiener_eps {wiener_eps:g}, {name} vs plain: " + ", ".join(
            f"{k} {v:.3e}" for k, v in r[name].items()))
    log(f"    loss {ref['loss']:.9e}, grad_norm {ref['grad_norm']:.9e}, max|g| {gmax:.3e} "
        f"(plain route); fused step = plain optimizer on the same gradients bit for bit: "
        f"{r['exact']}")
    return r


def phase_train(device) -> dict:
    """Trainer.fit at full dsd100 width on synthetic stems, then the route
    check and step times."""
    import tempfile

    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples
    from convsep_tpu_torch.data.pipeline import to_device
    from convsep_tpu_torch.train.e2e import make_audio_train_step
    from convsep_tpu_torch.train.loop import Trainer, create_train_state

    preset, plain = train_preset(True), train_preset(False)
    seg = segment_samples(preset)
    with tempfile.TemporaryDirectory() as root:
        write_tracks(root, preset.sources)
        ds = AudioSegmentDataset(root, preset.sources, seg, fs=FS)
        metrics = os.path.join(root, "metrics.jsonl")
        log(f"  dataset: {len(ds)} segments of {seg} samples from {TRAIN_TRACKS} tracks")
        trainer = Trainer(preset, from_audio=True, device=device, seed=0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer.fit(ds, max_steps=TRAIN_STEPS, metrics_path=metrics)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(metrics) as f:
            recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in steps]
    log(f"  fit: {trainer.state.step} steps in {fit_s:.2f} s, launches {launches}")
    log(f"  losses by logged step: {[round(v, 6) for v in losses]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  mean loss, first 5 logged steps {first:.6f}, last 5 {last:.6f}")
    if trainer.state.step != TRAIN_STEPS or len(losses) < 10:
        raise AssertionError(f"fit took {trainer.state.step} steps, logged {len(losses)}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"training loss is not finite and falling: {losses}")
    # two STFTs a step (the mixtures, the stems), all on the FFT kernel
    if not (launches["stft"] == 2 * TRAIN_STEPS and launches["stft_dft"] == 0
            and launches["fused_adadelta"] > 0):
        raise AssertionError(f"training path missed a kernel: {launches}")
    fit_ms = float(np.median([r["step_time_ms"] for r in steps[1:]]))
    fit_rtf = float(np.median([r["rtf_train"] for r in steps[1:]]))
    log(f"  fit: median step_time_ms {fit_ms:.3f}, rtf_train {fit_rtf:.1f} (the Trainer's log)")
    mix, stems = to_device(next(ds.batches(preset.train.batch_size, shuffle=True, seed=123)),
                           device)
    fitted = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    del trainer, ds
    torch.cuda.empty_cache()

    # The two routes' STFTs differ by f32 rounding (~2e-6 of the peak), as
    # the plain route's direct STFT and the witnesses' (factored, rfft) do.
    # At the preset's wiener_eps (1e-8) the Wiener ratio's derivative is
    # ~1/eps wherever every source's output is near 0, and ReLU units near 0
    # flip, so one step's gradients part chaotically; a small gradient's
    # difference passes into its weight unchanged (Adadelta's slope is 1
    # from zero accumulators). The kernel route is held to 1e-5 where
    # f32-correct routes meet it (the loss), and elsewhere to fixed limits
    # above the larger witness's reading at this case (TOL_ROUTE_GN,
    # TOL_ROUTE_GN_EPS, TOL_ROUTE_WEIGHTS; PERF.md), never to the kernel's
    # own: even at wiener_eps 1e-2, where the ratio is well conditioned,
    # the witnesses' grad_norm parts from the plain route's by 1.4e-5 and
    # 2.2e-5. From the seeded init every input is fixed, so these numbers
    # repeat run to run; the fitted weights differ run to run (the backward
    # is not bitwise deterministic), so that check is printed and gated
    # only on the fused step's bit-exactness.
    init = create_train_state(preset, 0, device)[0].params
    log(f"  route check from the seeded random init (gated: loss {TOL_ROUTE} relative, "
        f"grad_norm {TOL_ROUTE_GN} relative at wiener_eps 1e-2 and {TOL_ROUTE_GN_EPS} at the "
        f"preset's, weights {TOL_ROUTE_WEIGHTS} × max|g|, the fused step bit-exact):")
    route = {}
    for weps in (preset.sep.wiener_eps, 1e-2):
        r = route_check(init, mix, stems, weps, device)
        k = r["kernel"]
        gn_tol = TOL_ROUTE_GN if weps == 1e-2 else TOL_ROUTE_GN_EPS
        larger = {g: max(r["witness"][g], r["rfft"][g]) for g in ("grad_norm", "weights")}
        log(f"    wiener_eps {weps:g}: the larger witness reads grad_norm "
            f"{larger['grad_norm']:.3e} (limit {gn_tol}), weights {larger['weights']:.3e} "
            f"(limit {TOL_ROUTE_WEIGHTS})")
        route[f"{weps:g}"] = {"kernel": k, "witness": r["witness"], "rfft": r["rfft"]}
        if not (k["loss"] <= TOL_ROUTE and k["grad_norm"] <= gn_tol
                and k["weights"] <= TOL_ROUTE_WEIGHTS and r["exact"]):
            raise AssertionError(f"the kernel route's train step disagrees with the plain "
                                 f"route at wiener_eps {weps}: {r}")
    del init
    log("  route check from the fitted parameters (gated on the fused step's bit-exactness):")
    for weps in (preset.sep.wiener_eps, 1e-2):
        if not route_check(fitted, mix, stems, weps, device)["exact"]:
            raise AssertionError("the fused step from the fitted weights is not bit-exact")
    del fitted
    torch.cuda.empty_cache()
    audio_s = preset.train.batch_size * seg / FS
    s_k, opt = create_train_state(preset, 0, device)
    s_p, _ = create_train_state(plain, 0, device)
    ms = time_steps(make_audio_train_step(preset, opt), s_k, mix, stems)
    plain_ms = time_steps(make_audio_train_step(plain, opt), s_p, mix, stems)
    log(f"  train step B {preset.train.batch_size}: kernel route {ms:.3f} ms "
        f"(rtf_train {audio_s * 1e3 / ms:.1f}), plain route {plain_ms:.3f} ms "
        f"(rtf_train {audio_s * 1e3 / plain_ms:.1f})")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms, "route": route}


def istft_inputs(nfft: int, hop: int, nf: int, N: int, device, gen):
    """Masked STFT halves (N, nf, nfft/2 + 1) of random signals."""
    import torch
    from convsep_tpu_torch.dsp.dft import stft_matmul
    from convsep_tpu_torch.dsp.windows import sinebell

    L = (nf - 2) * hop
    w = sinebell(nfft)
    re, im = stft_matmul(0.3 * torch.randn(N, L, generator=gen, device=device), w, hop)
    assert re.shape[-2] == nf, (re.shape, nf)
    mask = torch.rand(re.shape, generator=gen, device=device)
    return w, L, re * mask, im * mask


def phase_istft(device, gen) -> dict:
    """iSTFT kernel vs plain at path A's shapes (``istft_ct_pallas``, f32 and
    int16) and path B's (``istft_pallas``), beside ``torch.istft``."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_pallas, istft_ct_pallas_plain
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas, istft_pallas_plain

    res = {}
    for name, nfft, hop, nf, N, ct in ISTFT_SHAPES:
        kern, plain = ((istft_ct_pallas, istft_ct_pallas_plain) if ct
                       else (istft_pallas, istft_pallas_plain))
        outs = ("float32", "int16") if ct else ("float32",)
        w, L, re, im = istft_inputs(nfft, hop, nf, N, device, gen)
        err = {}
        for out in outs:
            kw = {"output_dtype": out} if out == "int16" else {}
            got = kern(re, im, w, hop, L, **kw)
            want = plain(re, im, w, hop, L, **kw)
            torch.cuda.synchronize()
            if got.shape != (N, L) or got.dtype != want.dtype or not torch.isfinite(got.float()).all():
                raise AssertionError(f"istft {name} {out}: bad output {tuple(got.shape)} {got.dtype}")
            e = (got.float() - want.float()).abs().max().item()
            tol = TOL_WIENER_I16 if out == "int16" else TOL_WIENER_F32
            log(f"  istft {name} {out}: (N {N}, nf {nf}, bins {nfft // 2 + 1}) max_abs_err "
                f"{e:.3e}{'LSB' if out == 'int16' else ''} (tol {tol})")
            if not e <= tol:
                raise AssertionError(f"istft kernel {name} {out} disagrees: {e} > {tol}")
            err[out] = e
        want = plain(re, im, w, hop, L)
        wt = torch.from_numpy(w.astype(np.float32)).to(device)
        spec = torch.complex(re, im).transpose(-1, -2)  # torch.istft's (..., bins, frames)

        def library():
            return torch.istft(spec, nfft, hop, window=wt, center=True, length=L)

        e_lib = (library() - want).abs().max().item()
        ms = cuda_ms(lambda: kern(re, im, w, hop, L))
        plain_ms = cuda_ms(lambda: plain(re, im, w, hop, L))
        lib_ms = cuda_ms(library)
        us = host_us(lambda: kern(re, im, w, hop, L))
        b = bound(8 * re.numel() + 4 * N * L, fft_flops(N * nf, nfft))
        log(f"  istft {name} f32 out: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, torch.istft "
            f"{lib_ms:.4f} ms (cuFFT; same framing and window-square normalization, its output "
            f"{e_lib:.3e} from the plain version's); bound {b['bound_ms']:.4f} ms ({b['bound_by']});"
            f" wrapper host {us:.1f} us per call")
        res[name] = {"max_abs_err": err["float32"], "max_abs_err_int16": err.get("int16"),
                     "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms, "host_us": us}
        del re, im, spec, want
        torch.cuda.empty_cache()
    dev = device_times("istft")["istft"]
    for name, r in res.items():
        d = dev[name]
        r.update(device_ms=d["device_ms"], library_device_ms=d["library_device_ms"])
        log(f"  istft {name}: device {ms_str(d['device_ms'])} (torch.istft device "
            f"{ms_str(d['library_device_ms'])}); bound {r['bound_ms']:.4f} ms")
    log(f"  device kernels: {json.dumps(dev)}")
    return res


def phase_wiener_apply(device, gen) -> dict:
    """Wiener mask kernel vs plain, bf16 y, p = 1 and 2: bit for bit."""
    import torch
    from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_pallas, wiener_apply_plain

    res = {}
    for name, S, nf, bins in WIENER_APPLY_SHAPES:
        y = torch.relu(torch.randn(S, nf, bins, generator=gen, device=device))
        y[:, : nf // 3, :8] = 0.0  # dead bins: the eps paths
        y = y.to(torch.bfloat16)
        re = torch.randn(nf, bins, generator=gen, device=device)
        im = torch.randn(nf, bins, generator=gen, device=device)
        worst = 0.0
        for p in (1.0, 2.0):
            got = wiener_apply_pallas(y, re, im, p=p)
            want = wiener_apply_plain(y, re, im, p=p)
            torch.cuda.synchronize()
            e = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
            same = all(torch.equal(g, w_) for g, w_ in zip(got, want))
            log(f"  wiener_apply {name} (S {S}, nf {nf}, bins {bins}) p={p:g}: max_abs_err "
                f"{e:.3e}, bit-exact {same} (tol {TOL_WIENER_APPLY})")
            if not e <= TOL_WIENER_APPLY:
                raise AssertionError(f"wiener_apply {name} p={p} disagrees: {e}")
            worst = max(worst, e)
        ms = cuda_ms(lambda: wiener_apply_pallas(y, re, im))
        plain_ms = cuda_ms(lambda: wiener_apply_plain(y, re, im))
        n = re.numel()
        b = bound(2 * S * n + 8 * n + 8 * S * n, 5.0 * S * n)
        log(f"  wiener_apply {name} p=1: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); no single PyTorch call computes it")
        res[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None}
        del y, re, im
    return res


def d2h_ms(t, reps: int = 5) -> tuple[float, float]:
    """Median host ms of copying ``t`` to pageable memory (``.cpu()``) and
    to pinned memory (``utils.transfer.fetch``), in turns."""
    import torch
    from convsep_tpu_torch.utils.transfer import fetch

    times = {"pageable": [], "pinned": []}
    for _ in range(reps + 1):
        for name, fn in (("pageable", lambda: t.cpu().numpy()), ("pinned", lambda: fetch(t))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v[1:])[reps // 2] for k, v in times.items()}
    return med["pageable"], med["pinned"]


def stereo_mixture(seed: int = 0):
    """The 30 s mixture panned slowly between the two channels."""
    import numpy as np

    mono = mixture(seed)
    pan = 0.5 + 0.4 * np.sin(2 * np.pi * 0.1 * np.arange(len(mono)) / FS)
    return np.stack([pan * mono, (1.0 - pan) * mono]).astype(np.float32)


def on_factored_istft(sep):
    """``sep`` (a StereoSeparator) with its iSTFT forced onto the plain
    factored chain: the stereo entry reads no preset field for it and runs
    ``istft_matmul``'s "auto", as the reference does."""
    import functools
    from unittest import mock

    from convsep_tpu_torch.separate import stereo

    factored = functools.partial(stereo.istft_matmul, algorithm="factored")

    def call(audio):
        with mock.patch.object(stereo, "istft_matmul", factored):
            return sep(audio)

    return call


def phase_stereo(state, preset, device, audio) -> dict:
    """StereoSeparator at full width: counters, finiteness, kernel vs plain
    route (as phase 4), complement_last, ms per track, the D2H copy."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.dft import istft_matmul
    from convsep_tpu_torch.models.masks import wiener_mask
    from convsep_tpu_torch.separate import StereoSeparator, bucket_length, stereo_source_magnitudes
    from convsep_tpu_torch.separate.pipeline import window_of

    name = preset.name
    L = audio.shape[1]
    sep = StereoSeparator(preset, state, device=device)
    sep(audio[:, :FS])  # first call: cuBLAS warm-up
    kernels.reset_launches()
    stems = sep(audio)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  {name}: stems {stems.shape} {stems.dtype}, launches {launches}")
    S = preset.model.num_sources
    if stems.shape != (S, L, 2) or not np.isfinite(stems).all():
        raise AssertionError(f"{name}: bad stems {stems.shape}, finite={np.isfinite(stems).all()}")
    if not (launches["istft"] > 0
            and (launches["fused_decode"] > 0) == auto_fused(preset, track_segments(preset, L))):
        raise AssertionError(f"{name}: the stereo path missed a kernel: {launches}")
    ms = time_track(sep, audio)
    p_sep = StereoSeparator(plain_route(preset), state, device=device)
    plain_ms = time_track(on_factored_istft(p_sep), audio)
    del p_sep
    log(f"  {name}: {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time); plain route "
        f"{plain_ms:.2f} ms/track ({SECONDS * 1e3 / plain_ms:.1f}x)")
    # the f32 tail, as phase 4: y elementwise, the kernel route's stems
    # against the plain synthesis of its own y, the two routes' stems by SNR
    f32 = dataclasses.replace(preset, model=dataclasses.replace(preset.model, mask_dtype="float32"))
    k32 = StereoSeparator(f32, state, device=device)
    p32 = StereoSeparator(plain_route(f32), state, device=device)
    Lb = bucket_length(L, preset)
    x = torch.from_numpy(np.pad(audio, ((0, 0), (0, Lb - L)))).to(device)
    y_k, re, im = stereo_source_magnitudes(k32.model, x, f32)
    y_p = stereo_source_magnitudes(p32.model, x, plain_route(f32))[0]
    scale = y_p.abs().max().item()
    ey = (y_k - y_p).abs().max().item()
    log(f"  {name} f32 tail: model y kernel route vs plain route max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}, max|y| {scale:.3e})")
    if not ey <= TOL_SLICE_Y * scale:
        raise AssertionError(f"{name}: model output of the kernel route disagrees: {ey}")
    w, hop = window_of(preset), preset.transform.hop_size
    stems32, plain32 = k32(audio), on_factored_istft(p32)(audio)
    del k32, p32
    mask = wiener_mask(y_k, p=preset.sep.wiener_p, eps=preset.sep.wiener_eps, axis=0)
    synth = istft_matmul(mask * re, mask * im, w, hop, Lb, algorithm="factored")
    synth = synth[:, :, :L].transpose(1, 2).cpu().numpy()
    del mask
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
    # complement_last: conservative masks, the last stem derived on the host
    comp = StereoSeparator(preset, state, device=device, complement_last=True)(audio)
    rt = istft_matmul(re, im, w, hop, Lb, algorithm="factored")[:, :L].T.cpu().numpy()
    ce = float(np.abs(comp.sum(0) - rt).max())
    log(f"  {name} complement_last: |Σ stems − round-tripped mixture| max {ce:.3e} "
        f"(tol {TOL_CONSERVE})")
    if not ce <= TOL_CONSERVE:
        raise AssertionError(f"{name}: complement_last stems do not add up: {ce}")
    out = torch.empty((S, 2, Lb), device=device)
    pageable, pinned = d2h_ms(out)
    log(f"  {name} stems D2H ({out.numel() * 4 / 1e6:.1f} MB f32): pageable {pageable:.3f} ms, "
        f"pinned {pinned:.3f} ms")
    del sep, re, im, y_k, y_p, x, out
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "launches": launches,
            "d2h_pageable_ms": pageable, "d2h_pinned_ms": pinned}


def phase_pallas_route(state, preset, device, audio) -> dict:
    """Separator(fft_impl="pallas") at full width: counters, finiteness, the
    stems against the plain synthesis of the route's own y, against the
    matmul route's stems by SNR, the bf16 tail, ms per track."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain
    from convsep_tpu_torch.dsp.cuda.wiener_kernel import wiener_apply_plain
    from convsep_tpu_torch.separate import Separator, bucket_length, source_magnitudes
    from convsep_tpu_torch.separate.pipeline import window_of

    def pallas(p):
        return dataclasses.replace(p, transform=dataclasses.replace(p.transform, fft_impl="pallas"))

    name = f"{preset.name} fft_impl=pallas"
    sep = Separator(pallas(preset), state, device=device)
    sep(audio[:FS])
    kernels.reset_launches()
    stems = sep(audio)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  {name}: stems {stems.shape} {stems.dtype}, launches {launches}")
    S = preset.model.num_sources
    if stems.shape != (S, len(audio)) or not np.isfinite(stems).all():
        raise AssertionError(f"{name}: bad stems {stems.shape}, finite={np.isfinite(stems).all()}")
    if not (all(launches[k] > 0 for k in ("wiener_apply", "istft"))
            and launches["stft"] == 1 and launches["stft_dft"] == 0):
        raise AssertionError(f"{name}: the pallas route missed a kernel: {launches}")
    ms = time_track(sep, audio)
    mm = Separator(preset, state, device=device)
    mm_ms = time_track(mm, audio)
    del mm
    log(f"  {name}: {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time); matmul route "
        f"(Wiener+iSTFT kernel) {mm_ms:.2f} ms/track ({SECONDS * 1e3 / mm_ms:.1f}x)")
    f32 = dataclasses.replace(preset, model=dataclasses.replace(preset.model, mask_dtype="float32"))
    k32 = Separator(pallas(f32), state, device=device)
    m32 = Separator(f32, state, device=device)
    Lb = bucket_length(len(audio), preset)
    x = torch.from_numpy(np.pad(audio, (0, Lb - len(audio))))[None].to(device)
    y_k, re, im, _ = source_magnitudes(k32.model, x, pallas(f32))
    y_m = source_magnitudes(m32.model, x, f32)[0]
    ey = (y_k - y_m).abs().max().item()
    log(f"  {name} f32 tail: model y vs the matmul route's max_abs_err {ey:.3e} "
        f"(max|y| {y_m.abs().max().item():.3e}; the STFT kernel sums in another order)")
    stems32, mm32 = k32(audio), m32(audio)
    del k32, m32
    er, ei = wiener_apply_plain(y_k[0], re[0], im[0], p=preset.sep.wiener_p,
                                eps=preset.sep.wiener_eps)
    synth = istft_pallas_plain(er, ei, window_of(preset), preset.transform.hop_size, Lb)
    synth = synth[:, : len(audio)].cpu().numpy()
    es = float(np.abs(stems32 - synth).max())
    log(f"  {name} f32 tail: stems vs plain mask + synthesis of the same y max_abs_err {es:.3e} "
        f"(tol {TOL_WIENER_F32})")
    if not es <= TOL_WIENER_F32:
        raise AssertionError(f"{name}: the mask and iSTFT kernels disagree in the slice: {es}")
    snr32 = snr_db(mm32, stems32)
    log(f"  {name} f32 tail: stems vs the matmul route SNR {snr32:.1f} dB "
        f"(min {MIN_SNR_PALLAS_DB}), max_abs_err {np.abs(stems32 - mm32).max():.3e}")
    if not snr32 >= MIN_SNR_PALLAS_DB:
        raise AssertionError(f"{name}: stems disagree with the matmul route: {snr32} dB")
    snr = snr_db(stems32, stems)
    log(f"  {name} bf16 tail vs f32 tail: SNR {snr:.1f} dB (min {MIN_SNR_BF16_DB})")
    if not snr >= MIN_SNR_BF16_DB:
        raise AssertionError(f"{name}: bf16 tail SNR {snr} dB")
    out = torch.empty((S, Lb), device=device)
    pageable, pinned = d2h_ms(out)
    log(f"  {name} stems D2H ({out.numel() * 4 / 1e6:.1f} MB f32): pageable {pageable:.3f} ms, "
        f"pinned {pinned:.3f} ms")
    del sep, re, im, y_k, y_m, x, er, ei, out
    torch.cuda.empty_cache()
    return {"ms": ms, "matmul_ms": mm_ms, "launches": launches,
            "d2h_pageable_ms": pageable, "d2h_pinned_ms": pinned}


def phase_ct_stft(device, gen) -> dict:
    """The forward STFT kernel vs plain on one multires4096 track
    (1, 1 474 560), 4096 pt, hop 1024, beside ``torch.stft`` on the same
    (already padded) frames."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas, stft_ct_pallas_plain
    from convsep_tpu_torch.dsp.stft import _pad_signal
    from convsep_tpu_torch.dsp.windows import sinebell

    w, hop, nfft = sinebell(4096), 1024, 4096
    x = 0.3 * torch.randn(1, MR_SAMPLES, generator=gen, device=device)
    got = stft_ct_pallas(x, w, hop)
    want = stft_ct_pallas_plain(x, w, hop)
    torch.cuda.synchronize()
    peak = max(a.abs().max().item() for a in want)
    e = max((g - p).abs().max().item() for g, p in zip(got, want))
    nf = got[0].shape[1]
    log(f"  ct_stft (1, {MR_SAMPLES}): re/im {tuple(got[0].shape)}, ny {tuple(got[2].shape)} "
        f"max_abs_err {e:.3e} (tol {TOL_STFT * peak:.3e}, max|X| {peak:.3e})")
    if not (e <= TOL_STFT * peak and all(torch.isfinite(a).all() for a in got)):
        raise AssertionError(f"ct_stft kernel disagrees: {e} > {TOL_STFT * peak}")
    padded = _pad_signal(x, nfft, hop)
    wt = torch.from_numpy(w.astype(np.float32)).to(device)

    def library():
        return torch.stft(padded, nfft, hop, window=wt, center=False, return_complex=True)

    lib = library()[0].transpose(0, 1)  # (nf, bins)
    e_lib = max((lib.real[:, :2048] - want[0][0]).abs().max().item(),
                (lib.imag[:, :2048] - want[1][0]).abs().max().item(),
                (lib.real[:, 2048] - want[2][0]).abs().max().item())
    ms = cuda_ms(lambda: stft_ct_pallas(x, w, hop))
    plain_ms = cuda_ms(lambda: stft_ct_pallas_plain(x, w, hop))
    lib_ms = cuda_ms(library)
    us = host_us(lambda: stft_ct_pallas(x, w, hop))
    dev = device_times("ct_stft")["ct_stft"]["ct_stft"]
    b = bound(4 * x.numel() + 4 * sum(a.numel() for a in got), fft_flops(nf, nfft))
    log(f"  ct_stft: kernel {ms:.4f} ms (device {ms_str(dev['device_ms'])}), plain "
        f"{plain_ms:.4f} ms, torch.stft {lib_ms:.4f} ms (device "
        f"{ms_str(dev['library_device_ms'])}; cuFFT on the same frames; {e_lib:.3e} from the "
        f"plain version); bound {b['bound_ms']:.4f} ms ({b['bound_by']}); wrapper host "
        f"{us:.1f} us per call")
    log(f"  device kernels: {json.dumps(dev)}")
    return {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms,
            "device_ms": dev["device_ms"], "library_device_ms": dev["library_device_ms"],
            "host_us": us}


def phase_wiener_ny(device, gen) -> dict:
    """The Wiener+iSTFT kernel's Nyquist-row input at multires4096 (S 4,
    nf 1442, bf16 y): against its plain version (p = 1 and 2,
    conserve_last, f32 and int16) and, bit for bit, against the same
    kernel fed the concatenated spectrum."""
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain
    from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas
    from convsep_tpu_torch.dsp.windows import sinebell

    w, hop, S = sinebell(4096), 1024, 4
    L = MR_SAMPLES
    re, im, ny = stft_ct_pallas(0.3 * torch.randn(1, L, generator=gen, device=device), w, hop)
    nf = re.shape[1]
    y = torch.randn(1, S, nf, 2049, generator=gen, device=device).abs()
    y[..., : nf // 3, :8] = 0.0
    y = y.to(torch.bfloat16)
    full_re = torch.cat([re, ny[..., None]], -1)
    full_im = torch.cat([im, torch.zeros_like(ny)[..., None]], -1)
    worst, same = 0.0, True
    for kw in ({"p": 1.0}, {"p": 2.0}, {"p": 1.0, "conserve_last": True}):
        for out in ("float32", "int16"):
            got = wiener_istft(y, re, im, w, hop, L, output_dtype=out, ny=ny, **kw)
            cat = wiener_istft(y, full_re, full_im, w, hop, L, output_dtype=out, **kw)
            want = wiener_istft_plain(y, re, im, w, hop, L, output_dtype=out, ny=ny, **kw)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            eq = bool(torch.equal(got, cat))
            same = same and eq
            tol = TOL_WIENER_I16 if out == "int16" else TOL_WIENER_F32
            log(f"  wiener ny {kw} {out}: max_abs_err {e:.3e} (tol {tol}), equal to the "
                f"concatenated input's: {eq}")
            if not (e <= tol and eq and torch.isfinite(got.float()).all()):
                raise AssertionError(f"wiener_istft ny {kw} {out}: {e}, bit-equal {eq}")
            if out == "float32":
                worst = max(worst, e)
    ms = cuda_ms(lambda: wiener_istft(y, re, im, w, hop, L, ny=ny))
    cat_ms = cuda_ms(lambda: wiener_istft(y, full_re, full_im, w, hop, L))
    plain_ms = cuda_ms(lambda: wiener_istft_plain(y, re, im, w, hop, L, ny=ny))
    b = bound(2 * y.numel() + 8 * re.numel() + 4 * ny.numel() + 4 * S * L,
              fft_flops(S * nf, 4096) + 4 * y.numel())
    log(f"  wiener ny p=1 f32 out: kernel {ms:.3f} ms (concatenated input {cat_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": worst, "ms": ms, "concatenated_ms": cat_ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "bit_equal_to_concatenated": same}


def phase_band_decode(device, gen) -> dict:
    """The band decode kernel vs plain at one multires4096 track: z (N 196,
    W 505, Tp·C2 800) bf16 and the time kernel's operand as the model builds
    it once (the band (16, 50, 1500) and its packed taps), beside a bf16
    ``torch.matmul`` of the same operands; the operations the kernel runs
    (its plan) beside the band's."""
    import torch
    from convsep_tpu_torch.models.decoder_band_cuda import (
        band_decode_wmajor,
        band_decode_wmajor_plain,
        band_operand,
        band_plan,
    )

    N, Tp, W, C2, kh, I = BAND_SHAPE
    T = Tp + kh - 1
    z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=device)).to(torch.bfloat16)
    op = band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=device), T)
    got = band_decode_wmajor(z, op, T)
    want = band_decode_wmajor_plain(z, op)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    e = (got - want).abs().max().item()
    log(f"  band_decode z {tuple(z.shape)} bf16 → {tuple(got.shape)} f32: max_abs_err {e:.3e} "
        f"(tol {TOL_BAND * scale:.3e}, max|plain| {scale:.3e})")
    if not (e <= TOL_BAND * scale and torch.isfinite(got).all()):
        raise AssertionError(f"band decode kernel disagrees: {e} > {TOL_BAND * scale}")
    zb, bb = z.reshape(N * W, -1), op.band.reshape(Tp * C2, -1).to(torch.bfloat16)
    ms = cuda_ms(lambda: band_decode_wmajor(z, op, T))
    plain_ms = cuda_ms(lambda: band_decode_wmajor_plain(z, op))
    lib_ms = cuda_ms(lambda: torch.matmul(zb, bb))
    us = host_us(lambda: band_decode_wmajor(z, op, T))
    plan = band_plan(N * W, Tp, C2, kh, I, torch.cuda.get_device_properties(0).multi_processor_count)
    # the band's nonzero products: each column t reads the taps h with
    # 0 <= t - h < kh, Tp·kh (h, t) pairs of C2 × I products
    flops = 2.0 * N * W * Tp * kh * C2 * I
    b = bound(2 * z.numel() + 2 * kh * C2 * I + 4 * got.numel(), flops, BF16_FLOPS)
    log(f"  band_decode: kernel {ms:.4f} ms, plain (f32 matmul of the bf16-rounded operands) "
        f"{plain_ms:.3f} ms, torch.matmul bf16 {lib_ms:.3f} ms (bf16 output); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {flops:.3e} operations, the dense product's "
        f"{2.0 * N * W * Tp * C2 * T * I:.3e}); the kernel runs {plan.executed_ops:.4e} "
        f"operations (its plan: {plan.row_tiles} row tiles on {plan.grid} blocks, columns padded "
        f"to {plan.ip}, depth to {plan.c2p} a tap, {plan.smem_bytes} B shared memory); wrapper "
        f"host {us:.1f} us per call")
    return {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms,
            "operations": flops, "executed_operations": plan.executed_ops, "host_us": us}


def auto_fused(preset, batch: int) -> bool:
    """Whether "auto" routes ``preset``'s decode of ``batch`` fc rows
    (segments in one model call) to the fused kernel on the card: only at
    the TMs and batches where it won (``FUSED_DECODE_WON``)."""
    import torch
    from convsep_tpu_torch.models.convsep import resolve_decoder_impl

    return resolve_decoder_impl(preset.model, torch.device("cuda"), batch) == "bandconv_pallas"


def track_segments(preset, n_samples: int) -> int:
    """The segments of one whole ``n_samples`` track (bucketed): the batch
    of its decode."""
    from convsep_tpu_torch.data.segment import segment_count
    from convsep_tpu_torch.dsp.stft import num_frames
    from convsep_tpu_torch.separate import bucket_length

    nf = num_frames(bucket_length(n_samples, preset), preset.transform.hop_size)
    return segment_count(nf, preset.model.time_context)


def with_fields(preset, transform=None, model=None, sep=None):
    """``preset`` with some fields of its transform, model or sep replaced."""
    return dataclasses.replace(
        preset,
        transform=dataclasses.replace(preset.transform, **(transform or {})),
        model=dataclasses.replace(preset.model, **(model or {})),
        sep=dataclasses.replace(preset.sep, **(sep or {})),
    )


def run_route(name: str, preset, state, device, audio, expect: dict):
    """A Separator on ``preset``: warm-up, the counted whole-track call
    (launches from zero), finiteness, ms per track."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.separate import Separator

    sep = Separator(preset, state, device=device)
    sep(audio[:FS])
    kernels.reset_launches()
    stems = sep(audio)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  {name}: stems {stems.shape} {stems.dtype}, launches {launches}")
    if stems.shape != (preset.model.num_sources, len(audio)) or not np.isfinite(stems).all():
        raise AssertionError(f"{name}: bad stems {stems.shape}")
    for k, want in expect.items():
        if (launches[k] > 0) != want:
            raise AssertionError(f"{name}: kernel {k} launched {launches[k]} times, expected "
                                 f"{'>0' if want else '0'}")
    ms = time_track(sep, audio)
    log(f"  {name}: {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time)")
    del sep
    return {"ms": ms, "launches": launches}


def phase_multires_routes(state, preset, device, audio) -> dict:
    """multires4096 routes (b) ``analysis="ct_pallas"`` and (c)
    ``decoder_impl="band_pallas"``, each counted and timed, (b) against
    the "auto" route (a) in the f32 tail, (c) against its plain band decode
    in the same model and against (a)'s f32-tail stems."""
    import numpy as np
    import torch
    from unittest import mock

    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain
    from convsep_tpu_torch.models import convsep as tconv
    from convsep_tpu_torch.models.decoder_band_cuda import band_decode_wmajor_plain
    from convsep_tpu_torch.separate import Separator, bucket_length, source_magnitudes
    from convsep_tpu_torch.separate.pipeline import window_of

    ct = with_fields(preset, transform={"analysis": "ct_pallas"})
    bp = with_fields(preset, model={"decoder_impl": "band_pallas"})
    runs = {
        "ct": run_route(f"{preset.name} analysis=ct_pallas", ct, state, device, audio,
                        {"ct_stft": True, "wiener_istft_ny": True, "wiener_istft": False,
                         "fused_decode": auto_fused(preset, track_segments(preset, len(audio))),
                         "band_decode": False, "stft": False,
                         "stft_dft": False}),
        "band": run_route(f"{preset.name} decoder_impl=band_pallas", bp, state, device, audio,
                          {"band_decode": True, "wiener_istft": True, "fused_decode": False,
                           "ct_stft": False, "wiener_istft_ny": False}),
    }
    if runs["ct"]["launches"]["ct_stft"] != 1:
        raise AssertionError(f"analysis=ct_pallas: {runs['ct']['launches']['ct_stft']} forward "
                             f"STFT launches for one track")
    f32 = {"mask_dtype": "float32"}
    Lb = bucket_length(len(audio), preset)
    x = torch.from_numpy(np.pad(audio, (0, Lb - len(audio))))[None].to(device)
    a32 = Separator(with_fields(preset, model=f32), state, device=device)
    y_a = source_magnitudes(a32.model, x, a32.preset)[0]
    stems_a = a32(audio)
    del a32
    # (b) against (a): the same model, only the analysis differs
    k32 = Separator(with_fields(ct, model=f32), state, device=device)
    y_k, re, im, ny = source_magnitudes(k32.model, x, k32.preset)
    scale = y_a.abs().max().item()
    ey = (y_k - y_a).abs().max().item()
    log(f"  ct_pallas f32 tail: model y vs the auto route's max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}, max|y| {scale:.3e})")
    if not ey <= TOL_SLICE_Y * scale:
        raise AssertionError(f"ct_pallas route: model output disagrees with auto: {ey}")
    stems_k = k32(audio)
    del k32
    synth = wiener_istft_plain(y_k, re, im, window_of(preset), preset.transform.hop_size, Lb,
                               p=preset.sep.wiener_p, eps=preset.sep.wiener_eps, ny=ny)
    es = float(np.abs(stems_k - synth[0, :, : len(audio)].cpu().numpy()).max())
    snr = snr_db(stems_a, stems_k)
    log(f"  ct_pallas f32 tail: stems vs plain synthesis of the same y (ny input) max_abs_err "
        f"{es:.3e} (tol {TOL_WIENER_F32}); vs the auto route SNR {snr:.1f} dB "
        f"(min {MIN_SNR_SLICE_DB}), max_abs_err {np.abs(stems_k - stems_a).max():.3e}")
    if not (es <= TOL_WIENER_F32 and snr >= MIN_SNR_SLICE_DB):
        raise AssertionError(f"ct_pallas route stems disagree: {es}, {snr} dB")
    del y_k, re, im, ny, synth
    # (c) the two-stage wiring in f32 ("band") against (a); then the kernel
    # against its plain band decode (the same z, so the same bf16
    # roundings), and the bf16-operand route against (a)
    f32band = Separator(with_fields(preset, model={"decoder_impl": "band", **f32}), state,
                        device=device)
    ef = (source_magnitudes(f32band.model, x, f32band.preset)[0] - y_a).abs().max().item()
    del f32band
    scale_a = y_a.abs().max().item()
    log(f"  band (f32 two-stage decode) f32 tail: model y vs the auto route's max_abs_err "
        f"{ef:.3e} (tol {TOL_SLICE_Y * scale_a:.3e})")
    if not ef <= TOL_SLICE_Y * scale_a:
        raise AssertionError(f"the f32 band decode disagrees with bandconv: {ef}")
    b32 = Separator(with_fields(bp, model=f32), state, device=device)
    y_b = source_magnitudes(b32.model, x, b32.preset)[0]

    def plain(z, band, T):
        return band_decode_wmajor_plain(z, band)

    with mock.patch.object(tconv, "band_decode_kernel", plain):
        y_bp = source_magnitudes(b32.model, x, b32.preset)[0]
    scale = y_bp.abs().max().item()
    ey = (y_b - y_bp).abs().max().item()
    stems_b = b32(audio)
    del b32
    snr = snr_db(stems_a, stems_b)
    ey_a = (y_b - y_a).abs().max().item()
    log(f"  band_pallas f32 tail: model y vs the plain band decode's max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}); vs the auto route's (f32 bandconv) {ey_a:.3e} "
        f"(tol {TOL_BAND_BF16 * scale_a:.3e}); stems vs the auto route SNR {snr:.1f} dB "
        f"(min {MIN_SNR_BAND_DB})")
    if not (ey <= TOL_SLICE_Y * scale and ey_a <= TOL_BAND_BF16 * scale_a
            and snr >= MIN_SNR_BAND_DB):
        raise AssertionError(f"band_pallas route disagrees: y {ey}, {ey_a}, stems {snr} dB")
    del y_a, y_b, y_bp, x
    torch.cuda.empty_cache()
    return runs


def bach10_notes():
    """Four voices of fixed notes over 30 s (violin, clarinet, saxophone,
    bassoon ranges), made in the script: no annotation files."""
    from convsep_tpu_torch.score import Note

    lines = ((67, 71, 74, 76), (60, 64, 62, 67), (55, 57, 60, 59), (43, 45, 48, 50))
    return [[Note(float(p), 0.5 + 7.25 * i, 0.5 + 7.25 * i + 6.5) for i, p in enumerate(ln)]
            for ln in lines]


def phase_bach10(state, preset, device, audio) -> dict:
    """Separator(bach10)(audio, extra=) at score_gate 0, 0.5 "mult" and 1.0
    "blend", each as phase 4 gates a slice; the score channels from
    ``TransformFFT.compute_file`` and ``score_channels``."""
    from convsep_tpu_torch.data.features import score_channels
    from convsep_tpu_torch.dsp.transform import TransformFFT

    t0 = time.perf_counter()
    mag = TransformFFT(preset.transform, device=device).compute_file(audio)
    extra = score_channels(mag, bach10_notes(), preset, "comb") * preset.train.mult_factor_in
    log(f"  score channels {extra.shape} in {(time.perf_counter() - t0) * 1e3:.1f} ms (host)")
    runs = {}
    for g, mode in ((0.0, "mult"), (0.5, "mult"), (1.0, "blend")):
        name = f"bach10 score_gate={g:g} {mode}"
        p = with_fields(preset, sep={"score_gate": g, "score_gate_mode": mode})
        runs[name] = phase_slice(name, state, p, device, audio,
                                 {"wiener_istft": True, "fused_decode": False}, extra=extra)
    return runs


def phase_chunked(state, preset, device, audio) -> dict:
    """ChunkedSeparator at full width against Separator (see the module
    docstring, phase 15)."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.dft import istft_matmul
    from convsep_tpu_torch.separate import (
        ChunkedSeparator,
        Separator,
        bucket_length,
        source_magnitudes,
    )
    from convsep_tpu_torch.dsp.stft import num_frames
    from convsep_tpu_torch.separate.chunked import chunk_source_magnitudes, padded_chunks
    from convsep_tpu_torch.separate.pipeline import window_of
    from convsep_tpu_torch.utils.pcm import quantize_pcm16_host

    name = f"{preset.name} chunked"
    cs, L = CHUNK_SEGMENTS, len(audio)
    t, m = preset.transform, preset.model
    S, Fc, nf = m.num_sources, m.time_context * cs, num_frames(L, t.hop_size)
    slices = padded_chunks(audio, preset, cs)[1]
    nc = len(slices)
    sep = ChunkedSeparator(preset, state, chunk_segments=cs, device=device)
    sep(audio[:FS])
    kernels.reset_launches()
    stems = sep(audio)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  {name}: {nc} chunks of {Fc} frames, stems {stems.shape} {stems.dtype}, "
        f"launches {launches}")
    if stems.shape != (S, L) or not np.isfinite(stems).all():
        raise AssertionError(f"{name}: bad stems {stems.shape}")
    # the decode sees chunk_segments rows a chunk; the chunk synthesizes by
    # products, as the reference's chunk program does
    want = {"fused_decode": nc if auto_fused(preset, cs) else 0, "wiener_istft": 0,
            "wiener_istft_ny": 0, "stft_dft": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    del sep
    whole = Separator(preset, state, device=device)
    ref = np.array(whole(audio))
    del whole
    snr = snr_db(ref, stems)
    log(f"  {name} bf16 tail vs Separator: SNR {snr:.1f} dB (min {MIN_SNR_BF16_DB}), "
        f"max_abs_err {np.abs(stems - ref).max():.3e}")
    if not snr >= MIN_SNR_BF16_DB:
        raise AssertionError(f"{name}: stems disagree with the whole track: {snr} dB")
    # f32 tail, as phase 4 holds two routes: the model output chunk by chunk
    # against the whole track's, elementwise; the stems by SNR
    f32 = dataclasses.replace(preset, model=dataclasses.replace(m, mask_dtype="float32"))
    c32 = ChunkedSeparator(f32, state, chunk_segments=cs, device=device)
    w32 = Separator(f32, state, device=device)
    y_c = torch.cat([chunk_source_magnitudes(c32.model, torch.from_numpy(s).to(device), f32,
                                             cs)[0] for s in slices], dim=1)[:, :nf]
    Lb = bucket_length(L, preset)
    x = torch.from_numpy(np.pad(audio, (0, Lb - L)))[None].to(device)
    y_w, re, im, _ = source_magnitudes(w32.model, x, f32)
    y_w = y_w[0, :, :nf]
    scale = y_w.abs().max().item()
    ey = (y_c - y_w).abs().max().item()
    log(f"  {name} f32 tail: model y chunk by chunk vs the whole track's max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}, max|y| {scale:.3e})")
    if not ey <= TOL_SLICE_Y * scale:
        raise AssertionError(f"{name}: the chunks' model output disagrees: {ey}")
    s32_c, s32_w = c32(audio), w32(audio)
    del c32, w32, y_c, y_w, x
    snr32 = snr_db(s32_w, s32_c)
    log(f"  {name} f32 tail: stems vs Separator SNR {snr32:.1f} dB (min {MIN_SNR_SLICE_DB}), "
        f"max_abs_err {np.abs(s32_c - s32_w).max():.3e}")
    if not snr32 >= MIN_SNR_SLICE_DB:
        raise AssertionError(f"{name}: f32-tail stems disagree with the whole track: {snr32} dB")
    # complement_last: conservative masks, each chunk's last stem derived on
    # the host; the stems add back to the STFT round trip of the mixture
    comp = ChunkedSeparator(preset, state, chunk_segments=cs, complement_last=True,
                            device=device)(audio)
    rt = istft_matmul(re, im, window_of(preset), t.hop_size, Lb)[0, :L].cpu().numpy()
    del re, im
    ce = float(np.abs(comp.sum(0) - rt).max())
    log(f"  {name} complement_last: |Σ stems − round-tripped mixture| max {ce:.3e} "
        f"(tol {TOL_CONSERVE})")
    if not ce <= TOL_CONSERVE:
        raise AssertionError(f"{name}: complement_last stems do not add up: {ce}")
    # PCM16 in and out, plain and complement, timed as the reference bench
    # times its chunked rows; the whole track's PCM16 time beside them
    pcm = quantize_pcm16_host(audio)
    kw = dict(chunk_segments=cs, output_dtype="int16", input_dtype="int16", device=device)
    ci = ChunkedSeparator(preset, state, **kw)
    cc = ChunkedSeparator(preset, state, complement_last=True, **kw)
    wi = Separator(preset, state, device=device, output_dtype="int16", input_dtype="int16")
    got_i, ref_i = ci(pcm), np.array(wi(pcm))
    if got_i.dtype != np.int16:
        raise AssertionError(f"{name}: PCM16 out gave {got_i.dtype}")
    lsb = int(np.abs(got_i.astype(np.int32) - ref_i.astype(np.int32)).max())
    snr_i = snr_db(ref_i, got_i)
    ms, comp_ms, whole_ms = (time_track(s, pcm) for s in (ci, cc, wi))
    del ci, cc, wi
    torch.cuda.empty_cache()
    nbytes = {"up_mb": (nc * Fc * t.hop_size + t.frame_size - t.hop_size) * 2 / 1e6,
              "down_mb_plain": S * nc * Fc * t.hop_size * 2 / 1e6,
              "down_mb_complement": (S - 1) * nc * Fc * t.hop_size * 2 / 1e6, "n_chunks": nc}
    log(f"  {name} PCM16: vs Separator max {lsb} LSB, SNR {snr_i:.1f} dB (min "
        f"{MIN_SNR_BF16_DB}); {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time), "
        f"complement_last {comp_ms:.2f} ms/track ({SECONDS * 1e3 / comp_ms:.1f}x), whole track "
        f"{whole_ms:.2f} ms/track ({SECONDS * 1e3 / whole_ms:.1f}x); bytes {nbytes}")
    if not snr_i >= MIN_SNR_BF16_DB:
        raise AssertionError(f"{name}: PCM16 stems disagree with the whole track: {snr_i} dB")
    return {"ms": ms, "complement_ms": comp_ms, "whole_track_ms": whole_ms,
            "launches": launches, "bytes": nbytes, "snr_db": snr, "snr_f32_db": snr32,
            "pcm16_max_lsb": lsb}


def phase_online(state, preset, device, audio) -> dict:
    """OnlineSeparator against ChunkedSeparator at the same chunk size, bit
    for bit (phase 16)."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.separate import ChunkedSeparator, OnlineSeparator
    from convsep_tpu_torch.separate.chunked import padded_chunks

    name = f"{preset.name} online"
    cs = ONLINE_SEGMENTS
    osep = OnlineSeparator(preset, state, chunk_segments=cs, device=device)

    def run(_audio=None):
        outs = [osep.push(audio[i:i + ONLINE_BLOCK]) for i in range(0, len(audio), ONLINE_BLOCK)]
        outs.append(osep.flush())
        osep.reset()
        return np.concatenate(outs, axis=-1)

    run()
    kernels.reset_launches()
    got = run()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    nc = len(padded_chunks(audio, preset, cs)[1])
    log(f"  {name}: {nc} chunks, stems {got.shape} {got.dtype}, launches {launches}")
    S = preset.model.num_sources
    if got.shape != (S, len(audio)) or not np.isfinite(got).all():
        raise AssertionError(f"{name}: bad stems {got.shape}")
    want = {"fused_decode": nc if auto_fused(preset, cs) else 0, "wiener_istft": 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    again = run()
    ref = ChunkedSeparator(preset, state, chunk_segments=cs, device=device)(audio)
    same, repeat = np.array_equal(got, ref), np.array_equal(again, got)
    log(f"  {name}: equal to ChunkedSeparator(chunk_segments={cs}) bit for bit: {same} "
        f"(max_abs_err {np.abs(got - ref).max():.3e}); after reset(): {repeat}")
    if not (same and repeat):
        raise AssertionError(f"{name}: online stems differ from the chunked ones")
    ms = time_track(run, audio)
    latency = osep.latency_samples
    osep.close()
    del osep
    torch.cuda.empty_cache()
    log(f"  {name}: {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time) in {ONLINE_BLOCK}-"
        f"sample pushes; latency {latency} samples ({latency / FS * 1e3:.1f} ms of audio)")
    return {"ms": ms, "launches": launches, "latency_samples": latency, "chunks": nc}


def stream_tracks(audio):
    """The reference bench's streaming tracks: the PCM16 mixture + i % 3."""
    import numpy as np
    from convsep_tpu_torch.utils.pcm import quantize_pcm16_host

    pcm = quantize_pcm16_host(audio)
    return [pcm + np.int16(i % 3) for i in range(STREAM_TRACKS)]


def phase_stream(state, preset, device, audio) -> dict:
    """StreamSeparator, PCM16 in and out, against Separator per track
    (phase 17)."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.separate import (
        Separator,
        StreamSeparator,
        bucket_length,
        source_magnitudes,
    )
    from convsep_tpu_torch.utils.pcm import quantize_pcm16_host

    name = f"{preset.name} stream"
    S = preset.model.num_sources
    tracks = stream_tracks(audio)
    kw = dict(output_dtype="int16", input_dtype="int16", device=device)
    ss = StreamSeparator(preset, state, **kw)
    ssc = StreamSeparator(preset, state, complement_last=True, **kw)
    for s in (ss, ssc):
        list(s.stream(iter(tracks[:STREAM_BATCH]), batch_size=STREAM_BATCH))
    kernels.reset_launches()
    outs = [np.array(o) for b in ss.stream(iter(tracks), batch_size=STREAM_BATCH) for o in b]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    batches = -(-len(tracks) // STREAM_BATCH)
    B = STREAM_BATCH * track_segments(preset, len(audio))
    log(f"  {name}: {len(outs)} tracks in batches of {STREAM_BATCH} (decode B {B}), "
        f"launches {launches}")
    want = {"wiener_istft": batches, "fused_decode": batches if auto_fused(preset, B) else 0}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    comp = [np.array(o) for b in ssc.stream(iter(tracks), batch_size=STREAM_BATCH) for o in b]
    single = Separator(preset, state, **kw)
    lsb, snrs, sums, copied = [], [], [], []
    for t, o, c in zip(tracks, outs, comp):
        if o.shape != (S, len(t)) or o.dtype != np.int16 or c.shape != o.shape:
            raise AssertionError(f"{name}: bad stems {o.shape} {o.dtype}, {c.shape}")
        ref = np.array(single(t))
        lsb.append(int(np.abs(o.astype(np.int32) - ref.astype(np.int32)).max()))
        snrs.append(snr_db(ref, o))
        # the copied stems: conservative masks change only the last mask's
        # numerator, so they are the plain stems up to the rounding of the
        # kernel's conserve path
        copied.append(int(np.abs(c[:-1].astype(np.int32) - o[:-1].astype(np.int32)).max()))
        sums.append(int(np.abs(c.astype(np.int32).sum(0) - t.astype(np.int32)).max()))
    # a batch of two clearly different tracks: a kernel that reads the
    # other track's spectra or magnitudes moves its stems by far more than
    # the LSBs between the mixture + i % 3 tracks
    distinct = [quantize_pcm16_host(mixture(0)), quantize_pcm16_host(mixture(1)[::-1].copy())]
    got = [np.array(o) for b in ss.stream(iter(distinct), batch_size=STREAM_BATCH) for o in b]
    snr_distinct = [snr_db(np.array(single(t)), o) for t, o in zip(distinct, got)]
    cross = snr_db(np.array(single(distinct[0])), np.array(single(distinct[1])))
    log(f"  {name} a batch of two different tracks vs Separator per track: SNR "
        f"{[round(v, 1) for v in snr_distinct]} dB (min {MIN_SNR_BF16_DB}); the two tracks' "
        f"stems apart: {cross:.1f} dB")
    if len(got) != 2 or not min(snr_distinct) >= MIN_SNR_BF16_DB:
        raise AssertionError(f"{name}: a batch of different tracks disagrees with Separator: "
                             f"{snr_distinct} dB")
    del single
    log(f"  {name} PCM16 vs Separator per track: max LSB {lsb}, SNR {min(snrs):.1f} dB at worst "
        f"(min {MIN_SNR_BF16_DB}); complement_last: copied stems vs plain max {max(copied)} LSB "
        f"(tol {TOL_WIENER_I16}), |Σ stems − mixture| max {max(sums)} LSB "
        f"(tol {TOL_STREAM_LSB_SUM})")
    if not (min(snrs) >= MIN_SNR_BF16_DB and max(copied) <= TOL_WIENER_I16
            and max(sums) <= TOL_STREAM_LSB_SUM):
        raise AssertionError(f"{name}: stems disagree: {snrs} dB, {copied}, {sums} LSB")
    # f32 tail, the first batch: the batch's model output against each
    # track's alone elementwise, its stems by SNR
    f32 = dataclasses.replace(preset, model=dataclasses.replace(preset.model,
                                                                mask_dtype="float32"))
    s32 = StreamSeparator(f32, state, device=device)
    w32 = Separator(f32, state, device=device)
    first = [t.astype(np.float32) / 32768.0 for t in tracks[:STREAM_BATCH]]
    Lb = bucket_length(len(audio), preset)
    x = torch.from_numpy(np.stack([np.pad(t, (0, Lb - len(t))) for t in first])).to(device)
    y_b = source_magnitudes(s32.model, x, f32)[0]
    ey, scale = 0.0, 0.0
    for i in range(STREAM_BATCH):
        y_1 = source_magnitudes(w32.model, x[i:i + 1], f32)[0]
        scale = max(scale, y_1.abs().max().item())
        ey = max(ey, (y_b[i] - y_1[0]).abs().max().item())
    del y_b, y_1, x
    snr32 = min(snr_db(w32(t), o) for t, o in zip(first, s32.separate_many(first)))
    del s32, w32
    log(f"  {name} f32 tail, batch vs one track at a time: model y max_abs_err {ey:.3e} "
        f"(tol {TOL_SLICE_Y * scale:.3e}); stems SNR {snr32:.1f} dB (min {MIN_SNR_SLICE_DB})")
    if not (ey <= TOL_SLICE_Y * scale and snr32 >= MIN_SNR_SLICE_DB):
        raise AssertionError(f"{name}: the batch disagrees with one track at a time: {ey}, "
                             f"{snr32} dB")
    # per-track time, plain and complement in turns, as the reference bench
    times = {"plain": [], "complement": []}
    for _ in range(3):
        for key, s in (("plain", ss), ("complement", ssc)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = sum(len(b) for b in s.stream(iter(tracks), batch_size=STREAM_BATCH))
            times[key].append((time.perf_counter() - t0) * 1e3 / n)
    ms, comp_ms = (sorted(v)[1] for v in (times["plain"], times["complement"]))
    log(f"  {name} PCM16: {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time), "
        f"complement_last {comp_ms:.2f} ms/track ({SECONDS * 1e3 / comp_ms:.1f}x)")
    # a batch of 8 tracks: its memory, and its stems against the batches of 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    eight = tracks + tracks[:8 - len(tracks)]
    big = [np.array(o) for b in ss.stream(iter(eight), batch_size=8) for o in b]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    snr8 = min(snr_db(o, g) for o, g in zip(outs + outs[:2], big))
    log(f"  {name} batch_size 8: {len(big)} tracks, peak device memory {peak:.2f} GiB; stems vs "
        f"the batches of 2 SNR {snr8:.1f} dB at worst (min {MIN_SNR_BF16_DB})")
    if len(big) != 8 or not snr8 >= MIN_SNR_BF16_DB:
        raise AssertionError(f"{name}: a batch of 8 gave {len(big)} tracks, {snr8} dB")
    del ss, ssc
    torch.cuda.empty_cache()
    return {"ms": ms, "complement_ms": comp_ms, "launches": launches, "decode_batch": B,
            "max_lsb": lsb, "snr_db_min": min(snrs), "snr_f32_db": snr32,
            "snr_distinct_db": snr_distinct,
            "batch8_peak_gib": peak}


def phase_stream_route(name: str, stream, single, tracks, want: dict) -> dict:
    """A StreamSeparator route that runs one track at a time (the pallas
    route, stereo): exact launch counts, and each track's stems against
    the whole-track separator's (the same program per track)."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels

    list(stream.stream(iter(tracks[:STREAM_BATCH]), batch_size=STREAM_BATCH))
    kernels.reset_launches()
    outs = [np.array(o) for b in stream.stream(iter(tracks), batch_size=STREAM_BATCH) for o in b]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"  {name}: {len(outs)} tracks in batches of {STREAM_BATCH}, launches {launches}")
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    err = 0.0
    for t, o in zip(tracks, outs):
        ref = single(t)
        ref = ref.transpose(0, 2, 1) if ref.ndim == 3 else ref  # stereo: (S, L, 2) → (S, 2, L)
        if o.shape != ref.shape or not np.isfinite(o).all():
            raise AssertionError(f"{name}: bad stems {o.shape} vs {ref.shape}")
        err = max(err, float(np.abs(o - ref).max()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(len(b) for b in stream.stream(iter(tracks), batch_size=STREAM_BATCH))
    ms = (time.perf_counter() - t0) * 1e3 / n
    log(f"  {name}: stems vs the whole-track separator max_abs_err {err:.3e} (tol "
        f"{TOL_WIENER_F32}); {ms:.2f} ms/track ({SECONDS * 1e3 / ms:.1f}x real time)")
    if not err <= TOL_WIENER_F32:
        raise AssertionError(f"{name}: stems disagree with the whole-track separator: {err}")
    return {"ms": ms, "launches": launches}


def phase_service(state, preset, device, audio) -> dict:
    """WatchService on a temporary directory of wav mixtures (phase 19)."""
    import os
    import tempfile

    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.data.io import read_wav, write_wav
    from convsep_tpu_torch.separate import StreamSeparator, WatchService

    tracks = stream_tracks(audio)[:3]
    with tempfile.TemporaryDirectory(prefix="convsep-serve-") as tmp:
        inp, out = os.path.join(tmp, "incoming"), os.path.join(tmp, "done")
        os.makedirs(inp)
        names = [f"mix{i}" for i in range(len(tracks))]
        for n, t in zip(names, tracks):
            write_wav(os.path.join(inp, n + ".wav"), FS, t)
        svc = WatchService(preset, state, inp, out, poll_s=0.0, device=device)
        first = svc.sweep()  # records the sizes: no file is known to be complete yet
        kernels.reset_launches()
        t0 = time.perf_counter()
        done = svc.sweep()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        log(f"  service: first sweep {first} tracks, second {done} tracks in {ms:.1f} ms "
            f"(wav reads and writes included), launches {launches}")
        if first != 0 or done != len(tracks) or launches["wiener_istft"] != 1:
            raise AssertionError(f"service: sweeps gave {first}, {done}; launches {launches}")
        wavs = [read_wav(os.path.join(inp, n + ".wav"))[1] for n in names]
        ref = StreamSeparator(preset, state, output_dtype="int16", input_dtype="int16",
                              device=device).separate_many(wavs)
        for n, r in zip(names, ref):
            for s, stem in zip(preset.sources, r):
                fs, got = read_wav(os.path.join(out, n, f"{s}.wav"))
                got = np.rint(got * 32768.0).astype(np.int16)
                if fs != FS or not np.array_equal(got, stem):
                    raise AssertionError(f"service: {n}/{s}.wav differs from StreamSeparator's")
        late = os.path.join(inp, "late.wav")
        third = len(tracks[0]) // 3
        write_wav(late, FS, tracks[0][:third])
        seen = svc.sweep()
        write_wav(late, FS, tracks[0][: 2 * third])  # still being written
        growing = svc.sweep()
        settled = svc.sweep()
        log(f"  service: a growing file: sweeps {seen}, {growing} while it grows, {settled} once "
            f"its size held; stems equal StreamSeparator's bit for bit")
        if (seen, growing, settled) != (0, 0, 1) or not svc._done("late"):
            raise AssertionError(f"service: the growing file gave {seen}, {growing}, {settled}")
    del svc
    torch.cuda.empty_cache()
    return {"ms": ms, "tracks": len(tracks), "launches": launches}


def feature_route_step(preset, params, x, y, device) -> dict:
    """One feature train step of ``preset``'s route from ``params`` with
    zero accumulators (:func:`route_step` for the feature path): loss,
    gradients, the parameters after the update and, on the fused route,
    whether the update equals the plain optimizer's on the same gradients
    bit for bit."""
    import torch
    from convsep_tpu_torch.train.loop import (
        _apply_from_opt,
        _feature_loss_fn,
        _preset_apply_fn,
        create_train_state,
    )

    s, opt = create_train_state(preset, 0, device, params=params)
    loss = _feature_loss_fn(preset)(s.params, x, y)
    g = dict(zip(s.params, torch.autograd.grad(loss, list(s.params.values()))))
    fused = _preset_apply_fn(preset)
    out = {"loss": loss.item(), "grads": g}
    if fused is not None:
        ref, _ = create_train_state(preset, 0, device, params=s.params)
        _apply_from_opt(opt)(ref.params, g, ref.opt_state)
    _, _, gn = (fused or _apply_from_opt(opt))(s.params, g, s.opt_state)
    out.update(grad_norm=gn.item(), params=s.params)
    if fused is not None:
        out["exact"] = all(torch.equal(s.params[k], ref.params[k]) for k in s.params)
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_feature_train(device) -> dict:
    """Feature files, the native batch gather, feature-file training with
    the fused adadelta kernel, one step against the plain route, and a
    checkpointed run resumed mid-epoch, at full dsd100 width."""
    import tempfile

    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt import CheckpointManager
    from convsep_tpu_torch.data import fastbatch
    from convsep_tpu_torch.data.features import compute_features
    from convsep_tpu_torch.data.io import load_tensor, read_wav
    from convsep_tpu_torch.data.pipeline import SegmentDataset, to_device
    from convsep_tpu_torch.dsp.transform import TransformFFT
    from convsep_tpu_torch.train.loop import Trainer, create_train_state, make_train_step

    preset, plain = train_preset(True), train_preset(False)
    tr = preset.train
    with tempfile.TemporaryDirectory() as root:
        audio_dir, feat_dir = os.path.join(root, "audio"), os.path.join(root, "features")
        write_tracks(audio_dir, preset.sources)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        names = compute_features(audio_dir, feat_dir, preset, device=device)
        torch.cuda.synchronize()
        feat_ms = (time.perf_counter() - t0) * 1e3 / len(names)
        feat_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        log(f"  compute_features: {len(names)} tracks of {TRAIN_SECONDS} s (mixture + "
            f"{len(preset.sources)} stems each) in {feat_ms:.1f} ms/track; kernel launches "
            f"{feat_launches or 'none'} (TransformFFT's DFT products)")
        # the mixture as the walker builds it, through the same TransformFFT on the CPU
        stems = [read_wav(os.path.join(audio_dir, names[0], f"{s}.wav"))[1]
                 for s in preset.sources]
        want = TransformFFT(preset.transform, device="cpu").compute_file(np.sum(stems, axis=0))
        got = np.asarray(load_tensor(os.path.join(feat_dir, f"{names[0]}.mix.data")))
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        log(f"  {names[0]}.mix.data {got.shape} vs the CPU route: max err {err:.3e} × peak "
            f"(tol {TOL_FEATURES})")
        if got.shape != want.shape or not err <= TOL_FEATURES:
            raise AssertionError(f"feature file disagrees with the CPU route: {err}")

        ds = SegmentDataset(feat_dir, preset.sources, time_context=tr.time_context,
                            overlap=tr.overlap, mult_factor_in=tr.mult_factor_in,
                            mult_factor_out=tr.mult_factor_out)
        if not fastbatch.available():
            raise AssertionError("the native batch gather (native/fastbatch.cpp) is not in use")
        idx_all = list(ds.batch_indices(tr.batch_size, seed=tr.seed))
        gather = {}
        for native in (True, False):
            ts = []
            for idx in idx_all[:12]:
                t0 = time.perf_counter()
                xb, yb = ds._assemble(idx, native=native)
                ts.append((time.perf_counter() - t0) * 1e3)
            gather["native" if native else "numpy"] = float(np.median(ts[2:]))
        xn, yn = ds._assemble(idx_all[0], native=True)
        xp, yp = ds._assemble(idx_all[0], native=False)
        if not (np.array_equal(xn, xp) and np.array_equal(yn, yp)):
            raise AssertionError("native and numpy batches differ")
        log(f"  SegmentDataset: {len(ds)} segments (T {tr.time_context}, overlap "
            f"{tr.overlap}), {len(idx_all)} batches of {tr.batch_size} an epoch, x "
            f"{xn.shape}; host ms per batch: native gather {gather['native']:.3f}, numpy "
            f"{gather['numpy']:.3f} (equal bytes)")

        seen: list = []
        assemble = ds._assemble

        def recording(idx, native=None):
            seen.append([int(i) for i in idx])
            return assemble(idx, native)

        ds._assemble = recording

        def fit(trainer, max_steps):
            # the prefetch assembles one batch past the last step: keep the trained ones
            seen.clear()
            step0 = trainer.state.step
            trainer.fit(ds, max_steps=max_steps, metrics_path=metrics)
            torch.cuda.synchronize()
            return list(seen[: trainer.state.step - step0])

        metrics = os.path.join(root, "metrics.jsonl")
        # The resume check needs every run to repeat its arithmetic: with
        # cuDNN's default algorithms two runs from one seed part by step 7
        # and end 7e-3 × max|p| apart at step 20 (PERF.md), so the training
        # runs of this phase take cuDNN's deterministic algorithms, and the
        # resumed run must then equal the uninterrupted one bit for bit; the
        # step times at the end of the phase take the default ones.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        ref = Trainer(preset, device=device, seed=0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ref_idx = fit(ref, TRAIN_STEPS)
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with open(metrics) as f:
            recs = [json.loads(line) for line in f]
        steps = [r for r in recs if "loss" in r]
        losses = [r["loss"] for r in steps]
        log(f"  fit: {ref.state.step} steps in {fit_s:.2f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        log(f"  losses by logged step: {[round(v, 6) for v in losses]}")
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"  mean loss, first 5 logged steps {first:.6f}, last 5 {last:.6f}")
        if ref.state.step != TRAIN_STEPS or len(losses) < 10:
            raise AssertionError(f"fit took {ref.state.step} steps, logged {len(losses)}")
        if not (np.isfinite(losses).all() and last < first):
            raise AssertionError(f"feature training loss is not finite and falling: {losses}")
        # two adadelta launches a step (fc_expand_kernel, fc_kernel); no STFT in the step
        if not (launches["fused_adadelta"] == 2 * TRAIN_STEPS and launches["stft"] == 0
                and launches["stft_dft"] == 0):
            raise AssertionError(f"feature training path launched {launches}")
        fit_ms = float(np.median([r["step_time_ms"] for r in steps[1:]]))
        fit_rtf = float(np.median([r["rtf_train"] for r in steps[1:]]))
        log(f"  fit: median step_time_ms {fit_ms:.3f}, rtf_train {fit_rtf:.1f} (the Trainer's "
            f"log; {tr.batch_size * tr.time_context * preset.transform.hop_size / FS:.2f} s "
            f"of audio a step)")

        # the same seed with a workdir, stopped at step 10 (saved there), resumed
        wd = os.path.join(root, "run")
        t1 = Trainer(preset, workdir=wd, device=device, seed=0)
        t1_idx = fit(t1, TRAIN_STEPS // 2)
        t2 = Trainer(preset, workdir=wd, device=device, seed=0)
        t0 = time.perf_counter()
        step = t2.restore()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        same = all(torch.equal(t1.state.params[k], t2.state.params[k])
                   and torch.equal(t1.state.opt_state.accu[k], t2.state.opt_state.accu[k])
                   and torch.equal(t1.state.opt_state.delta_accu[k],
                                   t2.state.opt_state.delta_accu[k]) for k in t1.state.params)
        pos = t2.data_position
        log(f"  restore: step {step}, data position epoch {pos['epoch']} batch "
            f"{pos['batch_in_epoch']}, state bit for bit: {same}")
        if not (same and step == TRAIN_STEPS // 2 and t2.state.step == step
                and (pos["epoch"], pos["batch_in_epoch"]) == (0, TRAIN_STEPS // 2)):
            raise AssertionError(f"restore: step {step}, position {pos}, equal {same}")
        t2_idx = fit(t2, TRAIN_STEPS)
        if not (t1_idx == ref_idx[: TRAIN_STEPS // 2] and t2_idx == ref_idx[TRAIN_STEPS // 2:]):
            raise AssertionError("the resumed run did not train on exactly the unseen batches")
        pmax = max(p.abs().max().item() for p in ref.state.params.values())
        resume_err = max((t2.state.params[k] - p).abs().max().item()
                         for k, p in ref.state.params.items()) / pmax
        resume_exact = all(torch.equal(t2.state.params[k], p)
                           for k, p in ref.state.params.items())
        log(f"  resumed run: batches {TRAIN_STEPS // 2}-{TRAIN_STEPS - 1} of the uninterrupted "
            f"run's (segment indices equal); final parameters vs the uninterrupted run: max "
            f"err {resume_err:.3e} × max|p|, bit for bit: {resume_exact} (gated bit for bit)")
        torch.backends.cudnn.deterministic = deterministic
        if not resume_exact:
            raise AssertionError(f"resumed parameters differ: {resume_err} × max|p|")
        del t1
        # one full-state save and one restore, timed alone
        mgr = CheckpointManager(os.path.join(root, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(t2.state.step, t2.state, extra=t2.data_position)
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = dir_bytes(os.path.join(root, "timed"))
        t0 = time.perf_counter()
        mgr.restore_latest(t2.state)
        torch.cuda.synchronize()
        restore_alone_ms = (time.perf_counter() - t0) * 1e3
        log(f"  checkpoint, full state: {nbytes} bytes; save {save_ms:.1f} ms, restore "
            f"{restore_alone_ms:.1f} ms (the Trainer's restore {restore_ms:.1f} ms)")
        x, y = to_device(ds._assemble(idx_all[0]), device)
        del ref, t2, ds
        torch.cuda.empty_cache()

    # one step of each route from the seeded init, zero accumulators, the same batch
    init = create_train_state(preset, 0, device)[0].params
    k = feature_route_step(preset, init, x, y, device)
    p = feature_route_step(plain, init, x, y, device)
    torch.cuda.synchronize()
    gmax = max(g.abs().max().item() for g in p["grads"].values())
    route = {"loss": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
             "grad_norm": abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"],
             "weights": max((k["params"][n] - w).abs().max().item()
                            for n, w in p["params"].items()) / gmax,
             "exact": k["exact"]}
    log(f"  one step, fused vs plain route: loss {route['loss']:.3e} (tol {TOL_FEATURE_LOSS}), "
        f"grad_norm {route['grad_norm']:.3e}, weights {route['weights']:.3e} × max|g| (tol "
        f"{TOL_FEATURE_WEIGHTS}); the fused update = the plain one on the same gradients: "
        f"{route['exact']}")
    if not (route["loss"] <= TOL_FEATURE_LOSS and route["weights"] <= TOL_FEATURE_WEIGHTS
            and route["exact"]):
        raise AssertionError(f"the fused feature step disagrees with the plain route: {route}")
    del init, k, p
    s_k, opt = create_train_state(preset, 0, device)
    s_p, _ = create_train_state(plain, 0, device)
    ms = time_steps(make_train_step(preset, opt), s_k, x, y)
    plain_ms = time_steps(make_train_step(plain, opt), s_p, x, y)
    audio_s = tr.batch_size * tr.time_context * preset.transform.hop_size / FS
    log(f"  feature train step B {tr.batch_size}: fused {ms:.3f} ms (rtf_train "
        f"{audio_s * 1e3 / ms:.1f}), plain {plain_ms:.3f} ms (rtf_train "
        f"{audio_s * 1e3 / plain_ms:.1f})")
    return {"launches": launches, "features_ms_per_track": feat_ms, "gather_ms": gather,
            "fit_step_ms": fit_ms, "fit_rtf_train": fit_rtf, "ms": ms, "plain_ms": plain_ms,
            "route": route, "resume_err": resume_err, "resume_exact": resume_exact,
            "checkpoint_bytes": nbytes, "save_ms": save_ms, "restore_ms": restore_alone_ms}


CLI_EVAL_SECONDS = 5         # the head the card's evaluation is held to the CPU's on
TOL_EVAL_DB = 1e-4           # dB, BSS Eval on the card vs the CPU route (float64 both)
TOL_EVAL_JSON_DB = 1.5e-3    # dB, the same through the CLI, whose JSON rounds to 1e-3


def mixture_stems(seed: int = 0):
    """The four stems of :func:`mixture` (the same draws): three tones, and
    the fourth tone with the noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(SECONDS * FS)) / FS
    stems = [0.15 * np.sin(2 * np.pi * f * t + 0.5 * np.sin(2 * np.pi * 5 * t + rng.uniform(0, 6)))
             for f in (110.0, 440.0, 1320.0, 3520.0)]
    stems[3] = stems[3] + 0.02 * rng.standard_normal(t.shape)
    return np.stack(stems).astype(np.float32)


def run_cli(verb_args: list[str], cwd: str, timeout: float = 600) -> dict:
    """``python3 -m convsep_tpu_torch.cli --launches <verb> ...`` in ``cwd``
    with this checkout's package; raises with its output unless it exits
    0. Returns its stdout, the launch counts it printed (its own process,
    from zero) and its wall seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(HERE), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "convsep_tpu_torch.cli", "--launches", *verb_args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"convsep-torch {' '.join(verb_args)} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-5000:]}")
    m = re.search(r"^kernel launches: (\{.*\})$", out.stderr, re.M)
    if m is None:
        raise AssertionError(f"convsep-torch {verb_args[0]} printed no launch counts")
    launches = json.loads(m.group(1))
    log(f"  convsep-torch {verb_args[0]}: {wall * 1e3:.0f} ms wall (process start included), "
        f"launches {({k: v for k, v in launches.items() if v})}")
    return {"stdout": out.stdout, "stderr": out.stderr, "launches": launches, "wall_s": wall}


def write_pickle(preset, seed: int, path: str, device) -> None:
    """A seeded random parameter set in the reference pickle format (its
    list of arrays; protocol 4: the reference's protocol 2 stores each
    array as latin-1 text, which takes half a minute a GB to read back)."""
    import pickle

    import torch
    from convsep_tpu_torch.ckpt import export_reference_params, init_params

    state = init_params(preset.model, torch.Generator(device=device).manual_seed(seed), device)
    with open(path, "wb") as f:
        pickle.dump(export_reference_params(state, preset.model), f, protocol=4)


def phase_cli(device) -> dict:
    """Phase 21: each verb as a subprocess of ``python3 -m
    convsep_tpu_torch.cli`` at full width, in a temporary directory."""
    import tempfile

    import numpy as np
    import torch
    from convsep_tpu_torch.ckpt import convert_reference_checkpoint
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.io import read_wav, write_wav
    from convsep_tpu_torch.eval import bss_eval_sources
    from convsep_tpu_torch.separate import Separator

    hi, dsd = get_preset("highres4096"), get_preset("dsd100")
    walls, paths = {}, {}
    with tempfile.TemporaryDirectory() as root:
        def at(*p):
            return os.path.join(root, *p)

        # (a) seeded reference pickles, converted to checkpoint directories
        write_pickle(hi, 21, at("hi.pkl"), device)
        write_pickle(dsd, 22, at("dsd.pkl"), device)
        torch.cuda.empty_cache()
        for name, pkl in (("highres4096", "hi.pkl"), ("dsd100", "dsd.pkl")):
            r = run_cli(["convert", "--preset", name, "--input", at(pkl), "--out",
                         at(pkl[:-4] + "_ckpt")], root)
            walls[f"convert {name}"] = r["wall_s"]

        # (b) separate highres4096 from the checkpoint and from the pickle
        audio = mixture(0)
        write_wav(at("mix.wav"), FS, audio)
        stems_by = {}
        for how, params in (("checkpoint", at("hi_ckpt")), ("pickle", at("hi.pkl"))):
            r = run_cli(["separate", "--preset", "highres4096", "--params", params,
                         "-i", at("mix.wav"), "-o", at(f"est_{how}")], root)
            walls[f"separate highres4096 ({how})"] = r["wall_s"]
            paths[f"highres4096 CLI separate ({how})"] = {"launches": r["launches"]}
            if r["launches"]["fused_decode"] != 1 or r["launches"]["wiener_istft"] != 1:
                raise AssertionError(f"CLI separate ({how}): launches {r['launches']}, "
                                     "expected fused_decode 1 and wiener_istft 1")
            stems_by[how] = np.stack([read_wav(at(f"est_{how}", f"{s}.wav"))[1]
                                      for s in hi.sources])
        _, pcm = read_wav(at("mix.wav"))
        want = Separator(hi, convert_reference_checkpoint(at("hi.pkl"), hi.model), device=device,
                         output_dtype="int16", input_dtype="int16")(pcm)
        torch.cuda.empty_cache()
        for how, got in stems_by.items():
            got16 = np.round(got * 32768.0).astype(np.int16)
            if got16.shape != want.shape or not np.array_equal(got16, want):
                raise AssertionError(
                    f"CLI separate ({how}) stems differ from Separator's: max "
                    f"{np.abs(got16.astype(np.int32) - want).max()} LSB")
        log("  separate: checkpoint and pickle stems equal to Separator's PCM16 stems bit "
            "for bit")

        # (c) evaluate --oracle on those stems against the true stems
        true = mixture_stems(0)
        if not np.abs(true.sum(0) - audio).max() <= 1e-6:
            raise AssertionError("mixture_stems does not add up to mixture")
        for tag, n in (("", len(audio)), ("_head", CLI_EVAL_SECONDS * FS)):
            os.makedirs(at("ref" + tag))
            os.makedirs(at("est" + tag))
            for s, name in enumerate(hi.sources):
                write_wav(at("ref" + tag, f"{name}.wav"), FS, true[s, :n])
                write_wav(at("est" + tag, f"{name}.wav"), FS,
                          np.round(stems_by["checkpoint"][s, :n] * 32768).astype(np.int16))
            write_wav(at(f"mix{tag}.wav"), FS, audio[:n])
        ev, solves = {}, {}
        for tag, dev in (("", "cuda"), ("_head", "cuda"), ("_head", "cpu")):
            r = run_cli(["evaluate", "--ref-dir", at("ref" + tag), "--est-dir", at("est" + tag),
                         "--oracle", "--mix", at(f"mix{tag}.wav"), "--preset", "highres4096",
                         "--device", dev], root)
            walls[f"evaluate {tag or 'full'} {dev}"] = r["wall_s"]
            ev[tag + dev] = json.loads(r["stdout"])
            m = re.search(r"^bss_eval solves: (\{.*\})$", r["stderr"], re.M)
            if m is None:
                raise AssertionError("evaluate printed no solve routes")
            solves[f"{tag or 'full'} {dev}"] = json.loads(m.group(1))
        log(f"  evaluate: Gram solves by route (cholesky on the device, lstsq_host where it "
            f"failed): {json.dumps(solves)}")
        log(f"  evaluate (30 s, card): {json.dumps(ev['cuda'])}")
        for name in hi.sources:
            row = ev["cuda"][name]
            if not all(np.isfinite(list(row.values()))):
                raise AssertionError(f"evaluate: non-finite metrics {row}")
            if not row["oracle_SDR"] > row["SDR"]:
                raise AssertionError(f"evaluate: oracle SDR not above the model's: {row}")
            d = max(abs(ev["_headcuda"][name][k] - ev["_headcpu"][name][k])
                    for k in ev["_headcpu"][name])
            if not d <= TOL_EVAL_JSON_DB:
                raise AssertionError(f"evaluate {name}: card vs CPU {d} dB")
        refs = np.stack([read_wav(at("ref_head", f"{s}.wav"))[1] for s in hi.sources])
        ests = np.stack([read_wav(at("est_head", f"{s}.wav"))[1] for s in hi.sources])
        got = bss_eval_sources(refs, ests, device=device)
        ref_cpu = bss_eval_sources(refs, ests, device="cpu")
        eval_err = max(float(np.abs(g - w).max()) for g, w in zip(got[:3], ref_cpu[:3]))
        log(f"  evaluate: first {CLI_EVAL_SECONDS} s, card vs CPU: {eval_err:.3e} dB in process "
            f"(tol {TOL_EVAL_DB}), JSON within {TOL_EVAL_JSON_DB}")
        if not eval_err <= TOL_EVAL_DB:
            raise AssertionError(f"BSS Eval on the card vs the CPU: {eval_err} dB")

        # (d) compute-features then train one epoch at dsd100
        write_tracks(at("audio"), dsd.sources)
        r = run_cli(["compute-features", "--preset", "dsd100", "--audio-dir", at("audio"),
                     "--out", at("features")], root)
        walls["compute-features dsd100"] = r["wall_s"]
        r = run_cli(["train", "--preset", "dsd100", "--features", at("features"), "--workdir",
                     at("run"), "--epochs", "1", "--optimizer-impl", "fused"], root, timeout=900)
        walls["train dsd100 1 epoch"] = r["wall_s"]
        with open(at("run", "metrics.jsonl")) as f:
            steps = [json.loads(ln) for ln in f if "epoch_loss" in ln][-1]["step"]
        if r["launches"]["fused_adadelta"] != 2 * steps or r["launches"]["stft"]:
            raise AssertionError(f"CLI train: launches {r['launches']}, expected fused_adadelta "
                                 f"2 x {steps} steps and no STFT")
        paths["dsd100 CLI train"] = {"launches": r["launches"]}
        log(f"  train: {steps} steps, fused_adadelta {r['launches']['fused_adadelta']} launches")

        # (e) bench at dsd100
        r = run_cli(["bench", "--preset", "dsd100", "--seconds", "30", "--runs", "3"], root,
                    timeout=900)
        walls["bench dsd100"] = r["wall_s"]
        lines = [ln for ln in r["stdout"].splitlines() if ln.strip()]
        if len(lines) != 1:
            raise AssertionError(f"bench printed {len(lines)} lines")
        bench = json.loads(lines[0])
        d = bench["detail"]
        if not (bench["value"] > 0 and 0 < d["mfu_bf16"] <= 1 and not d["sections_skipped"]):
            raise AssertionError(f"bench: value {bench['value']}, mfu_bf16 {d['mfu_bf16']}, "
                                 f"skipped {d['sections_skipped']}")
        pl = d["launches"].get("pallas-impl", {})
        if not all(pl.get(k, 0) > 0 for k in ("stft", "wiener_apply", "istft")):
            raise AssertionError(f"bench pallas-impl launched {pl}")
        bench_launches = {}
        for sec in d["launches"].values():
            for k, v in sec.items():
                bench_launches[k] = bench_launches.get(k, 0) + v
        paths["dsd100 CLI bench"] = {"launches": {**{k: 0 for k in r["launches"]},
                                                  **bench_launches}}
        headline = {k: v for k, v in d.items() if k.startswith("rtf_")}
        log(f"  bench dsd100: value {bench['value']} ({bench['unit']}), mfu_bf16 "
            f"{d['mfu_bf16']}, tflops {d['tflops']}, batched {d['batched_per_track_s'] * 1e3:.3f} "
            f"ms/track, {json.dumps(headline)}, launches by section {json.dumps(d['launches'])}")

        # (f) profile highres4096: the fused decode kernel on top
        r = run_cli(["profile", "--preset", "highres4096", "--top", "10", "--logdir",
                     at("trace")], root)
        walls["profile highres4096"] = r["wall_s"]
        rows = json.loads(r["stdout"][: r["stdout"].rindex("]") + 1])
        log(f"  profile: top rows {json.dumps(rows[:4])}")
        if "fused_decode_kernel" not in rows[0]["name"]:
            raise AssertionError(f"profile: top row {rows[0]}")
        paths["highres4096 CLI profile"] = {"launches": r["launches"]}
    return {"walls_s": walls, "paths": paths, "bench": bench, "eval_card_vs_cpu_db": eval_err,
            "evaluate": ev["cuda"], "evaluate_solves": solves, "profile_top": rows[:3]}


def setup() -> int:
    """0 when torch sees a CUDA device and the checkout's own
    convsep_tpu_torch imports; else an exit code, with the reason."""
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
    return 0


def main(argv: list[str]) -> int:
    code = setup()
    if code:
        return code
    if argv[:1] == ["--device-times"]:
        print(json.dumps({k: child_device_times(k) for k in argv[1].split(",")}), flush=True)
        return 0
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.models import ConvSep
    from convsep_tpu_torch.separate import Separator, StereoSeparator, StreamSeparator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    global CARD
    smi = smi_line()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernels.build(verbose=True)
    kernels.library()
    log(f"  built {lib.name} in {time.perf_counter() - t0:.1f} s")
    CARD = smi

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
    torch.cuda.empty_cache()
    log("phase 2b: compute_dtype=bfloat16 at highres4096, B 49 (the fused kernel's route)")
    bf16 = phase_bf16_compute(hi_state, hi, 49, device, gen)
    torch.cuda.empty_cache()
    log("phase 3: Wiener+iSTFT kernel vs plain")
    wie = phase_wiener("highres4096", 4096, 1024, 1442, 4, device, gen)
    wie_dsd = phase_wiener("dsd100", 1024, 512, 2882, 4, device, gen)
    torch.cuda.empty_cache()
    # the stream path's batches (phase 17): STREAM_BATCH tracks, and 8
    wie_batches = {}
    for B in (STREAM_BATCH, 8):
        wie_batches[f"highres4096 B {B}"] = phase_wiener("highres4096", 4096, 1024, 1442, 4,
                                                         device, gen, B)
        wie_batches[f"dsd100 B {B}"] = phase_wiener("dsd100", 1024, 512, 2882, 4, device, gen, B)
        torch.cuda.empty_cache()

    log("phase 4: separation slice, 30 s 44.1 kHz mixture, seeded random weights")
    audio = mixture(0)
    hi_run = phase_slice("highres4096", hi_state, hi, device, audio,
                         {"fused_decode": auto_fused(hi, track_segments(hi, len(audio))),
                          "wiener_istft": True})
    del hi_state
    torch.cuda.empty_cache()
    dsd_state = init_params(dsd.model, torch.Generator(device=device).manual_seed(1), device)
    dsd_run = phase_slice("dsd100", dsd_state, dsd, device, audio,
                          {"fused_decode": False, "wiener_istft": True})
    torch.cuda.empty_cache()

    log("phase 5: training kernels vs plain (dsd100 training-step shapes)")
    stft, stft_dft = phase_stft(device, gen)
    ada = phase_adadelta(device, gen)
    torch.cuda.empty_cache()
    log("phase 6: training slice, dsd100 full width, B 32, synthetic stems, seeded weights")
    train = phase_train(device)
    torch.cuda.empty_cache()

    log("phase 7: iSTFT kernel vs plain (stereo highres4096 and dsd100 pallas-route shapes)")
    ist = phase_istft(device, gen)
    log("phase 8: Wiener mask kernel vs plain (dsd100 pallas-route and highres4096 shapes)")
    wap = phase_wiener_apply(device, gen)
    torch.cuda.empty_cache()
    log("phase 9: stereo slice, highres4096-stereo full width, 30 s stereo mixture, "
        "seeded random weights")
    st = get_preset("highres4096-stereo")
    st_state = init_params(st.model, torch.Generator(device=device).manual_seed(2), device)
    st_run = phase_stereo(st_state, st, device, stereo_mixture(0))
    st_model = ConvSep(st.model, st_state, device=device).prepare_inference()
    assert tuple(st_model.kcat.shape) == (800, 8, 240), tuple(st_model.kcat.shape)
    dec240 = phase_decode(st_model, 49, device, gen)
    del st_state, st_model
    torch.cuda.empty_cache()
    log("phase 10: fft_impl=\"pallas\" slice, dsd100 full width, the phase 4 mixture and weights")
    pl_run = phase_pallas_route(dsd_state, dsd, device, audio)
    del dsd_state
    torch.cuda.empty_cache()

    log("phase 11: multires4096 kernels vs plain (forward STFT, Nyquist-row Wiener+iSTFT, "
        "band decode, fused decode at TM 360)")
    ct = phase_ct_stft(device, gen)
    wny = phase_wiener_ny(device, gen)
    torch.cuda.empty_cache()
    band = phase_band_decode(device, gen)
    torch.cuda.empty_cache()
    mr = get_preset("multires4096")
    mr_state = init_params(mr.model, torch.Generator(device=device).manual_seed(4), device)
    mr_model = ConvSep(mr.model, mr_state, device=device).prepare_inference()
    assert tuple(mr_model.kcat.shape) == (800, 8, 360), tuple(mr_model.kcat.shape)
    dec360 = phase_decode(mr_model, 49, device, gen)
    del mr_model
    torch.cuda.empty_cache()
    log("phase 12: multires4096 slice, full width, the phase 4 mixture, seeded random weights")
    mr_run = phase_slice("multires4096", mr_state, mr, device, audio,
                         {"fused_decode": auto_fused(mr, track_segments(mr, len(audio))),
                          "wiener_istft": True, "ct_stft": False,
                          "band_decode": False})
    mr_routes = phase_multires_routes(mr_state, mr, device, audio)
    del mr_state
    torch.cuda.empty_cache()
    log("phase 13: bach10 score-informed slice, full width, the phase 4 mixture, seeded "
        "random weights")
    b10 = get_preset("bach10")
    b10_state = init_params(b10.model, torch.Generator(device=device).manual_seed(5), device)
    b10_runs = phase_bach10(b10_state, b10, device, audio)
    del b10_state
    torch.cuda.empty_cache()

    log("phase 14: device times (torch.profiler, in a child) of the fused decode at TM 120 "
        "and 360, the Wiener+iSTFT (highres4096, dsd100), Wiener mask, band decode and "
        "adadelta kernels")
    dev = device_times("decode,others")
    for key, r in (("TM 120", dec), ("TM 360", dec360)):
        d = dev["decode"][key]
        r.update(device_ms=d["device_ms"], plain_device_ms=d["plain_device_ms"])
        log(f"  fused decode {key}: device {ms_str(d['device_ms'])}, plain device "
            f"{ms_str(d['plain_device_ms'])}; bound {r['bound_ms']:.3f} ms (3xTF32), "
            f"{r['f32_simt_bound_ms']:.3f} ms (float32 SIMT)")
    others = dev["others"]
    for name, r in (("wiener_istft", wie), ("wiener_istft dsd100", wie_dsd),
                    ("wiener_apply", wap["dsd100 pallas route"]), ("band_decode", band),
                    ("fused_adadelta", ada)):
        r["device_ms"] = others[name]
        log(f"  {name}: device {ms_str(others[name])} (events {r['ms']:.4f} ms), bound "
            f"{r['bound_ms']:.4f} ms")
    log(f"  device kernels: {json.dumps(dev)}")

    # the separation modes that stream: each state re-made from its seed
    log("phase 15: chunked, ChunkedSeparator(chunk_segments=32) at full width, the phase 4 "
        "mixture, seeded random weights")
    hi_state = init_params(hi.model, torch.Generator(device=device).manual_seed(0), device)
    dsd_state = init_params(dsd.model, torch.Generator(device=device).manual_seed(1), device)
    chunked = {"highres4096": phase_chunked(hi_state, hi, device, audio),
               "dsd100": phase_chunked(dsd_state, dsd, device, audio)}
    log("phase 16: online, OnlineSeparator(chunk_segments=8), 16 384-sample pushes")
    online = {"dsd100": phase_online(dsd_state, dsd, device, audio),
              "highres4096": phase_online(hi_state, hi, device, audio)}
    log("phase 17: stream, StreamSeparator, 6 tracks in batches of 2")
    stream = {"dsd100": phase_stream(dsd_state, dsd, device, audio),
              "highres4096": phase_stream(hi_state, hi, device, audio)}
    pallas = with_fields(dsd, transform={"fft_impl": "pallas"})
    n = STREAM_TRACKS
    stream["dsd100 fft_impl=pallas"] = phase_stream_route(
        "dsd100 fft_impl=pallas stream", StreamSeparator(pallas, dsd_state, device=device),
        Separator(pallas, dsd_state, device=device),
        [audio + np.float32(i % 3 / 32768.0) for i in range(n)],
        {"stft": n, "wiener_apply": n, "istft": n, "stft_dft": 0, "wiener_istft": 0})
    st_state = init_params(st.model, torch.Generator(device=device).manual_seed(2), device)
    st_mix = stereo_mixture(0)
    stream["highres4096-stereo"] = phase_stream_route(
        "highres4096-stereo stream", StreamSeparator(st, st_state, device=device),
        StereoSeparator(st, st_state, device=device), [st_mix, 0.5 * st_mix],
        {"istft": 2, "wiener_istft": 0,
         "fused_decode": 2 if auto_fused(st, track_segments(st, st_mix.shape[1])) else 0})
    del st_state
    torch.cuda.empty_cache()
    log("phase 18: fused decode kernel vs plain at TM 120, B 8, 32 and 98 (the online, "
        "chunked and stream batches)")
    hi_model = ConvSep(hi.model, hi_state, device=device).prepare_inference()
    dec_batches = {B: phase_decode(hi_model, B, device, gen) for B in (8, 32, 98)}
    del hi_model, hi_state
    torch.cuda.empty_cache()
    log("phase 19: service, WatchService(dsd100) on a temporary directory of 3 wav mixtures")
    service = phase_service(dsd_state, dsd, device, audio)
    del dsd_state
    torch.cuda.empty_cache()
    log("phase 20: feature-file training, dsd100 full width: compute_features, "
        "SegmentDataset, Trainer(from_audio=False) with the fused adadelta kernel, resume")
    t0 = time.perf_counter()
    feature_train = phase_feature_train(device)
    torch.cuda.empty_cache()
    log(f"  phase 20 took {time.perf_counter() - t0:.1f} s")

    log("phase 21: the CLI on the card, each verb a subprocess: convert, separate "
        "(highres4096), evaluate --oracle, compute-features + train (dsd100), bench, profile")
    t0 = time.perf_counter()
    cli_run = phase_cli(device)
    log(f"  phase 21 took {time.perf_counter() - t0:.1f} s")

    # each main path's counts, taken from zero just before it ran
    paths = {"highres4096": hi_run, "dsd100": dsd_run, "dsd100 training": train,
             "dsd100 feature training": feature_train,
             "highres4096-stereo": st_run, "dsd100 fft_impl=pallas": pl_run,
             "multires4096": mr_run, "multires4096 analysis=ct_pallas": mr_routes["ct"],
             "multires4096 decoder_impl=band_pallas": mr_routes["band"], **b10_runs,
             "highres4096 compute_dtype=bfloat16 (B 49)": bf16,
             **{f"{k} chunked": r for k, r in chunked.items()},
             **{f"{k} online": r for k, r in online.items()},
             **{f"{k} stream": r for k, r in stream.items()}, "dsd100 service": service,
             **cli_run["paths"]}

    def launched(kernel: str) -> dict:
        by_path = {p: r["launches"][kernel] for p, r in paths.items() if r["launches"][kernel]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    # every path's STFT runs on the FFT core: the dense DFT kernel serves
    # only sizes that no preset uses
    if launched("stft_dft")["launches"]:
        raise AssertionError(f"a main path ran the dense DFT kernel: {launched('stft_dft')}")

    result = {"kernels": [
        {"name": "fused_decode", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/decoder_fused.cu",
         "replaces": "convsep_tpu/models/decoder_fused_pallas.py:194",
         **launched("fused_decode"), **dec, "stereo_tm240": dec240, "multires4096_tm360": dec360,
         "bf16_compute_b49": {k: v for k, v in bf16.items() if k != "launches"},
         "tm120_batches": {str(B): r for B, r in dec_batches.items()}},
        {"name": "wiener_istft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         **launched("wiener_istft"), **wie, "dsd100": wie_dsd, "batches": wie_batches,
         "ny": {**launched("wiener_istft_ny"), **wny}},
        {"name": "stft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_fft_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         **launched("stft"), **stft, "route_check": train["route"]},
        {"name": "stft_dft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_dft_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         "serves": "nfft not a power of two in [16, 8192]; no preset",
         **launched("stft_dft"), **stft_dft},
        {"name": "fused_adadelta", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/fused_adadelta.cu",
         "replaces": "convsep_tpu/train/fused_optim.py:88",
         **launched("fused_adadelta"), **ada},
        {"name": "istft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         **launched("istft"), **ist["highres4096-stereo"],
         "dsd100_pallas_route": ist["dsd100 pallas route"]},
        {"name": "wiener_apply", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_apply.cu",
         "replaces": "convsep_tpu/dsp/pallas/wiener_kernel.py:77",
         **launched("wiener_apply"), **wap["dsd100 pallas route"],
         "highres4096": wap["highres4096"]},
        {"name": "ct_stft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/ct_stft.cu",
         "replaces": "convsep_tpu/dsp/pallas/ct_stft_kernel.py:187",
         **launched("ct_stft"), **ct},
        {"name": "band_decode", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/band_decode.cu",
         "replaces": "convsep_tpu/models/decoder_pallas.py:80",
         **launched("band_decode"), **band},
    ], "slices_ms_per_track": {
        "highres4096-stereo": {"kernel": st_run["ms"], "plain": st_run["plain_ms"]},
        "dsd100 fft_impl=pallas": {"pallas": pl_run["ms"], "matmul": pl_run["matmul_ms"]},
        "multires4096": {"auto": mr_run["ms"], "plain": mr_run["plain_ms"],
                         "analysis=ct_pallas": mr_routes["ct"]["ms"],
                         "decoder_impl=band_pallas": mr_routes["band"]["ms"]},
        **{k: {"kernel": r["ms"], "plain": r["plain_ms"]} for k, r in b10_runs.items()},
        "chunked": {k: {"pcm16": r["ms"], "pcm16_complement": r["complement_ms"],
                        "whole_track_pcm16": r["whole_track_ms"]} for k, r in chunked.items()},
        "online": {k: {"float32": r["ms"], "latency_samples": r["latency_samples"]}
                   for k, r in online.items()},
        "stream": {k: {"ms": r["ms"], **({"pcm16_complement": r["complement_ms"]}
                                         if "complement_ms" in r else {})}
                   for k, r in stream.items()},
        "service": {"dsd100 sweep of 3 tracks": service["ms"]},
    }, "feature_training": {k: v for k, v in feature_train.items() if k != "launches"},
        "cli": {k: v for k, v in cli_run.items() if k not in ("paths", "bench")},
        "bench": {"value": cli_run["bench"]["value"],
                  **{k: v for k, v in cli_run["bench"]["detail"].items()
                     if k.startswith("rtf_") or k in ("mfu_bf16", "tflops", "launches")}}, "chunked_bytes": {k: r["bytes"] for k, r in chunked.items()}, "stems_d2h_ms": {
        "highres4096-stereo": {"pageable": st_run["d2h_pageable_ms"],
                               "pinned": st_run["d2h_pinned_ms"]},
        "dsd100": {"pageable": pl_run["d2h_pageable_ms"], "pinned": pl_run["d2h_pinned_ms"]},
    }}
    print(json.dumps(result), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
