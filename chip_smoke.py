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
   spread (``DECODE_SPREAD``); 2b: ``compute_dtype="bfloat16"`` at B 49,
   where "auto" must take the plain bf16 decode (float32 the kernel), the
   kernel forced (``decoder_impl="bandconv_pallas"``: one launch) against
   it within ``TOL_BF16_COMPUTE``, and both forward times;
3. Wiener+iSTFT kernel vs its plain version at highres4096 (nfft 4096,
   hop 1024, nf 1442, bf16 y) and dsd100 (nfft 1024, hop 512, nf 2882):
   p = 1 and 2, conserve_last, float32 and int16 output; at both shapes its
   time, the plain version's, the bound, the wrapper's host time, the
   launch plan (``fft_plan.wiener_plan``), the masked chain's time and
   ``torch.istft``'s of the masked spectra; then the same at the stream
   path's batches (phase 17): 2 and 8 tracks a launch, each track its own
   random mixture and magnitudes; 3c: past 8192 points on a thread-block
   cluster at the reference kernel's 16 384 (hop 2048) and 32 768 (hop
   4096), 4 stems of a 30 s track: the direct transform on 2 and 4 blocks,
   and at W 10 000 (hop 2500), 20 000 (hop 5000) and 14 000 (hop 3500, a
   radix-7 pass) the same on the 7-smooth block core (C 2, 4 and 2): bf16
   and f32 y and the Nyquist-row
   input (at 16 384 the forward STFT kernel's own pair), also against the
   float64 synthesis, the A/B against the masked chain that keys "auto"
   (``WIENER_CLUSTER_WON``) and ``torch.istft`` of the masked spectra;
   Bluestein's cluster forced at 16 384, 10 000, 20 000 and 14 000 (the
   kernel the direct ones replaced; at 20 000 also f32 y and its
   Nyquist-row input);
   the clusters of 2 and 4 the card holds at once;
4. the slice: ``Separator`` for highres4096 and dsd100 at full width with
   seeded random weights on a 30 s 44.1 kHz mixture: finite stems of the
   right shape, kernel launch counters above zero, the kernel route
   against the plain route in float32 (the model's output elementwise,
   the stems by SNR), conservation of the mixture, the bf16 tail's SNR
   against the f32 tail, ms per track and real-time factor;
5. the training kernels vs their plain versions at the dsd100 training
   step's shapes: the FFT STFT kernel on (32, 14 336) and (128, 14 336)
   signals (W 1024, hop 512) beside ``torch.stft(center=False)`` on the
   same padded signal; the split STFT kernel (m · 2^a sizes) on (32, 14
   336) at W 768, hop 256 and W 1280, hop 320, and the Bluestein kernel at
   W 1000, hop 250, on the 16 384-point level at W 6000, hop 1500, and on
   a thread-block cluster at W 12 288, hop 3072 (4 blocks), W 20 000,
   hop 5000 (8 blocks), W 40 000, hop 10 000 and W 65 536, hop 16 384 (16
   blocks; the plain version there the float64 STFT, the direct matrices
   passing 6 GB; every cluster row also held to it), beside the dense DFT
   kernel forced at the split's, Bluestein's and the cluster's W 12 288 and
   W 40 000 shapes; each call launching its kernel once and no other
   (``STFT_SHAPES``), each with its device time from ``torch.profiler`` (in
   a child process: a profiler session slows its process's host for good)
   and its wrapper's host time per call; the fused adadelta kernel on
   leaves the size of ``fc_expand_kernel`` and ``fc_kernel``; 5b: the second
   level past 65 536 points (Bluestein's M 262 144 or 524 288 over two
   passes through device memory): ``stft_pallas`` at W 70 000, 131 072 and
   99 999 on B 32 segments and ``istft_pallas`` (float32 and PCM16) at the
   same W on a 30 s track's frames, against the float64 transforms, beside
   ``torch.stft`` / ``torch.istft``, their device times in a child, and the
   dense DFT kernel forced at W 70 000 (its 19.6 GB of matrices made on the
   card and freed at once);
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
7. the iSTFT kernels vs their plain version, float32 and int16, at the
   stereo highres4096 shapes (8 signals, nf 1442, 2049 bins, through
   ``istft_ct_pallas``) and the dsd100 pallas-route shapes (4 signals, nf
   2882, 513 bins, through ``istft_pallas``), beside ``torch.istft``, with
   both device times (in a child) and the wrapper's host time; the split
   run backwards at W 768, hop 256, Bluestein run backwards at W 1000, hop
   250 (beside the direct sum forced there) and on the level at W 6000, hop
   1500 (4 stems of a 30 s track each), on a cluster at W 10 000, hop 2500
   (beside the direct sum forced there), W 20 000, hop 5000, W 40 000, hop
   10 000 and W 65 536, hop 16 384 (one stem each; the plan beside the
   clusters the card holds at once; past 32 768 the plain version is the
   float64 synthesis, and every cluster row is also held to it); at W
   10 000, 20 000 and 40 000 the direct transform on the 7-smooth block
   core (2, 4 and 8 blocks of n 5000), at W 14 000, hop 3500 and W 56 000,
   hop 14 000 on its radix-7 pass (2 and 8 blocks of n 7000), under
   Bluestein's cluster forced at each, ``istft_plan`` taking it exactly
   where ``ISTFT_MIXED_WON`` says;
   each call launching its kernel once and no other; 7b: the Wiener+iSTFT at even
   sizes up to 8192 that are not powers of two, 4 stems of a 30 s track, as
   phase 3: the split at W 768 and 1280, Bluestein run backwards at W 1000,
   on the level at W 6000 and with frame pairs at W 8190, hop 910, the
   direct sum they replaced forced at W 768 and 1000, each beside
   ``torch.istft`` of the masked spectra and, but the direct sum, the A/B
   against the masked chain that keys "auto"
   (``WIENER_SPLIT_BLUESTEIN_WON``); the Nyquist-row input at W 768 and
   8190; 7c: the iSTFT at odd nfft (no Nyquist bin): Bluestein run
   backwards at W 1001, hop 143 and W 999, hop 333, on a cluster at W 9999,
   hop 1111 and W 39 999, hop 13 333, on a 30 s track's frames, float32
   against the float64 synthesis (``TOL_ODD_ISTFT``) and PCM16 within one
   LSB;
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
   kernel on one track (1, 1 474 560), 4096 pt, hop 1024, its level at the
   reference's 16 384 pt, hop 4096, and the cluster kernel it replaced
   there, forced (both also against the float64 STFT),
   beside ``torch.stft``, with both device times (as phase 5) and the
   wrapper's host time; the Wiener+iSTFT kernel's Nyquist-row input against its
   plain version and, bit for bit, against the same kernel fed the
   concatenated spectrum; the band decode kernel at N 196, Tp 16, W 505,
   C2 50, T·I 1500 on the operand the model builds once (band and packed
   taps) beside a bf16 ``torch.matmul``, with the operations it runs (its
   plan) beside the band's, and its wrapper's host time; the fused decode
   at TM 360; 11b: the fused decode at the reference rule's edges (J 128
   with ktaps 17 at TM 120 and ktaps 16 at TM 360, J 100 padded to 104; B
   49, random operands), the launcher's plan against its mirror; the band
   decode past one block's shared memory (multires4096's geometry at C2
   128, I 64 and at C2 100, I 100) on the streamed kernel, one launch a
   call, beside the pieces it replaced (forced), the plain version, a bf16
   ``torch.matmul`` and the bound, and faster than the pieces; its A/B
   against the taps-resident kernel at C2 32, I 100, a band that fits it,
   which keys ``BAND_STREAM_WON``;
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
   3 shapes, phase 3c's and phase 7b's), Wiener mask, band decode (phase
   11's shape, and the streamed kernel at phase 11b's) and fused adadelta
   kernels;
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
   fused decode kernel on top);
22. stereo training, dsd100-stereo at full width, B 32, on 8 synthetic
   tracks of panned stereo stems (``AudioSegmentDataset(stereo=True)``):
   one step of the kernel route (the STFT kernel on (64, 14 336) mixture
   and (256, 14 336) stem rows, the fused adadelta kernel) against the
   plain route from the seeded init, beside phase 6's witnesses, at phase
   6's limits or, where a witness itself reads past one,
   ``WITNESS_MARGIN`` × the larger witness; ``Trainer.fit(max_steps=20)``: a finite, falling loss, two
   STFT launches a step, the adadelta kernel; both routes' step times, the
   Trainer's logged step and the peak device memory;
23. multires training, multires4096 the same way on mono tracks (the STFT
   kernel at 4096 on (32, 28 672) and (128, 28 672), the multires channels
   by ``stft_matmul`` at 1024 and 2048 in the step);
24. bf16 adadelta state: dsd100, B 32, the plain update, 20 feature steps
   on one seeded batch (the reference bench's ``b32_state_bf16`` setting)
   with bf16 accumulators against float32 ones from the same seed (cuDNN
   deterministic): the accumulators bf16, each step's loss against the
   reference's 2e-5 (``TOL_BF16_STATE``, printed) and gated at the larger
   of it and bf16 storage's first-order limit (2^-9 of the float32 run's
   descent so far), both step times; the same from audio on 20 different
   batches, printed;
25. ``steps_per_dispatch`` 4: dsd100 kernel route, 5 replays of the CUDA
   graph of 4 steps against 20 eager steps from the same state (cuDNN
   deterministic): parameters, accumulators and losses bit for bit (else
   held at ``TOL_GRAPH`` × max|p|), the launch counts (a replay adds the
   capture's; the warm-up's 2 steps on copies counted), then
   ``Trainer.fit`` with K 4 and K 1, each its logged step;
26. asynchronous checkpoints: ``Trainer(workdir=...).fit(max_steps=10)``
   with ``checkpoint_every_steps`` 5: two saves on the writer thread, the
   ms each held the caller, a synchronous save of the same state beside
   them, and a fresh Trainer's restore bit for bit;
27. distributed on a process group of one rank (NCCL): ``ShardedSeparator``
   at highres4096 full width against ``Separator``, ``StreamSeparator(mesh=)``
   bit for bit its stems without a mesh, and ``Trainer(mesh=)`` at dsd100
   B 32 on the kernel route in grain's order, stopped and resumed on the
   unseen batches; ms per track and per step with and without the mesh.

Each slice expects the fused decode launched exactly where "auto" routes it
(``models/decoder_fused_cuda.py::FUSED_DECODE_WON``: by compute dtype, TM
and batch).

Every kernel's time comes with its bound (bytes over 3.35 TB/s or
operations over 67 TFLOP/s in float32, 989 TFLOP/s for the bf16 band
product, whichever is larger, from this run's shapes) and, where one
PyTorch call computes the same function, that call's time.
Then one JSON line with every kernel's numbers, the nvidia-smi line, and
the last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device and when run outside the repository checkout. TF32 is off for
every parity comparison (matmul and cuDNN).

    python3 chip_smoke.py --device-times stft|ct_stft|istft|level2|decode|others[,...]

is the child that phases 5, 5b, 7, 11 and 14 start: it prints one JSON line of
device times, keyed by kind. ``training_paths`` in the result line carries
phases 22–26's numbers.
"""

from __future__ import annotations

import dataclasses
import functools
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
# the stems of a 30 s track at W 768, hop 256 (the split, run backwards
# by the iSTFT; the Wiener+iSTFT kernel's direct sum), at W 1000, hop 250
# and W 6000, hop 1500 (Bluestein run backwards, on the core and on the
# level), at W 10 000, hop 2500 and W 20 000, hop 5000 (Bluestein on a
# thread-block cluster of 4 and of 8 blocks, and at W 10 000 the direct sum
# it replaces): sizes that are not powers of two, timed, no main path
W768_NF = 5170
W1280_NF = 4137
W1000_NF = 5294
W8190_NF = 1456
W6000_NF = 884
W10000_NF = 532
W20000_NF = 267
# the same at W 14 000, hop 3500 and W 56 000, hop 14 000 (7-smooth: C 2
# and C 8 of n 7000 on the mixed cluster's radix-7 pass)
W14000_NF = 380
W56000_NF = 97
# the 44.1 kHz windows of 250 ms, 500 ms and 1 s at hop N/5, N/5 and N/4
# (W 11 025 odd, C 3 of n 3675; W 22 050, C 3 of n 7350; W 44 100, C 6 of
# n 7350: the mixed cluster's clusters of 3 and 6 blocks)
W11025_NF = 602
W22050_NF = 302
W44100_NF = 122
# past 32 768 points (W 40 000, hop 10 000 and W 65 536, hop 16 384: 16 blocks
# a cluster) the frames of a 30 s track; the Wiener+iSTFT's cluster at the
# reference's 16 384 (hop 2048) and 32 768 (hop 4096)
W40000_NF = 135
W65536_NF = 83
W16384_NF = 648
W32768_NF = 325
# Past 32 768 points the plain versions' direct DFT matrices pass 6 GB (W 40
# 000: 40 000 × 20 001 floats, twice, a direction), so there the plain
# version is the float64 transform of the same frames (rfft64_stft,
# istft64); every kernel past 8192 is held to that float64 version too, at
# the bounds below, beside the float32 plain version's own tolerance.
DIRECT_MAX_NFFT = 32768
TOL_CLUSTER_STFT = 3e-6  # × max|X|: Bluestein on a cluster (float32) against the float64 STFT
TOL_CLUSTER_F32 = 2e-6   # × max|out|: the cluster iSTFT and Wiener+iSTFT against float64
TOL_LEVEL_STFT = 1e-6    # × max|X|: one 16 384-point transform a pair (the level) against float64
TOL_LEVEL2 = 2e-6        # × max|X| or max|out|: the second level, both directions, against float64
TOL_ODD_ISTFT = 1e-6     # × max|out|: odd-nfft iSTFT (Bluestein run backwards) against float64
MAX_CORE_NFFT = 8192     # the FFT core's largest transform (fft_common.cuh::kMaxLog2)
# The spread of the Wiener+iSTFT cluster's time against the masked chain's
# between runs: "auto" may take the kernel where one run reads it this much
# slower (ct_istft_kernel.WIENER_CLUSTER_WON, as DECODE_SPREAD for the decode).
WIENER_SPREAD = 0.05
# the iSTFT kernels' shapes: (path, nfft, hop, nf, signals, through
# istft_ct_pallas (else istft_pallas, or istft_direct_pallas where the
# kernel is "istft_direct", or istft_bluestein_cluster_pallas where it is
# "istft_cluster" at a power of two or a won 5-smooth size, or
# launch_istft(cluster_mixed=True) where it is "istft_cluster_mixed" at a
# size off ISTFT_MIXED_WON), the kernel it must launch). At the powers of
# two past 8192 (the reference's 16 384 and 32 768, and 65 536) the direct
# transform on a cluster, at W 10 000, 20 000 and 40 000 the same on the
# 7-smooth block core (C 2, 4, 8 of n 5000), at W 14 000 and 56 000 on its
# radix-7 pass (C 2 and 8 of n 7000), at W 11 025 (odd), 22 050 and 44 100
# on clusters of 3, 3 and 6 blocks, Bluestein's cluster forced beside
# each.
ISTFT_SHAPES = (("highres4096-stereo", 4096, 1024, 1442, 8, True, "istft"),
                ("dsd100 pallas route", 1024, 512, 2882, 4, False, "istft"),
                ("W 768 split", 768, 256, W768_NF, 4, False, "istft_split"),
                ("W 1000 Bluestein", 1000, 250, W1000_NF, 4, False, "istft_bluestein"),
                ("W 1000 direct sum", 1000, 250, W1000_NF, 4, False, "istft_direct"),
                ("W 6000 Bluestein", 6000, 1500, W6000_NF, 4, False, "istft_bluestein"),
                ("W 10000 cluster", 10000, 2500, W10000_NF, 1, False, "istft_cluster"),
                ("W 10000 direct sum", 10000, 2500, W10000_NF, 1, False, "istft_direct"),
                ("W 20000 cluster", 20000, 5000, W20000_NF, 1, False, "istft_cluster"),
                ("W 40000 cluster", 40000, 10000, W40000_NF, 1, False, "istft_cluster"),
                ("W 10000 cluster_mixed", 10000, 2500, W10000_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 20000 cluster_mixed", 20000, 5000, W20000_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 40000 cluster_mixed", 40000, 10000, W40000_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 14000 cluster_mixed", 14000, 3500, W14000_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 14000 cluster", 14000, 3500, W14000_NF, 1, False, "istft_cluster"),
                ("W 56000 cluster_mixed", 56000, 14000, W56000_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 56000 cluster", 56000, 14000, W56000_NF, 1, False, "istft_cluster"),
                ("W 11025 cluster_mixed", 11025, 2205, W11025_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 11025 cluster", 11025, 2205, W11025_NF, 1, False, "istft_cluster"),
                ("W 22050 cluster_mixed", 22050, 4410, W22050_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 22050 cluster", 22050, 4410, W22050_NF, 1, False, "istft_cluster"),
                ("W 44100 cluster_mixed", 44100, 11025, W44100_NF, 1, False,
                 "istft_cluster_mixed"),
                ("W 44100 cluster", 44100, 11025, W44100_NF, 1, False, "istft_cluster"),
                ("W 16384 cluster_dit", 16384, 2048, W16384_NF, 4, True, "istft_cluster_dit"),
                ("W 16384 Bluestein", 16384, 2048, W16384_NF, 4, False, "istft_cluster"),
                ("W 32768 cluster_dit", 32768, 4096, W32768_NF, 4, True, "istft_cluster_dit"),
                ("W 32768 Bluestein", 32768, 4096, W32768_NF, 4, False, "istft_cluster"),
                ("W 65536 cluster_dit", 65536, 16384, W65536_NF, 1, False, "istft_cluster_dit"),
                ("W 65536 Bluestein", 65536, 16384, W65536_NF, 1, False, "istft_cluster"))
ISTFT_NAMES = ("istft", "istft_split", "istft_bluestein", "istft_cluster", "istft_cluster_dit",
               "istft_cluster_mixed", "istft_level2", "istft_level2_direct", "istft_direct")
# the direct transform's rows and the Bluestein rows forced at their shapes
ISTFT_DIT_AB = (("W 16384 cluster_dit", "W 16384 Bluestein"),
                ("W 32768 cluster_dit", "W 32768 Bluestein"),
                ("W 65536 cluster_dit", "W 65536 Bluestein"),
                ("W 10000 cluster_mixed", "W 10000 cluster"),
                ("W 20000 cluster_mixed", "W 20000 cluster"),
                ("W 40000 cluster_mixed", "W 40000 cluster"),
                ("W 14000 cluster_mixed", "W 14000 cluster"),
                ("W 56000 cluster_mixed", "W 56000 cluster"),
                ("W 11025 cluster_mixed", "W 11025 cluster"),
                ("W 22050 cluster_mixed", "W 22050 cluster"),
                ("W 44100 cluster_mixed", "W 44100 cluster"))
# the mixed cluster's sizes on clusters of 5 and 7 blocks, whose clusters at
# once phase 7 reads beside CLUSTERS_AT_ONCE: (nfft, hop)
MIXED_OCCUPANCY_ONLY = ((30870, 6174), (16807, 2401))
# the cluster routes' codes of csrc/istft.cu::istft_cluster_occupancy
CLUSTER_ROUTES = {"cluster": 0, "cluster_dit": 1, "cluster_mixed": 2}
# phase 7b: the Wiener+iSTFT at even sizes up to 8192 that are not powers
# of two, 4 stems of a 30 s track, bf16 y: (key, nfft, hop, nf, the kernel
# it must launch). The split at W 768 and 1280, Bluestein run backwards at W
# 1000, on the level at W 6000 and with frame pairs at W 8190, hop 910 (two
# carries do not fit beside the level's tables), the direct sum they
# replaced forced at W 768 and 1000.
WIENER_OFFCORE_SHAPES = (
    ("W 768 split", 768, 256, W768_NF, "wiener_istft_split"),
    ("W 1280 split", 1280, 320, W1280_NF, "wiener_istft_split"),
    ("W 1000 Bluestein", 1000, 250, W1000_NF, "wiener_istft_bluestein"),
    ("W 6000 Bluestein", 6000, 1500, W6000_NF, "wiener_istft_bluestein"),
    ("W 8190 Bluestein frame pairs", 8190, 910, W8190_NF, "wiener_istft_bluestein"),
    ("W 768 direct sum", 768, 256, W768_NF, "wiener_istft_direct"),
    ("W 1000 direct sum", 1000, 250, W1000_NF, "wiener_istft_direct"),
)
# phase 3c: the Wiener+iSTFT past 8192 points, 4 stems of a 30 s track, bf16
# y: (key, nfft, hop, nf, the kernel it must launch). The direct transform on
# a cluster at the reference's 16 384 and 32 768, the same on the 7-smooth
# block core at W 10 000 (C 2), 20 000 (C 4), 14 000 (C 2 of n 7000, a
# radix-7 pass) and 22 050 (C 3 of n 7350), each "auto"'s route there;
# Bluestein's cluster, which both replaced, forced at 16 384, 10 000, 20 000,
# 14 000 and 22 050.
WIENER_CLUSTER_SHAPES = (
    ("W 16384", 16384, 2048, W16384_NF, "wiener_istft_cluster_dit"),
    ("W 32768", 32768, 4096, W32768_NF, "wiener_istft_cluster_dit"),
    ("W 10000", 10000, 2500, W10000_NF, "wiener_istft_cluster_mixed"),
    ("W 20000", 20000, 5000, W20000_NF, "wiener_istft_cluster_mixed"),
    ("W 14000", 14000, 3500, W14000_NF, "wiener_istft_cluster_mixed"),
    ("W 22050", 22050, 4410, W22050_NF, "wiener_istft_cluster_mixed"),
    ("W 16384 Bluestein", 16384, 2048, W16384_NF, "wiener_istft_cluster"),
    ("W 10000 Bluestein", 10000, 2500, W10000_NF, "wiener_istft_cluster"),
    ("W 20000 Bluestein", 20000, 5000, W20000_NF, "wiener_istft_cluster"),
    ("W 14000 Bluestein", 14000, 3500, W14000_NF, "wiener_istft_cluster"),
    ("W 22050 Bluestein", 22050, 4410, W22050_NF, "wiener_istft_cluster"),
)
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


def profile_ms(fn, reps: int = 10, warmup: int = 3, sessions: int = 3) -> dict:
    """Device time per call of ``fn`` under ``torch.profiler`` over ``reps``
    calls: every kernel's and copy's own device time summed, in all and by
    name. A session that recorded no device work is run again, up to
    ``sessions`` in all (the trace on the card's machine has dropped a
    whole session's kernels: the adadelta leaf's, in a run that timed it
    before and after); ``device_ms`` is None where none saw any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / reps
        if by_name:
            break
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


# phase 5's STFT launches: (key, the kernel it must launch, W, hop, batches,
# forced dense). The split kernel at m = 3 and 5, Bluestein at W 1000, on
# the level at W 6000 and on a cluster at W 12 288 (4 blocks), W 20 000 (8
# blocks), W 40 000 and W 65 536 (16 blocks), the dense kernel at their
# shapes (forced: the time each replaces; it still serves past 65 536; at W
# 40 000 its matrices are 6.4 GB, so that row is timed in fewer calls).
STFT_SHAPES = (
    ("stft", "stft", 1024, 512, (32, 128), False),
    ("stft_split", "stft_split", 768, 256, (32,), False),
    ("stft_split W 1280", "stft_split", 1280, 320, (32,), False),
    ("stft_bluestein", "stft_bluestein", 1000, 250, (32,), False),
    ("stft_bluestein W 6000", "stft_bluestein", 6000, 1500, (32,), False),
    ("stft_cluster", "stft_cluster", 12288, 3072, (32,), False),
    ("stft_cluster W 20000", "stft_cluster", 20000, 5000, (32,), False),
    ("stft_cluster W 40000", "stft_cluster", 40000, 10000, (32,), False),
    ("stft_cluster W 65536", "stft_cluster", 65536, 16384, (32,), False),
    ("stft_dft W 12288", "stft_dft", 12288, 3072, (32,), True),
    ("stft_dft W 40000", "stft_dft", 40000, 10000, (32,), True),
    ("stft_dft W 768", "stft_dft", 768, 256, (32,), True),
    ("stft_dft W 1280", "stft_dft", 1280, 320, (32,), True),
    ("stft_dft W 1000", "stft_dft", 1000, 250, (32,), True),
    ("stft_dft W 6000", "stft_dft", 6000, 1500, (32,), True),
)


def stft_fn(dense: bool):
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_dft_pallas, stft_pallas

    return stft_dft_pallas if dense else stft_pallas


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
    """Device ms of phase 5's ("stft": every ``STFT_SHAPES`` launch) or
    phase 11's ("ct_stft") kernels and of ``torch.stft`` on the same frames,
    at their shapes, by :func:`profile_ms`."""
    import torch
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
    if kind == "level2":
        return child_level2_times(device, gen, pair)
    if kind == "ct_stft":
        x = 0.3 * torch.randn(1, MR_SAMPLES, generator=gen, device=device)
        res = {}
        for key, nfft, hop, kernel in CT_STFT_SHAPES:
            w = sinebell(nfft)
            padded = _pad_signal(x, nfft, hop)
            wt = torch.from_numpy(w.astype("float32")).to(device)
            fn = ct_fn(kernel)
            res[key] = pair(lambda: fn(x, w, hop),
                            lambda: torch.stft(padded, nfft, hop, window=wt, center=False,
                                               return_complex=True))
        return res
    res = {}
    for name, _, win, hop, batches, dense in STFT_SHAPES:
        per_b = {}
        fn = stft_fn(dense)
        # the dense kernel past DIRECT_MAX_NFFT (0.15 s a call, 6.4 GB of
        # matrices made on the host first) is not profiled: its events time
        # (phase 5) stands, its device time is "not measured"
        huge = dense and win > DIRECT_MAX_NFFT
        for B in batches:
            x, w, padded, wt = stft_inputs(B, win, hop, device, gen)
            k = {"device_ms": None, "by_kernel": {}} if huge else profile_ms(lambda: fn(x, w, hop))
            lib = profile_ms(lambda: torch.stft(padded, win, hop, window=wt, center=False,
                                                return_complex=True))
            per_b[B] = {"device_ms": k["device_ms"], "kernels": k["by_kernel"],
                        "library_device_ms": lib["device_ms"],
                        "library_kernels": lib["by_kernel"]}
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
    res = {}
    for name, nfft, hop, nf, N, ct, kernel in ISTFT_SHAPES:
        w, L, re, im = istft_inputs(nfft, hop, nf, N, device, gen)
        kern = istft_fn(ct, kernel, nfft)
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
    (highres4096 and dsd100, phase 3's inputs; the cluster, phase 3c's;
    phase 7b's split, Bluestein and forced direct sum), the Wiener mask kernel (the
    dsd100 pallas route's shape), the band decode kernel (phase 11's shape,
    the prepared operand), the streamed band decode kernel (phase 11b's
    shapes) and the fused adadelta kernel (phase 5's two leaves)."""
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_direct_pallas, wiener_istft
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
    for N, Tp, W, C2, kh, I in BAND_STREAM_SHAPES:  # the streamed kernel (phase 11b's shapes)
        T = Tp + kh - 1
        z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=device)).to(torch.bfloat16)
        band = band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=device), T)
        res[f"band_decode_stream C2 {C2} I {I}"] = profile_ms(
            lambda: band_decode_wmajor(z, band, T))["device_ms"]
        del z, band
    total = 0.0
    for shape in ((128, 518400), (129600, 128)):
        p = 0.01 * torch.randn(shape, generator=gen, device=device)
        g = 1e-3 * torch.randn(shape, generator=gen, device=device)
        a = 1e-6 * torch.rand(shape, generator=gen, device=device)
        d = 1e-6 * torch.rand(shape, generator=gen, device=device)
        ms = profile_ms(lambda: fused_adadelta_leaf(p, g, a, d, 1.0, 0.95, 1e-6))["device_ms"]
        total = None if total is None or ms is None else total + ms
    res["fused_adadelta"] = total
    del p, g, a, d
    # past 8192 points: the clusters and Bluestein's forced (phase 3c's shapes)
    for key, nfft, hop, nf, kernel in WIENER_CLUSTER_SHAPES:
        fn = wiener_fn(kernel)[0]
        w, L, y, re, im = wiener_inputs(nfft, hop, nf, 4, device, gen)
        res[f"wiener_istft {key}"] = profile_ms(lambda: fn(y, re, im, w, hop, L))["device_ms"]
        del y, re, im
    # last: measured before the Wiener mask kernel, the direct sum at W 768
    # left that kernel's profiler session with no device work recorded
    # (device_ms None)
    for key, nfft, hop, nf, kernel in WIENER_OFFCORE_SHAPES:
        fn = wiener_direct_pallas if kernel == "wiener_istft_direct" else wiener_istft
        w, L, y, re, im = wiener_inputs(nfft, hop, nf, 4, device, gen)
        res[f"wiener_istft {key}"] = profile_ms(lambda: fn(y, re, im, w, hop, L))["device_ms"]
        del y, re, im
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
    """compute_dtype="bfloat16" at B segments: "auto" takes the plain bf16
    decode (the bf16 won table is empty), while float32 takes the fused
    kernel at highres4096 B 49; then the fused kernel forced
    (decoder_impl="bandconv_pallas", its bf16 operands passed as float32),
    its sources against the plain bf16 decode's (decoder_impl="bandconv")
    on the same random magnitudes, and both forward times."""
    import dataclasses

    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.models import ConvSep
    from convsep_tpu_torch.models.convsep import resolve_decoder_impl

    cfg = dataclasses.replace(preset.model, compute_dtype="bfloat16")
    auto = resolve_decoder_impl(cfg, device, B)
    f32 = resolve_decoder_impl(preset.model, device, B)
    if auto != "bandconv" or f32 != "bandconv_pallas":
        raise AssertionError(f"\"auto\" routes bf16 compute to {auto} at B {B} (want "
                             f"bandconv), float32 to {f32} (want bandconv_pallas)")
    forced = dataclasses.replace(cfg, decoder_impl="bandconv_pallas")
    model = ConvSep(forced, state, device=device).prepare_inference()
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
    log(f"  bf16 compute B {B}: \"auto\" {auto} (float32 {f32}); forced bandconv_pallas, "
        f"launches {launches['fused_decode']}; sources vs the plain bf16 decode max_abs_err "
        f"{e:.3e} (tol {TOL_BF16_COMPUTE * scale:.3e}); forward forced kernel {ms:.3f} ms, "
        f"plain bf16 (\"auto\") {plain_ms:.3f} ms")
    if launches["fused_decode"] != 1 or not (e <= TOL_BF16_COMPUTE * scale
                                             and torch.isfinite(got).all()):
        raise AssertionError(f"bf16 compute B {B}: launches {launches}, error {e} "
                             f"(tol {TOL_BF16_COMPUTE * scale})")
    return {"launches": launches, "max_abs_err": e, "max_abs_plain": scale, "ms": ms,
            "plain_ms": plain_ms, "B": B, "auto_route": auto}


def wiener_inputs(nfft: int, hop: int, nf: int, S: int, device, gen, B: int = 1,
                  ydt: str = "bfloat16"):
    """A batch of B tracks, each its own random mixture and magnitudes
    (``ydt``: bf16, the model's mask tail, or float32), so a kernel that
    reads another track's spectrum or y disagrees."""
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
    return w, L, y.to(getattr(torch, ydt)), re, im


WIENER_NAMES = ("wiener_istft", "wiener_istft_ny", "wiener_istft_cluster",
                "wiener_istft_ny_cluster", "wiener_istft_cluster_dit",
                "wiener_istft_ny_cluster_dit", "wiener_istft_cluster_mixed",
                "wiener_istft_ny_cluster_mixed", "wiener_istft_split", "wiener_istft_ny_split",
                "wiener_istft_bluestein", "wiener_istft_ny_bluestein", "wiener_istft_direct",
                "wiener_istft_ny_direct")


def phase_wiener(name: str, nfft: int, hop: int, nf: int, S: int, device, gen,
                 B: int = 1, ydt: str = "bfloat16", kernel: str = "wiener_istft",
                 chain: bool = False) -> dict:
    """Wiener+iSTFT kernel vs plain: p ∈ {1, 2}, conserve_last, f32/int16,
    on B tracks at once (the stream path's batches); each call one launch
    of ``kernel`` (:func:`wiener_fn`: "wiener_istft_direct" through
    ``wiener_direct_pallas``, which forces the direct sum,
    "wiener_istft_cluster" through ``wiener_bluestein_cluster_pallas``,
    which forces Bluestein's cluster). On a cluster (past 8192 points) also
    against the float64 synthesis of the same float32 masks
    (:func:`wiener64`) within ``TOL_CLUSTER_F32`` × max|stem|. With
    ``chain``, also the masked chain's time (the f32 mask, then the iSTFT
    ``istft_matmul``'s "auto" resolves) and ``torch.istft``'s of the
    masked spectra (``library_ms``)."""
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft_plain

    fn, plan_of = wiener_fn(kernel)
    w, L, y, re, im = wiener_inputs(nfft, hop, nf, S, device, gen, B, ydt)
    if B > 1:
        name = f"{name} B {B}"
    worst, worst64 = 0.0, None
    for kw in ({"p": 1.0}, {"p": 2.0}, {"p": 1.0, "conserve_last": True}):
        for out in ("float32", "int16"):
            before = dict(kernels.LAUNCHES)
            got = fn(y, re, im, w, hop, L, output_dtype=out, **kw)
            want = wiener_istft_plain(y, re, im, w, hop, L, output_dtype=out, **kw)
            torch.cuda.synchronize()
            moved = {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES}
            if moved != {k: int(k == kernel) for k in WIENER_NAMES}:
                raise AssertionError(f"wiener_istft {name}: launched {moved}, want one {kernel}")
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"wiener_istft {name} {kw} {out}: non-finite output")
            e = (got.float() - want.float()).abs().max().item()
            tol = TOL_WIENER_I16 if out == "int16" else TOL_WIENER_F32
            unit = "LSB" if out == "int16" else ""
            log(f"  wiener {name} {kw} {out}: max_abs_err {e:.3e}{unit} (tol {tol})")
            if not e <= tol:
                raise AssertionError(f"wiener_istft {name} {kw} {out}: {e} > {tol}")
            if "_cluster" in kernel:
                ref = wiener64(y, re, im, w, hop, L, output_dtype=out, **kw)
                e64 = (got.float() - ref.float()).abs().max().item()
                tol64 = (TOL_WIENER_I16 if out == "int16"
                         else TOL_CLUSTER_F32 * ref.abs().max().item())
                log(f"  wiener {name} {kw} {out}: {e64:.3e}{unit} from the float64 synthesis "
                    f"(tol {tol64:.3e})")
                if not e64 <= tol64:
                    raise AssertionError(f"wiener_istft {name} {kw} {out}: {e64} > {tol64} from "
                                         f"the float64 synthesis")
                if out == "float32":
                    worst64 = max(worst64 or 0.0, e64 / ref.abs().max().item())
                del ref
            if out == "float32":
                worst = max(worst, e)
    ms = cuda_ms(lambda: fn(y, re, im, w, hop, L))
    plain_ms = cuda_ms(lambda: wiener_istft_plain(y, re, im, w, hop, L))
    us = host_us(lambda: fn(y, re, im, w, hop, L))
    plan = plan_of(B, S, nf, nfft, hop)
    b = bound(y.element_size() * y.numel() + 8 * re.numel() + 4 * B * S * L,
              fft_flops(B * S * nf, nfft) + 4 * y.numel())
    log(f"  wiener {name} p=1 f32 out: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); no single PyTorch call computes it; "
        f"wrapper host {us:.1f} us per call; plan ({plan.route}"
        f"{', frame pairs' if plan.frame_pairs else ''}): {plan.groups} groups x {plan.rounds} "
        f"rounds, {plan.rows} hop rows, {plan.blocks} blocks ({plan.waves} wave(s)), "
        f"{plan.smem_bytes} B shared memory")
    r = {"max_abs_err": worst, "rel_err_float64": worst64, "ms": ms, "plain_ms": plain_ms,
         **b, "library_ms": None, "host_us": us, "B": B, "y": ydt,
         "plan": dataclasses.asdict(plan)}
    if chain:
        algorithm, chain_ms = masked_chain_ms(nfft, hop, w, L, y, re, im, device)
        r.update(chain=algorithm, chain_ms=chain_ms,
                 library_ms=masked_istft_ms(nfft, hop, nf, w, L, y, re, im, device),
                 library=f"torch.istft of the {B * S} masked spectra (the synthesis alone)")
        log(f"  wiener {name}: the masked chain (mask + {algorithm}) {r['chain_ms']:.4f} ms, "
            f"torch.istft of the masked spectra {r['library_ms']:.4f} ms")
    return r


def wiener_fn(kernel: str):
    """The wrapper that launches Wiener+iSTFT ``kernel`` at any size it
    takes, and the plan it launches: ``wiener_istft`` and ``wiener_plan``
    (its route), or the forced direct sum and Bluestein's forced cluster."""
    from convsep_tpu_torch.dsp.cuda import fft_plan
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import (
        wiener_bluestein_cluster_pallas,
        wiener_direct_pallas,
        wiener_istft,
    )

    return {"wiener_istft_direct": (wiener_direct_pallas, fft_plan.wiener_direct_plan),
            "wiener_istft_cluster": (wiener_bluestein_cluster_pallas,
                                     fft_plan.wiener_cluster_plan)}.get(
        kernel, (wiener_istft, fft_plan.wiener_plan))


def masked_chain_ms(nfft: int, hop: int, w, L: int, y, re, im, device) -> tuple[str, float]:
    """The masked chain "auto" takes where it does not take the Wiener+iSTFT
    kernel (the f32 mask, then the iSTFT ``istft_matmul``'s "auto"
    resolves): its algorithm and its time, ms by events."""
    from convsep_tpu_torch.dsp.dft import istft_wiener, resolve_istft

    chain = resolve_istft("auto", nfft, nfft, hop, device)
    return chain, cuda_ms(lambda: istft_wiener(y, re, im, w, hop, L, algorithm=chain))


def masked_istft_ms(nfft: int, hop: int, nf: int, w, L: int, y, re, im, device) -> float:
    """``torch.istft`` of the masked spectra (the f32 Wiener mask of ``y``
    times the mixture): the synthesis alone, ms by events."""
    import numpy as np
    import torch
    from convsep_tpu_torch.models.masks import wiener_mask

    mask = wiener_mask(y, axis=-3)
    spec = torch.complex(mask * re.unsqueeze(-3), mask * im.unsqueeze(-3))
    spec = spec.reshape(-1, nf, nfft // 2 + 1).transpose(-1, -2)
    del mask
    wt = torch.from_numpy(w.astype(np.float32)).to(device)
    return cuda_ms(lambda: torch.istft(spec, nfft, hop, window=wt, center=True, length=L))


def wiener_ny_check(name: str, w, hop: int, L: int, y, re, im, ny, kernel: str,
                    fn=None) -> float:
    """The Wiener+iSTFT kernel's Nyquist-row input against its plain version
    (p = 1 and 2, conserve_last, f32 and int16) and, bit for bit, against
    the same kernel fed the concatenated spectrum; each call (through
    ``fn``, ``wiener_istft`` by default) one launch of ``kernel``. Returns
    the worst float32 error."""
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft, wiener_istft_plain

    fn = fn or wiener_istft
    full_re = torch.cat([re, ny[..., None]], -1)
    full_im = torch.cat([im, torch.zeros_like(ny)[..., None]], -1)
    worst = 0.0
    for kw in ({"p": 1.0}, {"p": 2.0}, {"p": 1.0, "conserve_last": True}):
        for out in ("float32", "int16"):
            before = dict(kernels.LAUNCHES)
            got = fn(y, re, im, w, hop, L, output_dtype=out, ny=ny, **kw)
            torch.cuda.synchronize()
            moved = {k: kernels.LAUNCHES[k] - before[k] for k in WIENER_NAMES}
            if moved != {k: int(k == kernel) for k in WIENER_NAMES}:
                raise AssertionError(f"wiener ny {name}: launched {moved}, want one {kernel}")
            cat = fn(y, full_re, full_im, w, hop, L, output_dtype=out, **kw)
            want = wiener_istft_plain(y, re, im, w, hop, L, output_dtype=out, ny=ny, **kw)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            eq = bool(torch.equal(got, cat))
            tol = TOL_WIENER_I16 if out == "int16" else TOL_WIENER_F32
            log(f"  wiener ny {name} {kw} {out}: max_abs_err {e:.3e} (tol {tol}), equal to the "
                f"concatenated input's: {eq}")
            if not (e <= tol and eq and torch.isfinite(got.float()).all()):
                raise AssertionError(f"wiener_istft ny {name} {kw} {out}: {e}, bit-equal {eq}")
            if out == "float32":
                worst = max(worst, e)
    return worst


def phase_wiener_cluster(device, gen) -> dict:
    """The Wiener+iSTFT past 8192 points, 4 stems of a 30 s track
    (``WIENER_CLUSTER_SHAPES``). At each shape of a route, the reference
    kernel's 16 384 (hop 2048) and 32 768 (hop 4096) on the direct transform
    on a cluster of 2 and 4 blocks ("wiener_istft_cluster_dit"), W 10 000
    (hop 2500), 20 000 (hop 5000), 14 000 (hop 3500) and 22 050 (hop 4410)
    on the same over the 7-smooth block core, C 2, 4, 2 and 3
    ("wiener_istft_cluster_mixed"): bf16
    and f32 y as phase
    3 (one launch a call, also held to the float64 synthesis), the
    Nyquist-row input (at 16 384 the forward STFT kernel's own pair) as phase
    11 (one launch of the ``_ny_`` kernel), ``torch.istft`` of the masked
    spectra, and the A/B that keys "auto": the kernel against the masked
    chain "auto" takes otherwise (the f32 mask, then ``istft_matmul``'s own
    "auto": the iSTFT kernel on a cluster at the powers of two, the factored
    products at 10 000, 20 000 and 22 050, the direct ones at 14 000).
    Bluestein's cluster ("wiener_istft_cluster"), which both replaced, forced
    at 16 384, 10 000, 20 000, 14 000 and 22 050 (bf16 y; at 20 000 also f32
    y and its Nyquist-row input). The clusters of 2 to 6 the card holds at
    once. It fails if a plan in
    ``WIENER_CLUSTER_WON`` loses by more than ``WIENER_SPREAD``."""
    import ctypes

    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda import fft_plan
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import WIENER_CLUSTER_WON
    from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas

    res = {}
    for key, nfft, hop, nf, kernel in WIENER_CLUSTER_SHAPES:
        forced = kernel == "wiener_istft_cluster"
        if forced:
            log(f"  Bluestein's cluster forced at {key.split()[1]}, the kernel the direct "
                "transform replaced:")
        r = phase_wiener(key, nfft, hop, nf, 4, device, gen, kernel=kernel)
        res[key] = r
        if forced and nfft != 20000:
            continue
        r["float32_y"] = phase_wiener(key + " f32 y", nfft, hop, nf, 4, device, gen,
                                      ydt="float32", kernel=kernel)
        w, L, y, re, im = wiener_inputs(nfft, hop, nf, 4, device, gen)
        if nfft == 16384:  # the forward STFT kernel's own Nyquist-separate pair
            x = 0.3 * torch.randn(1, L, generator=gen, device=device)
            re_b, im_b, ny = stft_ct_pallas(x, w, hop)
        else:  # past the forward kernel's 16 384: the bodies cut from the full spectrum
            re_b, im_b, ny = (re[..., :-1].contiguous(), im[..., :-1].contiguous(),
                              re[..., -1].contiguous())
        r["ny_max_abs_err"] = wiener_ny_check(key, w, hop, L, y, re_b, im_b, ny,
                                              kernel.replace("_istft", "_istft_ny"),
                                              wiener_fn(kernel)[0])
        if not forced:
            r.update(wiener_ab(key, nfft, hop, w, L, y, re, im, device, WIENER_CLUSTER_WON,
                               "WIENER_CLUSTER_WON"))
            r.update(library_ms=masked_istft_ms(nfft, hop, nf, w, L, y, re, im, device),
                     library="torch.istft of the 4 masked spectra (the synthesis alone)")
            log(f"  wiener {key}: torch.istft of the masked spectra {r['library_ms']:.4f} ms")
        del y, re, im, re_b, im_b, ny
        torch.cuda.empty_cache()
    lib = kernels.library()
    for nfft, hop, nf, launch, c in (
            (16384, 2048, W16384_NF, lib.wiener_cluster_dit_launch, 2),
            (10000, 2500, W10000_NF, lib.wiener_cluster_mixed_launch, 2),
            (20000, 5000, W20000_NF, lib.wiener_cluster_mixed_launch, 4),
            (22050, 4410, W22050_NF, lib.wiener_cluster_mixed_launch, 3),
            (30870, 6174, 100, lib.wiener_cluster_mixed_launch, 5),
            (30618, 10206, 100, lib.wiener_cluster_mixed_launch, 6)):
        plan = fft_plan.wiener_plan(1, 4, nf, nfft, hop)
        sched = ((fft_plan.mixed_schedule(fft_plan.mixed_radices(nfft // c)),)
                 if plan.route == "cluster_mixed" else ())
        active = ctypes.c_int(0)
        kernels.check(launch(
            None, 0, None, None, None, None, None, None, None, 0, 1, 4, nf, nfft, hop, 1,
            plan.rounds, *sched, 0, ctypes.c_float(1e-8), 0, ctypes.byref(active), None),
            plan.route)
        res[f"clusters_at_once_{plan.route}_{c}"] = {"card": active.value,
                                                      "plan": fft_plan.CLUSTERS_AT_ONCE[c]}
        log(f"  clusters of {c} at once ({plan.route}, W {nfft}): the card's {active.value}, "
            f"CLUSTERS_AT_ONCE[{c}] {fft_plan.CLUSTERS_AT_ONCE[c]}")
        if (plan.cluster, active.value) != (c, fft_plan.CLUSTERS_AT_ONCE[c]):
            raise AssertionError(f"the card holds {active.value} clusters of {plan.cluster} at "
                                 f"once ({plan.route}, W {nfft}), the plan weighs "
                                 f"{fft_plan.CLUSTERS_AT_ONCE[c]} of {c}")
    return res


def wiener_ab(key: str, nfft: int, hop: int, w, L: int, y, re, im, device, won,
              won_name: str) -> dict:
    """The A/B that keys "auto": the Wiener+iSTFT kernel against the masked
    chain "auto" takes otherwise (the f32 mask, then ``istft_matmul``'s own
    "auto"), p = 1, float32 out. It fails if "auto" disagrees with ``won``
    (the frozenset named ``won_name``) or takes the kernel where it lost by
    more than ``WIENER_SPREAD``."""
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import wiener_istft
    from convsep_tpu_torch.dsp.dft import resolve_masked_synthesis

    chain, chain_ms = masked_chain_ms(nfft, hop, w, L, y, re, im, device)
    auto = resolve_masked_synthesis("auto", nfft, nfft, hop, 1.0, device)
    r = {"chain_ms": chain_ms, "ms_ab": cuda_ms(lambda: wiener_istft(y, re, im, w, hop, L))}
    r.update(chain=chain, auto_route=auto, won=r["ms_ab"] < r["chain_ms"])
    log(f"  wiener {key} A/B: kernel {r['ms_ab']:.4f} ms against the masked chain "
        f"(mask + {chain}) {r['chain_ms']:.4f} ms: {'won' if r['won'] else 'lost'}; "
        f"\"auto\" takes {auto}")
    if (nfft, hop) in won and r["ms_ab"] > (1 + WIENER_SPREAD) * r["chain_ms"]:
        raise AssertionError(f"\"auto\" takes the Wiener+iSTFT at {key}, hop {hop}, where it "
                             f"lost: {r['ms_ab']} ms > {r['chain_ms']} ms")
    if (auto == "ct_pallas_wiener") != ((nfft, hop) in won):
        raise AssertionError(f"\"auto\" at {key}: {auto}, {won_name} says otherwise")
    return r


def phase_wiener_offcore(device, gen) -> dict:
    """The Wiener+iSTFT at even sizes up to 8192 that are not powers of two
    (``WIENER_OFFCORE_SHAPES``: the split, Bluestein run backwards on the
    core, on the level and with frame pairs, the direct sum forced), 4 stems
    of a 30 s track, bf16 y, as phase 3 (one launch of the row's kernel a
    call), beside ``torch.istft`` of the 4 masked spectra (the synthesis
    alone); at the split's and Bluestein's rows the A/B against the masked
    chain that keys "auto" (``WIENER_SPLIT_BLUESTEIN_WON``); the Nyquist-row
    input at W 768 and at W 8190's frame pairs."""
    import torch
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import WIENER_SPLIT_BLUESTEIN_WON

    res = {}
    for key, nfft, hop, nf, kernel in WIENER_OFFCORE_SHAPES:
        r = phase_wiener(key, nfft, hop, nf, 4, device, gen, kernel=kernel)
        w, L, y, re, im = wiener_inputs(nfft, hop, nf, 4, device, gen)
        r.update(library_ms=masked_istft_ms(nfft, hop, nf, w, L, y, re, im, device),
                 library="torch.istft of the 4 masked spectra (the synthesis alone)")
        log(f"  wiener {key}: torch.istft of the masked spectra {r['library_ms']:.4f} ms")
        if kernel != "wiener_istft_direct":
            r.update(wiener_ab(key, nfft, hop, w, L, y, re, im, device,
                               WIENER_SPLIT_BLUESTEIN_WON, "WIENER_SPLIT_BLUESTEIN_WON"))
        if key in ("W 768 split", "W 8190 Bluestein frame pairs"):
            re_b, im_b, ny = (re[..., :-1].contiguous(), im[..., :-1].contiguous(),
                              re[..., -1].contiguous())
            r["ny_max_abs_err"] = wiener_ny_check(key, w, hop, L, y, re_b, im_b, ny,
                                                  kernel.replace("_istft", "_istft_ny"))
            del re_b, im_b, ny
        res[key] = r
        del y, re, im
        torch.cuda.empty_cache()
    return res


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


def rfft64_stft(signal, window, hop: int):
    """``stft_pallas``'s function in float64: ``torch.fft.rfft`` of the same
    zero-padded frames times the float32 window, then rounded to float32
    (the plain version past ``DIRECT_MAX_NFFT`` and the reference every
    cluster STFT is held to)."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.stft import _pad_signal, frame_signal, num_frames

    win, hop = len(window), int(hop)
    x = signal.double()
    frames = frame_signal(_pad_signal(x, win, hop), win, hop, num_frames(x.shape[-1], hop))
    w = torch.from_numpy(np.asarray(window, np.float32).astype(np.float64)).to(x.device)
    spec = torch.fft.rfft(frames * w)
    return spec.real.float(), spec.imag.float()


def istft64(re, im, window, hop: int, length: int, output_dtype: str = "float32"):
    """``istft_pallas``'s function in float64 (nfft = the window): the
    inverse real FFT of the float32 spectra, times the window, overlap-add,
    the window-power normalization and the W/2 front trim, rounded to
    float32 or PCM16 once at the end (the plain version past
    ``DIRECT_MAX_NFFT`` and the reference every cluster iSTFT is held to)."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.istft import ola_norm, overlap_add
    from convsep_tpu_torch.utils.pcm import quantize_pcm16

    win, hop, nf = len(window), int(hop), int(re.shape[-2])
    w32 = np.asarray(window, np.float32)
    w = torch.from_numpy(w32.astype(np.float64)).to(re.device)
    frames = torch.fft.irfft(torch.complex(re.double(), im.double()), n=win) * w
    norm = torch.from_numpy(ola_norm(w32, w32, hop, nf).astype(np.float64)).to(re.device)
    out = (overlap_add(frames, hop) / norm)[..., win // 2: win // 2 + int(length)].float()
    return quantize_pcm16(out) if output_dtype == "int16" else out


def wiener64(y, re, im, window, hop: int, length: int, p: float = 1.0,
             conserve_last: bool = False, output_dtype: str = "float32", ny=None):
    """``wiener_istft``'s function with the synthesis in float64: the
    float32 Wiener mask (models/masks.py, as the kernel forms it) times the
    mixture, then :func:`istft64` per stem."""
    import torch
    from convsep_tpu_torch.models.masks import wiener_mask

    if ny is not None:
        re = torch.cat([re, ny.unsqueeze(-1)], -1)
        im = torch.cat([im, torch.zeros_like(ny).unsqueeze(-1)], -1)
    mask = wiener_mask(y, p=p, eps=1e-8, axis=-3, conserve_last=conserve_last)
    return istft64(mask * re.unsqueeze(-3), mask * im.unsqueeze(-3), window, hop, length,
                   output_dtype)


def stft_plain(x, w, hop: int):
    """The STFT's plain version at a phase 5 row: ``stft_pallas_plain`` up to
    ``DIRECT_MAX_NFFT``, the float64 transform past it."""
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas_plain

    return stft_pallas_plain(x, w, hop) if len(w) <= DIRECT_MAX_NFFT else rfft64_stft(x, w, hop)


def phase_stft(device, gen) -> dict:
    """The STFT kernels vs plain, each beside ``torch.stft(center=False)`` on
    the same padded signal (the same frames), with device and host times:
    the FFT kernel at the training step's shapes (mixtures B 32, stems B
    128; 14 336 samples, W 1024, hop 512 → 30 frames × 513 bins), the
    split kernel at W 768, hop 256 (3 · 256: 58 frames × 385 bins) and W
    1280, hop 320 (5 · 256: 47 × 641), Bluestein at W 1000, hop 250 (8 ·
    125: 60 × 501), on the level at W 6000, hop 1500 (12 × 3001), on a
    cluster at W 12 288, hop 3072 (7 × 6145) and W 20 000, hop 5000 (5 ×
    10 001), and the dense DFT kernel, forced, at the split's, Bluestein's
    and the cluster's W 12 288.
    Each call must launch its kernel once and no other STFT kernel. Past
    ``DIRECT_MAX_NFFT`` the plain version is the float64 STFT, and every
    cluster row is also held to it within ``TOL_CLUSTER_STFT``."""
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.dft import _forward_mats

    names = ("stft", "stft_split", "stft_bluestein", "stft_cluster", "stft_dft")
    out = {}
    for key, kernel, win, hop, batches, dense in STFT_SHAPES:
        fn = stft_fn(dense)
        huge = dense and win > DIRECT_MAX_NFFT  # 6.4 GB of matrices: fewer timed calls
        worst, ms, plain_ms, lib_ms, us, nbytes, flops = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
        for B in batches:
            x, w, padded, wt = stft_inputs(B, win, hop, device, gen)
            before = dict(kernels.LAUNCHES)
            re, im = fn(x, w, hop)
            re_p, im_p = stft_plain(x, w, hop)
            torch.cuda.synchronize()
            moved = {k: kernels.LAUNCHES[k] - before[k] for k in names}
            if moved != {k: int(k == kernel) for k in names}:
                raise AssertionError(f"{key} B {B}: launched {moved}, want one {kernel}")
            peak = max(re_p.abs().max().item(), im_p.abs().max().item())
            e = max((re - re_p).abs().max().item(), (im - im_p).abs().max().item())

            def library():
                return torch.stft(padded, win, hop, window=wt, center=False, return_complex=True)

            lib = library().transpose(-1, -2)  # (B, nf, bins)
            e_lib = max((lib.real - re_p).abs().max().item(), (lib.imag - im_p).abs().max().item())
            log(f"  {key} B {B}: re/im {tuple(re.shape)} max_abs_err {e:.3e} "
                f"(tol {TOL_STFT * peak:.3e}, max|X| {peak:.3e}); torch.stft {e_lib:.3e} from "
                f"the plain version")
            if not (e <= TOL_STFT * peak and torch.isfinite(re).all() and torch.isfinite(im).all()):
                raise AssertionError(f"{key} kernel B {B} disagrees: {e} > {TOL_STFT * peak}")
            if kernel == "stft_cluster":
                r64, i64 = rfft64_stft(x, w, hop)
                e64 = max((re - r64).abs().max().item(), (im - i64).abs().max().item())
                log(f"  {key} B {B}: {e64:.3e} from the float64 STFT (tol "
                    f"{TOL_CLUSTER_STFT * peak:.3e})")
                if not e64 <= TOL_CLUSTER_STFT * peak:
                    raise AssertionError(f"{key} B {B}: {e64} > {TOL_CLUSTER_STFT * peak} from "
                                         f"the float64 STFT")
                del r64, i64
            worst = max(worst, e)
            reps = dict(reps=1, rounds=3, warmup=0) if huge else {}
            t = cuda_ms(lambda: fn(x, w, hop), **reps)
            tp = cuda_ms(lambda: stft_plain(x, w, hop), **reps)
            tl = cuda_ms(library)
            h = host_us(lambda: fn(x, w, hop), reps=3 if huge else 200)
            log(f"  {key} B {B}: kernel {t:.4f} ms, plain {tp:.4f} ms, torch.stft {tl:.4f} ms; "
                f"wrapper host {h:.1f} us per call")
            ms, plain_ms, lib_ms, us = ms + t, plain_ms + tp, lib_ms + tl, us + h
            nf = re.shape[-2]
            nbytes += 4 * x.numel() + 8 * re.numel()
            flops += fft_flops(B * nf, win)  # what the transform needs, whatever the kernel runs
        b = bound(nbytes, flops)
        out[key] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b,
                    "library_ms": lib_ms, "host_us": us, "W": win, "hop": hop,
                    "B": list(batches)}
        if huge:
            _forward_mats.cache_clear()
            del re, im, re_p, im_p
            torch.cuda.empty_cache()
    dev = device_times("stft")["stft"]
    for key, *_ in STFT_SHAPES:
        r, d = out[key], dev[key]
        r.update(device_ms=d["device_ms"], library_device_ms=d["library_device_ms"])
        what = ("per training step (B 32 + B 128)" if key == "stft"
                else f"W {r['W']}, hop {r['hop']}, B 32")
        log(f"  {key.split()[0]} {what}: kernel {r['ms']:.4f} ms (device "
            f"{ms_str(d['device_ms'])}), plain {r['plain_ms']:.4f} ms, torch.stft {r['library_ms']:.4f} ms (device "
            f"{ms_str(d['library_device_ms'])}); bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); wrapper host {r['host_us']:.1f} us")
    for key, dense in (("stft_split", "stft_dft W 768"), ("stft_split W 1280", "stft_dft W 1280"),
                       ("stft_bluestein", "stft_dft W 1000"),
                       ("stft_bluestein W 6000", "stft_dft W 6000"),
                       ("stft_cluster", "stft_dft W 12288"),
                       ("stft_cluster W 40000", "stft_dft W 40000")):
        r, d = out[key], out[dense]
        r["dense_ms"], r["dense_device_ms"] = d["ms"], d["device_ms"]
        log(f"  {key}: {key.split()[0]} {r['ms']:.4f} ms (device {ms_str(r['device_ms'])}) against the "
            f"dense DFT kernel's {d['ms']:.4f} ms (device {ms_str(d['device_ms'])}) and "
            f"torch.stft's {r['library_ms']:.4f} ms (device {ms_str(r['library_device_ms'])})")
    log(f"  device kernels: {json.dumps(dev)}")
    return out


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


def train_preset(kernels_on: bool, name: str = "dsd100", **train_kw):
    """Preset ``name`` on the kernel route (fft_impl "pallas",
    optimizer_impl "fused") or the plain route ("matmul", "xla"); logs
    every step; ``train_kw`` overrides its training fields."""
    from convsep_tpu_torch.configs import get_preset

    p = get_preset(name)
    return dataclasses.replace(
        p,
        transform=dataclasses.replace(p.transform,
                                      fft_impl="pallas" if kernels_on else "matmul"),
        train=dataclasses.replace(p.train, **{
            "optimizer_impl": "fused" if kernels_on else "xla", "log_every_steps": 1,
            **train_kw}),
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


def route_check(params, mix, stems, wiener_eps: float, device, name: str = "dsd100") -> dict:
    """One step of preset ``name``'s kernel route, its plain route and the
    two witnesses (:func:`witness_stfts`) from the same parameters, zero
    accumulators and the same batch, at ``wiener_eps``. Returns each of the
    kernel route's and the witnesses' gaps to the plain route: loss and
    grad_norm (relative), gradients and weights after the step (absolute,
    in units of max|g|), the mixture's spectrum (in units of its peak); and
    whether the fused step is bit-exact."""
    import torch
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas
    from convsep_tpu_torch.dsp.dft import stft_matmul
    from convsep_tpu_torch.dsp.windows import hann, sinebell

    def at_eps(p):
        return dataclasses.replace(p, sep=dataclasses.replace(p.sep, wiener_eps=wiener_eps))

    kern, plain = at_eps(train_preset(True, name)), at_eps(train_preset(False, name))
    t = plain.transform
    w = (sinebell if t.window == "sinebell" else hann)(t.frame_size)
    witnesses = witness_stfts()
    rows = mix.reshape(-1, mix.shape[-1])  # a stereo mixture's ears as rows
    spec = {"plain": stft_matmul(rows, w, t.hop_size, algorithm="direct"),
            "kernel": stft_pallas(rows, w, t.hop_size),
            **{k: f(rows, w, t.hop_size) for k, f in witnesses.items()}}
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
        run = fit_losses(trainer, ds, TRAIN_STEPS, metrics, device)
    losses, launches = run["losses"], run["launches"]
    log(f"  fit: {trainer.state.step} steps in {run['fit_s']:.2f} s, launches {launches}")
    log(f"  losses by logged step: {[round(v, 6) for v in losses]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  mean loss, first 5 logged steps {first:.6f}, last 5 {last:.6f}")
    if trainer.state.step != TRAIN_STEPS or len(losses) < 10:
        raise AssertionError(f"fit took {trainer.state.step} steps, logged {len(losses)}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"training loss is not finite and falling: {losses}")
    # two STFTs a step (the mixtures, the stems), all on the FFT kernel
    if not (launches["stft"] == 2 * TRAIN_STEPS and launches["stft_split"] == 0
            and launches["stft_bluestein"] == 0 and launches["stft_cluster"] == 0
            and launches["stft_dft"] == 0 and launches["fused_adadelta"] > 0):
        raise AssertionError(f"training path missed a kernel: {launches}")
    log(f"  fit: median step_time_ms {run['step_time_ms']:.3f}, rtf_train "
        f"{run['rtf_train']:.1f} (the Trainer's log)")
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


def forced_bluestein(kernel: str, nfft: int) -> bool:
    """An ``ISTFT_SHAPES`` row that forces Bluestein's cluster at a power of
    two or a 5-smooth size in ``ISTFT_MIXED_WON``, where the wrapper takes
    the direct transform."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import ISTFT_MIXED_WON

    return kernel == "istft_cluster" and (nfft & (nfft - 1) == 0 or nfft in ISTFT_MIXED_WON)


def forced_mixed(kernel: str, nfft: int) -> bool:
    """An ``ISTFT_SHAPES`` row of the mixed cluster at a size off
    ``ISTFT_MIXED_WON``, where the wrapper takes Bluestein's cluster: the
    row forces the mixed one, to time it."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import ISTFT_MIXED_WON

    return kernel == "istft_cluster_mixed" and nfft not in ISTFT_MIXED_WON


def istft_fn(ct: bool, kernel: str, nfft: int):
    """The wrapper an ``ISTFT_SHAPES`` row calls: ``istft_ct_pallas``, the
    direct sum forced (``istft_direct_pallas``), Bluestein's cluster forced
    (``istft_bluestein_cluster_pallas``), the mixed cluster forced
    (``launch_istft(cluster_mixed=True)``) or ``istft_pallas``, each but the
    first given nfft."""
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_pallas
    from convsep_tpu_torch.dsp.cuda.istft_kernel import (
        istft_bluestein_cluster_pallas,
        istft_direct_pallas,
        istft_pallas,
        launch_istft,
    )

    if ct:
        return istft_ct_pallas
    if forced_mixed(kernel, nfft):
        return lambda re, im, w, hop, L: launch_istft(re, im, w, hop, L, nfft, cluster_mixed=True)
    fn = (istft_bluestein_cluster_pallas if forced_bluestein(kernel, nfft)
          else istft_direct_pallas if kernel == "istft_direct" else istft_pallas)
    return functools.partial(fn, nfft=nfft)  # an odd nfft is not told by its bins


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


def cluster_plan_check(N: int, nf: int, nfft: int, hop: int, bluestein: bool = False,
                       mixed: bool = False) -> dict:
    """The iSTFT cluster plan at a phase 7 shape (``bluestein``: Bluestein's
    cluster forced; ``mixed``: the mixed one forced) beside the clusters the
    card holds at once (cudaOccupancyMaxActiveClusters of the plan's
    kernel), which the plan's waves assume: a plan past the card's count
    runs a second wave."""
    import ctypes
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    plan = (fp.istft_cluster_plan if bluestein else fp.istft_cluster_mixed_plan if mixed
            else fp.istft_plan)(N, nf, nfft, nfft, hop)
    active = ctypes.c_int(0)
    kernels.check(kernels.library().istft_cluster_occupancy(
        nfft, nfft, hop, CLUSTER_ROUTES[plan.route], ctypes.byref(active)),
        "istft_cluster_occupancy")
    out = {"route": plan.route, "cluster": plan.cluster, "rounds": plan.rounds, "rows": plan.rows,
           "clusters": N * plan.blocks_per_signal, "clusters_at_once_plan":
           fp.CLUSTERS_AT_ONCE[plan.cluster], "clusters_at_once_card": active.value}
    log(f"  istft cluster plan W {nfft}: {json.dumps(out)}")
    return out


def phase_istft(device, gen) -> dict:
    """The iSTFT kernels vs plain, float32 and int16, beside ``torch.istft``:
    path A's shapes (``istft_ct_pallas``), path B's (``istft_pallas``; its
    int16 through ``launch_istft``, against the direct synthesis quantized),
    the split run backwards at W 768, Bluestein run backwards at W 1000, W
    6000 (the level), W 10 000, W 20 000 and W 40 000 (a cluster of 4, 8
    and 16 blocks; forced where the mixed cluster won), the direct transform
    on a cluster of 2, 4 and 8 blocks at W 16 384, 32 768 and 65 536 and on
    the 7-smooth block core at W 10 000, 20 000 and 40 000 (n 5000),
    14 000 and 56 000 (n 7000), 11 025 (odd, C 3), 22 050 (C 3) and 44 100
    (C 6), with Bluestein's cluster forced there, the direct sum forced at W
    1000 and W 10 000 (the times Bluestein and the cluster replace); the
    clusters of 5 and 7 the card holds at once. Each call must launch its
    kernel once and no other iSTFT kernel; each direct transform on a
    cluster must beat the forced Bluestein cluster's device time at its
    shape, and ``istft_plan`` must take the mixed one exactly at the sizes
    of ``ISTFT_MIXED_WON``."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.ct_istft_kernel import istft_ct_pallas_plain
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain, launch_istft
    from convsep_tpu_torch.dsp.dft import istft_matmul

    names = ISTFT_NAMES
    res = {}
    for name, nfft, hop, nf, N, ct, kernel in ISTFT_SHAPES:
        kern = istft_fn(ct, kernel, nfft)
        plain = istft_ct_pallas_plain if ct else functools.partial(istft_pallas_plain, nfft=nfft)
        # past 32 768 the direct matrices pass 6 GB (4.3 GB at 32 768, made on
        # the host): the float64 synthesis
        huge = nfft > DIRECT_MAX_NFFT or (not ct and nfft == DIRECT_MAX_NFFT)
        if huge:
            plain = istft64
        w, L, re, im = istft_inputs(nfft, hop, nf, N, device, gen)
        err = {}
        for out in ("float32", "int16"):
            before = dict(kernels.LAUNCHES)
            if out == "float32":
                got, want = kern(re, im, w, hop, L), plain(re, im, w, hop, L)
            elif ct:
                got = kern(re, im, w, hop, L, output_dtype=out)
                want = plain(re, im, w, hop, L, output_dtype=out)
            else:
                got = launch_istft(re, im, w, hop, L, nfft, out, direct=kernel == "istft_direct",
                                   bluestein_cluster=forced_bluestein(kernel, nfft),
                                   cluster_mixed=forced_mixed(kernel, nfft))
                want = (istft64(re, im, w, hop, L, out) if huge else
                        istft_matmul(re, im, w, hop, L, nfft=nfft, algorithm="direct",
                                     output_dtype=out))
            torch.cuda.synchronize()
            moved = {k: kernels.LAUNCHES[k] - before[k] for k in names}
            if moved != {k: int(k == kernel) for k in names}:
                raise AssertionError(f"istft {name} {out}: launched {moved}, want one {kernel}")
            if got.shape != (N, L) or got.dtype != want.dtype or not torch.isfinite(got.float()).all():
                raise AssertionError(f"istft {name} {out}: bad output {tuple(got.shape)} {got.dtype}")
            e = (got.float() - want.float()).abs().max().item()
            tol = TOL_WIENER_I16 if out == "int16" else TOL_WIENER_F32
            log(f"  istft {name} {out}: (N {N}, nf {nf}, bins {nfft // 2 + 1}) max_abs_err "
                f"{e:.3e}{'LSB' if out == 'int16' else ''} (tol {tol})")
            if not e <= tol:
                raise AssertionError(f"istft kernel {name} {out} disagrees: {e} > {tol}")
            err[out] = e
            if kernel.startswith("istft_cluster") and out == "float32":
                ref = want if huge else istft64(re, im, w, hop, L)
                peak = ref.abs().max().item()
                e64 = (got - ref).abs().max().item()
                tol64 = (TOL_ODD_ISTFT if nfft % 2 else TOL_CLUSTER_F32) * peak
                log(f"  istft {name}: {e64:.3e} from the float64 synthesis (tol {tol64:.3e})")
                if not e64 <= tol64:
                    raise AssertionError(f"istft {name}: {e64} > {tol64} from the float64 "
                                         "synthesis")
                err["rel_float64"] = e64 / peak
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
                     "rel_err_float64": err.get("rel_float64"),
                     "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms, "host_us": us}
        if kernel.startswith("istft_cluster"):
            res[name]["plan"] = cluster_plan_check(N, nf, nfft, hop,
                                                   forced_bluestein(kernel, nfft),
                                                   forced_mixed(kernel, nfft))
        del re, im, spec, want
        torch.cuda.empty_cache()
    dev = device_times("istft")["istft"]
    for name, r in res.items():
        d = dev[name]
        r.update(device_ms=d["device_ms"], library_device_ms=d["library_device_ms"])
        log(f"  istft {name}: device {ms_str(d['device_ms'])} (torch.istft device "
            f"{ms_str(d['library_device_ms'])}); bound {r['bound_ms']:.4f} ms")
    log(f"  device kernels: {json.dumps(dev)}")
    for key, direct in (("W 768 split", "W 1000 direct sum"),
                        ("W 1000 Bluestein", "W 1000 direct sum"),
                        ("W 10000 cluster", "W 10000 direct sum")):
        r, d = res[key], res[direct]
        log(f"  istft {key}: device {ms_str(r['device_ms'])} against torch.istft's "
            f"{ms_str(r['library_device_ms'])} and the {direct}'s {ms_str(d['device_ms'])}")
    for key, blue in ISTFT_DIT_AB:
        r, b = res[key], res[blue]
        log(f"  istft {key}: device {ms_str(r['device_ms'])} against torch.istft's "
            f"{ms_str(r['library_device_ms'])} and Bluestein's cluster forced, "
            f"{ms_str(b['device_ms'])}")
        r["bluestein_forced"] = {k: b[k] for k in ("device_ms", "ms", "max_abs_err",
                                                   "rel_err_float64", "plan")}
        if None in (r["device_ms"], b["device_ms"]) or not r["device_ms"] < b["device_ms"]:
            raise AssertionError(f"istft {key}: device {r['device_ms']} ms, not under the "
                                 f"forced Bluestein cluster's {b['device_ms']}")
    from convsep_tpu_torch.dsp.cuda import fft_plan as fp

    for name, nfft, hop, nf, N, _, kernel in ISTFT_SHAPES:
        if kernel == "istft_cluster_mixed":
            route = fp.istft_plan(N, nf, nfft, nfft, hop).route
            if (route == "cluster_mixed") != (nfft in fp.ISTFT_MIXED_WON):
                raise AssertionError(f"istft_plan at {name} takes {route}; ISTFT_MIXED_WON "
                                     f"says otherwise")
    import ctypes

    for nfft, hop in MIXED_OCCUPANCY_ONLY:  # the clusters of 5 and 7 no row launches
        c = fp.mixed_factors(nfft)[0]
        active = ctypes.c_int(0)
        kernels.check(kernels.library().istft_cluster_occupancy(
            nfft, nfft, hop, CLUSTER_ROUTES["cluster_mixed"], ctypes.byref(active)),
            "istft_cluster_occupancy")
        res[f"clusters_at_once_cluster_mixed_{c}"] = {"card": active.value,
                                                      "plan": fp.CLUSTERS_AT_ONCE[c]}
        log(f"  clusters of {c} at once (istft_cluster_mixed_kernel, W {nfft}): the card's "
            f"{active.value}, CLUSTERS_AT_ONCE[{c}] {fp.CLUSTERS_AT_ONCE[c]}")
        if active.value != fp.CLUSTERS_AT_ONCE[c]:
            raise AssertionError(f"the card holds {active.value} clusters of {c} at once "
                                 f"(istft_cluster_mixed_kernel), the plans weigh "
                                 f"{fp.CLUSTERS_AT_ONCE[c]}")
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
            and launches["stft"] == 1 and launches["stft_split"] == 0
            and launches["stft_bluestein"] == 0 and launches["stft_cluster"] == 0
            and launches["stft_dft"] == 0 and launches["istft_split"] == 0
            and launches["istft_bluestein"] == 0 and launches["istft_cluster"] == 0
            and launches["istft_direct"] == 0):
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


# phase 11's forward STFT kernel: (key, nfft = W, hop, the kernel it must
# launch): multires4096's 4096 points on the FFT core, and the reference's
# largest, 16 384, on a thread-block cluster of 4 blocks
CT_STFT_SHAPES = (("ct_stft", 4096, 1024, "ct_stft"),
                  ("ct_stft W 16384", 16384, 4096, "ct_stft_level"),
                  ("ct_stft_cluster W 16384", 16384, 4096, "ct_stft_cluster"))
CT_STFT_NAMES = ("ct_stft", "ct_stft_level", "ct_stft_cluster")


def ct_fn(kernel: str):
    """The wrapper a ``CT_STFT_SHAPES`` row calls: ``stft_ct_pallas``, or at
    16 384 points the cluster kernel forced (``stft_ct_cluster_pallas``, the
    design the level replaced, timed beside it in the same run)."""
    from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_cluster_pallas, stft_ct_pallas

    return stft_ct_cluster_pallas if kernel == "ct_stft_cluster" else stft_ct_pallas


def phase_ct_stft(device, gen) -> dict:
    """The forward STFT kernels vs plain on one multires4096 track
    (1, 1 474 560) at ``CT_STFT_SHAPES``, beside ``torch.stft`` on the same
    (already padded) frames; each call one launch of its kernel. At 16 384
    points the level (the route) and the cluster (forced) are also held to
    the float64 STFT within ``TOL_LEVEL_STFT`` and ``TOL_CLUSTER_STFT``."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.ct_stft_kernel import stft_ct_pallas_plain
    from convsep_tpu_torch.dsp.stft import _pad_signal
    from convsep_tpu_torch.dsp.windows import sinebell

    x = 0.3 * torch.randn(1, MR_SAMPLES, generator=gen, device=device)
    dev_all = device_times("ct_stft")["ct_stft"]
    res = {}
    for key, nfft, hop, kernel in CT_STFT_SHAPES:
        w = sinebell(nfft)
        half = nfft // 2
        fn = ct_fn(kernel)
        before = dict(kernels.LAUNCHES)
        got = fn(x, w, hop)
        torch.cuda.synchronize()
        moved = {k: kernels.LAUNCHES[k] - before[k] for k in CT_STFT_NAMES}
        if moved != {k: int(k == kernel) for k in moved}:
            raise AssertionError(f"{key}: launched {moved}, want one {kernel}")
        want = stft_ct_pallas_plain(x, w, hop)
        peak = max(a.abs().max().item() for a in want)
        e = max((g - p).abs().max().item() for g, p in zip(got, want))
        nf = got[0].shape[1]
        log(f"  {key} (1, {MR_SAMPLES}): re/im {tuple(got[0].shape)}, ny {tuple(got[2].shape)} "
            f"max_abs_err {e:.3e} (tol {TOL_STFT * peak:.3e}, max|X| {peak:.3e})")
        if not (e <= TOL_STFT * peak and all(torch.isfinite(a).all() for a in got)):
            raise AssertionError(f"{key} kernel disagrees: {e} > {TOL_STFT * peak}")
        e64 = None
        if nfft > MAX_CORE_NFFT:
            tol64 = TOL_CLUSTER_STFT if kernel == "ct_stft_cluster" else TOL_LEVEL_STFT
            r64, i64 = rfft64_stft(x, w, hop)
            e64 = max((got[0] - r64[..., :half]).abs().max().item(),
                      (got[1] - i64[..., :half]).abs().max().item(),
                      (got[2] - r64[..., half]).abs().max().item())
            log(f"  {key}: {e64:.3e} from the float64 STFT (tol {tol64 * peak:.3e})")
            if not e64 <= tol64 * peak:
                raise AssertionError(f"{key}: {e64} > {tol64 * peak} from the float64 STFT")
            del r64, i64
        padded = _pad_signal(x, nfft, hop)
        wt = torch.from_numpy(w.astype(np.float32)).to(device)

        def library():
            return torch.stft(padded, nfft, hop, window=wt, center=False, return_complex=True)

        lib = library()[0].transpose(0, 1)  # (nf, bins)
        e_lib = max((lib.real[:, :half] - want[0][0]).abs().max().item(),
                    (lib.imag[:, :half] - want[1][0]).abs().max().item(),
                    (lib.real[:, half] - want[2][0]).abs().max().item())
        ms = cuda_ms(lambda: fn(x, w, hop))
        plain_ms = cuda_ms(lambda: stft_ct_pallas_plain(x, w, hop))
        lib_ms = cuda_ms(library)
        us = host_us(lambda: fn(x, w, hop))
        dev = dev_all[key]
        b = bound(4 * x.numel() + 4 * sum(a.numel() for a in got), fft_flops(nf, nfft))
        log(f"  {key}: kernel {ms:.4f} ms (device {ms_str(dev['device_ms'])}), plain "
            f"{plain_ms:.4f} ms, torch.stft {lib_ms:.4f} ms (device "
            f"{ms_str(dev['library_device_ms'])}; cuFFT on the same frames; {e_lib:.3e} from the "
            f"plain version); bound {b['bound_ms']:.4f} ms ({b['bound_by']}); wrapper host "
            f"{us:.1f} us per call")
        log(f"  device kernels: {json.dumps(dev)}")
        res[key] = {"max_abs_err": e, "rel_err_float64": None if e64 is None else e64 / peak,
                    "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms,
                    "device_ms": dev["device_ms"], "library_device_ms": dev["library_device_ms"],
                    "host_us": us, "W": nfft, "hop": hop}
        del got, want, lib, padded
        torch.cuda.empty_cache()
    return res


def phase_wiener_ny(device, gen) -> dict:
    """The Wiener+iSTFT kernel's Nyquist-row input at multires4096 (S 4,
    nf 1442, bf16 y): :func:`wiener_ny_check` (its plain version, and bit
    for bit the same kernel fed the concatenated spectrum)."""
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
    worst = wiener_ny_check("multires4096", w, hop, L, y, re, im, ny, "wiener_istft_ny")
    ms = cuda_ms(lambda: wiener_istft(y, re, im, w, hop, L, ny=ny))
    cat_ms = cuda_ms(lambda: wiener_istft(y, full_re, full_im, w, hop, L))
    plain_ms = cuda_ms(lambda: wiener_istft_plain(y, re, im, w, hop, L, ny=ny))
    b = bound(2 * y.numel() + 8 * re.numel() + 4 * ny.numel() + 4 * S * L,
              fft_flops(S * nf, 4096) + 4 * y.numel())
    log(f"  wiener ny p=1 f32 out: kernel {ms:.3f} ms (concatenated input {cat_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": worst, "ms": ms, "concatenated_ms": cat_ms, "plain_ms": plain_ms,
            **b, "library_ms": None, "bit_equal_to_concatenated": True}


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


# odd-nfft iSTFT rows (phase 7c): (key, nfft, hop, nf, signals, kernel), nf
# a 30 s track's (1 323 000 samples) frames
ODD_ISTFT_SHAPES = (("W 1001 odd", 1001, 143, 9254, 4, "istft_bluestein"),
                    ("W 999 odd", 999, 333, 3975, 4, "istft_bluestein"),
                    ("W 9999 odd cluster", 9999, 1111, 1193, 1, "istft_cluster"),
                    ("W 39999 odd cluster", 39999, 13333, 101, 1, "istft_cluster"))
# the second level's rows (phase 5b): STFT (key, nfft, hop, B) on B training
# segments of 14 336 samples; iSTFT (key, nfft, hop, nf, signals, the kernel
# it must launch), nf a 30 s track's frames: the direct level at its 7-smooth
# sizes (R 16 at W 70 000 and 131 072, R 32 at W 200 000), Bluestein's level
# at the odd W 99 999 and forced (istft_level2_bluestein_pallas) at the
# direct level's shapes
LEVEL2_STFT_SHAPES = (("stft_level2", 70000, 17500, 32),
                      ("stft_level2 W 131072", 131072, 32768, 32),
                      ("stft_level2 W 99999", 99999, 33333, 32))
LEVEL2_ISTFT_SHAPES = (("istft_level2_direct", 70000, 17500, 78, 1, "istft_level2_direct"),
                       ("istft_level2_direct W 131072", 131072, 32768, 43, 1,
                        "istft_level2_direct"),
                       ("istft_level2_direct W 200000", 200000, 50000, 29, 1,
                        "istft_level2_direct"),
                       ("istft_level2 W 99999", 99999, 33333, 42, 1, "istft_level2"),
                       ("istft_level2", 70000, 17500, 78, 1, "istft_level2"),
                       ("istft_level2 W 131072", 131072, 32768, 43, 1, "istft_level2"),
                       ("istft_level2 W 200000", 200000, 50000, 29, 1, "istft_level2"))
# the direct level's rows and Bluestein's level forced at their shapes
LEVEL2_DIRECT_AB = (("istft_level2_direct", "istft_level2"),
                    ("istft_level2_direct W 131072", "istft_level2 W 131072"),
                    ("istft_level2_direct W 200000", "istft_level2 W 200000"))


def random_spectra(nfft: int, hop: int, nf: int, N: int, device, gen):
    """Random half-spectra (N, nf, nfft//2 + 1) and the signal length whose
    frames they are (the kernels' function does not depend on them being an
    STFT's; the direct matrices that would make one pass 6 GB past 32 768)."""
    import torch
    from convsep_tpu_torch.dsp.windows import sinebell

    bins = nfft // 2 + 1
    re = torch.randn(N, nf, bins, generator=gen, device=device)
    im = torch.randn(N, nf, bins, generator=gen, device=device)
    return sinebell(nfft), (nf - 2) * hop, re, im


def level2_bluestein_forced(kernel: str, nfft: int) -> bool:
    """A ``LEVEL2_ISTFT_SHAPES`` row that forces Bluestein's second level at
    a size in ``ISTFT_LEVEL2_DIRECT_WON``, where the wrapper takes the
    direct level."""
    from convsep_tpu_torch.dsp.cuda.fft_plan import ISTFT_LEVEL2_DIRECT_WON

    return kernel == "istft_level2" and nfft in ISTFT_LEVEL2_DIRECT_WON


def level2_istft_fn(kernel: str, nfft: int):
    """The wrapper a ``LEVEL2_ISTFT_SHAPES`` row calls: Bluestein's level
    forced (``istft_level2_bluestein_pallas``) or ``istft_pallas``."""
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_level2_bluestein_pallas, istft_pallas

    return istft_level2_bluestein_pallas if level2_bluestein_forced(kernel, nfft) else istft_pallas


def istft_row(name: str, kernel: str, nfft: int, hop: int, w, L: int, re, im, plain, tol64,
              device, level2_bluestein: bool = False) -> dict:
    """One iSTFT row: ``istft_pallas`` (float32) and ``launch_istft``
    (PCM16) against the float64 synthesis (float32 within ``tol64`` ×
    max|out|, PCM16 within ``TOL_WIENER_I16``), one launch of ``kernel``
    and no other iSTFT kernel; the kernel, ``plain`` and ``torch.istft``
    timed; the bound. ``level2_bluestein``: Bluestein's second level forced
    (``istft_level2_bluestein_pallas``, ``launch_istft(level2_bluestein=
    True)``)."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.istft_kernel import (
        istft_level2_bluestein_pallas,
        istft_pallas,
        launch_istft,
    )

    names = ISTFT_NAMES
    N = re.shape[0]
    err = {}
    f32 = istft_level2_bluestein_pallas if level2_bluestein else istft_pallas
    for out in ("float32", "int16"):
        before = dict(kernels.LAUNCHES)
        got = (f32(re, im, w, hop, L, nfft=nfft) if out == "float32"
               else launch_istft(re, im, w, hop, L, nfft, out, level2_bluestein=level2_bluestein))
        want = istft64(re, im, w, hop, L, out)
        torch.cuda.synchronize()
        moved = {k: kernels.LAUNCHES[k] - before[k] for k in names}
        if moved != {k: int(k == kernel) for k in names}:
            raise AssertionError(f"istft {name} {out}: launched {moved}, want one {kernel}")
        if got.shape != (N, L) or not torch.isfinite(got.float()).all():
            raise AssertionError(f"istft {name} {out}: bad output {tuple(got.shape)}")
        e = (got.float() - want.float()).abs().max().item()
        tol = TOL_WIENER_I16 if out == "int16" else tol64 * want.abs().max().item()
        log(f"  istft {name} {out}: (N {N}, nf {re.shape[1]}, bins {re.shape[2]}) {e:.3e}"
            f"{' LSB' if out == 'int16' else ''} from the float64 synthesis (tol {tol:.3e})")
        if not e <= tol:
            raise AssertionError(f"istft {name} {out}: {e} > {tol} from the float64 synthesis")
        err[out] = e
        if out == "float32":
            err["rel"] = e / want.abs().max().item()
        if out == "float32" and plain is not istft64:
            ep = (got - plain(re, im, w, hop, L, nfft=nfft)).abs().max().item()
            log(f"  istft {name}: {ep:.3e} from the plain version (tol {TOL_WIENER_F32})")
            if not ep <= TOL_WIENER_F32:
                raise AssertionError(f"istft {name}: {ep} > {TOL_WIENER_F32} from plain")
            err["plain"] = ep
    wt = torch.from_numpy(np.asarray(w, np.float32)).to(device)
    spec = torch.complex(re, im).transpose(-1, -2)
    ms = cuda_ms(lambda: f32(re, im, w, hop, L, nfft=nfft))
    plain_ms = cuda_ms(lambda: plain(re, im, w, hop, L, **({} if plain is istft64 else
                                                           {"nfft": nfft})))
    lib_ms = cuda_ms(lambda: torch.istft(spec, nfft, hop, window=wt, center=True, length=L))
    us = host_us(lambda: f32(re, im, w, hop, L, nfft=nfft), reps=20)
    b = bound(8 * re.numel() + 4 * N * L, fft_flops(N * re.shape[1], nfft))
    log(f"  istft {name} f32 out: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"({'float64' if plain is istft64 else 'the direct matrices'}), torch.istft "
        f"{lib_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); wrapper host "
        f"{us:.1f} us per call")
    return {"max_abs_err": err.get("plain", err["float32"]), "rel_err_float64": err["rel"],
            "max_abs_err_int16": err["int16"], "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": lib_ms, "host_us": us, "W": nfft, "hop": hop, "nf": re.shape[1],
            "signals": N}


def phase_odd_istft(device, gen) -> dict:
    """The iSTFT at odd nfft (no Nyquist bin, every bin but DC twice, as the
    reference's inverse matrices weight them), on one 30 s track's frames
    (``ODD_ISTFT_SHAPES``): Bluestein run backwards at W 1001, hop 143 and
    W 999, hop 333; on a cluster at W 9999, hop 1111 (4 blocks) and W 39
    999, hop 13 333 (16 blocks); float32 within ``TOL_ODD_ISTFT`` of the
    float64 synthesis (and ``TOL_WIENER_F32`` of the plain version up to
    32 768 points), PCM16 within one LSB."""
    import torch
    from convsep_tpu_torch.dsp.cuda.istft_kernel import istft_pallas_plain

    res = {}
    for name, nfft, hop, nf, N, kernel in ODD_ISTFT_SHAPES:
        w, L, re, im = random_spectra(nfft, hop, nf, N, device, gen)
        plain = istft_pallas_plain if nfft <= DIRECT_MAX_NFFT else istft64
        res[name] = {"kernel": kernel, **istft_row(name, kernel, nfft, hop, w, L, re, im, plain,
                                                   TOL_ODD_ISTFT, device)}
        del re, im
        torch.cuda.empty_cache()
    return res


def phase_level2(device, gen) -> dict:
    """The second level (Bluestein's M 262 144 or 524 288 over two passes
    through device memory, past 65 536 points): ``stft_pallas`` at
    ``LEVEL2_STFT_SHAPES`` on B 32 training segments and ``istft_pallas``
    at ``LEVEL2_ISTFT_SHAPES`` on one 30 s track's frames, one odd size
    each way, against the float64 transforms within ``TOL_LEVEL2``, beside
    ``torch.stft`` / ``torch.istft``; then the dense DFT kernel forced at W
    70 000 (its 19.6 GB of matrices made on the card and freed at once), the
    time the level replaces. The iSTFT's direct level at its three shapes
    beside Bluestein's level forced at each (``LEVEL2_DIRECT_AB``): the
    phase fails unless the direct level's device time is under it. Device
    times from a profiler child."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.dsp.cuda.fft_plan import level2_direct_plan, level2_plan
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_dft_pallas, stft_pallas
    from convsep_tpu_torch.dsp.dft import _forward_mats

    names = ("stft", "stft_split", "stft_bluestein", "stft_cluster", "stft_level2", "stft_dft")
    res = {}
    for key, win, hop, B in LEVEL2_STFT_SHAPES:
        x, w, padded, wt = stft_inputs(B, win, hop, device, gen)
        before = dict(kernels.LAUNCHES)
        re, im = stft_pallas(x, w, hop)
        torch.cuda.synchronize()
        moved = {k: kernels.LAUNCHES[k] - before[k] for k in names}
        if moved != {k: int(k == "stft_level2") for k in names}:
            raise AssertionError(f"{key}: launched {moved}, want one stft_level2")
        r64, i64 = rfft64_stft(x, w, hop)
        peak = max(r64.abs().max().item(), i64.abs().max().item())
        e = max((re - r64).abs().max().item(), (im - i64).abs().max().item())
        log(f"  {key} B {B}: re/im {tuple(re.shape)} {e:.3e} from the float64 STFT (tol "
            f"{TOL_LEVEL2 * peak:.3e}, max|X| {peak:.3e})")
        if not (e <= TOL_LEVEL2 * peak and torch.isfinite(re).all() and torch.isfinite(im).all()):
            raise AssertionError(f"{key}: {e} > {TOL_LEVEL2 * peak} from the float64 STFT")

        def library():
            return torch.stft(padded, win, hop, window=wt, center=False, return_complex=True)

        ms = cuda_ms(lambda: stft_pallas(x, w, hop))
        plain_ms = cuda_ms(lambda: rfft64_stft(x, w, hop))
        lib_ms = cuda_ms(library)
        us = host_us(lambda: stft_pallas(x, w, hop), reps=20)
        nf = re.shape[-2]
        b = bound(4 * x.numel() + 8 * re.numel(), fft_flops(B * nf, win))
        plan = level2_plan(B, nf, win, win, hop)
        log(f"  {key}: kernel {ms:.4f} ms, plain (float64 STFT) {plain_ms:.4f} ms, torch.stft "
            f"{lib_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); wrapper host "
            f"{us:.1f} us; plan: M {plan.m}, R {plan.radix}, {plan.pairs} pairs in "
            f"{plan.rounds} rounds of {plan.pairs_per_round}, {plan.scratch_bytes} B of scratch")
        res[key] = {"max_abs_err": e, "rel_err_float64": e / peak, "ms": ms, "plain_ms": plain_ms,
                    **b, "library_ms": lib_ms, "host_us": us, "W": win, "hop": hop, "B": B,
                    "nf": nf, "plan": {"m": plan.m, "radix": plan.radix, "pairs": plan.pairs,
                                       "pairs_per_round": plan.pairs_per_round,
                                       "rounds": plan.rounds,
                                       "scratch_bytes": plan.scratch_bytes}}
        if key == "stft_level2":  # the dense kernel it replaces, forced, at the same shape
            before = dict(kernels.LAUNCHES)
            dr, di = stft_dft_pallas(x, w, hop)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["stft_dft"] != before["stft_dft"] + 1:
                raise AssertionError("the forced dense kernel did not launch stft_dft")
            ed = max((dr - r64).abs().max().item(), (di - i64).abs().max().item())
            del dr, di
            dense_ms = cuda_ms(lambda: stft_dft_pallas(x, w, hop), reps=1, rounds=3, warmup=0)
            log(f"  {key}: the dense DFT kernel forced {dense_ms:.4f} ms ({ed:.3e} from the "
                f"float64 STFT; its matrices {8 * win * (win // 2 + 1) / 1e9:.1f} GB)")
            if not ed <= TOL_STFT * peak:
                raise AssertionError(f"the dense kernel at W {win}: {ed} > {TOL_STFT * peak}")
            res[key].update(dense_ms=dense_ms, dense_max_abs_err=ed)
            _forward_mats.cache_clear()
        del re, im, r64, i64, x, padded
        torch.cuda.empty_cache()
    for key, nfft, hop, nf, N, kernel in LEVEL2_ISTFT_SHAPES:
        w, L, re, im = random_spectra(nfft, hop, nf, N, device, gen)
        res[key] = istft_row(key, kernel, nfft, hop, w, L, re, im, istft64, TOL_LEVEL2, device,
                             level2_bluestein_forced(kernel, nfft))
        plan = (level2_plan if kernel == "istft_level2" else level2_direct_plan)(N, nf, nfft,
                                                                                 nfft, hop)
        res[key]["plan"] = {"m": plan.m, "radix": plan.radix, "pairs": plan.pairs,
                            "pairs_per_round": plan.pairs_per_round, "rounds": plan.rounds,
                            "scratch_bytes": plan.scratch_bytes}
        log(f"  {key}: plan {res[key]['plan']}")
        del re, im
        torch.cuda.empty_cache()
    dev = device_times("level2")["level2"]
    for key, r in res.items():
        d = dev.get(key)
        if d:
            r.update(device_ms=d["device_ms"], library_device_ms=d["library_device_ms"],
                     device_kernels=d["kernels"])
            log(f"  {key}: device {ms_str(d['device_ms'])} (torch's device "
                f"{ms_str(d['library_device_ms'])}); kernels {json.dumps(d['kernels'])}")
    for key, blue in LEVEL2_DIRECT_AB:
        r, b = res[key], res[blue]
        log(f"  {key}: device {ms_str(r['device_ms'])} against torch.istft's "
            f"{ms_str(r['library_device_ms'])} and Bluestein's level forced, "
            f"{ms_str(b['device_ms'])}")
        r["bluestein_forced"] = {k: b[k] for k in ("device_ms", "ms", "max_abs_err",
                                                   "max_abs_err_int16", "rel_err_float64")}
        if None in (r["device_ms"], b["device_ms"]) or not r["device_ms"] < b["device_ms"]:
            raise AssertionError(f"{key}: device {r['device_ms']} ms, not under the forced "
                                 f"Bluestein level's {b['device_ms']}")
    return res


def child_level2_times(device, gen, pair) -> dict:
    """Device ms of the second level: the STFT's first row (W 70 000, hop
    17 500) and every ``LEVEL2_ISTFT_SHAPES`` row, each beside
    ``torch.stft`` / ``torch.istft``."""
    import numpy as np
    import torch
    from convsep_tpu_torch.dsp.cuda.stft_kernel import stft_pallas

    key, win, hop, B = LEVEL2_STFT_SHAPES[0]
    x, w, padded, wt = stft_inputs(B, win, hop, device, gen)
    res = {key: pair(lambda: stft_pallas(x, w, hop),
                     lambda: torch.stft(padded, win, hop, window=wt, center=False,
                                        return_complex=True))}
    for key, nfft, hop, nf, N, kernel in LEVEL2_ISTFT_SHAPES:
        w, L, re, im = random_spectra(nfft, hop, nf, N, device, gen)
        wt = torch.from_numpy(np.asarray(w, np.float32)).to(device)
        spec = torch.complex(re, im).transpose(-1, -2)
        fn = level2_istft_fn(kernel, nfft)
        res[key] = pair(lambda: fn(re, im, w, hop, L, nfft=nfft),
                        lambda: torch.istft(spec, nfft, hop, window=wt, center=True, length=L))
        del re, im, spec
        torch.cuda.empty_cache()
    return res


# the fused decode at the reference rule's edges (phase 11b): (key, J,
# ktaps, TM) at B 49, S 4, W_pad 512, TpC 800 (highres4096's other widths)
DECODE_EDGE_SHAPES = (("J 128 ktaps 17 TM 120", 128, 17, 120),
                      ("J 128 ktaps 16 TM 360", 128, 16, 360),
                      ("J 100 ktaps 8 TM 120", 100, 8, 120))
# a band decode past one block's shared memory (phase 11b): multires4096's
# geometry (N 196, Tp 16, W 505, kh 15) at 128 input channels and 64 output
# channels (8 pieces of 4 depths × 8 or 7 taps; 64 columns a product)
BAND_PIECES_SHAPE = (196, 16, 505, 128, 15, 64)
# the streamed band decode's shapes (phase 11b): BAND_PIECES_SHAPE and the
# same geometry at C2 100, I 100 (6 pieces; 104 columns a product)
BAND_STREAM_SHAPES = (BAND_PIECES_SHAPE, (196, 16, 505, 100, 15, 100))
# its A/B against band_decode.cu where the band fits (phase 11b): I 100 runs
# there as thirteen products of 8 columns a column block
BAND_STREAM_AB_SHAPE = (196, 16, 505, 32, 15, 100)
# the spread of the two band kernels' times between runs: BAND_STREAM_WON
# may route a band where one run reads the streamed kernel this much slower
BAND_SPREAD = 0.05


def phase_decode_edges(device, gen) -> dict:
    """The fused decode kernel at ``DECODE_EDGE_SHAPES`` (the reference's
    largest ktaps, at TM 120 and 360; a J padded to the mma depth 8) on
    random operands, forced: float32 and bf16 within the decode's
    tolerances of the plain version, one launch each, the launcher's plan
    equal to its mirror (``decode_plan``), kernel and plain times."""
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.models.decoder_fused_cuda import (
        band_freq_decode,
        band_freq_decode_plain,
        card_plan,
        decode_plan,
    )

    res = {}
    B, S, W_pad, TpC = 49, 4, 512, 800
    for key, J, ktaps, TM in DECODE_EDGE_SHAPES:
        fc = torch.relu(torch.randn(B, J, generator=gen, device=device))
        ops = (0.2 * torch.randn(J, S, W_pad, TpC, generator=gen, device=device),
               0.1 * torch.randn(S, W_pad, TpC, generator=gen, device=device),
               0.1 * torch.randn(TpC, ktaps, TM, generator=gen, device=device))
        err = {}
        for dt in (torch.float32, torch.bfloat16):
            before = kernels.LAUNCHES["fused_decode"]
            got = band_freq_decode(fc, *ops, out_dtype=dt).float()
            want = band_freq_decode_plain(fc, *ops, out_dtype=dt).float()
            torch.cuda.synchronize()
            if kernels.LAUNCHES["fused_decode"] != before + 1:
                raise AssertionError(f"decode {key}: no fused_decode launch")
            scale = want.abs().max().item()
            tol = (TOL_DECODE_F32 if dt == torch.float32 else TOL_DECODE_BF16) * scale
            e = (got - want).abs().max().item()
            log(f"  decode {key} {str(dt)[6:]}: max_abs_err {e:.3e} (tol {tol:.3e})")
            if not (e <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"fused decode {key} {dt} disagrees: {e} > {tol}")
            err[dt] = e
        shape = (B, J, S, W_pad, TpC, ktaps, TM)
        plan, mirror = card_plan(*shape), decode_plan(*shape)
        if (plan["bt"], plan["kc_bufs"], plan["k4_bufs"], plan["wb"], plan["smem_bytes"]) != (
                mirror.bt, mirror.kc_bufs, mirror.k4_bufs, mirror.wb, mirror.smem_bytes):
            raise AssertionError(f"decode {key}: the launcher's plan {plan} is not its mirror "
                                 f"{mirror}")
        ms = cuda_ms(lambda: band_freq_decode(fc, *ops, out_dtype=torch.bfloat16))
        plain_ms = cuda_ms(lambda: band_freq_decode_plain(fc, *ops, out_dtype=torch.bfloat16))
        b = decode_bounds(fc, ops)
        log(f"  decode {key} B {B} bf16 out: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
            f"{b['bound_ms']:.3f} ms (3xTF32); plan: row tiles of {plan['bt']} fc rows (bp "
            f"{plan['bp']}), {plan['kc_bufs']} Kcat and {plan['k4_bufs']} K4 buffers, "
            f"{plan['wb']} output rows a block (halo {mirror.halo:.2f}), clusters of "
            f"{plan['cluster']}, {plan['active_clusters']} at once, {plan['smem_bytes']} B")
        res[key] = {"max_abs_err": err[torch.float32], "max_abs_err_bf16": err[torch.bfloat16],
                    "ms": ms, "plain_ms": plain_ms, **b, "library_ms": None, "B": B, "J": J,
                    "ktaps": ktaps, "TM": TM, "plan": plan}
        del fc, ops, got, want
        torch.cuda.empty_cache()
    return res


def band_flops(N: int, W: int, Tp: int, C2: int, kh: int, I: int) -> float:
    """The band's nonzero products: each column block t reads the taps h
    with 0 <= t - h < kh, Tp·kh (h, t) pairs of C2 × I products a row."""
    return 2.0 * N * W * Tp * kh * C2 * I


def phase_band_stream(device, gen) -> dict:
    """The streamed band decode kernel (``csrc/band_stream.cu``) at
    ``BAND_STREAM_SHAPES``, bands whose taps and z tile do not fit one
    block's shared memory: routed by ``band_decode_wmajor``, exactly one
    ``band_decode_stream`` launch a call and no ``band_decode``, within
    ``TOL_BAND`` of the plain version; its card ms and wrapper host µs
    beside the pieces it replaced (``band_decode_pieces_pallas``, forced,
    also held to the plain version), the plain version, a bf16
    ``torch.matmul`` of the dense band and the bound; it must beat the
    pieces. Then the A/B at ``BAND_STREAM_AB_SHAPE``, a band that fits
    ``csrc/band_decode.cu``: the streamed kernel against the taps-resident
    one (``band_decode_resident_pallas``); where ``BAND_STREAM_WON`` routes
    the streamed kernel, it may read at most ``BAND_SPREAD`` slower."""
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.models.decoder_band_cuda import (
        BAND_STREAM_WON,
        band_decode_pieces_pallas,
        band_decode_resident_pallas,
        band_decode_stream_pallas,
        band_decode_wmajor,
        band_decode_wmajor_plain,
        band_operand,
        band_pieces,
        band_stream_plan,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for N, Tp, W, C2, kh, I in BAND_STREAM_SHAPES:
        key = f"C2 {C2} I {I}"
        T = Tp + kh - 1
        split = band_pieces(Tp, C2, kh, I)
        plan = band_stream_plan(N * W, Tp, C2, kh, I, sms)
        z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=device)).to(torch.bfloat16)
        op = band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=device), T)
        before = dict(kernels.LAUNCHES)
        got = band_decode_wmajor(z, op, T)
        want = band_decode_wmajor_plain(z, op)
        torch.cuda.synchronize()
        if (kernels.LAUNCHES["band_decode_stream"] != before["band_decode_stream"] + 1
                or kernels.LAUNCHES["band_decode"] != before["band_decode"]):
            raise AssertionError(f"band stream {key}: not one band_decode_stream launch")
        scale = want.abs().max().item()
        e = (got - want).abs().max().item()
        before = kernels.LAUNCHES["band_decode"]
        pieces = band_decode_pieces_pallas(z, op, T)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["band_decode"] != before + 1:
            raise AssertionError(f"band pieces {key}: no band_decode count")
        ep = (pieces - want).abs().max().item() if torch.isfinite(pieces).all() else float("inf")
        del pieces
        log(f"  band_decode_stream {key} z {tuple(z.shape)}: max_abs_err {e:.3e}, the forced "
            f"pieces ({len(split.pieces)} of at most {split.tp} depths x {split.kh} taps) "
            f"{ep:.3e} (tol {TOL_BAND * scale:.3e})")
        if not torch.isfinite(got).all():
            e = float("inf")
        for name, err in (("stream", e), ("pieces", ep)):
            if not err <= TOL_BAND * scale:
                raise AssertionError(f"band decode {name} {key} disagrees: {err} > "
                                     f"{TOL_BAND * scale}")
        zb, bb = z.reshape(N * W, -1), op.band.reshape(Tp * C2, -1).to(torch.bfloat16)
        ms = cuda_ms(lambda: band_decode_wmajor(z, op, T))
        pieces_ms = cuda_ms(lambda: band_decode_pieces_pallas(z, op, T), reps=3, rounds=3)
        plain_ms = cuda_ms(lambda: band_decode_wmajor_plain(z, op), reps=3, rounds=3)
        lib_ms = cuda_ms(lambda: torch.matmul(zb, bb))
        us = host_us(lambda: band_decode_wmajor(z, op, T), reps=50)
        flops = band_flops(N, W, Tp, C2, kh, I)
        b = bound(2 * z.numel() + 2 * kh * C2 * I + 4 * got.numel(), flops, BF16_FLOPS)
        log(f"  band_decode_stream {key}: kernel {ms:.4f} ms, the forced pieces {pieces_ms:.4f} "
            f"ms, plain {plain_ms:.3f} ms, torch.matmul bf16 {lib_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {flops:.4e} operations, "
            f"{plan.executed_ops:.4e} run); wrapper host {us:.1f} us per call; plan: N "
            f"{plan.n}, G {plan.g}, {plan.items} items on {plan.grid} blocks, "
            f"{plan.smem_bytes} B")
        if not ms < pieces_ms:
            raise AssertionError(f"band stream {key}: {ms} ms, not under the pieces' {pieces_ms}")
        res[key] = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms,
                    "host_us": us, "operations": flops, "executed_operations": plan.executed_ops,
                    "shape": [N, Tp, W, C2, kh, I], "n": plan.n, "g": plan.g,
                    "pieces_forced": {"ms": pieces_ms, "max_abs_err": ep,
                                      "pieces": len(split.pieces), "piece_depths": split.tp,
                                      "piece_taps": split.kh}}
        del z, op, got, want, zb, bb
        torch.cuda.empty_cache()
    N, Tp, W, C2, kh, I = BAND_STREAM_AB_SHAPE
    T = Tp + kh - 1
    z = torch.relu(torch.randn(N, W, Tp * C2, generator=gen, device=device)).to(torch.bfloat16)
    op = band_operand(0.05 * torch.randn(kh, 1, I, C2, generator=gen, device=device), T)
    want = band_decode_wmajor_plain(z, op)
    scale = want.abs().max().item()
    errs = {}
    for name, fn in (("stream", band_decode_stream_pallas), ("resident", band_decode_resident_pallas)):
        errs[name] = (fn(z, op, T) - want).abs().max().item()
        if not errs[name] <= TOL_BAND * scale:
            raise AssertionError(f"band A/B {name} disagrees: {errs[name]} > {TOL_BAND * scale}")
    stream_ms = cuda_ms(lambda: band_decode_stream_pallas(z, op, T))
    resident_ms = cuda_ms(lambda: band_decode_resident_pallas(z, op, T))
    won = (Tp, C2, kh, I) in BAND_STREAM_WON
    log(f"  band A/B at N {N}, Tp {Tp}, W {W}, C2 {C2}, kh {kh}, I {I} (fits band_decode.cu): "
        f"streamed {stream_ms:.4f} ms, taps-resident {resident_ms:.4f} ms; routed to the "
        f"{'streamed' if won else 'taps-resident'} kernel (BAND_STREAM_WON)")
    if won and stream_ms > (1 + BAND_SPREAD) * resident_ms:
        raise AssertionError(f"BAND_STREAM_WON routes a band where the streamed kernel lost: "
                             f"{stream_ms} > {resident_ms}")
    res["ab"] = {"shape": [N, Tp, W, C2, kh, I], "stream_ms": stream_ms,
                 "resident_ms": resident_ms, "routed_to_stream": won,
                 "stream_max_abs_err": errs["stream"], "resident_max_abs_err": errs["resident"]}
    return res


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
                         "stft_split": False, "stft_bluestein": False, "stft_cluster": False,
                         "stft_dft": False, "istft": False, "istft_split": False,
                         "istft_bluestein": False, "istft_cluster": False,
                         "istft_direct": False}),
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
            "wiener_istft_ny": 0, "stft_split": 0, "stft_bluestein": 0, "stft_cluster": 0,
            "stft_dft": 0, "istft_split": 0, "istft_cluster": 0}
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
                and launches["stft_split"] == 0 and launches["stft_bluestein"] == 0
                and launches["stft_cluster"] == 0 and launches["stft_dft"] == 0):
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
        mgr = CheckpointManager(os.path.join(root, "timed"), async_save=False)
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


# relative, each step's loss, bf16 against float32 adadelta state: the
# reference's bound (its v5e, 200 steps), printed; phase 24 gates at the
# larger of it and the first-order limit of bf16 storage (the card read
# 4.6e-5 at step 17 of 20)
TOL_BF16_STATE = 2e-5
# phases 22-23: phase 6's route limits were set above dsd100's witnesses; at
# dsd100-stereo a witness itself passes them (rfft: weights 4.11e-5 against
# 3e-5 at wiener_eps 1e-8), so a limit there is this × the larger witness's
# reading in the same run
WITNESS_MARGIN = 2.0
TOL_GRAPH = 1e-6          # × max|p|, the K-step graph against eager steps, if not bit for bit
DISPATCH_K = 4            # steps_per_dispatch of the graph phase


def write_stereo_tracks(root: str, sources, tracks: int = TRAIN_TRACKS,
                        seconds: int = TRAIN_SECONDS) -> None:
    """As :func:`write_tracks`, each stem a stereo wav panned to its own
    angle (stem s of S at (s + 1/2) · 90° / S: no two stems alike in both
    ears)."""
    import numpy as np
    from convsep_tpu_torch.data.io import write_wav
    from convsep_tpu_torch.data.synth import sine_mixture

    for i in range(tracks):
        stems, _ = sine_mixture(len(sources), seconds * FS, fs=FS, seed=i)
        os.makedirs(os.path.join(root, f"track{i}"))
        for s, name in enumerate(sources):
            theta = (s + 0.5) * np.pi / (2 * len(sources))
            write_wav(os.path.join(root, f"track{i}", f"{name}.wav"), FS,
                      np.stack([np.cos(theta) * stems[s], np.sin(theta) * stems[s]], axis=1))


def route_gate(name: str, mix, stems, device) -> dict:
    """Phase 6's route check (:func:`route_check`) for preset ``name`` from
    the seeded init, at the preset's Wiener eps and at 1e-2, gated as phase
    6: the loss within ``TOL_ROUTE``, the fused step bit for bit, grad_norm
    and weights within phase 6's limits (``TOL_ROUTE_GN`` /
    ``TOL_ROUTE_GN_EPS``, ``TOL_ROUTE_WEIGHTS`` × max|g|) or, where a
    witness (a float32-correct plain route) itself reads past them,
    ``WITNESS_MARGIN`` × the larger witness's reading in this run."""
    import torch
    from convsep_tpu_torch.train.loop import create_train_state

    preset = train_preset(True, name)
    init = create_train_state(preset, 0, device)[0].params
    out = {}
    for weps in (preset.sep.wiener_eps, 1e-2):
        r = route_check(init, mix, stems, weps, device, name)
        limits = {"grad_norm": TOL_ROUTE_GN if weps == 1e-2 else TOL_ROUTE_GN_EPS,
                  "weights": TOL_ROUTE_WEIGHTS}
        limits = {g: max(v, WITNESS_MARGIN * max(r["witness"][g], r["rfft"][g]))
                  for g, v in limits.items()}
        log(f"    wiener_eps {weps:g}: limits grad_norm {limits['grad_norm']:.3e}, weights "
            f"{limits['weights']:.3e}")
        k = r["kernel"]
        out[f"{weps:g}"] = {**r, "limits": limits}
        if not (k["loss"] <= TOL_ROUTE and k["grad_norm"] <= limits["grad_norm"]
                and k["weights"] <= limits["weights"] and r["exact"]):
            raise AssertionError(f"the kernel route's train step disagrees with the plain "
                                 f"route at wiener_eps {weps}: {r}")
        torch.cuda.empty_cache()
    return out


def fit_losses(trainer, ds, steps: int, metrics: str, device) -> dict:
    """``trainer.fit(ds, max_steps=steps)`` with the launch counts taken
    from zero just before it and read just after, the peak device memory,
    and the logged losses and step times."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(ds, max_steps=steps, metrics_path=metrics)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    with open(metrics) as f:
        recs = [r for r in map(json.loads, f) if "loss" in r]
    return {"launches": launches, "fit_s": fit_s, "losses": [r["loss"] for r in recs],
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "step_time_ms": float(np.median([r["step_time_ms"] for r in recs[1:]])),
            "rtf_train": float(np.median([r["rtf_train"] for r in recs[1:]]))}


def phase_train_path(name: str, ds, device) -> dict:
    """Stereo (dsd100-stereo) or multires (multires4096) training at full
    width, B 32: the route gate from the seeded init, then
    ``Trainer.fit(max_steps=20)`` on the kernel route (finite, falling
    loss; two STFT launches a step, no other STFT kernel; the adadelta
    kernel), the kernel and plain routes' step times."""
    import tempfile

    import numpy as np
    import torch
    from convsep_tpu_torch.data.pipeline import to_device
    from convsep_tpu_torch.train.e2e import make_audio_train_step
    from convsep_tpu_torch.train.loop import Trainer, create_train_state

    kern, plain = train_preset(True, name), train_preset(False, name)
    B = kern.train.batch_size
    mix, stems = to_device(next(ds.batches(B, shuffle=True, seed=123)), device)
    log(f"  batch: mixtures {tuple(mix.shape)}, stems {tuple(stems.shape)}; the STFT kernel on "
        f"({mix.numel() // mix.shape[-1]}, {mix.shape[-1]}) and "
        f"({stems.numel() // stems.shape[-1]}, {stems.shape[-1]}) rows a step")
    log(f"  route check from the seeded random init (gated as phase 6):")
    route = route_gate(name, mix, stems, device)
    with tempfile.TemporaryDirectory() as root:
        trainer = Trainer(kern, from_audio=True, device=device, seed=0)
        run = fit_losses(trainer, ds, TRAIN_STEPS, os.path.join(root, "m.jsonl"), device)
    del trainer
    losses, launches = run["losses"], run["launches"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  fit: {TRAIN_STEPS} steps in {run['fit_s']:.2f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} }, peak device memory "
        f"{run['peak_bytes'] / 2**30:.2f} GiB")
    log(f"  losses by logged step: {[round(v, 6) for v in losses]}; mean of the first 5 "
        f"{first:.6f}, of the last 5 {last:.6f}")
    if len(losses) < 10 or not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"{name}: training loss is not finite and falling: {losses}")
    others = [k for k in ("stft_split", "stft_bluestein", "stft_cluster", "stft_level2",
                          "stft_dft") if launches[k]]
    if launches["stft"] != 2 * TRAIN_STEPS or others or launches["fused_adadelta"] == 0:
        raise AssertionError(f"{name}: the training path missed a kernel: {launches}")
    torch.cuda.empty_cache()
    times = {}
    for route_name, p in (("kernel", kern), ("plain", plain)):
        st, opt = create_train_state(p, 0, device)
        times[route_name] = time_steps(make_audio_train_step(p, opt), st, mix, stems)
        del st
        torch.cuda.empty_cache()
    audio_s = B * mix.shape[-1] / FS
    log(f"  train step B {B}: kernel route {times['kernel']:.3f} ms (rtf_train "
        f"{audio_s * 1e3 / times['kernel']:.1f}), plain route {times['plain']:.3f} ms; "
        f"the Trainer's logged step {run['step_time_ms']:.3f} ms")
    return {"launches": launches, "ms": times["kernel"], "plain_ms": times["plain"],
            "logged_step_ms": run["step_time_ms"], "peak_bytes": run["peak_bytes"],
            "route": route}


def device_batches(ds, B: int, n: int, device) -> list:
    """The first ``n`` shuffled batches of ``ds``, epoch after epoch (seeds
    7, 8, ...), on the card."""
    from convsep_tpu_torch.data.pipeline import to_device

    out, seed = [], 7
    while len(out) < n:
        for b in ds.batches(B, shuffle=True, seed=seed):
            out.append(to_device(b, device))
            if len(out) == n:
                break
        seed += 1
    return out


def bf16_against_float32(step_of, f32, b16, batches, device) -> tuple:
    """20 steps of ``step_of(preset, opt)`` with float32 and with bf16
    adadelta state from the same seed on ``batches`` (cuDNN deterministic,
    so only the state's type differs): the bf16 state's dtypes, each
    step's relative loss gap, the bf16 run's launch counts."""
    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt.checkpoint import flatten
    from convsep_tpu_torch.train.loop import create_train_state

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, p in (("float32", f32), ("bfloat16", b16)):
            st, opt = create_train_state(p, 0, device)
            step = step_of(p, opt)
            torch.cuda.synchronize()
            kernels.reset_launches()
            losses = []
            for x, y in batches:
                st, m = step(st, x, y)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            runs[name] = (torch.stack(losses).cpu().numpy().astype(np.float64),
                          dict(kernels.LAUNCHES),
                          {str(t.dtype) for t in flatten(st.opt_state).values()})
            del st
    finally:
        torch.backends.cudnn.deterministic = deterministic
    l32, l16 = runs["float32"][0], runs["bfloat16"][0]
    return runs["bfloat16"][2], np.abs(l16 - l32) / np.abs(l32), l32, runs["bfloat16"][1]


def phase_bf16_state(ds, device) -> dict:
    """dsd100, B 32, the plain update with bf16 accumulators against
    float32 ones from the same seed, as the reference measured its bound
    (``convsep_tpu/benchmark.py``'s ``b32_state_bf16`` row: the feature
    step on one seeded batch): the accumulators bf16, each of 20 steps'
    loss within ``TOL_BF16_STATE`` relative, both step times. Then the
    same from audio on 20 different batches of the synthetic tracks,
    printed: there the Wiener ratio near silent bins makes any
    perturbation grow (phase 20 saw two float32 runs part by step 7 under
    cuDNN's default algorithms), so that gap is not the state's."""
    import numpy as np
    import torch
    from convsep_tpu_torch.train.e2e import make_audio_train_step
    from convsep_tpu_torch.train.loop import create_train_state, make_train_step

    f32 = train_preset(True, optimizer_impl="xla")
    b16 = dataclasses.replace(f32, train=dataclasses.replace(
        f32.train, optimizer_state_dtype="bfloat16"))
    m, B = f32.model, f32.train.batch_size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, m.time_context, m.feat_size, m.channels_in))
                         .astype(np.float32)).to(device)
    y = torch.from_numpy(rng.normal(size=(B, m.num_sources, m.time_context, m.feat_size))
                         .astype(np.float32)).to(device)
    dtypes, rel, l32, launches = bf16_against_float32(make_train_step, f32, b16,
                                                       [(x, y)] * TRAIN_STEPS, device)
    # bf16 storage errs by at most 2^-9 of an accumulator, which moves each
    # update by at most about 2^-9 of itself: to first order the loss at
    # step k parts by at most 2^-9 of the float32 run's descent so far
    descent = np.concatenate([[0.0], np.cumsum(np.abs(np.diff(l32)))])
    limit = np.maximum(TOL_BF16_STATE, 2.0 ** -9 * descent / np.abs(l32))
    log(f"  feature step, one seeded batch: accumulator dtypes {sorted(dtypes)}; losses "
        f"(float32 state) {[round(float(v), 6) for v in l32]}")
    log(f"  bf16 against float32 state, each step's loss: max {rel.max():.3e} relative at "
        f"step {int(rel.argmax()) + 1} (the reference's bound {TOL_BF16_STATE}: "
        f"{'met' if rel.max() <= TOL_BF16_STATE else 'not met'}); the largest share of the "
        f"first-order limit {(rel / limit).max():.3f}")
    if dtypes != {"torch.bfloat16"} or not np.all(rel <= limit):
        raise AssertionError(f"bf16 state: dtypes {dtypes}, loss gaps {rel} past {limit}")
    times = {}
    for name, p in (("float32", f32), ("bfloat16", b16)):
        st, opt = create_train_state(p, 0, device)
        times[name] = time_steps(make_train_step(p, opt), st, x, y)
        del st
    log(f"  feature step B {B}, plain update: bf16 state {times['bfloat16']:.3f} ms, "
        f"float32 state {times['float32']:.3f} ms")
    _, audio_rel, _, _ = bf16_against_float32(
        make_audio_train_step, f32, b16, device_batches(ds, B, TRAIN_STEPS, device), device)
    log(f"  from audio, 20 batches (printed, not gated): each step's loss gap "
        f"{[float(f'{v:.2e}') for v in audio_rel]}")
    return {"launches": launches, "max_rel_loss_gap": float(rel.max()),
            "limit_share": float((rel / limit).max()),
            "audio_max_rel_loss_gap": float(audio_rel.max()), "ms": times["bfloat16"],
            "float32_ms": times["float32"]}


def phase_dispatch(ds, device) -> dict:
    """dsd100 kernel route, B 32, ``steps_per_dispatch`` 4: 20 steps as 5
    replays of the CUDA graph of 4 steps against 20 eager single steps from
    the same state on the same batches (cuDNN deterministic): parameters
    and accumulators bit for bit (else the largest gap, held at
    ``TOL_GRAPH`` × max|p|); the launch counts (a replay adds the capture's
    counts); then ``Trainer.fit`` with K 4 and with K 1, each its logged
    step time."""
    import tempfile

    import numpy as np
    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt.checkpoint import flatten
    from convsep_tpu_torch.train.e2e import make_audio_train_step, make_audio_train_step_multi
    from convsep_tpu_torch.train.loop import Trainer, create_train_state

    K = DISPATCH_K
    preset = train_preset(True)
    batches = device_batches(ds, preset.train.batch_size, TRAIN_STEPS, device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sa, opt = create_train_state(preset, 0, device)
        sb, _ = create_train_state(preset, 0, device)
        multi, single = make_audio_train_step_multi(preset, opt), make_audio_train_step(preset, opt)
        groups = [(torch.stack([b[0] for b in batches[g:g + K]]),
                   torch.stack([b[1] for b in batches[g:g + K]]))
                  for g in range(0, TRAIN_STEPS, K)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        graph_losses = []
        for xs, ys in groups:
            sa, m = multi(sa, xs, ys)
            graph_losses.append(m["loss"])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        graph_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        kernels.reset_launches()
        eager_losses = []
        for mix, stems in batches:
            sb, m = single(sb, mix, stems)
            eager_losses.append(m["loss"])
        torch.cuda.synchronize()
        eager_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = flatten((sa.params, sa.opt_state)), flatten((sb.params, sb.opt_state))
    exact = all(torch.equal(a[k], b[k]) for k in a) and torch.equal(
        torch.cat(graph_losses), torch.stack(eager_losses))
    pmax = max(p.abs().max().item() for p in sb.params.values())
    gap = max((a[k].float() - b[k].float()).abs().max().item() for k in a) / pmax
    per_step = {k: v // TRAIN_STEPS for k, v in eager_launches.items()}
    log(f"  {TRAIN_STEPS // K} replays of the {K}-step graph (capture and warm-up included: "
        f"{capture_s:.2f} s) against {TRAIN_STEPS} eager steps: bit for bit {exact}, largest "
        f"gap {gap:.3e} × max|p|; launches with the graph {graph_launches} (the warm-up's "
        f"2 steps on copies of the state included), eager {eager_launches}")
    if not (exact or gap <= TOL_GRAPH):
        raise AssertionError(f"the K-step graph parts from eager steps by {gap} × max|p|")
    warm = 2 if device.type == "cuda" else 0  # GraphedSteps' warm-up steps (none on a CPU)
    if graph_launches != {k: v + warm * per_step[k] for k, v in eager_launches.items()}:
        raise AssertionError(f"graph launches {graph_launches} against eager {eager_launches}")
    del sa, sb, a, b, groups, batches
    torch.cuda.empty_cache()
    fits = {}
    with tempfile.TemporaryDirectory() as root:
        for k in (K, 1):
            p = dataclasses.replace(preset, train=dataclasses.replace(
                preset.train, steps_per_dispatch=k))
            trainer = Trainer(p, from_audio=True, device=device, seed=0)
            fits[k] = fit_losses(trainer, ds, TRAIN_STEPS, os.path.join(root, f"m{k}.jsonl"),
                                 device)
            del trainer
            torch.cuda.empty_cache()
    log(f"  Trainer.fit, {TRAIN_STEPS} steps: logged step {fits[K]['step_time_ms']:.3f} ms "
        f"with the {K}-step graph, {fits[1]['step_time_ms']:.3f} ms one step a dispatch; "
        f"launches with the graph {({k: v for k, v in fits[K]['launches'].items() if v})}")
    if not all(np.isfinite(f["losses"]).all() for f in fits.values()):
        raise AssertionError(f"non-finite losses: {fits}")
    return {"launches": fits[K]["launches"], "bit_for_bit": exact, "gap_max_p": gap,
            "logged_step_ms": fits[K]["step_time_ms"],
            "logged_step_ms_k1": fits[1]["step_time_ms"]}


def phase_async_checkpoint(ds, device) -> dict:
    """``Trainer(dsd100 kernel route, workdir=...).fit(max_steps=10)`` with
    ``checkpoint_every_steps`` 5 on the asynchronous writer: two saves, the
    time each held the caller, a synchronous save of the same state beside
    them, and a restore into a fresh Trainer equal to the state bit for
    bit."""
    import tempfile

    import torch
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt import CheckpointManager
    from convsep_tpu_torch.ckpt.checkpoint import flatten
    from convsep_tpu_torch.train.loop import Trainer

    preset = train_preset(True, checkpoint_every_steps=5)
    with tempfile.TemporaryDirectory() as root:
        wd = os.path.join(root, "run")
        trainer = Trainer(preset, workdir=wd, from_audio=True, device=device, seed=0)
        blocked = []
        save = trainer._ckpt.save

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wrote = save(*args, **kw)
            if wrote:
                blocked.append((time.perf_counter() - t0) * 1e3)
            return wrote

        trainer._ckpt.save = timed
        kernels.reset_launches()
        trainer.fit(ds, max_steps=10)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        steps = trainer._ckpt.all_steps()
        # a save that finds no write in flight (saves far apart, as the
        # presets' 500 steps are), its pinned blocks cached by the last
        trainer._ckpt.wait()
        timed(11, trainer.state)
        trainer._ckpt.wait()
        apart_ms = blocked.pop()
        sync = CheckpointManager(os.path.join(root, "sync"), async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync.save(trainer.state.step, trainer.state)
        sync_ms = (time.perf_counter() - t0) * 1e3
        fresh = Trainer(preset, workdir=wd, from_audio=True, device=device, seed=1)
        step = fresh.restore()
        a, b = flatten((trainer.state.params, trainer.state.opt_state)), flatten(
            (fresh.state.params, fresh.state.opt_state))
        same = all(torch.equal(a[k], b[k]) for k in a)
    log(f"  checkpoints {steps}; the caller held {[round(v, 1) for v in blocked]} ms a save "
        f"on the asynchronous writer (the second waits for the first's write: 5 steps take "
        f"less than a write), {apart_ms:.1f} ms a save with no write in flight, "
        f"{sync_ms:.1f} ms by a synchronous save of the same state; restored step {step}, "
        f"bit for bit {same}")
    if not (steps == [5, 10] and len(blocked) == 2 and step == 10 and same
            and not trainer._ckpt.fell_back_to_sync):
        raise AssertionError(f"asynchronous checkpoints: steps {steps}, saves {blocked}, "
                             f"restored {step}, equal {same}")
    return {"launches": launches, "blocked_ms": blocked, "apart_ms": apart_ms,
            "sync_ms": sync_ms}


def phase_training_paths(device) -> dict:
    """Phases 22-26 on synthetic tracks written once: mono for dsd100 and
    multires4096, panned stereo for dsd100-stereo."""
    import tempfile

    import torch
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples

    out = {}
    with tempfile.TemporaryDirectory() as root:
        mono, stereo = os.path.join(root, "mono"), os.path.join(root, "stereo")
        sources = get_preset("dsd100").sources
        write_tracks(mono, sources)
        write_stereo_tracks(stereo, sources)

        def dataset(name, where, is_stereo=False):
            p = get_preset(name)
            return AudioSegmentDataset(where, p.sources, segment_samples(p), fs=FS,
                                       stereo=is_stereo)

        for label, name, where, is_stereo in (
                ("22", "dsd100-stereo", stereo, True), ("23", "multires4096", mono, False)):
            ds = dataset(name, where, is_stereo)
            log(f"phase {label}: {name} training from audio, full width, B "
                f"{get_preset(name).train.batch_size}, {len(ds)} "
                f"segments of {TRAIN_TRACKS} synthetic {'stereo' if is_stereo else 'mono'} "
                f"tracks, seeded weights")
            t0 = time.perf_counter()
            out[name] = phase_train_path(name, ds, device)
            log(f"  phase {label} took {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
        ds = dataset("dsd100", mono)
        for label, key, fn, what in (
                ("24", "bf16_state", phase_bf16_state,
                 "dsd100, the plain update with bf16 adadelta state against float32"),
                ("25", "dispatch", phase_dispatch,
                 f"dsd100 kernel route, steps_per_dispatch {DISPATCH_K} as one CUDA graph"),
                ("26", "async_checkpoint", phase_async_checkpoint,
                 "dsd100 kernel route, Trainer checkpoints on the asynchronous writer")):
            log(f"phase {label}: {what}")
            t0 = time.perf_counter()
            out[key] = fn(ds, device)
            log(f"  phase {label} took {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    return out


TOL_SHARDED = 1e-5           # × max|stems|: ShardedSeparator vs Separator (other synthesis route)
DIST_STOP, DIST_RESUMED = 4, 3  # mesh training: steps before the stop, steps after the restore


def phase_distributed(device, audio) -> dict:
    """Phase 27: the distributed layer on a process group of one rank
    (NCCL, a ``FileStore`` in a temporary directory, destroyed at the end).
    ``ShardedSeparator`` at highres4096 full width against ``Separator``
    (stems within ``TOL_SHARDED`` of the peak: the sharded path
    synthesizes by the inverse-DFT products and a halo overlap-add, the
    whole-track one by the Wiener+iSTFT kernel); ``StreamSeparator(mesh=)``
    against the same without a mesh, bit for bit (PCM16); and
    ``Trainer(mesh=make_mesh(data=1))`` at dsd100 B 32 from audio on the
    kernel route (``fft_impl="pallas"``, ``optimizer_impl="fused"``) with
    ``use_grain=True``, stopped mid-epoch,
    restored, and resumed on exactly the batches the host's grain order
    gives after the stop. Each path's launch counts are taken from zero
    just before it; the times print beside the card's line."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from convsep_tpu_torch import kernels
    from convsep_tpu_torch.ckpt import init_params
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples
    from convsep_tpu_torch.data.grain_pipeline import make_loader
    from convsep_tpu_torch.data.pipeline import to_device
    from convsep_tpu_torch.distributed import make_mesh
    from convsep_tpu_torch.separate import Separator, StreamSeparator
    from convsep_tpu_torch.separate.sharded import ShardedSeparator
    from convsep_tpu_torch.train.loop import Trainer

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(data=1)
            hi = get_preset("highres4096")
            state = init_params(hi.model, torch.Generator(device=device).manual_seed(0), device)
            sep = Separator(hi, state, device=device)
            sharded = ShardedSeparator(hi, state, mesh)
            want = np.array(sep(audio))
            kernels.reset_launches()
            got = np.array(sharded(audio))
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            err = float(np.abs(got - want).max())
            peak = float(np.abs(want).max())
            fused = auto_fused(hi, track_segments(hi, len(audio)))
            ms, whole_ms = time_track(sharded, audio), time_track(sep, audio)
            log(f"  highres4096 ShardedSeparator (mesh of 1): max|Δ| {err:.3e} against "
                f"Separator (peak {peak:.4f}, limit {TOL_SHARDED} × peak); {ms:.2f} ms a track, "
                f"Separator {whole_ms:.2f} ms | {CARD}")
            if not (got.shape == want.shape and err <= TOL_SHARDED * peak):
                raise AssertionError(f"sharded stems disagree: {err} of {peak}")
            if launches["fused_decode"] != (1 if fused else 0):
                raise AssertionError(f"the sharded path's decode launches: {launches}")
            out["highres4096 sharded"] = {"launches": launches, "ms": ms, "whole_ms": whole_ms,
                                          "max_abs_err": err, "peak": peak}
            del sep, sharded, state
            torch.cuda.empty_cache()

            dsd = get_preset("dsd100")
            state = init_params(dsd.model, torch.Generator(device=device).manual_seed(1), device)
            tracks = stream_tracks(audio)
            kw = dict(output_dtype="int16", input_dtype="int16", device=device)
            plain = [np.array(o) for b in StreamSeparator(dsd, state, **kw).stream(
                iter(tracks), STREAM_BATCH) for o in b]
            meshed = StreamSeparator(dsd, state, mesh=mesh, **kw)
            kernels.reset_launches()
            got = [np.array(o) for b in meshed.stream(iter(tracks), STREAM_BATCH) for o in b]
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            same = len(got) == len(plain) and all(np.array_equal(a, b)
                                                  for a, b in zip(got, plain))
            log(f"  dsd100 StreamSeparator(mesh=) over {len(tracks)} tracks: bit for bit "
                f"{same}; launches {launches}")
            if not same:
                raise AssertionError("the stream separator's stems under a mesh differ")
            out["dsd100 stream"] = {"launches": launches}
            del meshed, state
            torch.cuda.empty_cache()

            preset = train_preset(True)
            B = preset.train.batch_size
            seg = segment_samples(preset)
            root = os.path.join(tmp, "tracks")
            write_tracks(root, preset.sources)
            ds = AudioSegmentDataset(root, preset.sources, seg, fs=FS)
            order = [x for x, _ in make_loader(ds, B, seed=preset.train.seed, num_epochs=1)]
            log(f"  dataset: {len(ds)} segments, {len(order)} batches of {B} an epoch")

            def trainer():
                """A mesh Trainer whose train step records each batch, the
                batches seen, and its own step (no copy to the host)."""
                t = Trainer(preset, workdir=os.path.join(tmp, "run"), mesh=mesh,
                            from_audio=True, seed=0)
                seen, step = [], t.train_step

                def spy(state, x, y):
                    seen.append(x.cpu().numpy())
                    return step(state, x, y)

                t.train_step = spy
                return t, seen, step

            first, seen, _ = trainer()
            kernels.reset_launches()
            t0 = time.perf_counter()
            first.fit(ds, max_steps=DIST_STOP, use_grain=True)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            again, rest, again_step = trainer()
            step = again.restore()
            again.fit(ds, max_steps=DIST_STOP + DIST_RESUMED, use_grain=True)
            pos = again.data_position
            ok = bool(step == DIST_STOP and len(seen) == DIST_STOP and len(rest) == DIST_RESUMED
                  and all(np.array_equal(a, b) for a, b in zip(seen + rest, order))
                  and pos["batch_in_epoch"] == DIST_STOP + DIST_RESUMED and pos["grain"])
            log(f"  dsd100 Trainer(mesh=make_mesh(data=1)), use_grain: {DIST_STOP} steps in "
                f"{fit_s:.2f} s, restored at step {step}, {len(rest)} more on the host's "
                f"grain-order batches: {ok}; launches {launches}")
            if not ok:
                raise AssertionError("the resumed mesh Trainer did not see the unseen batches")
            if not (launches["stft"] == 2 * DIST_STOP
                    and launches["fused_adadelta"] == 2 * DIST_STOP):
                raise AssertionError(f"the mesh training path's launches: {launches}")
            mix, stems = to_device(next(ds.batches(B, shuffle=True, seed=123)), device)
            mesh_ms = time_steps(again_step, again.state, mix, stems)
            single = Trainer(preset, from_audio=True, device=device, seed=0)
            single_ms = time_steps(single.train_step, single.state, mix, stems)
            log(f"  train step B {B} (fused update): mesh of 1 {mesh_ms:.3f} ms, no mesh "
                f"{single_ms:.3f} ms | {CARD}")
            out["dsd100 training"] = {"launches": launches, "fit_s": fit_s, "ms": mesh_ms,
                                      "no_mesh_ms": single_ms}
            del first, again, single
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return out


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
    log("phase 2b: compute_dtype=bfloat16 at highres4096, B 49 (\"auto\" takes the plain bf16 "
        "decode; the fused kernel forced)")
    bf16 = phase_bf16_compute(hi_state, hi, 49, device, gen)
    torch.cuda.empty_cache()
    log("phase 3: Wiener+iSTFT kernel vs plain")
    wie = phase_wiener("highres4096", 4096, 1024, 1442, 4, device, gen, chain=True)
    wie_dsd = phase_wiener("dsd100", 1024, 512, 2882, 4, device, gen, chain=True)
    torch.cuda.empty_cache()
    # the stream path's batches (phase 17): STREAM_BATCH tracks, and 8
    wie_batches = {}
    for B in (STREAM_BATCH, 8):
        wie_batches[f"highres4096 B {B}"] = phase_wiener("highres4096", 4096, 1024, 1442, 4,
                                                         device, gen, B)
        wie_batches[f"dsd100 B {B}"] = phase_wiener("dsd100", 1024, 512, 2882, 4, device, gen, B)
        torch.cuda.empty_cache()
    log("phase 3c: the Wiener+iSTFT past 8192 points on a thread-block cluster (W 16 384, hop "
        "2048 and W 32 768, hop 4096 on the direct transform; W 10 000, hop 2500, W 20 000, "
        "hop 5000 and W 14 000, hop 3500 on the 7-smooth block core; 4 stems of a 30 s track; "
        "bf16 and f32 y, the Nyquist-row input), its A/B against the masked chain, torch.istft "
        "of the masked spectra; Bluestein's cluster forced at W 16 384, 10 000, 20 000 and "
        "14 000")
    wie_cl = phase_wiener_cluster(device, gen)
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
    stft_all = phase_stft(device, gen)
    ada = phase_adadelta(device, gen)
    torch.cuda.empty_cache()
    log("phase 5b: the second level past 65 536 points (stft_pallas at W 70 000, 131 072 and "
        "99 999 on B 32 segments; istft_pallas at the same W on a 30 s track's frames), against "
        "float64, and the dense DFT kernel forced at W 70 000")
    lvl2 = phase_level2(device, gen)
    torch.cuda.empty_cache()
    log("phase 6: training slice, dsd100 full width, B 32, synthetic stems, seeded weights")
    train = phase_train(device)
    torch.cuda.empty_cache()

    log("phase 7: iSTFT kernels vs plain (stereo highres4096 and dsd100 pallas-route shapes, "
        "the split at W 768, Bluestein at W 1000 and 6000, on a cluster at W 10 000 to 65 536, "
        "the direct and mixed clusters beside Bluestein's forced, the mixed one's radix-7 pass "
        "at W 14 000 and 56 000, the direct sum forced at W 1000 and 10 000)")
    ist = phase_istft(device, gen)
    log("phase 7b: the Wiener+iSTFT off the core (4 stems of a 30 s track): the split at W "
        "768 and 1280, Bluestein at W 1000, 6000 (the level) and 8190, hop 910 (frame pairs), "
        "the direct sum forced at W 768 and 1000, each beside the masked chain (the A/B)")
    offcore = phase_wiener_offcore(device, gen)
    torch.cuda.empty_cache()
    log("phase 7c: the iSTFT at odd nfft (W 1001, 999 Bluestein; 9999, 39 999 on a cluster), "
        "against float64")
    odd = phase_odd_istft(device, gen)
    torch.cuda.empty_cache()
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
    log("phase 11b: the fused decode at the reference rule's edges (ktaps 17 at TM 120, 16 at "
        "TM 360, J 100) and the band decode past one block's shared memory (streamed, beside "
        "the forced pieces), the streamed kernel's A/B where the band fits")
    dec_edges = phase_decode_edges(device, gen)
    band_stream = phase_band_stream(device, gen)
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
        "and 360, the Wiener+iSTFT (highres4096, dsd100, phase 7b's sizes off the core, the "
        "cluster), Wiener mask, band decode and adadelta kernels")
    dev = device_times("decode,others")
    for key, r in (("TM 120", dec), ("TM 360", dec360)):
        d = dev["decode"][key]
        r.update(device_ms=d["device_ms"], plain_device_ms=d["plain_device_ms"])
        log(f"  fused decode {key}: device {ms_str(d['device_ms'])}, plain device "
            f"{ms_str(d['plain_device_ms'])}; bound {r['bound_ms']:.3f} ms (3xTF32), "
            f"{r['f32_simt_bound_ms']:.3f} ms (float32 SIMT)")
    others = dev["others"]
    for name, r in (("wiener_istft", wie), ("wiener_istft dsd100", wie_dsd),
                    *((f"wiener_istft {key}", offcore[key]) for key, *_ in WIENER_OFFCORE_SHAPES),
                    *((f"wiener_istft {key}", wie_cl[key]) for key, *_ in WIENER_CLUSTER_SHAPES),
                    ("wiener_apply", wap["dsd100 pallas route"]), ("band_decode", band),
                    *((f"band_decode_stream {key}", band_stream[key])
                      for key in (f"C2 {c2} I {i}" for _, _, _, c2, _, i in BAND_STREAM_SHAPES)),
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
        {"stft": n, "wiener_apply": n, "istft": n, "stft_split": 0, "stft_bluestein": 0,
         "stft_cluster": 0, "stft_dft": 0, "istft_split": 0, "istft_bluestein": 0,
         "istft_cluster": 0, "istft_direct": 0,
         "wiener_istft": 0})
    st_state = init_params(st.model, torch.Generator(device=device).manual_seed(2), device)
    st_mix = stereo_mixture(0)
    stream["highres4096-stereo"] = phase_stream_route(
        "highres4096-stereo stream", StreamSeparator(st, st_state, device=device),
        StereoSeparator(st, st_state, device=device), [st_mix, 0.5 * st_mix],
        {"istft": 2, "istft_split": 0, "istft_bluestein": 0, "istft_cluster": 0,
         "istft_direct": 0,
         "wiener_istft": 0,
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
    train_paths = phase_training_paths(device)
    log("phase 27: distributed on a process group of one rank (NCCL): ShardedSeparator "
        "(highres4096), StreamSeparator(mesh=) (dsd100), Trainer(mesh=) with use_grain (dsd100)")
    t0 = time.perf_counter()
    dist_run = phase_distributed(device, audio)
    log(f"  phase 27 took {time.perf_counter() - t0:.1f} s")

    # each main path's counts, taken from zero just before it ran
    paths = {"highres4096": hi_run, "dsd100": dsd_run, "dsd100 training": train,
             "dsd100 feature training": feature_train,
             "highres4096-stereo": st_run, "dsd100 fft_impl=pallas": pl_run,
             "multires4096": mr_run, "multires4096 analysis=ct_pallas": mr_routes["ct"],
             "multires4096 decoder_impl=band_pallas": mr_routes["band"], **b10_runs,
             "highres4096 compute_dtype=bfloat16, bandconv_pallas forced (B 49)": bf16,
             **{f"{k} chunked": r for k, r in chunked.items()},
             **{f"{k} online": r for k, r in online.items()},
             **{f"{k} stream": r for k, r in stream.items()}, "dsd100 service": service,
             **cli_run["paths"], "dsd100-stereo training": train_paths["dsd100-stereo"],
             "multires4096 training": train_paths["multires4096"],
             "dsd100 training, bf16 adadelta state": train_paths["bf16_state"],
             f"dsd100 training, {DISPATCH_K}-step CUDA graph": train_paths["dispatch"],
             "dsd100 training, asynchronous checkpoints": train_paths["async_checkpoint"],
             "highres4096 sharded, mesh of 1": dist_run["highres4096 sharded"],
             "dsd100 stream, mesh of 1": dist_run["dsd100 stream"],
             "dsd100 training, mesh of 1, grain order": dist_run["dsd100 training"]}

    def launched(kernel: str) -> dict:
        by_path = {p: r["launches"][kernel] for p, r in paths.items() if r["launches"][kernel]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    # every path's STFT and iSTFT runs on the FFT core: the split,
    # Bluestein and its cluster (both directions, and the Wiener+iSTFT's
    # split, Bluestein and cluster, and the forward STFT's), the dense DFT
    # and the direct sums serve only sizes that no preset uses
    for kernel in ("stft_split", "stft_bluestein", "stft_cluster", "stft_level2", "stft_dft",
                   "istft_split", "istft_bluestein", "istft_cluster", "istft_cluster_dit",
                   "istft_cluster_mixed", "istft_level2", "istft_level2_direct",
                   "istft_direct", "wiener_istft_cluster", "wiener_istft_ny_cluster",
                   "wiener_istft_cluster_dit", "wiener_istft_ny_cluster_dit",
                   "wiener_istft_cluster_mixed", "wiener_istft_ny_cluster_mixed",
                   "wiener_istft_split", "wiener_istft_ny_split", "wiener_istft_bluestein",
                   "wiener_istft_ny_bluestein", "wiener_istft_direct", "wiener_istft_ny_direct",
                   "ct_stft_level", "ct_stft_cluster", "band_decode_stream"):
        if launched(kernel)["launches"]:
            raise AssertionError(f"a main path ran {kernel}: {launched(kernel)}")

    result = {"kernels": [
        {"name": "fused_decode", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/decoder_fused.cu",
         "replaces": "convsep_tpu/models/decoder_fused_pallas.py:194",
         **launched("fused_decode"), **dec, "stereo_tm240": dec240, "multires4096_tm360": dec360,
         "envelope_edges": dec_edges,
         "bf16_compute_b49": {k: v for k, v in bf16.items() if k != "launches"},
         "tm120_batches": {str(B): r for B, r in dec_batches.items()}},
        {"name": "wiener_istft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         **launched("wiener_istft"), **wie, "dsd100": wie_dsd, "batches": wie_batches,
         "ny": {**launched("wiener_istft_ny"), **wny}},
        {"name": "wiener_istft_split", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_split.cu (device code wiener_common.cuh, "
                   "launched by wiener_istft.cu::wiener_istft_launch)",
         "entry": "wiener_split_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "serves": "nfft = m 2^a, m in 3, 5, 9, 15, 2^a >= 16, nfft <= 8192 (768, 1280, ...): "
                   "the split run backwards, a pair of sources a block, the mask in the point "
                   "loads; no preset",
         **launched("wiener_istft_split"), **offcore["W 768 split"],
         "w1280_hop320": offcore["W 1280 split"],
         "ny": {**launched("wiener_istft_ny_split"),
                "max_abs_err_768": offcore["W 768 split"]["ny_max_abs_err"]}},
        {"name": "wiener_istft_bluestein", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_bluestein.cu (device code "
                   "wiener_common.cuh, launched by wiener_istft.cu::wiener_istft_launch)",
         "entry": "wiener_bluestein_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "serves": "the other even nfft <= 8192 (1000, 2000, 6000, 8190): Bluestein run "
                   "backwards, a pair of sources a block (past 4096 on the 16 384-point level; "
                   "frame pairs of one source where two carries do not fit), the mask in the "
                   "point loads; no preset",
         **launched("wiener_istft_bluestein"), **offcore["W 1000 Bluestein"],
         "w6000_hop1500": offcore["W 6000 Bluestein"],
         "w8190_hop910_frame_pairs": offcore["W 8190 Bluestein frame pairs"],
         "ny": {**launched("wiener_istft_ny_bluestein"),
                "max_abs_err_8190": offcore["W 8190 Bluestein frame pairs"]["ny_max_abs_err"]}},
        {"name": "wiener_istft_direct", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu", "entry": "wiener_direct_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "serves": "no size of wiener_istft; wiener_direct_pallas forces it at any even nfft "
                   "<= 8192 off the core (timed forced at W 768 and 1000, beside the split and "
                   "Bluestein that replaced it); no preset",
         **launched("wiener_istft_direct"), **offcore["W 768 direct sum"],
         "forced_w1000": offcore["W 1000 direct sum"]},
        {"name": "wiener_istft_cluster_dit", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu (device code wiener_common.cuh, "
                   "fft_common.cuh::ClusterDit)", "entry": "wiener_cluster_dit_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "serves": "the powers of two past 8192, the reference kernel's 16 384 and 32 768: the "
                   "direct transform by decimation in time on a thread-block cluster of 2 or 4 "
                   "blocks, a pair of sources a cluster; no preset",
         **launched("wiener_istft_cluster_dit"), **wie_cl["W 16384"],
         "w32768_hop4096": wie_cl["W 32768"],
         "bluestein_forced_w16384": wie_cl["W 16384 Bluestein"],
         "clusters_at_once_2": wie_cl["clusters_at_once_cluster_dit_2"],
         "ny": {**launched("wiener_istft_ny_cluster_dit"),
                "max_abs_err_16384": wie_cl["W 16384"]["ny_max_abs_err"],
                "max_abs_err_32768": wie_cl["W 32768"]["ny_max_abs_err"]}},
        {"name": "wiener_istft_cluster_mixed", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu (device code wiener_common.cuh, "
                   "fft_common.cuh::ClusterMixed)", "entry": "wiener_cluster_mixed_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "serves": "the 7-smooth even nfft = C n, C 2 to 6, from 8232 to 32 400 where it "
                   "won its A/B (fft_plan.WIENER_MIXED_WON: 10 000, 14 000, 20 000, 22 050, "
                   "...): the "
                   "direct transform by decimation in time on a thread-block cluster, each "
                   "block's n points on the mixed-radix core, a pair of sources a cluster; no "
                   "preset",
         **launched("wiener_istft_cluster_mixed"), **wie_cl["W 10000"],
         "w20000_hop5000": wie_cl["W 20000"], "w14000_hop3500": wie_cl["W 14000"],
         "w22050_hop4410": wie_cl["W 22050"],
         "bluestein_forced_w10000": wie_cl["W 10000 Bluestein"],
         "bluestein_forced_w20000": wie_cl["W 20000 Bluestein"],
         "bluestein_forced_w14000": wie_cl["W 14000 Bluestein"],
         "bluestein_forced_w22050": wie_cl["W 22050 Bluestein"],
         **{f"clusters_at_once_{c}": wie_cl[f"clusters_at_once_cluster_mixed_{c}"]
            for c in (2, 3, 4, 5, 6)},
         "ny": {**launched("wiener_istft_ny_cluster_mixed"),
                "max_abs_err_10000": wie_cl["W 10000"]["ny_max_abs_err"],
                "max_abs_err_20000": wie_cl["W 20000"]["ny_max_abs_err"],
                "max_abs_err_14000": wie_cl["W 14000"]["ny_max_abs_err"],
                "max_abs_err_22050": wie_cl["W 22050"]["ny_max_abs_err"]}},
        {"name": "wiener_istft_cluster", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_istft.cu", "entry": "wiener_cluster_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:571",
         "serves": "even 8192 < nfft < 32 768 off the powers of two and the mixed cluster's "
                   "won sizes (8194, 11 264): Bluestein run backwards on a thread-block cluster "
                   "of 4 or 8 blocks, a pair of sources a cluster; "
                   "wiener_bluestein_cluster_pallas forces it at the powers of two and the "
                   "7-smooth sizes (timed forced at W 20 000, 10 000, 16 384, 14 000 and "
                   "22 050); no preset",
         **launched("wiener_istft_cluster"), **wie_cl["W 20000 Bluestein"],
         "forced_w10000_hop2500": wie_cl["W 10000 Bluestein"],
         "forced_w16384_hop2048": wie_cl["W 16384 Bluestein"],
         "forced_w14000_hop3500": wie_cl["W 14000 Bluestein"],
         "forced_w22050_hop4410": wie_cl["W 22050 Bluestein"],
         "ny": {**launched("wiener_istft_ny_cluster"),
                "max_abs_err_20000": wie_cl["W 20000 Bluestein"]["ny_max_abs_err"]}},
        {"name": "stft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_fft_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         **launched("stft"), **stft_all["stft"], "route_check": train["route"]},
        {"name": "stft_split", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_split_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         "serves": "nfft = m 2^a, m in 3, 5, 9, 15, 2^a >= 16, nfft <= 8192; no preset",
         **launched("stft_split"), **stft_all["stft_split"],
         "w1280_hop320": stft_all["stft_split W 1280"]},
        {"name": "stft_bluestein", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_bluestein_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         "serves": "nfft <= 8192 that neither the FFT core nor its split plans (1000 = 8 125, "
                   "a factor 7, odd sizes; past 4096 on the 16 384-point level, as 6000); "
                   "no preset",
         **launched("stft_bluestein"), **stft_all["stft_bluestein"],
         "w6000_hop1500": stft_all["stft_bluestein W 6000"]},
        {"name": "stft_cluster", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_cluster_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         "serves": "8192 < nfft <= 65 536 (12 288, 20 000, 40 000, odd sizes): Bluestein on a "
                   "thread-block cluster of 4, 8 or 16 blocks; no preset",
         **launched("stft_cluster"), **stft_all["stft_cluster"],
         "w20000_hop5000": stft_all["stft_cluster W 20000"],
         "w40000_hop10000": stft_all["stft_cluster W 40000"],
         "w65536_hop16384": stft_all["stft_cluster W 65536"]},
        {"name": "stft_level2", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu",
         "entry": "stft_level2_first_kernel, stft_level2_middle_kernel, stft_level2_last_kernel, "
                  "stft_level2_split_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         "serves": "65 536 < nfft <= 262 144 (70 000, 131 072, odd sizes): Bluestein on the "
                   "second level, M 262 144 or 524 288 over two passes through a scratch in "
                   "device memory; one count a call (four phase launches a round); no preset",
         **launched("stft_level2"), **lvl2["stft_level2"],
         "w131072_hop32768": lvl2["stft_level2 W 131072"],
         "w99999_hop33333": lvl2["stft_level2 W 99999"]},
        {"name": "stft_dft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/stft_dft.cu", "entry": "stft_dft_kernel",
         "replaces": "convsep_tpu/dsp/pallas/stft_kernel.py:88",
         "serves": "nfft past 262 144; stft_dft_pallas forces it at any size (timed forced at W "
                   "12 288, 40 000 and 70 000, the cluster's and the second level's shapes); no "
                   "preset",
         **launched("stft_dft"), **stft_all["stft_dft W 12288"],
         "forced_w40000": stft_all["stft_dft W 40000"],
         "forced_w70000": {"ms": lvl2["stft_level2"]["dense_ms"],
                           "max_abs_err": lvl2["stft_level2"]["dense_max_abs_err"]},
         "forced_w768": stft_all["stft_dft W 768"],
         "forced_w1280": stft_all["stft_dft W 1280"],
         "forced_w1000": stft_all["stft_dft W 1000"],
         "forced_w6000": stft_all["stft_dft W 6000"]},
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
        {"name": "istft_split", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu", "entry": "istft_split_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "nfft = m 2^a, m in 3, 5, 9, 15, 2^a >= 16, nfft <= 8192; no preset",
         **launched("istft_split"), **ist["W 768 split"]},
        {"name": "istft_bluestein", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu", "entry": "istft_bluestein_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "even nfft <= 8192 that neither the FFT core nor its split plans (1000 = "
                   "8 125, a factor 7; past 4096 on the 16 384-point level, as 6000); no preset",
         **launched("istft_bluestein"), **ist["W 1000 Bluestein"],
         "w6000_hop1500": ist["W 6000 Bluestein"],
         "odd_w1001_hop143": odd["W 1001 odd"], "odd_w999_hop333": odd["W 999 odd"]},
        {"name": "istft_cluster", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu", "entry": "istft_cluster_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "8192 < nfft <= 65 536 off the powers of two and the mixed cluster's won "
                   "sizes (8194, 11 264, odd sizes): Bluestein run backwards on a thread-block "
                   "cluster of 4, 8 or 16 blocks; istft_bluestein_cluster_pallas forces it at "
                   "the powers of two and the won sizes (timed forced at W 10 000, 20 000, "
                   "40 000, 14 000, 56 000, 11 025, 22 050 and 44 100); no preset",
         **launched("istft_cluster"), **ist["W 10000 cluster"],
         "w20000_hop5000": ist["W 20000 cluster"],
         "w40000_hop10000": ist["W 40000 cluster"],
         "w14000_hop3500": ist["W 14000 cluster"],
         "w56000_hop14000": ist["W 56000 cluster"],
         "w11025_hop2205": ist["W 11025 cluster"],
         "w22050_hop4410": ist["W 22050 cluster"],
         "w44100_hop11025": ist["W 44100 cluster"],
         "forced_w16384_hop2048": ist["W 16384 Bluestein"],
         "forced_w32768_hop4096": ist["W 32768 Bluestein"],
         "forced_w65536_hop16384": ist["W 65536 Bluestein"],
         "odd_w9999_hop1111": odd["W 9999 odd cluster"],
         "odd_w39999_hop13333": odd["W 39999 odd cluster"]},
        {"name": "istft_cluster_dit", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu (device code "
                   "fft_common.cuh::istft_cluster_dit_block)",
         "entry": "istft_cluster_dit_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "the powers of two past 8192 (the reference's 16 384 and 32 768, and "
                   "65 536): the direct inverse by decimation in time on a thread-block "
                   "cluster of 2, 4 or 8 blocks; no preset",
         **launched("istft_cluster_dit"), **ist["W 16384 cluster_dit"],
         "w32768_hop4096": ist["W 32768 cluster_dit"],
         "w65536_hop16384": ist["W 65536 cluster_dit"]},
        {"name": "istft_cluster_mixed", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu (device code "
                   "fft_common.cuh::istft_cluster_mixed_block)",
         "entry": "istft_cluster_mixed_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "nfft = C n past 8192, C 2 to 8, n 7-smooth (10 000, 14 000, 20 000, "
                   "40 000, 56 000, the odd 11 025, 22 050, 44 100; 281 sizes, 40 odd), where "
                   "it won its A/B (fft_plan.ISTFT_MIXED_WON): the direct inverse by "
                   "decimation in time on a thread-block cluster, each block's n points on a "
                   "mixed-radix core; no preset",
         **launched("istft_cluster_mixed"), **ist["W 10000 cluster_mixed"],
         "w20000_hop5000": ist["W 20000 cluster_mixed"],
         "w40000_hop10000": ist["W 40000 cluster_mixed"],
         "w14000_hop3500": ist["W 14000 cluster_mixed"],
         "w56000_hop14000": ist["W 56000 cluster_mixed"],
         "w11025_hop2205": ist["W 11025 cluster_mixed"],
         "w22050_hop4410": ist["W 22050 cluster_mixed"],
         "w44100_hop11025": ist["W 44100 cluster_mixed"],
         **{f"clusters_at_once_{c}": ist[f"clusters_at_once_cluster_mixed_{c}"]
            for c in (5, 7)}},
        {"name": "istft_level2", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu",
         "entry": "istft_level2_first_kernel, istft_level2_middle_kernel, "
                  "istft_level2_last_kernel, istft_level2_ola_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "65 536 < nfft <= 262 144, any parity, off fft_plan.ISTFT_LEVEL2_DIRECT_WON "
                   "(99 999, 131 073, 70 001): Bluestein run backwards on the second level, "
                   "then an overlap-add of the frames' samples; one count a call; timed forced "
                   "(istft_level2_bluestein_pallas) at W 70 000, 131 072 and 200 000; no preset",
         **launched("istft_level2"), **lvl2["istft_level2 W 99999"],
         "forced_w70000_hop17500": lvl2["istft_level2"],
         "forced_w131072_hop32768": lvl2["istft_level2 W 131072"],
         "forced_w200000_hop50000": lvl2["istft_level2 W 200000"]},
        {"name": "istft_level2_direct", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu (device code "
                   "fft_common.cuh::level2_direct_combine, level2_direct_rows, "
                   "level2_direct_overlap_add)",
         "entry": "istft_level2_direct_combine_kernel, istft_level2_direct_rows_kernel, "
                  "istft_level2_direct_ola_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "nfft = R n past 65 536 up to 262 144, R 16 or 32, n 7-smooth (70 000, "
                   "131 072, 200 000; 138 sizes) where it won its A/B "
                   "(fft_plan.ISTFT_LEVEL2_DIRECT_WON): the direct inverse on the second level, "
                   "a radix-R combine and R rows on the mixed-radix core, no chirp; one count "
                   "a call; no preset",
         **launched("istft_level2_direct"), **lvl2["istft_level2_direct"],
         "w131072_hop32768": lvl2["istft_level2_direct W 131072"],
         "w200000_hop50000": lvl2["istft_level2_direct W 200000"]},
        {"name": "istft_direct", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/istft.cu", "entry": "istft_direct_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_istft_kernel.py:315; "
                     "convsep_tpu/dsp/pallas/istft_kernel.py:107, :146",
         "serves": "no size of istft_pallas; istft_direct_pallas forces it at any even size "
                   "up to 12 800 (timed forced at W 10 000, the cluster's shape); no preset",
         **launched("istft_direct"), **ist["W 10000 direct sum"],
         "forced_w1000": ist["W 1000 direct sum"]},
        {"name": "wiener_apply", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/wiener_apply.cu",
         "replaces": "convsep_tpu/dsp/pallas/wiener_kernel.py:77",
         **launched("wiener_apply"), **wap["dsd100 pallas route"],
         "highres4096": wap["highres4096"]},
        {"name": "ct_stft", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/ct_stft.cu",
         "replaces": "convsep_tpu/dsp/pallas/ct_stft_kernel.py:187",
         **launched("ct_stft"), **ct["ct_stft"]},
        {"name": "ct_stft_level", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/ct_stft.cu", "entry": "ct_stft_level_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_stft_kernel.py:187",
         "serves": "nfft 16 384, the reference kernel's largest: one 16 384-point transform a "
                   "pair of frames on the FFT core's level; no preset",
         **launched("ct_stft_level"), **ct["ct_stft W 16384"]},
        {"name": "ct_stft_cluster", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/ct_stft.cu", "entry": "ct_stft_cluster_kernel",
         "replaces": "convsep_tpu/dsp/pallas/ct_stft_kernel.py:187",
         "serves": "no route: stft_ct_cluster_pallas forces it at 16 384 (Bluestein on a "
                   "thread-block cluster of 4 blocks), timed beside the level that replaced it",
         **launched("ct_stft_cluster"), **ct["ct_stft_cluster W 16384"]},
        {"name": "band_decode", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/band_decode.cu",
         "replaces": "convsep_tpu/models/decoder_pallas.py:80",
         **launched("band_decode"), **band,
         "pieces_forced": {k: band_stream[k]["pieces_forced"] for k in band_stream if k != "ab"},
         "ab_resident_ms": band_stream["ab"]["resident_ms"]},
        {"name": "band_decode_stream", "route": "cuda",
         "source": "convsep_tpu_torch/csrc/band_stream.cu (kernel in band_stream.cuh; widths "
                   "72-256 in band_stream_n128.cu, band_stream_n192.cu, band_stream_n256.cu)",
         "entry": "band_stream_kernel",
         "replaces": "convsep_tpu/models/decoder_pallas.py:80",
         "serves": "bands whose taps and 64-row z tile do not fit one block's shared memory "
                   "(twice a preset's channels or more) and the shapes in BAND_STREAM_WON: "
                   "slabs of z and of the taps streamed by TMA through a ring, one launch; "
                   "no preset",
         **launched("band_decode_stream"), **band_stream["C2 128 I 64"],
         "c2_100_i100": band_stream["C2 100 I 100"], "ab": band_stream["ab"]},
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
        "highres4096 sharded, mesh of 1": {
            "sharded": dist_run["highres4096 sharded"]["ms"],
            "whole_track": dist_run["highres4096 sharded"]["whole_ms"]},
    }, "distributed_training_step_ms": {
        "mesh of 1": dist_run["dsd100 training"]["ms"],
        "no mesh": dist_run["dsd100 training"]["no_mesh_ms"]}, "feature_training": {k: v for k, v in feature_train.items() if k != "launches"},
        "training_paths": {k: {f: v for f, v in r.items() if f not in ("launches", "route")}
                           for k, r in train_paths.items()},
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
