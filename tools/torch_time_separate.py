#!/usr/bin/env python3
"""Separation on one CUDA GPU, whole-track and streaming: ms per 30 s track,
or where the device time goes and whether the copies overlap the kernels
(convsep_tpu_torch; no JAX).

    python3 tools/torch_time_separate.py [--profile] [--only NAME ...] [--out FILE]

Slices at full width with seeded random weights on the 30 s mixture of
``chip_smoke.py`` (its stereo mixture for the stereo preset). Whole track,
float32: highres4096 and dsd100 (``Separator``, matmul route), dsd100 with
``fft_impl="pallas"``, highres4096-stereo (``StereoSeparator``),
multires4096 on its three routes ("auto", ``analysis="ct_pallas"``,
``decoder_impl="band_pallas"``) and bach10 with ``chip_smoke.py``'s score
channels at score_gate 0.5 "mult". Streaming, PCM16 in and out, for
highres4096 and dsd100: the whole track (``Separator``, "PCM16"),
``ChunkedSeparator`` (chunk_segments 32), ``OnlineSeparator``
(chunk_segments 8, 16 384-sample pushes, then flush) and ``StreamSeparator``
(``chip_smoke.stream_tracks``: 6 tracks in batches of 2). ``--only`` keeps
the named slices.

Without ``--profile``: the host clock around each call (it ends in the
stems' host copy), median of 5 after one warm-up, per track. The float32
whole-track slices run in turns pageable, pinned, pinned, pageable
("pageable" swaps ``utils.transfer.fetch`` for ``tensor.cpu()``); the
streaming slices copy through ``fetch_async`` only, "pinned" 4 times.

With ``--profile``: ``torch.profiler`` over 3 calls after 3 warm-ups per
slice; from its trace (every kernel and memory copy with its start and
length on the device), per track: the profiled wall time, the device
busy time (the union of all kernel and copy intervals, so work that runs
on two streams at once counts once), the kernel and copy times, the copy
time that ran while a kernel ran, and the largest device items (each
item's own time summed). For the streaming slices the model's decode is
then profiled alone at the batch the slice gives it (its route as "auto"
takes it), with every device item it runs. A profiler session slows the
host for the rest of the process, so run the two modes as two processes.
``--out`` writes the numbers as JSON. Prints the card's name and power
limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch.ckpt import init_params  # noqa: E402
from convsep_tpu_torch.configs import get_preset  # noqa: E402
from convsep_tpu_torch.separate import (  # noqa: E402
    ChunkedSeparator,
    OnlineSeparator,
    Separator,
    StereoSeparator,
    StreamSeparator,
)
from convsep_tpu_torch.separate import pipeline, stereo  # noqa: E402
from convsep_tpu_torch.utils.pcm import quantize_pcm16_host  # noqa: E402
from convsep_tpu_torch.utils.transfer import fetch  # noqa: E402
from tools.torch_profile_train import device_rows  # noqa: E402

PCM16 = dict(output_dtype="int16", input_dtype="int16")


def bach10_extra(preset, audio, dev):
    """The score channels ``chip_smoke.py`` feeds bach10 (its fixed notes)."""
    from convsep_tpu_torch.data.features import score_channels
    from convsep_tpu_torch.dsp.transform import TransformFFT

    mag = TransformFFT(preset.transform, device=dev).compute_file(audio)
    return score_channels(mag, cs.bach10_notes(), preset, "comb") * preset.train.mult_factor_in


def whole_slices(dev, only):
    """(name, call, tracks per call, None) of the float32 whole-track
    slices, built one at a time; their stems go through ``fetch``."""
    mono, mr, b10 = cs.mixture(0), get_preset("multires4096"), get_preset("bach10")
    b10 = cs.with_fields(b10, sep={"score_gate": 0.5, "score_gate_mode": "mult"})
    for name, preset, cls, audio in (
        ("highres4096", get_preset("highres4096"), Separator, mono),
        ("dsd100", get_preset("dsd100"), Separator, mono),
        ("dsd100 fft_impl=pallas", cs.with_fields(get_preset("dsd100"),
                                                  transform={"fft_impl": "pallas"}),
         Separator, mono),
        ("highres4096-stereo", get_preset("highres4096-stereo"), StereoSeparator,
         cs.stereo_mixture(0)),
        ("multires4096", mr, Separator, mono),
        ("multires4096 analysis=ct_pallas", cs.with_fields(mr, transform={"analysis": "ct_pallas"}),
         Separator, mono),
        ("multires4096 decoder_impl=band_pallas",
         cs.with_fields(mr, model={"decoder_impl": "band_pallas"}), Separator, mono),
        ("bach10 score_gate=0.5 mult", b10, Separator, mono),
    ):
        if only and name not in only:
            continue
        state = init_params(preset.model, torch.Generator(device=dev).manual_seed(0), dev)
        kw = {"extra": bach10_extra(preset, audio, dev)} if preset.name == "bach10" else {}
        sep = cls(preset, state, device=dev)
        del state
        yield name, (lambda sep=sep, audio=audio, kw=kw: sep(audio, **kw)), 1, None
        del sep
        torch.cuda.empty_cache()


def streaming_slices(dev, only):
    """(name, call, tracks per call, (model, decode batch)) of the PCM16
    slices, built one at a time."""
    audio = cs.mixture(0)
    pcm = quantize_pcm16_host(audio)
    tracks = cs.stream_tracks(audio)
    for preset_name in ("highres4096", "dsd100"):
        preset = get_preset(preset_name)
        segments = cs.track_segments(preset, len(pcm))
        kinds = {
            "PCM16": (lambda st: Separator(preset, st, device=dev, **PCM16), segments),
            "chunked": (lambda st: ChunkedSeparator(preset, st, chunk_segments=cs.CHUNK_SEGMENTS,
                                                    device=dev, **PCM16), cs.CHUNK_SEGMENTS),
            "online": (lambda st: OnlineSeparator(preset, st, chunk_segments=cs.ONLINE_SEGMENTS,
                                                  device=dev, **PCM16), cs.ONLINE_SEGMENTS),
            "stream": (lambda st: StreamSeparator(preset, st, device=dev, **PCM16),
                       cs.STREAM_BATCH * segments),
        }
        state = None
        for kind, (make, batch) in kinds.items():
            name = f"{preset_name} {kind}"
            if only and name not in only:
                continue
            if state is None:
                state = init_params(preset.model, torch.Generator(device=dev).manual_seed(0), dev)
            sep = make(state)
            if kind == "online":
                def call(sep=sep):
                    for i in range(0, len(pcm), cs.ONLINE_BLOCK):
                        sep.push(pcm[i:i + cs.ONLINE_BLOCK])
                    sep.flush()
                    sep.reset()
                yield name, call, 1, (sep.model, batch)
            elif kind == "stream":
                yield name, (lambda sep=sep: [len(b) for b in sep.stream(
                    iter(tracks), batch_size=cs.STREAM_BATCH)]), len(tracks), (sep.model, batch)
            else:
                yield name, (lambda sep=sep: sep(pcm)), 1, (sep.model, batch)
            del sep
            torch.cuda.empty_cache()
        del state
        torch.cuda.empty_cache()


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def intersect(x, y) -> float:
    """Total length of the intersection of two sorted disjoint unions."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_intervals(prof) -> tuple[list, list]:
    """(kernel intervals, memory copy and set intervals) in ms, each a
    union, from the profiler's trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kern, copy = [], []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if "dur" not in e:
            continue
        iv = (e["ts"] / 1e3, (e["ts"] + e["dur"]) / 1e3)
        if cat == "kernel":
            kern.append(iv)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copy.append(iv)
    return union(kern), union(copy)


def profiled(call, per: int, n: int = 3) -> dict:
    """``call`` under the profiler, ``n`` calls after 3 warm-ups; times per
    track (``per`` tracks a call)."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (n * per)
    kern, copy = device_intervals(prof)
    per_track = n * per
    return {"wall_ms": wall, "busy_ms": length(union(kern + copy)) / per_track,
            "kernel_ms": length(kern) / per_track, "copy_ms": length(copy) / per_track,
            "copy_under_kernel_ms": intersect(kern, copy) / per_track,
            "top": device_rows(prof, per_track)[:20]}


def decode_alone(model, B: int, dev) -> dict:
    """The model's decode at batch ``B`` on the route "auto" takes there,
    profiled alone: device busy per call and every device item."""
    from convsep_tpu_torch.models.convsep import _DTYPES, resolve_decoder_impl
    from convsep_tpu_torch.models.decoder_fused_cuda import (
        band_freq_decode,
        band_freq_decode_plain,
    )
    from convsep_tpu_torch.utils.precision import float32_exact

    route = resolve_decoder_impl(model.config, dev, B)
    decode = band_freq_decode if route == "bandconv_pallas" else band_freq_decode_plain
    md = _DTYPES[model.config.mask_dtype]
    gen = torch.Generator(device=dev).manual_seed(7)
    fc = torch.relu(torch.randn(B, model.k4.shape[0], generator=gen, device=dev))

    def call():
        with float32_exact():
            decode(fc, model.k4, model.b3, model.kcat, out_dtype=md)

    r = profiled(call, 1)
    return {"route": route, "B": B, "busy_ms": r["busy_ms"], "items": r["top"]}


def time_call(call, per: int, reps: int = 5) -> float:
    """Median host ms per track of ``call()`` after one warm-up."""
    call()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3 / per)
    return sorted(times)[reps // 2]


def set_fetch(fn) -> None:
    pipeline.fetch = fn
    stereo.fetch = fn


def pageable(t: torch.Tensor):
    return t.cpu().numpy()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only", nargs="*", default=None, help="slice names to run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_time_separate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"smi": cs.smi_line()}
    print(f"card: {out['smi']}", flush=True)
    # one slice built at a time: each generator builds its next separator
    # only when the loop asks for it
    for swap, (name, call, per, decode) in itertools.chain(
        ((True, s) for s in whole_slices(dev, args.only)),
        ((False, s) for s in streaming_slices(dev, args.only)),
    ):
        if args.profile:
            r = profiled(call, per)
            print(f"{name}: wall {r['wall_ms']:.3f} ms/track (profiled), device busy "
                  f"{r['busy_ms']:.3f} ms ({100 * r['busy_ms'] / r['wall_ms']:.1f} %), kernels "
                  f"{r['kernel_ms']:.3f} ms, copies {r['copy_ms']:.3f} ms of which "
                  f"{r['copy_under_kernel_ms']:.3f} ms under a kernel | {out['smi']}", flush=True)
            for key, ms, count in r["top"][:10]:
                print(f"  {ms:8.3f} ms  x{count:<4d} {key[:100]}")
            if decode is not None:
                d = decode_alone(*decode, dev)
                r["decode_alone"] = d
                print(f"  decode alone at B {d['B']} ({d['route']}): device busy "
                      f"{d['busy_ms']:.3f} ms a call; items:", flush=True)
                for key, ms, count in d["items"]:
                    print(f"    {ms:8.3f} ms  x{count:<3d} {key[:100]}")
            out[name] = r
        elif swap:
            times = {"pageable": [], "pinned": []}
            for mode in ("pageable", "pinned", "pinned", "pageable"):
                set_fetch(pageable if mode == "pageable" else fetch)
                times[mode].append(time_call(call, per))
            set_fetch(fetch)
            print(f"{name}: ms per track, stems to pageable memory {times['pageable']}, "
                  f"to pinned memory {times['pinned']}", flush=True)
            out[name] = times
        else:
            times = {"pinned": [time_call(call, per) for _ in range(4)]}
            print(f"{name}: ms per track (fetch_async, pinned) {times['pinned']}", flush=True)
            out[name] = times
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(out["smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
