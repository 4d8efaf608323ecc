#!/usr/bin/env python3
"""Whole-track separation on one CUDA GPU: ms per 30 s track with the stems
copied to pinned and to pageable host memory, or where the device time
goes (convsep_tpu_torch; no JAX).

    python3 tools/torch_time_separate.py [--profile] [--only NAME ...] [--out FILE]

Eight slices at full width with seeded random weights on the 30 s mixture
of ``chip_smoke.py`` (its stereo mixture for the stereo preset):
highres4096 and dsd100 (``Separator``, matmul route), dsd100 with
``fft_impl="pallas"``, highres4096-stereo (``StereoSeparator``),
multires4096 on its three routes ("auto", ``analysis="ct_pallas"``,
``decoder_impl="band_pallas"``) and bach10 with ``chip_smoke.py``'s score
channels at score_gate 0.5 "mult". ``--only`` keeps the named slices.

Without ``--profile``: the host clock around each call (it ends in the
stems' host copy), median of 5 after one warm-up, in turns pageable,
pinned, pinned, pageable; "pageable" swaps ``utils.transfer.fetch`` for
``tensor.cpu()``. With ``--profile``: ``torch.profiler`` over 3 calls
after 3 warm-ups per slice: wall ms per track, device busy ms (device
kernel and memcpy time on the one stream) and the largest device items.
A profiler session slows the host for the rest of the process, so run
the two modes as two processes. ``--out`` writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from convsep_tpu_torch.ckpt import init_params  # noqa: E402
from convsep_tpu_torch.configs import get_preset  # noqa: E402
from convsep_tpu_torch.separate import Separator, StereoSeparator  # noqa: E402
from convsep_tpu_torch.separate import pipeline, stereo  # noqa: E402
from convsep_tpu_torch.utils.transfer import fetch  # noqa: E402
from tools.torch_profile_train import device_rows  # noqa: E402


def bach10_extra(preset, audio, dev):
    """The score channels ``chip_smoke.py`` feeds bach10 (its fixed notes)."""
    from convsep_tpu_torch.data.features import score_channels
    from convsep_tpu_torch.dsp.transform import TransformFFT

    mag = TransformFFT(preset.transform, device=dev).compute_file(audio)
    return score_channels(mag, cs.bach10_notes(), preset, "comb") * preset.train.mult_factor_in


def slices(dev, only=None):
    """(name, separator, audio, call kwargs) for each slice, built one at a
    time."""
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
        yield name, cls(preset, state, device=dev), audio, kw
        del state
        torch.cuda.empty_cache()


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
    for name, sep, audio, kw in slices(dev, args.only):
        if args.profile:
            for _ in range(3):
                sep(audio, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(3):
                    sep(audio, **kw)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 3
            rows = device_rows(prof, 3)
            busy = sum(r[1] for r in rows)
            print(f"{name}: wall {wall:.3f} ms/track (profiled), device busy {busy:.3f} ms "
                  f"({100 * busy / wall:.1f} %), {sum(r[2] for r in rows)} device items")
            for key, ms, count in rows[:10]:
                print(f"  {ms:8.3f} ms  x{count:<3d} {key[:100]}")
            out[name] = {"wall_ms": wall, "busy_ms": busy, "top": rows[:20]}
        else:
            times = {"pageable": [], "pinned": []}
            for mode in ("pageable", "pinned", "pinned", "pageable"):
                set_fetch(pageable if mode == "pageable" else fetch)
                times[mode].append(cs.time_track(sep, audio, **kw))
            set_fetch(fetch)
            print(f"{name}: ms per track, stems to pageable memory {times['pageable']}, "
                  f"to pinned memory {times['pinned']}")
            out[name] = times
        del sep
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(out["smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
