"""Command-line interface of the port: the reference CLI's nine verbs.

    convsep-torch compute-features --preset dsd100 --audio-dir DSD100/Dev --out feats/
    convsep-torch train            --preset dsd100 --features feats/ --workdir runs/d1
    convsep-torch separate         --preset dsd100 --params runs/d1/checkpoints -i mix.wav -o stems/
    convsep-torch separate         --preset ikala  --params model.pkl -i mix.wav -o stems/
    convsep-torch separate-batch   --preset dsd100 --params model.pkl --input-dir mixes/ -o stems/
    convsep-torch serve            --preset dsd100 --params model.pkl --input-dir inbox/ -o stems/
    convsep-torch evaluate         --ref-dir true_stems/ --est-dir stems/
    convsep-torch convert          --preset dsd100 --input model.pkl --out ckpt/
    convsep-torch profile          --preset highres4096
    convsep-torch bench            --preset dsd100 --seconds 30

(also ``python -m convsep_tpu_torch.cli``). Every verb takes the flags of
``convsep``'s and ``--device``: "cuda" by default, which raises without a
GPU; ``--device cpu`` runs on the CPU. The verbs run the package's own
entry points, so the kernels and routes are the ones the library
resolves. ``--params`` takes a checkpoint directory of this package
(``ckpt/checkpoint.py``, the newest step) or a reference pickle. ``train
--from-audio`` with a ``*-stereo`` preset trains on both channels;
``--grain`` feeds it in grain's order. ``--mesh-data N`` (train,
separate-batch, serve) runs on a data mesh of N ranks, one process a
device, under a launcher that starts them (``torchrun --nproc_per_node=N
-m convsep_tpu_torch <verb> --mesh-data N …``; NCCL on the GPUs, gloo with
``--device cpu``); N > 1 without one raises. ``--launches``
(before the verb) prints the hand-written kernels' launch counts as one
line on stderr when the verb ends.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np

DECODER_IMPLS = ("auto", "bandconv", "bandconv_pallas", "band", "band_pallas")
MESH_HELP = ("data-parallel mesh size: the ranks a launcher started (torchrun "
             "--nproc_per_node=N); > 1 without a launcher raises")


def _replace(preset, part: str, **kw):
    return dataclasses.replace(preset, **{part: dataclasses.replace(getattr(preset, part), **kw)})


_OWN_GROUP = False  # a process group _mesh initialized, which main() destroys


def _mesh(n: int, device: str | None):
    """``--mesh-data``: a data mesh of ``n`` ranks over the process group a
    launcher started (``WORLD_SIZE`` set; the group is initialized here
    from its environment), or None for one process without a launcher."""
    world = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if world == 0:
        if n > 1:
            raise ValueError(
                f"--mesh-data {n} needs {n} processes, one a device, started by a launcher: "
                f"torchrun --nproc_per_node={n} -m convsep_tpu_torch <verb> --mesh-data {n} …")
        return None
    import torch.distributed as dist

    from convsep_tpu_torch.distributed import make_mesh

    global _OWN_GROUP
    cpu = str(device or "cuda").startswith("cpu")
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
        _OWN_GROUP = True
    return make_mesh(data=n, device="cpu" if cpu else None)


def _cmd_compute_features(args) -> int:
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.features import compute_features

    tracks = compute_features(
        args.audio_dir, args.out, get_preset(args.preset), score_informed=args.score_informed,
        layout=args.layout, augment=args.augment, score_filter=args.score_filter,
        device=args.device,
    )
    print(f"computed features for {len(tracks)} tracks -> {args.out}")
    return 0


def _cmd_train(args) -> int:
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.pipeline import SegmentDataset
    from convsep_tpu_torch.train.loop import Trainer

    preset = get_preset(args.preset)
    for flag, field in (("epochs", "num_epochs"),
                        ("checkpoint_every_epochs", "checkpoint_every_epochs"),
                        ("optimizer_impl", "optimizer_impl"),
                        ("optimizer_state_dtype", "optimizer_state_dtype")):
        if getattr(args, flag):
            preset = _replace(preset, "train", **{field: getattr(args, flag)})
    tr = preset.train
    if args.from_audio:
        from convsep_tpu_torch.data.audio_dataset import AudioSegmentDataset, segment_samples

        seg = segment_samples(preset)
        ds = AudioSegmentDataset(args.features, preset.sources, seg, overlap_samples=seg // 3,
                                 fs=preset.transform.fs,
                                 stereo=preset.model.decoder_reduce == "all")
    else:
        if args.score_informed:
            extra = tuple(f"score_{s}" for s in preset.sources)
        elif preset.transform.multires:
            extra = tuple(f"res{size}" for size in preset.transform.multires)
        else:
            extra = ()
        ds = SegmentDataset(args.features, preset.sources, time_context=tr.time_context,
                            overlap=tr.overlap, mult_factor_in=tr.mult_factor_in,
                            mult_factor_out=tr.mult_factor_out, extra_channels=extra)
    trainer = Trainer(preset, workdir=args.workdir, mesh=_mesh(args.mesh_data, args.device),
                      from_audio=args.from_audio, device=args.device)
    if args.resume:
        print(f"resumed from step {trainer.restore()}")
    val_ds = None
    if args.val_features:
        val_ds = SegmentDataset(args.val_features, preset.sources, time_context=tr.time_context,
                                overlap=tr.overlap, mult_factor_in=tr.mult_factor_in,
                                mult_factor_out=tr.mult_factor_out)
    losses = trainer.fit(ds, tensorboard=args.tensorboard, use_grain=args.grain,
                         val_dataset=val_ds)
    print(f"done; epoch losses: {[round(l, 6) for l in losses]}")
    return 0


def _load_params(path: str, preset, allow_unsafe: bool = False):
    """The flat parameter dict (CPU tensors) from a checkpoint directory of
    this package (its newest step) or a reference pickle."""
    if path.endswith((".pkl", ".pickle", ".param")):
        from convsep_tpu_torch.ckpt.convert_reference import convert_reference_checkpoint

        return convert_reference_checkpoint(path, preset.model, allow_unsafe=allow_unsafe)
    import torch

    from convsep_tpu_torch.ckpt.checkpoint import CheckpointManager
    from convsep_tpu_torch.models.convsep import param_shapes

    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    mgr = CheckpointManager(path)
    step = mgr.latest_step()
    if step is None:
        raise ValueError(
            f"{path} holds no convsep-torch checkpoint (a JAX orbax checkpoint is not read "
            "here): export it with `convsep convert --export`, then import the pickle with "
            "`convsep-torch convert`"
        )
    like = {"params": {k: torch.empty(s) for k, s in param_shapes(preset.model).items()}}
    return mgr.restore(step, like)[0]["params"]


def _score_extra(preset, audio: np.ndarray, score_dir: str, score_filter: str, device):
    """Score channels × mult_factor_in from ``<score_dir>/<source>.notes.txt``."""
    from convsep_tpu_torch.data.features import score_channels
    from convsep_tpu_torch.dsp.transform import TransformFFT
    from convsep_tpu_torch.score import parse_note_annotations

    mag = TransformFFT(preset.transform, device=device).compute_file(
        np.asarray(audio, np.float32))
    notes = [parse_note_annotations(os.path.join(score_dir, f"{s}.notes.txt"))
             for s in preset.sources]
    return score_channels(mag, notes, preset, score_filter) * preset.train.mult_factor_in


def _cmd_separate(args) -> int:
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.io import read_wav, write_wav
    from convsep_tpu_torch.separate import ChunkedSeparator, Separator, StereoSeparator

    preset = get_preset(args.preset)
    if args.decoder_impl:
        preset = _replace(preset, "model", decoder_impl=args.decoder_impl)
    if args.wiener_p is not None:
        preset = _replace(preset, "sep", wiener_p=args.wiener_p)
    if args.mask_dtype:
        preset = _replace(preset, "model", mask_dtype=args.mask_dtype)
    if args.analysis:
        preset = _replace(preset, "transform", analysis=args.analysis)
    # the gate and its mode fall back to the preset's (every preset: g 0, "mult")
    preset = _replace(preset, "sep", score_gate=args.score_gate or preset.sep.score_gate,
                      score_gate_mode=args.score_gate_mode or preset.sep.score_gate_mode)
    params = _load_params(args.params, preset, allow_unsafe=args.unsafe_pickle)
    if args.online:
        return _separate_online(args, preset, params)
    fs, audio = read_wav(args.input)
    if fs != preset.transform.fs:
        raise ValueError(f"{args.input}: fs {fs} != preset fs {preset.transform.fs}")
    kw = dict(output_dtype="int16", input_dtype="int16", complement_last=args.complement_last,
              device=args.device)
    os.makedirs(args.out, exist_ok=True)
    if preset.model.decoder_reduce == "all":  # the joint-channel presets (*-stereo)
        if audio.ndim != 2:
            raise ValueError(f"preset {preset.name!r} needs a stereo input wav")
        if args.score:
            raise ValueError("score conditioning is not supported by stereo presets")
        ssep = (ChunkedSeparator(preset, params, chunk_segments=args.chunk_segments, **kw)
                if args.chunked else StereoSeparator(preset, params, **kw))
        for name, stem in zip(preset.sources, ssep(audio)):  # (S, L, 2)
            write_wav(os.path.join(args.out, f"{name}.wav"), fs, stem)
        print(f"wrote {len(preset.sources)} stereo stems -> {args.out}")
        return 0
    stereo = audio.ndim == 2 and args.stereo
    if audio.ndim == 2 and not stereo:
        audio = audio.mean(axis=1)
    extra = None
    if args.score:
        extra = _score_extra(preset, audio, args.score, args.score_filter, args.device)
    sep = (ChunkedSeparator(preset, params, chunk_segments=args.chunk_segments, **kw)
           if args.chunked else Separator(preset, params, **kw))
    if stereo:  # each channel through the same separator → stereo stems
        left = np.array(sep(audio[:, 0], extra=extra))
        right = sep(audio[:, 1], extra=extra)
        for i, name in enumerate(preset.sources):
            write_wav(os.path.join(args.out, f"{name}.wav"), fs,
                      np.stack([left[i], right[i]], axis=1))
    else:
        for name, stem in zip(preset.sources, sep(audio, extra=extra)):
            write_wav(os.path.join(args.out, f"{name}.wav"), fs, stem)
    print(f"wrote {len(preset.sources)} stems -> {args.out}")
    return 0


def _separate_online(args, preset, params) -> int:
    """``separate --online``: the input wav (or raw mono PCM16 on stdin with
    ``-i -``) pushed in ``--block-samples`` blocks through OnlineSeparator;
    the stems written, then one JSON line of the steady RTF and the
    latencies."""
    import time

    from convsep_tpu_torch.data.io import read_wav, write_wav
    from convsep_tpu_torch.separate.online import OnlineSeparator

    fs = preset.transform.fs
    stereo = preset.model.decoder_reduce == "all"
    stdin_mode = args.input == "-"
    audio = None
    if not stdin_mode:
        wav_fs, audio = read_wav(args.input)
        if wav_fs != fs:
            raise ValueError(f"{args.input}: fs {wav_fs} != preset fs {fs}")
        if stereo:
            if audio.ndim != 2:
                raise ValueError(f"preset {preset.name!r} needs a stereo input wav")
            audio = audio.T[:2]
        elif audio.ndim == 2:
            audio = audio.mean(axis=1)
    elif stereo:
        raise ValueError("stdin streaming is mono PCM16 only")
    extra = None
    if args.score:
        if stdin_mode or stereo:
            raise ValueError("--score needs a mono wav input")
        extra = _score_extra(preset, audio, args.score, args.score_filter, args.device)
    osep = OnlineSeparator(preset, params, chunk_segments=args.chunk_segments,
                           output_dtype="int16", input_dtype="int16",
                           complement_last=args.complement_last, max_pending=args.max_pending,
                           device=args.device)
    block = int(args.block_samples)

    def blocks():
        if stdin_mode:
            while raw := sys.stdin.buffer.read(block * 2):  # int16 mono
                yield np.frombuffer(raw, np.int16)
        else:
            for p in range(0, audio.shape[-1], block):
                yield audio[..., p:p + block]

    outs, proc_ms, pushed, first = [], [], 0, True
    t0 = time.perf_counter()
    for blk in blocks():
        t1 = time.perf_counter()
        got = osep.push(blk, extra=extra if first else None)
        dt = time.perf_counter() - t1
        first = False
        pushed += blk.shape[-1]
        if got.shape[-1]:
            proc_ms.append(dt * 1e3)  # a push that finished at least one chunk
            outs.append(np.array(got))
    outs.append(osep.flush())
    wall = time.perf_counter() - t0
    osep.close()
    stems = np.concatenate(outs, axis=-1)
    os.makedirs(args.out, exist_ok=True)
    for name, stem in zip(preset.sources, stems):
        write_wav(os.path.join(args.out, f"{name}.wav"), fs, stem.T if stereo else stem)
    print(json.dumps({
        "mode": "online",
        "chunk_segments": args.chunk_segments,
        "pushed_samples": pushed,
        "rtf_steady": round(pushed / fs / wall, 2),
        "latency_algo_s": round(osep.latency_samples / fs, 4),
        "latency_proc_ms_median": round(float(np.median(proc_ms)), 1) if proc_ms else None,
        "stems": len(preset.sources),
        "out": args.out,
    }))
    return 0


def _cmd_separate_batch(args) -> int:
    """Every wav in a directory through batched separation (StreamSeparator)."""
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.io import read_wav, write_wav
    from convsep_tpu_torch.separate import StreamSeparator

    preset = get_preset(args.preset)
    if args.decoder_impl:
        preset = _replace(preset, "model", decoder_impl=args.decoder_impl)
    params = _load_params(args.params, preset, allow_unsafe=args.unsafe_pickle)
    names = sorted(f for f in os.listdir(args.input_dir) if f.endswith(".wav"))
    if not names:
        raise FileNotFoundError(f"no wavs under {args.input_dir}")
    stereo = preset.model.decoder_reduce == "all"
    ss = StreamSeparator(preset, params, mesh=_mesh(args.mesh_data, args.device),
                         output_dtype="int16",
                         input_dtype="int16", complement_last=args.complement_last,
                         device=args.device)

    def read(n):
        fs, audio = read_wav(os.path.join(args.input_dir, n))
        if fs != preset.transform.fs:
            raise ValueError(f"{n}: fs {fs} != preset fs {preset.transform.fs}")
        return audio

    def tracks():
        for n in names:
            audio = read(n)
            if stereo:  # joint-channel preset: both ears, (2, L)
                if audio.ndim != 2:
                    raise ValueError(f"{n}: stereo preset needs a stereo wav")
                yield audio.T[:2]
            else:
                yield audio.mean(axis=1) if audio.ndim == 2 else audio

    extras = None
    if args.score_dir:  # <score-dir>/<track>/<source>.notes.txt per input wav
        def extras_gen():
            for n in names:
                audio = read(n)
                yield _score_extra(preset, audio.mean(axis=1) if audio.ndim == 2 else audio,
                                   os.path.join(args.score_dir, n[: -len(".wav")]),
                                   args.score_filter, args.device)

        extras = extras_gen()
    done = 0
    it = iter(names)
    for batch in ss.stream(tracks(), batch_size=args.batch_size, extras=extras):
        for stems in batch:
            outdir = os.path.join(args.out, next(it)[: -len(".wav")])
            os.makedirs(outdir, exist_ok=True)
            for sname, stem in zip(preset.sources, stems):
                write_wav(os.path.join(outdir, f"{sname}.wav"), preset.transform.fs,
                          stem.T if stereo else stem)  # stereo stems (2, L) → (L, 2)
            done += 1
    print(f"separated {done} tracks -> {args.out}")
    return 0


def _cmd_serve(args) -> int:
    """Watch-folder separation (separate/service.py)."""
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.separate.service import WatchService

    preset = get_preset(args.preset)
    params = _load_params(args.params, preset, allow_unsafe=args.unsafe_pickle)
    svc = WatchService(preset, params, args.input_dir, args.out, batch_size=args.batch_size,
                       poll_s=args.poll, mesh=_mesh(args.mesh_data, args.device),
                       score_dir=args.score_dir,
                       score_filter=args.score_filter, device=args.device)
    print(f"serving {args.input_dir} -> {args.out} (ctrl-c to stop)")
    total = svc.run(max_sweeps=args.max_sweeps,
                    on_sweep=lambda n: n and print(f"separated {n} tracks"))
    print(f"served {total} tracks")
    return 0


def _cmd_evaluate(args) -> int:
    from convsep_tpu_torch.data.io import read_wav
    from convsep_tpu_torch.eval import (
        bss_eval_sources,
        bss_eval_stereo,
        bss_eval_windowed,
        oracle_stems,
    )
    from convsep_tpu_torch.eval.bss_eval import SOLVES

    names = sorted(f[:-4] for f in os.listdir(args.ref_dir) if f.endswith(".wav"))
    refs, ests = [], []
    fs = None
    stereo = args.stereo
    for n in names:
        fs, r = read_wav(os.path.join(args.ref_dir, n + ".wav"))
        _, e = read_wav(os.path.join(args.est_dir, n + ".wav"))
        L = min(len(r), len(e))
        if stereo:
            if r.ndim != 2 or e.ndim != 2:
                raise ValueError(f"{n}: --stereo needs stereo ref AND est wavs")
            refs.append(r[:L].T)
            ests.append(e[:L].T)
        else:
            refs.append(r[:L] if r.ndim == 1 else r[:L].mean(1))
            ests.append(e[:L] if e.ndim == 1 else e[:L].mean(1))
    L = min(r.shape[-1] for r in refs)
    refs = np.stack([r[..., :L] for r in refs])  # (S, L) or (S, 2, L)
    ests = np.stack([e[..., :L] for e in ests])

    def metric(r, e):
        if stereo:
            return (*bss_eval_stereo(r, e, flen=args.flen, device=args.device), None)
        if args.windowed:
            w = bss_eval_windowed(r, e, fs, flen=args.flen, device=args.device)
            return w["SDR"], w["SIR"], w["SAR"], w["windows"]
        return (*bss_eval_sources(r, e, flen=args.flen, device=args.device)[:3], None)

    SOLVES.clear()
    sdr, sir, sar, nwin = metric(refs, ests)
    out = {n: {"SDR": round(float(a), 3), "SIR": round(float(b), 3), "SAR": round(float(c), 3)}
           for n, a, b, c in zip(names, sdr, sir, sar)}
    if nwin is not None:
        out["_windows"] = nwin
    if args.oracle:  # the ideal soft mask from the true stems and the mixture
        from convsep_tpu_torch.configs import get_preset

        if not args.mix or not args.preset:
            raise ValueError("--oracle needs --mix <mixture.wav> and --preset")
        _, mix = read_wav(args.mix)
        mix = mix[..., :L] if mix.ndim == 1 else mix[:L].mean(1)
        r_mono = refs.mean(axis=1) if stereo else refs
        orc = oracle_stems(mix[:L], r_mono, get_preset(args.preset), device=args.device)
        osdr, _, _, _ = metric(refs if stereo else r_mono,
                               np.repeat(orc[:, None], 2, axis=1) if stereo else orc)
        for n, a, b in zip(names, osdr, sdr):
            out[n]["oracle_SDR"] = round(float(a), 3)
            out[n]["headroom_dB"] = round(float(a) - float(b), 3)
    print(json.dumps(out, indent=2))
    print("bss_eval solves: " + json.dumps(dict(SOLVES)), file=sys.stderr, flush=True)
    return 0


def _cmd_convert(args) -> int:
    """Reference pickle → checkpoint directory (step 0, a fresh optimizer
    state beside the parameters), or back with ``--export``."""
    import pickle

    from convsep_tpu_torch.ckpt.checkpoint import CheckpointManager
    from convsep_tpu_torch.ckpt.convert_reference import (
        convert_reference_checkpoint,
        export_reference_params,
    )
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.train.loop import create_train_state

    preset = get_preset(args.preset)
    if args.export:
        vals = export_reference_params(
            _load_params(args.input, preset, allow_unsafe=args.unsafe_pickle), preset.model)
        with open(args.out, "wb") as f:
            pickle.dump(vals, f, protocol=2)
        print(f"exported {len(vals)} reference arrays -> {args.out}")
        return 0
    params = convert_reference_checkpoint(args.input, preset.model,
                                          allow_unsafe=args.unsafe_pickle)
    state, _ = create_train_state(preset, 0, args.device, params=params)
    CheckpointManager(args.out, async_save=False).save(0, state)
    print(f"converted {args.input} -> checkpoint at {args.out} (step 0)")
    return 0


def _cmd_profile(args) -> int:
    """A profiler trace of one whole-track separation (after a warm-up run
    outside it: the kernel build, the libraries' start-up) and its hottest
    device items (CPU operations with ``--device cpu``)."""
    import torch

    from convsep_tpu_torch.ckpt.bridge import init_params
    from convsep_tpu_torch.configs import get_preset
    from convsep_tpu_torch.data.synth import sine_mixture
    from convsep_tpu_torch.models.convsep import ConvSep
    from convsep_tpu_torch.separate.pipeline import bucket_length, separate_fused
    from convsep_tpu_torch.utils.profiling import summarize_trace, trace

    device = args.device
    preset = get_preset(args.preset)
    if args.decoder_impl:
        preset = _replace(preset, "model", decoder_impl=args.decoder_impl)
    cfg = preset.model
    if cfg.channels_in > 1:
        raise ValueError("profile supports single-channel-input presets")
    if args.input:
        from convsep_tpu_torch.data.io import read_wav

        _, audio = read_wav(args.input)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
    else:
        fs = preset.transform.fs
        _, audio = sine_mixture(cfg.num_sources, int(args.seconds * fs), fs=fs, seed=0)
    state = (_load_params(args.params, preset) if args.params
             else init_params(cfg, torch.Generator(device=device).manual_seed(0), device))
    model = ConvSep(cfg, state, device=device).prepare_inference()
    Lb = bucket_length(len(audio), preset)
    dev = torch.from_numpy(np.pad(np.asarray(audio, np.float32), (0, Lb - len(audio))))
    dev = dev.to(device)

    def run():
        separate_fused(model, dev, preset, Lb, "int16")
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    with trace(args.logdir):
        run()
    print(json.dumps(summarize_trace(args.logdir, top=args.top, device=device), indent=2))
    print(f"trace -> {args.logdir} (open with Perfetto)")
    return 0


def _cmd_bench(args) -> int:
    from convsep_tpu_torch.benchmark import run_benchmark

    print(json.dumps(run_benchmark(args.preset, seconds=args.seconds, runs=args.runs,
                                   matrix=args.matrix, device=args.device)))
    return 0


def _common(sp, params: bool = False) -> None:
    sp.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) | cuda:N | cpu")
    if params:
        sp.add_argument("--unsafe-pickle", action="store_true",
                        help="allow arbitrary (unrestricted) pickle loading; only for trusted "
                             "checkpoint files")


def main(argv=None) -> int:
    global _OWN_GROUP
    p = argparse.ArgumentParser(prog="convsep-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--launches", action="store_true",
                   help="print the kernels' launch counts on stderr when the verb ends")
    sub = p.add_subparsers(dest="cmd", required=True)
    score_filter = dict(default="comb", choices=["comb", "nmf"],
                        help="score channel filter: harmonic-comb gating or score-constrained "
                             "NMF refinement")

    cf = sub.add_parser("compute-features", help="dataset audio -> feature files")
    cf.add_argument("--preset", required=True)
    cf.add_argument("--audio-dir", required=True)
    cf.add_argument("--out", required=True)
    cf.add_argument("--score-informed", action="store_true")
    cf.add_argument("--layout", default="trackdirs", choices=["trackdirs", "ikala-stereo"],
                    help="trackdirs: <track>/<stem>.wav; ikala-stereo: flat stereo wavs "
                         "(ch0 accompaniment, ch1 voice)")
    cf.add_argument("--augment", type=int, default=0,
                    help="emit N augmented copies per track (time shifts and stretches)")
    cf.add_argument("--score-filter", **score_filter)
    _common(cf)
    cf.set_defaults(fn=_cmd_compute_features)

    tr = sub.add_parser("train", help="train a separation model")
    tr.add_argument("--preset", required=True)
    tr.add_argument("--features", required=True)
    tr.add_argument("--workdir", required=True)
    tr.add_argument("--epochs", type=int, default=None)
    tr.add_argument("--resume", action="store_true")
    tr.add_argument("--score-informed", action="store_true")
    tr.add_argument("--mesh-data", type=int, default=1, help=MESH_HELP)
    tr.add_argument("--optimizer-impl", default=None, choices=["xla", "fused"],
                    help="adadelta update: the plain formula or the fused CUDA kernel")
    tr.add_argument("--optimizer-state-dtype", default=None, choices=["float32", "bfloat16"],
                    help="adadelta accumulator dtype (bfloat16: stored in bf16, float32 math; "
                         "the plain update only)")
    tr.add_argument("--grain", action="store_true",
                    help="batches in grain's order, grain's iterator state in the checkpoints")
    tr.add_argument("--from-audio", action="store_true",
                    help="train from <track>/<stem>.wav dirs (STFT inside the step; "
                         "--features is the audio dir)")
    tr.add_argument("--tensorboard", action="store_true",
                    help="also write the logged scalars to <workdir>/tb")
    tr.add_argument("--checkpoint-every-epochs", type=int, default=None,
                    help="save cadence in epochs (default: the preset's)")
    tr.add_argument("--val-features", default=None,
                    help="feature dir for a per-epoch validation loss")
    _common(tr)
    tr.set_defaults(fn=_cmd_train)

    se = sub.add_parser("separate", help="separate a mixture wav into stems")
    se.add_argument("--preset", required=True)
    se.add_argument("--params", required=True, help="checkpoint dir or reference .pkl")
    se.add_argument("-i", "--input", required=True)
    se.add_argument("-o", "--out", required=True)
    se.add_argument("--score", default=None,
                    help="dir with <source>.notes.txt for score-informed runs")
    se.add_argument("--score-filter", **score_filter)
    se.add_argument("--score-gate", type=float, default=0.0,
                    help="score-gated resynthesis strength g in [0, 1] (default: the preset's)")
    se.add_argument("--score-gate-mode", default=None, choices=["mult", "blend"],
                    help="how --score-gate combines model and score (default: the preset's)")
    se.add_argument("--stereo", action="store_true",
                    help="separate channels independently -> stereo stems (default: downmix)")
    se.add_argument("--wiener-p", type=float, default=None,
                    help="generalized Wiener exponent (default: the preset's)")
    se.add_argument("--mask-dtype", default=None, choices=("float32", "bfloat16"),
                    help="decoder -> Wiener mask tail dtype (the ratio divides in float32)")
    se.add_argument("--analysis", default=None, choices=("auto", "ct_pallas", "matmul"),
                    help="forward STFT route (ct_pallas: the forward STFT kernel)")
    se.add_argument("--chunked", action="store_true",
                    help="stream the track in fixed-size chunks (ChunkedSeparator)")
    se.add_argument("--online", action="store_true",
                    help="push/flush live streaming: read the input in --block-samples blocks, "
                         "print steady RTF and latency (-i - reads raw mono PCM16 on stdin)")
    se.add_argument("--block-samples", type=int, default=16384,
                    help="push block size for --online")
    se.add_argument("--chunk-segments", type=int, default=32,
                    help="time-context windows per chunk for --chunked/--online")
    se.add_argument("--complement-last", action="store_true",
                    help="conservative masks; the LAST stem derived on the host as "
                         "mixture - sum(others)")
    se.add_argument("--max-pending", type=int, default=0,
                    help="--online: chunks allowed in flight across pushes")
    se.add_argument("--decoder-impl", default=None, choices=DECODER_IMPLS,
                    help="tied-decoder route override (default: the preset's)")
    _common(se, params=True)
    se.set_defaults(fn=_cmd_separate)

    sb = sub.add_parser("separate-batch", help="a directory of wavs through batched separation")
    sb.add_argument("--preset", required=True)
    sb.add_argument("--params", required=True)
    sb.add_argument("--input-dir", required=True)
    sb.add_argument("-o", "--out", required=True)
    sb.add_argument("--batch-size", type=int, default=4)
    sb.add_argument("--mesh-data", type=int, default=1, help=MESH_HELP)
    sb.add_argument("--decoder-impl", default=None, choices=DECODER_IMPLS)
    sb.add_argument("--score-dir", default=None,
                    help="score-informed runs: <track>/<source>.notes.txt per input wav")
    sb.add_argument("--score-filter", **score_filter)
    sb.add_argument("--complement-last", action="store_true",
                    help="conservative masks + the LAST stem derived on the host")
    _common(sb, params=True)
    sb.set_defaults(fn=_cmd_separate_batch)

    sv = sub.add_parser("serve", help="watch a directory; separate wavs as they arrive")
    sv.add_argument("--preset", required=True)
    sv.add_argument("--params", required=True)
    sv.add_argument("--input-dir", required=True)
    sv.add_argument("-o", "--out", required=True)
    sv.add_argument("--batch-size", type=int, default=4)
    sv.add_argument("--poll", type=float, default=1.0, help="sweep interval seconds")
    sv.add_argument("--mesh-data", type=int, default=1, help=MESH_HELP)
    sv.add_argument("--max-sweeps", type=int, default=None,
                    help="stop after N sweeps (default: run forever)")
    sv.add_argument("--score-dir", default=None,
                    help="score-informed runs: <track>/<source>.notes.txt per incoming wav")
    sv.add_argument("--score-filter", **score_filter)
    _common(sv, params=True)
    sv.set_defaults(fn=_cmd_serve)

    ev = sub.add_parser("evaluate", help="BSS Eval SDR/SIR/SAR of estimated stems")
    ev.add_argument("--ref-dir", required=True)
    ev.add_argument("--est-dir", required=True)
    ev.add_argument("--flen", type=int, default=512)
    ev.add_argument("--windowed", action="store_true",
                    help="30 s windows at 15 s hop, median over windows")
    ev.add_argument("--stereo", action="store_true",
                    help="evaluate (S, 2, L) stereo stems (channel-combined BSS Eval)")
    ev.add_argument("--oracle", action="store_true",
                    help="also the ideal-soft-mask oracle SDR and headroom (needs --mix, "
                         "--preset)")
    ev.add_argument("--mix", default=None, help="mixture wav for --oracle")
    ev.add_argument("--preset", default=None, help="preset for --oracle's transform")
    _common(ev)
    ev.set_defaults(fn=_cmd_evaluate)

    cv = sub.add_parser("convert", help="reference pickle <-> checkpoint directory")
    cv.add_argument("--preset", required=True)
    cv.add_argument("--input", required=True, help=".pkl (import) or checkpoint dir (--export)")
    cv.add_argument("--out", required=True)
    cv.add_argument("--export", action="store_true", help="checkpoint dir -> reference pickle")
    _common(cv, params=True)
    cv.set_defaults(fn=_cmd_convert)

    pr = sub.add_parser("profile", help="profile one separation; print the hottest items")
    pr.add_argument("--preset", default="dsd100")
    pr.add_argument("--params", default=None,
                    help="checkpoint dir or reference .pkl (default: seeded random weights)")
    pr.add_argument("-i", "--input", default=None, help="wav (default: a synthetic mixture)")
    pr.add_argument("--seconds", type=float, default=30.0)
    pr.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(), "convsep_trace"))
    pr.add_argument("--top", type=int, default=20)
    pr.add_argument("--decoder-impl", default=None, choices=DECODER_IMPLS)
    _common(pr)
    pr.set_defaults(fn=_cmd_profile)

    be = sub.add_parser("bench", help="RTF benchmark (one JSON line)")
    be.add_argument("--preset", default="dsd100")
    be.add_argument("--seconds", type=float, default=30.0)
    be.add_argument("--runs", type=int, default=5)
    be.add_argument("--matrix", action=argparse.BooleanOptionalAction, default=False,
                    help="also the online, train, preset-matrix and memory-watermark sections")
    _common(be)
    be.set_defaults(fn=_cmd_bench)

    args = p.parse_args(argv)
    from convsep_tpu_torch.utils.device import resolve_device

    args.device = resolve_device(args.device)  # before any work: no GPU, no run
    try:
        return args.fn(args)
    finally:
        if _OWN_GROUP:
            import torch.distributed as dist

            dist.destroy_process_group()
            _OWN_GROUP = False
        if args.launches:
            from convsep_tpu_torch import kernels

            print("kernel launches: " + json.dumps(kernels.LAUNCHES), file=sys.stderr,
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
