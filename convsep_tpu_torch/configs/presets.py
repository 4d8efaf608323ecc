"""Config dataclasses + per-dataset presets, framework-free.

Mirror of ``convsep_tpu.configs.presets``: the same dataclasses, fields,
defaults and all 8 presets (tests/test_torch_config.py holds them equal
field for field). The reference module imports its flax model for
``ConvSepConfig``, so this package keeps its own copy.

Routing fields and what they mean here:

* ``fft_impl``: "matmul" everywhere; "pallas" routes the in-step STFT of
  training and mono separation's STFT, Wiener mask and iSTFT to the
  hand-written kernels (``dsp/cuda/``); stereo separation takes the matmul
  chain for either, as the reference does. "fft" is not ported.
* ``analysis``: "auto" / "matmul" run the torch DFT chain; "ct_pallas" runs
  the fused forward-STFT kernel (``dsp/cuda/ct_stft_kernel.py``; nfft >=
  2048, hop a multiple of 1024), whose Nyquist-separate spectra the
  Wiener+iSTFT kernel reads as they are. Mono separation reads it.
* ``masked_synthesis``: "auto" runs the hand-written Wiener+iSTFT kernel
  on CUDA tensors inside its envelope and the mask + iSTFT chain
  elsewhere, whose iSTFT is the hand-written iSTFT kernel where the
  reference's rule routes it (factored, ``ct_pallas_supported``);
  "ct_pallas_wiener" / "ct_pallas" ask for those kernels' wrappers (plain
  on CPU tensors); "direct" / "factored" force the plain chain with that
  iDFT algorithm. Stereo separation masks before its iSTFT and takes the
  named iSTFT algorithm ("ct_pallas_wiener" reads as "auto" there).
* ``dft_precision``: "highest" and "high" are both exact float32 here
  (TF32 stays off); "default", the reference's bf16x1 ablation, is not
  ported.
"""

from __future__ import annotations

import dataclasses

from convsep_tpu_torch.models.config import ConvSepConfig


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """STFT analysis settings."""

    fs: int = 44100
    frame_size: int = 1024
    hop_size: int = 512
    nfft: int | None = None  # None -> frame_size
    window: str = "sinebell"
    iscale: str = "lin"
    fft_impl: str = "matmul"
    dft_precision: str = "high"
    masked_synthesis: str = "auto"
    analysis: str = "auto"
    multires: tuple[int, ...] = ()

    @property
    def bins(self) -> int:
        return (self.nfft or self.frame_size) // 2 + 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop settings. ``optimizer_impl``: "xla" runs the plain
    adadelta formula, "fused" the hand-written one-pass kernel
    (``train/fused_optim.py``); float32 optimizer state only."""

    batch_size: int = 32
    num_epochs: int = 50
    optimizer: str = "adadelta"
    optimizer_impl: str = "xla"
    optimizer_state_dtype: str = "float32"
    learning_rate: float = 1.0
    alpha: float = 0.001
    beta: float | None = None
    beta_voc: float | None = None
    vocals_idx: int = 0
    other_idx: int | None = None
    mult_factor_in: float = 0.3
    mult_factor_out: float = 0.3
    time_context: int = 30
    overlap: int = 20
    # the reference scans K steps in one program to save dispatches; eager
    # PyTorch has no dispatch to save, so the Trainer always runs single
    # steps and ignores this (the same math)
    steps_per_dispatch: int = 1
    log_every_steps: int = 50
    checkpoint_every_steps: int = 500
    checkpoint_every_epochs: int = 1
    checkpoint_optimizer_state: bool = True
    seed: int = 0
    debug_nans: bool = False


@dataclasses.dataclass(frozen=True)
class SepConfig:
    """Whole-track separation settings."""

    wiener_p: float = 1.0
    wiener_eps: float = 1e-8
    segment_bucket: int = 16
    score_gate: float = 0.0
    score_gate_mode: str = "mult"


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    sources: tuple[str, ...]
    transform: TransformConfig
    model: ConvSepConfig
    train: TrainConfig
    sep: SepConfig


def _ikala() -> Preset:
    t = TransformConfig(fft_impl="matmul")
    return Preset(
        name="ikala",
        sources=("vocals", "accompaniment"),
        transform=t,
        model=ConvSepConfig(
            time_context=30, feat_size=t.bins, channels_in=1, num_sources=2
        ),
        train=TrainConfig(alpha=0.001, beta_voc=0.03, vocals_idx=0),
        sep=SepConfig(),
    )


def _dsd100() -> Preset:
    t = TransformConfig(fft_impl="matmul")
    return Preset(
        name="dsd100",
        sources=("vocals", "bass", "drums", "other"),
        transform=t,
        model=ConvSepConfig(
            time_context=30,
            feat_size=t.bins,
            channels_in=1,
            num_sources=4,
            conv1_freq_stride=3,
            mask_dtype="bfloat16",
        ),
        train=TrainConfig(alpha=0.001, beta=0.01, beta_voc=0.03, vocals_idx=0, other_idx=3),
        sep=SepConfig(),
    )


def _bach10() -> Preset:
    t = TransformConfig(frame_size=4096, hop_size=1024, fft_impl="matmul")
    n_instruments = 4  # violin, clarinet, saxophone, bassoon
    return Preset(
        name="bach10",
        sources=("violin", "clarinet", "saxophone", "bassoon"),
        transform=t,
        model=ConvSepConfig(
            time_context=30,
            feat_size=t.bins,
            channels_in=1 + n_instruments,  # mixture + score-filtered channels
            num_sources=n_instruments,
            conv1_freq_stride=3,
        ),
        train=TrainConfig(alpha=0.001),
        sep=SepConfig(),
    )


def _highres4096() -> Preset:
    t = TransformConfig(frame_size=4096, hop_size=1024, fft_impl="matmul")
    return Preset(
        name="highres4096",
        sources=("vocals", "bass", "drums", "other"),
        transform=t,
        model=ConvSepConfig(
            time_context=30,
            feat_size=t.bins,
            channels_in=1,
            num_sources=4,
            conv1_freq_stride=4,
            decoder_impl="auto",
            mask_dtype="bfloat16",
        ),
        train=TrainConfig(alpha=0.001, beta=0.01, beta_voc=0.03, vocals_idx=0, other_idx=3),
        sep=SepConfig(),
    )


def _multires4096() -> Preset:
    t = TransformConfig(
        frame_size=4096, hop_size=1024, fft_impl="matmul", multires=(1024, 2048)
    )
    return Preset(
        name="multires4096",
        sources=("vocals", "bass", "drums", "other"),
        transform=t,
        model=ConvSepConfig(
            time_context=30,
            feat_size=t.bins,
            channels_in=1 + len(t.multires),
            num_sources=4,
            conv1_freq_stride=4,
            decoder_impl="auto",
            mask_dtype="bfloat16",
        ),
        train=TrainConfig(alpha=0.001, beta=0.01, beta_voc=0.03, vocals_idx=0, other_idx=3),
        sep=SepConfig(),
    )


def stereo_preset(base: Preset) -> Preset:
    """Stereo-native joint-channel variant of a mono preset."""
    if base.model.channels_in != 1 or base.transform.multires:
        raise ValueError(f"preset {base.name!r} is not a plain mono preset")
    return dataclasses.replace(
        base,
        name=base.name + "-stereo",
        model=dataclasses.replace(base.model, channels_in=2, decoder_reduce="all"),
    )


PRESETS = {
    "ikala": _ikala,
    "dsd100": _dsd100,
    "bach10": _bach10,
    "highres4096": _highres4096,
    "multires4096": _multires4096,
    "ikala-stereo": lambda: stereo_preset(_ikala()),
    "dsd100-stereo": lambda: stereo_preset(_dsd100()),
    "highres4096-stereo": lambda: stereo_preset(_highres4096()),
}


def preset_from_dict(d: dict) -> Preset:
    """Inverse of ``dataclasses.asdict``: a :class:`Preset` from nested plain
    data (a JSON file, or ``asdict`` of the reference's preset)."""
    t = dict(d["transform"])
    t["multires"] = tuple(t.get("multires", ()))
    return Preset(
        name=d["name"],
        sources=tuple(d["sources"]),
        transform=TransformConfig(**t),
        model=ConvSepConfig(**d["model"]),
        train=TrainConfig(**d["train"]),
        sep=SepConfig(**d["sep"]),
    )


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}") from None
