"""Training engine: the train step, the epoch loop, checkpoints and resume.

Mirror of ``convsep_tpu.train.loop`` on one device. A train step is the
loss — on feature-file batches (:func:`make_train_step`, the masked
estimate of the mixture magnitude against the stems') or on raw audio
(:func:`convsep_tpu_torch.train.e2e.make_audio_loss_fn`, the STFT inside
the step) — its gradients by ``torch.autograd.grad``, and the adadelta
update: the plain formula (``optimizer_impl="xla"``) or the fused CUDA
kernel (``"fused"``). The reference's step is one jitted program over
donated buffers; here the state's tensors are updated in place and the
same :class:`TrainState` object is returned. Metrics stay on the device
and are read only at the logging cadence, one step late, so the host does
not wait on the device every step.

With a ``workdir`` the :class:`Trainer` checkpoints (ckpt/checkpoint.py)
every ``checkpoint_every_steps`` steps, every ``checkpoint_every_epochs``
epochs, after the last epoch and at ``max_steps``; each checkpoint carries
the data position, so a :meth:`Trainer.restore` continues mid-epoch on
exactly the batches the interrupted run never trained on.

Not ported yet (ROADMAP queue 1): grain loading, device meshes,
tensorboard.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from functools import partial
from typing import Any, Callable

import torch

from convsep_tpu_torch.ckpt.bridge import init_params
from convsep_tpu_torch.ckpt.checkpoint import CheckpointManager
from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.audio_dataset import segment_samples
from convsep_tpu_torch.data.pipeline import prefetch_to_device, to_device
from convsep_tpu_torch.models.convsep import train_sources, trainable_config
from convsep_tpu_torch.models.masks import wiener_filter
from convsep_tpu_torch.train import e2e
from convsep_tpu_torch.train.losses import interference_on_device, separation_loss
from convsep_tpu_torch.train.optim import GradientTransformation, global_norm, make_optimizer
from convsep_tpu_torch.utils.device import resolve_device
from convsep_tpu_torch.utils.precision import float32_exact

_ROADMAP = "not ported yet (ROADMAP.md, queue 1)"


@dataclasses.dataclass
class TrainState:
    """Step count, the flat parameter dict (leaf tensors that require
    gradients) and the optimizer state."""

    step: int
    params: dict[str, torch.Tensor]
    opt_state: Any


def create_train_state(
    preset: Preset,
    seed: int = 0,
    device: str | torch.device | None = None,
    params: dict[str, torch.Tensor] | None = None,
) -> tuple[TrainState, GradientTransformation]:
    """Seeded random parameters of the trainable model (:func:`init_params`,
    a generator on ``device``), or copies of ``params`` (e.g. bridged from
    the reference), and a zero optimizer state. ``device=None`` means
    "cuda", which raises without a GPU; the CPU only when asked for."""
    device = resolve_device(device)
    cfg = trainable_config(preset.model)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)
    params = {k: t.detach().to(device=device, dtype=torch.float32, copy=True).requires_grad_()
              for k, t in params.items()}
    kw = {}
    if preset.train.optimizer_state_dtype != "float32":
        if preset.train.optimizer != "adadelta":
            raise ValueError(
                "optimizer_state_dtype is only supported for optimizer="
                f"'adadelta', got {preset.train.optimizer!r}"
            )
        kw["state_dtype"] = preset.train.optimizer_state_dtype
    opt = make_optimizer(preset.train.optimizer, learning_rate=preset.train.learning_rate, **kw)
    return TrainState(step=0, params=params, opt_state=opt.init(params)), opt


def _feature_loss_fn(preset: Preset) -> Callable:
    """(params, x (B, T, F, C), y (B, S, T, F)) → loss, shared by the train
    and eval steps: the trainable model's source magnitudes, the Wiener
    mask of the mixture channel x[..., 0], the interference loss against
    the targets (source-major throughout, the model's output layout)."""
    cfg = trainable_config(preset.model)
    interf = interference_on_device(preset)

    def loss_fn(params, x, y):
        out = train_sources(params, x, cfg)
        est = wiener_filter(out, x[..., 0], p=1.0, eps=preset.sep.wiener_eps, axis=1)
        return separation_loss(est, y, interf(x.device), source_axis=1)

    return loss_fn


def _apply_from_opt(opt: GradientTransformation) -> Callable:
    """Default optimizer apply: (params, grads, opt_state) → (params,
    opt_state', grad_norm); the parameters are updated in place."""

    @torch.no_grad()
    def apply_fn(params, grads, opt_state):
        gnorm = global_norm(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        for k, u in updates.items():
            params[k].add_(u)
        return params, opt_state, gnorm

    return apply_fn


def step_from_loss(
    loss_fn: Callable, opt: GradientTransformation, apply_fn: Callable | None = None
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], tuple[TrainState, dict]]:
    """loss_fn → step: (state, x, y) → (state, {"loss": (), "grad_norm": ()}).
    ``apply_fn`` overrides the optimizer application (the fused kernel,
    train/fused_optim.py)."""
    if apply_fn is None:
        apply_fn = _apply_from_opt(opt)

    @float32_exact()  # the backward's convolutions and products too
    def train_step(state: TrainState, x, y):
        names = list(state.params)
        loss = loss_fn(state.params, x, y)
        grads = dict(zip(names, torch.autograd.grad(loss, [state.params[k] for k in names])))
        state.params, state.opt_state, gnorm = apply_fn(state.params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def multi_step_from_loss(
    loss_fn: Callable, opt: GradientTransformation, apply_fn: Callable | None = None
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], tuple[TrainState, dict]]:
    """K steps per call: (state, xs (K, B, …), ys (K, B, …)) → (state,
    {"loss": (K,), "grad_norm": (K,)}); K single steps, the same math."""
    step = step_from_loss(loss_fn, opt, apply_fn)

    def train_step_k(state: TrainState, xs, ys):
        losses, gnorms = [], []
        for x, y in zip(xs, ys):
            state, m = step(state, x, y)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        return state, {"loss": torch.stack(losses), "grad_norm": torch.stack(gnorms)}

    return train_step_k


def _preset_apply_fn(preset: Preset) -> Callable | None:
    """The fused single-pass adadelta apply when the preset selects it
    (TrainConfig.optimizer_impl="fused"); None → the plain optimizer."""
    if preset.train.optimizer_impl == "xla":
        return None
    if preset.train.optimizer_impl != "fused":
        raise ValueError(
            f"unknown optimizer_impl {preset.train.optimizer_impl!r};"
            " expected 'xla' or 'fused'"
        )
    if preset.train.optimizer != "adadelta":
        raise ValueError("optimizer_impl='fused' requires optimizer='adadelta'")
    if preset.train.optimizer_state_dtype != "float32":
        raise ValueError(
            "optimizer_impl='fused' requires optimizer_state_dtype='float32'"
            " (the kernel streams the accumulators in place)"
        )
    from convsep_tpu_torch.train.fused_optim import fused_adadelta_apply

    return partial(fused_adadelta_apply, learning_rate=preset.train.learning_rate)


def make_train_step(preset: Preset, opt: GradientTransformation) -> Callable:
    """The feature-file train step: (state, x (B, T, F, C), y (B, S, T, F))
    → (state, metrics); forward, backward and update, the state updated in
    place."""
    return step_from_loss(_feature_loss_fn(preset), opt, _preset_apply_fn(preset))


def make_train_step_multi(preset: Preset, opt: GradientTransformation) -> Callable:
    """K feature-file steps per call: (state, xs (K, B, …), ys (K, B, …))
    → (state, {"loss": (K,), "grad_norm": (K,)})."""
    return multi_step_from_loss(_feature_loss_fn(preset), opt, _preset_apply_fn(preset))


def make_eval_step(preset: Preset, from_audio: bool = False) -> Callable:
    """Loss-only step (no update, no gradients) sharing the train step's
    loss: on feature batches, or on raw audio with ``from_audio``."""
    loss_fn = e2e.make_audio_loss_fn(preset) if from_audio else _feature_loss_fn(preset)
    return float32_exact()(torch.no_grad()(loss_fn))


class MetricsLogger:
    """Structured per-step metrics → JSONL + stdout."""

    def __init__(self, path: str | None = None, print_every: int = 50,
                 tensorboard_dir: str | None = None):
        if tensorboard_dir:
            raise NotImplementedError(f"tensorboard logging is {_ROADMAP}")
        self.path = path
        self.print_every = print_every
        self._f = open(path, "a") if path else None

    def log(self, **kv):
        if self._f:
            self._f.write(json.dumps(kv) + "\n")
            self._f.flush()
        if kv.get("step", 0) % self.print_every == 0:
            print("  " + " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                                  for k, v in kv.items()))

    def close(self):
        if self._f:
            self._f.close()


class Trainer:
    """Epoch loop with a one-deep device prefetch, checkpoints and resume,
    on one device (``device=None``: the GPU, which raises without one; the
    CPU only when asked for). ``from_audio=False`` trains on a feature-file
    :class:`~convsep_tpu_torch.data.pipeline.SegmentDataset`, ``True`` on
    an :class:`~convsep_tpu_torch.data.audio_dataset.AudioSegmentDataset`
    (the STFT inside the step). With ``workdir``, checkpoints go to
    ``<workdir>/checkpoints`` and metrics to ``<workdir>/metrics.jsonl``."""

    def __init__(
        self,
        preset: Preset,
        workdir: str | None = None,
        mesh=None,
        seed: int | None = None,
        from_audio: bool = False,
        device: str | torch.device | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(f"training on a device mesh is {_ROADMAP}")
        self.preset = preset
        self.workdir = workdir
        self.from_audio = from_audio
        self.device = resolve_device(device)
        seed = preset.train.seed if seed is None else seed
        self.state, self.opt = create_train_state(preset, seed, self.device)
        make = e2e.make_audio_train_step if from_audio else make_train_step
        self.train_step = make(preset, self.opt)
        self._eval_step = None
        self._ckpt = None
        # the data position riding along with every checkpoint (mid-epoch
        # resume); "grain" is the reference's loader state, always None here
        self._data_pos: dict = {"epoch": 0, "batch_in_epoch": 0, "grain": None}
        self._resume: dict = {}
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self._ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"))

    def _save_view(self):
        """What a checkpoint holds: the whole state, or only the step and
        parameters (``checkpoint_optimizer_state=False``, a third of the
        bytes; a restore then starts the accumulators from zero)."""
        if self.preset.train.checkpoint_optimizer_state:
            return self.state
        return {"step": self.state.step, "params": self.state.params}

    def _save(self, step: int) -> None:
        self._ckpt.save(step, self._save_view(), extra=self._data_pos)

    def restore(self) -> int:
        """Resume from the latest checkpoint if there is one; returns the
        step. The data position comes back too (epoch, batch in epoch), so
        the next :meth:`fit` continues mid-epoch on exactly the batches the
        interrupted run never trained on."""
        if self._ckpt is not None:
            restored = self._ckpt.restore_latest(self._save_view())
            if restored is not None:
                st, meta = restored
                if self.preset.train.checkpoint_optimizer_state:
                    self.state = st
                else:  # the optimizer accumulators restart from zero
                    self.state = dataclasses.replace(self.state, step=st["step"],
                                                     params=st["params"])
                self._resume = dict(meta or {})
        return int(self.state.step)

    @property
    def data_position(self) -> dict:
        """(epoch, batch in epoch) where the next :meth:`fit` starts: the
        restored checkpoint's, else where the last fit stopped."""
        return dict(self._resume or self._data_pos)

    def evaluate(self, dataset, max_batches: int | None = None) -> float:
        """Mean loss over a (validation) dataset without updating params:
        a ``SegmentDataset``, or an ``AudioSegmentDataset`` with
        ``from_audio``."""
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.preset, from_audio=self.from_audio)
        losses = []
        for i, (x, y) in enumerate(dataset.batches(self.preset.train.batch_size, shuffle=False)):
            if max_batches is not None and i >= max_batches:
                break
            x, y = to_device((x, y), self.device)
            losses.append(self._eval_step(self.state.params, x, y))
        return float(torch.stack(losses).mean()) if losses else float("nan")

    def fit(
        self,
        dataset,
        num_epochs: int | None = None,
        metrics_path: str | None = None,
        tensorboard: bool = False,
        use_grain: bool = False,
        grain_workers: int = 0,
        val_dataset=None,
        max_steps: int | None = None,
    ) -> list[float]:
        """Run the epoch loop; returns per-epoch mean losses. ``num_epochs``
        is the total budget: after :meth:`restore` the loop starts at the
        checkpoint's epoch and batch. ``max_steps`` stops (with a
        checkpoint) after that many cumulative steps. Every step is a
        single step (``steps_per_dispatch`` is ignored: the same math)."""
        if use_grain or grain_workers:
            raise NotImplementedError(f"grain data loading is {_ROADMAP}")
        if tensorboard:
            raise NotImplementedError(f"tensorboard logging is {_ROADMAP}")
        tr = self.preset.train
        num_epochs = tr.num_epochs if num_epochs is None else num_epochs
        if metrics_path is None and self.workdir:
            metrics_path = os.path.join(self.workdir, "metrics.jsonl")
        logger = MetricsLogger(metrics_path, print_every=tr.log_every_steps)
        epoch_losses = []
        step = int(self.state.step)
        start_epoch = int(self._resume.get("epoch", 0))
        resume_batch = int(self._resume.get("batch_in_epoch", 0))
        self._resume = {}
        # training RTF: audio-seconds consumed per step
        t_cfg = self.preset.transform
        if self.from_audio:
            seg_sec = segment_samples(self.preset) / t_cfg.fs
        else:
            seg_sec = tr.time_context * t_cfg.hop_size / t_cfg.fs
        audio_sec_per_step = tr.batch_size * seg_sec

        try:
            for epoch in range(start_epoch, num_epochs):
                t0 = time.perf_counter()
                losses, gnorms = [], []
                skip = resume_batch if epoch == start_epoch else 0
                batches = dataset.batches(tr.batch_size, shuffle=True, seed=tr.seed + epoch,
                                          start=skip)
                consumed = skip
                stop = False
                t_win = time.perf_counter()
                steps_win = 0
                for x, y in prefetch_to_device(batches, self.device):
                    prev_step = step
                    self.state, m = self.train_step(self.state, x, y)
                    step += 1
                    consumed += 1
                    steps_win += 1
                    losses.append(m["loss"])
                    gnorms.append(m["grad_norm"])
                    self._data_pos = {"epoch": epoch, "batch_in_epoch": consumed, "grain": None}
                    if tr.debug_nans and not bool(torch.isfinite(losses[-1])):
                        raise FloatingPointError(f"non-finite loss at step {step}")
                    if self._ckpt is not None and (
                        step // tr.checkpoint_every_steps > prev_step // tr.checkpoint_every_steps
                    ):
                        self._save(step)
                    # read the previous step's metrics, at the print cadence
                    # only: the current one may still be running
                    if step % logger.print_every == 0 and len(losses) >= 2:
                        now = time.perf_counter()
                        step_s = (now - t_win) / steps_win
                        logger.log(
                            step=step - 1, epoch=epoch, loss=float(losses[-2]),
                            grad_norm=float(gnorms[-2]),
                            step_time_ms=round(step_s * 1e3, 3),
                            rtf_train=round(audio_sec_per_step / step_s, 1),
                        )
                        t_win = now
                        steps_win = 0
                    if max_steps is not None and step >= max_steps:
                        stop = True
                        break
                if stop:
                    if self._ckpt is not None:
                        self._save(step)
                    break
                mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
                epoch_losses.append(mean_loss)
                epoch_kv = dict(step=step, epoch=epoch, epoch_loss=mean_loss,
                                epoch_seconds=time.perf_counter() - t0)
                if val_dataset is not None:
                    epoch_kv["val_loss"] = self.evaluate(val_dataset)
                logger.log(**epoch_kv)
                self._data_pos = {"epoch": epoch + 1, "batch_in_epoch": 0, "grain": None}
                if self._ckpt is not None and (
                    epoch == num_epochs - 1 or (epoch + 1) % tr.checkpoint_every_epochs == 0
                ):
                    self._save(step)
        finally:
            if self._ckpt is not None:
                self._ckpt.wait()
            logger.close()
        return epoch_losses
