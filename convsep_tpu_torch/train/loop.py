"""Training engine: the train step and the epoch loop.

Mirror of ``convsep_tpu.train.loop`` for from-audio training on one device.
A train step is the loss (:func:`convsep_tpu_torch.train.e2e.make_audio_loss_fn`),
its gradients by ``torch.autograd.grad``, and the adadelta update: the
plain formula (``optimizer_impl="xla"``) or the fused CUDA kernel
(``"fused"``). The reference's step is one jitted program over donated
buffers; here the state's tensors are updated in place and the same
:class:`TrainState` object is returned. Metrics stay on the device and are
read only at the logging cadence, one step late, so the host does not wait
on the device every step.

Not ported yet (ROADMAP queue 1): the feature-file path (``SegmentDataset``,
``make_train_step``), checkpoints (``workdir``, ``restore``), grain
loading, device meshes, tensorboard.
"""

from __future__ import annotations

import dataclasses
import json
import time
from functools import partial
from typing import Any, Callable

import torch

from convsep_tpu_torch.ckpt.bridge import init_params
from convsep_tpu_torch.configs.presets import Preset
from convsep_tpu_torch.data.audio_dataset import segment_samples
from convsep_tpu_torch.data.pipeline import prefetch_to_device, to_device
from convsep_tpu_torch.models.convsep import trainable_config
from convsep_tpu_torch.train import e2e
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


def make_eval_step(preset: Preset, from_audio: bool = False) -> Callable:
    """Loss-only step (no update, no gradients) sharing the train step's
    loss."""
    if not from_audio:
        raise NotImplementedError(f"feature-file training (SegmentDataset) is {_ROADMAP}")
    return float32_exact()(torch.no_grad()(e2e.make_audio_loss_fn(preset)))


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
    """Epoch loop over an :class:`AudioSegmentDataset` with a one-deep
    device prefetch, on one device (``device=None``: the GPU, which raises
    without one; the CPU only when asked for)."""

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
        if workdir is not None:
            raise NotImplementedError(f"checkpointing to a workdir is {_ROADMAP}")
        if not from_audio:
            raise NotImplementedError(f"feature-file training (SegmentDataset) is {_ROADMAP}")
        self.preset = preset
        self.from_audio = from_audio
        self.device = resolve_device(device)
        seed = preset.train.seed if seed is None else seed
        self.state, self.opt = create_train_state(preset, seed, self.device)
        self.train_step = e2e.make_audio_train_step(preset, self.opt)
        self._eval_step = None

    def restore(self) -> int:
        raise NotImplementedError(f"checkpoint restore is {_ROADMAP}")

    def evaluate(self, dataset, max_batches: int | None = None) -> float:
        """Mean loss over a (validation) dataset without updating params."""
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
        """Run the epoch loop; returns per-epoch mean losses. ``max_steps``
        stops after that many cumulative steps (mid-epoch). Every step is a
        single step (``steps_per_dispatch`` is ignored: the same math)."""
        if use_grain or grain_workers:
            raise NotImplementedError(f"grain data loading is {_ROADMAP}")
        if tensorboard:
            raise NotImplementedError(f"tensorboard logging is {_ROADMAP}")
        tr = self.preset.train
        num_epochs = tr.num_epochs if num_epochs is None else num_epochs
        logger = MetricsLogger(metrics_path, print_every=tr.log_every_steps)
        epoch_losses = []
        step = int(self.state.step)
        # training RTF: audio-seconds consumed per step
        audio_sec_per_step = tr.batch_size * segment_samples(self.preset) / self.preset.transform.fs

        try:
            for epoch in range(num_epochs):
                t0 = time.perf_counter()
                losses, gnorms = [], []
                batches = dataset.batches(tr.batch_size, shuffle=True, seed=tr.seed + epoch)
                stop = False
                t_win = time.perf_counter()
                steps_win = 0
                for x, y in prefetch_to_device(batches, self.device):
                    self.state, m = self.train_step(self.state, x, y)
                    step += 1
                    steps_win += 1
                    losses.append(m["loss"])
                    gnorms.append(m["grad_norm"])
                    if tr.debug_nans and not bool(torch.isfinite(losses[-1])):
                        raise FloatingPointError(f"non-finite loss at step {step}")
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
                    break
                mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
                epoch_losses.append(mean_loss)
                epoch_kv = dict(step=step, epoch=epoch, epoch_loss=mean_loss,
                                epoch_seconds=time.perf_counter() - t0)
                if val_dataset is not None:
                    epoch_kv["val_loss"] = self.evaluate(val_dataset)
                logger.log(**epoch_kv)
        finally:
            logger.close()
        return epoch_losses
