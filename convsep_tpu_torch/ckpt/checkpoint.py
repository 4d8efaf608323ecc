"""Checkpoint manager: atomic per-step saves and restore-latest.

The port's counterpart of ``convsep_tpu.ckpt.orbax_io.CheckpointManager``.
A checkpoint is a directory ``<dir>/<step>/`` holding ``state.pt`` (the
state's leaves, flattened by path, written by ``torch.save``) and
``meta.json`` (a small JSON dict riding beside the state: the training
loop's data position, for mid-epoch resume). A save is written into a
temporary directory beside the others and renamed to ``<step>/`` in one
``os.replace``, so a reader never sees half a checkpoint; the oldest
checkpoints past ``max_to_keep`` are deleted after each save.

Device tensors are copied once each into pinned host memory on the
current stream, with one wait for all of them, on the caller's thread;
that is all a save blocks training for. The file is written, renamed into
place and the old checkpoints pruned by one writer thread
(``async_save=True``, the default, as the reference's orbax manager), or
before ``save`` returns (``async_save=False``). One write is in flight at
a time: a save, a read (``all_steps``, ``restore``, …) or ``wait`` first
waits for the write in flight, up to ``async_timeout_s``; past it the
manager warns (``on_warning``), abandons the wedged writer (its step is
dropped: it is never renamed into place) and saves synchronously from then
on (``fell_back_to_sync``), as the reference's watchdog does. A write that
failed raises at the next save, read or wait. A write killed midway
leaves only a temporary directory, which no read lists.

A state holding inference-prepared operands (what
``ConvSep.prepare_inference`` builds: the composed encoder weight and the
decode operands, which replace the raw ``fc_expand_kernel``) is refused:
checkpoint the trainable parameter dict instead.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
import threading
from typing import Any, Callable

import torch

log = logging.getLogger(__name__)

_STATE = "state.pt"
_META = "meta.json"
# the buffers ConvSep.prepare_inference adds (models/convsep.py::ConvSep._operands)
PREPARED_NAMES = frozenset({"w_eff", "bias_eff", "k4", "b3", "kcat", "band", "band_taps",
                            "band_stream"})


def _has_prepared_leaves(tree: Any) -> bool:
    """True if ``tree`` holds inference-prepared operands: a prepared
    ``ConvSep``, or a dict (a state dict of one) with their names."""
    if getattr(tree, "prepared", False) is True:
        return True
    if isinstance(tree, dict):
        return bool(PREPARED_NAMES & set(tree)) or any(
            _has_prepared_leaves(v) for v in tree.values())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return any(_has_prepared_leaves(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, tuple):
        return any(_has_prepared_leaves(v) for v in tree)
    return False


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container node; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # NamedTuple
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{"a/b/c": leaf} over dicts, dataclasses, NamedTuples and sequences."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in kids:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_like(like: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """``like``'s structure with every leaf taken from ``leaves`` by path:
    a tensor leaf lands on the device, dtype and ``requires_grad`` of
    ``like``'s leaf (its shape must match); other leaves as saved."""
    kids = _children(like)
    if kids is None:
        if prefix not in leaves:
            raise KeyError(f"checkpoint has no leaf {prefix!r}")
        got = leaves[prefix]
        if isinstance(like, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != like.shape:
                raise ValueError(f"checkpoint leaf {prefix!r}: "
                                 f"{getattr(got, 'shape', type(got))} != {tuple(like.shape)}")
            return got.to(device=like.device, dtype=like.dtype).requires_grad_(like.requires_grad)
        return got
    vals = {k: unflatten_like(v, leaves, f"{prefix}/{k}" if prefix else k) for k, v in kids}
    if isinstance(like, dict):
        return type(like)((k, vals[str(k)]) for k in like)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **vals)
    if hasattr(like, "_fields"):
        return type(like)(**vals)
    return type(like)(vals[str(i)] for i in range(len(like)))


def host_leaves(tree: Any) -> dict[str, Any]:
    """The tree's leaves by path, tensors on the host: one copy each into
    pinned memory (non-blocking) for device tensors, then one wait."""
    out, streams = {}, set()
    for path, leaf in flatten(tree).items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                streams.add(torch.cuda.current_stream(t.device))
                leaf = host
            else:
                leaf = t.clone()
        out[path] = leaf
    for s in streams:
        s.synchronize()
    return out


class _Write:
    """One checkpoint's write on the writer thread."""

    def __init__(self, manager: "CheckpointManager", step: int, leaves: dict, extra: dict):
        self.done = threading.Event()
        self.abandoned = False
        self.error: BaseException | None = None
        # not a daemon: a script that ends without wait() still finishes its
        # last checkpoint before the interpreter exits
        self.thread = threading.Thread(target=self._run, args=(manager, step, leaves, extra),
                                       name=f"checkpoint-{step}")
        self.thread.start()

    def _run(self, manager, step, leaves, extra):
        try:
            manager._write(step, leaves, extra, self)
        except BaseException as e:  # raised on the caller's side at the next call
            self.error = e
        finally:
            self.done.set()


class CheckpointManager:
    """Atomic per-step checkpoints in ``directory`` (created), the newest
    ``max_to_keep`` kept (None: all). ``async_save``, ``async_timeout_s``
    and ``on_warning`` as the reference's manager (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3, async_save: bool = True,
                 async_timeout_s: float = 300.0, on_warning: Callable[[str], None] | None = None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1 or None, got {max_to_keep}")
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._timeout = async_timeout_s
        self._on_warning = on_warning
        self.fell_back_to_sync = False
        self._pending: _Write | None = None
        os.makedirs(self._dir, exist_ok=True)

    def _warn(self, msg: str) -> None:
        log.warning(msg)
        if self._on_warning is not None:
            self._on_warning(msg)

    def _settle(self, timeout: float | None, what: str) -> bool:
        """Wait for the write in flight, up to ``timeout`` (None: the
        manager's); past it fall back to synchronous saves and return
        False. A failed write raises here."""
        w = self._pending
        if w is None:
            return True
        if not w.done.wait(self._timeout if timeout is None else timeout):
            w.abandoned = True
            self._pending = None
            self._async = False
            self.fell_back_to_sync = True
            self._warn(
                f"async checkpoint {what} did not finish within {self._timeout}s; abandoning "
                f"the wedged writer and falling back to SYNCHRONOUS saves (the unfinished step "
                f"is dropped — atomic commit keeps restores safe)")
            return False
        self._pending = None
        if w.error is not None:
            raise w.error
        return True

    def all_steps(self) -> list[int]:
        """The finished checkpoints' steps (after the write in flight)."""
        self._settle(None, "read")
        return sorted(int(d) for d in os.listdir(self._dir)
                      if d.isdigit() and os.path.isfile(os.path.join(self._dir, d, _META)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: dict | None = None) -> bool:
        """Write ``state`` (and ``extra``, JSON-serializable) as checkpoint
        ``step``; False (nothing written) if a checkpoint at ``step`` or
        later exists, as the reference's manager skips such saves. Returns
        once the state is on the host; the write may still be in flight."""
        if _has_prepared_leaves(state):
            raise ValueError(
                "refusing to checkpoint an inference-prepared state (prepare_inference "
                "replaces the raw fc_expand_kernel with derived operands): save the "
                "trainable parameter dict instead"
            )
        step = int(step)
        self._settle(None, "save")
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        leaves = host_leaves(state)
        extra = dict(extra) if extra is not None else {}
        if self._async:
            self._pending = _Write(self, step, leaves, extra)
        else:
            self._write(step, leaves, extra)
        return True

    def _write(self, step: int, leaves: dict, extra: dict, job: _Write | None = None) -> None:
        """``torch.save`` into a temporary directory, then one rename into
        place (unless the write was abandoned meanwhile), then pruning."""
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self._dir)
        try:
            torch.save(leaves, os.path.join(tmp, _STATE))
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(extra, f)
            if job is not None and job.abandoned:
                raise RuntimeError(f"checkpoint {step} abandoned by the watchdog")
            os.replace(tmp, os.path.join(self._dir, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._max_to_keep is not None:
            steps = sorted(int(d) for d in os.listdir(self._dir)
                           if d.isdigit() and os.path.isfile(os.path.join(self._dir, d, _META)))
            for old in steps[: -self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)), ignore_errors=True)

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Checkpoint ``step`` in the structure of ``like`` (a live state
        works; its tensors say each leaf's device) → (state, meta)."""
        self._settle(None, "read")
        d = os.path.join(self._dir, str(int(step)))
        leaves = torch.load(os.path.join(d, _STATE), map_location="cpu", weights_only=True)
        with open(os.path.join(d, _META)) as f:
            meta = json.load(f)
        return unflatten_like(like, leaves), dict(meta or {})

    def restore_latest(self, like: Any) -> tuple[Any, dict] | None:
        """The newest finished checkpoint as (state, meta), or None if there
        is none."""
        step = self.latest_step()
        return None if step is None else self.restore(step, like)

    def wait(self, timeout: float | None = None) -> bool:
        """Wait for the write in flight (``timeout`` None: the manager's);
        on timeout fall back to synchronous saves and return False."""
        return self._settle(timeout, "wait")

    def close(self) -> None:
        self.wait()
