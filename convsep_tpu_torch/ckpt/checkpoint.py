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
current stream, with one wait for all of them, before the file is
written. The writer is synchronous: ``save`` returns once the checkpoint
is on disk (``wait`` has nothing to wait for).

A state holding inference-prepared operands (what
``ConvSep.prepare_inference`` builds: the composed encoder weight and the
decode operands, which replace the raw ``fc_expand_kernel``) is refused:
checkpoint the trainable parameter dict instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import torch

_STATE = "state.pt"
_META = "meta.json"
# the buffers ConvSep.prepare_inference adds (models/convsep.py::ConvSep._operands)
PREPARED_NAMES = frozenset({"w_eff", "bias_eff", "k4", "b3", "kcat", "band", "band_taps"})


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


class CheckpointManager:
    """Atomic per-step checkpoints in ``directory`` (created), the newest
    ``max_to_keep`` kept (None: all)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1 or None, got {max_to_keep}")
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self._dir)
                      if d.isdigit() and os.path.isfile(os.path.join(self._dir, d, _META)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: dict | None = None) -> bool:
        """Write ``state`` (and ``extra``, JSON-serializable) as checkpoint
        ``step``; False (nothing written) if a checkpoint at ``step`` or
        later exists, as the reference's manager skips such saves."""
        if _has_prepared_leaves(state):
            raise ValueError(
                "refusing to checkpoint an inference-prepared state (prepare_inference "
                "replaces the raw fc_expand_kernel with derived operands): save the "
                "trainable parameter dict instead"
            )
        step = int(step)
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        leaves = host_leaves(state)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self._dir)
        try:
            torch.save(leaves, os.path.join(tmp, _STATE))
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(extra if extra is not None else {}, f)
            os.replace(tmp, os.path.join(self._dir, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self._max_to_keep is not None:
            for old in self.all_steps()[: -self._max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)), ignore_errors=True)
        return True

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Checkpoint ``step`` in the structure of ``like`` (a live state
        works; its tensors say each leaf's device) → (state, meta)."""
        d = os.path.join(self._dir, str(int(step)))
        leaves = torch.load(os.path.join(d, _STATE), map_location="cpu", weights_only=True)
        with open(os.path.join(d, _META)) as f:
            meta = json.load(f)
        return unflatten_like(like, leaves), dict(meta or {})

    def restore_latest(self, like: Any) -> tuple[Any, dict] | None:
        """The newest checkpoint as (state, meta), or None if there is none."""
        step = self.latest_step()
        return None if step is None else self.restore(step, like)

    def wait(self, timeout: float | None = None) -> bool:
        """Saves are synchronous: nothing is ever outstanding."""
        return True

    def close(self) -> None:
        pass
