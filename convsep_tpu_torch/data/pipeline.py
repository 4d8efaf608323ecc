"""Host → device batch feeding.

Mirror of ``prefetch_to_device`` in ``convsep_tpu.data.pipeline``, as a
one-deep prefetch on the caller's thread: batch i + 1 is assembled on the
host and its copy enqueued while the device still runs step i (PyTorch
returns from a step before the device finishes it). Arrays go through
pinned host buffers and ``non_blocking`` copies to an explicit device; the
caching host allocator keeps a pinned buffer alive until its copy is done.
The feature-file ``SegmentDataset`` is not ported.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

_EMPTY = object()


def to_device(item: Any, device: torch.device) -> Any:
    """numpy arrays and tensors in nested tuples / lists → tensors on
    ``device`` (pinned, non-blocking for CUDA); other leaves unchanged."""
    if isinstance(item, (tuple, list)):
        return type(item)(to_device(x, device) for x in item)
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(np.ascontiguousarray(item))
    if not isinstance(item, torch.Tensor):
        return item
    if device.type == "cuda" and item.device.type == "cpu":
        return item.pin_memory().to(device, non_blocking=True)
    return item.to(device)


def prefetch_to_device(iterator: Iterator, device: str | torch.device) -> Iterator:
    """Yield the iterator's items on ``device``, one item ahead: each item's
    copy is enqueued before the previous item is handed out."""
    device = torch.device(device)
    pending = _EMPTY
    for item in iterator:
        item = to_device(item, device)
        if pending is not _EMPTY:
            yield pending
        pending = item
    if pending is not _EMPTY:
        yield pending
