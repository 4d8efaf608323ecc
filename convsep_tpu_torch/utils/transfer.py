"""Host ↔ device copies of inputs and results.

Counterpart of ``convsep_tpu.utils.transfer.fetch_parallel``. The reference
split its fetch across threads because its link to the TPU was limited per
stream. A CUDA copy into pageable host memory runs through a staging
buffer at a fraction of the link's rate; :func:`fetch` copies into pinned
(page-locked) host memory instead, asynchronously on the current stream,
then waits on that stream. PyTorch's caching host allocator keeps the
pinned blocks for reuse once the returned arrays are dropped; until then
they stay page-locked, so a caller that keeps many results copies them into
ordinary memory (``np.array(result)``).

The streaming separators overlap a track's copies with its compute, which
a wait per copy would serialize. They stage their inputs once in pinned
memory (:func:`stage_pinned`) and run every copy on one side stream of
their own: :func:`upload_async` and :func:`fetch_async` enqueue a copy and
return at once, with the event that marks it done, and
:func:`wait_upload` orders the compute stream after an upload only where
the upload is first used. On CPU tensors every copy is immediate and no
event is returned.
"""

from __future__ import annotations

import numpy as np
import torch


def fetch(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array: a view of ``t`` itself on the CPU; for a
    CUDA tensor, a view of a pinned copy that is complete when this
    returns and stays page-locked while the view lives."""
    if t.device.type == "cpu":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def stage_pinned(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a host tensor to upload to ``device`` from: a
    page-locked copy for a CUDA device (so that :func:`upload_async` does
    not wait for the host), the array's own memory for the CPU."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    return host.pin_memory() if device.type == "cuda" else host


def upload_async(host: torch.Tensor, device: torch.device,
                 stream: torch.cuda.Stream | None) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Enqueue ``host`` (pinned, contiguous) → ``device`` on ``stream`` and
    return at once: the device tensor and the event recorded after the
    copy. The tensor may be read only on a stream that has waited on the
    event: pass both to :func:`wait_upload` on the stream that uses it,
    just before the first use. On the CPU: ``host`` itself, no event."""
    if device.type == "cpu":
        return host, None
    with torch.cuda.stream(stream):
        dev = host.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return dev, done


def wait_upload(dev: torch.Tensor, event: torch.cuda.Event | None) -> torch.Tensor:
    """Order the current stream after the upload that ``event`` marks and
    tell the caching allocator that this stream uses ``dev`` (its block is
    not handed out again before the current stream's work on it is done).
    The host does not wait. Returns ``dev``."""
    if event is not None:
        current = torch.cuda.current_stream(dev.device)
        current.wait_event(event)
        dev.record_stream(current)
    return dev


def fetch_async(t: torch.Tensor, stream: torch.cuda.Stream | None,
                ready: torch.cuda.Event | None = None
                ) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """Enqueue ``t`` → pinned host memory on ``stream`` and return at once:
    the host tensor and the event recorded after the copy. The copy starts
    after ``ready`` (an event recorded on the stream that computed ``t``
    once it was written), or after the work the current stream has
    enqueued so far when ``ready`` is None. The host may read the tensor
    only once the event has completed (``event.synchronize()``). On the
    CPU: ``t`` itself, no event."""
    if t.device.type == "cpu":
        return t, None
    current = torch.cuda.current_stream(t.device)
    if ready is None:
        ready = torch.cuda.Event()
        ready.record(current)
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        t.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
    return host, done


def host_array(host: torch.Tensor, event: torch.cuda.Event | None) -> np.ndarray:
    """The result of :func:`fetch_async` as a numpy array, once its copy
    has completed (the host waits on ``event``)."""
    if event is not None:
        event.synchronize()
    return host.numpy()
