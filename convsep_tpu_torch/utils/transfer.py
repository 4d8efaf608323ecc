"""Device → host copies of results.

Counterpart of ``convsep_tpu.utils.transfer.fetch_parallel``. The reference
split its fetch across threads because its link to the TPU was limited per
stream. A CUDA copy into pageable host memory runs through a staging
buffer at a fraction of the link's rate; :func:`fetch` copies into pinned
(page-locked) host memory instead, asynchronously on the current stream,
then waits on that stream. PyTorch's caching host allocator keeps the
pinned blocks for reuse once the returned arrays are dropped; until then
they stay page-locked, so a caller that keeps many results copies them into
ordinary memory (``np.array(result)``).
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
