"""Single-pass fused adadelta: the CUDA kernel's wrapper and plain version.

Replaces ``convsep_tpu/train/fused_optim.py::fused_adadelta_apply``, which
the training step runs when ``TrainConfig.optimizer_impl="fused"``. The
kernel (``csrc/fused_adadelta.cu``) reads p, g, accu and delta_accu once
and writes p, accu and delta_accu back in place, with the leaf's
gradient square-sum for the grad norm; its header says what bounds it on
the H100.

The leaf rule is the reference's: float32 leaves with at least
``min_elems`` elements take the kernel, the rest the plain formula
(:func:`fused_adadelta_plain`, the reference's ``_leaf_jnp``). The
reference also needs a TPU tiling of the leaf; the CUDA kernel takes any
size. For CPU tensors every leaf takes the plain formula; a CUDA leaf
past ``min_elems`` launches the kernel or raises.

Unlike the reference, the update is in place: the parameter tensors (and
the state's accumulator tensors) are overwritten, so a step holds one copy
of each 265 MB leaf.
"""

from __future__ import annotations

import ctypes

import torch

from convsep_tpu_torch import kernels
from convsep_tpu_torch.train.optim import AdadeltaState, adadelta_leaf

# the kernel engages only on leaves at least this many elements (as the
# reference: a launch per bias is not worth it)
_MIN_ELEMS = 1 << 20
_MAX_BLOCKS = 1024  # csrc/fused_adadelta.cu kMaxBlocks


@torch.no_grad()
def fused_adadelta_plain(p, g, a, d, lr: float, rho: float, eps: float) -> torch.Tensor:
    """One leaf in plain PyTorch, in place: p, a, d are overwritten with the
    updated values (:func:`adadelta_leaf`, the reference's ``_leaf_jnp`` op
    order). Returns the leaf's gradient square-sum (0-d float32)."""
    u, a2, d2 = adadelta_leaf(g, a, d, rho, eps)
    p.copy_(p - lr * u)
    a.copy_(a2)
    d.copy_(d2)
    return (g * g).sum()


@torch.no_grad()
def fused_adadelta_leaf(p, g, a, d, lr: float, rho: float, eps: float) -> torch.Tensor:
    """One leaf, in place: the plain version for CPU tensors, the kernel for
    CUDA tensors (float32, contiguous, distinct, one device)."""
    ts = (p, g, a, d)
    devices = {t.device.type for t in ts}
    if devices == {"cpu"}:
        return fused_adadelta_plain(p, g, a, d, lr, rho, eps)
    if devices != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"fused_adadelta: tensors on mixed devices {devices}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("fused_adadelta kernel takes float32 tensors")
    if any(t.shape != p.shape for t in ts) or not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_adadelta kernel takes contiguous tensors of one shape")
    if len({t.data_ptr() for t in ts}) != 4:
        raise ValueError("fused_adadelta kernel takes four distinct tensors")
    dev = p.device
    partial = torch.empty(_MAX_BLOCKS, dtype=torch.float64, device=dev)
    sq = torch.empty((), dtype=torch.float32, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fused_adadelta_launch(
            p.data_ptr(), g.data_ptr(), a.data_ptr(), d.data_ptr(), p.numel(),
            ctypes.c_float(lr), ctypes.c_float(rho), ctypes.c_float(1.0 - rho),
            ctypes.c_float(eps), partial.data_ptr(), sq.data_ptr(), stream,
        )
    kernels.check(code, "fused_adadelta")
    kernels.LAUNCHES["fused_adadelta"] += 1
    return sq


@torch.no_grad()
def fused_adadelta_apply(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdadeltaState,
    learning_rate: float = 1.0,
    rho: float = 0.95,
    eps: float = 1e-6,
    *,
    min_elems: int = _MIN_ELEMS,
):
    """(params, grads, AdadeltaState) → (params, AdadeltaState, grad_norm),
    the whole adadelta step, one pass per large leaf. ``params`` and
    ``state`` are updated in place and returned."""
    sqs = []
    for k, p in params.items():
        g, a, d = grads[k], state.accu[k], state.delta_accu[k]
        fuse = p.dtype == torch.float32 and p.numel() >= min_elems
        leaf = fused_adadelta_leaf if fuse else fused_adadelta_plain
        sqs.append(leaf(p, g, a, d, learning_rate, rho, eps))
    return params, state, torch.sqrt(sum(sqs))
