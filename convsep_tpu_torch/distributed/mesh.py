"""Device mesh helpers over ``torch.distributed``.

Mirror of ``convsep_tpu.distributed.mesh``. The reference's mesh is one
controller over many devices (a ``jax.sharding.Mesh``); here it is one
process per device: every rank runs the same program on its own device,
the ranks joined by an initialized process group (NCCL between GPUs, gloo
on the CPU), and the mesh is a ``DeviceMesh`` over those ranks with the
reference's axes: ``("data", "model")``, or ``("dcn", "data", "model")``
with a leading inter-slice axis. A "sharded" array is each rank's block
of it on the rank's device; a "replicated" one is the whole array on
every rank. The mesh spans every rank of the process group. Its device is
chosen as the single-device entry points choose theirs: the GPU (the
launcher's ``LOCAL_RANK``, made current), which raises without one, and
the CPU only when the caller asks for it.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from convsep_tpu_torch.utils.device import resolve_device


def _local_device(device) -> torch.device:
    """``None`` or an index-less "cuda" → ``cuda:LOCAL_RANK`` (raises without
    a GPU), made the current device; "cpu" only when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
        torch.cuda.set_device(dev)
    return dev


def make_mesh(devices=None, data: int | None = None, model: int = 1, dcn: int = 1,
              axis_names=("data", "model"), device: str | torch.device | None = None):
    """A (data, model), or with ``dcn`` > 1 a (dcn, data, model), mesh over
    the process group's ranks (``devices``: those ranks, default all).
    ``data`` defaults to what the ranks leave after ``model`` and ``dcn``.
    The batch shards over ``("dcn", "data")`` jointly (:func:`batch_axes`).
    ``device``: this rank's device (module docstring); ``None`` is the
    launcher's GPU, which becomes current. Ranks along ``model`` hold the
    same batch block: nothing here splits the parameters."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(d) for d in devices]
    n = len(ranks)
    if data is None:
        data = n // (model * dcn)
    need = data * model * dcn
    if need > n:
        raise ValueError(
            f"mesh {dcn}x{data}x{model} needs {need} devices, have {n}"
            if dcn > 1
            else f"mesh {data}x{model} needs {need} devices, have {n}"
        )
    if need != dist.get_world_size():
        raise ValueError(f"the mesh must span every rank of the process group: "
                         f"{need} of {dist.get_world_size()}")
    device_type = _local_device(device).type
    if dcn > 1:
        shape, names = (dcn, data, model), ("dcn",) + tuple(axis_names)
    else:
        shape, names = (data, model), tuple(axis_names)
    return DeviceMesh(device_type, torch.tensor(ranks[:need]).reshape(shape),
                      mesh_dim_names=names)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dimension shards over (dcn + data when multi-slice)."""
    return ("dcn", "data") if "dcn" in mesh.mesh_dim_names else ("data",)


def batch_block(mesh) -> tuple[int, int]:
    """(this rank's index, count) along the joint batch axes."""
    index, count = 0, 1
    for name in batch_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index = index * size + mesh.get_local_rank(name)
        count *= size
    return index, count


def gather_batch(mesh, block: torch.Tensor) -> torch.Tensor:
    """Every rank's block of a batch (along axis 0) → the whole batch on
    every rank, the blocks in batch order (int16 travels as its bytes:
    neither NCCL nor gloo reduces or gathers int16)."""
    wire = block.contiguous()
    if wire.dtype == torch.int16:
        wire = wire.view(torch.float16)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, wire)
    names = mesh.mesh_dim_names
    axes = [names.index(a) for a in batch_axes(mesh)]
    owner: dict[int, int] = {}
    grid = mesh.mesh
    for coord in np.ndindex(*grid.shape):
        index = 0
        for a in axes:
            index = index * grid.shape[a] + coord[a]
        owner.setdefault(index, int(grid[coord]))
    out = torch.cat([parts[owner[i]] for i in range(len(owner))])
    return out.view(block.dtype) if block.dtype == torch.int16 else out


def rank_device(mesh) -> torch.device:
    """The device this rank's blocks live on (:func:`make_mesh` made it
    current)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def take_block(a, mesh, axis: int):
    """This rank's block of ``a`` (numpy or tensor) along ``axis``, split
    over the batch axes; the length must divide evenly."""
    index, count = batch_block(mesh)
    n = a.shape[axis]
    if n % count:
        raise ValueError(f"axis {axis} of length {n} does not split over {count} ranks")
    step = n // count
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(index * step, (index + 1) * step)
    return a[tuple(sl)]


def _map(item: Any, fn: Callable) -> Any:
    if isinstance(item, (tuple, list)):
        return type(item)(_map(x, fn) for x in item)
    if isinstance(item, dict):
        return {k: _map(v, fn) for k, v in item.items()}
    return fn(item) if hasattr(item, "shape") else item


def _to(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def host_block(mesh, stacked: bool = False) -> Callable:
    """A placer for ``prefetch_to_device(sharding=)``: this rank's block of
    every array leaf's leading axis (mixed ranks: (B, seg) and (B, S, seg)
    audio batches, (B, T, F, C) feature batches), or of axis 1 for a
    ``stacked`` (K, B, …) multi-step batch, still on the host, so only
    that block is uploaded."""
    return lambda item: _map(item, lambda a: take_block(a, mesh, 1 if stacked else 0))


def put_leading(mesh, item):
    """:func:`host_block` of ``item``, on the rank's device."""
    device = rank_device(mesh)
    return _map(host_block(mesh)(item), lambda a: _to(a, device))


def put_stacked(mesh, item):
    """The same for a (K, B, …) multi-step batch: axis 0 (the steps) whole,
    axis 1 (the batch) split."""
    device = rank_device(mesh)
    return _map(host_block(mesh, stacked=True)(item), lambda a: _to(a, device))


def mean_over_ranks(mesh) -> Callable:
    """(loss, grads) → the same averaged over the mesh's ranks: one
    flattened buffer, all-reduced by SUM and divided by the rank count
    (gloo has no AVG). Ranks that share a batch block (a ``model`` axis)
    hold equal terms, so the mean is the batch blocks' mean."""
    size = mesh.size()

    @torch.no_grad()
    def reduce(loss: torch.Tensor, grads: dict) -> tuple[torch.Tensor, dict]:
        names = list(grads)
        flat = torch.cat([loss.detach().reshape(1).float()] +
                         [grads[k].reshape(-1).float() for k in names])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= size
        out, at = {}, 1
        for k in names:
            g = grads[k]
            out[k] = flat[at: at + g.numel()].view_as(g).to(g.dtype)
            at += g.numel()
        return flat[0].to(loss.dtype), out

    return reduce


# The reference's placements as DTensor placements, one per mesh axis. The
# port's ranks each hold whole, local parameter and batch tensors (the
# batch as its block, through take_block / host_block), so no code of the
# port applies these; they state the reference's rules for a caller that
# builds DTensors on this mesh.

def _placements():
    try:  # public since torch 2.4
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:  # pragma: no cover - older torch
        from torch.distributed._tensor import Replicate, Shard
    return Replicate, Shard


def batch_sharding(mesh, ndim: int) -> tuple:
    """DTensor placements sharding the leading (batch) axis over ``data``
    (and ``dcn``), replicating the rest, one per mesh axis."""
    Replicate, Shard = _placements()
    axes = batch_axes(mesh)
    return tuple(Shard(0) if name in axes else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    """DTensor placements of a replicated array."""
    Replicate, _ = _placements()
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def param_shardings(mesh, params: dict, axis: str = "model") -> dict:
    """Tensor-parallel placement rules for the flat parameter dict: ``fc``
    kernel rows and ``fc_expand`` kernel columns and bias over ``axis``,
    everything else replicated (one placement per mesh axis)."""
    Replicate, Shard = _placements()

    def on(shard):
        return tuple(shard if name == axis else Replicate() for name in mesh.mesh_dim_names)

    rules = {"fc_kernel": Shard(0), "fc_expand_kernel": Shard(1), "fc_expand_bias": Shard(0)}
    return {k: on(rules[k]) if k in rules else replicated(mesh) for k in params}
