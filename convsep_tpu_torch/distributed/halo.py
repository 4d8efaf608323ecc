"""halo_overlap_add: overlap-add of a frame axis split over the ranks.

Mirror of ``convsep_tpu.distributed.halo`` (the conv/OLA analog of context
parallelism): a track's iSTFT frames are split over the mesh's ``data``
axis; each rank overlap-adds its own block, and the ``win_length - hop``
seam samples that spill into the next rank's region go to it in one
point-to-point exchange a boundary (``dist.batch_isend_irecv``), where they
are added to its head. The last rank's spill past the bodies is broadcast;
the bodies are gathered, so every rank returns the whole signal.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from convsep_tpu_torch.dsp.istft import overlap_add


def _check(nf: int, n: int, w: int, hop: int, axis: str) -> int:
    if nf % n:
        raise ValueError(f"n_frames {nf} not divisible by mesh axis {axis}={n}")
    halo = w - hop
    if halo < 0:
        raise ValueError(f"hop {hop} > win_length {w}")
    if nf // n * hop < halo:
        raise ValueError(
            f"local block too short: {nf // n} frames x hop {hop} < halo {halo}")
    return halo


def halo_overlap_add(frames: torch.Tensor, hop: int, mesh, axis: str = "data") -> torch.Tensor:
    """Distributed OLA of (..., n_frames, win_length) → (..., (n_frames −
    1)·hop + W), on every rank. ``frames`` is the whole frame array (each
    rank reads its block along axis −2); leading axes (sources, channels)
    are replicated. Needs n_frames divisible by the axis size and blocks
    long enough that a seam only reaches the next rank."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    *lead, nf, w = frames.shape
    _check(nf, n, w, hop, axis)
    r = mesh.get_local_rank(axis)
    block = frames[..., r * (nf // n):(r + 1) * (nf // n), :]
    return halo_overlap_add_local(block, hop, mesh, axis)


def halo_overlap_add_local(block: torch.Tensor, hop: int, mesh, axis: str = "data"
                           ) -> torch.Tensor:
    """:func:`halo_overlap_add` from this rank's block (..., n_frames / n,
    W) of the frames alone (the blocks in rank order make the whole)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    *lead, nf_local, w = block.shape
    halo = _check(nf_local * n, n, w, hop, axis)
    ola = overlap_add(block, hop)  # (..., (nf_local - 1)·hop + W)
    body = ola[..., :nf_local * hop].contiguous()
    tail = ola[..., nf_local * hop:].contiguous()  # (..., halo)
    if n == 1:
        return torch.cat([body, tail], dim=-1)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    r = mesh.get_local_rank(axis)
    ops, from_left = [], None
    if r < n - 1:
        ops.append(dist.P2POp(dist.isend, tail, ranks[r + 1], group))
    if r > 0:
        from_left = torch.empty_like(tail)
        ops.append(dist.P2POp(dist.irecv, from_left, ranks[r - 1], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if from_left is not None:
        body[..., :halo] += from_left
    # only the last rank's spill reaches past the concatenated bodies
    dist.broadcast(tail, ranks[n - 1], group=group)
    bodies = [torch.empty_like(body) for _ in range(n)]
    dist.all_gather(bodies, body, group=group)
    return torch.cat(bodies + [tail], dim=-1)
