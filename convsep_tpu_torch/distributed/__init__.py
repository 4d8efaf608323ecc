"""Distributed layer: the device mesh over ``torch.distributed`` ranks and
the halo overlap-add."""

from convsep_tpu_torch.distributed.halo import halo_overlap_add
from convsep_tpu_torch.distributed.mesh import batch_sharding, make_mesh, replicated

__all__ = ["make_mesh", "batch_sharding", "replicated", "halo_overlap_add"]
