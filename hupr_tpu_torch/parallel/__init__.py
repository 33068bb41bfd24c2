"""Data-parallel and multi-process training and eval over torch.distributed
(counterpart of `hupr_tpu/parallel/`): `mesh` (the rank's view of the
world, batch blocks, state replication, the differentiable exchanges) and
`multihost` (process-sliced loading, the control plane, rank-file eval)."""

from hupr_tpu_torch.parallel.mesh import (Mesh, make_mesh, replicate_state,
                                          shard_batch)

__all__ = ["Mesh", "make_mesh", "replicate_state", "shard_batch"]
