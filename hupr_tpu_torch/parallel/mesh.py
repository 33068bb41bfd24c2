"""Data parallelism with one process per card (counterpart of
`hupr_tpu/parallel/mesh.py`).

The JAX package runs one program over a one-axis device mesh: batch leaves
sharded on their leading axis, parameters and optimizer state replicated,
XLA inserting the gradient all-reduce. Here each process holds one card
and its block of every batch. The "mesh" is a small object (`Mesh`): the
process's rank, the world size and its device, over the default process
group. Rows of a global batch map to ranks in contiguous blocks
(multihost.local_row_range). The train step syncs BN's statistics over the
real rows of the global batch and sums the gradients across ranks
(engine/steps.py); a world of one runs the single-card step unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hupr_tpu_torch.parallel import multihost
from hupr_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """The data-parallel world as this process sees it: its rank, the
    number of ranks, and its device. Collectives run over the default
    process group."""
    rank: int
    world: int
    device: torch.device

    @property
    def parallel(self) -> bool:
        """True when there is more than one rank to reduce over."""
        return self.world > 1


def make_mesh(device=None) -> Mesh:
    """The mesh of this process: the default process group's rank and
    size (0 and 1 without one). The device is `device` when given; else,
    in a process group, cuda:LOCAL_RANK, and without one the card as
    utils.device.resolve_device picks it."""
    if multihost.is_initialized() and device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", multihost.local_rank())
    else:
        dev = resolve_device(device)
    return Mesh(multihost.process_index(), multihost.process_count(), dev)


def _pad_batch_axis(arr, target: int):
    """Pad the batch axis to `target` rows by repeating the last sample
    (numpy or torch): padded rows are masked out of the loss and BN
    statistics and sliced off by the caller."""
    rem = target - arr.shape[0]
    if rem == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(rem, *arr.shape[1:])])
    return np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)])


def shard_batch(batch: dict, mesh: Mesh,
                pad_to: Optional[int] = None) -> tuple:
    """This rank's block of a global batch that every rank holds whole:
    the batch padded by repeating its last sample to max(rows, pad_to)
    rounded up to a multiple of the world size, a "mask" leaf (1.0 real,
    0.0 padded) added, and the rank's contiguous block of every leaf put
    on `mesh.device`. Returns (block, true_batch_size)."""
    true_b = next(iter(batch.values())).shape[0]
    target = max(true_b, pad_to or 0)
    padded_b = target + ((-target) % mesh.world)
    rows = padded_b // mesh.world
    lo, hi = mesh.rank * rows, (mesh.rank + 1) * rows
    out = {k: torch.as_tensor(_pad_batch_axis(v, padded_b)[lo:hi])
           .to(mesh.device) for k, v in batch.items()}
    mask = (np.arange(lo, hi) < true_b).astype(np.float32)
    out["mask"] = torch.from_numpy(mask).to(mesh.device)
    return out, true_b


def state_tensors(model: torch.nn.Module,
                  optimizer: Optional[torch.optim.Optimizer] = None) -> list:
    """Every tensor a replica must hold equal: the parameters, the
    buffers (BN's running statistics and counts), and the optimizer's
    per-parameter state (Adam's moments and step), in a fixed order."""
    out = [p.data for p in model.parameters()] + list(model.buffers())
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                state = optimizer.state.get(p, {})
                out += [state[k] for k in sorted(state)
                        if isinstance(state[k], torch.Tensor)]
    return out


def replicate_state(state, mesh: Mesh):
    """Make every rank's TrainState equal to rank 0's: the model (built
    from the same seed on every rank, or loaded from a shared checkpoint)
    and the optimizer's state are broadcast from rank 0 in place. Returns
    `state`."""
    if mesh.parallel:
        multihost.replicate_tree(state_tensors(state.model, state.optimizer),
                                 mesh)
    return state


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is all_reduce(SUM) of the gradient:
    each rank's loss is its share of the global loss, so the gradient of a
    value every rank read is the sum of every rank's gradient of it."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over all ranks, on every rank; differentiable."""
    return _AllReduceSum.apply(x)


def gather_blocks(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `local` block concatenated in rank order along the
    leading axis, on every rank, with gradients flowing back to the rank
    that made each block: a zero-filled full buffer with this rank's block
    written in, summed over the ranks in float32 (exact: every element is
    one rank's value plus zeros). Returns `local`'s dtype."""
    if not mesh.parallel:
        return local
    rows = local.shape[0]
    x = local.to(torch.float32)
    parts = []
    if mesh.rank > 0:
        parts.append(x.new_zeros((mesh.rank * rows,) + x.shape[1:]))
    parts.append(x)
    if mesh.rank < mesh.world - 1:
        parts.append(x.new_zeros(((mesh.world - 1 - mesh.rank) * rows,)
                                 + x.shape[1:]))
    return all_reduce_sum(torch.cat(parts)).to(local.dtype)


def device_prefetch(batch_iter, mesh: Mesh,
                    keys=("hori", "vert", "jointsGroup"),
                    pad_to: Optional[int] = None):
    """utils.prefetch.device_prefetch onto `mesh.device`: batch i+1's copy
    runs while step i does. Batches with a "trueRows" count come from a
    process-sliced BatchLoader and carry this rank's rows of the padded
    global batch; they get the global mask (multihost.global_shard_batch).
    Yields (device_batch, host_batch, true_batch_size)."""
    from hupr_tpu_torch.utils.prefetch import device_prefetch as prefetch

    return prefetch(batch_iter, mesh.device, pad_to=pad_to, keys=keys)
