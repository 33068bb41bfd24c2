"""One request's frames split over ranks: the rank's frame block, the
sliding window's halo exchange, and the windows of a block.

The JAX package shards the frame axis of one serving request over a
one-axis device mesh, and XLA turns the sliding window's replicate-padded
slices into halo exchanges between devices (hupr_tpu/engine/pipeline.py,
make_e2e_infer(mesh=)). Here each rank is a process, so the exchange is
written out: every rank holds a contiguous block of `s` frames
(`frame_block`), and the window of global frame g reads frames
clamp(g - G//2) .. clamp(g + G - G//2 - 1), each clamped within its own
`duration`-frame sequence (the reference's `index % duration`). A rank
therefore needs the G//2 frames before its block and the G - G//2 - 1
after it: 4 and 3 at G = 8. `halo_exchange` moves only those edge frames,
in one all_gather of every rank's first min(s, right) and last
min(s, left) frames, so a block smaller than the halo reads its frames
from several ranks on each side. A world of one runs the unsharded
windowing and no collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from hupr_tpu_torch.engine.pipeline import window_stack_sequences
from hupr_tpu_torch.parallel.mesh import Mesh
from hupr_tpu_torch.utils import profiling


def frame_block(total_frames: int, mesh: Mesh) -> tuple:
    """This rank's contiguous frame range [lo, hi) of `total_frames`
    split evenly over the ranks in rank order. Raises ValueError unless
    the world size divides the frame count."""
    if total_frames % mesh.world != 0:
        raise ValueError(f"{total_frames} frames do not split evenly over "
                         f"{mesh.world} ranks")
    s = total_frames // mesh.world
    return mesh.rank * s, (mesh.rank + 1) * s


def halo_exchange(local: torch.Tensor, mesh: Mesh, left: int,
                  right: int) -> torch.Tensor:
    """This rank's block `local` (s, ...) with the `left` frames before it
    and the `right` frames after it: (left + s + right, ...), row j being
    global frame clamp(lo - left + j, 0, F - 1) of the F = s * world
    frames. Every rank must call it with blocks of one shape; the frames
    from other ranks come from one all_gather of each rank's first
    min(s, right) and last min(s, left) frames."""
    s = local.shape[0]
    total = s * mesh.world
    lo = mesh.rank * s
    frames = np.clip(np.arange(lo - left, lo + s + right), 0, total - 1)
    owner, offset = np.divmod(frames, s)
    head, tail = min(s, right), min(s, left)
    # row of each frame in cat([local, edges of rank 0, edges of rank 1,
    # ...]), a rank's edges being its first `head` frames, then its last
    # `tail`
    edge = np.where(offset < head, offset, head + offset - (s - tail))
    source = np.where(owner == mesh.rank, offset,
                      s + owner * (head + tail) + edge)
    if not mesh.parallel:
        return local[torch.as_tensor(source, device=local.device)]
    edges = torch.cat([local[:head], local[s - tail:]]).contiguous()
    gathered = [torch.empty_like(edges) for _ in range(mesh.world)]
    profiling.count("hupr.collectives")
    dist.all_gather(gathered, edges)
    return torch.cat([local] + gathered)[
        torch.as_tensor(source, device=local.device)]


def _window_frames(lo: int, hi: int, group: int, duration: int,
                   total_frames: int) -> np.ndarray:
    """(hi - lo, G) global frame of each window slot of frames [lo, hi):
    frame g's window reads g - G//2 + j, clamped within g's sequence
    (pipeline.window_stack_sequences' clamp). Raises ValueError where
    window_stack_sequences does: more than one sequence, not whole."""
    if total_frames > duration and total_frames % duration != 0:
        raise ValueError(f"frame stack of {total_frames} must be whole "
                         f"{duration}-frame sequences")
    span = min(duration, total_frames)
    g = np.arange(lo, hi)[:, None]
    first = g // span * span
    return np.clip(g - group // 2 + np.arange(group)[None], first,
                   first + span - 1)


def window_stack_sharded(local_maps: torch.Tensor, mesh: Mesh, group: int,
                         duration: int, total_frames: int) -> torch.Tensor:
    """This rank's windows (s, G, ...) of its block `local_maps` (s, ...)
    of `total_frames` per-frame values: rows lo:hi of
    pipeline.window_stack_sequences on the whole stack, bit for bit,
    frames past a sequence boundary clamped and never read from a
    neighbour. A world of one is window_stack_sequences itself."""
    if not mesh.parallel:
        return window_stack_sequences(local_maps, group, duration)
    lo, hi = frame_block(total_frames, mesh)
    if local_maps.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} holds {local_maps.shape[0]} "
                         f"frames, its block of {total_frames} is "
                         f"{hi - lo}")
    left = group // 2
    idx = _window_frames(lo, hi, group, duration, total_frames)
    padded = halo_exchange(local_maps, mesh, left, group - left - 1)
    return padded[torch.as_tensor(idx - (lo - left),
                                  device=local_maps.device)]
