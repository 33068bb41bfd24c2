"""Multi-process runs: process-sliced data loading, the control plane and
distributed evaluation (counterpart of `hupr_tpu/parallel/multihost.py`).

Model: `HUPR_MULTIHOST=1 python -m hupr_tpu_torch.main ...` in every
process, one process per card, with the environment `torchrun` sets
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); main.run calls
`initialize`, the counterpart of jax.distributed.initialize(). Training is
data parallel over all processes: each process assembles only its block of
every padded global batch (data.BatchLoader(process=, padded_rows=)), the
train step syncs BN's statistics and sums the gradients across processes
(engine/steps.py). Evaluation is split by sequence: each process runs
sequence-mode eval over its round-robin share on its own card, writes a
rank file, and process 0 merges and scores it; the AP is broadcast so that
every process agrees on best-model tracking.

The data dir and the ./logs dir must be on a filesystem every process
sees (the rank-file merge, process-0-only checkpoints, resume): the Runner
checks the logs dir at startup with `assert_shared_dir`, and catches
divergent per-host data copies with `assert_agreement` on the dataset
sizes, since hosts with different annotation files would run different
numbers of batches and hang at a skewed collective.

The control plane (barriers, verdicts, scalar broadcasts) goes through the
c10d store of the default process group, never a device collective, as the
JAX package goes through its coordination service's key-value store: every
process publishes what it saw and reads everyone else's, so a disagreement
raises on every process together instead of stranding the others at the
next collective, and a process may arrive up to _SYNC_TIMEOUT_S late.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hupr_tpu_torch.utils import profiling

_SYNC_TIMEOUT_S = 600
_seq: dict = {}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's card on its host: LOCAL_RANK, as torchrun sets it
    (0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(device=None, backend: Optional[str] = None,
               init_method: str = "env://") -> None:
    """torch.distributed.init_process_group from the environment (RANK,
    WORLD_SIZE, and MASTER_ADDR / MASTER_PORT for env://). The backend is
    `backend` when given, else nccl on the card and gloo when `device` asks
    for the CPU; on the card the process's current device becomes
    cuda:LOCAL_RANK first. Collectives time out after _SYNC_TIMEOUT_S."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"HUPR_MULTIHOST=1 needs {missing} in the "
                           f"environment (and MASTER_ADDR / MASTER_PORT): "
                           f"start every process with torchrun, or set "
                           f"them")
    cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if cpu else "nccl"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=init_method,
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=_SYNC_TIMEOUT_S))


def assert_shared_dir(path: str) -> None:
    """Fail fast if `path` is not on a filesystem every process can see:
    the rank-file eval merge and process-0-only checkpointing need one.
    Process 0 drops a probe file; every other process must observe it."""
    probe = os.path.join(path, ".hupr_shared_fs_probe")
    if process_index() == 0:
        os.makedirs(path, exist_ok=True)
        with open(probe, "w") as fp:
            fp.write("probe")
    barrier("shared_fs_probe_written")
    # every process publishes what it saw before anyone raises: a lone
    # process raising between two barriers would leave the rest waiting
    visible = [v == 1.0 for v in allgather_scalar(
        1.0 if os.path.exists(probe) else 0.0)]
    if process_index() == 0:
        os.remove(probe)     # every verdict was published before this read
    if not all(visible):
        bad = [i for i, v in enumerate(visible) if not v]
        raise RuntimeError(
            f"multi-host runs need a shared output/data filesystem: "
            f"process(es) {bad} cannot see {probe} written by process 0")


def local_row_range(padded_rows: int) -> tuple:
    """This process's contiguous slice [lo, hi) of a padded global batch:
    process p owns the p-th block of rows. `padded_rows` must divide by
    the process count."""
    n = process_count()
    rows = padded_rows // n
    lo = process_index() * rows
    return lo, lo + rows


def local_row_mask(padded_rows: int, true_rows: int) -> np.ndarray:
    """The loss and BN mask of this process's rows of a padded global
    batch: 1.0 for a real row, 0.0 for padding."""
    lo, hi = local_row_range(padded_rows)
    return (np.arange(lo, hi) < true_rows).astype(np.float32)


def global_shard_batch(local_batch: dict, mesh, padded_rows: int,
                       true_rows: int) -> tuple:
    """Multi-process counterpart of parallel.mesh.shard_batch:
    `local_batch` holds ONLY this process's rows (local_row_range of the
    padded global batch); adds the global loss / BN "mask" of those rows.
    The leaves go to `mesh.device` (they stay on the host with mesh None).
    Returns (batch, true_rows)."""
    out = {k: torch.as_tensor(v) for k, v in local_batch.items()}
    out["mask"] = torch.from_numpy(local_row_mask(padded_rows, true_rows))
    if mesh is not None:
        out = {k: v.to(mesh.device) for k, v in out.items()}
    return out, true_rows


def replicate_tree(tensors, mesh) -> None:
    """Process 0's values of `tensors` (a list), written into every
    process's tensors in place: one broadcast per dtype of the flattened
    tensors, on `mesh.device`. Every process must pass tensors of the same
    shapes and dtypes in the same order."""
    if process_count() == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device)
                          for t in group])
        profiling.count("hupr.collectives")
        dist.broadcast(flat, src=0)
        offset = 0
        with torch.no_grad():
            for t in group:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view(t.shape))
                offset += n


def _next_id(tag: str) -> str:
    """Store keys are single-use: suffix a per-tag sequence number. SPMD
    call order keeps it identical across processes."""
    n = _seq.get(tag, 0)
    _seq[tag] = n + 1
    return f"{tag}/{n}"


def _publish_and_read(tag: str, value: str, sources) -> list:
    """Set this process's `value` under a fresh key of `tag` (only if it
    is among `sources`), then read the value of every process in
    `sources`, waiting up to _SYNC_TIMEOUT_S for each."""
    store = dist.distributed_c10d._get_default_store()
    key = _next_id(tag)
    me = process_index()
    if me in sources:
        store.set(f"{key}/{me}", value)
    keys = [f"{key}/{p}" for p in sources]
    store.wait(keys, datetime.timedelta(seconds=_SYNC_TIMEOUT_S))
    return [store.get(k).decode() for k in keys]


def barrier(tag: str) -> None:
    """Every process waits here for every other (no-op in one process)."""
    if process_count() > 1:
        _publish_and_read(f"hupr_b/{tag}", "1", range(process_count()))


def broadcast_scalar(value: float) -> float:
    """Process 0's value, on every process."""
    if process_count() == 1:
        return float(value)
    return float(_publish_and_read("hupr_kv/bcast", repr(float(value)),
                                   [0])[0])


def allgather_scalar(value: float) -> list:
    """Every process's value, in process order, through the store: every
    process sees the same list, so an agreement check raises on all of
    them together."""
    if process_count() == 1:
        return [float(value)]
    return [float(v) for v in _publish_and_read(
        "hupr_kv/ag", repr(float(value)), range(process_count()))]


def assert_agreement(tag: str, value: float) -> None:
    """Fail fast, on every process together, if `value` differs across
    processes, naming the per-process values."""
    if process_count() == 1:
        return
    vals = allgather_scalar(float(value))
    if any(v != vals[0] for v in vals):
        raise RuntimeError(
            f"multi-host disagreement on {tag}: per-process values "
            f"{vals} — all hosts must see the same data/config")


def warmup_device_collectives(mesh) -> None:
    """One all_reduce on the mesh's device right after init, while the
    processes are in step: NCCL builds its communicator at the first
    collective, and the train step's collectives reuse it. Raises unless
    the sum is the process count. No-op without a process group."""
    if not is_initialized():
        return
    barrier("collective_warmup")
    x = torch.ones(1, device=mesh.device)
    profiling.count("hupr.collectives")
    dist.all_reduce(x)
    if x.item() != process_count():
        raise RuntimeError(f"collective warm-up summed {x.item()} over "
                           f"{process_count()} processes")


def rank_result_path(out_dir: str, phase: str,
                     pid: Optional[int] = None) -> str:
    pid = process_index() if pid is None else pid
    return os.path.join(out_dir, f"{phase}_results.rank{pid}.json")


def merge_rank_results(out_dir: str, phase: str, final_path: str) -> None:
    """Process 0: concatenate every rank's keypoint blocks in image_id
    order (the evaluator does not care, the file does), write the results
    JSON, and remove the rank files."""
    blocks = []
    for pid in range(process_count()):
        path = rank_result_path(out_dir, phase, pid)
        with open(path) as fp:
            blocks.extend(json.load(fp))
        os.remove(path)
    blocks.sort(key=lambda b: b["image_id"])
    with open(final_path, "w") as fp:
        json.dump(blocks, fp)
