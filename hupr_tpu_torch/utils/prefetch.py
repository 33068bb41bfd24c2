"""Host-to-device staging for the Runner's loops (counterpart of
`hupr_tpu/utils/prefetch.py` and of `device_prefetch` in
`hupr_tpu/parallel/mesh.py`, on one card).

  stop_aware_put  a bounded put that gives up when the consumer has gone,
                  so an abandoned producer thread is released
  device_prefetch batch i+1's host-to-device copy runs on a side stream
                  while batch i's step runs on the compute stream
  PendingFetch    copies of a step's outputs to the host, started now and
                  read one step later, so that reading them does not wait
                  for work queued after them
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Optional

import numpy as np
import torch


def stop_aware_put(q: "queue.Queue", item, stop: threading.Event,
                   poll: float = 0.1) -> bool:
    """Bounded put that aborts when `stop` is set (the consumer went away).
    Returns False if aborted, True once the item is enqueued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=poll)
            return True
        except queue.Full:
            continue
    return False


def _pad_rows(arr, target: int):
    """Pad the batch axis to `target` rows by repeating the last sample,
    as the JAX package's shard_batch does (the padded rows are masked out
    of the loss and BN statistics and dropped by the caller)."""
    rem = target - arr.shape[0]
    if rem == 0:
        return arr
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(rem, *arr.shape[1:])])
    return np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)])


def device_prefetch(batch_iter: Iterable[dict], device,
                    pad_to: Optional[int] = None,
                    keys=("hori", "vert", "jointsGroup")):
    """Yields (device_batch, host_batch, true_b) for each host batch of
    `batch_iter` (numpy arrays, or torch tensors for half-width planes).

    A batch shorter than `pad_to` is padded to it by repeating its last
    sample and carries a 0/1 'mask' of its real rows; a full batch carries
    no mask (the steps read none as all rows real, and the train step
    would otherwise read the mask back from the card every step). On the
    card each batch is pinned and copied with non_blocking on a side
    stream, and the compute stream waits for the copy before it uses the
    batch. A batch is staged when the consumer asks for it, which is after
    it has queued the previous batch's step: the copy then runs while that
    step does, and the first step waits for one batch, not two (the JAX
    package stages one ahead because its device_put never blocks the host,
    where pinning here is a host copy)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def stage(batch):
        if "trueRows" in batch:
            raise NotImplementedError(
                "process-sliced batches (multi-host) are not ported: "
                "ROADMAP A9")
        true_b = batch[keys[0]].shape[0]
        target = max(true_b, pad_to or 0)
        host = {k: torch.as_tensor(_pad_rows(batch[k], target))
                for k in keys}
        if target > true_b:
            host["mask"] = torch.from_numpy(
                (np.arange(target) < true_b).astype(np.float32))
        if not cuda:
            return {k: v.to(device) for k, v in host.items()}, None, true_b
        with torch.cuda.stream(copy_stream):
            dev = {k: v.pin_memory().to(device, non_blocking=True)
                   for k, v in host.items()}
        done = torch.cuda.Event()
        done.record(copy_stream)
        return dev, done, true_b

    def ready(dev, done):
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for t in dev.values():
                t.record_stream(compute)
        return dev

    for batch in batch_iter:
        dev, done, true_b = stage(batch)
        yield ready(dev, done), batch, true_b


class PendingFetch:
    """Host copies of a dict of tensors, started when made and read by
    `get()`. On the card the copies go into pinned memory with non_blocking
    behind the work that made the tensors, and `get()` waits for them
    alone: a plain `.cpu()` one step later would also wait for the step
    queued in between."""

    def __init__(self, tensors: dict):
        self._done = None
        self._host = {}
        for k, t in tensors.items():
            t = t.detach()
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                if self._done is None:
                    self._done = torch.cuda.Event()
            else:
                host = t.clone()
            self._host[k] = host
        if self._done is not None:
            self._done.record()

    def get(self) -> dict:
        """The values as numpy arrays, once their copies have landed."""
        if self._done is not None:
            self._done.synchronize()
        return {k: v.numpy() for k, v in self._host.items()}
