"""Sequence-mode evaluation: window assembly on the card for the eval loop
(counterpart of `hupr_tpu/engine/seq_eval.py`).

The classic eval path (the reference's tools/run.py:35-63 over a
DataLoader) has the host assemble a (G, C, 2, R, A, E) window per sample:
33.6 MB of copies and host-to-device traffic per frame, G-1 of G of it
redundant, because adjacent windows share G-1 of G frames.

Sequence mode ships each frame once, as its four raw chirp planes (4 MB),
and does the rest on the card, as serving does (engine/pipeline.py): the
per-plane normalize and the MNet chirp encoding run once per frame, the
encoded (R, A, F) maps are replicate-padded and sliced into windows, and
pose decoding and the loss run per TEST.batchSize window batch. Its
outputs are the eval step's dict, batch for batch, so the Runner consumes
both paths alike, and they equal the classic path's
(tests/test_torch_runner.py holds them together).

Applicable (the Runner falls back to the classic loader otherwise) when:
  * sampling_ratio == 1 (every frame, in order: the benchmark's setting)
  * lossDecay == -1 (annealing advances per computeLoss call, and the two
    paths make different numbers of calls when sequences do not divide
    the batch)
  * every sequence of the split has exactly DATASET.duration frames (the
    reference's clamp, `index % duration`, defines in-range windows only
    then).

Raw-ADC sequence eval (TEST.sequenceSource: adc) is not ported (ROADMAP
A4): the Runner raises on it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch

from hupr_tpu_torch.engine.pipeline import replicate_pad
from hupr_tpu_torch.ops.heatmap import (bce_loss, generate_target_batch,
                                        get_max_preds)
from hupr_tpu_torch.ops.normalize import normalize_radar_window
from hupr_tpu_torch.utils.device import float32_math
from hupr_tpu_torch.utils.prefetch import stop_aware_put
from hupr_tpu_torch.utils.transfer import cast_for_transfer, transfer_dtype


def sequence_groups(image_ids: List[int]) -> List[Tuple[int, int]]:
    """Split the dataset's image_id list (frame + seq*100000, annot.py) into
    contiguous per-sequence (start, length) runs, preserving order."""
    groups = []
    start = 0
    for i in range(1, len(image_ids) + 1):
        if i == len(image_ids) or image_ids[i] // 100000 != \
                image_ids[start] // 100000:
            groups.append((start, i - start))
            start = i
    return groups


def make_sequence_encoder(model, group: int):
    """encode(hre, him, vre, vim, pad_to) -> (ra_pad, re_pad).

    Inputs are one sequence's per-frame chirp planes, (F, C, R, A, E) per
    component and view, on the model's device in the wire dtype. Outputs
    are the chirp-encoded maps (pad_to + G - 1, R, A, Fc) per view,
    replicate-padded for window slicing: frames past F repeat the last
    frame, so that the last window batch is whole (its extra windows are
    masked out of the loss and dropped by the caller)."""

    def prep(re, im):
        x = torch.stack([re, im], dim=2)             # (F, C, 2, R, A, E)
        return normalize_radar_window(x.to(torch.float32))[:, None]

    def encode(hre, him, vre, vim, pad_to: int):
        ra, re_m = model.chirp_maps(prep(hre, him), prep(vre, vim))
        ra, re_m = ra[:, 0], re_m[:, 0]              # (F, R, A, Fc)
        return (replicate_pad(ra, group, pad_to),
                replicate_pad(re_m, group, pad_to))

    return encode


def make_window_eval_step(model, group: int, geometry=(14, 64, 256),
                          batch_size: int = 32):
    """step(ra_pad, re_pad, joints, mask, start) -> the eval step's dict
    for the `batch_size` consecutive windows that begin at frame `start`
    (engine/steps.make_eval_step's outputs, lossDecay == -1)."""
    num_keypoints, heatmap_size, img_size = geometry

    def windows(maps_pad, start):
        raw = maps_pad[start:start + batch_size + group - 1]
        # window b = padded frames [b, b + G): pipeline.window_stack's
        # slices, from an offset
        return torch.stack([raw[j:j + batch_size] for j in range(group)],
                           dim=1)                    # (B, G, R, A, Fc)

    def step(ra_pad, re_pad, joints, mask, start: int):
        heatmap, gcn = model.pose_from_maps(windows(ra_pad, start),
                                            windows(re_pad, start))
        targets, _ = generate_target_batch(
            joints, num_keypoints=num_keypoints, heatmap_size=heatmap_size,
            img_size=img_size)
        k, h = targets.shape[1], targets.shape[2]
        main = heatmap.reshape(-1, k, h, h)
        refined = gcn.reshape(-1, k, h, h)
        loss1 = bce_loss(main, targets, mask)
        loss2 = bce_loss(refined, targets, mask)
        pred2d, maxvals = get_max_preds(refined)
        gt_dec, _ = get_max_preds(targets)
        return {"loss": loss1 + loss2, "loss1": loss1, "loss2": loss2,
                "pred2d": pred2d, "gt2d": gt_dec, "maxvals": maxvals,
                "predHeatmap": refined}

    return step


class SequenceEvaluator:
    """Drives eval over per-sequence frame planes, windowed on the card.

    eval_batches(dataset) yields (out, image_ids, bbox, true_b) tuples
    equal to the classic device_prefetch + eval_step loop's, from the
    model's current weights. Each call runs in eval mode, under
    torch.inference_mode and float32_math (TF32 off)."""

    def __init__(self, model, cfg):
        d = cfg.DATASET
        self.model = model
        self.device = next(model.parameters()).device
        self.transfer_dtype = transfer_dtype(
            getattr(cfg.SETUP, "transferDtype", "float32"))
        self.group = d.numGroupFrames
        self.batch_size = cfg.TEST.batchSize
        self.geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        self._encode = make_sequence_encoder(model, self.group)
        self._step = make_window_eval_step(model, self.group, self.geometry,
                                           self.batch_size)

    @staticmethod
    def applicable(dataset, cfg) -> bool:
        if dataset.sampling_ratio != 1:
            return False
        if cfg.TRAINING.lossDecay != -1:
            return False
        # the reference clamp (index % duration) only defines in-range
        # windows for full-duration sequences; shorter ones send the global
        # window table past the end of the data in both paths
        groups = sequence_groups(dataset.image_ids)
        return all(n == dataset.duration for _, n in groups)

    def _load_planes(self, dataset, start: int, length: int):
        """Host side: one sequence's per-frame (C, R, A, E) cube planes,
        [hre, him, vre, vim], in the wire dtype; pinned when the card
        takes them."""
        idx = range(start, start + length)
        out = []
        for paths in (dataset.paths_hori, dataset.paths_vert):
            frames = dataset._frames([paths[i] for i in idx])
            for c in (0, 1):
                p = torch.as_tensor(cast_for_transfer(
                    np.stack([f[c] for f in frames]), self.transfer_dtype))
                out.append(p.pin_memory() if self.device.type == "cuda"
                           else p)
        return out

    def _call(self, fn, *args):
        """fn(*args) in eval mode, inference mode and full float32."""
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode(), float32_math():
                return fn(*args)
        finally:
            self.model.train(was_training)

    def eval_batches(self, dataset) -> Iterator[tuple]:
        groups = sequence_groups(dataset.image_ids)
        stop = threading.Event()

        # one-sequence lookahead: load sequence s+1 while the card works
        # on s. Puts are stop-aware, so an abandoned generator releases the
        # thread (and its planes) instead of pinning them forever.
        def put(q, item) -> bool:
            return stop_aware_put(q, item, stop)

        def producer(q):
            try:
                for start, length in groups:
                    if not put(q, (start, length,
                                   self._load_planes(dataset, start, length))):
                        return
            except BaseException as exc:    # propagate to the consumer
                put(q, exc)
            finally:
                put(q, None)

        q: queue.Queue = queue.Queue(maxsize=1)
        threading.Thread(target=producer, args=(q,), daemon=True).start()

        dev = self.device
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                start, length, planes = item
                n_batches = -(-length // self.batch_size)
                pad_to = n_batches * self.batch_size
                planes = [p.to(dev, non_blocking=True) for p in planes]
                ra_pad, re_pad = self._call(self._encode, *planes, pad_to)
                del planes
                # the sequence's joints go to the card once, zero-padded to
                # pad_to, next to its planes: no host-to-device copy (and
                # so no wait on the card) is left inside the batch loop
                joints = np.zeros((pad_to,) + dataset.joints.shape[1:],
                                  dtype=dataset.joints.dtype)
                joints[:length] = dataset.joints[start:start + length]
                joints = torch.from_numpy(joints)
                if dev.type == "cuda":
                    joints = joints.pin_memory()
                joints = joints.to(dev, non_blocking=True)
                rows = torch.arange(self.batch_size, device=dev)
                for b in range(n_batches):
                    s = b * self.batch_size
                    true_b = min(self.batch_size, length - s)
                    mask = (rows < true_b).to(torch.float32)
                    out = self._call(self._step, ra_pad, re_pad,
                                     joints[s:s + self.batch_size], mask, s)
                    image_ids = np.asarray(
                        dataset.image_ids[start + s:start + s + true_b])
                    bbox = dataset.bboxes[start + s:start + s + true_b]
                    yield out, image_ids, bbox, true_b
        finally:
            stop.set()      # consumer finished or bailed: release producer
