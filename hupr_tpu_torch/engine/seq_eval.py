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

Raw-ADC mode (TEST.sequenceSource: adc) ships each frame's raw int16
DCA1000 capture slice (768 KiB) instead of its cube planes, and the encode
decodes it and runs the radar cube DSP on the card first
(chunk_train.make_adc_frame_prep): evaluation straight from the sensor's
.bin files, with no offline .npy hop. Its results equal the cube-fed
path's on cubes the same DSP wrote (tests/test_torch_chunk.py).

With a mesh (parallel.mesh.Mesh) of more than one rank, one sequence is
split over the ranks, as the JAX package splits it over a device mesh:
each rank loads and encodes only its block of the sequence's frames
(parallel/halo.frame_block), the encoded maps are gathered to every rank,
each rank runs its TEST.batchSize / world windows of every batch, and the
losses are the global masked means and the outputs the whole batch's, so
that every rank yields what the unsharded evaluator yields. It shards
only when the world size divides both DATASET.duration and TEST.batchSize
and runs unsharded otherwise. The Runner passes no mesh: it splits eval by
whole sequences over its processes (engine/runner.py), as the JAX
package's multi-process Runner does, and with one card a process there is
no second device in a process to split a sequence over.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np
import torch

from hupr_tpu_torch.engine.chunk_train import (cube_frame_prep,
                                               make_adc_frame_prep)
from hupr_tpu_torch.engine.pipeline import replicate_pad
from hupr_tpu_torch.ops.heatmap import (bce_loss, generate_target_batch,
                                        get_max_preds)
from hupr_tpu_torch.parallel.halo import frame_block
from hupr_tpu_torch.parallel.mesh import all_reduce_sum, gather_blocks
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


def _planes_prep(planes):
    """A view's (re, im) chirp planes, (F, C, R, A, E) each in the wire
    dtype -> normalized model input (F, 1, C, 2, R, A, E)."""
    return cube_frame_prep(torch.stack(planes, dim=2))


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.parallel


def make_sequence_encoder(model, group: int, frame_prep=_planes_prep,
                          mesh=None):
    """encode(hori, vert, pad_to) -> (ra_pad, re_pad).

    Inputs are one sequence's per-view payloads for `frame_prep`, on the
    model's device: by default its (re, im) chirp planes, (F, C, R, A, E)
    each in the wire dtype; with make_adc_frame_prep its raw int16
    DCA1000 stream slices (F, frame_samples). Outputs are the
    chirp-encoded maps (pad_to + G - 1, R, A, Fc) per view,
    replicate-padded for window slicing: frames past F repeat the last
    frame, so that the last window batch is whole (its extra windows are
    masked out of the loss and dropped by the caller).

    With `mesh` of more than one rank, the payloads are this rank's frame
    block of the sequence (parallel/halo.frame_block) and the encoded
    maps are gathered from every rank before the padding: every rank
    returns the whole sequence's."""
    sharded = _sharded(mesh)

    def encode(hori, vert, pad_to: int):
        ra, re_m = model.chirp_maps(frame_prep(hori), frame_prep(vert))
        ra, re_m = ra[:, 0], re_m[:, 0]              # (F, R, A, Fc)
        if sharded:
            ra, re_m = gather_blocks(ra, mesh), gather_blocks(re_m, mesh)
        return (replicate_pad(ra, group, pad_to),
                replicate_pad(re_m, group, pad_to))

    return encode


def make_adc_sequence_encoder(model, group: int, radar_params=None,
                              num_frames: int = 8, mesh=None):
    """make_sequence_encoder on raw int16 DCA1000 stream slices: decode,
    radar cube DSP, normalize and the MNet chirp encode on the card."""
    return make_sequence_encoder(
        model, group, make_adc_frame_prep(radar_params, num_frames), mesh)


def make_window_eval_step(model, group: int, geometry=(14, 64, 256),
                          batch_size: int = 32, mesh=None):
    """step(ra_pad, re_pad, joints, mask, start) -> the eval step's dict
    for the `batch_size` consecutive windows that begin at frame `start`
    (engine/steps.make_eval_step's outputs, lossDecay == -1).

    With `mesh` of more than one rank (the world size dividing
    `batch_size`), each rank runs its block of batch_size / world
    windows, `joints` and `mask` being that block's rows: loss1 and loss2
    are the global masked means (each rank's masked sum over the global
    real count, summed over the ranks) and pred2d, gt2d, maxvals and
    predHeatmap the whole batch's, on every rank."""
    num_keypoints, heatmap_size, img_size = geometry
    sharded = _sharded(mesh)
    first, last = frame_block(batch_size, mesh) if sharded \
        else (0, batch_size)
    rows = last - first

    def windows(maps_pad, start):
        raw = maps_pad[start + first:start + first + rows + group - 1]
        # window b = padded frames [b, b + G): pipeline.window_stack's
        # slices, from an offset
        return torch.stack([raw[j:j + rows] for j in range(group)],
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
        count = all_reduce_sum(mask.to(torch.float32).sum()) \
            if sharded else None
        loss1 = bce_loss(main, targets, mask, count)
        loss2 = bce_loss(refined, targets, mask, count)
        pred2d, maxvals = get_max_preds(refined)
        gt_dec, _ = get_max_preds(targets)
        out = {"pred2d": pred2d, "gt2d": gt_dec, "maxvals": maxvals,
               "predHeatmap": refined}
        if sharded:
            loss1, loss2 = all_reduce_sum(torch.stack([loss1, loss2]))
            out = {k: gather_blocks(v, mesh) for k, v in out.items()}
        return {"loss": loss1 + loss2, "loss1": loss1, "loss2": loss2,
                **out}

    return step


class SequenceEvaluator:
    """Drives eval over per-sequence frame planes, windowed on the card.

    eval_batches(dataset) yields (out, image_ids, bbox, true_b) tuples
    equal to the classic device_prefetch + eval_step loop's, from the
    model's current weights. Each call runs in eval mode, under
    torch.inference_mode and float32_math (TF32 off). With `adc_source`
    (a data.adc.ADCFrameSource; TEST.sequenceSource: adc) it reads raw
    int16 capture slices instead of .npy cubes. With `mesh` (every rank
    calling eval_batches alike) each sequence is split over the ranks
    when the world size divides both DATASET.duration and TEST.batchSize
    (the module's docstring), and runs unsharded otherwise."""

    def __init__(self, model, cfg, adc_source=None, mesh=None):
        d = cfg.DATASET
        self.model = model
        self.device = next(model.parameters()).device
        self.transfer_dtype = transfer_dtype(
            getattr(cfg.SETUP, "transferDtype", "float32"))
        self.group = d.numGroupFrames
        self.batch_size = cfg.TEST.batchSize
        self.geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        self.adc = adc_source
        # all or nothing, as the JAX package's gate: the encode's frame
        # blocks and the step's window blocks both split evenly
        world = mesh.world if mesh is not None else 1
        if not (world > 1 and d.duration % world == 0
                and self.batch_size % world == 0):
            mesh = None
        self.mesh = mesh
        if adc_source is not None:
            self._encode = make_adc_sequence_encoder(
                model, self.group, d.radar_params(), d.numFrames, mesh)
        else:
            self._encode = make_sequence_encoder(model, self.group,
                                                 mesh=mesh)
        self._step = make_window_eval_step(model, self.group, self.geometry,
                                           self.batch_size, mesh)

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

    @staticmethod
    def adc_applicable(dataset, cfg, adc_source) -> bool:
        """Raw-ADC eval also needs the capture .bin files to cover the
        split (ADCChunkLoader.applicable's gate)."""
        if not SequenceEvaluator.applicable(dataset, cfg):
            return False
        return adc_source is not None and \
            adc_source.available(dataset.image_ids)

    def _load_planes(self, dataset, start: int, length: int):
        """Host side: one sequence's payload, pinned when the card takes
        it. In raw-ADC mode its int16 capture slices [hori, vert], each
        (F, frame_samples); else its per-frame (C, R, A, E) cube planes
        [hre, him, vre, vim] in the wire dtype."""
        out = []
        if self.adc is not None:
            for view in ("hori", "vert"):
                arr = np.empty((length, self.adc.frame_samples), np.int16)
                self.adc.read_frames(dataset.image_ids, start, length,
                                     view, arr)
                out.append(torch.from_numpy(arr))
        else:
            idx = range(start, start + length)
            for paths in (dataset.paths_hori, dataset.paths_vert):
                frames = dataset._frames([paths[i] for i in idx])
                for c in (0, 1):
                    out.append(torch.as_tensor(cast_for_transfer(
                        np.stack([f[c] for f in frames]),
                        self.transfer_dtype)))
        if self.device.type == "cuda":
            out = [p.pin_memory() for p in out]
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

    def eval_batches(self, dataset, groups=None) -> Iterator[tuple]:
        """Yields (out, image_ids, bbox, true_b) per window batch of every
        sequence, in order. `groups`: a subset of
        sequence_groups(dataset.image_ids)'s (start, length) runs to
        evaluate instead of all of them (a multi-process eval hands each
        process its own share)."""
        if groups is None:
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
                    lo, hi = (frame_block(length, self.mesh)
                              if self.mesh is not None else (0, length))
                    if not put(q, (start, length, self._load_planes(
                            dataset, start + lo, hi - lo))):
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
                views = planes if self.adc is not None \
                    else (planes[:2], planes[2:])
                ra_pad, re_pad = self._call(self._encode, *views, pad_to)
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
                # this rank's block of each batch's rows (all of it
                # unsharded)
                first, last = (frame_block(self.batch_size, self.mesh)
                               if self.mesh is not None
                               else (0, self.batch_size))
                row_ids = torch.arange(first, last, device=dev)
                for b in range(n_batches):
                    s = b * self.batch_size
                    true_b = min(self.batch_size, length - s)
                    mask = (row_ids < true_b).to(torch.float32)
                    out = self._call(self._step, ra_pad, re_pad,
                                     joints[s + first:s + last], mask, s)
                    image_ids = np.asarray(
                        dataset.image_ids[start + s:start + s + true_b])
                    bbox = dataset.bboxes[start + s:start + s + true_b]
                    yield out, image_ids, bbox, true_b
        finally:
            stop.set()      # consumer finished or bailed: release producer
