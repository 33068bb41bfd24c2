"""Window assembly on the card for training, TRAINING.chunkTrain
(counterpart of `hupr_tpu/engine/chunk_train.py`).

The classic train loop (the reference's tools/run.py:65-86 over a
DataLoader) has the host assemble a (G, C, 2, R, A, E) window per sample,
33.6 MB each, although adjacent windows share G-1 of G frames
(datasets/dataset.py:126-138).

Chunk mode trains each step on B consecutive windows of one sequence. The
host ships the union of their frames once (B + G - 1 per-frame planes)
and a (B, G) gather table built from the same clamped window_indices the
classic dataset uses. On the card the per-plane normalize and the MNet
chirp encode (per frame, no BN) run once per distinct frame, `index_select`
gathers each window's encoded (R, A, F) maps, and the pose network, the
loss and the optimizer step are those of steps.make_train_step. Autograd
sums a shared frame's gradients over the windows that gather it, so the
step equals the classic step on the same window batch.

It is opt-in because it changes the training's batches, not its per-step
math: an epoch shuffles chunks, not windows, so each step sees B
consecutive, correlated windows. Applicable, as sequence-mode eval is
(engine/seq_eval.py), with sampling ratio 1, lossDecay -1 and
full-duration sequences.

Raw-ADC mode (TRAINING.chunkSource: adc) ships each frame's raw int16
DCA1000 stream slice from the capture .bin (data/adc.py) instead of cube
planes read from .npy files, and the step decodes it and runs the radar
cube DSP on the card before the encode: no .npy hop, and gradients equal
to the cube-fed step's.

Data parallel over processes (`mesh=` of more than one rank,
`ChunkTrainLoader(pad_multiple=world, process=(rank, world))`): both
shipped axes, the frames and the window rows, pad to a multiple of the
world size, and each rank holds its contiguous block of both. It encodes
its own frames through MNet, which has no BN, then every rank's encoded
maps are exchanged (parallel.mesh.gather_blocks: the all-gather GSPMD
inserts in the JAX package, differentiable, so each frame's gradient
flows back to the rank that encoded it) and each rank gathers its windows
by `rel`. The pose network then runs with BN synced over the real rows of
every rank, and the gradients are summed across ranks, as in
steps.make_train_step.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from hupr_tpu_torch.engine import steps
from hupr_tpu_torch.engine.pipeline import cube_chirp_input
from hupr_tpu_torch.models.blocks import synced_batch_stats
from hupr_tpu_torch.ops.dsp import (RadarParams, decode_dca1000,
                                    radar_cube_frames)
from hupr_tpu_torch.ops.heatmap import bce_loss, generate_target_batch
from hupr_tpu_torch.ops.normalize import normalize_radar_window
from hupr_tpu_torch.parallel.mesh import gather_blocks
from hupr_tpu_torch.utils.device import float32_math, resolve_device
from hupr_tpu_torch.utils.prefetch import stop_aware_put
from hupr_tpu_torch.utils.transfer import cast_for_transfer

# the leaves of a chunk batch that go to the card (utils/prefetch.py)
CHUNK_KEYS = ("hori", "vert", "rel", "jointsGroup", "mask")


def chunk_table(windows: np.ndarray, duration: int, batch_size: int,
                pad_rows_to: int = 0) -> list[dict]:
    """Split the dataset's (N, G) window table into per-sequence chunks of
    `batch_size` consecutive windows. One dict per chunk:
      lo        first dataset frame index the chunk's windows touch
      n_frames  number of distinct frames (contiguous: lo .. lo+n_frames-1)
      rel       (max(batch_size, pad_rows_to), G) int32 gather into the
                shipped frame stack; padded rows repeat the last real
                window's row (masked out downstream)
      row0      dataset index of the chunk's first window
      true_b    number of real (unmasked) windows
    The frames are contiguous because window_indices clamps into the
    window's own sequence, so the union of B consecutive rows is an
    interval."""
    n = windows.shape[0]
    rows_out = max(batch_size, pad_rows_to)
    chunks = []
    for seq_start in range(0, n, duration):
        seq_len = min(duration, n - seq_start)
        for s in range(0, seq_len, batch_size):
            true_b = min(batch_size, seq_len - s)
            rows = windows[seq_start + s:seq_start + s + true_b]
            lo = int(rows.min())
            hi = int(rows.max())
            rel = np.empty((rows_out, windows.shape[1]), np.int32)
            rel[:true_b] = rows - lo
            rel[true_b:] = rel[true_b - 1]
            chunks.append({"lo": lo, "n_frames": hi - lo + 1, "rel": rel,
                           "row0": seq_start + s, "true_b": true_b})
    return chunks


def cube_frame_prep(x):
    """Shipped centre-chirp cube planes (F, C, 2, R, A, E), in any float
    wire dtype -> normalized model input (F, 1, C, 2, R, A, E)."""
    return normalize_radar_window(x.to(torch.float32))[:, None]


def make_adc_frame_prep(radar_params: RadarParams | None = None,
                        num_frames: int = 8):
    """Per-frame prep of raw-ADC training and eval: raw int16 DCA1000
    stream slices (F, frame_samples) -> decode (ops/dsp.decode_dca1000) ->
    radar cube DSP -> centre-chirp slice and normalize
    (engine/pipeline.cube_chirp_input), all on the input's device."""
    rp = radar_params if radar_params is not None else RadarParams()

    def prep(x):
        cubes = radar_cube_frames(decode_dca1000(x, rp), rp)
        return cube_chirp_input(cubes.real, cubes.imag, num_frames)

    return prep


def make_chunk_train_step(model, tx: torch.optim.Optimizer,
                          geometry=(14, 64, 256), mesh=None, frame_prep=None):
    """Returns step(state, batch, lr, alpha) -> (state, metrics), as
    steps.make_train_step's (lossDecay -1 only, which chunk mode's
    applicability ensures: loss = loss1 + loss2).

    `batch` leaves, numpy or torch, on the host or the model's device:
      hori, vert    per-frame payloads for `frame_prep`: cube planes
                    (F, C, 2, R, A, E) by default, raw int16 ADC stream
                    slices (F, S) with make_adc_frame_prep
      rel           (B, G) gather into the frame axis
      jointsGroup   (B, K, 2)
      mask          (B,) 1.0 for a real window row, 0.0 for a padded one
      trueB         optional: the number of real rows. ChunkTrainLoader
                    pads at the tail, so with it the step keeps rows
                    [0, trueB) and reads nothing back from the card;
                    without it the mask is read as make_train_step reads
                    it.
    The padded rows are dropped before the pose network: the JAX package
    keeps them out of BN and the loss with the mask, which for a 0/1 mask
    is the same. The step runs in train mode, in the model's compute dtype
    and in full float32 elsewhere (TF32 off for the call).

    With a `mesh` of more than one rank the leaves are this rank's blocks
    of the padded frame and row axes (ChunkTrainLoader process mode), `rel`
    indexes the global frame axis, and every window row runs under its
    mask: the encoded maps are exchanged across ranks, BN is synced and
    the loss is divided by the global real count, and the gradients and
    metrics are summed across ranks (module docstring)."""
    dp = steps._data_parallel(mesh)
    num_keypoints, heatmap_size, img_size = geometry
    encode_frames = frame_prep if frame_prep is not None else cube_frame_prep

    def step(state: steps.TrainState, batch, lr, alpha):
        del alpha  # annealing is gated off (lossDecay == -1) in chunk mode
        if state.model is not model or state.optimizer is not tx:
            raise ValueError("state holds another model or optimizer than "
                             "this train step was made for")
        device = next(model.parameters()).device

        def on(key):
            return torch.as_tensor(batch[key], device=device)

        rel, joints = on("rel").to(torch.int64), on("jointsGroup")
        mask = count = None
        if dp:
            mask = on("mask").reshape(-1).to(torch.float32)
            count = steps._global_count(mask)
        else:
            true_b = batch.get("trueB")
            rows = slice(0, int(true_b)) if true_b is not None \
                else steps._real_rows(on("mask").reshape(-1))
            rel, joints = rel[rows], joints[rows]
        for group in tx.param_groups:
            group["lr"] = lr
        was_training = model.training
        model.train()
        try:
            with float32_math():
                ra, re = model.chirp_maps(encode_frames(on("hori")),
                                          encode_frames(on("vert")))
                ra, re = ra[:, 0], re[:, 0]             # (F, R, A, Fc)
                if dp:
                    # every rank's frames, in rank order: one exchange
                    ra, re = gather_blocks(torch.stack([ra, re], 1),
                                           mesh).unbind(1)
                # window b = encoded frames rel[b, :]: the clamped
                # reference window, gathered on the card
                idx = rel.reshape(-1)
                ra_w = ra.index_select(0, idx).reshape(*rel.shape,
                                                       *ra.shape[1:])
                re_w = re.index_select(0, idx).reshape(*rel.shape,
                                                       *re.shape[1:])
                with synced_batch_stats(mask):
                    heatmap, gcn = model.pose_from_maps(ra_w, re_w)
                targets, _ = generate_target_batch(
                    joints, num_keypoints=num_keypoints,
                    heatmap_size=heatmap_size, img_size=img_size)
                k, h = targets.shape[1], targets.shape[2]
                loss1 = bce_loss(heatmap.reshape(-1, k, h, h), targets,
                                 mask, count)
                loss2 = bce_loss(gcn.reshape(-1, k, h, h), targets, mask,
                                 count)
                loss = loss1 + loss2
                tx.zero_grad(set_to_none=True)
                loss.backward()
                if dp:
                    loss1, loss2, loss = steps._reduce_gradients(
                        model, (loss1, loss2, loss))
                tx.step()
        finally:
            model.train(was_training)
        state.step += 1
        return state, {"loss": loss.detach(), "loss1": loss1.detach(),
                       "loss2": loss2.detach()}

    return step


def make_adc_chunk_train_step(model, tx, geometry=(14, 64, 256), mesh=None,
                              radar_params=None, num_frames: int = 8):
    """The chunk train step over raw int16 ADC stream slices
    (TRAINING.chunkSource: adc): decode, DSP, normalize, encode, window
    gather, loss and the optimizer step on the card. Its gradients equal
    the cube-fed chunk step's on the same windows: the DSP reads data, not
    weights."""
    return make_chunk_train_step(
        model, tx, geometry, mesh=mesh,
        frame_prep=make_adc_frame_prep(radar_params, num_frames))


class ChunkTrainLoader:
    """Chunk batches over a HuPRDataset: ready-to-step dicts (frame planes,
    gather table, joints, mask, trueB, imageId), chunks shuffled with the
    (seed, epoch)-keyed rng of data.BatchLoader, so epochs repeat from a
    seed and equal the JAX package's. A background thread assembles up to
    `prefetch` chunks ahead of the step.

    `transfer_dtype` (a torch dtype, SETUP.transferDtype via
    utils/transfer.py) is the frame planes' wire format."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True, prefetch: int = 2,
                 pad_multiple: int = 1,
                 transfer_dtype: torch.dtype = torch.float32, process=None):
        """`pad_multiple`: the world size. Both shipped axes (the frame
        stack, the window rows) pad up to a multiple of it.
        `process=(rank, world)`: this process assembles only its
        contiguous block of both padded axes; every process derives the
        same (seed, epoch)-keyed chunk order."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.transfer_dtype = transfer_dtype
        self.group = dataset.num_group_frames
        self.seed = seed
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.process = process
        self._epoch = 0
        m = max(1, int(pad_multiple))
        self.rows_pad = batch_size + (-batch_size) % m
        self.chunks = chunk_table(dataset.windows, dataset.duration,
                                  batch_size, pad_rows_to=self.rows_pad)
        f = batch_size + self.group - 1
        self.f_pad = f + (-f) % m
        if process is not None:
            nproc = process[1]
            if self.rows_pad % nproc or self.f_pad % nproc:
                raise ValueError(
                    f"process mode needs the padded axes (rows {self.rows_pad}"
                    f", frames {self.f_pad}) divisible by nproc={nproc}; "
                    f"pass pad_multiple = the world size")

    @staticmethod
    def applicable(dataset, cfg) -> bool:
        from hupr_tpu_torch.engine.seq_eval import sequence_groups
        if dataset.sampling_ratio != 1:
            return False
        if cfg.TRAINING.lossDecay != -1:
            return False
        groups = sequence_groups(dataset.image_ids)
        return all(n == dataset.duration for _, n in groups)

    def __len__(self) -> int:
        return len(self.chunks)

    def _block(self, padded: int) -> tuple:
        """This process's contiguous index block [lo, hi) of a padded
        global axis (the whole axis in one process)."""
        if self.process is None:
            return 0, padded
        pid, nproc = self.process
        blk = padded // nproc
        return pid * blk, (pid + 1) * blk

    def _window_rows(self, chunk: dict) -> dict:
        """The window-axis leaves of one batch, this process's row block:
        global rows past true_b repeat the last real window, mask 0."""
        ds = self.dataset
        true_b, row0 = chunk["true_b"], chunk["row0"]
        r_lo, r_hi = self._block(self.rows_pad)
        joints = np.stack([ds.joints[row0 + min(r, true_b - 1)]
                           for r in range(r_lo, r_hi)])
        mask = (np.arange(r_lo, r_hi) < true_b).astype(np.float32)
        return dict(rel=chunk["rel"][r_lo:r_hi], jointsGroup=joints,
                    mask=mask, trueB=true_b, fPad=self.f_pad,
                    rowsPad=self.rows_pad,
                    imageId=np.asarray(ds.image_ids[row0:row0 + true_b]))

    def _assemble(self, chunk: dict) -> dict:
        """One copy of each distinct frame into this process's block of
        the (F_pad, C, 2, R, A, E) stacks; pad frames repeat the last real
        frame (never gathered, but they must stay finite: a zero gradient
        through a NaN activation is still NaN)."""
        ds = self.dataset
        nf = chunk["n_frames"]
        f_lo, f_hi = self._block(self.f_pad)
        # global frame g holds dataset frame lo + min(g, nf - 1)
        idx = [chunk["lo"] + min(g, nf - 1) for g in range(f_lo, f_hi)]
        shape = (f_hi - f_lo, ds.num_frames, 2) + ds._inner_shape
        out = {}
        for key, paths in (("hori", ds.paths_hori), ("vert", ds.paths_vert)):
            frames = ds._frames([paths[i] for i in idx])
            arr = np.empty(shape, np.float32)
            for g, (re, im) in enumerate(frames):
                arr[g, :, 0] = re
                arr[g, :, 1] = im
            out[key] = cast_for_transfer(arr, self.transfer_dtype)
        out.update(self._window_rows(chunk))
        return out

    def _order(self) -> list[int]:
        order = np.arange(len(self.chunks))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        self._epoch += 1
        return [int(i) for i in order]

    def __iter__(self) -> Iterator[dict]:
        import queue
        import threading

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        failure: list = []
        stop = threading.Event()

        def worker():
            try:
                for i in self._order():
                    if not stop_aware_put(q, self._assemble(self.chunks[i]),
                                          stop):
                        return
            except BaseException as exc:
                failure.append(exc)
            finally:
                stop_aware_put(q, done, stop)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()


class ADCChunkLoader(ChunkTrainLoader):
    """ChunkTrainLoader over raw capture .bin files (data/adc.py): ships
    each chunk's frames as int16 DCA1000 stream slices and never reads the
    .npy cubes. SETUP.transferDtype does not apply."""

    def __init__(self, dataset, batch_size: int, adc_source, seed: int = 0,
                 shuffle: bool = True, prefetch: int = 2,
                 pad_multiple: int = 1, process=None):
        super().__init__(dataset, batch_size, seed=seed, shuffle=shuffle,
                         prefetch=prefetch, pad_multiple=pad_multiple,
                         process=process)
        self.adc = adc_source

    @staticmethod
    def applicable(dataset, cfg, adc_source=None) -> bool:
        if not ChunkTrainLoader.applicable(dataset, cfg):
            return False
        return adc_source is not None and \
            adc_source.available(dataset.image_ids)

    def _assemble(self, chunk: dict) -> dict:
        ids = self.dataset.image_ids
        nf = chunk["n_frames"]
        f_lo, f_hi = self._block(self.f_pad)
        real_n = max(0, min(f_hi, nf) - f_lo)   # real frames in the block
        out = {}
        for view in ("hori", "vert"):
            arr = np.empty((f_hi - f_lo, self.adc.frame_samples), np.int16)
            if real_n > 0:
                self.adc.read_frames(ids, chunk["lo"] + f_lo, real_n, view,
                                     arr)
                arr[real_n:] = arr[real_n - 1]   # clamp rows repeat the last
            else:
                # the whole block is clamp rows (a short chunk's tail)
                self.adc.read_frames(ids, chunk["lo"] + nf - 1, 1, view,
                                     arr[:1])
                arr[1:] = arr[0]
            out[view] = arr
        out.update(self._window_rows(chunk))
        return out


def device_put_chunk(batch: dict, device=None, mesh=None) -> tuple[dict, int]:
    """One assembled chunk batch on the card (or `device`, or
    `mesh.device`): its CHUNK_KEYS leaves as tensors, rel as int64, and
    trueB. In a multi-process run the leaves are this process's blocks
    (ChunkTrainLoader process mode) and stay so. Returns (device_batch,
    true_b)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    true_b = int(batch["trueB"])
    out = {k: torch.as_tensor(batch[k], device=dev) for k in CHUNK_KEYS}
    out["rel"] = out["rel"].to(torch.int64)
    out["trueB"] = true_b
    return out, true_b
