"""HuPR sliding-window radar dataset and batched prefetching loader (a copy
of `hupr_tpu/data/dataset.py`, kept so that the port imports nothing of the
JAX package).

The batches are the JAX package's, value for value, from the same seed: the
same window table, the same seed- and epoch-keyed permutation, the same
per-row sampling stream. What differs: the wire dtype is a torch dtype
(utils/transfer.py), and the multi-host process slicing of BatchLoader is
not ported (ROADMAP A9).

Parity: HuPR3D_horivert (the reference's datasets/dataset.py).
  * Window indices (the reference's per-__getitem__ boundary-clamp loop,
    dataset.py:126-138) are precomputed once into an (N, G) gather table.
  * The per-chirp Normalize runs on the card over the whole batch
    (ops/normalize.py) instead of per slice in DataLoader workers.
  * .npy frames are memory-mapped and only the center numFrames chirps are
    read; recently used frames are LRU-cached because adjacent windows
    share G-1 of G frames.
  * Batches are assembled by a background prefetch thread (the numWorkers
    equivalent).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from hupr_tpu_torch.data.annot import generate_gt_annotations


def window_indices(n_frames_total: int, duration: int, group: int) -> np.ndarray:
    """(N, G) table of clamped window indices, replicating the reference's
    stateful loop (dataset.py:126-138) exactly."""
    table = np.zeros((n_frames_total, group), dtype=np.int64)
    half = group // 2
    for index in range(n_frames_total):
        pad = index % duration
        idx = index - half - 1
        for j in range(group):
            if (j + pad) <= half:
                idx = index - pad
            elif j > (duration - 1 - pad) + half:
                idx = index + (duration - 1 - pad)
            else:
                idx += 1
            table[index, j] = idx
    return table


class FrameCache:
    """LRU cache of per-frame chirp-sliced radar arrays, bounded both by
    item count and by total bytes (a frame pair of f32 planes is ~2 MB)."""

    def __init__(self, max_items: int = 4096,
                 max_bytes: int = 4 << 30):
        self.max_items = max_items
        self.max_bytes = max_bytes
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(val) -> int:
        return sum(int(np.asarray(a).nbytes)
                   for a in (val if isinstance(val, (tuple, list)) else [val]))

    def has(self, key) -> bool:
        with self._lock:
            return key in self._d

    def put(self, key, val):
        with self._lock:
            if key in self._d:
                self._bytes -= self._nbytes(self._d[key])
            self._d[key] = val
            self._d.move_to_end(key)
            self._bytes += self._nbytes(val)
            while self._d and (len(self._d) > self.max_items
                               or self._bytes > self.max_bytes):
                _, old = self._d.popitem(last=False)
                self._bytes -= self._nbytes(old)

    def get(self, key, loader):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        val = loader()
        self.put(key, val)
        return val


class HuPRDataset:
    """Index-addressable HuPR dataset over preprocessed .npy radar cubes."""

    def __init__(self, phase: str, cfg, sampling_ratio: int = 1,
                 random_sampling: Optional[bool] = None,
                 generate_gt: bool = True, cache_items: int = 4096,
                 use_native: Optional[bool] = None):
        if phase not in ("train", "val", "test"):
            raise ValueError(f"Invalid phase: {phase}")
        self.phase = phase
        self.cfg = cfg
        d = cfg.DATASET
        self.duration = d.duration
        self.num_frames = d.numFrames
        self.num_group_frames = d.numGroupFrames
        self.num_chirps = d.numChirps
        self.num_keypoints = d.numKeypoints
        self.sampling_ratio = sampling_ratio
        # the reference constructs every phase with random=True
        # (datasets/dataset.py:14-15,121-124): with sampling_ratio > 1 even
        # eval indices are randomized; parity keeps that default.
        self.random_sampling = True if random_sampling is None \
            else random_sampling
        self.data_dir = d.dataDir

        if generate_gt:
            self.gt_file = generate_gt_annotations(cfg, phase)
        else:
            self.gt_file = os.path.join(self.data_dir, f"{phase}_gt.json")
        with open(self.gt_file) as fp:
            self.gt_dataset = json.load(fp)

        self.image_ids: List[int] = [im["id"] for im in self.gt_dataset["images"]]
        self.paths_hori: List[str] = []
        self.paths_vert: List[str] = []
        for image_id in self.image_ids:
            s = "%09d" % image_id
            seq, frame = int(s[:4]), int(s[-4:])
            self.paths_hori.append(os.path.join(
                self.data_dir, f"single_{seq}/hori/{frame:09d}.npy"))
            self.paths_vert.append(os.path.join(
                self.data_dir, f"single_{seq}/vert/{frame:09d}.npy"))

        anns: Dict[int, dict] = {a["image_id"]: a
                                 for a in self.gt_dataset["annotations"]}
        self.joints = np.stack([
            np.asarray(anns[i]["keypoints"], dtype=np.float64)
              .reshape(-1, 3)[:, :2]
            for i in self.image_ids])                       # (N, K, 2)
        self.bboxes = np.stack([
            np.asarray(anns[i]["bbox"], dtype=np.float32)
            for i in self.image_ids])                       # (N, 4) xywh

        self.windows = window_indices(len(self.image_ids), self.duration,
                                      self.num_group_frames)
        self._cache = FrameCache(cache_items)
        self._chirp_start = self.num_chirps // 2 - self.num_frames // 2
        self._chirp_slice = slice(self._chirp_start,
                                  self._chirp_start + self.num_frames)
        if use_native is None:
            from hupr_tpu_torch.data.native_loader import native_available
            use_native = native_available()
        self.use_native = use_native
        self._inner_shape = (d.rangeSize, d.azimuthSize, d.elevationSize)
        self._num_io_threads = getattr(cfg.SETUP, "numWorkers", 4)
        self._load_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.image_ids) // self.sampling_ratio

    # ------------- frame/sample loading (host side) -------------

    def _load_frame_numpy(self, path: str):
        """(numFrames, R, A, E) float32 (re, im) — mmap'd center-chirp slice."""
        arr = np.load(path, mmap_mode="r")
        sel = np.ascontiguousarray(arr[self._chirp_slice])
        return (sel.real.astype(np.float32), sel.imag.astype(np.float32))

    def _frames(self, paths: List[str]):
        """Fetch frames through the LRU cache; cache misses are batch-loaded
        by the threaded C++ loader when available.

        Native bulk loads run under a single-flight lock: concurrent
        BatchLoader pool workers share G-1 of G window frames, and without
        it each would re-load the same files. The NumPy fallback stays
        outside the lock, which would undo the pool's IO parallelism; at
        worst two workers load the same frame, which the cache absorbs."""
        if self.use_native:
            with self._load_lock:
                missing = [p for p in dict.fromkeys(paths)
                           if not self._cache.has(p)]
                if missing:
                    from hupr_tpu_torch.data.native_loader import load_frames
                    loaded = load_frames(missing, self._chirp_start,
                                         self.num_frames, self._inner_shape,
                                         self._num_io_threads)
                    if loaded is not None:
                        re, im = loaded
                        for i, p in enumerate(missing):
                            # copy: caching views of the bulk array would
                            # keep the whole base alive past eviction,
                            # defeating the cache's byte bound
                            self._cache.put(p, (re[i].copy(), im[i].copy()))
                    else:
                        self.use_native = False  # fall back permanently
        return [self._cache.get(p, lambda p=p: self._load_frame_numpy(p))
                for p in paths]

    def raw_sample(self, index: int) -> dict:
        """One un-normalized sample: windows of both views + annotations.

        Returns float32 (G, C, 2, R, A, E) per view — the reference tensor
        contract before Normalize (which runs on the card per batch).
        """
        win = self.windows[index]

        def assemble(paths):
            frames = self._frames([paths[i] for i in win])
            re = np.stack([f[0] for f in frames])      # (G, C, R, A, E)
            im = np.stack([f[1] for f in frames])
            return np.stack([re, im], axis=2)          # (G, C, 2, R, A, E)

        hori = assemble(self.paths_hori)
        vert = assemble(self.paths_vert)
        return {
            "hori": hori,
            "vert": vert,
            "jointsGroup": self.joints[index],
            "bbox": self.bboxes[index],
            "imageId": self.image_ids[index],
        }

    def fill_sample(self, index: int, hori_out: np.ndarray,
                    vert_out: np.ndarray) -> None:
        """Write one sample's windows straight into caller buffers
        (G, C, 2, R, A, E): one copy from the cached frame planes instead
        of raw_sample's three stacked copies."""
        win = self.windows[index]
        for out, paths in ((hori_out, self.paths_hori),
                           (vert_out, self.paths_vert)):
            frames = self._frames([paths[i] for i in win])
            for g, (re, im) in enumerate(frames):
                out[g, :, 0] = re
                out[g, :, 1] = im

    def sample_index(self, i: int, rng: Optional[np.random.Generator]) -> int:
        """Sampling-ratio subsampling (dataset.py:121-124): randomized stride
        for train, fixed stride otherwise."""
        if self.random_sampling and self.sampling_ratio > 1 and rng is not None:
            return i * int(rng.integers(1, self.sampling_ratio + 1))
        return i * self.sampling_ratio

    # ------------- evaluation (dataset.py:48-88) -------------

    def evaluate(self, load_dir: str, verbose: bool = True) -> float:
        from hupr_tpu_torch.eval import KeypointEvaluator
        res_file = os.path.join(load_dir, f"{self.phase}_results.json")
        with open(res_file) as fp:
            dts = json.load(fp)
        ev = KeypointEvaluator(self.gt_dataset, dts)
        stats = ev.run(verbose=verbose)
        if verbose:
            names = ["AP", "Ap .5", "AP .75", "AP (M)", "AP (L)",
                     "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]
            for i, (n, v) in enumerate(zip(names, stats)):
                print("%s:\t%.3f\t" % (n, v), end="")
                if (i + 1) % 5 == 0:
                    print()
        return float(stats[0])

    def evaluate_each(self, load_dir: str, verbose: bool = True) -> float:
        """Per-keypoint AP (dataset.py:48-66). Returns the mean per-keypoint
        AP (the reference returns the last keypoint's AP by accident; the
        JAX package fixed that, and the port keeps its fix)."""
        from hupr_tpu_torch.eval import KeypointEvaluator
        res_file = os.path.join(load_dir, f"{self.phase}_results.json")
        with open(res_file) as fp:
            dts = json.load(fp)
        ev = KeypointEvaluator(self.gt_dataset, dts)
        aps = []
        joint_names = self.cfg.DATASET.idxToJoints
        for k in range(self.num_keypoints):
            stats = ev.run(idx_keypoint=k, verbose=False)
            aps.append(float(stats[0]))
        if verbose:
            for name, ap in zip(joint_names, aps):
                print("%s: %.3f" % (name, ap))
        return float(np.mean(aps))


class BatchLoader:
    """Background-thread prefetching batch iterator (numWorkers equivalent).

    `workers` > 1 assembles the samples of a batch with a thread pool
    (reference SETUP.numWorkers semantics, tools/run.py:21,28: .npy reads
    and memcpy release the GIL, so threads overlap IO)."""

    def __init__(self, dataset: HuPRDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = False, workers: int = 1,
                 transfer_dtype: torch.dtype = torch.float32):
        """transfer_dtype: wire format for the hori/vert planes
        (SETUP.transferDtype via utils/transfer.py; the cast happens in the
        loader thread so it overlaps the card's work)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.transfer_dtype = transfer_dtype
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0
        self.prefetch = prefetch
        self.workers = max(1, int(workers))
        self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _assemble(self, indices: List[int]) -> dict:
        from hupr_tpu_torch.utils.transfer import cast_for_transfer

        ds = self.dataset
        b = len(indices)
        shape = (b, ds.num_group_frames, ds.num_frames, 2) + ds._inner_shape
        hori = np.empty(shape, np.float32)
        vert = np.empty(shape, np.float32)

        def fill(j_i):
            j, i = j_i
            ds.fill_sample(i, hori[j], vert[j])

        work = list(enumerate(indices))
        if self.workers == 1 or b == 1:
            for w in work:
                fill(w)
        else:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=self.workers)
            list(self._pool.map(fill, work))
        return {
            "hori": cast_for_transfer(hori, self.transfer_dtype),
            "vert": cast_for_transfer(vert, self.transfer_dtype),
            "jointsGroup": ds.joints[indices],
            "bbox": ds.bboxes[indices],
            "imageId": np.asarray([ds.image_ids[i] for i in indices]),
        }

    def _batches(self) -> Iterator[dict]:
        n = len(self.dataset)
        # the permutation rng is keyed by (seed, epoch) only, the per-row
        # sampling-ratio stream by (seed, epoch, process 0): the JAX
        # package's streams, so both draw the same batches
        order_rng = np.random.default_rng((self.seed, self._epoch))
        sample_rng = np.random.default_rng((self.seed, self._epoch, 0))
        self._epoch += 1
        order = np.arange(n)
        if self.shuffle:
            order_rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            indices = [self.dataset.sample_index(int(i), sample_rng)
                       for i in idx]
            yield self._assemble(indices)

    def __iter__(self) -> Iterator[dict]:
        from hupr_tpu_torch.utils.prefetch import stop_aware_put

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        failure: list = []
        stop = threading.Event()

        def put(item) -> bool:
            return stop_aware_put(q, item, stop)

        def worker():
            try:
                for b in self._batches():
                    if not put(b):
                        return
            except BaseException as exc:  # propagate to the consumer
                failure.append(exc)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if failure:
                        raise failure[0]
                    break
                yield item
        finally:
            stop.set()  # consumer finished or bailed early: release producer


def get_dataset(phase: str, cfg, sampling_ratio: int = 1, **kw) -> HuPRDataset:
    """Reference getDataset equivalent (datasets/dataset.py:14-15)."""
    return HuPRDataset(phase, cfg, sampling_ratio=sampling_ratio, **kw)


def get_paths(data_dir_group, dir_group, mode, frame_group):
    """Enumerate per-frame .npy paths (reference BaseDataset.getPaths)."""
    paths = []
    for i, data_dir in enumerate(data_dir_group):
        for dir_name in dir_group[i]:
            for frame in frame_group:
                paths.append(os.path.join(data_dir, dir_name, mode,
                                          frame + ".npy"))
    return paths


def get_annots(data_dir_group, dir_group, mode, file_name):
    """Concatenate annotation JSONs (reference BaseDataset.getAnnots)."""
    annots = []
    for i, data_dir in enumerate(data_dir_group):
        for dir_name in dir_group[i]:
            with open(os.path.join(data_dir, dir_name, mode, file_name)) as fp:
                annots.extend(json.load(fp))
    return annots
