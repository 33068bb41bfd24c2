"""Runner: the train and eval loop (counterpart of
`hupr_tpu/engine/runner.py`; parity: the reference's tools/base.py and
tools/run.py).

Kept from the reference and the JAX package:
  * ./logs/<dir> checkpoints (.pth): best by val AP, latest every epoch,
    one every 5 epochs
  * the warmup back-computation of the initial learning rate
    (run.py:30-32) and the warmup-growth / decay schedule applied at batch
    0 and every lrDecayIter batches (run.py:81-82, base.py:66-72)
  * keypoint export: argmax coordinates x (imgSize / heatmapSize), vis 1,
    xywh -> center / scale with 1.25 inflation and pixel_std 200, score 1.0
    (base.py:49-64, 124-152) -> {val,test}_results.json
  * per-epoch val evaluation (sequence mode by default, classic
    otherwise), loss-list JSONs, a progress line per batch.
  * the JAX package's fast-path levers: chunk-mode training
    (TRAINING.chunkTrain, from cube planes or, with TRAINING.chunkSource
    adc, from the raw captures under DATASET.adcDir) and raw-ADC
    sequence eval (TEST.sequenceSource adc). Where a lever does not apply
    the Runner prints the JAX package's notice and takes its fallback:
    the classic loader when chunk mode is inapplicable, cube chunks or
    cube planes when the captures do not cover the split.

On the card, the host stays a step ahead: batch i+1 is copied while step i
runs (utils/prefetch.device_prefetch), and the losses and predictions of
a step are read one step later, from copies started right after it
(utils/prefetch.PendingFetch), so that reading them never waits for the
step queued behind them.

In a multi-process run (HUPR_MULTIHOST=1, main.run; one process per
card, parallel/multihost.py), as the JAX Runner does: every process loads
only its rows of each padded global batch (BatchLoader / ChunkTrainLoader
process mode) and takes the data-parallel step (engine/steps.py); the
startup checks the shared logs dir, warms the device collectives up and
makes every process agree on the dataset sizes, the resume, and the chunk
and raw-ADC fallbacks, raising on all of them together on a disagreement;
eval needs sequence mode, each process scores its round-robin share of the
sequences on its own card and writes a rank file, process 0 merges and
scores it, and the AP is broadcast; process 0 alone writes checkpoints and
loss lists. A world of one runs the single-card loop.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from hupr_tpu_torch.data.adc import ADCFrameSource
from hupr_tpu_torch.data.dataset import BatchLoader, get_dataset
from hupr_tpu_torch.engine.checkpoint import (AsyncCheckpointer,
                                              find_checkpoint,
                                              load_checkpoint)
from hupr_tpu_torch.engine.chunk_train import (CHUNK_KEYS, ADCChunkLoader,
                                               ChunkTrainLoader,
                                               make_adc_chunk_train_step,
                                               make_chunk_train_step)
from hupr_tpu_torch.engine.logger import Logger
from hupr_tpu_torch.engine.seq_eval import (SequenceEvaluator,
                                            sequence_groups)
from hupr_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                         make_optimizer, make_train_step)
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.parallel import multihost
from hupr_tpu_torch.parallel.mesh import make_mesh, replicate_state
from hupr_tpu_torch.utils.device import float32_math
from hupr_tpu_torch.utils.prefetch import PendingFetch, device_prefetch
from hupr_tpu_torch.utils.transfer import transfer_dtype


def xywh_to_center_scale(x, y, w, h, aspect_ratio=1.0, pixel_std=200.0):
    """bbox -> COCO center/scale with 1.25 inflation (base.py:49-64)."""
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
    if center[0] != -1:
        scale = scale * 1.25
    return center, scale


class Runner:
    """`args` carries the CLI's fields (seed, dir, visDir, eval,
    sampling_ratio, keypoints; optionally evalPhase). Logs and
    checkpoints go to ./logs/<dir>. Runs on the card unless `device` says
    otherwise; in a process group, on this process's card
    (parallel.make_mesh) or `mesh.device`."""

    def __init__(self, args, cfg, device=None, mesh=None):
        self.args = args
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_mesh(device)
        self.device = self.mesh.device
        np.random.seed(args.seed)
        torch.manual_seed(args.seed)
        self.dir = os.path.join("./logs", args.dir)
        self.vis_dir = os.path.join("./visualization", args.visDir)
        os.makedirs(self.dir, exist_ok=True)
        if args.visDir != "none":
            os.makedirs(self.vis_dir, exist_ok=True)

        d, t = cfg.DATASET, cfg.TRAINING
        self.heatmap_size = d.heatmapSize
        self.img_size = d.imgSize
        self.num_keypoints = d.numKeypoints
        self.img_heatmap_ratio = d.imgSize / d.heatmapSize
        self.start_epoch = 0
        self.epoch_aps = []     # each trained epoch's val AP, in order

        # multi-process: every process assembles only its block of each
        # padded global batch. The checks run before any step, and the
        # collective warm-up while the processes are still in step
        self.n_proc, self.pid = self.mesh.world, self.mesh.rank
        mh = {}
        if self.n_proc > 1:
            mh = dict(process=(self.pid, self.n_proc),
                      padded_rows=t.batchSize + (-t.batchSize) % self.n_proc)
            # the rank-file eval merge and process-0 checkpoints need a
            # filesystem every process shares: fail now, not after epoch 0
            multihost.assert_shared_dir(self.dir)
        multihost.warmup_device_collectives(self.mesh)

        self.model = build_model(cfg, self.device)
        self.tx = make_optimizer(cfg, self.model)
        self.state = replicate_state(TrainState(self.model, self.tx),
                                     self.mesh)
        geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        self.train_step = make_train_step(self.model, self.tx, t.lossDecay,
                                          geometry, mesh=self.mesh)
        self.eval_step = make_eval_step(self.model, t.lossDecay, geometry)
        self._seq_eval = None   # built at the first sequence-mode eval

        wire = transfer_dtype(getattr(cfg.SETUP, "transferDtype", "float32"))
        self.train_set, self.train_loader = None, None
        self._chunk_loader, self._chunk_step = None, None
        if not args.eval:
            self.train_set = get_dataset("train", cfg, args.sampling_ratio)
            chunk = getattr(t, "chunkTrain", False)
            if chunk:
                if not ChunkTrainLoader.applicable(self.train_set, cfg):
                    print("==========>chunkTrain requested but inapplicable "
                          "(needs sampling_ratio 1, lossDecay -1, "
                          "full-duration sequences) — classic loader")
                elif getattr(t, "chunkSource", "cubes") == "adc" and \
                        self._try_adc_chunk(cfg, args, geometry):
                    pass  # raw-ADC loader and step installed
                else:
                    self._chunk_loader = ChunkTrainLoader(
                        self.train_set, t.batchSize, seed=args.seed,
                        shuffle=True, pad_multiple=self.n_proc,
                        transfer_dtype=wire, process=mh.get("process"))
                    self._chunk_step = make_chunk_train_step(
                        self.model, self.tx, geometry, mesh=self.mesh)
            if self._chunk_loader is None:
                # only when chunk mode does not drive training
                self.train_loader = BatchLoader(
                    self.train_set, t.batchSize, shuffle=True,
                    seed=args.seed, workers=cfg.SETUP.numWorkers,
                    transfer_dtype=wire, **mh)
                if not chunk and \
                        ChunkTrainLoader.applicable(self.train_set, cfg):
                    # the JAX package's hint to input-bound classic runs
                    print("==========>hint: this run qualifies for "
                          "chunk-mode training (TRAINING.chunkTrain: "
                          "true, or config/mscsa_prgcn_tpu_fast.yaml) "
                          "— ~an order of magnitude faster when the "
                          "loader or host->device link is the "
                          "bottleneck; per-step math is unchanged, "
                          "epochs shuffle chunks instead of windows")
        # args.evalPhase overrides the reference's eval->test / train->val
        # pairing (its main.py:36-44), as in the JAX package
        phase = getattr(args, "evalPhase", None) or \
            ("test" if args.eval else "val")
        self.test_set = get_dataset(phase, cfg, args.sampling_ratio)
        self.test_loader = BatchLoader(self.test_set, cfg.TEST.batchSize,
                                       shuffle=False, seed=args.seed,
                                       workers=cfg.SETUP.numWorkers,
                                       transfer_dtype=wire)
        if self.n_proc > 1:
            # per-host copies of the data must describe the same global
            # dataset: a divergent annotation file gives processes
            # different batch counts, and one would issue collectives the
            # others never join. Fail fast with the per-process sizes
            multihost.assert_agreement(
                "train dataset size",
                -1.0 if self.train_set is None else float(
                    len(self.train_set)))
            multihost.assert_agreement(
                f"{self.test_set.phase} dataset size",
                float(len(self.test_set)))
            # multi-process eval needs sequence mode: fail at startup
            self._require_sequence_eval()

        # steps an epoch under the loader that drives training (chunk mode
        # has ceil(duration / B) chunks a sequence, more than ceil(N / B)
        # when duration % B != 0); None in eval mode
        driving_loader = (self._chunk_loader if self._chunk_loader
                          is not None else self.train_loader)
        # warmup LR back-computation (run.py:30-32); eval mode has no train
        # loader and never steps the optimizer
        if t.warmupEpoch == -1 or driving_loader is None:
            self.lr = t.lr
        else:
            step_size = len(driving_loader) * t.warmupEpoch
            self.lr = t.lr / (t.warmupGrowth ** step_size)
        # loss-annealing weight; the reference's LossComputer advances it
        # before combining the losses, on every computeLoss call, train and
        # eval batches alike (misc/losses.py:36-42)
        self.alpha = 0.0

        self.logger = Logger()
        self.checkpointer = AsyncCheckpointer()
        if driving_loader is not None:
            kind = "chunk steps" if self._chunk_loader is not None \
                else "batches"
            print(f"==========>Train set size: {len(driving_loader)} {kind}")
        print("==========>Test set size:", len(self.test_loader))

    def _try_adc_chunk(self, cfg, args, geometry) -> bool:
        """Install the raw-ADC chunk loader and step (TRAINING.chunkSource:
        adc) when the captures cover the train split; otherwise print the
        JAX package's notice and return False (the caller installs cube
        chunks)."""
        d = cfg.DATASET
        rp = d.radar_params()       # raises on a geometry mismatch
        adc = ADCFrameSource(d.adcDir, rp)
        ok = ADCChunkLoader.applicable(self.train_set, cfg, adc)
        # one process falling back to cube chunks would run another
        # program: agree, or raise on every process together
        multihost.assert_agreement("adc chunk availability", float(ok))
        if not ok:
            print("==========>chunkSource adc requested but the captures "
                  f"under DATASET.adcDir={d.adcDir!r} don't cover the "
                  "train split — cube chunks")
            return False
        process = (self.pid, self.n_proc) if self.n_proc > 1 else None
        self._chunk_loader = ADCChunkLoader(
            self.train_set, cfg.TRAINING.batchSize, adc, seed=args.seed,
            shuffle=True, pad_multiple=self.n_proc, process=process)
        self._chunk_step = make_adc_chunk_train_step(
            self.model, self.tx, geometry, mesh=self.mesh, radar_params=rp,
            num_frames=d.numFrames)
        return True

    # ---------------- LR schedule (base.py:66-72) ----------------

    def adjust_lr(self, epoch: int):
        t = self.cfg.TRAINING
        if epoch < t.warmupEpoch:
            self.lr *= t.warmupGrowth
        else:
            self.lr *= t.lrDecay

    def advance_alpha(self):
        """Advance the annealing weight as the reference does at the top of
        every computeLoss call (misc/losses.py:36-38)."""
        if self.alpha < 1.0:
            self.alpha += self.cfg.TRAINING.lossDecay

    def _sequence_eval_applicable(self) -> bool:
        return (getattr(self.cfg.TEST, "sequenceEval", True)
                and SequenceEvaluator.applicable(self.test_set, self.cfg))

    def _require_sequence_eval(self):
        if not self._sequence_eval_applicable():
            raise RuntimeError(
                "multi-host eval needs sequence mode (TEST.sequenceEval on, "
                "sampling_ratio 1, lossDecay -1, full-duration sequences)")

    # ---------------- checkpoints ----------------

    def load_model_weight(self, mode: str):
        """Load ./logs/<dir>/<mode>.pth: weights, and the optimizer's state
        when the file has one. In train mode, resume at the saved epoch,
        with its best AP and learning rate (tools/base.py:106-122). In a
        multi-process run every process must see the same file, and the
        state is then made rank 0's (parallel.replicate_state)."""
        path = find_checkpoint(self.dir, mode)
        if self.n_proc > 1:
            # every process must make the same resume decision: one that
            # cannot see the checkpoint would keep its fresh weights and
            # run another number of epochs of collectives. allgather, so
            # that a disagreement raises on every process together
            found = multihost.allgather_scalar(0.0 if path is None else 1.0)
            if any(f != found[0] for f in found):
                missing = [i for i, f in enumerate(found) if not f]
                raise RuntimeError(
                    f"checkpoint visibility differs across hosts: process(es) "
                    f"{missing} did not find a '{mode}' checkpoint the others "
                    f"did — the logs dir must be a shared filesystem")
        if path is None:
            print("==========>Train the model from scratch")
            return
        epoch, acc, lr = load_checkpoint(path, self.model, self.tx)
        print(f"==========>Load the model weight from {path}, "
              f"saved at epoch {epoch}")
        if not self.args.eval:
            self.start_epoch = epoch
            self.logger.update_best_acc(acc)
            if lr is not None:
                # continue the warmup-growth / decay trajectory at the
                # saved learning rate, as the reference's
                # optimizer.load_state_dict does (tools/base.py:114)
                self.lr = lr
        if self.n_proc > 1:
            # a stale copy on one host would desynchronize start_epoch
            epochs = multihost.allgather_scalar(float(epoch))
            if any(int(e) != int(epochs[0]) for e in epochs):
                raise RuntimeError(
                    f"checkpoint epoch differs across hosts: per-process "
                    f"epochs {[int(e) for e in epochs]}")
        replicate_state(self.state, self.mesh)

    def save_model_weight(self, epoch: int, acc: float):
        """The retention of tools/base.py:75-90 (best / latest / every 5),
        one device-to-host copy for all files, written on a background
        thread. In a multi-process run the replicas are equal, and process
        0 alone writes."""
        if self.pid != 0:
            self.logger.is_best_acc_ap(acc)   # keep best-AP tracking synced
            return
        paths = []
        if self.logger.is_best_acc_ap(acc):
            print("==========>Save the best model...")
            paths.append(os.path.join(self.dir, "model_best.pth"))
        print("==========>Save the latest model...")
        paths.append(os.path.join(self.dir, "checkpoint.pth"))
        if epoch % 5 == 0:
            paths.append(os.path.join(self.dir, f"checkpoint_{epoch}.pth"))
        self.checkpointer.save(paths, self.model, self.tx, epoch,
                               self.logger.show_best_ap(), lr=self.lr)

    def save_loss_list(self, epoch: int, loss_list, mode: str):
        if self.pid != 0:
            return
        path = os.path.join(self.dir, f"{mode}_loss_list_{epoch}.json")
        with open(path, "w") as fp:
            json.dump(loss_list, fp)

    # ---------------- keypoint export (base.py:124-152) ----------------

    def save_keypoints(self, save_preds: list, preds: np.ndarray,
                       bbox: np.ndarray, image_ids: np.ndarray,
                       pred_heatmap: Optional[np.ndarray] = None) -> list:
        vis = np.ones((len(preds), self.num_keypoints, 1))
        preds3 = np.concatenate([preds, vis], axis=2)
        for j in range(len(preds3)):
            center, scale = xywh_to_center_scale(*[float(v) for v in bbox[j]])
            block = {
                "category_id": 1,
                "center": center.tolist(),
                "image_id": int(image_ids[j]),
                "scale": scale.tolist(),
                "score": 1.0,
                "keypoints": preds3[j].reshape(-1).tolist(),
            }
            if pred_heatmap is not None:
                # torch .var() is unbiased (base.py:140) -> ddof=1
                block["sigma"] = [
                    float(np.var(pred_heatmap[j, k], ddof=1)
                          * self.heatmap_size)
                    for k in range(self.num_keypoints)]
            save_preds.append(block)
        return save_preds

    def write_keypoints(self, preds: list) -> str:
        # named after the split being scored (evalPhase may make it 'val'
        # in eval mode); dataset.evaluate reads f"{phase}_results.json"
        name = f"{self.test_set.phase}_results.json"
        path = os.path.join(self.dir, name)
        with open(path, "w") as fp:
            json.dump(preds, fp)
        return path

    # ---------------- eval (run.py:35-63) ----------------

    def _classic_eval_batches(self):
        """Per-window host assembly through the BatchLoader (the
        reference's DataLoader shape): yields (out, image_ids, bbox,
        true_b)."""
        for device_batch, batch, true_b in device_prefetch(
                self.test_loader, self.device,
                pad_to=self.cfg.TEST.batchSize):
            self.advance_alpha()
            out = self.eval_step(self.state, device_batch, self.alpha)
            yield out, batch["imageId"][:true_b], batch["bbox"][:true_b], \
                true_b

    def _eval_batches(self):
        """Sequence mode (windows assembled on the card,
        engine/seq_eval.py) when the split allows it and TEST.sequenceEval
        is on; classic otherwise. In a multi-process run each process
        evaluates its round-robin share of the sequences on its own card
        (eval() merges the rank files)."""
        self._eval_len = len(self.test_set)
        if self.n_proc > 1:
            self._require_sequence_eval()
        if self._sequence_eval_applicable():
            if self._seq_eval is None:
                self._seq_eval = SequenceEvaluator(
                    self.model, self.cfg, adc_source=self._adc_eval_source())
            groups = None
            if self.n_proc > 1:
                groups = sequence_groups(
                    self.test_set.image_ids)[self.pid::self.n_proc]
                # the progress line tracks this process's share
                self._eval_len = sum(length for _, length in groups)
            return self._seq_eval.eval_batches(self.test_set, groups)
        return self._classic_eval_batches()

    def _adc_eval_source(self):
        """The ADCFrameSource of raw-ADC sequence eval (TEST.sequenceSource:
        adc) when the captures cover the split; otherwise None (cube
        planes), with the JAX package's notice when adc was asked for."""
        if getattr(self.cfg.TEST, "sequenceSource", "cubes") != "adc":
            return None
        d = self.cfg.DATASET
        rp = d.radar_params()       # raises on a geometry mismatch
        adc = ADCFrameSource(d.adcDir, rp)
        ok = SequenceEvaluator.adc_applicable(self.test_set, self.cfg, adc)
        # a process falling back to cube planes would run another encode
        multihost.assert_agreement("adc eval availability", float(ok))
        if not ok:
            print("==========>sequenceSource adc requested but the captures "
                  f"under DATASET.adcDir={d.adcDir!r} don't cover the "
                  "test split — cube planes")
            return None
        return adc

    def _consume_eval_batch(self, item, loss_list, save_preds,
                            visualization: bool, epoch: int):
        """Host-side consumption of one eval batch: read its results, log,
        export keypoints, optionally plot."""
        fetched, image_ids, bbox, true_b = item
        out = fetched.get()
        pred2d = out["pred2d"][:true_b]
        loss = float(out["loss"])
        self.logger.display(loss, float(out["loss2"]), true_b, epoch)
        preds_img = pred2d * self.img_heatmap_ratio
        if visualization:
            from hupr_tpu_torch.utils.plot import plot_human_pose
            plot_human_pose(preds_img, self.cfg, self.vis_dir, image_ids)
        self.save_keypoints(save_preds, preds_img, bbox, image_ids)
        loss_list.append(loss)

    def eval(self, visualization: bool = True, epoch: int = -1) -> float:
        """Evaluate the split (val in train mode, test in eval mode):
        write its keypoints JSON and return its AP (process 0's, on every
        process, in a multi-process run)."""
        loss_list: list = []
        save_preds: list = []
        batches = self._eval_batches()   # also sets self._eval_len
        self.logger.clear(self._eval_len)
        # one batch deferred: batch i-1's results are read while batch i
        # runs
        pending = None
        with float32_math():
            for out, image_ids, bbox, true_b in batches:
                item = (PendingFetch({k: out[k] for k in
                                      ("pred2d", "loss", "loss2")}),
                        image_ids, bbox, true_b)
                if pending is not None:
                    self._consume_eval_batch(pending, loss_list, save_preds,
                                             visualization, epoch)
                pending = item
            if pending is not None:
                self._consume_eval_batch(pending, loss_list, save_preds,
                                         visualization, epoch)
        if self.n_proc > 1:
            return self._merge_eval(save_preds)
        self.write_keypoints(save_preds)
        if self.args.keypoints:
            self.test_set.evaluate_each(self.dir)
        return self.test_set.evaluate(self.dir)

    def _merge_eval(self, save_preds: list) -> float:
        """Multi-process eval's end: every process writes its share to a
        rank file; process 0 merges them, runs the OKS evaluator, and its
        AP is broadcast, so that best-model tracking agrees everywhere."""
        phase = self.test_set.phase
        with open(multihost.rank_result_path(self.dir, phase), "w") as fp:
            json.dump(save_preds, fp)
        multihost.barrier("hupr_eval_results")
        acc_ap = 0.0
        if self.pid == 0:
            # the evaluator reads f"{phase}_results.json"
            multihost.merge_rank_results(
                self.dir, phase,
                os.path.join(self.dir, f"{phase}_results.json"))
            if self.args.keypoints:
                self.test_set.evaluate_each(self.dir)
            acc_ap = self.test_set.evaluate(self.dir)
        return multihost.broadcast_scalar(acc_ap)

    # ---------------- train (run.py:65-86) ----------------

    def _log_loss(self, pending, loss_list, epoch: int):
        fetched, true_b = pending
        out = fetched.get()
        loss = float(out["loss"])
        self.logger.display(loss, float(out["loss2"]), true_b, epoch)
        loss_list.append(loss)

    def _train_batches(self):
        """The epoch's batches on the card, (device_batch, host_batch,
        true_b): chunk batches in chunk mode (TRAINING.chunkTrain), else
        the classic loader's, the last one padded to the batch size."""
        if self._chunk_loader is not None:
            return device_prefetch(self._chunk_loader, self.device,
                                   keys=CHUNK_KEYS)
        return device_prefetch(self.train_loader, self.device,
                               pad_to=self.cfg.TRAINING.batchSize)

    def train(self):
        """Train from self.start_epoch to TRAINING.epochs; evaluate, save
        the checkpoints and the loss list after each epoch. In chunk mode
        the step consumes chunk batches; the schedule is the same."""
        t = self.cfg.TRAINING
        step = self._chunk_step or self.train_step
        for epoch in range(self.start_epoch, t.epochs):
            loss_list = []
            self.logger.clear(len(self.train_set))
            # the losses of step i are read after step i+1 is queued
            pending = None
            with float32_math():
                for idx_batch, (device_batch, _, true_b) in enumerate(
                        self._train_batches()):
                    self.advance_alpha()
                    self.state, metrics = step(
                        self.state, device_batch, self.lr, self.alpha)
                    fetched = PendingFetch({"loss": metrics["loss"],
                                            "loss2": metrics["loss2"]})
                    if pending is not None:
                        self._log_loss(pending, loss_list, epoch)
                    pending = (fetched, true_b)
                    if idx_batch % t.lrDecayIter == 0:
                        self.adjust_lr(epoch)
                if pending is not None:
                    self._log_loss(pending, loss_list, epoch)
            acc_ap = self.eval(visualization=False, epoch=epoch)
            self.epoch_aps.append(acc_ap)
            self.save_model_weight(epoch, acc_ap)
            self.save_loss_list(epoch, loss_list, "train")
        self.checkpointer.wait()  # flush the last epoch's save
