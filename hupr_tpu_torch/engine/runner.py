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

On the card, the host stays a step ahead: batch i+1 is copied while step i
runs (utils/prefetch.device_prefetch), and the losses and predictions of
a step are read one step later, from copies started right after it
(utils/prefetch.PendingFetch), so that reading them never waits for the
step queued behind them.

Not ported, and refused with NotImplementedError: multi-host runs
(HUPR_MULTIHOST, ROADMAP A9), chunk-mode training (TRAINING.chunkTrain)
and raw-ADC sequence eval (TEST.sequenceSource: adc), both ROADMAP A4.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from hupr_tpu_torch.data.dataset import BatchLoader, get_dataset
from hupr_tpu_torch.engine.checkpoint import (AsyncCheckpointer,
                                              find_checkpoint,
                                              load_checkpoint)
from hupr_tpu_torch.engine.logger import Logger
from hupr_tpu_torch.engine.seq_eval import SequenceEvaluator
from hupr_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                         make_optimizer, make_train_step)
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.utils.device import float32_math, resolve_device
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


def refuse_unported(cfg, args) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that owns it,
    for what a config or the environment asks and the port lacks. None of
    them falls back to another path: each would give another result."""
    if os.environ.get("HUPR_MULTIHOST") == "1":
        raise NotImplementedError(
            "HUPR_MULTIHOST=1: multi-host runs are not ported (ROADMAP A9)")
    if not args.eval and getattr(cfg.TRAINING, "chunkTrain", False):
        raise NotImplementedError(
            "TRAINING.chunkTrain: chunk-mode training is not ported "
            "(ROADMAP A4); it batches consecutive windows, so the classic "
            "loader would train on other batches")
    if getattr(cfg.TEST, "sequenceEval", True) and \
            getattr(cfg.TEST, "sequenceSource", "cubes") == "adc":
        raise NotImplementedError(
            "TEST.sequenceSource: adc: raw-ADC sequence eval is not ported "
            "(ROADMAP A4)")


class Runner:
    """`args` carries the CLI's fields (seed, dir, visDir, eval,
    sampling_ratio, keypoints; optionally evalPhase). Logs and
    checkpoints go to ./logs/<dir>. Runs on the card unless `device` says
    otherwise."""

    def __init__(self, args, cfg, device=None):
        refuse_unported(cfg, args)
        self.args = args
        self.cfg = cfg
        self.device = resolve_device(device)
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

        self.model = build_model(cfg, self.device)
        self.tx = make_optimizer(cfg, self.model)
        self.state = TrainState(self.model, self.tx)
        geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        self.train_step = make_train_step(self.model, self.tx, t.lossDecay,
                                          geometry)
        self.eval_step = make_eval_step(self.model, t.lossDecay, geometry)
        self._seq_eval = None   # built at the first sequence-mode eval

        wire = transfer_dtype(getattr(cfg.SETUP, "transferDtype", "float32"))
        self.train_set, self.train_loader = None, None
        if not args.eval:
            self.train_set = get_dataset("train", cfg, args.sampling_ratio)
            self.train_loader = BatchLoader(
                self.train_set, t.batchSize, shuffle=True, seed=args.seed,
                workers=cfg.SETUP.numWorkers, transfer_dtype=wire)
        # args.evalPhase overrides the reference's eval->test / train->val
        # pairing (its main.py:36-44), as in the JAX package
        phase = getattr(args, "evalPhase", None) or \
            ("test" if args.eval else "val")
        self.test_set = get_dataset(phase, cfg, args.sampling_ratio)
        self.test_loader = BatchLoader(self.test_set, cfg.TEST.batchSize,
                                       shuffle=False, seed=args.seed,
                                       workers=cfg.SETUP.numWorkers,
                                       transfer_dtype=wire)

        # warmup LR back-computation (run.py:30-32); eval mode has no train
        # loader and never steps the optimizer
        if t.warmupEpoch == -1 or self.train_loader is None:
            self.lr = t.lr
        else:
            step_size = len(self.train_loader) * t.warmupEpoch
            self.lr = t.lr / (t.warmupGrowth ** step_size)
        # loss-annealing weight; the reference's LossComputer advances it
        # before combining the losses, on every computeLoss call, train and
        # eval batches alike (misc/losses.py:36-42)
        self.alpha = 0.0

        self.logger = Logger()
        self.checkpointer = AsyncCheckpointer()
        if self.train_loader is not None:
            print(f"==========>Train set size: {len(self.train_loader)} "
                  f"batches")
        print("==========>Test set size:", len(self.test_loader))

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

    # ---------------- checkpoints ----------------

    def load_model_weight(self, mode: str):
        """Load ./logs/<dir>/<mode>.pth: weights, and the optimizer's state
        when the file has one. In train mode, resume at the saved epoch,
        with its best AP and learning rate (tools/base.py:106-122)."""
        path = find_checkpoint(self.dir, mode)
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

    def save_model_weight(self, epoch: int, acc: float):
        """The retention of tools/base.py:75-90 (best / latest / every 5),
        one device-to-host copy for all files, written on a background
        thread."""
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
        is on; classic otherwise."""
        self._eval_len = len(self.test_set)
        if self._sequence_eval_applicable():
            if self._seq_eval is None:
                self._seq_eval = SequenceEvaluator(self.model, self.cfg)
            return self._seq_eval.eval_batches(self.test_set)
        return self._classic_eval_batches()

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
        write its keypoints JSON and return its AP."""
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
        self.write_keypoints(save_preds)
        if self.args.keypoints:
            self.test_set.evaluate_each(self.dir)
        return self.test_set.evaluate(self.dir)

    # ---------------- train (run.py:65-86) ----------------

    def _log_loss(self, pending, loss_list, epoch: int):
        fetched, true_b = pending
        out = fetched.get()
        loss = float(out["loss"])
        self.logger.display(loss, float(out["loss2"]), true_b, epoch)
        loss_list.append(loss)

    def train(self):
        """Train from self.start_epoch to TRAINING.epochs; evaluate, save
        the checkpoints and the loss list after each epoch."""
        t = self.cfg.TRAINING
        for epoch in range(self.start_epoch, t.epochs):
            loss_list = []
            self.logger.clear(len(self.train_set))
            # the losses of step i are read after step i+1 is queued
            pending = None
            with float32_math():
                for idx_batch, (device_batch, _, true_b) in enumerate(
                        device_prefetch(self.train_loader, self.device,
                                        pad_to=t.batchSize)):
                    self.advance_alpha()
                    self.state, metrics = self.train_step(
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
