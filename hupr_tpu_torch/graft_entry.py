"""The port's graft entry points (counterpart of `__graft_entry__.py`).

entry()              -> (forward, (hori, vert)): the flagship HuPRNet
                        (numFilters 32, 64x64 maps, 8-frame windows,
                        MODEL.attention pallas) in eval mode, its forward
                        running the attention kernel, and its example
                        inputs, on the card.
dryrun_multichip(n)  -> the mini epoch over n ranks, one process each:
                        data-parallel train steps (a padded remainder
                        batch among them), a sharded eval step, checkpoint
                        save -> load -> resume, serving with the frame axis
                        split, sequence eval, the chunk and raw-ADC chunk
                        train steps and raw-ADC sequence eval, then the
                        flagship shape pass. Every stage prints a flushed
                        "[dryrun +12.3s] ..." line.
flagship_shapes(r, w) -> every sharded program at the flagship geometry on
                        rank r of a w-rank world, on meta tensors over
                        torch's fake process group: the output shapes and
                        dtypes, and no arithmetic (the JAX dryrun lowers
                        these programs on abstract inputs).

    python -m hupr_tpu_torch.graft_entry [--cpu]

runs dryrun_multichip(HUPR_DRYRUN_N, default 8) on the card, or with --cpu
on gloo ranks on the CPU. HUPR_DRYRUN_BUDGET (seconds, default 420): a
stage past train, eval and checkpoint is skipped, with a "SKIPPED" line,
when less than its share of the budget is left. Rank 0's clock decides for
every rank (the c10d store carries it), so the ranks skip alike.

Ranks: on the CPU, gloo with one thread a rank. On the card, NCCL with a
card a rank while there are enough cards; with more ranks than cards,
gloo ranks sharing the cards round robin (NCCL refuses two ranks on one
device). A rank that fails, or outlives the budget by GRACE_S, fails the
command with every rank's output tail.

Geometry: on the CPU the JAX dryrun's reduced one (numFilters 2, 32x32
maps, heatmap 32, image 128, RadarParams(128, 48, 16, 2, 94)), its batches
drawn in its order from default_rng(0); on the card the flagship one with
the default RadarParams, since the kernels take C in {64, 128, 256} only.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from hupr_tpu_torch.config import (config_from_dict, flagship_serving_config,
                                   flagship_training_config,
                                   max_training_config)
from hupr_tpu_torch.data.dataset import window_indices
from hupr_tpu_torch.engine.checkpoint import (load_checkpoint, snapshot,
                                              write_checkpoint)
from hupr_tpu_torch.engine.chunk_train import (chunk_table,
                                               make_adc_chunk_train_step,
                                               make_chunk_train_step)
from hupr_tpu_torch.engine.pipeline import make_e2e_infer
from hupr_tpu_torch.engine.seq_eval import (make_adc_sequence_encoder,
                                            make_sequence_encoder,
                                            make_window_eval_step)
from hupr_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                         make_optimizer, make_train_step)
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.ops import attention, kernels
from hupr_tpu_torch.ops.dsp import RadarParams
from hupr_tpu_torch.parallel import multihost
from hupr_tpu_torch.parallel.halo import frame_block
from hupr_tpu_torch.parallel.mesh import (Mesh, all_reduce_sum,
                                          gather_blocks, make_mesh,
                                          replicate_state, shard_batch,
                                          state_tensors)
from hupr_tpu_torch.utils.device import float32_math, resolve_device
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX dryrun's reduced capture: 32 range / azimuth bins, 8 kept chirps
REDUCED_RADAR = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                     num_group_chirp=2, range_gate_start=94)
LR = 1e-4
# the least budget left, in seconds, at which each optional stage starts
# (the JAX dryrun's)
GATES = {"sharded e2e serving": 120, "sharded sequence eval": 90,
         "sharded chunk-train step": 90, "sharded ADC chunk-train step": 90,
         "sharded ADC sequence eval": 60, "flagship shape pass": 45}
GRACE_S = 300
# the shape pass's world and the ranks it runs as (the first and the last,
# whose blocks hold the padding)
SHAPE_WORLD, SHAPE_RANKS = 8, (0, 7)
PROGRAMS = ("train", "eval", "serve", "seq_encode", "seq_window",
            "chunk_train", "adc_chunk_train", "max_train", "adc_seq_encode")


def _example_inputs(batch=2, filters=32):
    rng = np.random.default_rng(0)
    shape = (batch, 8, 8, 2, 64, 64, 8)
    hori = rng.standard_normal(shape).astype(np.float32)
    vert = rng.standard_normal(shape).astype(np.float32)
    return hori, vert


def entry(device=None, state_dict=None):
    """(forward, (hori, vert)): forward(hori, vert) -> (heatmap (B, K, 1,
    H, W), gcn_heatmap (B, 1, K, H, W)) of the flagship HuPRNet in eval
    mode under torch.inference_mode (the attention kernel alone, not its
    autograd Function) with TF32 off; the inputs are _example_inputs()
    (batch 2) on the device. On the card unless `device` says otherwise
    (device='cpu' takes the plain attention); with no card it raises. The
    weights are `state_dict`, or seeded synthetic ones at the JAX entry's
    scale, N(0, 0.05)."""
    dev = resolve_device(device)
    model = build_model(flagship_serving_config(), device="cpu")
    if state_dict is None:
        state_dict = synthetic_state_dict(model, seed=0, scale=0.05)
    model.load_state_dict(state_dict, strict=True)
    model = model.to(dev).eval()
    hori, vert = (torch.from_numpy(x).to(dev) for x in _example_inputs())

    def forward(hori, vert):
        with torch.inference_mode(), float32_math():
            return model(hori, vert)

    return forward, (hori, vert)


# ------------------------------------------------------- the mini epoch

def dryrun_config(flagship: bool):
    """The dryrun's recipe through the attention kernels: the flagship, or
    the JAX dryrun's reduced geometry."""
    if flagship:
        return flagship_training_config()
    return config_from_dict({
        "MODEL": {"numFilters": 2, "attention": "pallas"},
        "DATASET": {"rangeSize": 32, "azimuthSize": 32, "heatmapSize": 32,
                    "imgSize": 128}})


def _block(x, mesh: Mesh):
    """This rank's contiguous block of `x`'s leading axis."""
    rows = x.shape[0] // mesh.world
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


def _on(x, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(x, device=mesh.device)


def _sharded_eval(eval_step, state, block: dict, mesh: Mesh) -> dict:
    """eval_step on this rank's block of a padded global batch (eval mixes
    no rows, so the step takes no mesh), made the whole batch's: the
    losses the global masked means (each rank's masked mean weighted by
    its real rows, summed over the ranks, over the global count), the
    per-row outputs every rank's in rank order. A world of one is the
    step's own output."""
    out = eval_step(state, block)
    if not mesh.parallel:
        return out
    with torch.inference_mode():
        count = block["mask"].to(torch.float32).sum()
        losses = torch.stack([out[k] for k in ("loss", "loss1", "loss2")])
        # a rank of padding only holds a 0/0 mean: it adds nothing
        weighted = torch.where(count > 0, losses * count,
                               torch.zeros_like(losses))
        loss, loss1, loss2 = all_reduce_sum(weighted) / all_reduce_sum(count)
        rows = {k: gather_blocks(v, mesh) for k, v in out.items()
                if v.dim() > 0}
    return {"loss": loss, "loss1": loss1, "loss2": loss2, **rows}


def _state_digest(tensors) -> float:
    """The first 48 bits of a SHA-256 of `tensors`' bytes as a float (exact
    below 2^53), for multihost.assert_agreement."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return float(int(h.hexdigest()[:12], 16))


def _finite(what: str, values) -> None:
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"{what}: non-finite loss {values}")


class MiniEpoch:
    """The dryrun's stages on one rank of `mesh`: the flagship geometry on
    the card, the reduced one elsewhere. Every rank builds the same model
    from seed 0 (or loads `state_dict`), then takes rank 0's replica, and
    draws every global batch from one default_rng(0) in the JAX dryrun's
    order, keeping its own block. Each stage raises on a failed check."""

    def __init__(self, mesh: Mesh, state_dict=None):
        self.mesh = mesh
        self.cfg = dryrun_config(mesh.device.type == "cuda")
        d = self.cfg.DATASET
        self.rp = RadarParams() if mesh.device.type == "cuda" \
            else RadarParams(**REDUCED_RADAR)
        self.geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        self.spatial = (d.numGroupFrames, d.numFrames, 2, d.rangeSize,
                        d.azimuthSize, d.elevationSize)
        self.samples = 2 * self.rp.num_rx * self.rp.num_chirp \
            * self.rp.num_adc_samples
        torch.manual_seed(0)
        model = build_model(self.cfg, device=mesh.device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.state = replicate_state(
            TrainState(model, make_optimizer(self.cfg, model)), mesh)
        self.train_step = make_train_step(model, self.state.optimizer,
                                          geometry=self.geometry, mesh=mesh)
        self.rng = np.random.default_rng(0)

    def make_batch(self, b: int) -> dict:
        img = self.cfg.DATASET.imgSize
        return {
            "hori": self.rng.standard_normal((b,) + self.spatial).astype(
                np.float32),
            "vert": self.rng.standard_normal((b,) + self.spatial).astype(
                np.float32),
            "jointsGroup": self.rng.uniform(10, img - 10, (b, 14, 2)),
        }

    def _joints(self, rows: int) -> np.ndarray:
        img = self.cfg.DATASET.imgSize
        return self.rng.uniform(10, img - 10, (rows, 14, 2)).astype(
            np.float32)

    def train(self) -> list:
        """Three data-parallel steps on batches of n, n and max(1, n - 3)
        rows, each padded to n; the global losses."""
        n = self.mesh.world
        losses = []
        for b in (n, n, max(1, n - 3)):
            block, _ = shard_batch(self.make_batch(b), self.mesh, pad_to=n)
            _, metrics = self.train_step(self.state, block, LR, 0.0)
            losses.append(metrics["loss"].item())
        _finite("train", losses)
        return losses

    def eval(self) -> float:
        """One eval step on max(1, n - 1) rows padded to n: the global
        masked loss; pred2d holds all n rows."""
        n = self.mesh.world
        block, _ = shard_batch(self.make_batch(max(1, n - 1)), self.mesh,
                               pad_to=n)
        out = _sharded_eval(make_eval_step(self.state.model,
                                           geometry=self.geometry),
                            self.state, block, self.mesh)
        loss = out["loss"].item()
        _finite("eval", [loss])
        if tuple(out["pred2d"].shape) != (n, 14, 2):
            raise AssertionError(f"eval: pred2d {tuple(out['pred2d'].shape)}")
        return loss

    def checkpoint(self, root: str) -> tuple:
        """Rank 0 writes the state to root/checkpoint.pth; every rank loads
        it into a model built from another seed, which must then equal the
        live one bit for bit, and takes one more step from it; the replicas
        must agree bit for bit after it. Returns (epoch, loss)."""
        path = os.path.join(root, "checkpoint.pth")
        if self.mesh.rank == 0:
            write_checkpoint(path, snapshot(self.state.model,
                                            self.state.optimizer, epoch=1,
                                            accuracy=0.0))
        multihost.barrier("dryrun_checkpoint")
        torch.manual_seed(1)
        model = build_model(self.cfg, device=self.mesh.device)
        tx = make_optimizer(self.cfg, model)
        epoch, _, _ = load_checkpoint(path, model, tx)
        restored = replicate_state(TrainState(model, tx), self.mesh)
        live = self.state.model.state_dict()
        for key, value in model.state_dict().items():
            if not torch.equal(value, live[key]):
                raise AssertionError(f"checkpoint: {key} differs after load")
        step = make_train_step(model, tx, geometry=self.geometry,
                               mesh=self.mesh)
        block, _ = shard_batch(self.make_batch(self.mesh.world), self.mesh)
        _, metrics = step(restored, block, LR, 0.0)
        loss = metrics["loss"].item()
        _finite("resume", [loss])
        multihost.assert_agreement("dryrun_replicas",
                                   _state_digest(state_tensors(model, tx)))
        return epoch, loss

    def serving(self) -> int:
        """make_e2e_infer(mesh=) on 2n raw frames, a block of 2 a rank
        under the halo exchange. Returns the frame count."""
        f = 2 * self.mesh.world
        d = self.cfg.DATASET
        serve = make_e2e_infer(self.state.model, None, self.rp, duration=f,
                               group=d.numGroupFrames,
                               num_frames=d.numFrames, mesh=self.mesh)
        shape = (f, self.rp.num_rx, self.rp.num_chirp,
                 self.rp.num_adc_samples)
        adc = [self.rng.standard_normal(shape).astype(np.float32)
               for _ in range(4)]
        pred2d, maxvals = serve(*adc)
        if tuple(pred2d.shape) != (f, 14, 2) \
                or not bool(torch.isfinite(maxvals).all()):
            raise AssertionError(f"serving: pred2d {tuple(pred2d.shape)}, "
                                 f"maxvals finite "
                                 f"{bool(torch.isfinite(maxvals).all())}")
        return f

    def _sequence(self, encode, views) -> float:
        """One n-frame sequence through `encode` (each rank its frame block
        of every payload in `views`, a payload or a tuple of them) and the
        window step at batch n (each rank the windows of its frames): the
        global loss."""
        fs = self.mesh.world
        d = self.cfg.DATASET
        lo, hi = frame_block(fs, self.mesh)
        joints = self._joints(fs)
        step = make_window_eval_step(self.state.model, d.numGroupFrames,
                                     self.geometry, batch_size=fs,
                                     mesh=self.mesh)

        def block(view):
            if isinstance(view, tuple):
                return tuple(_on(p[lo:hi], self.mesh) for p in view)
            return _on(view[lo:hi], self.mesh)

        model = self.state.model
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), float32_math():
                ra, re_m = encode(*map(block, views), fs)
                out = step(ra, re_m, _on(joints[lo:hi], self.mesh),
                           _on(np.ones(hi - lo, np.float32), self.mesh), 0)
        finally:
            model.train(was_training)
        loss = out["loss"].item()
        _finite("sequence eval", [loss])
        if tuple(out["pred2d"].shape) != (fs, 14, 2):
            raise AssertionError(f"sequence eval: pred2d "
                                 f"{tuple(out['pred2d'].shape)}")
        return loss

    def seq_eval(self) -> float:
        d = self.cfg.DATASET
        shape = (self.mesh.world, d.numFrames, d.rangeSize, d.azimuthSize,
                 d.elevationSize)
        hr, hi, vr, vi = (self.rng.standard_normal(shape).astype(np.float32)
                          for _ in range(4))
        encode = make_sequence_encoder(self.state.model, d.numGroupFrames,
                                       mesh=self.mesh)
        return self._sequence(encode, [(hr, hi), (vr, vi)])

    def _chunk_batch(self, draw) -> dict:
        """The first chunk of n windows: `draw(frames)` gives each view's
        payload over the frame union padded to a multiple of n; every leaf
        is this rank's block on its device."""
        n = self.mesh.world
        d = self.cfg.DATASET
        g = d.numGroupFrames
        chunk = chunk_table(window_indices(d.duration, d.duration, g),
                            d.duration, n)[0]
        f = n + g - 1
        f_pad = f + (-f) % n
        batch = {"hori": draw(f_pad), "vert": draw(f_pad),
                 "rel": chunk["rel"], "jointsGroup": self._joints(n),
                 "mask": (np.arange(n) < chunk["true_b"]).astype(
                     np.float32)}
        return {k: _on(_block(v, self.mesh), self.mesh)
                for k, v in batch.items()}

    def chunk(self) -> float:
        d = self.cfg.DATASET
        shape = (d.numFrames, 2, d.rangeSize, d.azimuthSize, d.elevationSize)
        batch = self._chunk_batch(lambda f: self.rng.standard_normal(
            (f,) + shape).astype(np.float32))
        step = make_chunk_train_step(self.state.model, self.state.optimizer,
                                     self.geometry, mesh=self.mesh)
        _, metrics = step(self.state, batch, LR, 0.0)
        loss = metrics["loss"].item()
        _finite("chunk train", [loss])
        return loss

    def _streams(self, frames: int) -> np.ndarray:
        return self.rng.integers(-300, 300, (frames, self.samples)).astype(
            np.int16)

    def adc_chunk(self) -> float:
        batch = self._chunk_batch(self._streams)
        step = make_adc_chunk_train_step(
            self.state.model, self.state.optimizer, self.geometry,
            mesh=self.mesh, radar_params=self.rp,
            num_frames=self.cfg.DATASET.numFrames)
        _, metrics = step(self.state, batch, LR, 0.0)
        loss = metrics["loss"].item()
        _finite("ADC chunk train", [loss])
        return loss

    def adc_seq_eval(self) -> float:
        d = self.cfg.DATASET
        fs = self.mesh.world
        hori, vert = self._streams(fs), self._streams(fs)
        encode = make_adc_sequence_encoder(
            self.state.model, d.numGroupFrames, radar_params=self.rp,
            num_frames=d.numFrames, mesh=self.mesh)
        return self._sequence(encode, [hori, vert])


def _stage_line(t_start: float, msg: str) -> None:
    print(f"[dryrun +{time.time() - t_start:6.1f}s] {msg}", flush=True)


def _launch_counts() -> dict:
    """The attention kernels' launches in this process, by mode."""
    return {"attention_fwd": dict(attention.attention_fwd.launches_by_mode),
            "attention_bwd": dict(attention.attention_bwd.launches_by_mode)}


def run_mini_epoch(mesh: Mesh, root: str, t_start: float,
                   budget: float) -> dict:
    """MiniEpoch's stages in the JAX dryrun's order, each announced by a
    stage line and the optional ones gated on the budget left. Returns
    the losses, the stages skipped and the kernel launches."""
    def stage(msg):
        _stage_line(t_start, msg)

    def gate(name) -> bool:
        left = multihost.broadcast_scalar(budget - (time.time() - t_start))
        if left < GATES[name]:
            print(f"[dryrun] SKIPPED {name} (remaining budget {left:.0f}s "
                  f"< {GATES[name]}s)", flush=True)
            skipped.append(name)
            return False
        return True

    n, skipped, losses = mesh.world, [], {}
    stage(f"mesh ready: {n} x {mesh.device.type} ranks "
          f"({dist.get_backend() if mesh.parallel else 'no group'}), "
          f"budget {budget:.0f}s")
    epoch = MiniEpoch(mesh)
    d = epoch.cfg.DATASET
    stage(f"model init done (numFilters={epoch.cfg.MODEL.numFilters}, "
          f"{d.rangeSize}x{d.azimuthSize} spatial)")
    losses["train"] = epoch.train()
    stage(f"{len(losses['train'])} DP train steps OK (losses "
          f"{['%.4f' % v for v in losses['train']]}, incl. padded "
          f"remainder)")
    losses["eval"] = epoch.eval()
    stage(f"sharded eval step OK (loss={losses['eval']:.4f})")
    saved_epoch, losses["resume"] = epoch.checkpoint(root)
    stage(f"checkpoint save/load/resume OK (epoch={saved_epoch}, "
          f"loss={losses['resume']:.4f})")
    if gate("sharded e2e serving"):
        f = epoch.serving()
        stage(f"sharded e2e serving OK ({f} frames over {n} ranks)")
    if gate("sharded sequence eval"):
        losses["seq_eval"] = epoch.seq_eval()
        stage(f"sharded sequence eval OK (loss={losses['seq_eval']:.4f})")
    if gate("sharded chunk-train step"):
        losses["chunk"] = epoch.chunk()
        stage(f"sharded chunk-train step OK (loss={losses['chunk']:.4f})")
    if gate("sharded ADC chunk-train step"):
        losses["adc_chunk"] = epoch.adc_chunk()
        stage(f"sharded ADC chunk-train step OK "
              f"(loss={losses['adc_chunk']:.4f})")
        if gate("sharded ADC sequence eval"):
            losses["adc_seq_eval"] = epoch.adc_seq_eval()
            stage(f"sharded ADC sequence eval OK "
                  f"(loss={losses['adc_seq_eval']:.4f})")
    return {"rank": mesh.rank, "device": str(mesh.device), "losses": losses,
            "skipped": skipped, "launches": _launch_counts()}


# ------------------------------------------------- the flagship shapes

def _spec(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


class _ShapePass:
    """The programs of flagship_shapes on one rank, on meta tensors."""

    def __init__(self, mesh: Mesh, serve_frames: int):
        self.mesh, self.serve_frames = mesh, serve_frames
        self.cfg = flagship_training_config()
        self.model, self.tx = self._build(self.cfg)
        d = self.cfg.DATASET
        self.geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        self.spatial = (d.numGroupFrames, d.numFrames, 2, d.rangeSize,
                        d.azimuthSize, d.elevationSize)
        self.rp = RadarParams()
        self.samples = 2 * self.rp.num_rx * self.rp.num_chirp \
            * self.rp.num_adc_samples
        self.maps = None

    @staticmethod
    def _build(cfg):
        with torch.device("meta"):
            model = build_model(cfg, device="meta")
        return model, make_optimizer(cfg, model)

    @staticmethod
    def meta(*shape, dtype=torch.float32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="meta")

    def _batch(self, rows: int) -> dict:
        return {"hori": self.meta(rows, *self.spatial),
                "vert": self.meta(rows, *self.spatial),
                "jointsGroup": self.meta(rows, 14, 2)}

    def _step_out(self, step, model, tx, batch) -> dict:
        _, metrics = step(TrainState(model, tx), batch, LR, 0.0)
        out = {k: _spec(v) for k, v in metrics.items()}
        out.update({f"state.{k}": _spec(v)
                    for k, v in model.state_dict().items()})
        return out

    def train(self):
        """The classic step, TRAINING.batchSize padded to the world."""
        block, _ = shard_batch(self._batch(self.cfg.TRAINING.batchSize),
                               self.mesh)
        step = make_train_step(self.model, self.tx, geometry=self.geometry,
                               mesh=self.mesh)
        return self._step_out(step, self.model, self.tx, block)

    def max_train(self):
        """The max recipe's step (batch 128, bfloat16, MODEL.remat)."""
        cfg = max_training_config()
        model, tx = self._build(cfg)
        block, _ = shard_batch(self._batch(cfg.TRAINING.batchSize),
                               self.mesh)
        step = make_train_step(model, tx, geometry=self.geometry,
                               mesh=self.mesh)
        return self._step_out(step, model, tx, block)

    def eval(self):
        """The eval step at TEST.batchSize, made the whole batch's."""
        block, _ = shard_batch(self._batch(self.cfg.TEST.batchSize),
                               self.mesh)
        out = _sharded_eval(make_eval_step(self.model,
                                           geometry=self.geometry),
                            TrainState(self.model, self.tx), block,
                            self.mesh)
        return {k: _spec(v) for k, v in out.items()}

    def serve(self):
        """make_e2e_infer(mesh=) on one request of serve_frames frames."""
        d = self.cfg.DATASET
        serve = make_e2e_infer(self.model, None, self.rp,
                               duration=self.serve_frames,
                               group=d.numGroupFrames,
                               num_frames=d.numFrames, mesh=self.mesh)
        adc = self.meta(self.serve_frames, self.rp.num_rx,
                        self.rp.num_chirp, self.rp.num_adc_samples)
        pred2d, maxvals = serve(adc, adc, adc, adc)
        return {"pred2d": _spec(pred2d), "maxvals": _spec(maxvals)}

    def _encode(self, encode, views) -> dict:
        """One DATASET.duration-frame sequence (this rank's frame block of
        each view) through `encode`, padded to whole TEST.batchSize window
        batches."""
        f, b = self.cfg.DATASET.duration, self.cfg.TEST.batchSize
        lo, hi = frame_block(f, self.mesh)
        self.model.eval()
        with torch.inference_mode(), float32_math():
            ra, re_m = encode(*(view(hi - lo) for view in views),
                              -(-f // b) * b)
        self.maps = ra
        return {"ra_pad": _spec(ra), "re_pad": _spec(re_m)}

    def seq_encode(self):
        d = self.cfg.DATASET

        def view(frames):
            plane = self.meta(frames, d.numFrames, d.rangeSize,
                              d.azimuthSize, d.elevationSize)
            return plane, plane

        return self._encode(make_sequence_encoder(
            self.model, d.numGroupFrames, mesh=self.mesh), [view, view])

    def adc_seq_encode(self):
        d = self.cfg.DATASET

        def view(frames):
            return self.meta(frames, self.samples, dtype=torch.int16)

        return self._encode(make_adc_sequence_encoder(
            self.model, d.numGroupFrames, radar_params=self.rp,
            num_frames=d.numFrames, mesh=self.mesh), [view, view])

    def seq_window(self):
        """The window step at TEST.batchSize on the encoded sequence."""
        d = self.cfg.DATASET
        b = self.cfg.TEST.batchSize
        if self.maps is None:
            self.seq_encode()
        first, last = frame_block(b, self.mesh)
        step = make_window_eval_step(self.model, d.numGroupFrames,
                                     self.geometry, batch_size=b,
                                     mesh=self.mesh)
        with torch.inference_mode(), float32_math():
            out = step(self.maps, self.maps, self.meta(last - first, 14, 2),
                       self.meta(last - first), 0)
        return {k: _spec(v) for k, v in out.items()}

    def _chunk(self, payload, dtype, step):
        """The chunk step at TRAINING.batchSize windows: rows and the frame
        union each padded to a multiple of the world, this rank's
        blocks."""
        w, b = self.mesh.world, self.cfg.TRAINING.batchSize
        g = self.cfg.DATASET.numGroupFrames
        rows_pad = b + (-b) % w
        f_pad = (b + g - 1) + (-(b + g - 1)) % w
        frames = self.meta(f_pad // w, *payload, dtype=dtype)
        batch = {"hori": frames, "vert": frames,
                 "rel": self.meta(rows_pad // w, g, dtype=torch.int32),
                 "jointsGroup": self.meta(rows_pad // w, 14, 2),
                 "mask": self.meta(rows_pad // w)}
        return self._step_out(step, self.model, self.tx, batch)

    def chunk_train(self):
        return self._chunk(self.spatial[1:], torch.float32,
                           make_chunk_train_step(self.model, self.tx,
                                                 self.geometry,
                                                 mesh=self.mesh))

    def adc_chunk_train(self):
        return self._chunk((self.samples,), torch.int16,
                           make_adc_chunk_train_step(
                               self.model, self.tx, self.geometry,
                               mesh=self.mesh, radar_params=self.rp,
                               num_frames=self.cfg.DATASET.numFrames))


def flagship_shapes(rank: int, world: int = SHAPE_WORLD, programs=PROGRAMS,
                    serve_frames: int = 32) -> dict:
    """{program: {output: (shape, dtype)}} of the sharded programs at the
    flagship geometry (flagship_training_config(): numFilters 32, 64x64
    maps, MODEL.attention pallas, batch 20, TEST.batchSize 32, 600-frame
    sequences; default RadarParams) on rank `rank` of a `world`-rank
    group: the inputs are meta tensors, the group torch's fake backend, the
    attention ops their shape functions (meta_stands_for_card), so every
    shape, block, pad, halo table and collective runs and no arithmetic
    does. The train programs' outputs include the model's state after the
    step ("state.<key>"). Programs: the classic train step (batch padded to
    the world) and eval step, serving one serve_frames-frame request,
    sequence eval (the encoder over one sequence, the window step), the
    chunk and raw-ADC chunk train steps, the max recipe's step, the raw-ADC
    sequence encoder. Raises what the programs raise (frame_block's
    ValueError for frames the world does not divide). Makes and destroys
    the default process group: the caller must have none."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("flagship_shapes makes the fake process group; "
                           "this process already has a group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        with kernels.meta_stands_for_card():
            runs = _ShapePass(Mesh(rank, world, torch.device("meta")),
                              serve_frames)
            return {name: getattr(runs, name)() for name in programs}
    finally:
        dist.destroy_process_group()


def check_flagship_shapes(shapes: dict) -> str:
    """Raise unless the shape pass's ranks agree and each program's global
    outputs have the flagship's shapes; a summary line."""
    first = next(iter(shapes.values()))
    for rank, got in shapes.items():
        if got != first:
            raise AssertionError(f"flagship shapes: rank {rank} differs")
    cfg = flagship_training_config()
    d = cfg.DATASET
    b, h, fc = cfg.TEST.batchSize, d.heatmapSize, cfg.MODEL.numFilters
    pad = -(-d.duration // b) * b + d.numGroupFrames - 1
    want = {("eval", "pred2d"): (b, 14, 2), ("eval", "predHeatmap"):
            (b, 14, h, h), ("serve", "pred2d"): (32, 14, 2),
            ("seq_encode", "ra_pad"): (pad, d.rangeSize, d.azimuthSize, fc),
            ("adc_seq_encode", "re_pad"): (pad, d.rangeSize, d.azimuthSize,
                                           fc),
            ("seq_window", "maxvals"): (b, 14, 1)}
    for prog in ("train", "chunk_train", "adc_chunk_train", "max_train"):
        want[(prog, "loss")] = ()
    bad = {k: first[k[0]][k[1]][0] for k, v in want.items()
           if first[k[0]][k[1]][0] != v}
    if bad:
        raise AssertionError(f"flagship shapes: {bad}, expected "
                             f"{ {k: want[k] for k in bad} }")
    return (f"64x64/F={fc} at world {SHAPE_WORLD}, ranks "
            f"{', '.join(map(str, shapes))}: train batch "
            f"{cfg.TRAINING.batchSize} padded, eval {b}, serving 32 frames, "
            f"sequence {d.duration} -> {pad}, chunk and ADC chunk, max "
            f"batch 128")


# ---------------------------------------------------------- the command

def _rank_kind(world: int, device) -> str:
    """'cpu' (gloo on the CPU), 'nccl' (a card a rank) or 'gloo' (ranks
    sharing the cards)."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"dryrun_multichip runs on the card or the CPU, "
                         f"not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def _start_ranks(world: int, kind: str, root: str, t_start: float,
                 budget: float) -> tuple:
    """Start the rank processes; a thread per rank keeps its output's tail
    and echoes rank 0's. Returns (processes, tails, threads)."""
    cards = torch.cuda.device_count() if kind != "cpu" else 1
    procs, tails, threads = [], [], []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank % cards),
               "PYTHONPATH": os.pathsep.join(
                   [_REPO, os.environ.get("PYTHONPATH", "")])}
        if kind == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-m", "hupr_tpu_torch.graft_entry",
             "--rank", root, kind, repr(t_start), repr(budget)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_REPO))
        tails.append(collections.deque(maxlen=60))

        def pump(proc=procs[-1], tail=tails[-1], echo=rank == 0):
            for line in proc.stdout:
                tail.append(line)
                if echo:
                    sys.stdout.write(line)
                    sys.stdout.flush()

        threads.append(threading.Thread(target=pump, daemon=True))
        threads[-1].start()
    return procs, tails, threads


def _join_ranks(procs, tails, threads, deadline: float) -> None:
    """Wait for every rank; on a rank's failure, or at `deadline`, kill
    them all and raise with every rank's tail."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > deadline
            if failed or late:
                break
            if all(c == 0 for c in codes):
                for t in threads:
                    t.join()
                return
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    for t in threads:
        t.join(timeout=30)
    what = f"rank(s) {failed} exited {codes}" if failed else \
        f"ranks did not finish in time (exit codes {codes})"
    raise RuntimeError(f"dryrun_multichip: {what}\n" + "\n".join(
        f"---- rank {r}:\n{''.join(tail)}" for r, tail in enumerate(tails)))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The mini epoch over `n_devices` ranks (module docstring), then the
    flagship shape pass in this process (which must hold no process group)
    at world SHAPE_WORLD, ranks SHAPE_RANKS. Raises on any failed stage or
    rank. Returns {"world", "backend", "ranks": each rank's losses,
    skipped stages and kernel launches, "skipped": the stages skipped for
    the budget, "seconds"}."""
    t_start = time.time()
    budget = float(os.environ.get("HUPR_DRYRUN_BUDGET", "420"))
    kind = _rank_kind(n_devices, device)
    with tempfile.TemporaryDirectory(prefix="hupr_dryrun_") as root:
        procs, tails, threads = _start_ranks(n_devices, kind, root, t_start,
                                             budget)
        _join_ranks(procs, tails, threads, time.monotonic()
                    + max(budget - (time.time() - t_start), 0.0) + GRACE_S)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(root, f"rank{r}.json")) as fp:
                ranks.append(json.load(fp))
    skipped = list(ranks[0]["skipped"])
    left = budget - (time.time() - t_start)
    if left < GATES["flagship shape pass"]:
        print(f"[dryrun] SKIPPED flagship shape pass (remaining budget "
              f"{left:.0f}s < {GATES['flagship shape pass']}s)", flush=True)
        skipped.append("flagship shape pass")
    else:
        summary = check_flagship_shapes(
            {r: flagship_shapes(r) for r in SHAPE_RANKS})
        _stage_line(t_start, f"flagship shape pass OK ({summary})")
    _stage_line(t_start, f"dryrun_multichip({n_devices}) PASSED")
    return {"world": n_devices,
            "backend": "nccl" if kind == "nccl" else "gloo",
            "ranks": ranks, "skipped": skipped,
            "seconds": time.time() - t_start}


def _rank_main(argv) -> int:
    """A rank of dryrun_multichip: `--rank root kind t_start budget`, RANK,
    WORLD_SIZE and LOCAL_RANK in the environment. Joins the group through
    root/rendezvous, runs the mini epoch, writes root/rank<r>.json."""
    root, kind, t_start, budget = argv
    cpu = kind == "cpu"
    if cpu:
        torch.set_num_threads(1)
    multihost.initialize(device="cpu" if cpu else None,
                         backend="nccl" if kind == "nccl" else "gloo",
                         init_method="file://"
                         + os.path.join(root, "rendezvous"))
    try:
        mesh = make_mesh("cpu" if cpu else None)
        multihost.warmup_device_collectives(mesh)
        result = run_mini_epoch(mesh, root, float(t_start), float(budget))
        with open(os.path.join(root, f"rank{mesh.rank}.json"), "w") as fp:
            json.dump(result, fp)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:
        return _rank_main(argv[1:])
    n = int(os.environ.get("HUPR_DRYRUN_N", "8"))
    dryrun_multichip(n, device="cpu" if "--cpu" in argv else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
