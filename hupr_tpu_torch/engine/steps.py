"""Train and eval steps (counterpart of `hupr_tpu/engine/steps.py`): the
per-batch work of the reference (tools/run.py:65-86, misc/losses.py:23-45)
on the card.

  batch (raw radar windows + joints) -> per-plane normalize -> HuPRNet ->
  Gaussian targets -> BCE(main) + BCE(GCN) -> backward -> torch.optim Adam
  or SGD at the learning rate the caller passes for this step.

The optimizers are the reference's own: torch Adam applies the weight decay
into the gradient (not decoupled), as the JAX package's optax chain
reproduces (tests/test_optimizer.py). The learning rate is written into the
param groups on every step, as the reference mutates it
(tools/base.py:66-72).

With a mesh of more than one rank (parallel.make_mesh) the train step is
data parallel: BN syncs its statistics over the real rows of every rank,
the loss divides by the global real count, and one flat all_reduce sums
the gradients and the metrics (the psum XLA inserts under the JAX
package's mesh), rather than DDP: one step function serves both world
sizes, and DDP's hooks would meet the non-reentrant checkpoint's
recompute under MODEL.remat.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from hupr_tpu_torch.models.blocks import synced_batch_stats
from hupr_tpu_torch.ops.heatmap import (bce_loss, generate_target_batch,
                                        get_max_preds)
from hupr_tpu_torch.ops.normalize import normalize_radar_window
from hupr_tpu_torch.utils.device import float32_math


@dataclass
class TrainState:
    """What a train step updates in place: the model (weights and BN
    running statistics), its optimizer, and the count of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """TRAINING.optimizer over all of `model`'s parameters in one group."""
    t = cfg.TRAINING
    params = list(model.parameters())
    if t.optimizer == "adam":
        return torch.optim.Adam(params, lr=t.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=t.weightDecay)
    if t.optimizer == "sgd":
        return torch.optim.SGD(params, lr=t.lr, momentum=0.9,
                               weight_decay=t.weightDecay)
    raise ValueError(f"unknown TRAINING.optimizer {t.optimizer!r}")


def _inputs(batch, device):
    """The batch dict on `device`: normalized float32 windows, joints, and
    the (B,) row mask or None. Windows may arrive in any float dtype."""
    def normalized(x):
        return normalize_radar_window(
            torch.as_tensor(x, device=device).to(torch.float32))

    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).reshape(-1)
    return (normalized(batch["hori"]), normalized(batch["vert"]),
            torch.as_tensor(batch["jointsGroup"], device=device), mask)


def _losses(model, hori, vert, joints, mask, geometry, count=None):
    num_keypoints, heatmap_size, img_size = geometry
    heatmap, gcn = model(hori, vert)
    targets, _ = generate_target_batch(
        joints, num_keypoints=num_keypoints, heatmap_size=heatmap_size,
        img_size=img_size)
    k, h = targets.shape[1], targets.shape[2]
    main = heatmap.reshape(-1, k, h, h)
    refined = gcn.reshape(-1, k, h, h)
    return (bce_loss(main, targets, mask, count),
            bce_loss(refined, targets, mask, count), refined, targets)


def _combine(loss1, loss2, alpha, loss_decay):
    """loss1 + loss2, or the annealed blend when TRAINING.lossDecay is set
    (misc/losses.py:36-42)."""
    if loss_decay != -1.0:
        return alpha * loss1 + (1.0 - alpha) * loss2
    return loss1 + loss2


def _real_rows(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the rows whose mask is 1. The rows a data-parallel batch
    is padded with carry 0; the JAX package keeps them out of the train-mode
    BN statistics and the loss mean, which for a 0/1 mask is the same as
    training on the real rows alone (the model mixes no rows but in BN)."""
    if not bool(((mask == 0) | (mask == 1)).all()):
        raise ValueError("batch['mask'] must hold 0 or 1 per row")
    return torch.nonzero(mask, as_tuple=True)[0]


def _global_count(mask: torch.Tensor) -> torch.Tensor:
    """The number of real rows (mask 1) over all ranks, float32 0-d."""
    count = mask.to(torch.float32).sum()
    dist.all_reduce(count)
    return count


def _reduce_gradients(model: nn.Module, metrics) -> list:
    """Sum every parameter's gradient and the float32 `metrics` over all
    ranks in one flat all_reduce (the psum XLA inserts under a mesh): each
    rank's loss is its share of the global batch's mean, so the sum is the
    global gradient. The parameters' .grad become views of the sum.
    Returns the summed metrics."""
    params = list(model.parameters())
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [m.detach().reshape(1) for m in metrics])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return list(flat[offset:].unbind())


def _data_parallel(mesh) -> bool:
    return mesh is not None and mesh.parallel


def make_train_step(model: nn.Module, tx: torch.optim.Optimizer,
                    loss_decay: float = -1.0, geometry=(14, 64, 256),
                    mesh=None):
    """Returns train_step(state, batch, lr, alpha) -> (state, metrics).

    `batch` holds 'hori' and 'vert' (B, G, C, 2, R, A, E) raw windows, numpy
    or torch in any float dtype, 'jointsGroup' (B, K, 2) image-space joints,
    and optionally 'mask' (B,). The caller advances alpha before each step
    (only read when lossDecay != -1). `geometry` = (numKeypoints,
    heatmapSize, imgSize). The forward and backward run in the model's
    compute dtype where it has one and in full float32 elsewhere (TF32 off
    for the call); gradients land on the float32 parameters, and the loss,
    the metrics and the optimizer step are float32. The model runs in train mode for
    the step and returns to its previous mode after it. metrics are 0-d
    tensors on the card, {loss, loss1, loss2}.

    With a `mesh` (parallel.make_mesh) of more than one rank, `batch` is
    this rank's block of the padded global batch, with its 'mask': every
    row runs, BN normalizes over the real rows of every rank
    (models/blocks.synced_batch_stats), each rank divides its masked loss
    sum by the global real count, and the gradients and metrics are
    summed across ranks before the optimizer step, so every rank takes
    the global step and reports the global losses. A rank whose rows are
    all padding joins every collective with zero rows of loss. The
    collectives run in one order on every rank: the count, each BN's
    statistics in the forward, each BN's gradient sums in the backward,
    the gradients. A world of one is the single-card step."""
    dp = _data_parallel(mesh)

    def train_step(state: TrainState, batch, lr, alpha):
        if state.model is not model or state.optimizer is not tx:
            raise ValueError("state holds another model or optimizer than "
                             "this train step was made for")
        device = next(model.parameters()).device
        hori, vert, joints, mask = _inputs(batch, device)
        count = None
        if dp:
            if mask is None:
                mask = torch.ones(hori.shape[0], device=device)
            count = _global_count(mask)
        elif mask is not None:
            rows = _real_rows(mask)
            hori, vert, joints = hori[rows], vert[rows], joints[rows]
            mask = None
        for group in tx.param_groups:
            group["lr"] = lr
        was_training = model.training
        model.train()
        try:
            with float32_math():
                with synced_batch_stats(mask):
                    loss1, loss2, _, _ = _losses(model, hori, vert, joints,
                                                 mask, geometry, count)
                loss = _combine(loss1, loss2, alpha, loss_decay)
                tx.zero_grad(set_to_none=True)
                loss.backward()
                if dp:
                    loss1, loss2, loss = _reduce_gradients(
                        model, (loss1, loss2, loss))
                tx.step()
        finally:
            model.train(was_training)
        state.step += 1
        return state, {"loss": loss.detach(), "loss1": loss1.detach(),
                       "loss2": loss2.detach()}

    return train_step


def make_eval_step(model: nn.Module, loss_decay: float = -1.0,
                   geometry=(14, 64, 256)):
    """Returns eval_step(state, batch, alpha=0.0) -> metrics: the losses
    (masked means when the batch has 'mask'), and from the GCN heatmap
    (the reference decodes preds2, misc/losses.py:43-44) 'pred2d' and
    'maxvals', 'gt2d' decoded from the targets, and 'predHeatmap'. The model
    runs in eval mode, on its running BN statistics, in its compute dtype
    (float32 math elsewhere); the outputs are float32."""

    def eval_step(state: TrainState, batch, alpha=0.0):
        if state.model is not model:
            raise ValueError("state holds another model than this eval "
                             "step was made for")
        device = next(model.parameters()).device
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), float32_math():
                hori, vert, joints, mask = _inputs(batch, device)
                loss1, loss2, refined, targets = _losses(
                    model, hori, vert, joints, mask, geometry)
                pred2d, maxvals = get_max_preds(refined)
                gt2d, _ = get_max_preds(targets)
        finally:
            model.train(was_training)
        return {"loss": _combine(loss1, loss2, alpha, loss_decay),
                "loss1": loss1, "loss2": loss2, "pred2d": pred2d,
                "gt2d": gt2d, "maxvals": maxvals, "predHeatmap": refined}

    return eval_step
