"""HuPR's training step in plain torch: Gaussian targets (misc/utils.py
generateTarget), BCE on the heatmap and on the refined heatmap
(misc/losses.py), autograd, and Adam with the weight decay added to the
gradient, as torch.optim.Adam applies it."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference import dsp, model
from gpubench.reference.precision import Precision

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def targets(joints: torch.Tensor, num_keypoints: int = 14,
            heatmap: int = 64, img: int = 256) -> torch.Tensor:
    """(B, K, 2) image-space joints -> (B, K, H, W) float32 Gaussians of
    sigma 2 (3 off 64x64 maps), centre value 1, written inside the paste
    window of the published code only, with its int() truncations; a joint
    whose window misses the map gives a zero map."""
    j = joints[..., :2].to(torch.float32)
    sigma = 2.0 if heatmap == 64 else 3.0
    tmp = sigma * 3.0
    mu = torch.trunc(j / (img / heatmap) + 0.5)
    ul = torch.trunc(mu - tmp)
    br = torch.trunc(mu + tmp + 1.0)
    centre = ul + math.floor(tmp + 0.5)
    grid = torch.arange(heatmap, dtype=torch.float32, device=j.device)
    xs, ys = grid[None, :], grid[:, None]
    ux, uy = ul[..., 0, None, None], ul[..., 1, None, None]
    bx, by = br[..., 0, None, None], br[..., 1, None, None]
    g = torch.exp(-((xs - centre[..., 0, None, None]) ** 2
                    + (ys - centre[..., 1, None, None]) ** 2)
                  / (2 * sigma * sigma))
    inside = (xs >= ux) & (xs < bx) & (ys >= uy) & (ys < by)
    hit = ((ul[..., 0] < heatmap) & (ul[..., 1] < heatmap)
           & (br[..., 0] >= 0) & (br[..., 1] >= 0)).to(torch.float32)
    return torch.where(inside, g, torch.zeros_like(g)) * hit[..., None, None]


def losses(P, batch, prec: Precision, num_frames: int = 8):
    """(loss1, loss2) of one batch {'hori', 'vert' (B, G, C, 2, R, A, E)
    raw windows, 'jointsGroup' (B, K, 2)}, in train mode."""
    hori = dsp.normalize_planes(batch["hori"].to(torch.float32))
    vert = dsp.normalize_planes(batch["vert"].to(torch.float32))
    heat, refined = model.forward(P, hori, vert, prec, train=True,
                                  num_frames=num_frames)
    k, h = heat.shape[1], heat.shape[2]
    t = targets(batch["jointsGroup"], k, h)
    return (F.binary_cross_entropy(heat, t),
            F.binary_cross_entropy(refined, t))


def train_steps(state: dict, batches, lr: float, weight_decay: float,
                prec: Precision, num_frames: int = 8, keep=None):
    """Adam steps from `state` (which is not changed), one per batch.
    Returns (losses [(loss1, loss2) per step] as floats, the first step's
    gradient with the weight decay added {name: tensor}, {t: the
    parameters after step t {name: tensor}} for each t in `keep`, by
    default the last step)."""
    P = {k: v.detach().clone() for k, v in state.items()}
    names = [k for k in P if model.is_parameter(k)]
    for k in names:
        P[k].requires_grad_(True)
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    keep = (len(batches),) if keep is None else tuple(keep)
    out, first, kept = [], None, {}
    for t, batch in enumerate(batches, start=1):
        loss1, loss2 = losses(P, batch, prec, num_frames)
        grads = torch.autograd.grad(loss1 + loss2, [P[k] for k in names])
        out.append((loss1.item(), loss2.item()))
        with torch.no_grad():
            step = {}
            for k, g in zip(names, grads):
                g = g + weight_decay * P[k]
                step[k] = g
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                m_hat = m[k] / (1 - BETAS[0] ** t)
                v_hat = v[k] / (1 - BETAS[1] ** t)
                P[k].sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
            if first is None:
                first = step
            if t in keep:
                kept[t] = {k: P[k].detach().clone() for k in names}
        del grads
    return out, first, kept
