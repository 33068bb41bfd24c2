"""Gaussian target heatmaps, argmax decoding and the BCE loss (counterpart
of `hupr_tpu/ops/heatmap.py`).

  generate_target      the reference's generateTarget (misc/utils.py:6-65),
                       evaluated densely over the map for every joint at
                       once, on whatever device the joints are on
  get_max_preds        misc/metrics.py:10-38
  bce_loss             nn.BCELoss on probabilities (misc/losses.py:22,47-48),
                       optionally a mean over unpadded rows
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generate_target(joints: torch.Tensor, num_keypoints: int,
                    heatmap_size: int, img_size: int, is_coord: bool = False,
                    sigmas=None):
    """joints (..., K, 2) image-space coordinates -> (target (..., K, H, W),
    peak (..., K, 2)), float32, on the joints' device.

    sigma = 2 on 64x64 maps, else 3; `sigmas` gives one per joint (x10, the
    reference's scale) and `is_coord` reads joints as [0, 1) coordinates.
    The unnormalized Gaussian (centre value 1) is written inside the
    reference's paste window only. Its quirks are kept: int() truncates
    toward zero (not floor) for mu, ul and br; the centre sits at
    ul + floor(3 sigma + 0.5), so a fractional 3 sigma gives an asymmetric
    window; a joint whose window misses the map is skipped whole, peak
    zeroed."""
    joints = joints[..., :2].to(torch.float32)
    dev = joints.device
    if sigmas is not None:
        sigma = torch.as_tensor(sigmas, dtype=torch.float32,
                                device=dev).reshape(-1) * 10.0
    else:
        sigma = torch.full((num_keypoints,), 2.0 if heatmap_size == 64
                           else 3.0, device=dev)
    tmp = sigma * 3.0                                       # (K,)
    if is_coord:
        mu = torch.trunc(joints * heatmap_size)
    else:
        mu = torch.trunc(joints / (img_size / heatmap_size) + 0.5)
    ul = torch.trunc(mu - tmp[:, None])                     # (..., K, 2)
    br = torch.trunc(mu + tmp[:, None] + 1.0)
    center = ul + torch.floor(tmp + 0.5)[:, None]

    grid = torch.arange(heatmap_size, dtype=torch.float32, device=dev)
    xs, ys = grid[None, :], grid[:, None]                   # (1, W), (H, 1)

    def at(t, axis):
        return t[..., axis, None, None]                     # (..., K, 1, 1)

    dx, dy = xs - at(center, 0), ys - at(center, 1)
    s = sigma[:, None, None]
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2.0 * s * s))
    inside = ((xs >= at(ul, 0)) & (xs < at(br, 0))
              & (ys >= at(ul, 1)) & (ys < at(br, 1)))
    in_bounds = ((ul[..., 0] < heatmap_size) & (ul[..., 1] < heatmap_size)
                 & (br[..., 0] >= 0) & (br[..., 1] >= 0)).to(torch.float32)
    target = torch.where(inside, g, torch.zeros_like(g))
    return target * in_bounds[..., None, None], mu * in_bounds[..., None]


def generate_target_batch(joints: torch.Tensor, num_keypoints: int = 14,
                          heatmap_size: int = 64, img_size: int = 256):
    """(B, K, 2) -> ((B, K, H, W), (B, K, 2)): the reference's per-sample
    target loop (misc/losses.py:27-30) as one batched evaluation."""
    return generate_target(joints, num_keypoints, heatmap_size, img_size)


def get_max_preds(batch_heatmaps: torch.Tensor):
    """(B, K, H, W) -> (preds (B, K, 2) xy, maxvals (B, K, 1)).

    Argmax over the flattened map (first maximum on ties); x = idx % W,
    y = idx // W; coordinates are zeroed where the peak is <= 0."""
    b, k, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, k, h * w)
    idx = flat.argmax(dim=2)
    maxvals = flat.amax(dim=2)[..., None]
    x = (idx % w).to(torch.float32)
    y = torch.floor(idx.to(torch.float32) / w)
    preds = torch.stack([x, y], dim=-1)
    return preds * (maxvals > 0.0).to(torch.float32), maxvals


def bce_loss(probs: torch.Tensor, targets: torch.Tensor,
             sample_mask: torch.Tensor | None = None,
             count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean BCE on probabilities with nn.BCELoss's numerics: each log
    clamped at -100, and the input gradient's p(1-p) denominator clamped at
    1e-12, so saturated probabilities give large but finite gradients. With
    `sample_mask` (B,) the mean runs over the samples whose mask is 1 only:
    the rows a data-parallel batch is padded with carry 0. `count` replaces
    the mask's sum as the number of real samples: data parallel, each rank
    divides its masked sum by the global count, so the ranks' losses add up
    to the global batch's mean (hupr_tpu/ops/heatmap.py:135-146 under a
    mesh)."""
    elems = F.binary_cross_entropy(probs, targets, reduction="none")
    if sample_mask is None:
        return elems.mean()
    w = sample_mask.to(elems.dtype).reshape((-1,) + (1,) * (elems.dim() - 1))
    inner = math.prod(elems.shape[1:])
    if count is None:
        count = sample_mask.to(elems.dtype).sum()
    return (elems * w).sum() / (count * inner)
