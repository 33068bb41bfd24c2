"""Heatmap argmax decoding (counterpart of `hupr_tpu/ops/heatmap.py`
get_max_preds; reference misc/metrics.py:10-38)."""

from __future__ import annotations

import torch


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
