"""PRGCN pose-refinement GCN (counterpart of `hupr_tpu/models/prgcn.py`;
reference gcn_networks.py).

Heatmap logits (B, K, H, W) -> bilinear x0.5 -> node features (B, P, K) with
P = (H/2)^2 nodes in row-major (h, w) order -> 3 GCN layers
out = W @ (x @ A) + b with ReLU between -> bilinear x2 -> sigmoid.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from hupr_tpu_torch.ops.resize import scale_by_factor

# skeleton over the HuPR joint order (RHip, RKnee, RAnkle, LHip, LKnee,
# LAnkle, Neck, Head, LShoulder, LElbow, LWrist, RShoulder, RElbow, RWrist):
# self-loops plus kinematic edges
_EDGES = [
    (0, 1), (1, 2),            # right leg
    (3, 4), (4, 5),            # left leg
    (0, 3),                    # hips
    (6, 7),                    # neck-head
    (8, 9), (9, 10),           # left arm
    (11, 12), (12, 13),        # right arm
]
# the reference matrix is asymmetric at the shoulder-neck joints: the
# shoulder rows mark the neck column, the neck row marks no shoulder
_DIRECTED = [(8, 6), (11, 6)]


def skeleton_adjacency() -> np.ndarray:
    a = np.eye(14, dtype=np.float32)
    for i, j in _EDGES:
        a[i, j] = 1.0
        a[j, i] = 1.0
    for i, j in _DIRECTED:
        a[i, j] = 1.0
    return a


class GCNLayer(nn.Module):
    """out = W @ (x @ A) + b on x (B, P, K); uniform(+-1/sqrt(P)) init."""

    def __init__(self, features: int, num_keypoints: int):
        super().__init__()
        bound = 1.0 / math.sqrt(features)
        self.weight = nn.Parameter(
            torch.empty(features, features).uniform_(-bound, bound))
        self.bias = nn.Parameter(
            torch.empty(features, num_keypoints).uniform_(-bound, bound))

    def forward(self, x, adj):
        return torch.matmul(self.weight, torch.matmul(x, adj)) + self.bias


class PRGCN(nn.Module):
    def __init__(self, heatmap_size: int, num_keypoints: int):
        super().__init__()
        feat = (heatmap_size // 2) ** 2
        self.L1 = GCNLayer(feat, num_keypoints)
        self.L2 = GCNLayer(feat, num_keypoints)
        self.L3 = GCNLayer(feat, num_keypoints)
        # a constant of the model, not a weight: kept out of the state_dict
        self.register_buffer("adj", torch.from_numpy(skeleton_adjacency()),
                             persistent=False)

    def forward(self, logits):
        """(B, K, H, W) logits -> (B, K, H, W) refined heatmap."""
        x = scale_by_factor(logits, 0.5)                 # (B, K, h, w)
        b, k, h, w = x.shape
        x = x.reshape(b, k, h * w).transpose(1, 2)       # (B, P, K)
        x = torch.relu(self.L1(x, self.adj))
        x = torch.relu(self.L2(x, self.adj))
        x = self.L3(x, self.adj)
        x = x.transpose(1, 2).reshape(b, k, h, w)
        return torch.sigmoid(scale_by_factor(x, 2.0))
