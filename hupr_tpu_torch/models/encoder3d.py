"""Encoder3D (counterpart of `hupr_tpu/models/encoder3d.py`; reference
layers.py:186-217), NCDHW.

Three 3-D conv stages at (G, H, W), (G/2, H/2, W/2) and (G/4, H/4, W/4) with
trilinear align-corners halving between them, and per-stage temporal-merge
convs with kernel (T, 1, 1) that squeeze the frame axis into 2-D maps.
"""

from __future__ import annotations

from torch import nn

from hupr_tpu_torch.models.blocks import BasicBlock, Rescale


class Encoder3D(nn.Module):
    def __init__(self, num_filters: int, num_group_frames: int):
        super().__init__()
        f, g = num_filters, num_group_frames

        def bb(cin, cout):
            return BasicBlock(cin, cout, ndim=3)

        self.layer1 = nn.Sequential(nn.Conv3d(f, f * 2, 3, 1, 1),
                                    bb(f * 2, f * 2))
        self.layer2 = nn.Sequential(Rescale(0.5), bb(f * 2, f * 4),
                                    bb(f * 4, f * 4))
        self.layer3 = nn.Sequential(Rescale(0.5), bb(f * 4, f * 8),
                                    bb(f * 8, f * 8))
        self.l1temporalMerge = nn.Conv3d(f * 2, f * 2, (g, 1, 1), bias=False)
        self.l2temporalMerge = nn.Conv3d(f * 4, f * 4, (g // 2, 1, 1),
                                         bias=False)
        self.temporalMerge = nn.Conv3d(f * 8, f * 8, (g // 4, 1, 1),
                                       bias=False)

    def forward(self, x):
        """(B, F, G, H, W) -> maps (B, 2F, H, W), (B, 4F, H/2, W/2),
        (B, 8F, H/4, W/4)."""
        l1 = self.layer1(x)
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        return (self.l1temporalMerge(l1)[:, :, 0],
                self.l2temporalMerge(l2)[:, :, 0],
                self.temporalMerge(l3)[:, :, 0])
