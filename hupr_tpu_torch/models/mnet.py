"""MNet chirp encoder (counterpart of `hupr_tpu/models/mnet.py`; reference
chirp_networks.py:11-21): Conv3d kernel and stride (2, 1, 1) over the chirp
axis, then a max over what is left of it (in the compute dtype)."""

from __future__ import annotations

import torch
from torch import nn

from hupr_tpu_torch.models.blocks import Conv3d


class MNet(nn.Module):
    def __init__(self, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temporalConvWx1x1 = Conv3d(2, out_channels, (2, 1, 1), (2, 1, 1),
                                        compute_dtype=compute_dtype)

    def forward(self, x):
        """(B*, 2, numFrames, R, A) -> (B*, F, R, A)."""
        return self.temporalConvWx1x1(x).amax(dim=2)
