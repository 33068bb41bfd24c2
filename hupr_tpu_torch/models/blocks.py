"""Residual conv blocks (counterpart of `hupr_tpu/models/blocks.py`;
reference BasicBlock2D / BasicBlock3D, layers.py:8-70), NCHW / NCDHW.

    out = act( main(x) + downsample(x) )
    main = Conv3x3 (-BN) -act- Conv3x3 (-BN),  downsample = Conv3x3 (-BN)

Child names follow the reference so the state_dict keys are its keys.
Serving runs BatchNorm in eval mode, on the running statistics.
"""

from __future__ import annotations

from torch import nn

from hupr_tpu_torch.ops.resize import scale_by_factor


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, ndim: int,
                 batchnorm: bool = True, activation: str = "relu"):
        super().__init__()
        conv = {2: nn.Conv2d, 3: nn.Conv3d}[ndim]
        norm = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[ndim]
        act = {"relu": nn.ReLU, "prelu": nn.PReLU}[activation]

        def c3(cin, cout):
            return conv(cin, cout, 3, 1, 1, bias=False)

        if batchnorm:
            self.main = nn.Sequential(
                c3(in_channels, out_channels), norm(out_channels), act(),
                c3(out_channels, out_channels), norm(out_channels))
            self.downsample = nn.Sequential(c3(in_channels, out_channels),
                                            norm(out_channels))
        else:
            self.main = nn.Sequential(c3(in_channels, out_channels), act(),
                                      c3(out_channels, out_channels))
            self.downsample = nn.Sequential(c3(in_channels, out_channels))
        self.relu = act()

    def forward(self, x):
        return self.relu(self.main(x) + self.downsample(x))


class Rescale(nn.Module):
    """nn.Upsample(scale_factor, align_corners=True) stand-in holding no
    parameters, so it keeps the reference's Sequential indices."""

    def __init__(self, factor: float):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return scale_by_factor(x, self.factor)
