"""Residual conv blocks (counterpart of `hupr_tpu/models/blocks.py`;
reference BasicBlock2D / BasicBlock3D, layers.py:8-70), NCHW / NCDHW.

    out = act( main(x) + downsample(x) )
    main = Conv3x3 (-BN) -act- Conv3x3 (-BN),  downsample = Conv3x3 (-BN)

Child names follow the reference so the state_dict keys are its keys.
BatchNorm is torch's own, as in the reference: in eval mode (serving) it
normalizes with the running statistics; in train mode with the biased batch
variance, while it moves the running variance by the unbiased one at
momentum 0.1, the JAX package's TorchBatchNorm semantics.

A compute dtype (`compute_dtype`, flax's `dtype`): parameters stay float32,
and each conv casts its input, weight and bias to it at use, so a bfloat16
model runs bfloat16 convolutions whose gradients land on float32 weights.
PReLU casts its slope to the input's dtype, as the JAX package does. BN keeps
float32 parameters and statistics and returns the input's dtype; torch's
own BN normalizes a bfloat16 input in float32 and rounds once, where the JAX
package rounds after each of its four elementwise steps (the tests bound the
difference).

Under MODEL.remat (models/hupr.py) a checkpointed module's forward runs a
second time in the backward. torch's train-mode BN would then move its
running statistics and `num_batches_tracked` twice, where flax's remat is
functional and moves them once. So the BN here is `BatchNorm2d` /
`BatchNorm3d`, which inside `recomputing()` normalizes with the batch
statistics as before but writes its running-statistics update into
throwaway copies: the rebuilt forward is the same call on the same values,
and the buffers keep the first forward's update alone.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from hupr_tpu_torch.ops.resize import scale_by_factor


class _CastConv:
    """ConvNd whose forward runs in `compute_dtype` (in float32, `.to` hands
    back the same tensors and this is the plain conv)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


class PReLU(nn.PReLU):
    """nn.PReLU with its float32 slope cast to the input's dtype."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The recompute of a checkpointed forward, in this thread (the card's
    backward runs on autograd's own thread, which enters this context
    around the recompute: torch.utils.checkpoint's `context_fn`)."""
    before = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = before


class _RecomputeAwareBN:
    """BatchNormNd that leaves its buffers alone inside `recomputing()`."""

    def forward(self, x):
        if not (self.training and getattr(_RECOMPUTE, "active", False)):
            return super().forward(x)
        # the first forward's call (batch statistics, momentum) on copies
        # of the buffers: the same saved tensors, the same output
        return F.batch_norm(x, self.running_mean.clone(),
                            self.running_var.clone(), self.weight, self.bias,
                            True, self.momentum, self.eps)


class BatchNorm2d(_RecomputeAwareBN, nn.BatchNorm2d):
    pass


class BatchNorm3d(_RecomputeAwareBN, nn.BatchNorm3d):
    pass


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, ndim: int,
                 batchnorm: bool = True, activation: str = "relu",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        conv = {2: Conv2d, 3: Conv3d}[ndim]
        norm = {2: BatchNorm2d, 3: BatchNorm3d}[ndim]
        act = {"relu": nn.ReLU, "prelu": PReLU}[activation]

        def c3(cin, cout):
            return conv(cin, cout, 3, 1, 1, bias=False,
                        compute_dtype=compute_dtype)

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
