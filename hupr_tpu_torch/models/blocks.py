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

Data parallel (`synced_batch_stats`, entered by the train steps when the
world has more than one rank): native BN would normalize each rank's rows
by that rank's statistics, and nn.SyncBatchNorm has no row mask (and runs
only on the card). The BN here then normalizes with the mean and variance
over the real rows of the whole padded global batch, reduced in float32
across the ranks, and moves its running statistics once by them, as the
JAX package's TorchBatchNorm does under a mesh. Under MODEL.remat the
recompute reuses the first forward's synced statistics instead of
reducing again; its backward still reduces, once.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hupr_tpu_torch.ops import conv
from hupr_tpu_torch.ops.resize import scale_by_factor
from hupr_tpu_torch.utils import profiling


class _CastConv:
    """ConvNd whose forward runs in `compute_dtype` (in float32, `.to` hands
    back the same tensors and this is the plain conv). A float32 3x3x3
    Conv3d that ops/conv.takes_kernel takes goes to the op
    hupr_tpu_torch::conv3d_3x3x3 (the Hopper kernels on the card, forward
    and gradient; F.conv3d's arithmetic on the CPU), a float32 (k, 1, 1)
    Conv3d of whole windows that trains on the card to ops/conv.WindowConv
    (ops/conv.takes_window); every other conv is F.conv3d."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        x, weight = x.to(dt), self.weight.to(dt)
        if conv.takes_kernel(self, x, weight, bias):
            return conv.conv3d_3x3x3(x.contiguous(), weight, bias)
        if conv.takes_window(self, x, weight, bias):
            return conv.WindowConv.apply(x, weight, bias, self.stride)
        return self._conv_forward(x, weight, bias)


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


class PReLU(nn.PReLU):
    """nn.PReLU with its float32 slope cast to the input's dtype."""

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


_RECOMPUTE = threading.local()
_SYNC = threading.local()


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


@contextlib.contextmanager
def synced_batch_stats(mask: Optional[torch.Tensor]):
    """Data-parallel train-mode BN for the forwards in this thread: every
    BatchNorm2d / BatchNorm3d normalizes with the mean and variance over
    the rows whose `mask` (B,) is 1 on every rank of the default process
    group, and moves its running statistics by them (the unbiased factor
    of the global real count), as BN does over a batch-sharded mesh in
    the JAX package. The forward all-reduces each BN's statistics, the
    backward its two gradient sums. With `mask` None, torch's own BN on
    this rank's rows (a world of one)."""
    before = getattr(_SYNC, "mask", None)
    _SYNC.mask = mask
    try:
        yield
    finally:
        _SYNC.mask = before


def synced_moments(x: torch.Tensor, mask: torch.Tensor) -> tuple:
    """(mean, biased var, count) per channel of `x` (B, C, ...) over the
    rows whose mask is 1 on every rank, in float32. Each rank reduces its
    own rows in two passes (its mean, then its centred squares) and the
    ranks' (count, mean, M2) are combined exactly (Chan et al.), in one
    all_reduce of a (world, 2C + 1) buffer in which each rank fills its
    row: no E[x^2] - E[x]^2 cancellation. A rank with no real row adds
    nothing."""
    world, rank = dist.get_world_size(), dist.get_rank()
    c = x.shape[1]
    axes = [0] + list(range(2, x.dim()))
    xf = x.to(torch.float32)
    w = mask.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
    inner = xf[0, 0].numel()
    n = mask.to(torch.float32).sum() * inner
    mean = (xf * w).sum(axes) / n.clamp(min=1.0)
    m2 = (torch.square(xf - mean.reshape((1, c) + (1,) * (x.dim() - 2)))
          * w).sum(axes)
    buf = xf.new_zeros((world, 2 * c + 1))
    buf[rank] = torch.cat([n.reshape(1), mean, m2])
    profiling.count("hupr.collectives")
    dist.all_reduce(buf)
    counts, means, m2s = buf[:, :1], buf[:, 1:c + 1], buf[:, c + 1:]
    total = counts.sum()
    g_mean = (counts * means).sum(0) / total
    g_m2 = m2s.sum(0) + (counts * torch.square(means - g_mean)).sum(0)
    return g_mean, g_m2 / total, total


class _SyncedBatchNorm(torch.autograd.Function):
    """y = (x - mean) * invstd * weight + bias with mean and invstd the
    synced statistics over the real rows of every rank. Its backward
    all-reduces sum(dy) and sum(dy * xhat) per channel: d mean / dx and
    d var / dx are nonzero only on real rows, but every row's output
    depends on the statistics. weight and bias get this rank's sums (the
    train step sums parameter gradients across ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mask, mean, invstd, count):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x.to(torch.float32) - mean.reshape(shape)) \
            * invstd.reshape(shape)
        ctx.save_for_backward(x, weight, mask, mean, invstd, count)
        return (xhat * weight.reshape(shape) + bias.reshape(shape)).to(
            x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mask, mean, invstd, count = ctx.saved_tensors
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = [0] + list(range(2, x.dim()))
        dyf = dy.to(torch.float32)
        xhat = (x.to(torch.float32) - mean.reshape(shape)) \
            * invstd.reshape(shape)
        sum_dy = dyf.sum(axes)
        sum_dy_xhat = (dyf * xhat).sum(axes)
        both = torch.cat([sum_dy, sum_dy_xhat])
        profiling.count("hupr.collectives")
        dist.all_reduce(both)
        g_dy, g_dy_xhat = both.chunk(2)
        w = mask.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
        dx = (weight * invstd).reshape(shape) * (
            dyf - w * (g_dy.reshape(shape) + xhat * g_dy_xhat.reshape(shape))
            / count)
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None, None, None


class _RecomputeAwareBN:
    """BatchNormNd that leaves its buffers alone inside `recomputing()`
    and syncs its statistics inside `synced_batch_stats()`."""

    _synced = None      # (mask, mean, invstd, count) of the last forward

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if getattr(_RECOMPUTE, "active", False):
            if self._synced is not None:
                # the first forward's synced statistics: no second reduce,
                # and the same saved tensors
                return _SyncedBatchNorm.apply(x, self.weight, self.bias,
                                              *self._synced)
            # the first forward's call (batch statistics, momentum) on
            # copies of the buffers: the same saved tensors, the same output
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        mask = getattr(_SYNC, "mask", None)
        if mask is None:
            self._synced = None
            return super().forward(x)
        with torch.no_grad():
            mean, var, count = synced_moments(x, mask)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(
                m * var * count / (count - 1.0).clamp(min=1.0))
            self.num_batches_tracked.add_(1)
            invstd = torch.rsqrt(var + self.eps)
        self._synced = (mask, mean, invstd, count)
        return _SyncedBatchNorm.apply(x, self.weight, self.bias,
                                      *self._synced)


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
