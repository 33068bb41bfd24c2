"""Linear resize with align_corners=True (counterpart of
`hupr_tpu/ops/resize.py`; the reference's nn.Upsample / F.interpolate)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_MODES = {3: "linear", 4: "bilinear", 5: "trilinear"}


def scale_by_factor(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Resize every spatial axis of an N, C, *spatial tensor by `factor`,
    output size floor(in * factor) as nn.Upsample(scale_factor=...) gives,
    source coordinate i * (in - 1) / (out - 1). A bfloat16 input comes out
    float32, as the JAX package's product with its float32 interpolation
    matrix promotes it: the resize runs on the exact float32 values."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    size = [int(math.floor(s * factor)) for s in x.shape[2:]]
    return F.interpolate(x, size=size, mode=_MODES[x.dim()],
                         align_corners=True)
