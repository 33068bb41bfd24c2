"""Seeded synthetic HuPRNet weights (counterpart of
`hupr_tpu/utils/synthetic.py`), drawn with numpy on the host.

Every floating-point entry of the state_dict is N(0, scale), except the
BatchNorm running variances, which are drawn POSITIVE (|x| + 1): a plain
normal draw makes half of them negative, and 1/sqrt(var + eps) then fills
the whole forward with NaNs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def synthetic_state_dict(model: nn.Module, seed: int = 0,
                         scale: float = 0.05) -> dict:
    """A state_dict with `model`'s keys, shapes and dtypes, drawn from a
    numpy generator seeded with `seed`, on the CPU."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in model.state_dict().items():
        if not ref.is_floating_point():
            out[key] = torch.zeros_like(ref, device="cpu")
            continue
        x = rng.standard_normal(tuple(ref.shape)).astype(np.float32) * scale
        if key.endswith("running_var"):
            x = np.abs(x) + 1.0
        out[key] = torch.from_numpy(x)
    return out


def synthetic_train_batch(cfg, batch_size: int, device,
                          seed: int = 0) -> dict:
    """A train batch of `cfg`'s geometry drawn on `device` from `seed`, as
    bench.py draws its batch: N(0, 1) raw windows per view, joints uniform
    in (20, 230)."""
    ds = cfg.DATASET
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (batch_size, ds.numGroupFrames, ds.numFrames, 2, ds.rangeSize,
             ds.azimuthSize, ds.elevationSize)
    return {"hori": torch.randn(shape, generator=gen, device=device),
            "vert": torch.randn(shape, generator=gen, device=device),
            "jointsGroup": 20 + 210 * torch.rand(
                (batch_size, ds.numKeypoints, 2), generator=gen,
                device=device, dtype=torch.float64)}
