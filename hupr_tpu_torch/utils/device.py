"""Device selection and float32 math for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_math():
    """Full float32 convolutions and matmuls on the card for the duration:
    TF32 off in cuDNN (on by default) and in cuBLAS, restored on exit. The
    port computes in float32 only (build_model refuses other compute
    dtypes), and its parity with the float32 reference assumes this."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def resolve_device(device=None) -> torch.device:
    """The CUDA card unless the caller names a device. With no card and no
    explicit request this raises: entry points never carry on quietly on
    the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
