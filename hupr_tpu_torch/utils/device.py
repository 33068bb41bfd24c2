"""Device selection and float32 math for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_math():
    """Full float32 convolutions and matmuls, and float32 accumulation in
    bfloat16 matmuls, on the card for the duration: TF32 off in cuDNN (on
    by default) and in cuBLAS, and cuBLAS's reduced-precision bfloat16
    reduction off; restored on exit. The float32 parts of a model, which
    a bfloat16 compute dtype keeps too (the PRGCN, the resizes), and the
    port's parity with the JAX package assume this."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


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
