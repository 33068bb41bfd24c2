"""Where the reference rounds the operands of its products.

`Precision("float32")` is the flagship recipe: every product in float32,
TF32 off. `Precision("bfloat16")` is the fast recipe: convolutions,
projections and the attention's inputs in bfloat16, as MODEL.computeDtype
bfloat16 runs them, and the rest float32. `lower=True` is the control, one
notch below the precision the configuration states: float32 products take
operands rounded to TF32 (10 mantissa bits, as a TF32 tensor core reads
them), bfloat16 products operands rounded to float8 e4m3.
"""

from __future__ import annotations

import contextlib

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (ties to even).
    Under autograd the gradient passes through unrounded: the control
    rounds the forward's operands."""
    x = x.to(torch.float32)
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    rounded = i.view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Values rounded to float8 e4m3 and back to x's dtype."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


class Precision:
    def __init__(self, compute: str = "float32", lower: bool = False):
        if compute not in DTYPES:
            raise ValueError(f"compute dtype {compute!r}: expected one of "
                             f"{sorted(DTYPES)}")
        self.dtype = DTYPES[compute]
        self.lower = lower

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product in the compute dtype."""
        x = x.to(self.dtype)
        if not self.lower:
            return x
        return round_tf32(x) if self.dtype == torch.float32 else round_fp8(x)

    def f32_operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product that every recipe keeps in float32 (the
        PRGCN, the attention's softmax): TF32 under the float32 control."""
        x = x.to(torch.float32)
        if self.lower and self.dtype == torch.float32:
            return round_tf32(x)
        return x

    def soft_operand(self, a: torch.Tensor) -> torch.Tensor:
        """The attention's float32 softmax as the second product's operand:
        float32 in both recipes, the lower format under the control."""
        if not self.lower:
            return a
        return round_tf32(a) if self.dtype == torch.float32 else \
            round_fp8(a.to(torch.bfloat16)).to(torch.float32)


@contextlib.contextmanager
def full_float32():
    """TF32 off in cuDNN and cuBLAS, and no reduced-precision bfloat16
    reductions, for the duration."""
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
