"""The Encoder3Ds' float32 3x3x3 convolution: the Hopper kernel's wrapper,
its custom op, its plain version and the rule that sends a conv to it.

`conv3d_3x3x3(x, weight, bias)` is F.conv3d(x, weight, bias, padding=1)
for a (Cout, Cin, 3, 3, 3) kernel at stride 1, in float32. On the card it
launches csrc/conv3d_fprop.cu, an implicit GEMM on the tensor cores in
3xTF32 (float32's accuracy, as the float32 attention kernels take it:
csrc/tf32.cuh); it replaces no TPU kernel (XLA ran these convolutions), and
takes the place of cuDNN's float32 FFMA kernels, which TF32 off
(utils/device.float32_math) leaves them. On the CPU the op's kernel is the
plain version, F.conv3d itself. Like the attention kernels it is a
torch.library custom op, `hupr_tpu_torch::conv3d_3x3x3`, so that
torch.export keeps it as one node (engine/export.py) and the flagship shape
pass reaches its fake kernel (attention.meta_stands_for_card).

`takes_kernel` is the rule models/blocks.Conv3d follows, by what the call
shows and nothing else: a float32 3x3x3 conv at stride 1, padding 1,
dilation 1, one group, zero padding; whose gradient nobody needs (autograd
off, as under the inference_mode of serving, streaming and sequence eval,
or no input that requires grad); at shapes the kernel is built for: Cin a
multiple of 8, Cout of 64, W in (8, 16, 32, 64); and with a grid of at least
MIN_BLOCKS blocks. Everything else stays F.conv3d (cuDNN on the card): the
bfloat16 recipes, the (T, 1, 1) temporal merges, MNet's (2, 1, 1) convs,
every conv of a train step, and the small grids of the deeper convs at the
stream's B = 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from hupr_tpu_torch.ops import attention
from hupr_tpu_torch.ops.cuda_build import load_library
from hupr_tpu_torch.utils import profiling

KERNEL_WIDTHS = (8, 16, 32, 64)
CIN_MULTIPLE = 8          # input channels a stage of the kernel
COUT_MULTIPLE = 64        # output channels a block of the kernel
BLOCK_VOXELS = 256        # output voxels a block: 2 depths x 128 / W rows x W
# The least grid the rule sends to the kernel. One block runs a whole K, so a
# small grid leaves most of the card's SMs idle where cuDNN splits the work
# finer. On the H100 SXM (132 SMs) at B = 1: 128 blocks (Cin 32, 64) took
# 0.063 and 0.113 ms against cuDNN's 0.105 and 0.182; 32 blocks 0.107 and
# 0.206 ms (Cin 64, 128) against 0.183 and 0.144; 8 blocks (Cin 128, 256)
# 0.206 and 0.408 ms against 0.081 and 0.158
MIN_BLOCKS = 64
COUNTER = "hupr.conv3d_tf32x3"
# The card tests' bar: max |kernel - reference| over max |reference|, the
# reference F.conv3d in float64 or in float32 with TF32 off. A torch model of
# the kernel's 3xTF32 products reads at least ten times under it, one TF32
# product over it (tests/test_torch_conv.py)
REL_TOL = 2.0 ** -16


def conv_plain(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: F.conv3d at stride 1, padding 1, in float32."""
    return F.conv3d(x, weight, bias, padding=1)


def _shape_fits(x_shape, weight_shape) -> bool:
    """Whether the kernel is built for input (B, Cin, D, H, W) and weight
    (Cout, Cin, 3, 3, 3)."""
    if len(x_shape) != 5 or len(weight_shape) != 5:
        return False
    cin, w = x_shape[1], x_shape[4]
    cout = weight_shape[0]
    return (tuple(weight_shape[1:]) == (cin, 3, 3, 3)
            and cin % CIN_MULTIPLE == 0 and cout % COUT_MULTIPLE == 0
            and cout > 0 and w in KERNEL_WIDTHS)


def grid_blocks(x_shape, cout: int) -> int:
    """Blocks of the kernel's grid for input (B, Cin, D, H, W) and `cout`
    output channels (csrc/conv3d_fprop.cu: 2 depths x BLOCK_VOXELS / (2 W)
    rows x 64 channels a block)."""
    b, _, d, h, w = x_shape
    rows = BLOCK_VOXELS // (2 * w)
    return b * -(-d // 2) * -(-h // rows) * (cout // COUT_MULTIPLE)


def takes_kernel(conv, x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> bool:
    """Whether Conv3d module `conv`, called on `x` with `weight` and `bias`
    in its compute dtype, goes to the op (the rule in the module
    docstring)."""
    return (tuple(conv.kernel_size) == (3, 3, 3)
            and x.dtype == weight.dtype == torch.float32
            and (bias is None or bias.dtype == torch.float32)
            and tuple(conv.stride) == (1, 1, 1)
            and tuple(conv.padding) == (1, 1, 1)
            and tuple(conv.dilation) == (1, 1, 1)
            and conv.groups == 1 and conv.padding_mode == "zeros"
            and not (torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, weight, bias)))
            and _shape_fits(x.shape, weight.shape)
            and grid_blocks(x.shape, weight.shape[0]) >= MIN_BLOCKS)


def _check(x, weight, bias, device_types=("cuda",)) -> None:
    """Raise unless the kernel takes these tensors: float32, contiguous, on
    one device of a type in `device_types`, of shapes it is built for."""
    tensors = {"x": x, "weight": weight}
    if bias is not None:
        tensors["bias"] = bias
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"conv3d_3x3x3 inputs on different devices: "
                         f"{devices}")
    device = devices.pop()
    if device.type not in device_types:
        raise ValueError(f"conv3d_3x3x3 runs on CUDA or CPU, not {device}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"conv3d_3x3x3 takes float32; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv3d_3x3x3 takes contiguous tensors; {name} "
                             f"is not")
    if not _shape_fits(x.shape, weight.shape):
        raise ValueError(
            f"conv3d_3x3x3 is built for x (B, Cin, D, H, W) with Cin a "
            f"multiple of {CIN_MULTIPLE}, W in {KERNEL_WIDTHS}, and weight "
            f"(Cout, Cin, 3, 3, 3) with Cout a multiple of {COUT_MULTIPLE}; "
            f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"conv3d_3x3x3: bias has shape {tuple(bias.shape)}, "
                         f"expected ({weight.shape[0]},)")


@functools.cache
def _kernel():
    """The ctypes function of csrc/conv3d_fprop.cu: x, weight, bias, out,
    then b, cin, cout, depth, height, width, then the stream."""
    fn = load_library("conv3d_fprop").hupr_conv3d_fprop
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it on a 16-byte boundary (cp.async's copies)."""
    return t.clone() if t.data_ptr() % 16 else t


def _conv_cuda(x, weight, bias):
    _check(x, weight, bias)
    b, cin, d, h, w = x.shape
    cout = weight.shape[0]
    out = x.new_empty((b, cout, d, h, w))
    x, weight = _aligned(x), _aligned(weight)
    err = _kernel()(x.data_ptr(), weight.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), b, cin, cout, d, h, w,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3d_3x3x3 kernel launch failed with CUDA "
                           f"error {err}")
    conv3d_3x3x3.launches += 1
    profiling.count(COUNTER)
    return out


def _conv_fake(x, weight, bias):
    """Shapes and dtypes; off the CPU, held to what the CUDA kernel takes
    (a meta tensor stands for the card's within
    attention.meta_stands_for_card)."""
    if x.device.type != "cpu":
        _check(x, weight, bias, device_types=(
            ("cuda", "meta") if attention._meta_as_card else ("cuda",)))
    return x.new_empty((x.shape[0], weight.shape[0], *x.shape[2:]))


_conv_op = torch.library.custom_op(
    f"{attention.NAMESPACE}::conv3d_3x3x3", conv_plain, mutates_args=(),
    device_types="cpu",
    schema="(Tensor x, Tensor weight, Tensor? bias) -> Tensor")
_conv_op.register_kernel("cuda", _conv_cuda)
_conv_op.register_fake(_conv_fake)


def conv3d_3x3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """F.conv3d(x, weight, bias, padding=1) for a (Cout, Cin, 3, 3, 3)
    float32 kernel. The op hupr_tpu_torch::conv3d_3x3x3: CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream
    (counted in `conv3d_3x3x3.launches` and, while a profiler records, the
    counter hupr.conv3d_tf32x3), or raise. Forward only: its output records
    no graph, so with autograd recording and an input that requires grad it
    raises (takes_kernel keeps such convs on F.conv3d)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("conv3d_3x3x3 is forward-only: run it under "
                           "torch.inference_mode() or torch.no_grad()")
    return _conv_op(x, weight, bias)


def reset_launch_counts() -> None:
    """Zero the kernel wrapper's launch count."""
    conv3d_3x3x3.launches = 0


reset_launch_counts()
