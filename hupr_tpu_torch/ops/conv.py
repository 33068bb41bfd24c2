"""The Encoder3Ds' float32 3x3x3 convolution: the Hopper kernels' wrappers,
the custom op with its gradient, their plain versions and the rules that
send a conv and each of its passes to them.

`conv3d_3x3x3(x, weight, bias)` is F.conv3d(x, weight, bias, padding=1)
for a (Cout, Cin, 3, 3, 3) kernel at stride 1, in float32. On the card it
launches csrc/conv3d_fprop.cu, an implicit GEMM on the tensor cores' wgmma
in 3xTF32 (float32's accuracy, as the float32 attention kernels take it:
csrc/tf32.cuh), after a small launch that packs the weight's hi and lo tf32
terms into the layout the kernel stages (a workspace of the call); it
replaces no TPU kernel (XLA ran these convolutions), and
takes the place of cuDNN's float32 FFMA kernels, which TF32 off
(utils/device.float32_math) leaves them. On the CPU the op's kernel is the
plain version, F.conv3d itself. Like the attention kernels it is a custom
op of ops/kernels, `hupr_tpu_torch::conv3d_3x3x3`, so that torch.export
keeps it as one node (engine/export.py) and the flagship shape pass
reaches its fake kernel (kernels.meta_stands_for_card).

Its gradient (`_backward`), given the output gradient dY, takes each pass
where that pass's own rule sends it: dX is the forward kernel run on dY
with the weight flipped in its three spatial axes and its channel axes
swapped (`dgrad_takes`), dW the weight-gradient kernel csrc/conv3d_wgrad.cu
(`conv3d_wgrad`, `wgrad_takes`), db the sum of dY; a pass its rule refuses
is aten's convolution_backward (cuDNN). Off the card every pass is aten's,
so the CPU's gradients are F.conv3d's bit for bit.

`takes_kernel` is the rule models/blocks.Conv3d follows, by what the call
shows and nothing else: a float32 3x3x3 conv at stride 1, padding 1,
dilation 1, one group, zero padding; at shapes the kernel is built for: Cin
a multiple of 8, Cout of 64, W in (8, 16, 32, 64); and with a grid of at
least MIN_BLOCKS blocks (`fprop_takes`), whether or not its gradient is
needed. Everything else stays F.conv3d (cuDNN on the card): the bfloat16
recipes, the (T, 1, 1) temporal merges, MNet's (2, 1, 1) convs, and the
small grids of the 16x16 convs at the stream's B = 1 (8 tiles) and of one
input gradient at data parallel training's 5 rows a card (20 tiles).

`takes_window` is a second rule, for training on the card: a float32 conv
of kernel (k, 1, 1) whose windows along the depth neither overlap nor
leave a gap (stride k, or one window over the whole depth) and whose
gradient is needed: MNet's (2, 1, 1) convs at stride 2 and the Encoder3Ds'
(T, 1, 1) temporal merges. Its forward stays F.conv3d (cuDNN); its
gradients (`WindowConv`) are one matrix product each over the windows'
(channel, tap) pairs, where cuDNN's float32 weight gradient for MNet's
conv took 40 ms a call at batch 20 (its direct kernel at 0.02 TFLOP/s).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from hupr_tpu_torch.ops import kernels

KERNEL_WIDTHS = (8, 16, 32, 64)
CIN_MULTIPLE = 8          # input channels: a stage of the forward kernel,
                          # the least block of the weight gradient's
COUT_MULTIPLE = 64        # output channels a block of either kernel
# The forward kernel's tile (csrc/conv3d_fprop.cu): FPROP_VOXELS output
# voxels, 2 depths x FPROP_VOXELS / (2 W) rows x W, by COUT_MULTIPLE channels
FPROP_VOXELS = 256
# The weight-gradient kernel's voxel tile (csrc/conv3d_wgrad.cu): 2 depths x
# WGRAD_VOXELS / (2 W) rows x W, the unit its splits share out; a block of
# it owns WGRAD_CIN input channels (x 27 taps) by COUT_MULTIPLE output ones
WGRAD_VOXELS = 256
WGRAD_CIN = 16
# The least grid (tiles of the forward kernel) the rule sends to the forward
# kernel. One tile runs a whole K on one SM, so a small grid leaves most of
# the card's SMs idle where cuDNN splits the work finer. On the H100 SXM
# (132 SMs), the wgmma body against cuDNN's: 32 tiles (Cin 64, 128 at
# 32x32, B = 1) 0.064 and 0.120 ms against 0.176 and 0.139; 40 tiles (Cin
# 128, 256 at 16x16, B = 5) 0.129 and 0.253 against 0.218 and 0.431; 16
# tiles (B = 2) 0.127 and 0.243 against 0.084 and 0.159; 8 tiles (B = 1)
# 0.124 and 0.243 against 0.078 and 0.153
MIN_BLOCKS = 32
# The least grid the weight-gradient kernel takes (wgrad_takes). On the H100
# SXM the wgmma body beats cuDNN at every Encoder3D shape at B = 1, down to
# the least of their grids, 64 blocks (128 -> 256 at 16x16: 0.032 ms against
# 0.069); smaller grids are not measured
WGRAD_MIN_BLOCKS = 64
# Waves of one block an SM that the weight-gradient kernel's grid fills
# (wgrad_split). One block an SM over all its tiles pays the pipeline's fill
# and the epilogue once: a train step's 32 weight gradients on the H100 SXM
# took 19.70 ms at one wave, 20.12 at two, 21.42 at four (B = 20), and 5.44,
# 6.03 and 6.88 ms at B = 5
WGRAD_WAVES = 1
# The weight-gradient kernel's body, the mode its launches are counted
# under (conv3d_wgrad.launches_by_mode): warpgroup wgmma in 3xTF32
WGRAD_MODE = "wgmma"
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


def voxel_tiles(x_shape, voxels: int) -> int:
    """Tiles of 2 depths x `voxels` / (2 W) rows x W columns that cover the
    output of input (B, Cin, D, H, W), each in one batch element."""
    b, _, d, h, w = x_shape
    rows = voxels // (2 * w)
    return b * -(-d // 2) * -(-h // rows)


def grid_blocks(x_shape, cout: int) -> int:
    """Blocks of the forward kernel's grid for input (B, Cin, D, H, W) and
    `cout` output channels (csrc/conv3d_fprop.cu: a tile of FPROP_VOXELS
    voxels by COUT_MULTIPLE channels a block)."""
    return voxel_tiles(x_shape, FPROP_VOXELS) * (cout // COUT_MULTIPLE)


def fprop_takes(x_shape, cout: int) -> bool:
    """Whether the forward kernel takes input (B, Cin, D, H, W) to `cout`
    channels: shapes it is built for, a grid of MIN_BLOCKS or more."""
    return (_shape_fits(x_shape, (cout, x_shape[1], 3, 3, 3))
            and grid_blocks(x_shape, cout) >= MIN_BLOCKS)


def dgrad_takes(x_shape, cout: int) -> bool:
    """Whether the input gradient of that conv goes to the forward kernel:
    run on the output gradient (B, cout, D, H, W) to Cin channels, so Cin
    has to be a multiple of COUT_MULTIPLE (not the Encoder3D's first conv,
    32 -> 64)."""
    return fprop_takes((x_shape[0], cout, *x_shape[2:]), x_shape[1])


def wgrad_chunks(cin: int, cout: int) -> int:
    """Blocks of the weight-gradient kernel a split of the voxels: one for
    each WGRAD_CIN input channels (the last may hold 8) and COUT_MULTIPLE
    output channels."""
    return -(-cin // WGRAD_CIN) * (cout // COUT_MULTIPLE)


def wgrad_split(x_shape, cout: int, sms: int) -> tuple:
    """(tiles a block, splits) of the weight-gradient kernel for input (B,
    Cin, D, H, W) and `cout` channels on a card of `sms` SMs: its grid has
    wgrad_chunks blocks in each split of the voxel tiles (voxel_tiles of
    WGRAD_VOXELS), and the splits are as many as fit WGRAD_WAVES x `sms`
    blocks, and at least one."""
    tiles = voxel_tiles(x_shape, WGRAD_VOXELS)
    fit = max(1, WGRAD_WAVES * sms // wgrad_chunks(x_shape[1], cout))
    per = -(-tiles // fit)
    return per, -(-tiles // per)


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The SMs of the card `device` names, which wgrad_split fills."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgrad_takes(x_shape, cout: int) -> bool:
    """Whether the weight gradient of that conv goes to its kernel: shapes
    it is built for (those of the forward), and a grid that can have
    WGRAD_MIN_BLOCKS blocks."""
    cin = x_shape[1]
    return (_shape_fits(x_shape, (cout, cin, 3, 3, 3))
            and voxel_tiles(x_shape, WGRAD_VOXELS) * wgrad_chunks(cin, cout)
            >= WGRAD_MIN_BLOCKS)


def routes(x_shape, cout: int) -> dict:
    """{pass: True where it takes a kernel} for the conv of input (B, Cin,
    D, H, W) to `cout` channels that takes_kernel sends to the op."""
    return {"fprop": fprop_takes(x_shape, cout),
            "dgrad": dgrad_takes(x_shape, cout),
            "wgrad": wgrad_takes(x_shape, cout)}


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
            and tuple(weight.shape[1:]) == (x.shape[1], 3, 3, 3)
            and fprop_takes(x.shape, weight.shape[0]))


def _check(tensors: dict, x_shape, weight_shape,
           device_types=kernels.CARD) -> None:
    """Raise unless the kernels take `tensors` ({name: tensor}):
    kernels.check's rules in float32, for a conv of input `x_shape` and
    weight `weight_shape` of shapes they are built for, with a bias of
    Cout values and an output gradient of the output's shape."""
    kernels.check("conv3d_3x3x3", tensors, (torch.float32,), device_types)
    if not _shape_fits(x_shape, weight_shape):
        raise ValueError(
            f"conv3d_3x3x3 is built for x (B, Cin, D, H, W) with Cin a "
            f"multiple of {CIN_MULTIPLE}, W in {KERNEL_WIDTHS}, and weight "
            f"(Cout, Cin, 3, 3, 3) with Cout a multiple of {COUT_MULTIPLE}; "
            f"got {tuple(x_shape)} and {tuple(weight_shape)}")
    cout = weight_shape[0]
    bias, dy = tensors.get("bias"), tensors.get("dy")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3d_3x3x3: bias has shape {tuple(bias.shape)}, "
                         f"expected ({cout},)")
    out_shape = (x_shape[0], cout, *x_shape[2:])
    if dy is not None and tuple(dy.shape) != out_shape:
        raise ValueError(f"conv3d_3x3x3: dy has shape {tuple(dy.shape)}, "
                         f"expected {out_shape}")


@functools.cache
def _packed_floats(cin: int, cout: int) -> int:
    """Floats of the workspace in which the forward kernel's launch packs a
    (cout, cin, 3, 3, 3) weight (csrc/conv3d_fprop.cu, pack_weights)."""
    return kernels.bind("conv3d_fprop", "hupr_conv3d_fprop_packed_bytes",
                        (kernels.INT,) * 2, kernels.INT64)(cin, cout) // 4


def _conv_cuda(x, weight, bias):
    """csrc/conv3d_fprop.cu on x, weight, bias and the packed weights'
    workspace, into out, for b, cin, cout, d, h, w."""
    b, cin, d, h, w = x.shape
    cout = weight.shape[0]
    out = x.new_empty((b, cout, d, h, w))
    packed = x.new_empty((_packed_floats(cin, cout),))
    kernels.launch(conv3d_3x3x3, "conv3d_fprop",
                   (kernels.aligned(x), weight, bias, packed, out),
                   (b, cin, cout, d, h, w))
    return out


_conv_op = kernels.op(
    "conv3d_3x3x3", "(Tensor x, Tensor weight, Tensor? bias) -> Tensor",
    conv_plain, _conv_cuda,
    lambda x, weight, bias: x.new_empty(
        (x.shape[0], weight.shape[0], *x.shape[2:])),
    lambda op, t, device_types: _check(t, t["x"].shape, t["weight"].shape,
                                       device_types))


@kernels.counted
def conv3d_3x3x3(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """F.conv3d(x, weight, bias, padding=1) for a (Cout, Cin, 3, 3, 3)
    float32 kernel. The op hupr_tpu_torch::conv3d_3x3x3: CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream
    (counted in `conv3d_3x3x3.launches`), or raise. Where autograd records,
    its gradient is `_backward`'s."""
    return _conv_op(x, weight, bias)


def conv_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The plain version of the weight gradient: F.conv3d's at stride 1,
    padding 1, for input `x` and output gradient `dy`."""
    return torch.nn.grad.conv3d_weight(
        x, (dy.shape[1], x.shape[1], 3, 3, 3), dy, padding=1)


@kernels.counted
def conv3d_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient (Cout, Cin, 3, 3, 3) of conv3d_3x3x3 at input `x`
    (B, Cin, D, H, W) and output gradient `dy` (B, Cout, D, H, W). CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream (counted in `conv3d_wgrad.launches`), or raise."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return conv_wgrad_plain(x, dy)
    _check({"x": x, "dy": dy}, x.shape, (dy.shape[1], x.shape[1], 3, 3, 3))
    return _wgrad_cuda(x, dy)


def _wgrad_cuda(x, dy):
    """csrc/conv3d_wgrad.cu on x, dy and a workspace, for b, cin, cout, d,
    h, w and the tiles a block (wgrad_split): each split's partial sums,
    which torch's sum adds in a fixed order: the same bits every call."""
    b, cin, d, h, w = x.shape
    cout = dy.shape[1]
    per, splits = wgrad_split(x.shape, cout, _sm_count(x.device))
    part = x.new_empty((splits, cout, cin, 3, 3, 3))
    kernels.launch(conv3d_wgrad, "conv3d_wgrad",
                   (kernels.aligned(x), kernels.aligned(dy), part),
                   (b, cin, cout, d, h, w, per), mode=WGRAD_MODE)
    return part[0] if splits == 1 else part.sum(0)


def dgrad_weight(weight: torch.Tensor) -> torch.Tensor:
    """The forward kernel's weight for the input gradient: `weight` flipped
    in its three spatial axes, its channel axes swapped, (Cin, Cout, 3, 3,
    3). A 3x3x3 conv at stride 1 and padding 1 of the output gradient with
    it is the gradient of the input."""
    return weight.flip((2, 3, 4)).transpose(0, 1).contiguous()


_ONES, _ZEROS = [1, 1, 1], [0, 0, 0]


def _aten_backward(dy, x, weight, bias_sizes, mask):
    """aten's convolution_backward of conv3d_3x3x3, as F.conv3d's autograd
    calls it: (dx, dw, db), each None where `mask` leaves it out."""
    return torch.ops.aten.convolution_backward(
        dy, x, weight, bias_sizes, _ONES, _ONES, _ONES, False, _ZEROS, 1,
        mask)


def _setup_context(ctx, inputs, output):
    x, weight, bias = inputs
    ctx.save_for_backward(x, weight)
    ctx.bias_sizes = None if bias is None else list(bias.shape)


def _backward(ctx, dy):
    """dX, dW and db of the op. On the card each pass takes its kernel
    where its own rule in `routes` holds (dgrad_takes: the forward kernel
    on dy with dgrad_weight; wgrad_takes: conv3d_wgrad) and aten's
    convolution_backward (cuDNN) where it does not; db is dy's sum. Off the
    card all three are aten's, as F.conv3d's autograd computes them."""
    x, weight = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad
    if dy.device.type != "cuda":
        return _aten_backward(dy, x, weight, ctx.bias_sizes,
                              [need_x, need_w, need_b])
    dy = dy.contiguous()
    route = routes(x.shape, weight.shape[0])
    kernel_x = need_x and route["dgrad"]
    kernel_w = need_w and route["wgrad"]
    aten_x, aten_w = need_x and not kernel_x, need_w and not kernel_w
    dx = dw = None
    if aten_x or aten_w:
        dx, dw, _ = _aten_backward(dy, x, weight, None,
                                   [aten_x, aten_w, False])
    if kernel_x:
        dx = _conv_op(dy, dgrad_weight(weight), None)
    if kernel_w:
        dw = conv3d_wgrad(x, dy)
    db = dy.sum((0, 2, 3, 4)) if need_b else None
    return dx, dw, db


_conv_op.register_autograd(_backward, setup_context=_setup_context)


def takes_window(conv, x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> bool:
    """Whether Conv3d module `conv`, called on `x` with `weight` and `bias`
    in its compute dtype, goes to WindowConv (the rule in the module
    docstring)."""
    k = conv.kernel_size[0]
    return (tuple(conv.kernel_size[1:]) == (1, 1)
            and x.device.type == "cuda" and x.dim() == 5
            and x.dtype == weight.dtype == torch.float32
            and (bias is None or bias.dtype == torch.float32)
            and torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (x, weight, bias))
            and tuple(conv.stride[1:]) == (1, 1)
            and (conv.stride[0] == k or x.shape[2] == k)
            and x.shape[2] % k == 0
            and tuple(conv.padding) == (0, 0, 0)
            and tuple(conv.dilation) == (1, 1, 1)
            and conv.groups == 1 and conv.padding_mode == "zeros")


class WindowConv(torch.autograd.Function):
    """F.conv3d(x, weight, bias, stride) for a (Cout, Cin, k, 1, 1) weight
    whose windows tile the depth (takes_window), with gradients that are
    matrix products over each window's Cin x k values: y[b, o, d, p] =
    sum_{c, t} w[o, c, t] x[b, c, d k + t, p] + bias[o], so dW = sum_{b, d,
    p} dY x and dX = W^T dY."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, bias, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        b, c, d, h, w = x.shape
        o, k = weight.shape[0], weight.shape[2]
        g = dy.reshape(b, o, d // k, h * w)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.einsum("oct,bodp->bcdtp", weight.reshape(o, c, k),
                              g).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.einsum("bodp,bcdtp->oct", g, x.reshape(
                b, c, d // k, k, h * w)).reshape(weight.shape)
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 2, 3, 4))
        return dx, dw, db, None

