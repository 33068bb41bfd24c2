"""The Encoder3Ds' float32 3x3x3 convolution op (hupr_tpu_torch/ops/conv.py)
on the CPU: which convs go to it and which of their passes take a kernel,
its CPU and fake kernels and its gradients against F.conv3d at the
Encoder3D shapes, and torch models of the card kernels' 3xTF32 arithmetic
(the forward's, and the weight gradient's in its split and summation order)
against float64, which set the card tests' bar
(tests/test_torch_cuda.py)."""

import collections
import contextlib
import importlib.util
import os
import types

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from hupr_tpu_torch.models.blocks import BasicBlock, Conv2d, Conv3d
from hupr_tpu_torch.models.encoder3d import Encoder3D
from hupr_tpu_torch.models.hupr import HuPRNet
from hupr_tpu_torch.models.mnet import MNet
from hupr_tpu_torch.ops import conv, kernels

torch.set_num_threads(2)

# (input shape at B = 1, output channels, bias) of each 3x3x3 conv of an
# Encoder3D at the flagship widths (numFilters 32, 64x64 maps, 8 frames)
ENCODER_CONVS = [((1, 32, 8, 64, 64), 64, True),
                 ((1, 64, 8, 64, 64), 64, False),
                 ((1, 64, 4, 32, 32), 128, False),
                 ((1, 128, 4, 32, 32), 128, False),
                 ((1, 128, 2, 16, 16), 256, False),
                 ((1, 256, 2, 16, 16), 256, False)]
H100_SMS = 132   # the H100 SXM's SMs, which the weight-gradient split fills


def _draw(shape, cout, bias, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen)
    w = torch.randn((cout, shape[1], 3, 3, 3), generator=gen) \
        / (27 * shape[1]) ** 0.5
    b = torch.randn((cout,), generator=gen) if bias else None
    return x, w, b


@contextlib.contextmanager
def _counting(monkeypatch):
    """Count the convs that models/blocks sends to the op."""
    calls = []
    op = conv.conv3d_3x3x3

    def counted(x, weight, bias=None):
        calls.append((tuple(x.shape), tuple(weight.shape)))
        return op(x, weight, bias)

    monkeypatch.setattr(conv, "conv3d_3x3x3", counted)
    yield calls


# ------------------------------------------------------- the dispatch rule

def _x(cin=32, w=16, dtype=torch.float32):
    """A small map at a batch whose grid fills conv.MIN_BLOCKS (64 blocks
    at 64 output channels and W <= 16, 32 at W = 32)."""
    return torch.zeros((64, cin, 2, 4, w), dtype=dtype)


@pytest.mark.parametrize("make,x,grad,want", [
    # the Encoder3D's 3x3x3 convs, autograd off: the op
    (lambda: Conv3d(32, 64, 3, 1, 1), _x(), False, True),
    (lambda: Conv3d(64, 128, 3, 1, 1, bias=False), _x(64, 32), False, True),
    (lambda: Conv3d(256, 256, 3, 1, 1, bias=False), _x(256, 8), False, True),
    (lambda: Conv3d(32, 64, 3, 1, 1), _x(w=64), False, True),
    # their gradient is needed: the op too (its gradient is the op's)
    (lambda: Conv3d(32, 64, 3, 1, 1), _x(), True, True),
    (lambda: Conv3d(64, 128, 3, 1, 1, bias=False), _x(64, 32), True, True),
    # bfloat16 compute dtype: F.conv3d
    (lambda: Conv3d(32, 64, 3, 1, 1, compute_dtype=torch.bfloat16), _x(),
     False, False),
    # the temporal merges and MNet's convs
    (lambda: Conv3d(64, 64, (8, 1, 1), bias=False), _x(64), False, False),
    (lambda: Conv3d(2, 32, (2, 1, 1), (2, 1, 1)), _x(2), False, False),
    # shapes the kernel is not built for
    (lambda: Conv3d(4, 64, 3, 1, 1), _x(4), False, False),
    (lambda: Conv3d(32, 32, 3, 1, 1), _x(), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 1), _x(w=24), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 1), _x(w=128), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 1), _x(w=4), False, False),
    # other strides, paddings, dilations, groups, padding modes
    (lambda: Conv3d(32, 64, 3, 2, 1), _x(), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 0), _x(), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 2, dilation=2), _x(), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 1, groups=2), _x(), False, False),
    (lambda: Conv3d(32, 64, 3, 1, 1, padding_mode="reflect"), _x(), False,
     False),
])
def test_takes_kernel(make, x, grad, want):
    """ops/conv.takes_kernel on the module as blocks.Conv3d calls it: the
    weight and bias in the compute dtype, autograd on or off."""
    m = make()
    dt = m.compute_dtype
    with torch.set_grad_enabled(grad):
        bias = None if m.bias is None else m.bias.to(dt)
        assert conv.takes_kernel(m, x.to(dt), m.weight.to(dt), bias) == want


@pytest.mark.parametrize("b,want", [
    (1, [True, True, True, True, False, False]),
    (3, [True, True, True, True, False, False]),
    (4, [True] * 6)])
def test_takes_kernel_needs_a_grid_that_fills_the_card(b, want):
    """The Encoder3D's convs at batch b: the kernel where its grid has at
    least conv.MIN_BLOCKS (32) tiles. At the stream's B = 1 those are the
    convs at 64x64 (128 tiles) and 32x32 (32); the 16x16 ones (8 tiles a
    batch element, 24 at B = 3) stay F.conv3d."""
    got, blocks = [], []
    for shape, cout, bias in ENCODER_CONVS:
        m = Conv3d(shape[1], cout, 3, 1, 1, bias=bias).requires_grad_(False)
        x = torch.zeros((b, *shape[1:]), device="meta")
        got.append(conv.takes_kernel(m, x, m.weight, m.bias))
        blocks.append(conv.grid_blocks(x.shape, cout))
    assert got == want
    assert [n // b for n in blocks] == [128, 128, 32, 32, 8, 8]
    assert conv.MIN_BLOCKS == 32


def test_takes_kernel_with_grad_on_and_nothing_to_differentiate():
    """Autograd on but no input requires grad (frozen weights): the op."""
    m = Conv3d(32, 64, 3, 1, 1).requires_grad_(False)
    assert torch.is_grad_enabled()
    assert conv.takes_kernel(m, _x(), m.weight, m.bias)


@pytest.mark.parametrize("mode", ["inference", "no_grad", "grad"])
def test_conv3d_module_routes_by_grad_mode(monkeypatch, mode):
    """blocks.Conv3d's forward: the op under inference_mode, under no_grad
    and when autograd records (then with a graph); the same values every
    way."""
    m = Conv3d(32, 64, 3, 1, 1)
    x = torch.randn((64, 32, 2, 3, 8))
    ctx = {"inference": torch.inference_mode(), "no_grad": torch.no_grad(),
           "grad": contextlib.nullcontext()}[mode]
    with _counting(monkeypatch) as calls, ctx:
        got = m(x)
    assert len(calls) == 1
    assert got.requires_grad == (mode == "grad")
    torch.testing.assert_close(got.detach(), F.conv3d(x, m.weight, m.bias,
                                                      padding=1),
                               rtol=0, atol=0)


def test_conv2d_and_mnet_never_take_the_op(monkeypatch):
    """2-D convs (the decoder's) and MNet's (2, 1, 1) convs stay F.conv*."""
    with _counting(monkeypatch) as calls, torch.inference_mode():
        Conv2d(64, 64, 3, 1, 1)(torch.randn((1, 64, 8, 8)))
        MNet(32)(torch.randn((2, 2, 8, 4, 4)))
    assert calls == []


def test_basic_block_strided_input_is_made_contiguous(monkeypatch):
    """A strided NCDHW view reaches the op as a contiguous copy, with the
    values of F.conv3d on the view."""
    blk = BasicBlock(32, 64, ndim=3).eval()
    base = torch.randn((64, 32, 2, 3, 16)).transpose(3, 4)
    x = base.contiguous().transpose(3, 4)
    assert not x.is_contiguous()
    with _counting(monkeypatch) as calls, torch.inference_mode():
        got = blk(x)
    assert len(calls) == 3
    torch.testing.assert_close(got, blk(x.contiguous()).detach(), rtol=0,
                               atol=0)


def _meta_maps(b=32, g=8, side=64, f=32):
    return torch.empty((b, g, side, side, f), device="meta")


@pytest.mark.parametrize("grad,dtype,want", [
    (False, torch.float32, 32), (True, torch.float32, 32),
    (False, torch.bfloat16, 0)])
def test_flagship_request_sends_each_encoder_conv(monkeypatch, grad, dtype,
                                                  want):
    """HuPRNet at the flagship geometry on meta tensors (the ops' shape
    functions, kernels.meta_stands_for_card): a float32 forward at 32
    windows sends the 16 3x3x3 convs of each of the two Encoder3Ds to the
    op, served or recorded by autograd; a bfloat16 model sends none."""
    model = HuPRNet(num_filters=32, heatmap_size=64, attn_impl="pallas",
                    compute_dtype=dtype).to("meta")
    model.train(grad)
    ra = _meta_maps()
    with _counting(monkeypatch) as calls, torch.set_grad_enabled(grad), \
            kernels.meta_stands_for_card():
        heat, _ = model.pose_from_maps(ra, ra)
    assert len(calls) == want
    assert heat.shape[0] == 32
    if want:
        assert sorted(set(calls)) == sorted(
            ((32, *s[1:]), (c, s[1], 3, 3, 3)) for s, c, _ in ENCODER_CONVS)


@pytest.fixture(scope="module")
def smoke():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flagship_convs(monkeypatch):
    model = HuPRNet(num_filters=32, heatmap_size=64,
                    attn_impl="pallas").to("meta").eval()
    ra = _meta_maps()
    with _counting(monkeypatch) as calls, torch.inference_mode(), \
            kernels.meta_stands_for_card():
        model.pose_from_maps(ra, ra)
    return calls


def test_smoke_conv_table_is_the_request_convs(monkeypatch, smoke):
    """chip_smoke.CONV_SHAPES, which weights the card's per-shape times
    into a request's and sets the launch counts it holds, lists each conv a
    served float32 request sends to the op, as often as it sends it."""
    seen = collections.Counter(
        (x[1:], w[0]) for x, w in _flagship_convs(monkeypatch))
    table = {(s, cout): n for s, cout, _, n in smoke.CONV_SHAPES}
    assert seen == table
    assert smoke.CONV_PER_FORWARD == 32
    assert [smoke.conv_per_forward(b) for b in (1, 3, 4, 32)] == \
        [20, 20, 32, 32]
    assert smoke.conv_launches_want(12 * 8, "f32") == 32 * 8
    assert smoke.conv_launches_want(12 * 8, "bf16") == 0


def test_smoke_plain_convs_keeps_every_conv_off_the_op(monkeypatch, smoke):
    """Inside chip_smoke.plain_convs, the plain route of its serving
    comparison, blocks.Conv3d sends no conv to the op; after it, the rule
    is back."""
    with smoke.plain_convs():
        assert _flagship_convs(monkeypatch) == []
    monkeypatch.undo()
    assert len(_flagship_convs(monkeypatch)) == 32


def test_encoder3d_counts_its_convs(monkeypatch):
    """One Encoder3D: 16 3x3x3 convs (the stem, with bias, and one
    BasicBlock of three at the first stage; two BasicBlocks at each of the
    other two)."""
    enc = Encoder3D(32, 8).to("meta").eval()
    with _counting(monkeypatch) as calls, torch.inference_mode(), \
            kernels.meta_stands_for_card():
        enc(torch.empty((8, 32, 8, 64, 64), device="meta"))
    assert len(calls) == 16


# -------------------------------------------- the op's CPU and fake kernels

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("shape,cout,_", ENCODER_CONVS,
                         ids=[f"{s[1]}to{c}" for s, c, _ in ENCODER_CONVS])
def test_op_cpu_kernel_is_conv3d(shape, cout, _, b):
    """At every Encoder3D shape, with and without bias: the op's CPU kernel
    equals F.conv3d bit for bit and counts no launch; its fake kernel
    gives the output's shape and dtype."""
    x, w, bias = _draw((b, *shape[1:]), cout, True)
    before = conv.conv3d_3x3x3.launches
    for bb in (bias, None):
        got = conv.conv3d_3x3x3(x, w, bb)
        assert torch.equal(got, F.conv3d(x, w, bb, padding=1))
        with FakeTensorMode() as mode:
            fx, fw = mode.from_tensor(x), mode.from_tensor(w)
            fb = None if bb is None else mode.from_tensor(bb)
            out = torch.ops.hupr_tpu_torch.conv3d_3x3x3(fx, fw, fb)
        assert out.shape == got.shape and out.dtype == torch.float32
    assert conv.conv3d_3x3x3.launches == before


def test_op_opcheck():
    """torch.library.opcheck on the CPU: schema, fake kernel, AOT
    dispatch, with and without bias."""
    x, w, b = _draw((1, 8, 2, 3, 8), 64, True)
    torch.library.opcheck(torch.ops.hupr_tpu_torch.conv3d_3x3x3, (x, w, b))
    torch.library.opcheck(torch.ops.hupr_tpu_torch.conv3d_3x3x3,
                          (x, w, None))


@pytest.mark.parametrize("bad,match", [
    (lambda x, w, b: (x.to(torch.bfloat16), w.to(torch.bfloat16), b),
     "float32"),
    (lambda x, w, b: (x.transpose(3, 4), w, b), "contiguous"),
    (lambda x, w, b: (x[:, :4].contiguous(), w[:, :4].contiguous(), b),
     "multiple of 8"),
    (lambda x, w, b: (x, w[:32].contiguous(), b[:32]), "multiple of 64"),
    (lambda x, w, b: (x, w, b[:8]), "bias"),
])
def test_fake_kernel_refuses_what_the_card_refuses(bad, match):
    """On meta tensors standing for the card's, the fake kernel holds the
    inputs to what the CUDA kernel takes; outside meta_stands_for_card a
    meta tensor is refused."""
    x, w, b = (t.to("meta") for t in _draw((1, 8, 2, 3, 8), 64, True))
    with kernels.meta_stands_for_card():
        assert conv.conv3d_3x3x3(x, w, b).shape == (1, 64, 2, 3, 8)
        with pytest.raises((TypeError, ValueError), match=match):
            conv.conv3d_3x3x3(*bad(x, w, b))
    with pytest.raises(ValueError, match="not meta"):
        conv.conv3d_3x3x3(x, w, b)


def test_op_refuses_a_graph():
    """With autograd recording and only the weight requiring grad, the op
    records a graph (it refuses none) whose weight gradient is F.conv3d's
    bit for bit and which leaves the input and bias without one."""
    x, w, b = _draw((1, 8, 2, 3, 8), 64, True)
    y = conv.conv3d_3x3x3(x, w.requires_grad_(True), b)
    assert y.requires_grad
    dy = torch.randn_like(y)
    got, = torch.autograd.grad(y, w, dy)
    want, = torch.autograd.grad(F.conv3d(x, w, b, padding=1), w, dy)
    assert torch.equal(got, want)


@pytest.mark.parametrize("needs", ["all", "x", "weight", "weight_bias"])
@pytest.mark.parametrize("shape,cout,bias", ENCODER_CONVS,
                         ids=[f"{s[1]}to{c}" for s, c, _ in ENCODER_CONVS])
def test_op_gradients_are_conv3d_bit_for_bit(shape, cout, bias, needs):
    """At every Encoder3D's channels (the extent cut, batch 2): the op's
    output and its gradients of each input that requires one equal
    F.conv3d's and its autograd's bit for bit."""
    x, w, b = _draw((2, shape[1], 2, 4, 8), cout, bias, seed=cout)
    wants = {"all": ("x", "w", "b"), "x": ("x",), "weight": ("w",),
             "weight_bias": ("w", "b")}[needs]
    leaves = {"x": x, "w": w, "b": b}
    for name, t in leaves.items():
        if t is not None:
            t.requires_grad_(name in wants)
    inputs = [leaves[n] for n in wants if leaves[n] is not None]
    got_y = conv.conv3d_3x3x3(x, w, b)
    want_y = F.conv3d(x, w, b, padding=1)
    dy = torch.randn_like(want_y)
    got = torch.autograd.grad(got_y, inputs, dy)
    want = torch.autograd.grad(want_y, inputs, dy)
    assert torch.equal(got_y, want_y)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert conv.conv3d_3x3x3.launches == conv.conv3d_wgrad.launches == 0


def test_wgrad_cpu_is_its_plain_version():
    """conv3d_wgrad on CPU tensors is the plain version, F.conv3d's weight
    gradient, and counts no launch."""
    x, w, _ = _draw((2, 16, 3, 5, 8), 64, False)
    dy = torch.randn((2, 64, 3, 5, 8))
    want, = torch.autograd.grad(F.conv3d(x, w.requires_grad_(), padding=1),
                                w, dy)
    assert torch.equal(conv.conv3d_wgrad(x, dy), want)
    assert torch.equal(conv.conv_wgrad_plain(x, dy), want)
    assert conv.conv3d_wgrad.launches == 0


def test_dgrad_weight_makes_the_forward_the_input_gradient():
    """A conv of the output gradient with dgrad_weight(w), as the forward
    kernel computes it, is F.conv3d's input gradient."""
    x, w, _ = _draw((2, 64, 3, 4, 8), 128, False, seed=4)
    dy = torch.randn((2, 128, 3, 4, 8), dtype=torch.float64)
    x, w = x.double().requires_grad_(), w.double()
    want, = torch.autograd.grad(F.conv3d(x, w, padding=1), x, dy)
    got = F.conv3d(dy, conv.dgrad_weight(w), padding=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert conv.dgrad_weight(w).shape == (64, 128, 3, 3, 3)


# ------------------------------------------ each pass's kernel-or-cuDNN rule

# (fprop, dgrad, wgrad) of each Encoder3D conv at data parallel training's 5
# rows a card and the one-card batch of 20
PASS_ROUTES = {
    5: [(True, False, True), (True, True, True), (True, True, True),
        (True, True, True), (True, False, True), (True, True, True)],
    20: [(True, False, True)] + [(True, True, True)] * 5}


@pytest.mark.parametrize("b", sorted(PASS_ROUTES))
def test_each_pass_takes_its_kernel_by_its_own_grid(b):
    """At batch b, for each Encoder3D conv: the forward where its grid has
    conv.MIN_BLOCKS tiles (the (2, 16, 16) convs at 5 rows have 40); dX
    through the forward kernel where dY's conv to Cin channels fits the
    forward's rule (not the first conv: 32 channels; not the 128 -> 256
    conv at 5 rows, whose dX grid has 20 tiles), dW through its kernel
    where its grid has conv.WGRAD_MIN_BLOCKS blocks; and the
    weight-gradient kernel's splits fill conv.WGRAD_WAVES waves of the H100
    SXM's 132 SMs, one block an SM, to within 4 %."""
    got = []
    for shape, cout, _ in ENCODER_CONVS:
        x_shape = (b, *shape[1:])
        r = conv.routes(x_shape, cout)
        got.append((r["fprop"], r["dgrad"], r["wgrad"]))
        per, splits = conv.wgrad_split(x_shape, cout, H100_SMS)
        chunks = conv.wgrad_chunks(shape[1], cout)
        assert chunks == shape[1] // 16 * (cout // 64)
        tiles = conv.voxel_tiles(x_shape, conv.WGRAD_VOXELS)
        assert (splits - 1) * per < tiles <= splits * per
        assert (0.96 * conv.WGRAD_WAVES * H100_SMS <= splits * chunks
                <= conv.WGRAD_WAVES * H100_SMS)
    assert got == PASS_ROUTES[b]


# (tiles a block, splits) of the weight-gradient kernel's wgmma body at each
# Encoder3D conv on the H100 SXM, and its voxel tiles, at 5 rows and at
# batch 20: the tiling its dW has been checked at on the card, bit for bit
WGRAD_TILING = {
    5: ([(10, 64), (20, 32), (5, 16), (10, 8), (3, 4), (5, 2)],
        [640, 640, 80, 80, 10, 10]),
    20: ([(39, 66), (78, 33), (20, 16), (40, 8), (10, 4), (20, 2)],
         [2560, 2560, 320, 320, 40, 40])}


@pytest.mark.parametrize("b", sorted(WGRAD_TILING))
def test_wgrad_tiling_is_its_own(b):
    """The weight-gradient kernel's splits and tiles at the Encoder3D
    shapes stay what they are whatever the forward kernel's tile: they
    read WGRAD_VOXELS, not the forward's FPROP_VOXELS or grid_blocks, so
    dW keeps its order of sums."""
    splits, tiles = WGRAD_TILING[b]
    shapes = [((b, *shape[1:]), cout) for shape, cout, _ in ENCODER_CONVS]
    assert [conv.wgrad_split(s, c, H100_SMS) for s, c in shapes] == splits
    assert [conv.voxel_tiles(s, conv.WGRAD_VOXELS) for s, _ in shapes] \
        == tiles
    assert all(conv.wgrad_takes(s, c) for s, c in shapes)


@pytest.mark.parametrize("b", sorted(PASS_ROUTES))
def test_module_takes_the_op_by_the_forward_rule_under_grad(b):
    """With autograd recording, blocks.Conv3d sends an Encoder3D conv to
    the op exactly where its forward takes the kernel, as without it."""
    for shape, cout, bias in ENCODER_CONVS:
        m = Conv3d(shape[1], cout, 3, 1, 1, bias=bias)
        x = torch.zeros((b, *shape[1:]), device="meta")
        assert m.weight.requires_grad
        assert conv.takes_kernel(m, x, m.weight, m.bias) == \
            conv.fprop_takes(x.shape, cout)


def test_meta_train_step_gradients_have_the_weights_shapes():
    """On meta tensors standing for the card's (the flagship shape pass),
    an Encoder3D's forward and backward run through the op at batch 20:
    every parameter gets a gradient of its shape."""
    enc = Encoder3D(32, 8).to("meta")
    with kernels.meta_stands_for_card():
        out = enc(torch.empty((20, 32, 8, 64, 64), device="meta",
                              requires_grad=True))
        sum(o.sum() for o in out).backward()
    assert all(p.grad is not None and p.grad.shape == p.shape
               for p in enc.parameters())


# ---------------------------------- the window convs' gradients (WindowConv)

def _stand_in(shape, device="cuda", dtype=torch.float32, grad=True):
    """What takes_window reads of an input, on a device this machine may
    not have."""
    return types.SimpleNamespace(shape=shape, dtype=dtype, requires_grad=grad,
                                 device=torch.device(device),
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("make,x,grad,want", [
    # MNet's conv, kernel and stride (2, 1, 1), 8 chirps
    (lambda: MNet(32).temporalConvWx1x1, _stand_in((16, 2, 8, 8, 8)), True,
     True),
    # the temporal merges: one window over the depth, stride 1
    (lambda: Conv3d(64, 64, (8, 1, 1), bias=False),
     _stand_in((2, 64, 8, 8, 8)), True, True),
    (lambda: Conv3d(256, 256, (2, 1, 1), bias=False),
     _stand_in((2, 256, 2, 4, 4)), True, True),
    # no gradient needed, on the CPU, in bfloat16: F.conv3d
    (lambda: MNet(32).temporalConvWx1x1, _stand_in((16, 2, 8, 8, 8)), False,
     False),
    (lambda: MNet(32).temporalConvWx1x1,
     _stand_in((16, 2, 8, 8, 8), device="cpu"), True, False),
    (lambda: MNet(32, torch.bfloat16).temporalConvWx1x1,
     _stand_in((16, 2, 8, 8, 8), dtype=torch.bfloat16), True, False),
    # windows that overlap or leave a rest, and other kernels
    (lambda: Conv3d(64, 64, (2, 1, 1), bias=False),
     _stand_in((2, 64, 8, 8, 8)), True, False),
    (lambda: Conv3d(2, 32, (2, 1, 1), (2, 1, 1)), _stand_in((2, 2, 7, 8, 8)),
     True, False),
    (lambda: Conv3d(64, 64, (2, 1, 1), (2, 1, 1), (1, 0, 0)),
     _stand_in((2, 64, 8, 8, 8)), True, False),
    (lambda: Conv3d(64, 64, 3, 1, 1), _stand_in((2, 64, 8, 8, 8)), True,
     False),
])
def test_takes_window(make, x, grad, want):
    """ops/conv.takes_window on the module as blocks.Conv3d calls it."""
    m = make()
    dt = m.compute_dtype
    with torch.set_grad_enabled(grad):
        bias = None if m.bias is None else m.bias.to(dt)
        assert conv.takes_window(m, x, m.weight.to(dt), bias) == want


@pytest.mark.parametrize("shape,cout,k,stride,bias", [
    ((4, 2, 8, 6, 5), 32, 2, 2, True),      # MNet's
    ((2, 64, 8, 4, 4), 64, 8, 1, False),    # the temporal merges'
    ((2, 128, 4, 4, 4), 128, 4, 1, False),
    ((2, 256, 2, 2, 2), 256, 2, 1, False)])
def test_window_conv_gradients_are_conv3d(shape, cout, k, stride, bias):
    """WindowConv's output is F.conv3d's bit for bit, and its gradients
    (matrix products over the windows) are F.conv3d's autograd's within
    float64 rounding."""
    gen = torch.Generator().manual_seed(cout + k)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    w = torch.randn((cout, shape[1], k, 1, 1), generator=gen,
                    dtype=torch.float64)
    b = torch.randn((cout,), generator=gen, dtype=torch.float64) \
        if bias else None
    leaves = [t.requires_grad_() for t in (x, w, b) if t is not None]
    got_y = conv.WindowConv.apply(x, w, b, (stride, 1, 1))
    want_y = F.conv3d(x, w, b, stride=(stride, 1, 1))
    dy = torch.randn(want_y.shape, generator=gen, dtype=torch.float64)
    assert torch.equal(got_y, want_y)
    for g, h in zip(torch.autograd.grad(got_y, leaves, dy),
                    torch.autograd.grad(want_y, leaves, dy)):
        torch.testing.assert_close(g, h, rtol=1e-12, atol=1e-12)


# ----------------------------------------- the card kernel's arithmetic

def _tf32_bits(x: torch.Tensor, round_nearest: bool) -> torch.Tensor:
    """x cut to tf32's 10-bit mantissa: rounded to nearest, ties away
    (tf32.cuh's split), or truncated (the tensor core reading a float32
    operand)."""
    bits = x.view(torch.int32)
    if round_nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def conv_3xtf32(x, w, b=None):
    """The kernel's products in torch: x and w split into hi = rna(v) and
    lo = v - hi (the tensor core reads lo's tf32 bits), the three terms in
    the kernel's order, x_lo.w_hi, x_hi.w_lo and x_hi.w_hi (the voxels are
    wgmma's A, the weights its B), each an exact float32 convolution of
    tf32 values, summed in float32 small terms first, x_lo.w_lo dropped."""
    xh, wh = _tf32_bits(x, True), _tf32_bits(w, True)
    xl, wl = _tf32_bits(x - xh, False), _tf32_bits(w - wh, False)
    out = F.conv3d(xl, wh, padding=1) + F.conv3d(xh, wl, padding=1)
    out = out + F.conv3d(xh, wh, padding=1)
    return out if b is None else out + b[None, :, None, None, None]


def conv_1xtf32(x, w, b=None):
    """A planted fault: one TF32 product (operands rounded to tf32)."""
    return F.conv3d(_tf32_bits(x, True), _tf32_bits(w, True), b, padding=1)


def _rel_err(got, ref64) -> float:
    return ((got.double() - ref64).abs().max()
            / ref64.abs().max()).item()


# the Encoder3D's channel counts at each width, the spatial extent cut
@pytest.mark.parametrize("shape,cout", [((1, 32, 4, 8, 64), 64),
                                        ((1, 64, 4, 8, 64), 64),
                                        ((1, 128, 2, 8, 32), 128),
                                        ((1, 256, 2, 8, 16), 256)])
def test_3xtf32_model_within_the_card_bar_and_1xtf32_over_it(shape, cout):
    """The 3xTF32 model reads under conv.REL_TOL of a float64 convolution
    (max |error| over max |reference|), by an order of magnitude; one TF32
    product reads over it."""
    x, w, b = _draw(shape, cout, True, seed=shape[1])
    ref = F.conv3d(x.double(), w.double(), b.double(), padding=1)
    three = _rel_err(conv_3xtf32(x, w, b), ref)
    one = _rel_err(conv_1xtf32(x, w, b), ref)
    assert three < conv.REL_TOL / 10
    assert one > conv.REL_TOL


def wgrad_model(x, dy, product):
    """The weight-gradient kernel's sums in torch (csrc/conv3d_wgrad.cu):
    the voxels in tiles of 2 depths x 128 / W rows x W columns (zero past
    the volume), each tile in 4 chains of 64 voxels (8 wgmma k-steps) whose
    products `product(dy_chain, x_chain)` (float32, (Cout, Cin x 27); the
    kernel's m64 tiles of 16 channels x 4 taps by 64 output channels each
    take their own rows and columns of it) are summed from zero; each block
    adds its chains into its float32 accumulator in order, tile by tile over
    its split of conv.wgrad_split's tiles (one wave of the H100 SXM's SMs),
    and the splits are added by torch's sum, as the wrapper adds them."""
    b, cin, d, h, w = x.shape
    cout = dy.shape[1]
    rows = conv.WGRAD_VOXELS // (2 * w)
    dd, hh = -(-d // 2) * 2, -(-h // rows) * rows
    xp = F.pad(x, (1, 1, 1, 1 + hh - h, 1, 1 + dd - d))
    g = F.pad(dy, (0, 0, 0, hh - h, 0, dd - d))
    # the 27 shifted inputs, tap-minor: (B, Cin x 27, D', H', W)
    cols = torch.stack([xp[:, :, i:i + dd, j:j + hh, k:k + w]
                        for i in range(3) for j in range(3)
                        for k in range(3)], 2).reshape(b, cin * 27, dd, hh, w)

    def chains(t):   # (B, C, D', H', W) -> (tiles, 4 chains, C, 64 voxels)
        c = t.shape[1]
        t = t.reshape(b, c, dd // 2, 2, hh // rows, rows, w)
        t = t.permute(0, 2, 4, 1, 3, 5, 6).reshape(-1, c, 4, 64)
        return t.transpose(1, 2)

    parts = product(chains(g), chains(cols))     # (tiles, 4, Cout, N)
    per, splits = conv.wgrad_split(x.shape, cout, H100_SMS)
    parts = F.pad(parts.flatten(0, 1), (0, 0, 0, 0, 0,
                                        4 * (splits * per) - 4 * len(parts)))
    parts = parts.reshape(splits, 4 * per, cout, cin * 27)
    acc = torch.zeros_like(parts[:, 0])
    for i in range(4 * per):
        acc = acc + parts[:, i]
    return acc.sum(0).reshape(cout, cin, 3, 3, 3)


def product_3xtf32(g, xs):
    """A chain's 3xTF32 products: g and x split into hi = rna(v) and lo =
    v - hi (lo's tf32 bits), each an exact float32 product of tf32 values,
    added in float32 small terms first, in the kernel's order with the
    input as wgmma's A and g as its B: x_lo.g_hi + x_hi.g_lo + x_hi.g_hi."""
    gh, xh = _tf32_bits(g, True), _tf32_bits(xs, True)
    gl, xl = _tf32_bits(g - gh, False), _tf32_bits(xs - xh, False)
    return (gh @ xl.mT + gl @ xh.mT) + gh @ xh.mT


def product_1xtf32(g, xs):
    """A planted fault: one TF32 product (operands rounded to tf32)."""
    return _tf32_bits(g, True) @ _tf32_bits(xs, True).mT


# the Encoder3D's channel counts at each width, the extent cut, a batch
# whose tiles make several splits
@pytest.mark.parametrize("shape,cout", [((4, 32, 4, 4, 64), 64),
                                        ((4, 64, 4, 4, 64), 64),
                                        ((6, 128, 2, 8, 32), 128),
                                        ((8, 256, 2, 8, 16), 256)])
def test_wgrad_3xtf32_model_within_the_card_bar_and_1xtf32_over_it(shape,
                                                                   cout):
    """The weight-gradient kernel's 3xTF32 sums, modelled in their split and
    summation order, read under conv.REL_TOL of float64 (max |error| over
    max |reference|) by an order of magnitude; the same sums of one TF32
    product read over it. The model without rounding is the float64
    gradient: the tiling, chains and splits cover each product once."""
    gen = torch.Generator().manual_seed(cout)
    x = torch.randn(shape, generator=gen)
    dy = torch.randn((shape[0], cout, *shape[2:]), generator=gen)
    ref = torch.nn.grad.conv3d_weight(x.double(), (cout, shape[1], 3, 3, 3),
                                      dy.double(), padding=1)
    assert conv.wgrad_split(shape, cout, H100_SMS)[1] > 1
    exact = wgrad_model(x.double(), dy.double(), lambda g, xs: g @ xs.mT)
    torch.testing.assert_close(exact, ref, rtol=1e-12, atol=1e-10)
    three = _rel_err(wgrad_model(x, dy, product_3xtf32), ref)
    one = _rel_err(wgrad_model(x, dy, product_1xtf32), ref)
    assert three < conv.REL_TOL / 10
    assert one > conv.REL_TOL
