"""What the kernels' wrappers hand the kernels through the seam
(ops/kernels), and the least time chip_smoke.py charges a kernel against
(its bound). CPU only: no kernel runs."""

import ctypes
import importlib.util
import math
import os

import pytest
import torch

from hupr_tpu_torch.ops import attention, conv, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_f32_mode_operands_pass_through():
    ts = [torch.randn(2, 8, 64) for _ in range(3)]
    assert all(a is b for a, b in zip(
        attention._operand_tensors(ts, "f32"), ts))


@pytest.mark.parametrize("dtype,bf16_ops", [(torch.bfloat16, False),
                                            (torch.float32, True),
                                            (torch.bfloat16, True)])
def test_tensor_core_modes_take_aligned_bf16(dtype, bf16_ops):
    """bfloat16 operands on 16-byte boundaries: float32 rounded once (the
    values the TPU kernel rounds on load), a bfloat16 input passed as it
    is, and a view at an odd offset copied."""
    mode = attention.kernel_mode(dtype, bf16_ops)
    base = torch.randn(2 * 8 * 64 + 1).to(dtype)
    aligned = base[:-1].view(2, 8, 64)
    shifted = base[1:].view(2, 8, 64)
    assert shifted.data_ptr() % 16
    out = attention._operand_tensors([aligned, shifted], mode)
    for got, want in zip(out, (aligned, shifted)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        assert torch.equal(got, want.to(torch.bfloat16))
    if dtype == torch.bfloat16:
        assert out[0] is aligned


ATTN = (2, 8, 64)                   # (B, N, C)
X, DY = (1, 8, 2, 4, 8), (1, 64, 2, 4, 8)   # the conv's (B, C, D, H, W)

# id: (wrapper, mode, the operands' shapes, their places among the C
# function's pointers, the place of the output it returns, its ints, the
# call of the CUDA kernel on the operands). The unfolded forward's ids are
# its modes.
LAUNCH_CASES = {
    "f32": (attention.attention_fwd_unfolded, "f32", [ATTN] * 3, (0, 1, 2),
            3, (*ATTN, 0, 0),
            lambda k, q, m: attention._unfolded_cuda(k, q, m, False)),
    "f32_bf16ops": (
        attention.attention_fwd_unfolded, "f32_bf16ops", [ATTN] * 3,
        (0, 1, 2), 3, (*ATTN, 0, 1),
        lambda k, q, m: attention._unfolded_cuda(k, q, m, True)),
    "attention_fwd": (
        attention.attention_fwd, "f32", [ATTN] * 3, (0, 1, 2), 3,
        (*ATTN, 0, 0),
        lambda k, q, m: attention._fwd_cuda(k, q, m, False, False)),
    "attention_fwd_lse": (
        attention.attention_fwd, "f32", [ATTN] * 3, (0, 1, 2), 3,
        (*ATTN, 0, 0),
        lambda k, q, m: attention._fwd_cuda(k, q, m, False, True)[0]),
    "attention_bwd": (
        attention.attention_bwd, "f32", [ATTN] * 4, (0, 1, 2, 5), 6,
        (*ATTN, 0, 0),
        lambda k, q, m, g: attention._bwd_cuda(
            k, q, m, torch.randn(ATTN), torch.randn(ATTN[:2]), g, False)[0]),
    "conv3d_3x3x3": (
        conv.conv3d_3x3x3, "f32", [X], (0,), 4, (1, 8, 64, 2, 4, 8),
        lambda x: conv._conv_cuda(x, torch.randn(64, 8, 3, 3, 3),
                                  torch.randn(64))),
    "conv3d_wgrad": (
        conv.conv3d_wgrad, "wgmma", [X, DY], (0, 1), 2,
        (1, 8, 64, 2, 4, 8, 1),
        conv._wgrad_cuda),
}


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "shifted"])
@pytest.mark.parametrize("case", LAUNCH_CASES)
def test_unfolded_wrapper_hands_kernel_its_operands(monkeypatch, case,
                                                    offset):
    """Each kernel's CUDA wrapper (the unfolded forward in both its modes,
    the forward with and without the LSE, the backward, the conv's forward
    and its weight gradient) hands its C function the operands on 16-byte
    boundaries: in f32_bf16ops bfloat16, one cast each of the float32
    inputs; in f32 the inputs themselves, copied only when one starts off a
    boundary. It hands over the output it returns and the ints of the
    shapes and mode, counts the launch once under its mode, and raises,
    counting nothing, when the C function returns a CUDA error. The
    wrapper is called directly on CPU tensors (the dispatcher would hand
    them the plain twin), the seam's binding of the launch replaced by a
    recorder that reads the operands' bytes while the call lasts and its
    stream bypassed: no kernel runs."""
    wrapper, mode, shapes, places, out_at, ints, call = LAUNCH_CASES[case]
    operands = [torch.randn(math.prod(s) + 1)[offset:][:math.prod(s)]
                .view(s) for s in shapes]
    wants = [t.to(torch.bfloat16) if mode.endswith("bf16ops") else t
             for t in operands]
    calls, err = [], [0]

    def c_function(*args):
        calls.append((args, [ctypes.string_at(
            args[p], w.numel() * w.element_size())
            for p, w in zip(places, wants)]))
        return err[0]

    monkeypatch.setattr(kernels, "_launcher", lambda *a: c_function)
    monkeypatch.setattr(kernels, "stream", lambda device: None)
    monkeypatch.setattr(conv, "_packed_floats", lambda cin, cout: 4)
    monkeypatch.setattr(conv, "_sm_count", lambda device: 132)
    before = wrapper.launches_by_mode.get(mode, 0)
    out = call(*operands)
    (args, raw), = calls
    assert args[-len(ints) - 1:] == (*ints, None)
    assert args[out_at] == out.data_ptr()
    assert wrapper.launches_by_mode[mode] == before + 1
    for p, data, t, want in zip(places, raw, operands, wants):
        got = torch.frombuffer(bytearray(data), dtype=want.dtype)
        assert args[p] % 16 == 0
        assert torch.equal(got.view(want.shape), want)
        assert (args[p] == t.data_ptr()) == (want is t and offset == 0)
    err[0] = 700
    with pytest.raises(RuntimeError, match=f"mode {mode} failed with CUDA "
                                           f"error 700"):
        call(*operands)
    assert wrapper.launches_by_mode[mode] == before + 1


@pytest.mark.parametrize("a,b,pipe,products", [
    ("bf16", "bf16", "tensor", 1),    # one bfloat16 product
    ("f32", "bf16", "tensor", 2),     # hi + lo of the float32 side
    ("f32", "f32", "tensor", 3),      # 3xTF32 beats the FMA pipe
])
def test_product_route_is_the_cheapest_that_keeps_precision(
        smoke, a, b, pipe, products):
    peaks = smoke.PEAKS["SXM"]
    got_pipe, per_flop = smoke.product_route(a, b, peaks)
    peak = peaks["bf16"] if products < 3 else peaks["tf32"]
    assert got_pipe == pipe
    assert per_flop == pytest.approx(products / peak)
    assert per_flop < 1 / peaks["f32"]


@pytest.mark.parametrize("kind", ["fwd", "bwd", "unfolded"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_bf16ops",
                                  "bf16_bf16ops"])
def test_bound_counts_every_product_once(smoke, kind, mode):
    """The operations term of the bound: 2 (forward) or 5 (backward)
    products of 2*B*N^2*C flops at their routes, or the exps, whichever is
    slower; never below the bfloat16 tensor-core time of the products."""
    peaks = smoke.PEAKS["SXM"]
    b, n, c = 20, 4096, 64
    ms, by = smoke.attention_bound(kind, b, n, c, mode, peaks)
    products = 5 if kind == "bwd" else 2
    flops = 2 * b * n * n * c * products
    assert by == "operations"
    assert ms >= 1e3 * flops / peaks["bf16"] * (1 - 1e-12)
    if mode == "f32":   # three TF32 products each
        tensor = 1e3 * 3 * flops / peaks["tf32"]
    else:   # mode bf16 carries its float32 p (and dS) as two bf16 terms
        twice = {"bf16": 1 if kind != "bwd" else 3}.get(mode, 0)
        tensor = 1e3 * flops * (1 + twice / products) / peaks["bf16"]
    sfu = 1e3 * b * n * n / peaks["sfu"]
    assert ms == pytest.approx(max(tensor, sfu))
