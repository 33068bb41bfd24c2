"""What the attention wrappers hand the kernels, and the least time
chip_smoke.py charges a kernel against (its bound). CPU only: no kernel
runs."""

import ctypes
import importlib.util
import os

import pytest
import torch

from hupr_tpu_torch.ops import attention

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


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "shifted"])
@pytest.mark.parametrize("bf16_ops", [False, True],
                         ids=["f32", "f32_bf16ops"])
def test_unfolded_wrapper_hands_kernel_its_operands(monkeypatch, bf16_ops,
                                                    offset):
    """attention_fwd_unfolded hands its C function k, q and m on 16-byte
    boundaries: in f32_bf16ops bfloat16, one cast each of the float32
    inputs; in f32 the inputs themselves, copied only when one starts off a
    boundary; and a float32 out, in both. The op's CUDA kernel is called
    directly on CPU tensors (the dispatcher would hand them the plain
    twin), its C function replaced by a recorder that reads the operands'
    bytes while the call lasts, and the device checks and the stream
    bypassed: no kernel runs."""
    calls = []
    b, n, c = 2, 8, 64
    size = b * n * c

    def c_function(*args):
        width = 2 if bf16_ops else 4
        calls.append((args, [ctypes.string_at(p, size * width)
                             for p in args[:3]]))
        return 0

    monkeypatch.setattr(attention, "_kernel", lambda name: c_function)
    monkeypatch.setattr(attention, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(attention, "_stream", lambda t: None)
    base = torch.randn(3 * size + 1)
    k, q, m = (base[offset + i * size:offset + (i + 1) * size].view(b, n, c)
               for i in range(3))
    mode = attention.kernel_mode(torch.float32, bf16_ops)
    before = attention.attention_fwd_unfolded.launches_by_mode.get(mode, 0)
    out = attention._unfolded_cuda(k, q, m, bf16_ops)
    (args, raw), = calls
    assert args[4:] == (b, n, c, 0, int(bf16_ops), None)
    assert out.dtype == torch.float32 and args[3] == out.data_ptr()
    assert attention.attention_fwd_unfolded.launches_by_mode[mode] \
        == before + 1
    for ptr, data, t in zip(args[:3], raw, (k, q, m)):
        want = t.to(torch.bfloat16) if bf16_ops else t
        got = torch.frombuffer(bytearray(data), dtype=want.dtype)
        assert ptr % 16 == 0
        assert torch.equal(got.view(b, n, c), want)
        assert (ptr == t.data_ptr()) == (not bf16_ops and offset == 0)


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
