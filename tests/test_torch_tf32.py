"""The float32 backward kernel's 3xTF32 arithmetic, modelled on the CPU.

In mode f32 the backward kernel (csrc/attention_bwd.cu, csrc/tf32.cuh)
runs every product on the tensor cores in tf32: each float32 operand x is
split into hi = rna(x) (cvt.rna.tf32.f32's rounding: to nearest, ties
away, to a 10-bit mantissa) and lo = x - hi, which the tensor core
truncates to tf32, and a product a.b is taken as a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi into a float32 sum. Here the backward's
formulas run with exactly those products (tf32 values multiply exactly in
float32) at two of the model's (N, C) shapes, and must stay within
chip_smoke.REL_F32_BWD, the relative norm error the kernel is held to on
the card, of the float64 ideal and of the plain version; one TF32 product
(hi.hi alone) must miss it, so that the bar tells the two apart. Once, at
a small shape, the model is also tied to jax.grad through hupr_tpu's
Pallas backward in interpret mode.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hupr_tpu.ops.attention as jax_attention
from hupr_tpu_torch.ops import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 1024, 128), (2, 256, 256)]
NAMES = ("dk", "dq", "dm")


@pytest.fixture(scope="module")
def bar():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.REL_F32_BWD


def _tf32(x):
    """cvt.rna.tf32.f32 on the int32 view: add half of the 13 dropped
    bits' weight to the magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _truncate(x):
    """x as the tensor core reads a float32 operand: its tf32 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _truncate(x - hi)


def _three(eq, a, b):
    """3xTF32, the kernel's order: lo.hi + hi.lo + hi.hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def _one(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _bwd(k, q, m, out, lse, g, mm):
    """attention_bwd_plain's formulas with every product taken by mm."""
    p = torch.exp(mm("bic,bjc->bij", k, q) - lse[:, None, :])
    dp = mm("bic,bjc->bij", m, g)
    ds = p * (dp - (g * out).sum(dim=2)[:, None, :])
    return (mm("bij,bjc->bic", ds, q), mm("bij,bic->bjc", ds, k),
            mm("bij,bjc->bic", p, g))


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _inputs(b, n, c, seed):
    """k, q, m, g float32 from numpy, logits of unit spread, and the
    forward's out and lse."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, c)).astype(np.float32)
          for _ in range(4)]
    xs[0] *= c ** -0.25
    xs[1] *= c ** -0.25
    k, q, m, g = (torch.from_numpy(x) for x in xs)
    out, lse = attention.attention_fwd(k, q, m, with_lse=True)
    return k, q, m, out, lse, g


@pytest.mark.parametrize("x,hi", [
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),            # a tie rounds away from 0
    (-1 - 2.0 ** -11, -1 - 2.0 ** -10),
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0),           # below a tie, down
    (1 + 2.0 ** -10 + 2.0 ** -12, 1 + 2.0 ** -10),
])
def test_tf32_rounds_to_nearest_ties_away(x, hi):
    """hi keeps 10 mantissa bits, and hi + lo (lo truncated to tf32)
    carries x to 2^-21."""
    t = torch.tensor([x], dtype=torch.float32)
    got_hi, lo = _split(t)
    assert got_hi.item() == hi
    assert got_hi.view(torch.int32).item() & 0x1FFF == 0
    assert lo.view(torch.int32).item() & 0x1FFF == 0
    assert abs(got_hi.item() + lo.item() - x) <= 2.0 ** -21 * abs(x)


@pytest.mark.parametrize("b,n,c", SHAPES)
def test_three_tf32_products_within_bar(bar, b, n, c):
    ts = _inputs(b, n, c, seed=n + c)
    ideal = _bwd(*(t.double() for t in ts), torch.einsum)
    plain = attention.attention_bwd_plain(*ts)
    got = _bwd(*ts, _three)
    for name, a, i, p in zip(NAMES, got, ideal, plain):
        assert _rel(a, i) <= bar, name
        assert _rel(a, p) <= bar, name


@pytest.mark.parametrize("b,n,c", SHAPES)
def test_one_tf32_product_misses_bar(bar, b, n, c):
    ts = _inputs(b, n, c, seed=n + c)
    plain = attention.attention_bwd_plain(*ts)
    got = _bwd(*ts, _one)
    for name, a, p in zip(NAMES, got, plain):
        assert _rel(a, p) > bar, name


def test_model_matches_pallas_backward():
    """At (1, 64, 16) the 3xTF32 model gives the gradients jax.grad takes
    through the Pallas backward in interpret mode, within the bar of
    tests/test_attention.py (atol 1e-3 + rtol 1e-4)."""
    ts = _inputs(1, 64, 16, seed=5)
    k, q, m, _, _, g = ts
    got = _bwd(*ts, _three)
    _, vjp = jax.vjp(lambda k, q, m: jax_attention.fused_spatial_attention(
        k, q, m, 64, True, False), *(jnp.asarray(t.numpy())
                                     for t in (k, q, m)))
    want = vjp(jnp.asarray(g.numpy()))
    for name, a, w in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-4, err_msg=name)
