"""The float32 attention kernels' 3xTF32 arithmetic, modelled on the CPU.

In mode f32 the forward and backward kernels (csrc/attention_fwd.cu,
csrc/attention_bwd.cu, csrc/tf32.cuh) run every product on the tensor
cores in tf32: each float32 operand x is split into hi = rna(x)
(cvt.rna.tf32.f32's rounding: to nearest, ties away, to a 10-bit mantissa)
and lo = x - hi, which the tensor core truncates to tf32, and a product a.b
is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into a float32 sum. Here the
kernels' formulas run with exactly those products (tf32 values multiply
exactly in float32) at two of the model's (N, C) shapes, and must stay
within the relative norm error the kernel is held to on the card
(attention.REL_F32_BWD, REL_F32_FWD) of the float64 ideal and of the plain
version; one TF32 product (hi.hi alone) must miss it, so that the bar tells
the two apart. The forward is modelled as the kernel runs it: key tiles
with an online softmax, the logits summed in chunks of C and each tile's
p.m apart; the unfolded forward (csrc/attention_fwd_unfolded.cu) as its f32
body runs it: two passes over the same key tiles, the row statistics and
then the normalized softmax times m. Once, at a small shape, each model is
also tied to hupr_tpu's Pallas kernels (and the microbenchmark's round-1
body) in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import hupr_tpu.ops.attention as jax_attention
from hupr_tpu_torch.ops import attention

SHAPES = [(2, 1024, 128), (2, 256, 256)]
NAMES = ("dk", "dq", "dm")
LOG2E = 1.4426950408889634    # the kernels' exp2f((s - max) * LOG2E)


# (kernel, b, n, c, logits): the backward's cases keep their ids; the
# forwards (folded and unfolded) run on logits of unit spread and on N(0, 1)
# inputs, as chip_smoke.check_attention draws them (a nearly one-hot
# softmax)
CASES = [pytest.param("bwd", *shape, "unit", id="-".join(map(str, shape)))
         for shape in SHAPES] + [
    pytest.param(kernel, *shape, logits, id="-".join(map(str, (
        kernel, logits) + shape)))
    for kernel in ("fwd", "unfolded") for logits in ("unit", "randn")
    for shape in SHAPES]


@pytest.fixture(scope="module")
def bar():
    """The card's bar of each kernel, by name."""
    return {"bwd": attention.REL_F32_BWD, "fwd": attention.REL_F32_FWD,
            "unfolded": attention.REL_F32_FWD}


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


def _three_terms(eq, a, b):
    """3xTF32's three products, in the kernels' order: lo.hi, hi.lo,
    hi.hi."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return [torch.einsum(eq, al, bh), torch.einsum(eq, ah, bl),
            torch.einsum(eq, ah, bh)]


def _three(eq, a, b):
    """3xTF32 into one sum: lo.hi + hi.lo + hi.hi."""
    lo_hi, hi_lo, hi_hi = _three_terms(eq, a, b)
    return (lo_hi + hi_lo) + hi_hi


def _one(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _einsum_terms(eq, a, b):
    return [torch.einsum(eq, a, b)]


def _one_terms(eq, a, b):
    return [_one(eq, a, b)]


# products as lists of terms, summed in order: the kernels' 3xTF32, one
# TF32 product, and the plain product (the ideal, in float64)
TERMS = {"three": _three_terms, "one": _one_terms, "ideal": _einsum_terms}
MMS = {"three": _three, "one": _one, "ideal": torch.einsum}


def _tile(c):
    """Keys a tile of the float32 forwards (f32::tile in their sources)."""
    return 64 if c == 64 else 32


def _logits(q, kt, terms):
    """S (b, queries, keys) = q.kt^T of one key tile, as the float32
    forwards take it: 32 columns of C at a time, each chunk's product
    (as `terms`) added to the logits in float32."""
    return functools.reduce(torch.add, (
        functools.reduce(torch.add, terms("bjc,bic->bji", q[..., c0:c0 + 32],
                                          kt[..., c0:c0 + 32]))
        for c0 in range(0, q.shape[-1], 32)))


def _fwd(k, q, m, terms):
    """The forward kernel's arithmetic, every product as `terms`: key tiles
    of 64 at C = 64 and 32 above (csrc/attention_fwd.cu, f32::tile) with an
    online softmax; the logits summed 32 columns of C at a time and each
    tile's p.m apart, each added to its running sum in float32. Returns
    (out, lse)."""
    b, n, c = k.shape
    tile = _tile(c)
    o = torch.zeros_like(q)
    mx = torch.full((b, n), -np.inf, dtype=q.dtype)
    total = torch.zeros((b, n), dtype=q.dtype)
    for k0 in range(0, n, tile):
        s = _logits(q, k[:, k0:k0 + tile], terms)
        new_max = torch.maximum(mx, s.amax(dim=2))
        alpha = torch.exp(mx - new_max)
        p = torch.exp(s - new_max[..., None])
        total = total * alpha + p.sum(dim=2)
        mx = new_max
        pm = functools.reduce(torch.add, terms("bji,bic->bjc", p,
                                               m[:, k0:k0 + tile]))
        o = o * alpha[..., None] + pm
    return o / total[..., None], mx + torch.log(total)


def _unfolded(k, q, m, terms):
    """The unfolded forward's f32 body (csrc/attention_fwd_unfolded.cu),
    every product as `terms`: pass 1 takes each row's running max and sum
    over _fwd's key tiles; pass 2 recomputes the same logits, forms
    a = exp2((s - max) log2 e) / sum and adds each tile's a.m, summed
    apart, to the output in float32."""
    b, n, c = k.shape
    tile = _tile(c)
    mx = torch.full((b, n), -np.inf, dtype=q.dtype)
    total = torch.zeros((b, n), dtype=q.dtype)
    for k0 in range(0, n, tile):
        s = _logits(q, k[:, k0:k0 + tile], terms)
        new_max = torch.maximum(mx, s.amax(dim=2))
        total = total * torch.exp2((mx - new_max) * LOG2E) \
            + torch.exp2((s - new_max[..., None]) * LOG2E).sum(dim=2)
        mx = new_max
    inv = 1 / total
    o = torch.zeros_like(q)
    for k0 in range(0, n, tile):
        s = _logits(q, k[:, k0:k0 + tile], terms)
        a = torch.exp2((s - mx[..., None]) * LOG2E) * inv[..., None]
        o = o + functools.reduce(torch.add, terms("bji,bic->bjc", a,
                                                  m[:, k0:k0 + tile]))
    return o


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


def _inputs(b, n, c, seed, logits="unit"):
    """k, q, m, g float32 from numpy, logits of unit spread (N(0, 1) with
    logits="randn"), and the forward's out and lse."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, c)).astype(np.float32)
          for _ in range(4)]
    if logits == "unit":
        xs[0] *= c ** -0.25
        xs[1] *= c ** -0.25
    k, q, m, g = (torch.from_numpy(x) for x in xs)
    out, lse = attention.attention_fwd(k, q, m, with_lse=True)
    return k, q, m, out, lse, g


def _model(kernel, ts, products):
    """The kernel's outputs with every product taken as `products` (a key
    of TERMS), float64 for "ideal": (dk, dq, dm), or (out,) of the
    forward."""
    if products == "ideal":
        ts = [t.double() for t in ts]
    if kernel == "fwd":
        return _fwd(*ts[:3], TERMS[products])[:1]
    if kernel == "unfolded":
        return (_unfolded(*ts[:3], TERMS[products]),)
    return _bwd(*ts, MMS[products])


def _plain(kernel, ts):
    if kernel == "fwd":
        return (ts[3],)    # _inputs' out: attention_plain on the CPU
    if kernel == "unfolded":
        return (attention.attention_unfolded_plain(*ts[:3]),)
    return attention.attention_bwd_plain(*ts)


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


@pytest.mark.parametrize("kernel,b,n,c,logits", CASES)
def test_three_tf32_products_within_bar(bar, kernel, b, n, c, logits):
    ts = _inputs(b, n, c, seed=n + c, logits=logits)
    ideal = _model(kernel, ts, "ideal")
    plain = _plain(kernel, ts)
    got = _model(kernel, ts, "three")
    names = NAMES if kernel == "bwd" else ("out",)
    for name, a, i, p in zip(names, got, ideal, plain):
        assert _rel(a, i) <= bar[kernel], name
        assert _rel(a, p) <= bar[kernel], name
    if kernel == "fwd":     # the LSE at the card's bar for it
        lse = _fwd(*ts[:3], _three_terms)[1]
        torch.testing.assert_close(lse, ts[4], atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernel,b,n,c,logits", CASES)
def test_one_tf32_product_misses_bar(bar, kernel, b, n, c, logits):
    ts = _inputs(b, n, c, seed=n + c, logits=logits)
    plain = _plain(kernel, ts)
    got = _model(kernel, ts, "one")
    names = NAMES if kernel == "bwd" else ("out",)
    for name, a, p in zip(names, got, plain):
        assert _rel(a, p) > bar[kernel], name


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


def test_model_matches_pallas_forward():
    """At (1, 64, 16) the forward's 3xTF32 model gives what the Pallas
    forward gives in interpret mode, within the bar of
    tests/test_attention.py (atol 1e-4), and its LSE is torch.logsumexp of
    the logits within 1e-4."""
    k, q, m, _, lse, _ = _inputs(1, 64, 16, seed=6)
    got, got_lse = _fwd(k, q, m, _three_terms)
    want = jax_attention.fused_spatial_attention(
        *(jnp.asarray(t.numpy()) for t in (k, q, m)), 64, True, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    torch.testing.assert_close(got_lse, lse, atol=1e-4, rtol=0)


def _round1_pallas(k, q, m, q_block, mxu_bf16):
    """scripts/attn_microbench.py:make_pallas(fold=False), the round-1
    forward body, in interpret mode (the script itself runs on a TPU)."""
    b, n, c = k.shape

    def kernel(k_ref, q_ref, m_ref, o_ref):
        kk, qq, mm = k_ref[0], q_ref[0], m_ref[0]
        if mxu_bf16:
            kk, qq, mm = (x.astype(jnp.bfloat16) for x in (kk, qq, mm))
        logits = jnp.dot(kk, qq.T, preferred_element_type=jnp.float32)
        a = jax.nn.softmax(logits, axis=0)
        if mxu_bf16:
            a = a.astype(jnp.bfloat16)
        o_ref[0] = jnp.dot(a.T, mm, preferred_element_type=jnp.float32
                           ).astype(o_ref.dtype)

    return pl.pallas_call(
        kernel, grid=(b, pl.cdiv(n, q_block)),
        in_specs=[pl.BlockSpec((1, n, c), lambda bi, qi: (bi, 0, 0)),
                  pl.BlockSpec((1, q_block, c), lambda bi, qi: (bi, qi, 0)),
                  pl.BlockSpec((1, n, c), lambda bi, qi: (bi, 0, 0))],
        out_specs=pl.BlockSpec((1, q_block, c), lambda bi, qi: (bi, qi, 0)),
        out_shape=jax.ShapeDtypeStruct((b, n, c), m.dtype),
        interpret=True)(k, q, m)


def test_model_matches_round1_pallas_unfolded():
    """At (1, 64, 16) the unfolded body's 3xTF32 model gives what the
    microbenchmark's round-1 Pallas body gives in interpret mode, within
    the bar of tests/test_attention.py (atol 1e-4)."""
    k, q, m = _inputs(1, 64, 16, seed=7)[:3]
    got = _unfolded(k, q, m, _three_terms)
    want = _round1_pallas(*(jnp.asarray(t.numpy()) for t in (k, q, m)), 64,
                          False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
