"""Mode bf16's split operand, modelled on the CPU.

In mode bf16 (MODEL.computeDtype bfloat16) the attention kernels keep p
(forward and backward) and dS (backward) in float32, as the JAX kernel and
the port's plain twins do, but the tensor cores take bfloat16 operands. The
kernels feed each such x as two bfloat16 terms into one float32
accumulator: hi = bf16(x) and lo = bf16(x - hi). Here the twin's arithmetic
runs with that split on the same inputs, with float32 products of bfloat16
values (exact, as on the tensor cores) summed in float32, at two of the
model's (N, C) shapes; the outputs must stay within the bars the card holds
the kernels to against their twins: attention.REL_TWIN, 2^-7.5 (forward),
and REL_TWIN_BWD, 2^-12 (backward, relative norm errors). That a single
bfloat16 rounding of p or dS misses the backward's bar, at the same
shapes, is tests/test_torch_bf16.py::test_bwd_twin_bar_sees_rounding.
"""

import numpy as np
import pytest
import torch

from hupr_tpu_torch.ops import attention

SHAPES = [(2, 1024, 128), (2, 256, 256)]


def _round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x):
    hi = _round(x)
    return hi, _round(x - hi)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


def _inputs(b, n, c, seed):
    """k, q, m, g in bfloat16 from numpy, logits of unit spread."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, c)).astype(np.float32)
          for _ in range(4)]
    xs[0] *= c ** -0.25
    xs[1] *= c ** -0.25
    return [torch.from_numpy(x).to(torch.bfloat16) for x in xs]


def _fwd_split(k, q, m):
    """attention_plain's mode bf16 with p fed as hi + lo."""
    k, q, m = (t.float() for t in (k, q, m))
    logits = torch.einsum("bic,bjc->bij", k, q)
    p = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    out = sum(torch.einsum("bic,bij->bjc", m, t) for t in _split(p))
    return (out / p.sum(dim=1)[:, :, None]).to(torch.bfloat16)


def _bwd_terms(k, q, m, out, lse, g, terms):
    """attention_bwd_plain's mode bf16 with p and dS each fed as the
    bfloat16 terms `terms` gives."""
    k, q, m, g = (t.float() for t in (k, q, m, g))
    p = torch.exp(torch.einsum("bic,bjc->bij", k, q) - lse[:, None, :])
    dp = torch.einsum("bic,bjc->bij", m, g)
    ds = p * (dp - (g * out.float()).sum(dim=2)[:, None, :])
    dk = sum(torch.einsum("bij,bjc->bic", t, q) for t in terms(ds))
    dq = sum(torch.einsum("bij,bic->bjc", t, k) for t in terms(ds))
    dm = sum(torch.einsum("bij,bjc->bic", t, g) for t in terms(p))
    return tuple(x.to(torch.bfloat16) for x in (dk, dq, dm))


def test_split_carries_float32_to_2_pow_17():
    """hi + lo is within 2^-17 of x (hi is off by up to 2^-9 |x|, and lo
    rounds that remainder to 2^-9 of itself), across the range of p."""
    x = torch.exp(-30 * torch.rand(1 << 16, generator=torch.Generator()
                                   .manual_seed(0)))
    hi, lo = _split(x)
    assert ((hi + lo - x).abs() / x).max().item() <= 2.0 ** -17
    assert ((hi - x).abs() / x).max().item() > 2.0 ** -12


@pytest.mark.parametrize("b,n,c", SHAPES)
def test_forward_split_within_twin_bar(b, n, c):
    k, q, m, _ = _inputs(b, n, c, seed=n + c)
    twin = attention.attention_fwd(k, q, m)
    got = _fwd_split(k, q, m)
    assert got.dtype == twin.dtype == torch.bfloat16
    assert _rel(got.float(), twin.float()) <= attention.REL_TWIN


@pytest.mark.parametrize("b,n,c", SHAPES)
def test_backward_split_within_twin_bar(b, n, c):
    k, q, m, g = _inputs(b, n, c, seed=n + 2 * c)
    out, lse = attention.attention_fwd(k, q, m, with_lse=True)
    twin = attention.attention_bwd(k, q, m, out, lse, g)
    got = _bwd_terms(k, q, m, out, lse, g, _split)
    for name, a, w in zip(("dk", "dq", "dm"), got, twin):
        assert a.dtype == w.dtype == torch.bfloat16
        assert _rel(a.float(), w.float()) <= attention.REL_TWIN_BWD, name
