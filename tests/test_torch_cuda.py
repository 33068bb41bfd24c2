"""The port's CUDA kernels against their plain versions, and the train
step through them, on the card.

Skipped without a CUDA device. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which these tests do not use.)
"""

import pytest
import torch

from hupr_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                          attention_fwd, attention_plain,
                                          spatial_attention)
from hupr_tpu_torch.utils.device import float32_math

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with float32_math():
        yield torch.device("cuda")


@pytest.mark.parametrize("b,n,c", [
    (2, 4096, 64), (2, 1024, 128), (2, 256, 256),     # the serving shapes
    (3, 100, 64), (1, 1, 128), (2, 65, 256), (1, 1000, 64),  # ragged edges
])
def test_attention_fwd_matches_plain(cuda, b, n, c):
    """atol 1e-4: both float32, the kernel's online softmax and FMA order
    against cuBLAS matmuls and a two-pass softmax."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    k, q, m = (torch.randn((b, n, c), generator=gen, device=cuda)
               for _ in range(3))
    before = attention_fwd.launches
    with torch.inference_mode():
        got = attention_fwd(k, q, m)
        want = attention_plain(k, q, m)
    torch.cuda.synchronize()
    assert attention_fwd.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4


def test_attention_fwd_large_logits_stay_finite(cuda):
    """Logits in the hundreds: the online softmax rescales without
    overflow, as the plain two-pass softmax does."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    k, q, m = (torch.randn((1, 512, 64), generator=gen, device=cuda) * 4
               for _ in range(3))
    with torch.inference_mode():
        got = attention_fwd(k, q, m)
        want = attention_plain(k, q, m)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_attention_fwd_refuses_grad_on_cuda(cuda):
    k, q, m = (torch.randn((1, 256, 64), device=cuda) for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        attention_fwd(k, q, m)


def _bwd_inputs(b, n, c, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    k, q, m, g = (torch.randn((b, n, c), generator=gen, device=device)
                  for _ in range(4))
    # logits of unit spread: the softmax spreads over many keys (at N(0, 1)
    # inputs it is nearly one-hot and the sums have one term that matters)
    k, q = k * c ** -0.25, q * c ** -0.25
    with torch.inference_mode():
        out, lse = attention_fwd(k, q, m, with_lse=True)
    return k, q, m, out, lse, g


@pytest.mark.parametrize("b,n,c", [
    (2, 4096, 64), (2, 1024, 128), (2, 256, 256),     # the path shapes
] + [(2, n, c) for c in (64, 128, 256) for n in (1, 65, 100, 1000)])
def test_attention_bwd_matches_plain(cuda, b, n, c):
    """atol 1e-3 + rtol 1e-4, the bar of tests/test_attention.py for the
    Pallas backward: both float32, the kernel's tile-ordered FMA sums
    against cuBLAS products over (N, N) matrices. Ragged N masks missing
    keys and queries in both passes."""
    k, q, m, out, lse, g = _bwd_inputs(b, n, c, cuda, seed=n + c)
    before = attention_bwd.launches
    got = attention_bwd(k, q, m, out, lse, g)
    want = attention_bwd_plain(k, q, m, out, lse, g)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    for name, a, w in zip(("dk", "dq", "dm"), got, want):
        torch.testing.assert_close(a, w, atol=1e-3, rtol=1e-4, msg=name)


@pytest.mark.parametrize("n,c", [(4096, 64), (1024, 128), (256, 256),
                                 (100, 64), (1, 256)])
def test_attention_fwd_lse(cuda, n, c):
    """The LSE is torch.logsumexp of the logits over keys, and asking for
    it leaves out bit for bit as it was."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    k, q, m = (torch.randn((2, n, c), generator=gen, device=cuda)
               for _ in range(3))
    with torch.inference_mode():
        out, lse = attention_fwd(k, q, m, with_lse=True)
        alone = attention_fwd(k, q, m)
        want = torch.logsumexp(torch.einsum("bic,bjc->bij", k, q), dim=1)
    torch.cuda.synchronize()
    assert torch.equal(out, alone)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


def test_fused_attention_function_on_card(cuda):
    """spatial_attention under autograd launches both kernels once and
    gives the gradients autograd takes through the plain version; the
    strided output gradient of the decoder's transpose is accepted."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    ts = [torch.randn((2, 1024, 128), generator=gen, device=cuda)
          .requires_grad_(True) for _ in range(3)]
    w = torch.randn((2, 128, 1024), generator=gen, device=cuda)
    before = attention_fwd.launches, attention_bwd.launches
    out = spatial_attention(*ts)
    got = torch.autograd.grad((out.transpose(1, 2) * w).sum(), ts)
    assert (attention_fwd.launches, attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = attention_plain(*ts)
    want = torch.autograd.grad((plain.transpose(1, 2) * w).sum(), ts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)


def test_train_step_on_card(cuda):
    """Three train steps at the kernels' widths (numFilters 32) on 16x16
    maps: 12 forward and 12 backward launches a step, finite losses within
    rtol 2e-4 of the same steps through the plain attention."""
    import numpy as np

    from hupr_tpu_torch.config import config_from_dict
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import HuPRNet
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    h, b = 16, 2
    rng = np.random.default_rng(0)
    shape = (b, 8, 8, 2, h, h, 8)
    batches = [{"hori": rng.standard_normal(shape).astype(np.float32),
                "vert": rng.standard_normal(shape).astype(np.float32),
                "jointsGroup": rng.uniform(4, 4 * h - 4, (b, 14, 2))}
               for _ in range(3)]
    weights = synthetic_state_dict(HuPRNet(num_filters=32, heatmap_size=h),
                                   seed=0, scale=0.03)
    cfg = config_from_dict({})
    losses = {}
    for impl in ("pallas", "xla"):
        model = HuPRNet(num_filters=32, heatmap_size=h,
                        attn_impl=impl).to(cuda).eval()
        model.load_state_dict(weights, strict=True)
        tx = make_optimizer(cfg, model)
        state = TrainState(model, tx)
        step = make_train_step(model, tx, -1.0, (14, h, 4 * h))
        losses[impl] = []
        for batch in batches:
            before = attention_fwd.launches, attention_bwd.launches
            state, metrics = step(state, batch, 1e-4, 0.0)
            launched = (attention_fwd.launches - before[0],
                        attention_bwd.launches - before[1])
            assert launched == ((12, 12) if impl == "pallas" else (0, 0))
            losses[impl].append(metrics["loss"].item())
    assert np.isfinite(losses["pallas"]).all()
    np.testing.assert_allclose(losses["pallas"], losses["xla"], rtol=2e-4)
