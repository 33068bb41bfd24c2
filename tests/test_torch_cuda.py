"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a CUDA device. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which these tests do not use.)
"""

import pytest
import torch

from hupr_tpu_torch.ops.attention import attention_fwd, attention_plain
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
