"""The port's CUDA kernels against their plain versions, and the train
step through them, on the card.

Skipped without a CUDA device. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which these tests do not use.)
"""

import importlib.util
import math
import os

import pytest
import torch

from hupr_tpu_torch.ops.attention import (attention_bwd, attention_bwd_plain,
                                          attention_fwd,
                                          attention_fwd_unfolded,
                                          attention_plain,
                                          attention_unfolded_plain,
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
    """atol 1e-4: both float32, the kernel's online softmax and tile-ordered
    3xTF32 sums against cuBLAS matmuls and a two-pass softmax."""
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


def _chip_smoke():
    """chip_smoke.py as a module, for its bars."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("b,n,c", [(2, 4096, 64), (2, 1024, 128),
                                   (2, 256, 256), (2, 1000, 128)])
def test_attention_fwd_f32_within_rel_bar(cuda, b, n, c):
    """The float32 forward within chip_smoke.REL_F32_FWD (relative norm
    error) of the plain version at the path shapes and a ragged N, on N(0,
    1) inputs as chip_smoke.check_attention draws them: the bar that 3xTF32
    keeps and one TF32 product misses (tests/test_torch_tf32.py)."""
    smoke = _chip_smoke()
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    k, q, m = (torch.randn((b, n, c), generator=gen, device=cuda)
               for _ in range(3))
    with torch.inference_mode():
        got = attention_fwd(k, q, m)
        want = attention_plain(k, q, m)
    torch.cuda.synchronize()
    assert smoke.rel_err(got, want) <= smoke.REL_F32_FWD


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
    Pallas backward: both float32, the kernel's tile-ordered 3xTF32 sums
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


@pytest.mark.parametrize("b,n,c", [(2, 4096, 64), (2, 1024, 128),
                                   (2, 256, 256)])
def test_attention_bwd_f32_within_rel_bar(cuda, b, n, c):
    """Each float32 gradient within chip_smoke.REL_F32_BWD (relative norm
    error) of the plain version at the path shapes: the bar that 3xTF32
    keeps and one TF32 product misses (tests/test_torch_tf32.py)."""
    smoke = _chip_smoke()
    k, q, m, out, lse, g = _bwd_inputs(b, n, c, cuda, seed=n + c + 1)
    got = attention_bwd(k, q, m, out, lse, g)
    want = attention_bwd_plain(k, q, m, out, lse, g)
    torch.cuda.synchronize()
    for name, a, w in zip(("dk", "dq", "dm"), got, want):
        assert smoke.rel_err(a, w) <= smoke.REL_F32_BWD, name


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_on_card(cuda, dtype):
    """MODEL.remat on the card at the kernels' widths (numFilters 32) on
    16x16 maps: one step with remat and one without from the same weights,
    12 forward and 12 backward launches each (the recompute launches
    none), losses, weights and BN statistics at the train slices' bars
    (chip_smoke.TRAIN_BARS, PARAM_ATOL / PARAM_RTOL) and
    num_batches_tracked equal."""
    import numpy as np

    from hupr_tpu_torch.config import config_from_dict
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    smoke = _chip_smoke()
    bars = smoke.TRAIN_BARS["f32" if dtype == "float32" else "bf16"]
    h, b = 16, 2
    rng = np.random.default_rng(1)
    shape = (b, 8, 8, 2, h, h, 8)
    batch = {"hori": rng.standard_normal(shape).astype(np.float32),
             "vert": rng.standard_normal(shape).astype(np.float32),
             "jointsGroup": rng.uniform(4, 4 * h - 4, (b, 14, 2))}
    models, losses, weights = {}, {}, None
    for remat in (False, True):
        cfg = config_from_dict({
            "DATASET": {"rangeSize": h, "azimuthSize": h, "heatmapSize": h,
                        "imgSize": 4 * h},
            "MODEL": {"attention": "pallas", "computeDtype": dtype,
                      "remat": remat}})
        model = build_model(cfg, device=cuda)
        if weights is None:
            weights = synthetic_state_dict(model, seed=0, scale=0.03)
        model.load_state_dict(weights, strict=True)
        tx = make_optimizer(cfg, model)
        step = make_train_step(model, tx, -1.0, (14, h, 4 * h))
        before = attention_fwd.launches, attention_bwd.launches
        _, metrics = step(TrainState(model, tx), batch, 1e-4, 0.0)
        assert (attention_fwd.launches - before[0],
                attention_bwd.launches - before[1]) == (12, 12)
        models[remat], losses[remat] = model, metrics["loss"].item()
    assert math.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) <= \
        bars["loss_rtol"] * abs(losses[False])
    for (key, a), c in zip(models[False].state_dict().items(),
                           models[True].state_dict().values()):
        if not a.is_floating_point():
            assert torch.equal(a, c), key
        elif key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(c, a, atol=bars["stats"][0],
                                       rtol=bars["stats"][1], msg=key)
        else:
            torch.testing.assert_close(c, a, atol=smoke.PARAM_ATOL,
                                       rtol=smoke.PARAM_RTOL, msg=key)


# ------------------------------------------------------------ bfloat16 modes

# (input dtype, bf16_ops) of the three modes beside full float32
BF16_MODES = [(torch.bfloat16, False), (torch.float32, True),
              (torch.bfloat16, True)]
MODE_IDS = ["bf16", "f32_bf16ops", "bf16_bf16ops"]
BF16_SHAPES = [(2, 4096, 64), (2, 1024, 128), (2, 256, 256)] + [
    (2, n, c) for c in (64, 128, 256) for n in (1, 65, 100, 1000)]


def _assert_rel(got, want, name, bar=2.0 ** -8.5):
    """Relative norm error below `bar` (bfloat16 rounds to 2^-9 relative;
    kernel and twin round at the same points but may round a value the
    other way, or p against another maximum), with an absolute slack of
    1e-4 per element for outputs that are zero up to float32 noise (N=1)."""
    got, want = got.float(), want.float()
    err = (got - want).norm().item()
    assert err <= bar * want.norm().item() + 1e-4 * want.numel() ** 0.5, \
        (name, err, want.norm().item())


def _unit_spread(b, n, c, dtype, device, seed, count=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    ts = [torch.randn((b, n, c), generator=gen, device=device)
          for _ in range(count)]
    # logits of unit spread, as in _bwd_inputs
    ts[0], ts[1] = ts[0] * c ** -0.25, ts[1] * c ** -0.25
    return [t.to(dtype) for t in ts]


@pytest.mark.parametrize("dtype,bf16_ops", BF16_MODES, ids=MODE_IDS)
@pytest.mark.parametrize("b,n,c", BF16_SHAPES)
def test_attention_fwd_bf16_modes_match_twin(cuda, b, n, c, dtype, bf16_ops):
    """Each mode against its plain twin in the working dtype: out in the
    inputs' dtype within the relative bar, the LSE float32 within 1e-4
    (float32 sums of exact products in another order), one launch counted
    under the mode."""
    k, q, m = _unit_spread(b, n, c, dtype, cuda, seed=n + c)
    mode = ("bf16" if dtype == torch.bfloat16 else "f32") + (
        "_bf16ops" if bf16_ops else "")
    before = attention_fwd.launches_by_mode.get(mode, 0)
    with torch.inference_mode():
        out, lse = attention_fwd(k, q, m, with_lse=True, bf16_ops=bf16_ops)
        want, want_lse = attention_plain(k, q, m, True, bf16_ops)
    torch.cuda.synchronize()
    assert attention_fwd.launches_by_mode[mode] == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    _assert_rel(out, want, "out")
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,bf16_ops", BF16_MODES, ids=MODE_IDS)
@pytest.mark.parametrize("b,n,c", BF16_SHAPES)
def test_attention_bwd_bf16_modes_match_twin(cuda, b, n, c, dtype, bf16_ops):
    """The backward of each mode against its twin, from the same forward
    residuals: dk, dq, dm in the inputs' dtype within 2^-12 relative. The
    two round at the same points, so only a float32 sum in another order
    that rounds a value the other way separates them, and moving one
    rounding point moves the twin by more (tests/test_torch_bf16.py::
    test_bwd_twin_bar_sees_rounding)."""
    k, q, m, g = _unit_spread(b, n, c, dtype, cuda, seed=n + 2 * c, count=4)
    with torch.inference_mode():
        out, lse = attention_fwd(k, q, m, with_lse=True, bf16_ops=bf16_ops)
    got = attention_bwd(k, q, m, out, lse, g, bf16_ops=bf16_ops)
    want = attention_bwd_plain(k, q, m, out, lse, g, bf16_ops)
    torch.cuda.synchronize()
    for name, a, w in zip(("dk", "dq", "dm"), got, want):
        assert a.dtype == dtype
        _assert_rel(a, w, name, bar=2.0 ** -12)


@pytest.mark.parametrize("bf16_ops", [False, True], ids=["f32", "bf16ops"])
@pytest.mark.parametrize("b,n,c", [(2, 4096, 64), (2, 1024, 128),
                                   (2, 256, 256), (2, 100, 64), (1, 1, 128),
                                   (2, 1000, 256)])
def test_attention_fwd_unfolded_matches_twin(cuda, b, n, c, bf16_ops):
    """The unfolded forward against its twin: float32 within 1e-4 and
    chip_smoke.REL_F32_FWD (the folded forward's bars, which 3xTF32 keeps:
    tests/test_torch_tf32.py models this kernel's arithmetic), bf16_ops
    within the relative bar; two calls bit-identical in both modes."""
    k, q, m = _unit_spread(b, n, c, torch.float32, cuda, seed=n)
    before = attention_fwd_unfolded.launches
    got = attention_fwd_unfolded(k, q, m, bf16_ops=bf16_ops)
    again = attention_fwd_unfolded(k, q, m, bf16_ops=bf16_ops)
    want = attention_unfolded_plain(k, q, m, bf16_ops)
    torch.cuda.synchronize()
    assert attention_fwd_unfolded.launches == before + 2
    assert torch.equal(got, again)
    if bf16_ops:
        _assert_rel(got, want, "out")
    else:
        smoke = _chip_smoke()
        assert (got - want).abs().max().item() <= 1e-4
        assert smoke.rel_err(got, want) <= smoke.REL_F32_FWD


@pytest.mark.parametrize("compute,attn", [("bfloat16", "pallas"),
                                          ("float32", "pallas_bf16"),
                                          ("bfloat16", "pallas_bf16")])
def test_bf16_train_step_on_card(cuda, compute, attn):
    """Two train steps at the kernels' widths (numFilters 32) on 16x16
    maps: 12 + 12 launches a step, all in the expected mode; float32 losses
    and grads; losses within rtol 1e-2 of the same steps through the eager
    attention ('xla') in the same compute dtype, which rounds at other
    points (its softmax to bfloat16 in bfloat16 compute; nothing in
    float32), so the two differ at bfloat16's level."""
    import numpy as np

    from hupr_tpu_torch.config import config_from_dict
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    h, b = 16, 2
    rng = np.random.default_rng(1)
    shape = (b, 8, 8, 2, h, h, 8)
    batches = [{"hori": rng.standard_normal(shape).astype(np.float32),
                "vert": rng.standard_normal(shape).astype(np.float32),
                "jointsGroup": rng.uniform(4, 4 * h - 4, (b, 14, 2))}
               for _ in range(2)]
    mode = ("bf16" if compute == "bfloat16" else "f32") + (
        "_bf16ops" if attn == "pallas_bf16" else "")
    losses = {}
    for impl in (attn, "xla"):
        cfg = config_from_dict({"DATASET": {"heatmapSize": h},
                                "MODEL": {"computeDtype": compute,
                                          "attention": impl}})
        model = build_model(cfg, device=cuda)
        model.load_state_dict(synthetic_state_dict(model, seed=0,
                                                   scale=0.03), strict=True)
        tx = make_optimizer(cfg, model)
        state = TrainState(model, tx)
        step = make_train_step(model, tx, -1.0, (14, h, 4 * h))
        losses[impl] = []
        for batch in batches:
            attention.reset_launch_counts()
            state, metrics = step(state, batch, 1e-4, 0.0)
            want = {mode: 12} if impl == attn else {}
            assert attention.attention_fwd.launches_by_mode == want
            assert attention.attention_bwd.launches_by_mode == want
            assert metrics["loss"].dtype == torch.float32
            losses[impl].append(metrics["loss"].item())
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in model.parameters())
    assert np.isfinite(losses[attn]).all()
    np.testing.assert_allclose(losses[attn], losses["xla"], rtol=1e-2)


@pytest.mark.parametrize("dtype,bf16_ops", [(torch.float32, False)]
                         + BF16_MODES, ids=["f32"] + MODE_IDS)
@pytest.mark.parametrize("b,n,c", [(2, 4096, 64), (2, 1024, 128),
                                   (2, 1000, 256)])
def test_kernels_repeat_bit_for_bit(cuda, b, n, c, dtype, bf16_ops):
    """Two calls of each kernel on the same inputs give the same bits in
    every mode: each block owns the rows it writes and sums them in a fixed
    order, with no atomics."""
    k, q, m, g = _unit_spread(b, n, c, dtype, cuda, seed=7, count=4)
    with torch.inference_mode():
        fwd = [attention_fwd(k, q, m, with_lse=True, bf16_ops=bf16_ops)
               for _ in range(2)]
    out, lse = fwd[0]
    bwd = [attention_bwd(k, q, m, out, lse, g, bf16_ops=bf16_ops)
           for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, w in zip(("out", "lse", "dk", "dq", "dm"),
                          fwd[0] + bwd[0], fwd[1] + bwd[1]):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("dtype,bf16_ops", [(torch.float32, False)]
                         + BF16_MODES, ids=["f32"] + MODE_IDS)
def test_tensor_core_modes_take_unaligned_inputs(cuda, dtype, bf16_ops):
    """cp.async copies 16 bytes at a time: an input that starts off a
    16-byte boundary (a contiguous view at an odd offset) gives the same
    bits as an aligned copy of it."""
    b, n, c = 2, 100, 64
    ts = _unit_spread(b, n, c, dtype, cuda, seed=11, count=4)
    shifted = []
    for t in ts:
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    with torch.inference_mode():
        want = attention_fwd(*ts[:3], with_lse=True, bf16_ops=bf16_ops)
        got = attention_fwd(*shifted[:3], with_lse=True, bf16_ops=bf16_ops)
    grads = [attention_bwd(*xs[:3], *want, xs[3], bf16_ops=bf16_ops)
             for xs in (ts, shifted)]
    torch.cuda.synchronize()
    for a, w in zip(got + grads[1], want + grads[0]):
        assert torch.equal(a, w)


# ------------------------------------------------------------------ Runner

def test_runner_epoch_on_card(cuda, tmp_path, monkeypatch):
    """One epoch of the Runner at the kernels' widths (numFilters 32) on
    32x32 maps, from a seeded checkpoint.pth over a 12-frame sequence
    (train batch 8: one full step and one of 4 rows; test batch 8): 12
    forward and 12 backward launches a step and 12 forward launches an
    eval batch, finite losses, checkpoints written; then sequence and
    classic eval of model_best.pth agree on AP within 5e-3 (the protocol
    tier of tests/test_golden_ap.py)."""
    import json

    from hupr_tpu_torch.config import config_from_dict
    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.ops import attention

    smoke = _chip_smoke()
    frames, h = 12, 32
    data = smoke.write_sequence(str(tmp_path), frames, spatial=h)
    cfg = config_from_dict({
        "DATASET": {"duration": frames, "dataDir": data, "rangeSize": h,
                    "azimuthSize": h, "heatmapSize": h, "imgSize": 4 * h,
                    "trainName": [1], "valName": [1], "testName": [1]},
        "MODEL": {"numFilters": 32, "attention": "pallas"},
        "TRAINING": {"batchSize": 8, "epochs": 1},
        "TEST": {"batchSize": 8}})
    monkeypatch.chdir(tmp_path)
    smoke.seed_checkpoint(cfg, "card")
    args = smoke.runner_args("card")
    runner = Runner(args, cfg)
    runner.load_model_weight("checkpoint")
    attention.reset_launch_counts()
    runner.train()
    torch.cuda.synchronize()
    assert (attention.attention_fwd.launches,
            attention.attention_bwd.launches) == (12 * 2 + 12 * 2, 12 * 2)
    with open("logs/card/train_loss_list_0.json") as fp:
        losses = json.load(fp)
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert {"model_best.pth", "checkpoint.pth", "checkpoint_0.pth"} <= \
        set(os.listdir("logs/card"))
    aps = []
    for sequence in (True, False):
        cfg.TEST.sequenceEval = sequence
        ev = Runner(smoke.runner_args("card", True), cfg)
        ev.load_model_weight("model_best")
        aps.append(ev.eval(visualization=False))
    assert 0.0 < aps[0] < 1.0
    assert abs(aps[0] - aps[1]) <= 5e-3


# --------------------------------------------------------------- streaming

@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("n,c", [(256, 256), (1024, 128), (4096, 64)])
def test_attention_fwd_b1_matches_plain(cuda, n, c, mode):
    """The forward at B=1, as the stream launches it (a (256, 256) call is
    4 blocks): float32 within 1e-4 and chip_smoke's REL_F32_FWD of the
    plain version, bfloat16 within 2^-7.5 of its twin and 2^-8.5 of the
    float32 ideal."""
    smoke = _chip_smoke()
    if mode == "f32":
        gen = torch.Generator(device=cuda).manual_seed(n)
        k, q, m = (torch.randn((1, n, c), generator=gen, device=cuda)
                   for _ in range(3))
    else:
        k, q, m = _unit_spread(1, n, c, torch.bfloat16, cuda, seed=n)
    with torch.inference_mode():
        got = attention_fwd(k, q, m)
        want = attention_plain(k, q, m)
        ideal = attention_plain(*(t.float() for t in (k, q, m)))
    torch.cuda.synchronize()
    if mode == "f32":
        assert (got - want).abs().max().item() <= 1e-4
        assert smoke.rel_err(got, want) <= smoke.REL_F32_FWD
    else:
        _assert_rel(got, want, "twin", 2.0 ** -7.5)
        _assert_rel(got, ideal, "ideal")


def _traced_attention_kernels(fn):
    """(fn(), the forward attention kernels the card ran in it, from
    torch.profiler's device events), the window padded as
    chip_smoke.card_trace pads it."""
    from torch.profiler import ProfilerActivity

    with _chip_smoke().card_trace(torch, [ProfilerActivity.CUDA]) as prof:
        out = fn()
    return out, sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and ("::attention_fwd_tf32<" in e.name
                    or "::attention_fwd_tc<" in e.name))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_stream_graph_step_equals_eager(cuda, compute):
    """StreamingPoseEstimator at the kernels' widths (numFilters 32) on
    32x32 maps from a reduced capture: the CUDA graph step against the
    eager step over one sequence of 10 frames and the flush: the same
    keypoints, maxvals within 1e-5. The wrappers count the eager steps'
    launches, the capture's warm-up step and the capture itself, and no
    replay; the card's trace of a replayed frame holds the 12 forward
    kernels."""
    import numpy as np

    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
    from hupr_tpu_torch.models.hupr import HuPRNet
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.ops.dsp import RadarParams
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    rp = RadarParams(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                     num_group_chirp=2)
    model = HuPRNet(num_filters=32, heatmap_size=32, attn_impl="pallas",
                    compute_dtype=getattr(torch, compute))
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    rng = np.random.default_rng(1)
    frames = [rng.integers(-300, 300, (10, 4, 48, 128)).astype(np.int16)
              for _ in range(4)]
    outs = {}
    for graph in (True, False):
        est = StreamingPoseEstimator(model, state, rp, cuda_graph=graph)
        outs[graph] = []
        for t in range(10):
            before = attention.attention_fwd.launches

            def step(t=t):
                return est.process_frame((frames[0][t], frames[1][t]),
                                         (frames[2][t], frames[3][t]))

            if graph and t == 9:
                got, traced = _traced_attention_kernels(step)
                assert traced == 12
            else:
                got = step()
            outs[graph].append(got)
            launched = attention.attention_fwd.launches - before
            # the first graph step runs the capture's warm-up step and
            # records the capture; a replay calls no wrapper
            if graph:
                assert launched == {0: 12, 1: 24}.get(t, 0)
            else:
                assert launched == 12
        outs[graph] += est.flush()
        assert est.cuda_graph is graph and len(outs[graph]) == 13
    for (p, m), (pe, me) in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(p, pe)
        np.testing.assert_allclose(m, me, rtol=0, atol=1e-5)
    assert np.std([m for _, m in outs[True]]) > 1e-3


def test_two_rank_shared_card_step_equals_one_rank(cuda, tmp_path):
    """The data-parallel step in two processes sharing the card over gloo
    (chip_smoke.dp_step_phase; NCCL refuses two ranks on one device) at
    the kernels' widths (numFilters 32) on 32x32 maps: 19 real rows padded
    to 20, 10 a rank, 8 steps from seeded N(0, 0.03) weights, against the
    one-rank masked step on the card from the same weights: the ranks'
    replicas equal bit for bit, 12 + 12 launches a step on each rank,
    losses, weights, BN statistics and each leaf's update at the runner
    phase's bars (chip_smoke.hold_readings)."""
    smoke = _chip_smoke()
    out = smoke.dp_step_phase(torch, "f32", str(tmp_path), spatial=32)
    assert out["replicas_equal"] and out["finite"]
    assert out["update_max_rel_err"] <= smoke.RUNNER_UPDATE_RTOL
    assert out["launches_by_rank"] == [
        {"attention_fwd": 12 * smoke.DP_STEPS,
         "attention_bwd": 12 * smoke.DP_STEPS}] * 2


def test_two_rank_shared_card_request_equals_one_process(cuda, tmp_path):
    """One request's 32 frames split over two processes sharing the card
    over gloo (chip_smoke.shard_phase; NCCL refuses two ranks on one
    device), at the kernels' width (numFilters 32) on 32x32 maps from a
    reduced capture, against make_e2e_infer in this process on the same
    requests and weights: the ranks' results equal bit for bit, maxvals
    within 1e-4 and 99 % of keypoints equal, 12 launches a request on each
    rank, the same for an 8-frame request of two 4-frame sequences."""
    smoke = _chip_smoke()
    out = smoke.shard_phase(torch, "card test", str(tmp_path), spatial=32,
                            modes=("f32",), seq_eval=False, world_one=False)
    f32 = out["f32"]
    assert f32["replicas_equal"]
    assert f32["maxvals_max_abs_err"] <= smoke.MAXVAL_TOL
    assert f32["keypoint_agreement"] >= smoke.STREAM_AGREE["f32"]
    assert f32["launches_by_rank"] == [12 * smoke.SHARD_REQUESTS] * 2
    assert f32["small_launches_by_rank"] == [12, 12]


@pytest.mark.parametrize("compute,bars", [("float32", (1e-6, 0.99)),
                                          ("bfloat16", (1e-2, 0.95))])
def test_exported_artifact_on_card(cuda, tmp_path, compute, bars):
    """An artifact exported on the CPU at the kernels' widths (numFilters
    32) on 32x32 maps from a reduced capture, loaded onto the card: 12
    forward kernel launches a request in the compute dtype's mode, and
    make_e2e_infer's outputs on the same frames at the float32 bars of
    tests/test_export.py (one program, one card) or the stream's bfloat16
    bars."""
    import numpy as np

    from hupr_tpu_torch.engine import export
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import HuPRNet
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.ops.dsp import RadarParams
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    rp = RadarParams(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                     num_group_chirp=2)
    model = HuPRNet(num_filters=32, heatmap_size=32, attn_impl="pallas",
                    compute_dtype=getattr(torch, compute))
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    blob = export.export_serving(model, state, rp, frames=8)
    path = str(tmp_path / "serving.pt2")
    export.save_artifact(path, blob)
    serve = export.load_artifact(path)
    rng = np.random.default_rng(2)
    frames = [rng.integers(-300, 300, (8, 4, 48, 128)).astype(np.int16)
              for _ in range(4)]
    live = make_e2e_infer(model, None, rp, duration=8)(*frames)
    attention.reset_launch_counts()
    pred, maxv = serve(*frames)
    torch.cuda.synchronize()
    mode = "f32" if compute == "float32" else "bf16"
    assert attention.attention_fwd.launches_by_mode == {mode: 12}
    assert attention.attention_bwd.launches == 0
    tol, agree = bars
    assert (maxv - live[1]).abs().max().item() <= tol
    assert (pred == live[0]).all(dim=-1).float().mean().item() >= agree
    assert maxv.std().item() > 1e-3


def test_entry_on_card(cuda):
    """graft_entry.entry() on the card: the flagship forward (batch 2,
    default N(0, 0.05) weights) through the kernel, 12 forward launches
    and no backward a call, both heatmaps within 1e-4 of the same model
    and weights through the plain attention on the same inputs."""
    import copy

    from hupr_tpu_torch import graft_entry
    from hupr_tpu_torch.config import flagship_serving_config
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    forward, (hori, vert) = graft_entry.entry()
    assert hori.device.type == vert.device.type == "cuda"
    attention.reset_launch_counts()
    got = forward(hori, vert)
    torch.cuda.synchronize()
    assert attention.attention_fwd.launches_by_mode == {"f32": 12}
    assert attention.attention_bwd.launches == 0
    cfg = copy.deepcopy(flagship_serving_config())
    cfg.MODEL.attention = "xla"
    plain = build_model(cfg, "cpu")
    plain.load_state_dict(synthetic_state_dict(plain, seed=0, scale=0.05))
    plain = plain.to("cuda").eval()
    with torch.inference_mode():
        want = plain(hori, vert)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert (g - w).abs().max().item() <= 1e-4


def _small_request():
    """make_e2e_infer at the kernels' widths (numFilters 32) on 32x32 maps
    from a reduced capture, and an 8-frame request of int16 planes on the
    host."""
    import numpy as np

    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import HuPRNet
    from hupr_tpu_torch.ops.dsp import RadarParams
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    rp = RadarParams(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                     num_group_chirp=2)
    model = HuPRNet(num_filters=32, heatmap_size=32, attn_impl="pallas")
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    rng = np.random.default_rng(2)
    planes = [rng.integers(-300, 300, (8, 4, 48, 128)).astype(np.int16)
              for _ in range(4)]
    return make_e2e_infer(model, state, rp, duration=8), planes


def test_encoder3d_span_times_its_work_on_the_card(cuda):
    """Under the profiler, the span `hupr.encoder3d` reads the card's time
    of each encoder call from its CUDA events: two calls a request, a
    positive device time inside the request's host span."""
    from torch.profiler import ProfilerActivity, profile

    from hupr_tpu_torch.utils import profiling

    run, planes = _small_request()
    run(*planes)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(*planes)
        torch.cuda.synchronize()
    spans = profiling.table()["spans"]
    profiling.reset()
    enc, request = spans["hupr.encoder3d"], spans["hupr.serve.request"]
    assert enc["count"] == 2
    assert 0 < enc["device_s"] < request["host_s"]
    assert all("device_s" not in s for n, s in spans.items()
               if n != "hupr.encoder3d")


def test_stream_graph_capture_under_a_profiler(cuda):
    """The stream's CUDA graph captured while a profiler records (the
    device spans inside the capture record no event): the same poses as
    an estimator captured with no profiler, and the frame's spans."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
    from hupr_tpu_torch.models.hupr import HuPRNet
    from hupr_tpu_torch.ops.dsp import RadarParams
    from hupr_tpu_torch.utils import profiling
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    rp = RadarParams(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                     num_group_chirp=2)
    model = HuPRNet(num_filters=32, heatmap_size=32, attn_impl="pallas",
                    compute_dtype=torch.bfloat16)
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    rng = np.random.default_rng(3)
    frames = [rng.integers(-300, 300, (4, 4, 48, 128)).astype(np.int16)
              for _ in range(4)]

    def push(est, t):
        return est.process_frame((frames[0][t], frames[1][t]),
                                 (frames[2][t], frames[3][t]))

    plain = StreamingPoseEstimator(model, state, rp)
    want = [push(plain, t) for t in range(4)]
    traced = StreamingPoseEstimator(model, state, rp)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = [push(traced, t) for t in range(4)]
        torch.cuda.synchronize()
    spans = profiling.table()["spans"]
    profiling.reset()
    assert traced._graphs
    for (p, m), (pw, mw) in zip(got, want):
        np.testing.assert_array_equal(p, pw)
        np.testing.assert_allclose(m, mw, rtol=0, atol=1e-5)
    assert spans["hupr.stream.frame"]["count"] == 4
    assert spans["hupr.stream.replay"]["count"] == 3
    assert spans["hupr.stream.fetch"]["count"] == 4


def test_spans_stay_off_the_cards_kernels(cuda, monkeypatch):
    """gpubench.trace.traced over a served request: with the program's
    spans on, no `hupr.*` name among the card's kernels, and the host's
    launch calls those of the same request with the spans taken out."""
    from gpubench import trace

    from hupr_tpu_torch.utils import profiling

    run, planes = _small_request()
    run(*planes)
    on = trace.traced(lambda: run(*planes), 1, 8)
    profiling.reset()
    monkeypatch.setattr(profiling, "annotate",
                        lambda name, device=False: profiling._NO_SPAN)
    off = trace.traced(lambda: run(*planes), 1, 8)
    assert on.kernels and not [k for k in on.kernels
                               if k[0].startswith("hupr.")]
    assert not [k for k, _ in on.device_ops if k.startswith("hupr.")]
    assert on.host_launches == off.host_launches > 0
