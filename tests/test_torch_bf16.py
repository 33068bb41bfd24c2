"""The port's bfloat16 compute path (MODEL.computeDtype bfloat16 and
MODEL.attention pallas_bf16) against hupr_tpu's on the same numpy inputs:
the attention kernels' plain twins in each mode against the Pallas kernels
run in interpret mode, the unfolded forward's twin and a model of its
bf16_ops kernel's rounding points against the microbenchmark's round-1
body, the dtypes at the model's boundaries, the
whole bfloat16 forward, serving, and a 3-step bfloat16 train trajectory
and an eval step, at reduced geometry (F=4, 16x16 maps).

bfloat16 keeps 8 significant bits: one rounding is off by up to 2^-9
relative, and a norm over many roundings sits near 2^-9.5. The kernels'
bars are relative norm errors: 2^-8.5 against the float32 ideal on the same
values (the bar of tests/test_attention.py for bfloat16 gradients), and
2^-7.5 between the port's twin and the JAX kernel (each within 2^-8.5 of
the ideal). The JAX package's Pallas attention is patched to run in
interpret mode for the whole model (its decoder imports it at call time).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hupr_tpu.ops.attention as jax_attention
import hupr_tpu_torch.engine.pipeline as port_pipeline
from hupr_tpu.config import config_from_dict as jax_config_from_dict
from hupr_tpu.engine import steps as jax_steps
from hupr_tpu.models import HuPRNet as JaxHuPRNet
from hupr_tpu.models.torch_convert import convert_state_dict
from hupr_tpu.ops.heatmap import get_max_preds as jax_get_max_preds
from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.engine import steps
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.models.hupr import HuPRNet, build_model
from hupr_tpu_torch.ops import attention, kernels
from test_torch_models import _variables
from test_torch_pipeline import (SMALL, _adc, _jax_from_cubes, _nets,
                                 _port_cubes)
from test_torch_tf32 import LOG2E, _round1_pallas
from test_torch_train import _batches

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, B, G = 4, 16, 2, 8
GEOMETRY = (14, H, 4 * H)
IDEAL_BAR = 2.0 ** -8.5
JAX_BAR = 2.0 ** -7.5
# (inputs bfloat16, bf16_ops): computeDtype bfloat16; pallas_bf16 on
# float32 compute; pallas_bf16 on bfloat16 compute
MODES = [(True, False), (False, True), (True, True)]
MODE_IDS = ["bf16", "f32_bf16ops", "bf16_bf16ops"]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(b, n, c, seed, bf16):
    """k, q, m, g from numpy, logits of unit spread (k and q scaled by
    C^-1/4, so that each softmax spreads over many keys), as torch tensors
    and JAX arrays of the mode's input dtype."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, c)).astype(np.float32)
          for _ in range(4)]
    xs[0] *= c ** -0.25
    xs[1] *= c ** -0.25
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    return ([torch.from_numpy(x).to(tdt) for x in xs],
            [jnp.asarray(x).astype(jdt) for x in xs])


def _ideal(ts, bf16_ops):
    """The float32 ideal on the values the mode computes with (rounded to
    bfloat16 under bf16_ops): out, lse and (dk, dq, dm) by autograd."""
    vals = [(t.to(torch.bfloat16) if bf16_ops else t).to(torch.float32)
            for t in ts]
    k, q, m = (v.clone().requires_grad_(True) for v in vals[:3])
    out = attention.attention_plain(k, q, m)
    grads = torch.autograd.grad(out, (k, q, m), vals[3])
    lse = torch.logsumexp(torch.einsum("bic,bjc->bij", vals[0], vals[1]),
                          dim=1)
    return out.detach(), lse, grads


def _twin(ts, bf16_ops):
    k, q, m, g = ts
    out, lse = attention.attention_fwd(k, q, m, with_lse=True,
                                       bf16_ops=bf16_ops)
    return out, lse, attention.attention_bwd(k, q, m, out, lse, g,
                                             bf16_ops=bf16_ops)


@pytest.mark.parametrize("bf16,bf16_ops", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("n,c", [(256, 64), (256, 128), (128, 256)])
def test_attention_twins_match_pallas_kernels(n, c, bf16, bf16_ops):
    """Each mode's twins (the CPU path of attention_fwd / attention_bwd)
    against the Pallas forward and its custom VJP in interpret mode, 64-query
    blocks (so JAX carries dk and dm across blocks): the dtypes JAX returns,
    2^-8.5 of the float32 ideal, 2^-7.5 of JAX; the LSE float32 within 1e-4
    of the ideal's (exact products summed in another order, O(1) values)."""
    ts, js = _inputs(1, n, c, seed=n + c, bf16=bf16)
    out, lse, grads = _twin(ts, bf16_ops)
    want_out, want_lse, want_grads = _ideal(ts, bf16_ops)

    j_out, vjp = jax.vjp(lambda k, q, m: jax_attention.fused_spatial_attention(
        k, q, m, 64, True, bf16_ops), *js[:3])
    j_grads = vjp(js[3].astype(j_out.dtype))

    assert str(out.dtype).split(".")[-1] == str(j_out.dtype)
    assert lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    assert _rel(_f32(out), want_out) < IDEAL_BAR
    assert _rel(_f32(out), _f32(j_out)) < JAX_BAR
    for name, a, w, j in zip(("dk", "dq", "dm"), grads, want_grads, j_grads):
        assert str(a.dtype).split(".")[-1] == str(j.dtype), name
        assert _rel(_f32(a), w) < IDEAL_BAR, name
        assert _rel(_f32(a), _f32(j)) < JAX_BAR, name


@pytest.mark.parametrize("bf16,bf16_ops", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("n", [1, 65, 100])
def test_attention_twins_ragged(n, bf16, bf16_ops):
    """Ragged N against the float32 ideal only (the Pallas kernels' grid
    reads past the last block there: their dk and dm come back NaN), with
    an absolute slack of 1e-5 per element for the gradients that are zero up
    to float32 noise at N=1."""
    ts, _ = _inputs(2, n, 64, seed=n, bf16=bf16)
    out, lse, grads = _twin(ts, bf16_ops)
    want_out, want_lse, want_grads = _ideal(ts, bf16_ops)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    for name, a, w in zip(("out", "dk", "dq", "dm"), (out,) + grads,
                          (want_out,) + want_grads):
        err = np.linalg.norm(_f32(a) - w.numpy())
        assert err <= IDEAL_BAR * np.linalg.norm(w.numpy()) \
            + 1e-5 * w.numel() ** 0.5, name


# chip_smoke.py holds the backward kernel within 2^-12 of its twin: the two
# round at the same points and read the same out and lse, so they differ
# only where a float32 sum in another order rounds a value the other way
TWIN_BWD_BAR = 2.0 ** -12


def _bwd_rounded(k, q, m, out, lse, g, at):
    """attention_bwd_plain's formulas on the mode's values, with p, dS and
    D rounded to bfloat16 where `at` names them."""
    def r(name, x):
        return x.to(torch.bfloat16).to(torch.float32) if name in at else x

    dtype = k.dtype
    p = torch.exp(torch.einsum("bic,bjc->bij", k, q) - lse[:, None, :])
    dp = torch.einsum("bic,bjc->bij", m, g)
    d = r("D", (g * out.to(torch.float32)).sum(dim=2))
    ds = r("dS", p * (dp - d[:, None, :]))
    p = r("p", p)
    return (torch.einsum("bij,bjc->bic", ds, q).to(dtype),
            torch.einsum("bij,bic->bjc", ds, k).to(dtype),
            torch.einsum("bij,bjc->bic", p, g).to(dtype))


@pytest.mark.parametrize("bf16,bf16_ops", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("moved", ["p", "dS", "D"])
@pytest.mark.parametrize("n,c", [(1024, 128), (256, 256)])
def test_bwd_twin_bar_sees_rounding(n, c, moved, bf16, bf16_ops):
    """Rounding one more or one fewer of p, dS and D than the mode does
    moves the backward's twin by more than TWIN_BWD_BAR, so that bar
    separates a kernel that rounds elsewhere (in mode bf16, one that feeds
    p or dS to the tensor cores as one bfloat16 term instead of hi + lo).
    (D is float32 in every mode, taken from the forward's out in the
    inputs' dtype.)"""
    ts, _ = _inputs(2, n, c, seed=9, bf16=bf16)
    k, q, m, g = ts
    out, lse = attention.attention_fwd(k, q, m, with_lse=True,
                                       bf16_ops=bf16_ops)
    twin = attention.attention_bwd(k, q, m, out, lse, g, bf16_ops=bf16_ops)
    vals = [(t.to(torch.bfloat16) if bf16_ops else t).to(torch.float32)
            for t in ts]
    at = {"p", "dS"} if bf16_ops else set()
    dtype = k.dtype
    same = _bwd_rounded(*vals[:3], out, lse, vals[3], at)
    moved_ = _bwd_rounded(*vals[:3], out, lse, vals[3], at ^ {moved})
    assert all(torch.equal(a, s.to(dtype)) for a, s in zip(twin, same))
    # p enters dm alone; dS and D enter dk and dq
    assert max(_rel(_f32(w.to(dtype)), _f32(a))
               for a, w in zip(twin, moved_)) > TWIN_BWD_BAR


@pytest.mark.parametrize("bf16_ops", [False, True], ids=["f32", "bf16ops"])
@pytest.mark.parametrize("n,c", [(256, 64), (128, 256)])
def test_unfolded_twin_matches_round1_body(n, c, bf16_ops):
    """attention_fwd_unfolded's CPU path against the microbenchmark's
    round-1 body: float32 within 1e-4 (the folded kernel's bar), bf16_ops
    within 2^-7.5 (the same rounding points, a softmax summed in another
    order may round a value the other way)."""
    ts, js = _inputs(2, n, c, seed=c, bf16=False)
    got = attention.attention_fwd_unfolded(*ts[:3], bf16_ops=bf16_ops)
    want = np.asarray(_round1_pallas(*js[:3], 64, bf16_ops))
    assert got.dtype == torch.float32
    if bf16_ops:
        assert _rel(got.numpy(), want) < JAX_BAR
        # and it is not the folded kernel's function
        assert not torch.equal(got, attention.attention_plain(
            *ts[:3], bf16_ops=True))
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _unfolded_bf16ops(k, q, m):
    """The unfolded forward's f32_bf16ops body (csrc/attention_fwd_unfolded
    .cu) at its rounding points: k, q and m rounded to bfloat16, logits
    summed in float32 over 64-key tiles; pass 1 each row's running max and
    sum, pass 2 a = exp2((s - max) log2 e) / sum rounded to bfloat16 once,
    each tile's a.m summed apart and added in float32."""
    k, q, m = (t.to(torch.bfloat16).float() for t in (k, q, m))
    b, n, _ = k.shape
    mx = torch.full((b, n), -np.inf)
    total = torch.zeros((b, n))
    for k0 in range(0, n, 64):
        s = torch.einsum("bjc,bic->bji", q, k[:, k0:k0 + 64])
        new_max = torch.maximum(mx, s.amax(dim=2))
        total = total * torch.exp2((mx - new_max) * LOG2E) \
            + torch.exp2((s - new_max[..., None]) * LOG2E).sum(dim=2)
        mx = new_max
    inv = 1 / total
    o = torch.zeros_like(q)
    for k0 in range(0, n, 64):
        s = torch.einsum("bjc,bic->bji", q, k[:, k0:k0 + 64])
        a = torch.exp2((s - mx[..., None]) * LOG2E) * inv[..., None]
        o = o + torch.einsum("bji,bic->bjc", a.to(torch.bfloat16).float(),
                             m[:, k0:k0 + 64])
    return o


@pytest.mark.parametrize("n,c", [(256, 64), (128, 256)])
def test_unfolded_bf16ops_model_matches_round1_body(n, c):
    """The f32_bf16ops body's rounding points, modelled on the CPU, give
    the round-1 body's mxu_bf16 output in interpret mode and the twin's
    within 2^-7.5 (the same rounding points; a softmax summed in another
    order may round a value the other way), and stay within 2^-8.5 of the
    float32 ideal on the rounded operands."""
    ts, js = _inputs(2, n, c, seed=c + 1, bf16=False)
    got = _unfolded_bf16ops(*ts[:3])
    want = np.asarray(_round1_pallas(*js[:3], 64, True))
    assert _rel(got.numpy(), want) < JAX_BAR
    twin = attention.attention_unfolded_plain(*ts[:3], bf16_ops=True)
    assert _rel(got.numpy(), twin.numpy()) < JAX_BAR
    ideal = attention.attention_unfolded_plain(
        *(t.to(torch.bfloat16).float() for t in ts[:3]))
    assert _rel(got.numpy(), ideal.numpy()) < IDEAL_BAR


def test_kernel_wrappers_take_bf16_and_count_per_mode():
    """Mixed input dtypes raise before any launch; the LSE and D are
    float32; the counts start at zero per mode."""
    meta = [torch.empty((2, 256, 64), device="meta", dtype=torch.bfloat16)
            for _ in range(3)]
    kernels.reset_launch_counts()
    with pytest.raises(TypeError):
        attention.attention_fwd(meta[0], meta[1], meta[2].float())
    with pytest.raises(TypeError):         # the LSE must be float32
        attention.attention_bwd(*meta, meta[0], torch.empty(
            (2, 256), device="meta", dtype=torch.bfloat16), meta[0])
    with pytest.raises(TypeError):         # the unfolded kernel is float32
        attention.attention_fwd_unfolded(*meta)
    assert attention.attention_fwd.launches_by_mode == {}
    assert attention.attention_bwd.launches == 0
    assert attention.kernel_mode(torch.bfloat16, True) == "bf16_bf16ops"


# ------------------------------------------------------------- the model

def _patch_interpret(monkeypatch):
    monkeypatch.setattr(jax_attention, "spatial_attention_pallas",
                        functools.partial(
                            jax_attention.spatial_attention_pallas,
                            interpret=True))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _weights():
    return _variables(JaxHuPRNet(num_filters=F, heatmap_size=H), seed=0)


def _logit(h):
    h = np.asarray(h, np.float64)
    return np.log(h / (1 - h))


# Measured (CPU, F=4, 16x16): heatmaps within 1.8e-4 of JAX's, the GCN
# heatmaps within 7e-5, logits within 6.6e-3 relative, decode agreement 1.0.
# The port's bfloat16 differs from JAX's about as much as JAX's does from
# float32 (JAX rounds after each BN step and after the conv bias; torch's BN
# and conv round once). Bars: 10x the measurements, far inside the JAX
# package's own bfloat16 bars (tests/test_bf16_compute.py: heatmaps within
# 0.05, decode agreement >= 75 %), which also bound the decode here.
HEATMAP_ATOL = 2e-3
LOGIT_REL = 2.0 ** -4
DECODE_AGREE = 0.75


@pytest.mark.parametrize("attn_impl,compute", [
    ("pallas", "bfloat16"), ("xla", "bfloat16"), ("pallas_bf16", "float32"),
    ("pallas_bf16", "bfloat16")])
def test_bf16_forward_matches_jax(monkeypatch, attn_impl, compute):
    _patch_interpret(monkeypatch)
    variables = _weights()
    dtype = {"float32": None, "bfloat16": jnp.bfloat16}[compute]
    jax_model = JaxHuPRNet(num_filters=F, heatmap_size=H, dtype=dtype,
                           attn_impl=attn_impl)
    cfg = port_config.config_from_dict({
        "DATASET": {"heatmapSize": H},
        "MODEL": {"numFilters": F, "computeDtype": compute,
                  "attention": attn_impl}})
    port = build_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    hori, vert = _rand((B, G, 8, 2, H, H, 8), 20), _rand((B, G, 8, 2, H, H,
                                                           8), 21)
    j_heat, j_gcn = jax_model.apply(variables, hori, vert)
    with torch.no_grad():
        heat, gcn = port(torch.from_numpy(hori), torch.from_numpy(vert))
    assert heat.dtype == gcn.dtype == torch.float32
    np.testing.assert_allclose(heat.numpy(), np.asarray(j_heat),
                               atol=HEATMAP_ATOL)
    np.testing.assert_allclose(gcn.numpy(), np.asarray(j_gcn),
                               atol=HEATMAP_ATOL)
    assert _rel(_logit(heat.numpy()), _logit(j_heat)) < LOGIT_REL
    want, _ = jax_get_max_preds(np.asarray(j_gcn).reshape(-1, 14, H, H))
    got, _ = jax_get_max_preds(gcn.numpy().reshape(-1, 14, H, H))
    agree = np.mean(np.all(np.asarray(got) == np.asarray(want), axis=-1))
    assert agree >= DECODE_AGREE
    assert np.asarray(j_heat).std() > 1e-3


# encoder stage on JAX's own bfloat16 chirp maps: measured 6.6e-3 to
# 7.3e-3 relative (three BN'd blocks in bfloat16); bar 2^-5
ENCODER_REL = 2.0 ** -5
# chirp maps: one conv, rounded once (port) or twice (JAX, after the bias):
# measured 2.5e-3; bar 2^-7
CHIRP_REL = 2.0 ** -7


def test_bf16_stages_match_jax():
    variables = _weights()
    jax_model = JaxHuPRNet(num_filters=F, heatmap_size=H,
                           dtype=jnp.bfloat16)
    port = HuPRNet(num_filters=F, heatmap_size=H,
                   compute_dtype=torch.bfloat16).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    hori, vert = _rand((B, G, 8, 2, H, H, 8), 22), _rand((B, G, 8, 2, H, H,
                                                           8), 23)
    j_ra, _ = jax_model.apply(variables, hori, vert, method="chirp_maps")
    j_enc = jax_model.apply(variables, j_ra,
                            method=lambda m, x: m.RAradarEncoder(x, False))
    with torch.no_grad():
        ra, _ = port.chirp_maps(torch.from_numpy(hori),
                                torch.from_numpy(vert))
        enc = port.RAradarEncoder(torch.from_numpy(_f32(j_ra).copy()).to(
            torch.bfloat16).permute(0, 4, 1, 2, 3))
    assert ra.dtype == torch.bfloat16 and j_ra.dtype == jnp.bfloat16
    assert _rel(_f32(ra), _f32(j_ra)) < CHIRP_REL
    for got, want in zip(enc, j_enc):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _rel(np.moveaxis(_f32(got), 1, -1), _f32(want)) < ENCODER_REL


def test_bf16_dtypes_at_the_boundaries():
    """Under computeDtype bfloat16: the attention gets bfloat16 inputs and
    returns bfloat16; the PRGCN's layers run in float32; both heatmaps are
    float32; parameters, their gradients and the BN running statistics are
    float32 after a train-mode forward and backward."""
    port = HuPRNet(num_filters=F, heatmap_size=H, attn_impl="pallas",
                   compute_dtype=torch.bfloat16)
    port.load_state_dict(state_dict_from_jax(_weights()), strict=True)
    seen = {"attention": set(), "gcn": set()}
    attend = port.radarDecoder.attention

    def spy(k, q, m):
        out = attend(k, q, m)
        seen["attention"].add((k.dtype, q.dtype, m.dtype, out.dtype))
        return out

    port.radarDecoder.attention = spy
    for layer in ("L1", "L2", "L3"):
        getattr(port.radarDecoder.gcn, layer).register_forward_hook(
            lambda mod, args, out: seen["gcn"].add((args[0].dtype,
                                                    out.dtype)))
    port.train()
    hori, vert = (torch.from_numpy(_rand((B, G, 8, 2, H, H, 8), s))
                  for s in (24, 25))
    heat, gcn = port(hori, vert)
    (heat.sum() + gcn.sum()).backward()
    bf16 = torch.bfloat16
    assert seen["attention"] == {(bf16, bf16, bf16, bf16)}
    assert seen["gcn"] == {(torch.float32, torch.float32)}
    assert heat.dtype == gcn.dtype == torch.float32
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in port.parameters())
    stats = [b for name, b in port.named_buffers() if "running" in name]
    assert stats and all(b.dtype == torch.float32 for b in stats)


def test_bf16_serving_matches_jax():
    """make_e2e_infer with a bfloat16 model on raw int16 ADC, against the
    JAX pipeline body (bfloat16 chirp maps windowed, then decoded) on the
    port's own cubes: maxvals within the heatmap bar, decode agreement
    within the JAX package's bar."""
    rp = port_pipeline.RadarParams(**SMALL)
    jax_model, variables, _, state = _nets(num_filters=2, heatmap=32)
    jax_bf16 = JaxHuPRNet(num_filters=2, heatmap_size=32, dtype=jnp.bfloat16)
    port = HuPRNet(num_filters=2, heatmap_size=32, attn_impl="pallas",
                   compute_dtype=torch.bfloat16)
    adc = _adc(7, 8, rp)
    pred, maxv = port_pipeline.make_e2e_infer(port, state, rp, duration=8,
                                              device="cpu")(*adc)
    cubes = _port_cubes(*adc[:2], rp) + _port_cubes(*adc[2:], rp)
    want = _jax_from_cubes(jax_bf16, variables, 8)(*cubes)
    assert maxv.dtype == torch.float32 and pred.shape == (8, 14, 2)
    np.testing.assert_allclose(maxv.numpy(), np.asarray(want[1]),
                               atol=HEATMAP_ATOL)
    agree = np.mean(np.all(pred.numpy() == np.asarray(want[0]), axis=-1))
    assert agree >= DECODE_AGREE
    assert np.asarray(want[1]).std() > 1e-3


# ------------------------------------------------------------- training

def _both(attn_impl, seed):
    variables = _variables(JaxHuPRNet(num_filters=F, heatmap_size=H),
                           seed=seed)
    model_cfg = {"computeDtype": "bfloat16", "attention": attn_impl,
                 "numFilters": F}
    jcfg = jax_config_from_dict({"MODEL": model_cfg})
    jax_model = JaxHuPRNet(num_filters=F, heatmap_size=H, dtype=jnp.bfloat16,
                           attn_impl=attn_impl)
    jtx = jax_steps.make_optimizer(jcfg)
    jstate = jax_steps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32))
    cfg = port_config.config_from_dict({"DATASET": {"heatmapSize": H},
                                        "MODEL": model_cfg})
    port = build_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    tx = steps.make_optimizer(cfg, port)
    return (jax_model, jtx, jstate), (port, tx, steps.TrainState(port, tx))


# Measured (CPU, 3 Adam steps): losses within 3.2e-5 relative of JAX per
# step, so the float32 trajectory's bar (tests/test_reference_parity.py)
# holds; params within 6.0e-4, inside that test's float32 bars too (Adam
# moves each weight by about +-lr whatever the gradient's size, so bfloat16
# noise shows only where a gradient is near zero); the BN running statistics
# within 1.9e-3 absolute (they average bfloat16 activations, which the port
# rounds once per BN and JAX after each step): bar 5e-3 + 2e-2 relative.
LOSS_RTOL = 2e-4
PARAM_ATOL, PARAM_RTOL = 7e-4, 1e-3
STATS_ATOL, STATS_RTOL = 5e-3, 2e-2


@pytest.mark.parametrize("attn_impl", ["pallas", "pallas_bf16"])
def test_bf16_train_trajectory_matches_jax(monkeypatch, attn_impl):
    """Three Adam steps in bfloat16 compute from the same weights on the
    same batches, the port through its Function (on the CPU the twins), JAX
    through its Pallas custom VJP in interpret mode: losses per step within
    LOSS_RTOL; params within the float32 trajectory's bars
    (tests/test_reference_parity.py); the BN running statistics, which
    average bfloat16 activations, within STATS_ATOL + STATS_RTOL."""
    _patch_interpret(monkeypatch)
    (jax_model, jtx, jstate), (port, tx, state) = _both(attn_impl, seed=1)
    jstep = jax_steps.make_train_step(jax_model, jtx, -1.0, GEOMETRY)
    step = steps.make_train_step(port, tx, -1.0, GEOMETRY)
    for i, batch in enumerate(_batches(seed=2, b=3)):
        jstate, jm = jstep(jstate, batch, 1e-4 * 0.999 ** i, 0.0)
        state, m = step(state, batch, 1e-4 * 0.999 ** i, 0.0)
        for key in ("loss", "loss1", "loss2"):
            assert m[key].dtype == torch.float32
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{key} step {i}")
    assert all(p.dtype == torch.float32 for p in port.parameters())
    want = convert_state_dict({k: v.detach().clone()
                               for k, v in port.state_dict().items()})
    for tree, atol, rtol in (("params", PARAM_ATOL, PARAM_RTOL),
                             ("batch_stats", STATS_ATOL, STATS_RTOL)):
        ref = dict(jax.tree_util.tree_leaves_with_path(getattr(jstate, tree)))
        got = jax.tree_util.tree_leaves_with_path(want[tree])
        assert len(got) == len(ref)
        for path, leaf in got:
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(ref[path]), atol=atol, rtol=rtol,
                err_msg=jax.tree_util.keystr(path))


def test_bf16_eval_step_matches_jax(monkeypatch):
    """Eval mode in bfloat16 on the running statistics: float32 losses
    within LOSS_RTOL, maxvals within the heatmap bar, decode agreement
    within the JAX package's bar."""
    _patch_interpret(monkeypatch)
    (jax_model, _, jstate), (port, _, state) = _both("pallas", seed=5)
    batch = _batches(seed=6, b=3, n=1)[0]
    want = jax_steps.make_eval_step(jax_model, -1.0, GEOMETRY)(jstate, batch)
    got = steps.make_eval_step(port, -1.0, GEOMETRY)(state, batch)
    for key in ("loss", "loss1", "loss2"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["maxvals"].numpy(),
                               np.asarray(want["maxvals"]), atol=HEATMAP_ATOL)
    agree = np.mean(np.all(got["pred2d"].numpy() == np.asarray(
        want["pred2d"]), axis=-1))
    assert agree >= DECODE_AGREE
    assert got["predHeatmap"].dtype == torch.float32


# ------------------------------------------------------------- configs

def _without_splits(cfg):
    d = dataclasses.asdict(cfg)
    for split in ("testName", "valName", "trainName"):
        d["DATASET"].pop(split)
    return d


def test_fast_configs_equal_yaml():
    """chip_smoke.py builds config/mscsa_prgcn_tpu_fast.yaml without PyYAML:
    the training config is the YAML's in every field but the split lists;
    the serving config in every field but those and TRAINING."""
    want = _without_splits(port_config.load_config(
        os.path.join(REPO, "config", "mscsa_prgcn_tpu_fast.yaml")))
    assert _without_splits(port_config.fast_training_config()) == want
    serving = _without_splits(port_config.fast_serving_config())
    assert serving.pop("TRAINING") != want.pop("TRAINING")
    assert serving == want
    assert want["MODEL"] == {"numFilters": 32, "computeDtype": "bfloat16",
                             "remat": False, "attention": "pallas"}
    assert port_config.fast_serving_config().DATASET.testName == []


@pytest.mark.parametrize("name,ok", [("float32", True), ("bfloat16", True),
                                     ("float16", False), ("bf16", False)])
def test_compute_dtype_is_checked(name, ok):
    cfg = port_config.config_from_dict({"MODEL": {"numFilters": 2,
                                                  "computeDtype": name}})
    if ok:
        model = build_model(cfg, device="cpu")
        assert model.radarDecoder.compute_dtype == getattr(torch, name)
    else:
        with pytest.raises(ValueError, match="computeDtype"):
            build_model(cfg, device="cpu")
