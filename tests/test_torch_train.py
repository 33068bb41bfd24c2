"""The port's training slice against hupr_tpu's on the same numpy inputs:
Gaussian targets, BCE, the attention's gradients (its autograd Function on
the CPU, i.e. the plain versions, against the Pallas backward in interpret
mode), and 3-step train trajectories and the eval step from the same
weights, at reduced geometry (F=4, 16x16 maps)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hupr_tpu.config import config_from_dict as jax_config_from_dict
from hupr_tpu.engine import steps as jax_steps
from hupr_tpu.models import HuPRNet as JaxHuPRNet
from hupr_tpu.models.torch_convert import convert_state_dict
from hupr_tpu.ops import attention as jax_attention
from hupr_tpu.ops import heatmap as jax_heatmap
from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.engine import steps
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.models.hupr import HuPRNet
from hupr_tpu_torch.ops import attention, heatmap
from test_torch_models import _variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, H, G = 4, 16, 8                 # numFilters, map size, window
GEOMETRY = (14, H, 4 * H)          # numKeypoints, heatmapSize, imgSize


# ---------------------------------------------------------------- targets

def _edge_joints(rng, b, img):
    j = rng.uniform(-0.2 * img, 1.2 * img, (b, 14, 2))
    j[0, :6] = [[-1, -1], [-30, img / 2], [img - 1, img - 1], [0, 0],
                [1.2 * img, 1.2 * img], [img / 2, -9]]
    return j


@pytest.mark.parametrize("heatmap_size,img_size", [(64, 256), (128, 512)])
def test_generate_target_batch_matches_jax(heatmap_size, img_size):
    """The paste windows (which pixels are non-zero) and the peaks equal
    the JAX package's exactly, skipped joints included; the values agree
    to 1e-7 (the Gaussian is <= 1; XLA's and torch's float32 exp differ in
    the last bits)."""
    joints = _edge_joints(np.random.default_rng(heatmap_size), 4, img_size)
    want_t, want_p = jax_heatmap.generate_target_batch(
        jnp.asarray(joints), 14, heatmap_size, img_size)
    got_t, got_p = heatmap.generate_target_batch(
        torch.from_numpy(joints), 14, heatmap_size, img_size)
    want_t = np.asarray(want_t)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_t.numpy() != 0, want_t != 0)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=1e-7)
    peaks = want_t.max(axis=(2, 3))       # kept joints and skipped ones
    assert (peaks == 1.0).sum() >= 20 and (peaks == 0.0).sum() >= 3


@pytest.mark.parametrize("mode", ["sigmas", "is_coord"])
def test_generate_target_modes_match_jax(mode):
    rng = np.random.default_rng(7)
    kwargs = {}
    if mode == "sigmas":      # fractional 3 sigma: asymmetric windows
        joints = _edge_joints(rng, 1, 256)[0]
        kwargs["sigmas"] = rng.choice([0.15, 0.25, 0.2, 0.35], size=14)
    else:
        joints = rng.uniform(-0.1, 1.1, (14, 2))
        kwargs["is_coord"] = True
    want_t, want_p = jax_heatmap.generate_target(
        jnp.asarray(joints), 14, 64, 256,
        **{k: jnp.asarray(v) if k == "sigmas" else v
           for k, v in kwargs.items()})
    got_t, got_p = heatmap.generate_target(torch.from_numpy(joints), 14, 64,
                                           256, **kwargs)
    want_t = np.asarray(want_t)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_t.numpy() != 0, want_t != 0)
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=1e-7)


# -------------------------------------------------------------------- BCE

def _probs_targets(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (3, 14, 8, 8)).astype(np.float32)
    p[0, 0, 0, :4] = [0.0, 1.0, 0.0, 1.0]          # saturated sigmoid
    t = rng.uniform(0, 1, p.shape).astype(np.float32)
    t[0, 0, 0, :4] = [0.0, 1.0, 0.5, 0.5]
    return p, t


@pytest.mark.parametrize("masked", [False, True])
def test_bce_loss_and_gradient_match_jax(masked):
    """Values at atol 1e-6; input gradients at 1e-6 of their largest
    magnitude (p(1-p) clamped at 1e-12 makes them ~5e11 at p = 0 or 1),
    finite everywhere."""
    p, t = _probs_targets(seed=int(masked))
    mask = np.array([1.0, 1.0, 0.0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)

    want = jax_heatmap.bce_loss(jnp.asarray(p), jnp.asarray(t), jm)
    want_g = np.asarray(jax.grad(lambda x: jax_heatmap.bce_loss(
        x, jnp.asarray(t), jm))(jnp.asarray(p)))

    pt = torch.from_numpy(p).requires_grad_(True)
    got = heatmap.bce_loss(pt, torch.from_numpy(t),
                           None if mask is None else torch.from_numpy(mask))
    got.backward()

    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)
    assert np.isfinite(pt.grad.numpy()).all()
    scale = np.abs(want_g).max()
    assert scale > 1e7                   # the clamped denominators are hit
    np.testing.assert_allclose(pt.grad.numpy(), want_g, rtol=0,
                               atol=1e-6 * scale)


# ------------------------------------------------------- attention backward

def _kqmw(b, n, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, c)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("b,n,c,q_block", [
    (1, 64, 16, 64),       # one q-block
    (1, 1024, 32, 256),    # four q-blocks carrying dk, dm
])
def test_function_gradients_match_pallas_backward(b, n, c, q_block):
    """FusedSpatialAttention on the CPU (attention_plain with the LSE,
    attention_bwd_plain) against jax.grad through the Pallas custom VJP in
    interpret mode, at the bar of tests/test_attention.py: atol 1e-3,
    rtol 1e-4."""
    k, q, m, w = _kqmw(b, n, c, seed=n)

    def loss(k, q, m):
        return jnp.sum(jax_attention.fused_spatial_attention(
            k, q, m, q_block, True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (k, q, m)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (k, q, m)]
    out = attention.spatial_attention(*ts)
    assert type(out.grad_fn).__name__ == "FusedSpatialAttentionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=1e-3, rtol=1e-4)


def test_attention_bwd_plain_matches_autograd_and_lse():
    """The formulas written out against autograd of attention_plain, at
    atol 1e-5 (logits of unit spread, so the gradients are O(1)); the LSE
    is torch.logsumexp of the logits over keys."""
    k, q, m, g = map(torch.from_numpy, _kqmw(2, 100, 16, seed=5))
    k, q = k * 0.5, q * 0.5
    out, lse = attention.attention_fwd(k, q, m, with_lse=True)
    logits = torch.einsum("bic,bjc->bij", k, q)
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=1),
                               rtol=0, atol=1e-6)
    got = attention.attention_bwd(k, q, m, out, lse, g)
    ts = [x.clone().requires_grad_(True) for x in (k, q, m)]
    want = torch.autograd.grad(attention.attention_plain(*ts), ts, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_attention_bwd_on_cpu_is_the_plain_version_uncounted():
    k, q, m, g = map(torch.from_numpy, _kqmw(1, 64, 16, seed=6))
    out, lse = attention.attention_plain(k, q, m, with_lse=True)
    before = attention.attention_bwd.launches
    got = attention.attention_bwd(k, q, m, out, lse, g)
    want = attention.attention_bwd_plain(k, q, m, out, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert attention.attention_bwd.launches == before


@pytest.mark.parametrize("case,exc", [
    ("bf16", TypeError), ("lse_shape", ValueError), ("channels", ValueError),
    ("meta", ValueError),
])
def test_attention_bwd_rejects_what_the_kernel_does_not_take(case, exc):
    def mk(shape=(2, 256, 64), dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    k, q, m, out, g = mk(), mk(), mk(), mk(), mk()
    lse = mk((2, 256))
    if case == "bf16":
        g = mk(dtype=torch.bfloat16)
    elif case == "lse_shape":
        lse = mk((2, 128))
    elif case == "channels":
        k, q, m, out, g = (mk((2, 256, 48)) for _ in range(5))
    before = attention.attention_bwd.launches
    with pytest.raises(exc):
        attention.attention_bwd(k, q, m, out, lse, g)
    assert attention.attention_bwd.launches == before


def test_spatial_attention_dispatch():
    """Without grad the forward wrapper alone (serving keeps its launches);
    with grad the Function; on the meta device the Function's forward
    refuses a bf16 input before any launch."""
    k, q, m, _ = map(torch.from_numpy, _kqmw(1, 64, 16, seed=8))
    with torch.inference_mode():
        assert torch.equal(attention.spatial_attention(k, q, m),
                           attention.attention_plain(k, q, m))
    meta = [torch.empty((2, 256, 64), device="meta") for _ in range(3)]
    meta[0] = meta[0].to(torch.bfloat16)
    meta[1].requires_grad_(True)
    before = attention.attention_fwd.launches, attention.attention_bwd.launches
    with pytest.raises(TypeError):
        attention.spatial_attention(*meta)
    assert (attention.attention_fwd.launches,
            attention.attention_bwd.launches) == before


# ------------------------------------------------------------- the slice

def _batches(seed, b, n=3):
    rng = np.random.default_rng(seed)
    shape = (b, G, 8, 2, H, H, 8)
    return [{"hori": rng.standard_normal(shape).astype(np.float32),
             "vert": rng.standard_normal(shape).astype(np.float32),
             "jointsGroup": np.floor(rng.uniform(5, 4 * H - 6, (b, 14, 2)))}
            for _ in range(n)]


def _pad_last_row(batch):
    """The last row repeats the one before it and carries mask 0, as
    parallel.shard_batch pads a batch."""
    out = {k: v.copy() for k, v in batch.items()}
    for key in ("hori", "vert", "jointsGroup"):
        out[key][-1] = out[key][-2]
    out["mask"] = np.array([1.0] * (len(out["hori"]) - 1) + [0.0],
                           np.float32)
    return out


def _both_sides(optimizer, loss_decay, seed, attn_impl):
    jax_model = JaxHuPRNet(num_filters=F, heatmap_size=H, attn_impl="xla")
    variables = _variables(jax_model, seed=seed)
    training = {"optimizer": optimizer, "lossDecay": loss_decay}
    jcfg = jax_config_from_dict({"TRAINING": training})
    jtx = jax_steps.make_optimizer(jcfg)
    jstate = jax_steps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtx.init(variables["params"]), step=jnp.zeros((), jnp.int32))

    cfg = port_config.config_from_dict({"TRAINING": training})
    port = HuPRNet(num_filters=F, heatmap_size=H, attn_impl=attn_impl).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    tx = steps.make_optimizer(cfg, port)
    return (jax_model, jtx, jstate), (port, tx, steps.TrainState(port, tx))


@pytest.mark.parametrize("optimizer,loss_decay,lr,pad_step", [
    ("adam", -1.0, 1e-4, 1),
    ("sgd", 0.3, 1e-2, None),
], ids=["adam-padded", "sgd-annealed"])
def test_train_trajectory_matches_jax(optimizer, loss_decay, lr, pad_step):
    """Three steps from the same weights on the same batches, the port with
    MODEL.attention 'pallas' (its Function; on the CPU the plain versions),
    JAX with 'xla' (bit-identical to its Pallas path). Bars of
    tests/test_reference_parity.py: losses rtol 2e-4 per step; params and
    BN running statistics atol 7e-4, rtol 1e-3 after the steps (Adam moves
    each element by about +-lr whatever the gradient's size, so float32
    noise on near-zero gradients can flip a step)."""
    (jax_model, jtx, jstate), (port, tx, state) = _both_sides(
        optimizer, loss_decay, seed=1, attn_impl="pallas")
    jstep = jax_steps.make_train_step(jax_model, jtx, loss_decay, GEOMETRY)
    step = steps.make_train_step(port, tx, loss_decay, GEOMETRY)

    batches = _batches(seed=2, b=3)
    if pad_step is not None:
        batches[pad_step] = _pad_last_row(batches[pad_step])
    alpha = 0.0
    for i, batch in enumerate(batches):
        if alpha < 1.0:                 # Runner.advance_alpha
            alpha += loss_decay
        jstate, jm = jstep(jstate, batch, lr * 0.999 ** i, alpha)
        state, m = step(state, batch, lr * 0.999 ** i, alpha)
        for key in ("loss", "loss1", "loss2"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=2e-4, err_msg=f"{key} step {i}")
    assert state.step == 3 and port.training is False

    want = convert_state_dict({k: v.detach().clone()
                               for k, v in port.state_dict().items()})
    for tree in ("params", "batch_stats"):
        got_leaves = jax.tree_util.tree_leaves_with_path(want[tree])
        ref = dict(jax.tree_util.tree_leaves_with_path(
            getattr(jstate, tree)))
        assert len(got_leaves) == len(ref)
        for path, leaf in got_leaves:
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(ref[path]), atol=7e-4,
                rtol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_padded_row_changes_nothing():
    """A padded step equals the same step on the real rows alone: the mask
    keeps the repeated row out of the BN statistics and the loss."""
    _, (port, tx, state) = _both_sides("adam", -1.0, seed=3, attn_impl="xla")
    (_, _, _), (port2, tx2, state2) = _both_sides("adam", -1.0, seed=3,
                                                  attn_impl="xla")
    batch = _batches(seed=4, b=3, n=1)[0]
    padded = _pad_last_row(batch)
    real = {k: v[:2] for k, v in padded.items() if k != "mask"}
    _, m = steps.make_train_step(port, tx, -1.0, GEOMETRY)(
        state, padded, 1e-4, 0.0)
    _, m2 = steps.make_train_step(port2, tx2, -1.0, GEOMETRY)(
        state2, real, 1e-4, 0.0)
    assert m["loss"].item() == m2["loss"].item()
    for a, b in zip(port.state_dict().values(), port2.state_dict().values()):
        assert torch.equal(a, b)


def test_eval_step_matches_jax():
    """Eval mode on the running statistics, masked loss means: losses at
    rtol 1e-5, maxvals at atol 1e-4, decoded pred2d and gt2d exactly."""
    (jax_model, jtx, jstate), (port, tx, state) = _both_sides(
        "adam", 0.3, seed=5, attn_impl="pallas")
    batch = _pad_last_row(_batches(seed=6, b=3, n=1)[0])
    want = jax_steps.make_eval_step(jax_model, 0.3, GEOMETRY)(
        jstate, batch, 0.3)
    got = steps.make_eval_step(port, 0.3, GEOMETRY)(state, batch, 0.3)
    for key in ("loss", "loss1", "loss2"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-5)
    np.testing.assert_allclose(got["maxvals"].numpy(),
                               np.asarray(want["maxvals"]), atol=1e-4)
    np.testing.assert_array_equal(got["pred2d"].numpy(),
                                  np.asarray(want["pred2d"]))
    np.testing.assert_array_equal(got["gt2d"].numpy(),
                                  np.asarray(want["gt2d"]))
    assert np.asarray(want["maxvals"]).std() > 1e-3
    assert got["predHeatmap"].shape == (3, 14, H, H)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_optimizer_is_torch_semantics(optimizer):
    """One group over every parameter, with the hyperparameters
    hupr_tpu.engine.steps.make_optimizer's optax chain reproduces."""
    cfg = port_config.config_from_dict({"TRAINING": {
        "optimizer": optimizer, "weightDecay": 3e-4}})
    port = HuPRNet(num_filters=2, heatmap_size=H)
    tx = steps.make_optimizer(cfg, port)
    (group,) = tx.param_groups
    assert len(group["params"]) == len(list(port.parameters()))
    assert group["weight_decay"] == 3e-4
    if optimizer == "adam":
        assert isinstance(tx, torch.optim.Adam)
        assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    else:
        assert isinstance(tx, torch.optim.SGD)
        assert group["momentum"] == 0.9 and not group["nesterov"]


def test_flagship_training_config_equals_yaml():
    """chip_smoke.py builds the training recipe without PyYAML; every field
    but the split lists, which the train step never reads, is the YAML's."""
    want = dataclasses.asdict(port_config.load_config(
        os.path.join(REPO, "config", "mscsa_prgcn_tpu.yaml")))
    got = dataclasses.asdict(port_config.flagship_training_config())
    for split in ("testName", "valName", "trainName"):
        assert want["DATASET"].pop(split)
        assert got["DATASET"].pop(split) == []
    assert got == want
    t = got["TRAINING"]
    assert (t["batchSize"], t["lr"], t["optimizer"], t["weightDecay"],
            t["lossDecay"], t["lrDecay"], t["lrDecayIter"]) == \
        (20, 1e-4, "adam", 1e-4, -1, 0.999, 2000)
