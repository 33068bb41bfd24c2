"""MODEL.remat in the port (models/hupr.py: each Encoder3D under
torch.utils.checkpoint in a recorded train-mode forward) against the plain
step and against hupr_tpu's nn.remat step, on the CPU at
tests/test_remat.py's geometry (numFilters 2, 64x64 maps, batch 2) on
hupr_tpu's synthetic weights; the max-throughput recipe
(config/mscsa_prgcn_tpu_max.yaml) through the Runner and the CLI at the
tiny raw-ADC geometry of tests/test_torch_chunk.py; and the two scripts
that measure the knob, scripts/remat_memory.py and scripts/batch_sweep.py.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hupr_tpu.config import config_from_dict as jax_config_from_dict
from hupr_tpu.engine import steps as jax_steps
from hupr_tpu.models import build_model as jax_build_model
from hupr_tpu.ops import heatmap as jax_heatmap
from hupr_tpu.utils.synthetic import synthetic_variables
from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.data import get_dataset
from hupr_tpu_torch.data.adc import ADCFrameSource
from hupr_tpu_torch.engine import chunk_train, steps
from hupr_tpu_torch.engine.pipeline import make_e2e_infer
from hupr_tpu_torch.models import hupr
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.ops.dsp import RadarParams
from hupr_tpu_torch.scripts.remat_memory import autograd_saved_bytes
from test_torch_bf16 import _without_splits
from test_torch_chunk import (_assert_states_close, _geometry, _jax_state,
                              _port_state, adc_workspace)
from test_torch_chunk_runner import _args

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 8, 8, 2, 64, 64, 8)        # tests/test_remat.py
# the port's remat step against its plain step: tests/test_remat.py's bars
# (remat against no remat in hupr_tpu)
LOSS_RTOL_REMAT, PARAM_ATOL_REMAT = 1e-6, 5e-5
# the port against hupr_tpu: tests/test_torch_train.py's trajectory bars
LOSS_RTOL, PARAM_ATOL, PARAM_RTOL = 2e-4, 7e-4, 1e-3


@functools.lru_cache(maxsize=None)
def _variables():
    """hupr_tpu's synthetic weights at numFilters 2, as
    tests/test_remat.py::_setup draws them, as numpy."""
    cfg = jax_config_from_dict({"MODEL": {"numFilters": 2}})
    return jax.tree_util.tree_map(
        np.asarray, synthetic_variables(jax_build_model(cfg), SHAPE))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"hori": rng.standard_normal(SHAPE).astype(np.float32),
            "vert": rng.standard_normal(SHAPE).astype(np.float32),
            "jointsGroup": rng.uniform(20, 230, (2, 14, 2))}


def _port(remat, dtype="float32", attention="xla"):
    """The port's model (hupr_tpu's weights), optimizer and state."""
    cfg = port_config.config_from_dict({"MODEL": {
        "numFilters": 2, "remat": remat, "computeDtype": dtype,
        "attention": attention}})
    model = hupr.build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(_variables()), strict=True)
    tx = steps.make_optimizer(cfg, model)
    return model, tx, steps.TrainState(model, tx)


def _bn_buffers(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


# ------------------------------------------------ (a) remat vs plain step

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_plain_step(dtype):
    """Two steps with remat and two without, from the same weights on the
    same batches: losses within rtol 1e-6, weights within 5e-5, and the BN
    running statistics and num_batches_tracked bit for bit (a recompute
    that ran train-mode BN on the buffers again would move them twice)."""
    results = {}
    for remat in (False, True):
        model, tx, state = _port(remat, dtype)
        assert model.remat is remat
        step = steps.make_train_step(model, tx)
        losses = []
        for seed in (0, 1):
            state, m = step(state, _batch(seed), 1e-4, 0.0)
            losses.append(m["loss"].item())
        results[remat] = losses, model
    (losses, plain), (losses_r, rematted) = results[False], results[True]
    np.testing.assert_allclose(losses_r, losses, rtol=LOSS_RTOL_REMAT)
    for (key, a), b in zip(plain.named_parameters(), rematted.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=0, atol=PARAM_ATOL_REMAT,
                                   err_msg=key)
    bn, bn_r = _bn_buffers(plain), _bn_buffers(rematted)
    assert len(bn) == len(bn_r) and len(bn) > 40
    for key, value in bn.items():
        assert torch.equal(bn_r[key], value), key
    assert int(bn["RAradarEncoder.layer1.1.main.1.num_batches_tracked"]) == 2


# --------------------------------------- (b) the knob does something


def test_remat_recomputes_the_encoders_and_saves_less():
    """With remat, the convs of both Encoder3D run a second time in the
    backward (all 19 but the last, whose saved tensors are rebuilt once it
    starts: the checkpoint stops the recompute there, before its forward
    hook), no other conv does, and autograd saves fewer bytes for the
    backward; without remat neither happens. MODEL.attention 'pallas' (the
    kernels' Function, on the CPU their plain versions), which saves no
    (N, N) attention matrix, as the flagship trains."""
    readings = {}
    for remat in (False, True):
        model, tx, state = _port(remat, attention="pallas")
        calls = {"encoder": 0, "other": 0}

        def count(module, args, output, where):
            calls[where] += 1

        for name, module in model.named_modules():
            if isinstance(module, torch.nn.modules.conv._ConvNd):
                where = "encoder" if "radarEncoder" in name else "other"
                module.register_forward_hook(
                    functools.partial(count, where=where))
        step = steps.make_train_step(model, tx)
        _, saved = autograd_saved_bytes(
            lambda: step(state, _batch(), 1e-4, 0.0))
        readings[remat] = calls, saved
    (calls, saved), (calls_r, saved_r) = readings[False], readings[True]
    assert calls["encoder"] == 2 * 19       # 19 convs in each Encoder3D
    assert calls_r["encoder"] - calls["encoder"] >= 2 * 18
    assert calls_r["other"] == calls["other"] > 0
    assert saved_r < 0.8 * saved, (saved_r, saved)


# ----------------------------------------- (c) against hupr_tpu's remat


def _bce_loss_rowwise(probs, targets, sample_mask=None):
    """hupr_tpu's bce_loss with its mean taken over rows of 256 elements
    first. XLA:CPU sums this batch's 114688 BCE elements in float32 one
    after another, and on the untrained model's flat 0.5 main heatmap that
    reads 2.4e-4 relative high (0.693311 where the float64 mean of the same
    elements is 0.693147, as the port reads); the gradient, 1/N an element,
    is the same either way."""
    assert sample_mask is None
    elems = jax_heatmap.bce_elements(probs, targets)
    return jnp.mean(jnp.mean(elems.reshape(-1, 256), axis=1))


def test_remat_trajectory_matches_jax_remat(monkeypatch):
    """Three steps of the port's remat step against hupr_tpu's remat step
    (tests/test_remat.py::_setup with remat=True) from the same weights on
    the same batches, at tests/test_torch_train.py's trajectory bars; the
    JAX losses averaged row by row (_bce_loss_rowwise)."""
    monkeypatch.setattr(jax_steps, "bce_loss", _bce_loss_rowwise)
    jcfg = jax_config_from_dict({"MODEL": {"numFilters": 2, "remat": True}})
    jmodel = jax_build_model(jcfg)
    assert jmodel.remat
    variables = _variables()
    jtx = jax_steps.make_optimizer(jcfg)
    jstate = jax_steps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32))
    jstep = jax_steps.make_train_step(jmodel, jtx)
    model, tx, state = _port(True)
    step = steps.make_train_step(model, tx)
    for i in range(3):
        batch, lr = _batch(i), 1e-4 * 0.999 ** i
        jstate, jm = jstep(jstate, batch, lr, 0.0)
        state, m = step(state, batch, lr, 0.0)
        for key in ("loss", "loss1", "loss2"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{key} step {i}")
    _assert_states_close(model, jstate.params, jstate.batch_stats)


# ------------------------------------- (d) eval and serving are plain


def test_eval_and_serving_unchanged_by_remat(monkeypatch):
    """With remat the eval step and make_e2e_infer are bit-equal to the
    same calls without it, and neither reaches the checkpoint."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint called outside training")

    monkeypatch.setattr(hupr, "checkpoint", refuse)
    rp = RadarParams()
    rng = np.random.default_rng(5)
    adc = [rng.integers(-300, 300, (8, rp.num_rx, rp.num_chirp,
                                    rp.num_adc_samples)).astype(np.int16)
           for _ in range(4)]
    batch = _batch(3)
    batch["mask"] = np.array([1.0, 0.0], np.float32)
    outs = {}
    for remat in (False, True):
        model, _, state = _port(remat)
        model.train()           # eval_step switches it to eval mode
        ev = steps.make_eval_step(model)(state, batch)
        assert model.training
        served = make_e2e_infer(model, params=rp, duration=8,
                                device="cpu")(*adc)
        outs[remat] = ev, served
    (ev, served), (ev_r, served_r) = outs[False], outs[True]
    for key, value in ev.items():
        assert torch.equal(ev_r[key], value), key
    for a, b in zip(served, served_r):
        assert torch.equal(a, b)


# --------------------------------------------------- (e) the chunk step


def test_chunk_step_with_remat_equals_without(tmp_path):
    """One raw-ADC chunk step (engine/chunk_train.py, the path the max
    recipe trains on) with remat and one without, from the same weights on
    the same chunk: losses, weights and BN statistics bit for bit."""
    jcfg, cfg = adc_workspace(tmp_path)
    _, _, jstate = _jax_state(jcfg)
    rp = cfg.DATASET.radar_params()
    loader = chunk_train.ADCChunkLoader(
        get_dataset("train", cfg), 5, ADCFrameSource(cfg.DATASET.adcDir, rp),
        shuffle=False)
    batch = loader._assemble(loader.chunks[0])
    results = {}
    for remat in (False, True):
        cfg.MODEL.remat = remat
        state = _port_state(cfg, jstate)
        assert state.model.remat is remat
        step = chunk_train.make_adc_chunk_train_step(
            state.model, state.optimizer, _geometry(cfg), radar_params=rp,
            num_frames=cfg.DATASET.numFrames)
        state, m = step(state, batch, 1e-4, 0.0)
        results[remat] = m, state.model.state_dict()
    (m, sd), (m_r, sd_r) = results[False], results[True]
    for key in ("loss", "loss1", "loss2"):
        assert m_r[key].item() == m[key].item(), key
    for key, value in sd.items():
        assert torch.equal(sd_r[key], value), key


# ------------------------------------------- the max recipe's config


def test_max_training_config_equals_yaml():
    """chip_smoke.py builds config/mscsa_prgcn_tpu_max.yaml without
    PyYAML: every field but the split lists is the YAML's, and
    build_model builds it."""
    path = os.path.join(REPO, "config", "mscsa_prgcn_tpu_max.yaml")
    want = _without_splits(port_config.load_config(path))
    got = _without_splits(port_config.max_training_config())
    assert got == want
    assert want["MODEL"] == {"numFilters": 32, "computeDtype": "bfloat16",
                             "remat": True, "attention": "pallas"}
    t = want["TRAINING"]
    assert (t["batchSize"], t["lr"], t["chunkTrain"], t["chunkSource"]) == \
        (128, 2.5e-4, True, "adc")
    cfg = port_config.load_config(path)
    cfg.MODEL.numFilters = 2
    model = hupr.build_model(cfg, device="cpu")
    assert model.remat and model.RAradarEncoder.layer1[0].compute_dtype \
        == torch.bfloat16


@pytest.mark.parametrize("entry", ["run", "cli"])
def test_runner_trains_the_max_recipe(tmp_path, monkeypatch, capsys, entry):
    """The max recipe's levers (remat, bfloat16 compute and wire, chunk
    mode from raw ADC, raw-ADC sequence eval) at the tiny size, through
    main.run with max_training_config()'s levers, and through the CLI on a
    YAML whose BASE is config/mscsa_prgcn_tpu_max.yaml: one epoch with no
    fallback notice, finite losses, val keypoints and checkpoints."""
    from hupr_tpu_torch import main as cli

    _, cfg = adc_workspace(tmp_path)
    cfg.TRAINING.batchSize = 3
    monkeypatch.chdir(tmp_path)
    if entry == "run":
        levers = port_config.max_training_config()
        cfg.MODEL.remat = levers.MODEL.remat
        cfg.MODEL.computeDtype = levers.MODEL.computeDtype
        cfg.SETUP.transferDtype = levers.SETUP.transferDtype
        for key in ("chunkTrain", "chunkSource"):
            setattr(cfg.TRAINING, key, getattr(levers.TRAINING, key))
        cfg.TEST.sequenceSource = levers.TEST.sequenceSource
        runner = cli.run(_args("max"), cfg, device="cpu")
    else:
        import yaml

        d = dataclasses.asdict(cfg.DATASET)
        tiny = {"BASE": os.path.join(REPO, "config",
                                     "mscsa_prgcn_tpu_max.yaml"),
                "DATASET": {k: d[k] for k in (
                    "duration", "dataDir", "adcDir", "adcParams",
                    "numChirps", "rangeSize", "azimuthSize", "heatmapSize",
                    "imgSize", "trainName", "valName", "testName")},
                "MODEL": {"numFilters": 2, "attention": "xla"},
                "TRAINING": {"batchSize": 3, "epochs": 1},
                "TEST": {"batchSize": 2}}
        os.makedirs("config")
        with open("config/max_tiny.yaml", "w") as fp:
            yaml.safe_dump(tiny, fp)
        monkeypatch.setenv("HUPR_PLATFORM", "cpu")
        monkeypatch.delenv("HUPR_MULTIHOST", raising=False)
        runner = cli.main(["--config", "max_tiny.yaml", "--dir", "max"])
    out = capsys.readouterr().out
    m, t = runner.cfg.MODEL, runner.cfg.TRAINING
    assert runner.model.remat and m.computeDtype == "bfloat16"
    assert runner.cfg.SETUP.transferDtype == "bfloat16"
    assert (t.chunkTrain, t.chunkSource) == (True, "adc")
    assert "requested" not in out and "chunk steps" in out
    assert isinstance(runner._chunk_loader, chunk_train.ADCChunkLoader)
    assert runner._seq_eval.adc is not None
    with open("logs/max/train_loss_list_0.json") as fp:
        losses = json.load(fp)
    assert len(losses) == 3 and all(np.isfinite(losses))
    with open("logs/max/val_results.json") as fp:
        assert len(json.load(fp)) == 8
    assert os.path.exists("logs/max/checkpoint.pth")


# ----------------------------------------------------------- the scripts


def test_remat_memory_script_prints_its_line(capsys):
    from hupr_tpu_torch.scripts import remat_memory

    out = remat_memory.main(["--device", "cpu", "--filters", "2",
                             "--batch", "2", "--time", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert (line["batch"], line["filters"], line["device"]) == (2, 2, "cpu")
    for tag in ("base", "remat"):
        assert line[f"{tag}_autograd_mb"] > 0
        assert line[f"{tag}_ms_per_step"] > 0
    assert line["remat_loss"] == line["base_loss"]
    assert line["autograd_saved_mb"] > 0
    assert "base_peak_mb" not in line        # the card's reading only


def test_batch_sweep_script_prints_its_lines(capsys, monkeypatch):
    """One line per batch with the JAX script's keys, without and with
    remat: the flop counter sees the recompute's convolutions."""
    from hupr_tpu_torch.scripts import batch_sweep

    monkeypatch.setenv("BS_LIST", "2")
    monkeypatch.setenv("BS_REPS", "1")
    lines = {}
    for remat in ("0", "1"):
        monkeypatch.setenv("BS_REMAT", remat)
        (line,) = batch_sweep.main(["--device", "cpu", "--filters", "2"])
        printed = [json.loads(s) for s in
                   capsys.readouterr().out.strip().splitlines()]
        assert printed == [line]
        assert (line["batch"], line["remat"], line["dtype"]) == \
            (2, remat == "1", "float32")
        assert line["samples_per_sec"] == pytest.approx(
            2e3 / line["ms_per_step"])
        assert line["tflops_per_sec"] == pytest.approx(
            line["tflops_per_step"] * line["samples_per_sec"] / 2)
        assert line["tflops_per_step"] > 0
        assert 0 < line["mfu_vs_bf16_peak"] < 1
        lines[remat] = line
    assert lines["1"]["tflops_per_step"] > \
        1.05 * lines["0"]["tflops_per_step"]
