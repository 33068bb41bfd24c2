"""The port's Runner and CLI against hupr_tpu's Runner, on the CPU at the
tiny size of tests/test_e2e.py (numFilters 2, 8-frame windows) with
16x16 maps: checkpoints that round-trip bit for bit and load into the JAX
Runner, one epoch of training from the same .pth, sequence-mode eval
against classic eval batch for batch, the CLI, and the refusals of what
the port lacks."""

import argparse
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from hupr_tpu.engine.seq_eval import SequenceEvaluator as JaxSequenceEvaluator
from hupr_tpu_torch.engine import checkpoint
from hupr_tpu_torch.engine.runner import Runner
from hupr_tpu_torch.engine.seq_eval import SequenceEvaluator, sequence_groups
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict
from test_torch_data import port_cfg_of, tiny_workspace

torch.set_num_threads(1)

# port vs JAX over one epoch from the same weights: the train slice's bars
# (tests/test_torch_train.py, chip_smoke.py's TRAIN_BARS["f32"])
LOSS_RTOL = 2e-4
PARAM_ATOL, PARAM_RTOL = 7e-4, 1e-3
# each leaf's update from the common checkpoint, in L2 norm relative to
# JAX's: a leaf left untrained reads 1, a reversed update 2
UPDATE_RTOL = 1e-2
AP_ATOL = 5e-3              # tests/test_golden_ap.py's PROTOCOL_ATOL


def _args(dir_name, eval_mode=False, **kw):
    return argparse.Namespace(seed=0, dir=dir_name, visDir="none",
                              eval=eval_mode, sampling_ratio=1,
                              keypoints=False, **kw)


def _in(path):
    """chdir into `path` for the Runner's ./logs; returns the old cwd."""
    cwd = os.getcwd()
    os.chdir(path)
    return cwd


def _workspace(root, duration=8, batch=3):
    """tests/test_e2e.py's tiny dataset at 16x16 maps, its GT boxes
    inflated to 1500x1500 as tests/test_golden_ap.py's workspace does:
    OKS divides by the gt area, and with the natural boxes a model far
    from the random joints scores an AP of exactly 0."""
    jcfg, _ = tiny_workspace(root, duration=duration)
    for phase in ("train", "val", "test"):
        path = os.path.join(jcfg.DATASET.dataDir, f"hrnet_annot_{phase}.json")
        with open(path) as fp:
            annots = json.load(fp)
        for seq in annots:
            for block in seq:
                block["bbox"] = [0.0, 0.0, 1500.0, 1500.0]
        with open(path, "w") as fp:
            json.dump(annots, fp)
    jcfg.TRAINING.batchSize = batch      # 8 windows: 3 + 3 + 2 (masked)
    jcfg.TEST.batchSize = batch
    return jcfg, port_cfg_of(jcfg)


def _seed_checkpoint(root, cfg, dir_name, name="checkpoint.pth"):
    """A fresh run's checkpoint in ./logs/<dir_name>: synthetic N(0, 0.1)
    weights (at numFilters 2 and 16x16 maps, 0.05 leaves every heatmap
    near 0.5 and 0.2 saturates it at 1), an optimizer that has taken no
    step, epoch 0."""
    from hupr_tpu_torch.engine.steps import make_optimizer
    from hupr_tpu_torch.models.hupr import build_model

    model = build_model(cfg, device="cpu")
    model.load_state_dict(synthetic_state_dict(model, seed=1, scale=0.1))
    os.makedirs(root / "logs" / dir_name, exist_ok=True)
    checkpoint.write_checkpoint(
        str(root / "logs" / dir_name / name),
        checkpoint.snapshot(model, make_optimizer(cfg, model), 0, -1.0))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the port's Runner from a seeded checkpoint.pth; the
    workspace keeps logs/run and the Runner."""
    root = tmp_path_factory.mktemp("trained")
    jcfg, cfg = _workspace(root)
    cfg.TRAINING.epochs = 1
    _seed_checkpoint(root, cfg, "run")
    cwd = _in(root)
    try:
        runner = Runner(_args("run"), cfg, device="cpu")
        runner.load_model_weight("checkpoint")
        runner.train()
    finally:
        os.chdir(cwd)
    return root, jcfg, cfg, runner


def test_checkpoint_round_trip_is_bit_exact(trained):
    """checkpoint.pth reloads into a fresh Runner bit for bit: weights, BN
    statistics, Adam's moments and step, epoch, best AP and lr."""
    root, _, cfg, runner = trained
    assert sorted(os.listdir(root / "logs" / "run")) == [
        "checkpoint.pth", "checkpoint_0.pth", "model_best.pth",
        "train_loss_list_0.json", "val_results.json"]
    cwd = _in(root)
    try:
        fresh = Runner(_args("run"), cfg, device="cpu")
        fresh.load_model_weight("checkpoint")
    finally:
        os.chdir(cwd)
    want, got = runner.model.state_dict(), fresh.model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    sw, sg = runner.tx.state_dict(), fresh.tx.state_dict()
    assert sw["param_groups"][0]["lr"] != runner.lr  # set for the next step
    assert sg["param_groups"][0]["lr"] == runner.lr == fresh.lr
    assert runner.lr != cfg.TRAINING.lr              # two decays applied
    assert sw["state"].keys() == sg["state"].keys() and sw["state"]
    for i in sw["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sw["state"][i][k], sg["state"][i][k])
    assert fresh.start_epoch == 0
    assert fresh.logger.show_best_ap() == runner.logger.show_best_ap()


def test_jax_runner_loads_port_checkpoint(trained, tmp_path):
    """hupr_tpu's Runner reads the port's model_best.pth through its .pth
    fallback and scores the test split to the port's AP within 5e-3."""
    from hupr_tpu.engine import Runner as JaxRunner

    root, jcfg, cfg, _ = trained
    shutil.copytree(root / "logs" / "run", tmp_path / "logs" / "run")
    for f in os.listdir(tmp_path / "logs" / "run"):
        if not f.startswith("model_best"):
            os.unlink(tmp_path / "logs" / "run" / f)
    cwd = _in(tmp_path)
    try:
        port = Runner(_args("run", True), cfg, device="cpu")
        port.load_model_weight("model_best")
        ap_port = port.eval(visualization=False)
        jax_runner = JaxRunner(_args("run", True), jcfg)
        jax_runner.load_model_weight("model_best")
        ap_jax = jax_runner.eval(visualization=False)
    finally:
        os.chdir(cwd)
    assert 0.0 < ap_port
    assert abs(ap_port - ap_jax) <= AP_ATOL


def test_epoch_matches_jax_runner(tmp_path):
    """One epoch of each Runner, both resumed from the same checkpoint.pth:
    the same batches (seed 0), per-step losses within rtol 2e-4, final
    weights and BN statistics within atol 7e-4 + rtol 1e-3, and each
    leaf's update from the checkpoint within 1e-2 of JAX's update, in L2
    norm relative to it. The weights bar alone is above what 3 Adam steps
    at lr 1e-4 move a weight (about 3e-4), so only the updates show that
    every leaf was trained as JAX trains it."""
    from hupr_tpu.engine import Runner as JaxRunner

    jcfg, cfg = _workspace(tmp_path)
    jcfg.TRAINING.epochs = cfg.TRAINING.epochs = 1
    for name in ("port", "jax"):
        _seed_checkpoint(tmp_path, cfg, name)
    w0 = torch.load(tmp_path / "logs" / "port" / "checkpoint.pth",
                    weights_only=True)["model_state_dict"]
    cwd = _in(tmp_path)
    try:
        port = Runner(_args("port"), cfg, device="cpu")
        port.load_model_weight("checkpoint")
        port.train()
        ref = JaxRunner(_args("jax"), jcfg)
        ref.load_model_weight("checkpoint")
        ref.train()
        losses = {}
        for name in ("port", "jax"):
            with open(f"logs/{name}/train_loss_list_0.json") as fp:
                losses[name] = json.load(fp)
    finally:
        os.chdir(cwd)
    assert len(losses["port"]) == len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert np.isclose(port.lr, ref.lr, rtol=1e-12)
    want = state_dict_from_jax(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats})
    got = port.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
        # measured: worst leaf 2.7e-4 (a BN weight of 8 channels); every
        # leaf moved, the least by 1.2e-4 at its largest element
        d_ref = (w - w0[k]).double()
        d_port = (got[k] - w0[k]).double()
        assert d_ref.norm() > 0, k
        rel = ((d_port - d_ref).norm() / d_ref.norm()).item()
        assert rel <= UPDATE_RTOL, (k, rel)


@pytest.mark.parametrize("duration,batch,sizes", [
    (8, 3, [3, 3, 2]), (6, 4, [4, 2])], ids=["8x3", "6x4"])
def test_sequence_eval_equals_classic(tmp_path, duration, batch, sizes):
    """Batch for batch, partial final batch included: the same image ids
    and boxes, pred2d equal, maxvals and losses within 1e-6."""
    _, cfg = _workspace(tmp_path, duration=duration, batch=batch)
    _seed_checkpoint(tmp_path, cfg, "seq", "model_best.pth")
    cwd = _in(tmp_path)
    try:
        run = Runner(_args("seq", True), cfg, device="cpu")
        run.load_model_weight("model_best")
        assert SequenceEvaluator.applicable(run.test_set, cfg)

        def collect(batches):
            return [({k: o[k].numpy() for k in ("pred2d", "maxvals",
                                                 "loss", "loss2")},
                     np.asarray(ids), np.asarray(bb), t)
                    for o, ids, bb, t in batches]

        classic = collect(run._classic_eval_batches())
        seq = collect(SequenceEvaluator(run.model, cfg)
                      .eval_batches(run.test_set))
    finally:
        os.chdir(cwd)
    assert [t for *_, t in classic] == [t for *_, t in seq] == sizes
    for (co, cids, cbb, t), (so, sids, sbb, _) in zip(classic, seq):
        np.testing.assert_array_equal(cids, sids)
        np.testing.assert_array_equal(cbb, sbb)
        np.testing.assert_array_equal(so["pred2d"][:t], co["pred2d"][:t])
        np.testing.assert_allclose(so["maxvals"][:t], co["maxvals"][:t],
                                   rtol=0, atol=1e-6)
        for k in ("loss", "loss2"):
            np.testing.assert_allclose(so[k], co[k], rtol=0, atol=1e-6)
        assert so["maxvals"][:t].std() > 1e-3    # peaks not flat


def test_applicability_guards_match_jax(tmp_path):
    from hupr_tpu.data import get_dataset as jax_get_dataset
    from hupr_tpu_torch.data import get_dataset

    jcfg, cfg = _workspace(tmp_path, duration=8)
    cwd = _in(tmp_path)
    try:
        cases = []
        for ratio, loss_decay, duration in ((1, -1, 8), (2, -1, 8),
                                            (1, 0.1, 8), (1, -1, 16)):
            for c in (jcfg, cfg):
                c.TRAINING.lossDecay = loss_decay
                c.DATASET.duration = duration
            want = JaxSequenceEvaluator.applicable(
                jax_get_dataset("test", jcfg, ratio), jcfg)
            ds = get_dataset("test", cfg, ratio)
            assert SequenceEvaluator.applicable(ds, cfg) == want
            cases.append(want)
            assert sequence_groups(ds.image_ids) == [(0, 8)]
    finally:
        os.chdir(cwd)
    assert cases == [True, False, False, False]


def test_abandoned_eval_iterator_releases_producer(tmp_path):
    _, cfg = _workspace(tmp_path)
    cwd = _in(tmp_path)
    try:
        run = Runner(_args("leak", True), cfg, device="cpu")
        before = threading.active_count()
        it = SequenceEvaluator(run.model, cfg).eval_batches(run.test_set)
        next(it)
        it.close()
        deadline = time.monotonic() + 10.0
        while threading.active_count() > before and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before, "lookahead thread leaked"
    finally:
        os.chdir(cwd)


def test_cli_trains_then_evaluates(tmp_path, monkeypatch):
    """python -m hupr_tpu_torch.main's flow on a YAML under ./config, with
    HUPR_PLATFORM=cpu: train one epoch (checkpoints, val keypoints), then
    --eval --keypoints scores the test split from model_best.pth."""
    import yaml

    from hupr_tpu_torch import main as cli

    _, cfg = _workspace(tmp_path)
    os.makedirs(tmp_path / "config")
    d = cfg.DATASET
    (tmp_path / "config" / "tiny.yaml").write_text(yaml.safe_dump({
        "DATASET": {"duration": d.duration, "dataDir": d.dataDir,
                    "rangeSize": 16, "azimuthSize": 16, "heatmapSize": 16,
                    "imgSize": 64, "trainName": [1], "valName": [1],
                    "testName": [1]},
        "MODEL": {"numFilters": 2},
        "TRAINING": {"batchSize": 3, "epochs": 1, "lrDecayIter": 2},
        "TEST": {"batchSize": 3}}))
    monkeypatch.setenv("HUPR_PLATFORM", "cpu")
    monkeypatch.delenv("HUPR_MULTIHOST", raising=False)
    monkeypatch.chdir(tmp_path)
    runner = cli.main(["--config", "tiny.yaml", "--dir", "cli"])
    assert runner.device.type == "cpu" and not runner.args.eval
    files = set(os.listdir("logs/cli"))
    assert {"model_best.pth", "checkpoint.pth", "checkpoint_0.pth",
            "val_results.json", "train_loss_list_0.json"} <= files
    runner = cli.main(["--config", "tiny.yaml", "--dir", "cli", "--eval",
                       "--keypoints"])
    with open("logs/cli/test_results.json") as fp:
        assert len(json.load(fp)) == 8
    monkeypatch.setenv("HUPR_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="HUPR_PLATFORM"):
        cli.main(["--config", "tiny.yaml", "--dir", "cli"])


def test_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """chunk-mode training and raw-ADC sequence eval (ROADMAP A4) and
    multi-host runs (A9) raise instead of running another path; with no
    card and no request for the CPU, the Runner and the CLI raise."""
    from hupr_tpu_torch import main as cli

    _, cfg = _workspace(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HUPR_MULTIHOST", raising=False)

    cfg.TRAINING.chunkTrain = True
    with pytest.raises(NotImplementedError, match="A4"):
        Runner(_args("x"), cfg, device="cpu")
    Runner(_args("x", True), cfg, device="cpu")     # eval reads no chunks
    cfg.TRAINING.chunkTrain = False
    cfg.TEST.sequenceSource = "adc"
    with pytest.raises(NotImplementedError, match="A4"):
        Runner(_args("x", True), cfg, device="cpu")
    cfg.TEST.sequenceSource = "cubes"

    monkeypatch.setenv("HUPR_MULTIHOST", "1")
    with pytest.raises(NotImplementedError, match="A9"):
        Runner(_args("x"), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        cli.run(_args("x"), cfg, device="cpu")
    monkeypatch.delenv("HUPR_MULTIHOST")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner(_args("x"), cfg)
    monkeypatch.delenv("HUPR_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.run(_args("x"), cfg, device=cli.requested_device())

    (tmp_path / "logs" / "x" / "model_best.ckpt").write_bytes(b"\x80")
    with pytest.raises(RuntimeError, match="model_best.ckpt"):
        checkpoint.find_checkpoint(str(tmp_path / "logs" / "x"),
                                   "model_best")


def test_load_checkpoint_reads_reference_forms(tmp_path):
    """A bare state_dict with DataParallel's 'module.' prefixes, and the
    reference's dict with a numpy.float64 accuracy (COCOeval's stats[0]),
    load; an optimizer state whose tensors do not fit the parameters they
    are paired with raises instead of training on them."""
    from hupr_tpu_torch.engine.steps import make_optimizer
    from hupr_tpu_torch.models.hupr import build_model

    _, cfg = _workspace(tmp_path)
    src = build_model(cfg, device="cpu")
    src.load_state_dict(synthetic_state_dict(src, seed=2))
    sd = src.state_dict()
    torch.save({"module." + k: v for k, v in sd.items()}, tmp_path / "a.pth")
    torch.save({"model_state_dict": sd, "epoch": 3,
                "accuracy": np.float64(0.5)}, tmp_path / "b.pth")
    for name, want in (("a.pth", (-1, -1.0, None)), ("b.pth", (3, 0.5, None))):
        dst = build_model(cfg, device="cpu")
        assert checkpoint.load_checkpoint(str(tmp_path / name), dst) == want
        for k, v in dst.state_dict().items():
            assert torch.equal(v, sd[k]), k

    tx = make_optimizer(cfg, src)
    for p in src.parameters():
        p.grad = torch.ones_like(p)
    tx.step()
    opt = tx.state_dict()
    shapes = [tuple(s["exp_avg"].shape) for s in opt["state"].values()]
    i, j = next((i, j) for i in range(len(shapes))
                for j in range(len(shapes)) if shapes[i] != shapes[j])
    opt["state"][i], opt["state"][j] = opt["state"][j], opt["state"][i]
    torch.save({"model_state_dict": sd, "optimizer_state_dict": opt,
                "epoch": 1, "accuracy": 0.1}, tmp_path / "c.pth")
    dst = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        checkpoint.load_checkpoint(str(tmp_path / "c.pth"), dst,
                                   make_optimizer(cfg, dst))
