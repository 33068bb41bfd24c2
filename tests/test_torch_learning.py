"""The port LEARNS (counterpart of tests/test_learning.py): the whole loop
of hupr_tpu_torch (dataset -> normalize -> HuPRNet -> BCE on Gaussian
targets -> torch Adam -> argmax decode -> keypoint export -> OKS
evaluator) drives a localization task from chance to AP > 0.1, on the
JAX test's data (make_learnable_dataset: a bright complex spike at the
joints' (range, azimuth) bin), geometry (numFilters 2, MODEL.attention
xla on the CPU), steps, batch, lr and bars. The weights are the port's own
initialization (torch's defaults, seed 0). chip_smoke.py's `learn` phase
runs the same recipe at full width through the kernels."""

import argparse
import filecmp
import os

import numpy as np
import pytest
import torch

from hupr_tpu_torch import config as port_config
from test_learning import make_learnable_dataset


def assert_same_files(got_root, want_root):
    """The same relative paths under both roots, byte-equal."""
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    assert tree(got_root) == tree(want_root) != []
    for rel in tree(want_root):
        assert filecmp.cmp(os.path.join(got_root, rel),
                           os.path.join(want_root, rel), shallow=False), rel


def test_chip_smoke_learnable_dataset_equals_jax_tests(tmp_path):
    """chip_smoke.py's numpy-only copy of make_learnable_dataset writes the
    JAX test's .npy cubes and annotation files byte for byte."""
    import chip_smoke

    chip_smoke.make_learnable_dataset(str(tmp_path / "got"), duration=3,
                                      seed=1)
    make_learnable_dataset(str(tmp_path / "want"), duration=3, seed=1)
    assert_same_files(tmp_path / "got", tmp_path / "want")


@pytest.mark.slow
def test_port_learns_localization_to_nonzero_ap(tmp_path):
    from hupr_tpu_torch.data import BatchLoader, get_dataset
    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                             make_optimizer, make_train_step)
    from hupr_tpu_torch.models.hupr import build_model

    duration, batch, steps = 8, 4, 150
    data_dir = str(tmp_path / "data")
    make_learnable_dataset(data_dir, duration)
    cfg = port_config.config_from_dict({
        "DATASET": {"duration": duration, "dataDir": data_dir,
                    "trainName": [1], "valName": [1], "testName": [1]},
        "MODEL": {"numFilters": 2},
        "TRAINING": {"batchSize": batch, "epochs": 1, "lr": 1e-3},
        "TEST": {"batchSize": batch},
    })
    ds = get_dataset("train", cfg)
    batches = list(BatchLoader(ds, batch, shuffle=False))
    device_batches = [{k: b[k] for k in ("hori", "vert", "jointsGroup")}
                      for b in batches]

    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    tx = make_optimizer(cfg, model)
    state = TrainState(model, tx)
    train_step = make_train_step(model, tx)
    eval_step = make_eval_step(model)

    first_loss = None
    for i in range(steps):
        state, metrics = train_step(state, device_batches[i % len(batches)],
                                    1e-3, 0.0)
        if first_loss is None:
            first_loss = metrics["loss"].item()
    last_loss = metrics["loss"].item()
    assert last_loss < 0.5 * first_loss, (first_loss, last_loss)

    # decoded pixel error on the train data: chance is ~85 px
    errs = []
    for b, db in zip(batches, device_batches):
        out = eval_step(state, db, 0.0)
        pred = out["pred2d"].numpy() * 4.0
        errs.append(np.abs(pred - np.asarray(b["jointsGroup"])).mean())
    assert float(np.mean(errs)) < 25.0, errs

    # the Runner's eval: keypoint export -> OKS evaluator -> AP (an
    # untrained model scores 0.000)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        args = argparse.Namespace(seed=0, dir="learn", visDir="none",
                                  eval=True, sampling_ratio=1,
                                  keypoints=False)
        runner = Runner(args, cfg, device="cpu")
        runner.model.load_state_dict(model.state_dict())
        ap = runner.eval(visualization=False)
    finally:
        os.chdir(cwd)
    print(f"learn: first loss {first_loss}, last {last_loss}, pixel error "
          f"{float(np.mean(errs))}, AP {ap}")
    assert ap > 0.1, ap
