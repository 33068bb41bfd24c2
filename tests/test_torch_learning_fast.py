"""The port's fast recipe LEARNS (counterpart of
tests/test_learning_fast.py): chunk-mode training over raw int16 DCA1000
captures with bfloat16 compute and wire (config/mscsa_prgcn_tpu_fast.yaml's
levers, engine/chunk_train.py), then raw-ADC sequence eval through the
Runner, drive a localization task from AP 0.0 past 0.1. The JAX test's
point-target captures (make_learnable_adc_dataset), reduced 32x32
geometry (ADC_PARAMS, numFilters 2, MODEL.attention xla on the CPU),
chunk batch 12, 160 steps, lr 3e-3 and bars; the weights are the port's
own initialization (torch's defaults, seed 0). chip_smoke.py's
`learn_fast` phase runs the same recipe at numFilters 32 through the
kernels."""

import argparse
import os

import numpy as np
import pytest
import torch

from hupr_tpu.ops.dsp import RadarParams as JaxRadarParams
from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.ops.dsp import RadarParams
from test_learning_fast import (ADC_PARAMS, make_learnable_adc_dataset,
                                point_target_frame, serialize_dca1000)
from test_torch_learning import assert_same_files


def fast_cfg(data_dir, adc_dir, duration=16, batch=12):
    """tests/test_learning_fast.py::fast_cfg for the port."""
    return port_config.config_from_dict({
        "DATASET": {"duration": duration, "dataDir": data_dir,
                    "adcDir": adc_dir, "adcParams": ADC_PARAMS,
                    "trainName": [1], "valName": [1], "testName": [1],
                    "rangeSize": 32, "azimuthSize": 32, "heatmapSize": 32,
                    "imgSize": 128},
        "MODEL": {"numFilters": 2, "computeDtype": "bfloat16"},
        "TRAINING": {"batchSize": batch, "epochs": 1, "lr": 3e-3,
                     "chunkTrain": True, "chunkSource": "adc"},
        "TEST": {"batchSize": 8, "sequenceEval": True,
                 "sequenceSource": "adc"},
        "SETUP": {"transferDtype": "bfloat16"},
    })


def test_chip_smoke_learnable_adc_dataset_equals_jax_tests(tmp_path):
    """chip_smoke.py's numpy-only copies of make_learnable_adc_dataset,
    point_target_frame and serialize_dca1000 (on the port's RadarParams)
    write the JAX test's raw captures and annotation files byte for
    byte."""
    import chip_smoke

    assert chip_smoke.LEARN_ADC_PARAMS == ADC_PARAMS
    rp, jrp = RadarParams(**ADC_PARAMS), JaxRadarParams(**ADC_PARAMS)
    frame = chip_smoke.point_target_frame(5, 9, rp)
    np.testing.assert_array_equal(frame, point_target_frame(5, 9, jrp))
    np.testing.assert_array_equal(chip_smoke.serialize_dca1000(frame),
                                  serialize_dca1000(frame))
    got = chip_smoke.make_learnable_adc_dataset(str(tmp_path / "got"), rp,
                                                duration=4, seed=2)
    want = make_learnable_adc_dataset(str(tmp_path / "want"), jrp,
                                      duration=4, seed=2)
    assert os.path.relpath(got, tmp_path / "got") == \
        os.path.relpath(want, tmp_path / "want")
    assert_same_files(tmp_path / "got", tmp_path / "want")


@pytest.mark.slow
def test_port_fast_recipe_learns_localization_to_nonzero_ap(tmp_path):
    from hupr_tpu_torch.data import get_dataset
    from hupr_tpu_torch.data.adc import ADCFrameSource
    from hupr_tpu_torch.engine.chunk_train import (ADCChunkLoader,
                                                   device_put_chunk,
                                                   make_adc_chunk_train_step)
    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.engine.steps import TrainState, make_optimizer
    from hupr_tpu_torch.models.hupr import build_model

    duration, batch, steps_max, lr = 16, 12, 160, 3e-3
    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir)
    adc_dir = make_learnable_adc_dataset(
        data_dir, JaxRadarParams(**ADC_PARAMS), duration)
    cfg = fast_cfg(data_dir, adc_dir, duration, batch)
    rp = cfg.DATASET.radar_params()

    ds = get_dataset("train", cfg)
    adc_source = ADCFrameSource(adc_dir, rp)
    assert ADCChunkLoader.applicable(ds, cfg, adc_source)
    loader = ADCChunkLoader(ds, batch, adc_source, seed=0, shuffle=True)

    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    tx = make_optimizer(cfg, model)
    state = TrainState(model, tx)
    d = cfg.DATASET
    step = make_adc_chunk_train_step(
        model, tx, geometry=(d.numKeypoints, d.heatmapSize, d.imgSize),
        radar_params=rp, num_frames=d.numFrames)

    first_loss, i = None, 0
    while i < steps_max:
        for batch_host in loader:          # a fresh epoch reshuffles
            dev, _ = device_put_chunk(batch_host, "cpu")
            state, metrics = step(state, dev, lr, 0.0)
            i += 1
            if first_loss is None:
                first_loss = metrics["loss"].item()
            elif i >= steps_max:
                break
    last_loss = metrics["loss"].item()
    assert np.isfinite(last_loss)
    assert last_loss < 0.2 * first_loss, (first_loss, last_loss)

    # the fast eval path: the Runner's raw-ADC sequence eval -> OKS AP
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        args = argparse.Namespace(seed=0, dir="learn_fast", visDir="none",
                                  eval=True, sampling_ratio=1,
                                  keypoints=False)
        runner = Runner(args, cfg, device="cpu")
        runner.model.load_state_dict(model.state_dict())
        ap = runner.eval(visualization=False)
    finally:
        os.chdir(cwd)
    assert runner._seq_eval is not None and runner._seq_eval.adc is not None
    print(f"learn_fast: first loss {first_loss}, last {last_loss}, AP {ap}")
    assert ap > 0.1, ap
