"""The port's Runner in chunk mode and on raw ADC against hupr_tpu's, on
the CPU at the reduced capture geometry of tests/test_torch_chunk.py: the
loader that drives training and the eval source it installs, with the JAX
package's fallbacks and notices; one epoch of raw-ADC chunk training and
raw-ADC sequence eval against the JAX Runner's (the Doppler-0 plane pinned
on both sides); and the fast recipe's levers through the CLI's flow."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from hupr_tpu.ops import dsp as jax_dsp
from hupr_tpu_torch.engine import chunk_train, runner as port_runner
from test_torch_chunk import (D0, LOSS_RTOL, _assert_states_close,
                              _jax_state, _port_state, adc_workspace)

torch.set_num_threads(1)

AP_ATOL = 5e-3                        # tests/test_golden_ap.py's protocol


def _args(dir_name, eval_mode=False):
    return argparse.Namespace(seed=0, dir=dir_name, visDir="none",
                              eval=eval_mode, sampling_ratio=1,
                              keypoints=False)


def _pin_doppler0(monkeypatch):
    """The Doppler-0 plane of every cube the raw-ADC paths make, zero on
    both sides."""
    port_cube, jax_cube = (chunk_train.radar_cube_frames,
                           jax_dsp.radar_cube_single_frame)

    def port_pinned(frames, params):
        c = port_cube(frames, params)
        c[:, D0] = 0
        return c

    monkeypatch.setattr(chunk_train, "radar_cube_frames", port_pinned)
    monkeypatch.setattr(jax_dsp, "radar_cube_single_frame",
                        lambda fr, p: jax_cube(fr, p).at[D0].set(0))


def _notices(out):
    return [line for line in out.splitlines() if line.startswith(
        "==========>") and ("requested" in line or "hint:" in line)]


@pytest.mark.parametrize("case", ["adc", "adc-missing", "cubes",
                                  "inapplicable", "classic"])
def test_runner_installs_like_jax(tmp_path, monkeypatch, capsys, case):
    """The loader that drives training, its steps an epoch and the eval
    source, with the JAX Runner's notices word for word: raw-ADC chunks;
    cube chunks when the captures do not cover the split; the classic
    loader when chunk mode is inapplicable (lossDecay set), and the hint
    for a classic run that qualifies."""
    from hupr_tpu.engine import Runner as JaxRunner

    jcfg, cfg = adc_workspace(tmp_path)
    for c in (jcfg, cfg):
        c.TRAINING.batchSize = 3
        c.TRAINING.chunkTrain = case != "classic"
        c.TRAINING.chunkSource = "cubes" if case == "cubes" else "adc"
        c.TEST.sequenceSource = "adc"
        if case == "adc-missing":
            c.DATASET.adcDir = str(tmp_path / "nowhere")
        if case == "inapplicable":
            c.TRAINING.lossDecay = 0.1
    monkeypatch.chdir(tmp_path)
    port = port_runner.Runner(_args("p"), cfg, device="cpu")
    adc_eval = port._adc_eval_source()
    port_out = capsys.readouterr().out
    ref = JaxRunner(_args("j"), jcfg)
    ref_adc_eval = ref._adc_eval_source()
    ref_out = capsys.readouterr().out
    assert _notices(port_out) == _notices(ref_out)
    kinds = {"adc": chunk_train.ADCChunkLoader,
             "cubes": chunk_train.ChunkTrainLoader}
    want = {"adc": "adc", "adc-missing": "cubes", "cubes": "cubes"}.get(case)
    if want is None:
        assert port._chunk_loader is None and ref._chunk_loader is None
        assert port.train_loader is not None
    else:
        assert type(port._chunk_loader) is kinds[want]
        assert type(ref._chunk_loader).__name__ == kinds[want].__name__
        assert len(port._chunk_loader) == len(ref._chunk_loader) == 3
    # lossDecay set makes sequence eval inapplicable too
    assert (adc_eval is None) == (ref_adc_eval is None) == \
        (case in ("adc-missing", "inapplicable"))
    assert ("hint:" in port_out) == (case == "classic")


def test_runner_adc_epoch_equals_jax(tmp_path, monkeypatch):
    """One epoch of chunk-mode raw-ADC training (3 steps: chunks of 3, 3
    and 2) with raw-ADC sequence val eval, the port's Runner against the
    JAX Runner from the same checkpoint.pth, the Doppler-0 plane pinned on
    both sides: per-step losses, final weights and BN statistics, the val
    AP."""
    from hupr_tpu.engine import Runner as JaxRunner
    from hupr_tpu_torch.engine import checkpoint

    _pin_doppler0(monkeypatch)
    jcfg, cfg = adc_workspace(tmp_path)
    for c in (jcfg, cfg):
        c.TRAINING.batchSize = c.TEST.batchSize = 3
        c.TRAINING.chunkTrain = True
        c.TRAINING.chunkSource = c.TEST.sequenceSource = "adc"
    _, _, jstate = _jax_state(jcfg)
    seed = _port_state(cfg, jstate)
    for name in ("port", "jax"):
        os.makedirs(tmp_path / "logs" / name)
        checkpoint.write_checkpoint(
            str(tmp_path / "logs" / name / "checkpoint.pth"),
            checkpoint.snapshot(seed.model, seed.optimizer, 0, -1.0))
    monkeypatch.chdir(tmp_path)
    port = port_runner.Runner(_args("port"), cfg, device="cpu")
    port.load_model_weight("checkpoint")
    port.train()
    ref = JaxRunner(_args("jax"), jcfg)
    ref.load_model_weight("checkpoint")
    ref.train()
    assert isinstance(port._chunk_loader, chunk_train.ADCChunkLoader)
    assert port._seq_eval.adc is not None and ref._seq_eval.adc is not None
    losses = {}
    for name in ("port", "jax"):
        with open(f"logs/{name}/train_loss_list_0.json") as fp:
            losses[name] = json.load(fp)
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)
    _assert_states_close(port.model, ref.state.params, ref.state.batch_stats)
    assert 0.0 < port.epoch_aps[0] < 1.0
    assert abs(port.epoch_aps[0] - ref.logger.show_best_ap()) <= AP_ATOL


def test_runner_trains_the_fast_recipe(tmp_path, monkeypatch, capsys):
    """fast_training_config()'s levers at the tiny size (bfloat16 compute,
    bfloat16 wire, chunk mode from raw ADC, raw-ADC sequence eval) run
    through the CLI's flow with no fallback notice: finite losses, the val
    keypoints and the checkpoints written."""
    from hupr_tpu_torch import config as port_config
    from hupr_tpu_torch.main import run

    _, cfg = adc_workspace(tmp_path)
    fast = port_config.fast_training_config()
    cfg.MODEL.computeDtype = fast.MODEL.computeDtype
    cfg.SETUP.transferDtype = fast.SETUP.transferDtype
    for key in ("chunkTrain", "chunkSource"):
        setattr(cfg.TRAINING, key, getattr(fast.TRAINING, key))
    cfg.TEST.sequenceSource = fast.TEST.sequenceSource
    cfg.TRAINING.batchSize = 3
    monkeypatch.chdir(tmp_path)
    runner = run(_args("fast"), cfg, device="cpu")
    out = capsys.readouterr().out
    assert "requested" not in out and "chunk steps" in out
    assert isinstance(runner._chunk_loader, chunk_train.ADCChunkLoader)
    assert runner._seq_eval.adc is not None
    with open("logs/fast/train_loss_list_0.json") as fp:
        losses = json.load(fp)
    assert len(losses) == 3 and all(np.isfinite(losses))
    with open("logs/fast/val_results.json") as fp:
        assert len(json.load(fp)) == 8
    assert os.path.exists("logs/fast/checkpoint.pth")
