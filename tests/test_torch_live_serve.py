"""The port's live serving script (hupr_tpu_torch/scripts/live_serve.py)
against the repo's scripts/live_serve.py, on the CPU over loopback UDP at
tests/test_live_serve.py's 32x32 geometry (numFilters 2, 4 frames,
--synthetic, --platform cpu). Both read one .pth that the port saves. The
JAX script reads its --checkpoint as msgpack, so its loader is pointed at
the JAX package's own .pth reader (engine.checkpoint.load_torch_checkpoint)
for the run. FFT libraries leave their own residue in the Doppler-0 chirp
plane, which the per-plane normalize blows up to O(1), so that plane is
pinned to its exact value, zero, on both sides (tests/test_torch_pipeline.py
says why)."""

import os
import re

import importlib.util
import numpy as np
import pytest
import torch
import yaml

import hupr_tpu.engine.checkpoint as jax_checkpoint
import hupr_tpu.engine.streaming as jax_streaming
import hupr_tpu_torch.engine.streaming as port_streaming
from hupr_tpu_torch.config import load_config
from hupr_tpu_torch.data.capture import stream_to_iq_planes
from hupr_tpu_torch.engine.checkpoint import snapshot, write_checkpoint
from hupr_tpu_torch.engine.steps import make_optimizer
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.scripts import live_serve
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 4
# F x RX x chirps x ADC x IQ x int16 bytes
FULL_BYTES = FRAMES * 4 * 48 * 128 * 2 * 2
PRINT_ATOL = 1e-4
LINE = re.compile(r"frame +(\d+) \(stream idx (\d+)\): "
                  r"keypoint\[0\]=\[([^\]]*)\], max=([0-9.]+)")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The tiny live config and a port model_best-style .pth of seeded
    N(0, 0.1) weights (at numFilters 2 and 32x32 maps the heatmap peaks
    then spread, neither flat nor saturated)."""
    root = tmp_path_factory.mktemp("live")
    cfg_path = str(root / "tiny_live.yaml")
    with open(cfg_path, "w") as fp:
        yaml.safe_dump({
            "DATASET": {"rangeSize": 32, "azimuthSize": 32,
                        "heatmapSize": 32, "imgSize": 128,
                        "numChirps": 8,
                        "adcParams": {"num_adc_samples": 128,
                                      "num_chirp": 48,
                                      "idx_proc_chirp": 16,
                                      "num_group_chirp": 2}},
            "MODEL": {"numFilters": 2, "attention": "pallas"},
        }, fp)
    cfg = load_config(cfg_path)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(synthetic_state_dict(model, seed=3, scale=0.1))
    ckpt = str(root / "model_best.pth")
    write_checkpoint(ckpt, snapshot(model, make_optimizer(cfg, model), 0,
                                    -1.0))
    return cfg_path, ckpt


@pytest.fixture
def doppler0_pinned(monkeypatch):
    d0 = 8 // 2                          # Doppler bin 0 after the crop
    jax_cube, port_cube = (jax_streaming.radar_cube_single_frame,
                           port_streaming.radar_cube_frames)

    def port_pinned(frames, params):
        c = port_cube(frames, params)
        c[:, d0] = 0
        return c

    monkeypatch.setattr(jax_streaming, "radar_cube_single_frame",
                        lambda fr, p: jax_cube(fr, p).at[d0].set(0))
    monkeypatch.setattr(port_streaming, "radar_cube_frames", port_pinned)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "live_serve_jax", os.path.join(REPO, "scripts", "live_serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(out):
    """{served frame n: (keypoint[0], max)} from the cadence lines."""
    got = {}
    for m in LINE.finditer(out):
        kp = np.array([float(v) for v in m.group(3).split()])
        got[int(m.group(1))] = (kp, float(m.group(4)))
    return got


def _assert_clean(out):
    assert f"served {FRAMES} frames" in out
    assert "capture ended early" not in out
    assert "resync:" not in out
    stats = re.findall(r"'bytes': (\d+)", out)
    assert [int(s) for s in stats] == [FULL_BYTES, FULL_BYTES]


def _direct_poses(cfg_path, ckpt, streams):
    """The poses of a StreamingPoseEstimator fed the streams' int16 planes
    directly, frame by frame (the plain attention, as the script runs on
    the CPU)."""
    cfg = load_config(cfg_path)
    cfg.MODEL.attention = "xla"
    rp = cfg.DATASET.radar_params()
    model = build_model(cfg, device="cpu")
    state = torch.load(ckpt, weights_only=True)["model_state_dict"]
    est = port_streaming.StreamingPoseEstimator(model, state, rp,
                                                device="cpu")
    s = rp.num_rx * rp.num_chirp * rp.num_adc_samples * 2
    out = [est.process_frame(
        stream_to_iq_planes(streams["hori"][t * s:(t + 1) * s], rp),
        stream_to_iq_planes(streams["vert"][t * s:(t + 1) * s], rp))
        for t in range(FRAMES)]
    return np.stack([p for p, _ in out]), np.stack([m for _, m in out])


def test_live_serve_equals_jax_script(workspace, doppler0_pinned, capsys,
                                      monkeypatch):
    cfg_path, ckpt = workspace
    argv = ["--config", cfg_path, "--checkpoint", ckpt, "--synthetic",
            "--frames", str(FRAMES), "--platform", "cpu"]
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint",
                        jax_checkpoint.load_torch_checkpoint)
    monkeypatch.setattr("sys.argv", ["live_serve.py"] + argv)
    _jax_script().main()
    want = capsys.readouterr().out
    result = live_serve.main(argv)
    got = capsys.readouterr().out
    for out in (want, got):
        _assert_clean(out)
        assert "live_serve: cpu platform — MODEL.attention pallas -> xla" \
            in out
        assert "SYNTHETIC" not in out
    want_lines, got_lines = _printed(want), _printed(got)
    assert sorted(got_lines) == sorted(want_lines) == [1, FRAMES]
    for n, (kp, mx) in want_lines.items():
        np.testing.assert_allclose(got_lines[n][0], kp, rtol=0,
                                   atol=PRINT_ATOL)
        assert abs(got_lines[n][1] - mx) <= PRINT_ATOL + 1e-9, n
    assert result["served"] == FRAMES and result["resyncs"] == 0
    assert result["native"]                 # native=None picked the C++ one
    for view in ("hori", "vert"):
        s = result["stats"][view]
        assert s["bytes"] == FULL_BYTES
        assert s["late_bytes"] == s["overflow_frames"] == 0
    assert len(result["flushed"]) == 3      # the lookahead poses
    # the script's poses are those of the estimator fed the same planes
    rng = np.random.default_rng(0)           # --synthetic's draw
    streams = {v: rng.integers(-300, 300, FULL_BYTES // 2).astype(np.int16)
               for v in ("hori", "vert")}
    pred, maxv = _direct_poses(cfg_path, ckpt, streams)
    np.testing.assert_array_equal(result["pred2d"], pred)
    np.testing.assert_array_equal(result["maxvals"], maxv)
    assert float(np.std(maxv)) > 1e-3        # peaks not flat


def test_replay_and_streams_serve_the_capture(workspace, tmp_path, capsys):
    """--replay reads {dir}/{hori,vert}/adc_data.bin, and serve(streams=)
    replays given streams: both serve the estimator's poses on them, on
    the NumPy engine when native=False."""
    cfg_path, ckpt = workspace
    rng = np.random.default_rng(5)
    streams = {v: rng.integers(-300, 300, FULL_BYTES // 2).astype(np.int16)
               for v in ("hori", "vert")}
    for view, s in streams.items():
        os.makedirs(tmp_path / view)
        s.tofile(tmp_path / view / "adc_data.bin")
    pred, maxv = _direct_poses(cfg_path, ckpt, streams)
    base = ["--config", cfg_path, "--checkpoint", ckpt, "--frames",
            str(FRAMES), "--platform", "cpu"]
    replayed = live_serve.main(base + ["--replay", str(tmp_path)])
    _assert_clean(capsys.readouterr().out)
    args = live_serve.build_arg_parser().parse_args(base)
    given = live_serve.serve(args, load_config(cfg_path), streams=streams,
                             native=False)
    _assert_clean(capsys.readouterr().out)
    assert replayed["native"] and not given["native"]
    for result in (replayed, given):
        np.testing.assert_array_equal(result["pred2d"], pred)
        np.testing.assert_array_equal(result["maxvals"], maxv)


def test_platform_other_than_cpu_is_refused(workspace):
    cfg_path, _ = workspace
    with pytest.raises(ValueError, match="--platform"):
        live_serve.main(["--config", cfg_path, "--synthetic",
                         "--platform", "tpu"])
