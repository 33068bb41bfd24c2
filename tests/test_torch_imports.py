"""The PyTorch port stands alone: importing it pulls in no JAX, nothing of
hupr_tpu and no PyYAML; its config resolves the shipped YAMLs to the same
values as hupr_tpu.config; its entry points refuse to fall back to the CPU."""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from hupr_tpu import config as jax_config
from hupr_tpu_torch import config as port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.yaml")))

# what the port must not import, and what the card's machine lacks (torch
# itself imports tqdm where it is installed): importing any of them raises
# in the subprocess below
BLOCKED = ("jax", "flax", "optax", "hupr_tpu", "yaml", "tqdm", "cv2", "PIL",
           "ml_dtypes", "msgpack")

# modules that must be among those imported: the streaming, chunk-training,
# raw-ADC and remat scripts' modules, the preprocessing CLI, the live
# capture, live serving and the parity audit, data parallelism, and the
# serving export, the profiler helpers and the convolution microbenchmark,
# the frame-axis sharding of one request, and the graft entry points
NEW = ("data.adc", "engine.chunk_train", "engine.streaming",
       "scripts.remat_memory", "scripts.batch_sweep",
       "preprocessing.process_iwr1843", "data.capture", "scripts.live_serve",
       "scripts.parity_audit", "parallel", "parallel.mesh",
       "parallel.multihost", "scripts.dp_scaling", "engine.export",
       "scripts.export_serving", "utils.profiling", "scripts.profile_train",
       "scripts.conv_microbench", "parallel.halo", "graft_entry")

_IMPORT_ALL = """
import importlib, pkgutil, sys
BLOCKED = %r
NEW = %r
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import hupr_tpu_torch
for mod in pkgutil.walk_packages(hupr_tpu_torch.__path__, "hupr_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", len([m for m in sys.modules if m.startswith("hupr_tpu_torch")]))
print("MAIN", "hupr_tpu_torch.main" in sys.modules)
for m in NEW:
    if "hupr_tpu_torch." + m in sys.modules:
        print("NEW", "hupr_tpu_torch." + m)
print("BAD", bad)
""" % (BLOCKED, NEW)


def test_port_imports_no_jax_no_reference_package():
    """Every module of the port, its CLI (hupr_tpu_torch.main) and the
    modules of NEW among them, and chip_smoke.py import with JAX, the JAX
    package, PyYAML, tqdm, cv2, PIL, ml_dtypes and msgpack blocked."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "MAIN True" in out.stdout, out.stdout
    loaded = int(re.search(r"LOADED (\d+)", out.stdout).group(1))
    assert loaded >= 30, out.stdout
    for module in NEW:
        assert f"NEW hupr_tpu_torch.{module}" in out.stdout, out.stdout


def test_port_sources_name_no_jax_or_reference_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|flax|optax|hupr_tpu)(\.|\s|$)", re.M)
    files = glob.glob(os.path.join(REPO, "hupr_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) >= 15
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_configs_resolve_like_jax(path):
    want = dataclasses.asdict(jax_config.load_config(path))
    got = dataclasses.asdict(port_config.load_config(path))
    assert got == want


def test_config_count():
    assert len(CONFIGS) == 4


def test_flagship_serving_config_equals_yaml():
    """chip_smoke.py builds the flagship config without PyYAML; every field
    but the split lists, which serving never reads, is the YAML's."""
    want = dataclasses.asdict(port_config.load_config(
        os.path.join(REPO, "config", "mscsa_prgcn_tpu.yaml")))
    got = dataclasses.asdict(port_config.flagship_serving_config())
    for split in ("testName", "valName", "trainName"):
        assert want["DATASET"].pop(split)
        assert got["DATASET"].pop(split) == []
    assert got == want


def test_radar_params_validates_geometry():
    cfg = port_config.config_from_dict({})
    rp = cfg.DATASET.radar_params()
    assert (rp.num_angle_bins, rp.num_kept_chirps) == (64, 16)
    bad = port_config.config_from_dict(
        {"DATASET": {"adcParams": {"num_adc_samples": 128}}})
    with pytest.raises(ValueError, match="geometry"):
        bad.DATASET.radar_params()


def test_entry_points_refuse_silent_cpu(monkeypatch, tmp_path):
    """With no card and no request for the CPU, the entry points raise:
    build_model, make_e2e_infer, the preprocessor and its CLI, live
    serving (script and body), the parity audit (script and body), loading
    a serving artifact, the profiling script and the convolution
    microbenchmark."""
    from hupr_tpu_torch.engine import export
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import HuPRNet, build_model
    from hupr_tpu_torch.preprocessing import process_iwr1843
    from hupr_tpu_torch.scripts import (conv_microbench, live_serve,
                                        parity_audit, profile_train)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HUPR_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    cfg = port_config.config_from_dict({"MODEL": {"numFilters": 2}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_e2e_infer(HuPRNet(num_filters=2, heatmap_size=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_iwr1843.RadarPreprocessor(num_sequences=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_iwr1843.main(["--sequences", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        live_serve.main(["--synthetic", "--frames", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        live_serve.serve(live_serve.build_arg_parser().parse_args(
            ["--synthetic"]), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_audit.main(["--config", "mscsa_prgcn.yaml"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_serving(export.MAGIC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_artifact(str(tmp_path / "absent.pt2"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_train.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv_microbench.main([])
    (tmp_path / "data").mkdir()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_audit.run_audit(parity_audit.build_arg_parser().parse_args(
            ["--dir", "x"]), port_config.config_from_dict(
            {"DATASET": {"dataDir": "data", "testName": [1],
                         "duration": 1}}))
    assert build_model(cfg, device="cpu").training is False
    assert not os.path.exists(tmp_path / "data" / "HuPR")


@pytest.mark.parametrize("field,value,exc", [
    ("attention", "pallas_fp8", ValueError),
    ("computeDtype", "float16", ValueError),
    ("attention", "flash", ValueError),
])
def test_unported_model_options_raise(field, value, exc):
    from hupr_tpu_torch.models.hupr import build_model

    cfg = port_config.config_from_dict({"MODEL": {"numFilters": 2,
                                                  field: value}})
    with pytest.raises(exc):
        build_model(cfg, device="cpu")


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ,
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("argv", [
    [], ["--config", "mscsa_prgcn_tpu.yaml", "--dir", "x", "--eval"],
    ["--seed", "3", "-sr", "2", "--keypoints", "--visDir", "v",
     "--gpuIDs", "0,1"]])
def test_arg_parser_equals_jax(argv):
    """The CLI's 8 flags parse to the JAX package's values."""
    want = vars(jax_config.build_arg_parser().parse_args(argv))
    assert vars(port_config.build_arg_parser().parse_args(argv)) == want


def test_resolve_config_path_and_split_names(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "here.yaml").write_text("{}")
    for name in ("here.yaml", "mscsa_prgcn.yaml"):
        assert port_config.resolve_config_path(name) == \
            jax_config.resolve_config_path(name)
    cfg = port_config.config_from_dict({"DATASET": {
        "trainName": [1, 2], "valName": [3], "testName": [4]}})
    jcfg = jax_config.config_from_dict({"DATASET": {
        "trainName": [1, 2], "valName": [3], "testName": [4]}})
    for phase in ("train", "val", "test"):
        assert cfg.DATASET.split_names(phase) == \
            jcfg.DATASET.split_names(phase)
