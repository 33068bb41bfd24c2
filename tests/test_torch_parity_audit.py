"""The port's parity audit (hupr_tpu_torch/scripts/parity_audit.py): the
five cases of tests/test_parity_audit.py on synthetic tiny assets with a
model_best.pth the port saves (the checklist with exit 2 when the weights
or the dataset are missing, the JSON report, the val split, the
--expected-ap gate at exit 1 and exit 0), a JAX-package .ckpt refused, and
a differential: on the same .pth the port's 10 stats and per-keypoint APs
equal the repo's scripts/parity_audit.py's within PROTOCOL_ATOL. The GT
boxes are inflated to 1500x1500 as tests/test_golden_ap.py's workspace
does, so that a random model scores an AP above 0."""

import importlib.util
import json
import os

import pytest
import torch
import yaml

from hupr_tpu_torch.config import load_config
from hupr_tpu_torch.engine.checkpoint import snapshot, write_checkpoint
from hupr_tpu_torch.engine.steps import make_optimizer
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.scripts import parity_audit
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict
from test_e2e import make_tiny_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOCOL_ATOL = 5e-3        # tests/test_golden_ap.py:100
STATS = ("AP", "AP50", "AP75", "APm", "APl", "AR", "AR50", "AR75", "ARm",
         "ARl")


@pytest.fixture(scope="module")
def audit_workdir(tmp_path_factory):
    """tests/test_parity_audit.py's asset tree (32x32 geometry, dataset
    under data/, config tiny.yaml, classic eval) with the port's seeded
    N(0, 0.1) weights as logs/tiny/model_best.pth."""
    root = tmp_path_factory.mktemp("audit")
    data_dir = str(root / "data")
    make_tiny_dataset(data_dir, [1], r=32, a=32, img_size=128)
    for phase in ("train", "val", "test"):
        path = os.path.join(data_dir, f"hrnet_annot_{phase}.json")
        with open(path) as fp:
            annots = json.load(fp)
        for block in annots[0]:
            block["bbox"] = [0.0, 0.0, 1500.0, 1500.0]
        with open(path, "w") as fp:
            json.dump(annots, fp)
    cfg_path = str(root / "tiny.yaml")
    with open(cfg_path, "w") as fp:
        yaml.safe_dump({
            "DATASET": {"duration": 8, "dataDir": data_dir,
                        "trainName": [1], "valName": [1], "testName": [1],
                        "rangeSize": 32, "azimuthSize": 32,
                        "heatmapSize": 32, "imgSize": 128},
            "MODEL": {"numFilters": 2},
            "TRAINING": {"batchSize": 2, "epochs": 1},
            "TEST": {"batchSize": 2, "sequenceEval": False},
        }, fp)
    cfg = load_config(cfg_path)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(synthetic_state_dict(model, seed=1, scale=0.1))
    os.makedirs(root / "logs" / "tiny")
    write_checkpoint(str(root / "logs" / "tiny" / "model_best.pth"),
                     snapshot(model, make_optimizer(cfg, model), 0, -1.0))
    return root


def _run_audit(monkeypatch, capsys, workdir, argv):
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("HUPR_PLATFORM", "cpu")
    rc = parity_audit.main(argv)
    return rc, capsys.readouterr().out


def _report(out):
    return json.loads(out.strip().splitlines()[-1])


def test_missing_assets_prints_checklist(monkeypatch, capsys, audit_workdir):
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir,
                         ["--config", "tiny.yaml", "--dir", "nonexistent"])
    assert rc == 2
    assert "parity audit blocked" in out
    assert "weights: no model_best.pth" in out
    assert "annotation file" not in out and "sequence dir" not in out


def test_missing_dataset_prints_checklist(monkeypatch, capsys, audit_workdir,
                                          tmp_path):
    cfg_path = str(tmp_path / "empty.yaml")
    with open(cfg_path, "w") as fp:
        yaml.safe_dump({"DATASET": {"duration": 8,
                                    "dataDir": str(tmp_path / "nodata"),
                                    "trainName": [1], "valName": [1],
                                    "testName": [1]}}, fp)
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir,
                         ["--config", cfg_path, "--dir", "nonexistent"])
    assert rc == 2
    assert "annotation file" in out
    assert "2 sequence dir(s)" in out
    assert "weights" in out
    rc, _ = _run_audit(monkeypatch, capsys, audit_workdir,
                       ["--config", "no_such.yaml"])
    assert rc == 2


def test_audit_runs_and_reports(monkeypatch, capsys, audit_workdir):
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir,
                         ["--config", "tiny.yaml", "--dir", "tiny",
                          "--split", "test"])
    assert rc == 0
    report = _report(out)
    assert report["split"] == "test"
    assert set(report) == {"split", "config", "checkpoint_dir"} | set(STATS)
    for k in STATS:
        assert 0.0 <= report[k] <= 1.0 or report[k] == -1.0
    assert report["AP"] > 0.0
    assert os.path.exists(audit_workdir / "logs" / "tiny"
                          / "test_results.json")


def test_audit_val_split(monkeypatch, capsys, audit_workdir):
    """--split val scores val_results.json, named after the split."""
    stale = audit_workdir / "logs" / "tiny" / "val_results.json"
    if stale.exists():
        stale.unlink()
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir,
                         ["--config", "tiny.yaml", "--dir", "tiny",
                          "--split", "val"])
    assert rc == 0
    assert _report(out)["split"] == "val"
    assert os.path.exists(stale)


def test_expected_ap_gate(monkeypatch, capsys, audit_workdir):
    base = ["--config", "tiny.yaml", "--dir", "tiny", "--split", "test"]
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir, base)
    assert rc == 0
    ap = _report(out)["AP"]
    # far-off expectation -> exit 1, delta recorded
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir,
                         base + ["--expected-ap", str(ap + 0.5)])
    assert rc == 1
    report = _report(out)
    assert report["within_tolerance"] is False
    assert report["delta"] == pytest.approx(-0.5, abs=1e-6)
    # matching expectation -> exit 0
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir,
                         base + ["--expected-ap", str(ap),
                                 "--tolerance", "0.005"])
    assert rc == 0
    assert _report(out)["within_tolerance"] is True


def test_jax_ckpt_in_place_of_the_pth_raises(monkeypatch, capsys,
                                             audit_workdir, tmp_path):
    """A JAX-package model_best.ckpt is not read, and not taken as
    missing weights either: find_checkpoint raises, naming it."""
    os.makedirs(tmp_path / "logs" / "jaxrun")
    (tmp_path / "logs" / "jaxrun" / "model_best.ckpt").write_bytes(b"\x80")
    (tmp_path / "tiny.yaml").write_text(
        (audit_workdir / "tiny.yaml").read_text())
    with pytest.raises(RuntimeError, match="model_best.ckpt"):
        _run_audit(monkeypatch, capsys, tmp_path,
                   ["--config", "tiny.yaml", "--dir", "jaxrun"])


def test_stats_equal_jax_audit(monkeypatch, capsys, audit_workdir):
    """The repo's scripts/parity_audit.py scores the same model_best.pth
    (through the JAX package's .pth reader) to the port's 10 stats and
    per-keypoint APs within PROTOCOL_ATOL."""
    argv = ["--config", "tiny.yaml", "--dir", "tiny", "--split", "test",
            "--keypoints"]
    rc, out = _run_audit(monkeypatch, capsys, audit_workdir, argv)
    assert rc == 0
    got = _report(out)
    spec = importlib.util.spec_from_file_location(
        "parity_audit_jax", os.path.join(REPO, "scripts", "parity_audit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr("sys.argv", ["parity_audit.py"] + argv)
    assert mod.main() == 0
    want = _report(capsys.readouterr().out)
    assert got["AP"] > 0.0
    for k in STATS:
        assert abs(got[k] - want[k]) <= PROTOCOL_ATOL, (k, got[k], want[k])
    assert got["per_keypoint_AP"].keys() == want["per_keypoint_AP"].keys()
    for name, v in want["per_keypoint_AP"].items():
        assert abs(got["per_keypoint_AP"][name] - v) <= PROTOCOL_ATOL, name
