"""A new cell, traffic mix and per-layer metric are new files: the harness
finds and validates them with no edit to a file it has."""

import json
import shutil

import pytest

from conftest import ROOT
from gpubench.catalog import Benchmark, Invalid


@pytest.fixture
def copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def add_cell(root, cell="serve_bf16.req32", metric="copy_ms.serve"):
    """What a later PR adds: a traffic mix, a cell with its limits, a
    metric with its reader; BENCHMARK.json gains entries."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "gpubench/traffic/serve_req32.json").read_text())
    mix["frames"] = 64
    (root / "gpubench/traffic/serve_req64.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": cell, "config": "hupr_fast_bf16",
                              "traffic": "serve_req64", "chips": 1,
                              "why": "64 frames a request in bf16"})
    (root / f"gpubench/limits/{cell}.json").write_text(
        json.dumps({"maxval_gap": 1e-2, "argmax_gap": 1e-2}))
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": metric, "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "host dispatch",
                              "moves": "frames_per_s", "workloads": [cell]})
    (root / "gpubench/layer_metrics/copy_ms.py").write_text(
        "def read(metric, ctx):\n    return 1.5\n")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


def test_new_files_are_found(copy):
    before = {p: p.read_bytes() for p in (copy / "gpubench").rglob("*")
              if p.is_file()}
    add_cell(copy)
    bench = Benchmark(copy).validate()
    assert all(p.read_bytes() == data for p, data in before.items())
    names = [m["name"] for m in bench.per_layer("serve_bf16.req32")]
    assert names == ["copy_ms.serve"]
    assert bench.reader("copy_ms.serve")("copy_ms.serve", None) == 1.5
    assert [m["name"] for m in bench.end_to_end("serve_bf16.req32")] == [
        "frames_per_s", "setup_s"]
    assert bench.traffic("serve_req64")["frames"] == 64
    assert bench.traffic_module("serve_requests").Load


@pytest.mark.parametrize("edit", [
    lambda s: s["workloads"][-1].update(name="serve bf16"),
    lambda s: s["workloads"][-1].update(name="serve/bf16"),
    lambda s: s["per_layer"][-1].update(unit="ms per frame"),
    lambda s: s["per_layer"][-1].update(unit="µs"),
    lambda s: s["per_layer"][-1].update(why="a key of no entry"),
    lambda s: s["per_layer"][-1].update(name="missing_reader.serve"),
    lambda s: s["workloads"][-1].update(traffic="serve_req32",
                                        config="hupr_flagship_f32"),
    lambda s: s["end_to_end"][0].update(bound=0.3),
])
def test_broken_entries_are_refused(copy, edit):
    spec = add_cell(copy)
    edit(spec)
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises((Invalid, KeyError)):
        Benchmark(copy).validate()


def test_the_repository_benchmark_is_valid(bench):
    assert bench.spec["command"] == ["python3", "-m", "gpubench.run"]
    assert bench.spec["paths"] == ["gpubench"]
