"""Nothing the benchmark imports is JAX or the JAX package; the reference
imports nothing of the program either. Each check runs in a fresh
interpreter and compares the top-level name of every loaded module whole
(`hupr_tpu_torch` is not `hupr_tpu`)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

JAX = ["jax", "jaxlib", "flax", "optax", "hupr_tpu"]

LOAD = """
import json, sys
sys.path.insert(0, {root!r})
from gpubench.catalog import Benchmark
b = Benchmark()
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c",
                          LOAD.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_traffic_and_readers_load_no_jax(bench):
    kinds = sorted({bench.traffic(w["traffic"])["kind"]
                    for w in bench.spec["workloads"]})
    metrics = [m["name"] for m in bench.spec["per_layer"]]
    found = loaded(
        "import gpubench.run, gpubench.control, gpubench.trace\n"
        f"for k in {kinds!r}: b.traffic_module(k)\n"
        f"for m in {metrics!r}: b.reader(m)\n"
        "import hupr_tpu_torch.engine.pipeline, "
        "hupr_tpu_torch.engine.steps, hupr_tpu_torch.engine.streaming")
    assert "hupr_tpu_torch" in found and "gpubench" in found
    assert not found & set(JAX)


def test_reference_loads_nothing_of_the_program():
    found = loaded("import gpubench.reference, gpubench.reference.train")
    assert not found & set(JAX + ["hupr_tpu_torch"])


@pytest.mark.parametrize("name, caught", [("hupr_tpu", True),
                                          ("hupr_tpu.ops", True),
                                          ("hupr_tpu_torch", False),
                                          ("jaxlib.xla", True),
                                          ("jaxtyping", False)])
def test_run_guard_compares_whole_names(monkeypatch, name, caught):
    from gpubench import run

    monkeypatch.setitem(sys.modules, name, object())
    assert bool(run.forbidden_modules()) == caught


def test_no_card_no_result():
    """Without a card a run exits non-zero and prints no result: it never
    falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                          "serve_f32.req32", "--seed", str(2 ** 31 + 1),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
