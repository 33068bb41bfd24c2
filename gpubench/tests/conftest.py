"""CPU tests of the benchmark: tiny sizes of the cells' shapes.

Run from the root of the checkout: `python -m pytest gpubench/tests`.
Tests that need the card are marked `cuda` and skip without one."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each mix cut to a size the CPU runs in seconds; widths stay but for
# numFilters, which takes the encoders from 32 to 2 filters
TINY_TRAFFIC = {"serve_requests": {"frames": 4, "distinct": 2,
                                   "tail_units": 1},
                "train_steps": {"batch": 2, "distinct": 3,
                                "warmup_steps": 1, "tail_units": 1},
                "stream_frames": {"capture": 12, "warmup_frames": 3,
                                  "sample": 4, "tail_units": 2},
                "train_dp": {"batch": 4, "distinct": 3, "warmup_steps": 1,
                             "tail_units": 1}}


@pytest.fixture(scope="session")
def bench():
    from gpubench.catalog import Benchmark

    return Benchmark().validate()


@pytest.fixture
def tiny(bench):
    """tiny(cell name) -> (cell, config, traffic) at a CPU size."""
    def make(name):
        cell = bench.cell(name)
        config = copy.deepcopy(bench.config(cell["config"]))
        config["MODEL"]["numFilters"] = 2
        traffic = bench.traffic(cell["traffic"])
        traffic.update(TINY_TRAFFIC[traffic["kind"]])
        return cell, config, traffic
    return make


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
