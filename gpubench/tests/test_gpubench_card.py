"""On the card, at each cell's own size: a short run comes out correct,
and the control, the reference one notch below the configuration's
precision in the program's place, fails one of the cell's limits.

    python3 -m pytest gpubench/tests -m cuda
"""

import pytest

from gpubench.reference.precision import full_float32
from gpubench.run import run_cell

CELLS = ["serve_f32.req32", "train_bf16.b20", "stream_bf16.live"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(bench, card, name):
    result = run_cell(bench, bench.cell(name), 2 ** 31 + 17, 2.0, True,
                      device=card)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS + ["train_f32.dp4"])
def test_control_fails_a_limit(bench, card, name):
    cell = bench.cell(name)
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    with full_float32():
        readings = bench.traffic_module(traffic["kind"]).control(
            bench.config(cell["config"]), traffic, 2 ** 31 + 19, card)
    assert any(readings[k] > limits[k] for k in limits), readings
