"""The port's profiler helpers (hupr_tpu_torch/utils/profiling.py) against
hupr_tpu's, and scripts/profile_train.py on the CPU at numFilters 2."""

import json
import os
import re
import time

import pytest
import torch

from hupr_tpu.utils import profiling as jax_profiling
from hupr_tpu_torch.scripts import profile_train
from hupr_tpu_torch.utils import profiling

torch.set_num_threads(2)

# the JAX script's per-op line: f"{ms:9.3f} ms  {share:5.1f}%  {name}"
LINE = re.compile(r" *\d+\.\d{3} ms  [ \d]{2}\d\.\d%  \S.*")


@pytest.mark.parametrize("durations", [[], [0.5], [0.1, 0.3, 0.2, 0.9]])
def test_step_timer_equals_jax(monkeypatch, durations):
    """Both timers read the same clock (time.perf_counter, patched to a
    script of instants): the same summary."""
    def summary(timer_cls):
        instants = iter([t for d in durations for t in (10.0, 10.0 + d)])
        monkeypatch.setattr(time, "perf_counter", lambda: next(instants))
        timer = timer_cls()
        for _ in durations:
            with timer.step():
                pass
        return timer.summary()

    want = summary(jax_profiling.StepTimer)
    got = summary(profiling.StepTimer)
    assert got == want
    assert bool(got) == bool(durations)


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("hupr_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "hupr_region" in names and "aten::mm" in names


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::f32::attention_fwd_tf32<64>(float const*,"
     " float const*, float*, int)", "f32::attention_fwd_tf32"),
    ("void attention_bwd_dq_tc<64, __nv_bfloat16, true>(int)",
     "attention_bwd_dq_tc"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, float*)",
     "at::native::vectorized_elementwise_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_ndhwckrsc_nhwc",
     "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_ndhwckrsc_nhwc"),
    ("aten::convolution_backward", "aten::convolution_backward"),
])
def test_kernel_names_group_their_instances(name, want):
    assert profile_train.kernel_name(name) == want


@pytest.mark.parametrize("env", [{}, {"PROF_DTYPE": "bfloat16",
                                      "PROF_REMAT": "1"}],
                         ids=["f32", "bf16_remat"])
def test_profile_train_on_cpu_prints_total_and_per_op_lines(
        monkeypatch, capsys, env):
    """A train step at numFilters 2 and batch 2 on the CPU: the JAX
    script's total line and per-op lines (at most 25, the longest first,
    summing to at most the total), the attention ops among them, and no
    kernel launched."""
    monkeypatch.setenv("PROF_BATCH", "2")
    monkeypatch.delenv("MODE", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    out = profile_train.main(["--device", "cpu", "--filters", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("USDT")]
    total = re.fullmatch(r"total attributed compute: (\d+\.\d\d) ms",
                         lines[0])
    assert total and float(total.group(1)) == pytest.approx(
        out["total_ms"], abs=0.01) and out["total_ms"] > 0
    per_op = lines[1:-1]
    assert 0 < len(per_op) <= profile_train.TOP
    assert all(LINE.fullmatch(ln) for ln in per_op), per_op
    ms = [float(ln.split()[0]) for ln in per_op]
    assert ms == sorted(ms, reverse=True)
    assert sum(ms) <= out["total_ms"] + 0.01 * len(ms)
    names = {ln.split("%  ", 1)[1] for ln in per_op}
    assert {"hupr_tpu_torch::attention_fwd_lse",
            "hupr_tpu_torch::attention_bwd"} <= set(out["per_op_ms"])
    assert names <= set(out["per_op_ms"])
    assert lines[-1] == ("attention launches: "
                         '{"attention_fwd": {}, "attention_bwd": {}}')
