"""The port's spans and counters (hupr_tpu_torch/utils/profiling.py) on the
CPU: nothing recorded while no profiler records, the spans of a served
request, a streamed frame and a train step nested as the program opens
them, the bytes copied in counted exactly, self times, the table's clock
against the profiler's own events, the collectives of a data-parallel
step across 2 gloo ranks, the exporter, and the table under threads.

The data-parallel case runs this file as a script in each rank (the
harness of tests/test_torch_parallel.py), which imports no JAX."""

import json
import os
import statistics
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from hupr_tpu_torch.engine import pipeline, steps
from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
from hupr_tpu_torch.models.hupr import HuPRNet, build_model
from hupr_tpu_torch.ops import dsp
from hupr_tpu_torch.parallel import make_mesh, shard_batch
from hupr_tpu_torch.utils import profiling
from test_torch_parallel import (GEOMETRY, PADDED_ROWS, _load, _save,
                                 dp_batch, port_cfg, spawn, worker_main)

torch.set_num_threads(2)

# tests/test_torch_pipeline.py's reduced capture: 32x32 maps
SMALL = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
             num_group_chirp=2)
RP = dsp.RadarParams(**SMALL)
FRAMES = 8
MODEL_SPANS = ["hupr.mnet", "hupr.encoder3d", "hupr.encoder3d",
               "hupr.decoder", "hupr.prgcn"]
# a data-parallel step's collectives: the real-row count, each of the 30
# BNs' statistics in the forward and its gradient sums in the backward,
# the gradient sum
DP_COLLECTIVES = 1 + 30 + 30 + 1


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.integers(-300, 300, shape).astype(np.int16)
            for _ in range(4)]


@pytest.fixture
def serve():
    """(run, the request's four int16 planes) at numFilters 2."""
    torch.manual_seed(0)
    run = pipeline.make_e2e_infer(HuPRNet(num_filters=2, heatmap_size=32),
                                  None, RP, duration=FRAMES, device="cpu")
    return run, _planes(7, (FRAMES, RP.num_rx, RP.num_chirp,
                            RP.num_adc_samples))


@pytest.fixture
def train():
    """(step, state, a numpy batch of 2 rows) at numFilters 2."""
    torch.manual_seed(0)
    cfg = port_cfg()
    model = build_model(cfg, device="cpu")
    tx = steps.make_optimizer(cfg, model)
    rng = np.random.default_rng(3)
    shape = (2, 8, 8, 2, 32, 32, 8)
    batch = {"hori": rng.standard_normal(shape).astype(np.float32),
             "vert": rng.standard_normal(shape).astype(np.float32),
             "jointsGroup": rng.uniform(10, 115, (2, 14, 2))}
    return (steps.make_train_step(model, tx, -1.0, GEOMETRY),
            steps.TrainState(model, tx), batch)


def recorded(work):
    """The spans and counters `work()` records under torch.profiler, and the
    profiler."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    out = profiling.spans(), profiling.table()["counters"], prof
    profiling.reset()
    return out


def children(spans, parent):
    """Names of `parent`'s child spans, in the order they opened."""
    return [s["name"] for s in sorted(spans, key=lambda s: s["start_ns"])
            if s["parent"] == parent["id"]]


def only(spans, name):
    found = [s for s in spans if s["name"] == name]
    assert len(found) == 1, [s["name"] for s in spans]
    return found[0]


def test_no_profiler_records_nothing(monkeypatch, serve, train):
    """Without a profiler annotate hands back one shared no-op, calls no
    record_function, and count adds nothing: a served request and a train
    step leave the table empty."""
    def refused(name):
        raise AssertionError(f"record_function({name!r}) was called")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    profiling.reset()
    assert profiling.annotate("hupr.a") is profiling.annotate("hupr.b",
                                                              device=True)
    run, planes = serve
    run(*planes)
    step, state, batch = train
    step(state, batch, 1e-4, 0.0)
    profiling.count("hupr.collectives")
    assert profiling.table() == {"spans": {}, "counters": {}}


def test_served_request_spans_nest_and_count_bytes(serve):
    run, planes = serve
    run(*planes)
    spans, counters, _ = recorded(lambda: run(*planes))
    request = only(spans, "hupr.serve.request")
    assert request["parent"] is None
    assert children(spans, request) == ["hupr.serve.h2d", "hupr.dsp"] \
        + MODEL_SPANS + ["hupr.decode"]
    assert {s["root"] for s in spans} == {request["id"]}
    assert all(s["device_s"] is None for s in spans)       # no card
    assert counters == {"hupr.h2d_bytes": sum(p.nbytes for p in planes)}
    assert counters["hupr.h2d_bytes"] == 4 * FRAMES * 4 * 48 * 128 * 2


def test_streamed_frame_spans_nest_and_count_bytes():
    """The eager step (the CPU's) of a frame after the first."""
    torch.manual_seed(0)
    est = StreamingPoseEstimator(HuPRNet(num_filters=2, heatmap_size=32),
                                 params=RP, device="cpu")
    hr, hi, vr, vi = _planes(5, (RP.num_rx, RP.num_chirp,
                                 RP.num_adc_samples))
    est.process_frame((hr, hi), (vr, vi))
    spans, counters, _ = recorded(
        lambda: est.process_frame((hr, hi), (vr, vi)))
    frame = only(spans, "hupr.stream.frame")
    assert children(spans, frame) == ["hupr.stream.h2d"] + MODEL_SPANS \
        + ["hupr.stream.fetch"]
    assert {s["root"] for s in spans} == {frame["id"]}
    assert counters == {"hupr.h2d_bytes": 4 * hr.nbytes}


def test_train_step_spans_nest_and_count_bytes(train):
    step, state, batch = train
    spans, counters, _ = recorded(lambda: step(state, batch, 1e-4, 0.0))
    top = only(spans, "hupr.train.step")
    assert children(spans, top) == ["hupr.train.inputs", "hupr.train.forward",
                                    "hupr.train.backward",
                                    "hupr.train.optimizer"]
    assert children(spans, only(spans, "hupr.train.forward")) == MODEL_SPANS
    assert {s["root"] for s in spans} == {top["id"]}
    assert counters == {"hupr.h2d_bytes": sum(v.nbytes
                                              for v in batch.values())}


def test_self_time_is_duration_less_children_cover():
    """A hand-built nest: a (0-100 ns) holds b (10-30, holding e 12-20) and
    c (20-50), which overlap, and d (90-120), which outlives it."""
    profiling.reset()
    rows = [["a", 0, 100, 1, None, 1], ["b", 10, 30, 2, 1, 1],
            ["e", 12, 20, 5, 2, 1], ["c", 20, 50, 3, 1, 1],
            ["d", 90, 120, 4, 1, 1], ["a", 200, 300, 6, None, 6]]
    profiling._SPANS.extend(row + [None] for row in rows)
    spans = profiling.table()["spans"]
    profiling.reset()
    ns = 1e-9
    assert spans["a"] == pytest.approx(
        {"count": 2, "host_s": 200 * ns,
         "self_host_s": (100 - 40 - 10 + 100) * ns})
    assert spans["b"]["self_host_s"] == pytest.approx(12 * ns)
    assert spans["c"]["self_host_s"] == pytest.approx(30 * ns)
    assert spans["d"]["self_host_s"] == pytest.approx(30 * ns)
    assert all("device_s" not in s for s in spans.values())


def test_table_starts_match_the_profilers_events(serve):
    """Each span's start, less one constant (the profiler counts from its
    trace's start), is the start of the profiler's own event of that name
    within 0.1 ms. Three requests: a span's gap is the least of its three,
    since the scheduler may take the core between two stamps of one span,
    where a clock of its own would put every request off."""
    run, planes = serve
    recorded(lambda: run(*planes))          # record_function warmed up
    spans, _, prof = recorded(lambda: [run(*planes) for _ in range(3)])
    assert len(spans) == 3 * 9
    theirs = {}
    for e in prof.events():
        if e.name.startswith("hupr."):
            theirs.setdefault(e.name, []).append(e.time_range.start)
    gaps = {}
    for name, starts in theirs.items():
        ours = sorted(s["start_ns"] / 1e3 for s in spans
                      if s["name"] == name)
        assert len(ours) == len(starts) and len(ours) % 3 == 0, name
        per_request = len(ours) // 3
        for i, (o, t) in enumerate(zip(ours, sorted(starts))):
            gaps.setdefault((name, i % per_request), []).append(o - t)
    assert len(gaps) == 9
    offset = statistics.median(g for three in gaps.values() for g in three)
    assert max(min(abs(g - offset) for g in three)
               for three in gaps.values()) < 100.0


def job_collectives(tmp: Path, rank: int, world: int) -> None:
    """One data-parallel step (after a first one) under the profiler: the
    counter, and the collectives torch.distributed was actually asked
    for."""
    mesh = make_mesh("cpu")
    torch.manual_seed(0)
    model = build_model(port_cfg(), device="cpu")
    tx = steps.make_optimizer(port_cfg(), model)
    step = steps.make_train_step(model, tx, -1.0, GEOMETRY, mesh=mesh)
    state = steps.TrainState(model, tx)
    batch, _ = shard_batch(dp_batch(0), mesh, pad_to=PADDED_ROWS)
    step(state, batch, 1e-4, 0.0)
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast"):
        def called(*args, _real=getattr(dist, name), **kwargs):
            calls.append(1)
            return _real(*args, **kwargs)
        setattr(dist, name, called)
    spans, counters, _ = recorded(lambda: step(state, batch, 1e-4, 0.0))
    _save(tmp, "collectives", rank, {
        "counters": counters, "calls": len(calls),
        "steps": children(spans, only(spans, "hupr.train.step"))})


def test_data_parallel_step_counts_its_collectives(tmp_path):
    """2 gloo ranks: 62 collectives a step on each, every call counted."""
    spawn(__file__, "collectives", tmp_path)
    for run in _load(tmp_path, "collectives"):
        assert run["counters"]["hupr.collectives"] == DP_COLLECTIVES
        assert run["calls"] == DP_COLLECTIVES
        assert run["steps"] == ["hupr.train.inputs", "hupr.train.forward",
                                "hupr.train.backward", "hupr.train.grad_sum",
                                "hupr.train.optimizer"]


def test_trace_writes_the_span_table_beside_the_chrome_trace(tmp_path,
                                                              serve):
    run, planes = serve
    with profiling.trace(str(tmp_path)):
        run(*planes)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2
    stems = [f.split("_", 1) for f in files]
    assert [s[0] for s in stems] == ["spans", "trace"]
    assert stems[0][1] == stems[1][1]
    with open(tmp_path / files[0]) as f:
        written = json.load(f)
    assert written["table"]["spans"]["hupr.serve.request"]["count"] == 1
    assert written["table"]["counters"]["hupr.h2d_bytes"] == sum(
        p.nbytes for p in planes)
    assert len(written["spans"]) == 9
    with open(tmp_path / files[1]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"hupr.serve.request", "hupr.encoder3d"} <= names
    profiling.reset()


def test_table_holds_every_span_and_count_of_many_threads():
    """16 threads, each nesting spans and counting, with the interpreter
    switching every microsecond: no span or count is lost, and every span
    keeps its own thread's parent."""
    threads, rounds = 16, 200
    errors = []

    def work():
        try:
            for _ in range(rounds):
                with profiling.annotate("hupr.outer"):
                    with profiling.annotate("hupr.inner"):
                        profiling.count("hupr.n")
                    profiling.count("hupr.n", 2)
        except Exception as e:          # noqa: BLE001 - failed in a thread
            errors.append(e)

    interval = sys.getswitchinterval()
    profiling.reset()
    try:
        sys.setswitchinterval(1e-6)
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    spans = profiling.spans()
    table = profiling.table()
    profiling.reset()
    assert table["counters"] == {"hupr.n": 3 * threads * rounds}
    assert {k: v["count"] for k, v in table["spans"].items()} == {
        "hupr.outer": threads * rounds, "hupr.inner": threads * rounds}
    outer = {s["id"]: s for s in spans if s["name"] == "hupr.outer"}
    for s in spans:
        if s["name"] == "hupr.inner":
            parent = outer[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= parent["end_ns"]
            assert s["root"] == parent["id"]


JOBS = {"collectives": job_collectives}

if __name__ == "__main__":
    worker_main(JOBS)
