"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (run_cell, past the look for a card) at
a tiny size on the CPU with one fault planted in the program, and holds it
to the cell's own limits: a step that returns its state unchanged, half of
the batch left out with the mean over the rest, an answer altered where it
is produced. The sound run beside them comes out correct. The control,
the reference one notch below the configuration's precision, reads higher
than the program at the same size."""

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.run import run_cell


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def run(bench, tiny, name, seed=2 ** 31 + 11):
    cell, config, traffic = tiny(name)
    return run_cell(bench, cell, seed, 0.5, False, device="cpu",
                    config=config, traffic=traffic)


@pytest.mark.parametrize("name", ["serve_f32.req32", "train_bf16.b20",
                                  "stream_bf16.live", "train_f32.dp4"])
def test_sound_run_is_correct(bench, tiny, name):
    result = run(bench, tiny, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_altered_answer_in_serving(bench, tiny, monkeypatch):
    import hupr_tpu_torch.engine.pipeline as pipeline

    real = pipeline.make_e2e_infer

    def broken(*args, **kwargs):
        run_ = real(*args, **kwargs)
        return lambda *planes: harness.alter(*run_(*planes))

    monkeypatch.setattr(pipeline, "make_e2e_infer", broken)
    assert not run(bench, tiny, "serve_f32.req32")["correct"]


def test_altered_answer_in_streaming(bench, tiny, monkeypatch):
    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator

    real = StreamingPoseEstimator.process_frame

    def broken(self, *args, **kwargs):
        pred2d, maxvals = (torch.from_numpy(np.array(a)) for a in
                           real(self, *args, **kwargs))
        pred2d, maxvals = harness.alter(pred2d[None], maxvals[None])
        return pred2d[0].numpy(), maxvals[0].numpy()

    monkeypatch.setattr(StreamingPoseEstimator, "process_frame", broken)
    assert not run(bench, tiny, "stream_bf16.live")["correct"]


SET_UP_CHECKS = ("loss_gap", "grad_gap", "change_gap", "grad_diff_gap")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "unchanged_in_window"])
def test_broken_train_step(bench, tiny, monkeypatch, fault):
    """`unchanged_in_window` steps soundly through the set-up and leaves
    its state unchanged from the window's first step on: only the window's
    numbers can see it."""
    import hupr_tpu_torch.engine.steps as steps

    cell, config, traffic = tiny("train_bf16.b20")
    set_up = traffic["check_steps"] + traffic["warmup_steps"]
    real = steps.make_train_step

    def broken(model, tx, *args, **kwargs):
        step = real(model, tx, *args, **kwargs)
        calls = []

        def train_step(state, batch, lr, alpha):
            calls.append(1)
            if fault == "half_batch":
                half = batch["hori"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()},
                            lr, alpha)
            if fault == "unchanged_in_window" and len(calls) <= set_up:
                return step(state, batch, lr, alpha)
            saved = [p.detach().clone() for p in model.parameters()]
            state, metrics = step(state, batch, lr, alpha)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            tx.state.clear()
            return state, metrics

        return train_step

    monkeypatch.setattr(steps, "make_train_step", broken)
    result = run_cell(bench, cell, 2 ** 31 + 11, 0.5, False, device="cpu",
                      config=config, traffic=traffic)
    assert not result["correct"], result["checks"]
    if fault == "unchanged_in_window":
        checks = result["checks"]
        assert all(checks[k]["value"] <= checks[k]["limit"]
                   for k in SET_UP_CHECKS), checks


@pytest.mark.parametrize("name", ["serve_f32.req32", "train_bf16.b20",
                                  "stream_bf16.live"])
def test_control_reads_above_the_program(bench, tiny, name):
    cell, config, traffic = tiny(name)
    module = bench.traffic_module(traffic["kind"])
    sound = run(bench, tiny, name, seed=5)["checks"]
    control = module.control(config, traffic, 5, "cpu")
    assert any(control[k] > 3 * sound[k]["value"] for k in control), \
        (control, sound)


UNREDUCED = """
import sys
sys.path.insert(0, {root!r})
import hupr_tpu_torch.engine.steps as steps
steps._reduce_gradients = lambda model, metrics: list(metrics)
from gpubench.traffic import train_dp
sys.exit(train_dp.rank_main(sys.argv[1:]))
"""


def test_exchange_left_out_in_data_parallel(bench, tiny, monkeypatch):
    """Four gloo ranks on the CPU, every rank's gradient sum left out."""
    import sys

    import hupr_tpu_torch.engine.steps as steps
    from conftest import ROOT
    from gpubench.traffic import train_dp

    cell, config, traffic = tiny("train_f32.dp4")
    monkeypatch.setattr(steps, "_reduce_gradients",
                        lambda model, metrics: list(metrics))
    monkeypatch.setattr(train_dp, "RANK_COMMAND", [
        sys.executable, "-c", UNREDUCED.format(root=str(ROOT))])
    result = run_cell(bench, cell, 2 ** 31 + 3, 0.5, False, device="cpu",
                      config=config, traffic=traffic)
    assert not result["correct"], result["checks"]
