"""The port's graft entry points (hupr_tpu_torch/graft_entry.py) against
__graft_entry__.py on the CPU:

  * _example_inputs equals the JAX entry's, bit for bit;
  * entry(device="cpu") on the JAX entry's weights matches JAX's entry()
    forward at tests/test_reference_parity.py's 1e-4 on both outputs, with
    enough unsaturated values that the bar bites; entry() raises with no
    card;
  * dryrun_multichip(2, device="cpu") passes every stage, none skipped:
    with n = 2 the third train batch puts rank 1 on padding only;
  * the dryrun's train stage over 2 gloo ranks, from JAX's initial weights,
    matches hupr_tpu's train step on the 2-device CPU mesh on the same
    batches (tests/test_torch_parallel.py's bars);
  * a rank that fails or hangs fails the command with its output.

The ranks of the train-stage check are worker processes running this file
as a script (tests/test_torch_parallel.py's harness), with no JAX."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from hupr_tpu_torch import graft_entry
from hupr_tpu_torch.parallel import make_mesh
from test_torch_parallel import (JAX_LOSS_ATOL, JAX_PARAM_ATOL, REPO, _load,
                                 _max_abs_vs_jax, _save, join_ranks,
                                 start_ranks, worker_main)

# tests/test_reference_parity.py's bar on the whole network's forward
ENTRY_ATOL = 1e-4
# At the JAX entry's N(0, 0.05) weights the PRGCN sigmoid saturates: on an
# x86 CPU 44.9 % of the GCN heatmap's values lie in (1e-3, 1 - 1e-3) and
# all of the main heatmap's, where the two sides differ by at most 4.5e-5
# and 4.2e-6
UNSATURATED = (1e-3, 1 - 1e-3)
MIN_UNSATURATED = {"heatmap": 0.99, "gcn_heatmap": 0.3}
STAGES = ("mesh ready", "model init done", "3 DP train steps OK",
          "sharded eval step OK", "checkpoint save/load/resume OK",
          "sharded e2e serving OK", "sharded sequence eval OK",
          "sharded chunk-train step OK", "sharded ADC chunk-train step OK",
          "sharded ADC sequence eval OK", "flagship shape pass OK",
          "dryrun_multichip(2) PASSED")


@pytest.fixture
def two_threads():
    """The entry's forward on 2 threads, restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_example_inputs_equal_jax():
    import __graft_entry__ as jax_entry

    for got, want in zip(graft_entry._example_inputs(),
                         jax_entry._example_inputs()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_entry_matches_jax_entry(two_threads):
    """The flagship forward (numFilters 32, 64x64, batch 2) through the
    port's pallas attention on the CPU (its plain twin), on the weights
    JAX's entry() draws, against JAX's entry() forward."""
    import jax

    import __graft_entry__ as jax_entry
    from hupr_tpu.models import HuPRNet
    from hupr_tpu.utils.synthetic import synthetic_variables
    from hupr_tpu_torch.models.convert import state_dict_from_jax

    jax_forward, jax_args = jax_entry.entry()
    want = [np.asarray(x) for x in jax.jit(jax_forward)(*jax_args)]
    variables = jax.tree_util.tree_map(np.asarray, synthetic_variables(
        HuPRNet(num_filters=32), (1, 8, 8, 2, 64, 64, 8)))
    forward, args = graft_entry.entry(
        device="cpu", state_dict=state_dict_from_jax(variables))
    for got, jarg in zip(args, jax_args):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jarg))
    got = [x.numpy() for x in forward(*args)]
    for name, g, w in zip(MIN_UNSATURATED, got, want):
        assert g.shape == w.shape, name
        lo, hi = UNSATURATED
        live = (w > lo) & (w < hi)
        assert live.mean() >= MIN_UNSATURATED[name], (name, live.mean())
        err = np.abs(g - w)
        assert err.max() <= ENTRY_ATOL, (name, err.max())
        assert err[live].max() <= ENTRY_ATOL, (name, err[live].max())


def test_entry_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_two_cpu_ranks(capsys):
    """Every stage over 2 gloo ranks, none skipped, each announced in
    order by a stage line; the ranks' losses agree; nothing launched."""
    result = graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert result["skipped"] == [] and "SKIPPED" not in out, out
    lines = [line for line in out.splitlines()
             if line.startswith("[dryrun +")]
    at = [next(i for i, line in enumerate(lines) if stage in line)
          for stage in STAGES]
    assert at == sorted(at), lines
    r0, r1 = result["ranks"]
    assert r0["losses"] == r1["losses"]
    assert set(r0["losses"]) == {"train", "eval", "resume", "seq_eval",
                                 "chunk", "adc_chunk", "adc_seq_eval"}
    assert all(np.isfinite(v) for losses in r0["losses"].values()
               for v in np.atleast_1d(losses))
    assert r0["launches"] == {"attention_fwd": {}, "attention_bwd": {}}


def test_main_runs_the_configured_dryrun(monkeypatch):
    calls = []
    monkeypatch.setattr(graft_entry, "dryrun_multichip",
                        lambda n, device=None: calls.append((n, device)))
    monkeypatch.setenv("HUPR_DRYRUN_N", "3")
    assert graft_entry.main(["--cpu"]) == 0
    monkeypatch.delenv("HUPR_DRYRUN_N")
    assert graft_entry.main([]) == 0
    assert calls == [(3, "cpu"), (8, None)]


def _sleeper(seconds: float, code: int = 0, say: str = "") -> list:
    return [sys.executable, "-c",
            f"import sys, time; print({say!r}, flush=True); "
            f"time.sleep({seconds}); sys.exit({code})"]


def _started(cmds) -> tuple:
    import collections
    import threading

    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    tails = [collections.deque() for _ in procs]
    threads = [threading.Thread(target=lambda p=p, t=t: t.extend(p.stdout))
               for p, t in zip(procs, tails)]
    for t in threads:
        t.start()
    return procs, tails, threads


@pytest.mark.parametrize("case", ["rank_fails", "rank_hangs"])
def test_failed_or_hung_rank_fails_the_command(case):
    """A rank that exits non-zero fails the wait at once, and one that
    outlives the deadline fails it then; every rank is stopped and the
    error carries each rank's output."""
    if case == "rank_fails":
        cmds = [_sleeper(0.2, 3, "rank zero broke"), _sleeper(60)]
        deadline = time.monotonic() + 60
    else:
        cmds = [_sleeper(60), _sleeper(0)]
        deadline = time.monotonic() + 5
    procs, tails, threads = _started(cmds)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        graft_entry._join_ranks(procs, tails, threads, deadline)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)
    assert "---- rank 0" in str(err.value) and "---- rank 1" in str(err.value)
    if case == "rank_fails":
        assert "rank(s) [0] exited" in str(err.value)
        assert "rank zero broke" in str(err.value)
    else:
        assert "did not finish in time" in str(err.value)


def test_import_starts_no_process():
    """Importing the module starts no process and joins no group."""
    code = ("import subprocess, torch.distributed as dist\n"
            "def refuse(*a, **k): raise AssertionError('started')\n"
            "subprocess.Popen = refuse\n"
            "dist.init_process_group = refuse\n"
            "import hupr_tpu_torch.graft_entry as g\n"
            "print('IMPORTED', g.PROGRAMS[0], dist.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert "IMPORTED train False" in out.stdout, out.stdout


# ------------------------------------------- the train stage against JAX

def _jax_reduced_config():
    """__graft_entry__.dryrun_multichip's reduced geometry."""
    from hupr_tpu.config import Config

    cfg = Config()
    cfg.MODEL.numFilters = 2
    d = cfg.DATASET
    d.rangeSize = d.azimuthSize = 32
    d.heatmapSize = 32
    d.imgSize = 128
    return cfg


def job_train(tmp, rank: int, world: int) -> None:
    """The dryrun's train stage from tmp/init.pt on this rank."""
    torch.set_num_threads(1)
    epoch = graft_entry.MiniEpoch(make_mesh("cpu"),
                                  state_dict=torch.load(tmp / "init.pt"))
    losses = epoch.train()
    _save(tmp, "train", rank, {
        "losses": losses,
        "state": {k: v.clone()
                  for k, v in epoch.state.model.state_dict().items()}})


JOBS = {"train": job_train}


def test_dryrun_train_stage_equals_jax(tmp_path):
    """Three steps over 2 ranks (batches 2, 2 and 1 padded to 2) from
    JAX's init_state(PRNGKey(0)) against hupr_tpu's make_train_step on 2
    devices of the CPU mesh, the batches drawn as the JAX dryrun draws
    them: losses within 1e-5, weights and BN statistics within 2e-4; the
    ranks agree bit for bit."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from hupr_tpu.engine.steps import (init_state, make_optimizer,
                                       make_train_step)
    from hupr_tpu.models import build_model
    from hupr_tpu.parallel import replicate_state, shard_batch
    from hupr_tpu_torch.models.convert import state_dict_from_jax

    cfg = _jax_reduced_config()
    model = build_model(cfg)
    state = init_state(model, cfg, jax.random.PRNGKey(0))
    torch.save(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})),
               tmp_path / "init.pt")
    ranks = start_ranks(__file__, "train", tmp_path)

    d = cfg.DATASET
    port_cfg = graft_entry.dryrun_config(False)
    fields = ("numGroupFrames", "numFrames", "rangeSize", "azimuthSize",
              "elevationSize", "heatmapSize", "imgSize", "duration")
    assert port_cfg.MODEL.numFilters == cfg.MODEL.numFilters
    assert [getattr(port_cfg.DATASET, f) for f in fields] == \
        [getattr(d, f) for f in fields]
    spatial = (d.numGroupFrames, d.numFrames, 2, d.rangeSize, d.azimuthSize,
               d.elevationSize)
    rng = np.random.default_rng(0)

    def make_batch(b):          # __graft_entry__.py's draws, in its order
        return {
            "hori": rng.standard_normal((b,) + spatial).astype(np.float32),
            "vert": rng.standard_normal((b,) + spatial).astype(np.float32),
            "jointsGroup": rng.uniform(10, d.imgSize - 10, (b, 14, 2)),
        }

    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("data",))
    state = replicate_state(state, mesh)
    step = make_train_step(model, make_optimizer(cfg),
                           geometry=(d.numKeypoints, d.heatmapSize,
                                     d.imgSize))
    losses = []
    for b in (2, 2, 1):
        sharded, _ = shard_batch(make_batch(b), mesh, pad_to=2)
        state, metrics = step(state, sharded, 1e-4, 0.0)
        losses.append(float(metrics["loss"]))

    join_ranks(ranks, "train")
    r0, r1 = _load(tmp_path, "train")
    assert r0["losses"] == r1["losses"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    np.testing.assert_allclose(r0["losses"], losses, rtol=0,
                               atol=JAX_LOSS_ATOL)
    err = _max_abs_vs_jax(r0["state"], state.params, state.batch_stats)
    assert max(err.values()) <= JAX_PARAM_ATOL, err


if __name__ == "__main__":
    worker_main(JOBS)
