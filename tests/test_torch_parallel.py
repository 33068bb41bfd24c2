"""The port's data parallelism (hupr_tpu_torch.parallel) against hupr_tpu's
on the CPU: shard_batch and its padding, local_row_range and
merge_rank_results against the JAX functions; the masked synced BN across
2 gloo ranks against native BN over the union of the real rows; the
data-parallel train step across 2 gloo ranks against the JAX package's
meshed step on 2 devices of the virtual CPU mesh and against the port's
one-process masked step, with three planted faults that must fail that
parity; the chunk step across 2 ranks likewise.

The ranks are worker processes running this file as a script, which
imports the port and no JAX: `python tests/test_torch_parallel.py <job>
<tmp> <rank> <world> <rendezvous file>`. The parent test, which has JAX,
computes the references and compares. Each worker joins a gloo group
through a file:// rendezvous in the test's tmp_path (no ports to race for
under xdist) and uses one thread; every wait has a timeout of its own,
and a failure shows the workers' output."""

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.engine import chunk_train, steps
from hupr_tpu_torch.models import blocks
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.parallel import (make_mesh, mesh as port_mesh,
                                     multihost, replicate_state, shard_batch)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 240        # seconds, for all the ranks of one spawn

GEOMETRY = (14, 32, 128)    # tests/test_parallel.py's reduced layout
REAL_ROWS, PADDED_ROWS, STEPS, LR = 7, 8, 4, 1e-4
# tests/test_parallel.py's bars for the meshed step against one device
JAX_LOSS_ATOL, JAX_PARAM_ATOL = 1e-5, 2e-4
# the 2-rank step against the port's one-process masked step from the same
# weights: the same float32 math summed in another order (the ranks' BN
# statistics combined, the gradients of two halves added). The correct
# step reads 8.7e-8 (losses, relative), 1.0e-7 (weights and statistics)
# and 7.0e-7 (first-step gradients, relative L2) on an x86 CPU; each
# planted fault reads 5.2e-3 to 0.5 on the gradients and also fails the
# JAX bars (weights 5.2e-4 to 8.0e-4)
ONE_LOSS_RTOL, ONE_STATE_ATOL, ONE_GRAD_REL = 1e-6, 1e-6, 1e-5
FAULTS = ("per_rank_bn", "per_rank_loss_mean", "averaged_gradients")


# ------------------------------------------------------------- workers

def start_ranks(script, job: str, tmp: Path, world: int = 2,
                env=None) -> list:
    """Start `world` ranks of `job`: python `script` job tmp rank world
    rendezvous, in `tmp`."""
    rdv = tmp / f"rendezvous-{job}-{uuid.uuid4().hex}"
    full_env = {**os.environ, **(env or {}),
                "PYTHONPATH": os.pathsep.join(
                    [REPO, os.environ.get("PYTHONPATH", "")])}
    return [subprocess.Popen(
        [sys.executable, str(script), job, str(tmp), str(rank), str(world),
         str(rdv)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=full_env, cwd=str(tmp)) for rank in range(world)]


def join_ranks(procs: list, job: str,
               timeout: float = WORKER_TIMEOUT) -> list:
    """Wait for every rank, each within what is left of `timeout`; fail
    with their output on a timeout or a non-zero exit. Returns their
    outputs."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate(timeout=30)[0][-3000:] for p in procs]
        pytest.fail(f"the ranks of {job!r} did not finish in {timeout} s:\n"
                    + "\n----\n".join(tails))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {job!r} failed:\n" \
            f"{out[-4000:]}"
    return outs


def spawn(script, job: str, tmp: Path, world: int = 2,
          timeout: float = WORKER_TIMEOUT, env=None) -> list:
    """start_ranks, then join_ranks."""
    return join_ranks(start_ranks(script, job, tmp, world, env), job,
                      timeout)


def worker_main(jobs: dict) -> None:
    """The worker's entry: join the gloo group, run jobs[job](tmp, rank,
    world), leave the group."""
    job, tmp, rank, world, rdv = sys.argv[1:6]
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=180))
    try:
        jobs[job](Path(tmp), int(rank), int(world))
    finally:
        dist.destroy_process_group()


def _save(tmp: Path, job: str, rank: int, result) -> None:
    torch.save(result, tmp / f"{job}-rank{rank}.pt")


def _load(tmp: Path, job: str, world: int = 2) -> list:
    return [torch.load(tmp / f"{job}-rank{r}.pt", weights_only=False)
            for r in range(world)]


# --------------------------------------------------- batches and configs

def port_cfg():
    return port_config.config_from_dict({
        "MODEL": {"numFilters": 2},
        "DATASET": {"rangeSize": 32, "azimuthSize": 32, "heatmapSize": 32,
                    "imgSize": 128},
        "TRAINING": {"batchSize": PADDED_ROWS}})


def dp_batch(i: int, rows: int = REAL_ROWS) -> dict:
    """Step i's batch: tests/test_parallel.py's draws at 32x32 maps."""
    rng = np.random.default_rng(100 + i)
    shape = (rows, 8, 8, 2, 32, 32, 8)
    return {"hori": rng.standard_normal(shape).astype(np.float32),
            "vert": rng.standard_normal(shape).astype(np.float32),
            "jointsGroup": rng.uniform(10, 115, (rows, 14, 2))}


def flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.detach().reshape(-1).clone()
                      for p in model.parameters()])


def run_port_steps(model, tx, mesh, batches, lr=LR) -> dict:
    """The port's train step over `batches` (whole global batches; each
    rank takes its block with shard_batch): the losses, the first step's
    gradients and the final state_dict."""
    step = steps.make_train_step(model, tx, -1.0, GEOMETRY, mesh=mesh)
    state = steps.TrainState(model, tx)
    losses, grads = [], None
    for i, batch in enumerate(batches):
        if mesh is not None:
            batch, _ = shard_batch(batch, mesh, pad_to=PADDED_ROWS)
        state, m = step(state, batch, lr, 0.0)
        losses.append([m[k].item() for k in ("loss", "loss1", "loss2")])
        if i == 0:
            grads = flat_grads(model)
    return {"losses": losses, "grads": grads,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


class _Fault:
    """A planted fault of the data-parallel step, undone on exit."""

    def __init__(self, name):
        self.name, self.saved = name, {}

    def _set(self, attr, value):
        self.saved[attr] = getattr(steps, attr)
        setattr(steps, attr, value)

    def __enter__(self):
        import contextlib

        def averaged(model, metrics):
            out = self.saved["_reduce_gradients"](model, metrics)
            for p in model.parameters():
                p.grad.div_(dist.get_world_size())
            return out

        if self.name == "per_rank_bn":
            # native BN on each rank's block, as under plain DDP
            self._set("synced_batch_stats",
                      lambda mask: contextlib.nullcontext())
        elif self.name == "per_rank_loss_mean":
            # each rank's loss the mean of its own real rows, and the
            # gradients averaged over the ranks
            self._set("_global_count",
                      lambda mask: mask.to(torch.float32).sum())
            self._set("_reduce_gradients", averaged)
        elif self.name == "averaged_gradients":
            self._set("_reduce_gradients", averaged)
        return self

    def __exit__(self, *exc):
        for attr, value in self.saved.items():
            setattr(steps, attr, value)


def job_step(tmp: Path, rank: int, world: int) -> None:
    """The 2-rank data-parallel step from the weights in tmp/init.pt over
    STEPS batches, correct and with each planted fault. Rank 1 first
    scrambles its replica: replicate_state must make it rank 0's."""
    mesh = make_mesh("cpu")
    init = torch.load(tmp / "init.pt")
    batches = [dp_batch(i) for i in range(STEPS)]
    out = {}
    for variant in ("ok",) + FAULTS:
        model = build_model(port_cfg(), device="cpu")
        model.load_state_dict(init)
        tx = steps.make_optimizer(port_cfg(), model)
        if rank == 1:
            with torch.no_grad():
                for t in port_mesh.state_tensors(model, tx):
                    t.add_(1)
        replicate_state(steps.TrainState(model, tx), mesh)
        if variant == "ok":
            out["replicated"] = all(
                torch.equal(v, init[k]) for k, v in model.state_dict().items())
            out["ok"] = run_port_steps(model, tx, mesh, batches)
        else:
            with _Fault(variant):
                out[variant] = run_port_steps(model, tx, mesh, batches)
    _save(tmp, "step", rank, out)


BN_C = 4
BN_CASES = {   # global mask of 8 rows (rank 0 holds rows 0-3), dtype, remat
    "uneven": ([1, 1, 1, 1, 1, 1, 0, 0], torch.float32, False),
    "rank_all_padding": ([1, 1, 1, 0, 0, 0, 0, 0], torch.float32, False),
    "recompute": ([1, 1, 1, 1, 1, 1, 0, 0], torch.float32, True),
    "bf16": ([1, 1, 1, 1, 1, 1, 0, 0], torch.bfloat16, False),
}


def bn_inputs(case: str):
    """(x (8, C, 3, 5, 5), mask, upstream gradient, weight, bias, running
    mean, running var), numpy, from a seed per case."""
    rng = np.random.default_rng(len(case))
    x = (rng.standard_normal((8, BN_C, 3, 5, 5)) * 2 + 3).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    params = [rng.uniform(0.5, 1.5, BN_C), rng.standard_normal(BN_C) * 0.1,
              rng.standard_normal(BN_C) * 0.1, rng.uniform(0.5, 1.5, BN_C)]
    mask = np.asarray(BN_CASES[case][0], np.float32)
    return (x, mask, g) + tuple(p.astype(np.float32) for p in params)


def make_bn(weight, bias, mean, var):
    bn = blocks.BatchNorm3d(BN_C)
    with torch.no_grad():
        for t, v in ((bn.weight, weight), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    return bn.train()


def job_bn(tmp: Path, rank: int, world: int) -> None:
    """Each case of BN_CASES on this rank's 4 rows: the output, the input
    and affine gradients of sum(y * g * mask), the buffers after, and the
    number of all_reduce calls (one forward, one backward)."""
    from torch.utils.checkpoint import checkpoint

    from hupr_tpu_torch.models.hupr import _recompute_context

    calls = []
    real_all_reduce = blocks.dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return real_all_reduce(*args, **kwargs)

    blocks.dist.all_reduce = counted
    out = {}
    for case, (_, dtype, remat) in BN_CASES.items():
        x, mask, g, *params = bn_inputs(case)
        bn = make_bn(*params)
        lo, hi = rank * 4, rank * 4 + 4
        xl = torch.from_numpy(x[lo:hi]).to(dtype).requires_grad_(True)
        ml = torch.from_numpy(mask[lo:hi])
        calls.clear()
        with blocks.synced_batch_stats(ml):
            if remat:
                y = checkpoint(bn, xl, use_reentrant=False,
                               context_fn=_recompute_context)
            else:
                y = bn(xl)
        w = ml.reshape(-1, 1, 1, 1, 1)
        (y.float() * torch.from_numpy(g[lo:hi]) * w).sum().backward()
        out[case] = {"y": y.detach().float(), "dx": xl.grad.float(),
                     "dw": bn.weight.grad, "db": bn.bias.grad,
                     "mean": bn.running_mean.clone(),
                     "var": bn.running_var.clone(),
                     "tracked": int(bn.num_batches_tracked),
                     "dtype": str(y.dtype), "all_reduces": len(calls)}
    _save(tmp, "bn", rank, out)


CHUNK_BATCH = 5     # 8 windows: chunks of 5 and 3, padded to 6 rows


def job_chunk(tmp: Path, rank: int, world: int) -> None:
    """Two chunk steps (the chunk of 5, then the padded one of 3) from
    tmp/init.pt across the ranks, each loading its block of both padded
    axes (pad_multiple=world, process=(rank, world))."""
    from hupr_tpu_torch.data import get_dataset

    mesh = make_mesh("cpu")
    cfg = port_config.config_from_dict(
        json.loads((tmp / "cfg.json").read_text()))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(tmp / "init.pt"))
    tx = steps.make_optimizer(cfg, model)
    d = cfg.DATASET
    step = chunk_train.make_chunk_train_step(
        model, tx, (d.numKeypoints, d.heatmapSize, d.imgSize), mesh=mesh)
    loader = chunk_train.ChunkTrainLoader(
        get_dataset("train", cfg), CHUNK_BATCH, shuffle=False,
        pad_multiple=world, process=(rank, world))
    state, losses = steps.TrainState(model, tx), []
    for i, chunk in enumerate(loader.chunks):
        batch, _ = chunk_train.device_put_chunk(loader._assemble(chunk),
                                                mesh=mesh)
        state, m = step(state, batch, 1e-4 * 0.999 ** i, 0.0)
        losses.append([m[k].item() for k in ("loss", "loss1", "loss2")])
    _save(tmp, "chunk", rank, {
        "losses": losses, "rows": int(batch["rel"].shape[0]),
        "frames": int(batch["hori"].shape[0]),
        "state": {k: v.clone() for k, v in model.state_dict().items()}})


JOBS = {"step": job_step, "bn": job_bn, "chunk": job_chunk}


# ------------------------------------------------------------ helpers

def _jax_tree(state_dict):
    from hupr_tpu.models.torch_convert import convert_state_dict
    return convert_state_dict({k: v.detach().clone()
                               for k, v in state_dict.items()})


def _max_abs_vs_jax(state_dict, params, batch_stats) -> dict:
    """The largest absolute difference of the port's weights and of its
    BN statistics from a JAX tree's."""
    import jax

    got = _jax_tree(state_dict)
    out = {}
    for tree, want in (("params", params), ("batch_stats", batch_stats)):
        leaves = jax.tree_util.tree_leaves_with_path(got[tree])
        ref = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(leaves) == len(ref)
        out[tree] = max(float(np.abs(np.asarray(v)
                                     - np.asarray(ref[p])).max())
                        for p, v in leaves)
    return out


def parity_readings(run: dict, one: dict, jax_ref: dict) -> dict:
    """A 2-rank run's distances from the port's one-process masked step
    and from the JAX package's meshed step, and whether each is within
    its bar."""
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0])
                   for a, b in zip(run["losses"], one["losses"]))
    state_err = max((run["state"][k].double() - v.double()).abs().max()
                    .item() for k, v in one["state"].items()
                    if v.is_floating_point())
    grad_rel = ((run["grads"] - one["grads"]).norm()
                / one["grads"].norm()).item()
    jax_loss = max(abs(a[0] - b) for a, b in zip(run["losses"],
                                                 jax_ref["losses"]))
    jax_err = _max_abs_vs_jax(run["state"], jax_ref["params"],
                              jax_ref["batch_stats"])
    r = {"one_loss_rel": loss_rel, "one_state_abs": state_err,
         "one_grad_rel": grad_rel, "jax_loss_abs": jax_loss,
         "jax_param_abs": jax_err["params"],
         "jax_stats_abs": jax_err["batch_stats"]}
    r["within"] = (loss_rel <= ONE_LOSS_RTOL
                   and state_err <= ONE_STATE_ATOL
                   and grad_rel <= ONE_GRAD_REL
                   and jax_loss <= JAX_LOSS_ATOL
                   and jax_err["params"] <= JAX_PARAM_ATOL
                   and jax_err["batch_stats"] <= JAX_PARAM_ATOL)
    return r


# ------------------------------------------------- host-side functions

def _jax_mesh():
    import jax

    from hupr_tpu.parallel import make_mesh as jax_make_mesh
    return jax_make_mesh(jax.devices()[:2])


@pytest.mark.parametrize("rows,pad_to", [(5, None), (7, 8), (8, None),
                                         (3, 8), (1, None)])
def test_shard_batch_equals_jax(rows, pad_to):
    """Each rank's block of the port's padded batch, concatenated in rank
    order, is the JAX package's sharded global batch: the padding repeats
    the last sample, the mask marks the real rows, pad_to is honoured."""
    from hupr_tpu.parallel import shard_batch as jax_shard_batch
    from hupr_tpu.parallel.mesh import _pad_batch_axis as jax_pad

    rng = np.random.default_rng(rows)
    batch = {"hori": rng.standard_normal((rows, 3, 2)).astype(np.float32),
             "jointsGroup": rng.uniform(0, 9, (rows, 14, 2))}
    want, want_b = jax_shard_batch(batch, _jax_mesh(), pad_to)
    blocks_ = [shard_batch(batch, port_mesh.Mesh(r, 2, torch.device("cpu")),
                           pad_to) for r in range(2)]
    assert {b for _, b in blocks_} == {want_b} == {rows}
    for key in ("hori", "jointsGroup", "mask"):
        got = np.concatenate([blk[key].numpy() for blk, _ in blocks_])
        want_key = np.asarray(want[key])      # JAX holds float64 as float32
        np.testing.assert_array_equal(got.astype(want_key.dtype), want_key)
    for key in ("hori", "jointsGroup"):
        for target in (rows, rows + 3):
            np.testing.assert_array_equal(
                port_mesh._pad_batch_axis(batch[key], target),
                jax_pad(batch[key], target))
            np.testing.assert_array_equal(
                port_mesh._pad_batch_axis(torch.from_numpy(batch[key]),
                                          target).numpy(),
                jax_pad(batch[key], target))


@pytest.mark.parametrize("padded,world", [(8, 2), (20, 4), (6, 3), (4, 1)])
def test_local_row_range_equals_jax(monkeypatch, padded, world):
    from hupr_tpu.parallel import multihost as jax_multihost

    for pid in range(world):
        for mod in (multihost, jax_multihost):
            monkeypatch.setattr(mod, "process_count", lambda w=world: w)
            monkeypatch.setattr(mod, "process_index", lambda p=pid: p)
        assert multihost.local_row_range(padded) == \
            jax_multihost.local_row_range(padded)
        lo, hi = multihost.local_row_range(padded)
        np.testing.assert_array_equal(multihost.local_row_mask(padded, 5),
                                      (np.arange(lo, hi) < 5))


def test_merge_rank_results_equals_jax(tmp_path, monkeypatch):
    """Three ranks' files (shares interleaved by sequence) merge into the
    same JSON, image ids sorted, and the rank files go."""
    from hupr_tpu.parallel import multihost as jax_multihost

    rng = np.random.default_rng(0)
    shares = [[{"image_id": int(i), "score": float(rng.uniform())}
               for i in ids] for ids in ([100003, 200001], [100001],
                                         [300000, 100002])]
    merged = {}
    for name, mod in (("port", multihost), ("jax", jax_multihost)):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.setattr(mod, "process_count", lambda: 3)
        for pid, share in enumerate(shares):
            with open(mod.rank_result_path(str(out), "val", pid), "w") as fp:
                json.dump(share, fp)
        mod.merge_rank_results(str(out), "val", str(out / "val.json"))
        assert sorted(os.listdir(out)) == ["val.json"]
        merged[name] = (out / "val.json").read_text()
    assert merged["port"] == merged["jax"]
    ids = [b["image_id"] for b in json.loads(merged["port"])]
    assert ids == sorted(ids) and len(ids) == 5
    assert multihost.rank_result_path("d", "test", 1) == \
        jax_multihost.rank_result_path("d", "test", 1)


def test_one_process_is_a_world_of_one():
    """Without a process group the mesh is rank 0 of 1, the control plane
    answers locally, and the step built with it is the single-card step."""
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.parallel) == (0, 1, False)
    assert multihost.allgather_scalar(3.0) == [3.0]
    assert multihost.broadcast_scalar(2.0) == 2.0
    multihost.barrier("x")
    multihost.assert_agreement("x", 1.0)
    multihost.warmup_device_collectives(mesh)
    x = torch.arange(6.0).reshape(3, 2)
    assert port_mesh.gather_blocks(x, mesh) is x
    assert not steps._data_parallel(mesh) and not steps._data_parallel(None)


# ------------------------------------------------------- synced BN

@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn")
    spawn(__file__, "bn", tmp)
    return _load(tmp, "bn")


@pytest.mark.parametrize("case", list(BN_CASES))
def test_synced_bn_equals_native_bn_over_real_rows(bn_runs, case):
    """2 gloo ranks, 4 rows each, against nn.BatchNorm3d over the union of
    the real rows in one process: outputs and input gradients on the real
    rows, zero input gradient on the padded ones, the affine gradients
    summed over the ranks, and the running statistics moved once on both
    ranks; one all_reduce forward and one backward, under the recompute
    too. float32 at 1e-5; bfloat16 at its rounding (y and dx are rounded
    once to bfloat16, the statistics stay float32)."""
    x, mask, g, *params = bn_inputs(case)
    dtype = BN_CASES[case][1]
    real = mask == 1
    ref = torch.nn.BatchNorm3d(BN_C).train()
    with torch.no_grad():
        for t, v in zip((ref.weight, ref.bias, ref.running_mean,
                         ref.running_var), params):
            t.copy_(torch.from_numpy(v))
    xr = torch.from_numpy(x[real]).to(dtype).requires_grad_(True)
    y = ref(xr)
    (y.float() * torch.from_numpy(g[real])).sum().backward()

    tol = dict(rtol=0, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2e-2)
    runs = [bn_runs[r][case] for r in range(2)]
    assert all(r["dtype"] == str(dtype) for r in runs)
    got_y = torch.cat([r["y"] for r in runs])
    got_dx = torch.cat([r["dx"] for r in runs])
    torch.testing.assert_close(got_y[real], y.detach().float(), **tol)
    torch.testing.assert_close(got_dx[real], xr.grad.float(), **tol)
    assert torch.equal(got_dx[~real], torch.zeros_like(got_dx[~real]))
    sum_tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-1)
    for key, want in (("dw", ref.weight.grad), ("db", ref.bias.grad)):
        torch.testing.assert_close(runs[0][key] + runs[1][key], want,
                                   **sum_tol)
    for r in runs:
        torch.testing.assert_close(r["mean"], ref.running_mean, rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(r["var"], ref.running_var, rtol=1e-5,
                                   atol=1e-6)
        assert r["tracked"] == int(ref.num_batches_tracked) == 1
        assert r["all_reduces"] == 2


# ------------------------------------------------- the data-parallel step

@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """JAX's weights, the JAX meshed step and the port's one-process
    masked step in this process; the 2-rank step (correct and faulted)
    in the workers."""
    import jax

    from hupr_tpu.config import config_from_dict as jax_config_from_dict
    from hupr_tpu.engine import steps as jax_steps
    from hupr_tpu.models import build_model as jax_build_model
    from hupr_tpu.parallel import replicate_state as jax_replicate
    from hupr_tpu.parallel import shard_batch as jax_shard_batch
    from hupr_tpu_torch.models.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("dp_step")
    jcfg = jax_config_from_dict(dataclasses.asdict(port_cfg()))
    jmodel = jax_build_model(jcfg)
    jtx = jax_steps.make_optimizer(jcfg)
    jstate = jax_steps.init_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                  tx=jtx)
    init = state_dict_from_jax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats})
    torch.save(init, tmp / "init.pt")
    ranks = start_ranks(__file__, "step", tmp)
    batches = [dp_batch(i) for i in range(STEPS)]

    mesh = _jax_mesh()
    jstate = jax_replicate(jstate, mesh)
    jstep = jax_steps.make_train_step(jmodel, jtx, geometry=GEOMETRY)
    jax_losses = []
    for batch in batches:
        sharded, true_b = jax_shard_batch(batch, mesh, PADDED_ROWS)
        assert true_b == REAL_ROWS and sharded["hori"].shape[0] == 8
        jstate, m = jstep(jstate, sharded, LR, 0.0)
        jax_losses.append(float(m["loss"]))
    jax_ref = {"losses": jax_losses, "params": jstate.params,
               "batch_stats": jstate.batch_stats}

    model = build_model(port_cfg(), device="cpu")
    model.load_state_dict(init)
    padded = [{**{k: port_mesh._pad_batch_axis(v, PADDED_ROWS)
                  for k, v in b.items()},
               "mask": (np.arange(PADDED_ROWS) < REAL_ROWS).astype(
                   np.float32)} for b in batches]
    one = run_port_steps(model, steps.make_optimizer(port_cfg(), model),
                         None, padded)
    join_ranks(ranks, "step")
    return {"ranks": _load(tmp, "step"), "one": one, "jax": jax_ref,
            "init": init}


def test_dp_step_replicas_agree(step_runs):
    """replicate_state made rank 1's scrambled replica rank 0's, and the
    ranks report the same global losses and end with the same weights,
    bit for bit."""
    r0, r1 = (r["ok"] for r in step_runs["ranks"])
    assert step_runs["ranks"][0]["replicated"]
    assert step_runs["ranks"][1]["replicated"]
    assert r0["losses"] == r1["losses"]
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    moved = [k for k, v in r0["state"].items() if v.is_floating_point()
             and not torch.equal(v, step_runs["init"][k])]
    assert len(moved) == sum(v.is_floating_point()
                             for v in r0["state"].values())


def test_dp_step_equals_jax_meshed_step(step_runs):
    """The 2-rank step (7 real rows padded to 8, 4 per rank) over 4
    steps against hupr_tpu's step on a 2-device mesh from the same
    weights: losses within 1e-5, weights and BN running statistics within
    2e-4 (tests/test_parallel.py's bars)."""
    r = parity_readings(step_runs["ranks"][0]["ok"], step_runs["one"],
                        step_runs["jax"])
    assert r["jax_loss_abs"] <= JAX_LOSS_ATOL, r
    assert r["jax_param_abs"] <= JAX_PARAM_ATOL, r
    assert r["jax_stats_abs"] <= JAX_PARAM_ATOL, r


def test_dp_step_equals_one_process_step(step_runs):
    """Against the port's one-process masked step on the same 7 rows:
    losses within ONE_LOSS_RTOL, weights and statistics within
    ONE_STATE_ATOL, the first step's summed gradients within ONE_GRAD_REL
    (relative L2)."""
    r = parity_readings(step_runs["ranks"][0]["ok"], step_runs["one"],
                        step_runs["jax"])
    assert r["within"], r


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_parity(step_runs, fault):
    """Each planted fault falls outside the parity bars the correct step
    holds: per-rank (native) BN statistics, a per-rank loss mean averaged
    over the ranks, and gradients averaged instead of summed after the
    global-count loss."""
    r = parity_readings(step_runs["ranks"][0][fault], step_runs["one"],
                        step_runs["jax"])
    assert not r["within"], r
    # the fault reads far outside, not at the edge of a bar
    assert r["one_grad_rel"] > 100 * ONE_GRAD_REL, r


# ------------------------------------------------- the chunk step

def test_dp_chunk_step_equals_jax_and_one_process(tmp_path):
    """Two chunk steps (5 windows, then 3) across 2 ranks, each holding
    its block of the padded frame (12) and row (6) axes, against
    hupr_tpu's meshed chunk step on 2 devices and the port's one-process
    chunk step, from the same weights, at tests/test_torch_chunk.py's
    sizes: losses within 1e-5 of JAX's and 1e-6 relative of the port's,
    weights and BN statistics within 2e-4 of JAX's and 1e-6 of the
    port's; the ranks agree bit for bit."""
    from hupr_tpu.data import get_dataset as jax_get_dataset
    from hupr_tpu.engine import chunk_train as jax_chunk
    from hupr_tpu_torch.data import get_dataset
    from test_torch_chunk import _geometry, _jax_state, _port_state, \
        adc_workspace

    jcfg, cfg = adc_workspace(tmp_path)
    jmodel, jtx, jstate = _jax_state(jcfg)
    one = _port_state(cfg, jstate)
    torch.save({k: v.clone() for k, v in one.model.state_dict().items()},
               tmp_path / "init.pt")
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    spawn(__file__, "chunk", tmp_path)
    ranks = _load(tmp_path, "chunk")

    from hupr_tpu.parallel import replicate_state as jax_replicate
    mesh = _jax_mesh()
    jstate = jax_replicate(jstate, mesh)
    jstep = jax_chunk.make_chunk_train_step(jmodel, jtx, _geometry(jcfg),
                                            mesh=mesh)
    jloader = jax_chunk.ChunkTrainLoader(jax_get_dataset("train", jcfg),
                                         CHUNK_BATCH, shuffle=False,
                                         pad_multiple=2)
    step = chunk_train.make_chunk_train_step(one.model, one.optimizer,
                                             _geometry(cfg))
    loader = chunk_train.ChunkTrainLoader(get_dataset("train", cfg),
                                          CHUNK_BATCH, shuffle=False)
    jax_losses, one_losses = [], []
    for i, (jc, pc) in enumerate(zip(jloader.chunks, loader.chunks)):
        lr = 1e-4 * 0.999 ** i
        jdev, _ = jax_chunk.device_put_chunk(jloader._assemble(jc), mesh)
        jstate, jm = jstep(jstate, jdev, lr, 0.0)
        jax_losses.append(float(jm["loss"]))
        _, m = step(one, loader._assemble(pc), lr, 0.0)
        one_losses.append(m["loss"].item())
    r0, r1 = ranks
    assert (r0["rows"], r0["frames"]) == (3, 6)
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    got = [loss[0] for loss in r0["losses"]]
    np.testing.assert_allclose(got, jax_losses, rtol=0, atol=JAX_LOSS_ATOL)
    np.testing.assert_allclose(got, one_losses, rtol=ONE_LOSS_RTOL)
    err = _max_abs_vs_jax(r0["state"], jstate.params, jstate.batch_stats)
    assert max(err.values()) <= JAX_PARAM_ATOL, err
    one_sd = one.model.state_dict()
    state_err = max((v.double() - one_sd[k].double()).abs().max().item()
                    for k, v in r0["state"].items() if v.is_floating_point())
    assert state_err <= ONE_STATE_ATOL, state_err


@pytest.mark.parametrize("world", [2, 4])
def test_chunk_loaders_process_blocks_equal_jax(tmp_path, world):
    """ChunkTrainLoader and ADCChunkLoader in process mode, every rank of
    2 and 4 (at 4 the last rank's frame block of the short chunk is all
    clamp rows): each batch equals JAX's leaf for leaf, and the blocks
    tile the padded axes."""
    from hupr_tpu.data import get_dataset as jax_get_dataset
    from hupr_tpu.data.adc import ADCFrameSource as JaxADCFrameSource
    from hupr_tpu.engine import chunk_train as jax_chunk
    from hupr_tpu.ops import dsp as jax_dsp
    from hupr_tpu_torch.data import get_dataset
    from hupr_tpu_torch.data.adc import ADCFrameSource
    from test_torch_chunk import RP, TINY_ADC, adc_workspace

    jcfg, cfg = adc_workspace(tmp_path)
    ds, jds = get_dataset("train", cfg), jax_get_dataset("train", jcfg)
    src = ADCFrameSource(cfg.DATASET.adcDir, RP)
    jsrc = JaxADCFrameSource(jcfg.DATASET.adcDir,
                             jax_dsp.RadarParams(**TINY_ADC))
    for pid in range(world):
        kw = dict(shuffle=True, seed=3, pad_multiple=world,
                  process=(pid, world))
        pairs = [(chunk_train.ChunkTrainLoader(ds, CHUNK_BATCH, **kw),
                  jax_chunk.ChunkTrainLoader(jds, CHUNK_BATCH, **kw)),
                 (chunk_train.ADCChunkLoader(ds, CHUNK_BATCH, src, **kw),
                  jax_chunk.ADCChunkLoader(jds, CHUNK_BATCH, jsrc, **kw))]
        for port, ref in pairs:
            assert (port.rows_pad, port.f_pad) == (ref.rows_pad, ref.f_pad)
            for got, want in zip(port, ref):
                assert got.keys() == want.keys()
                assert got["hori"].shape[0] == port.f_pad // world
                assert got["rel"].shape[0] == port.rows_pad // world
                for k in got:
                    gv = got[k].float().numpy() if isinstance(
                        got[k], torch.Tensor) else np.asarray(got[k])
                    np.testing.assert_array_equal(
                        gv, np.asarray(want[k]).astype(gv.dtype), err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        chunk_train.ChunkTrainLoader(ds, CHUNK_BATCH, pad_multiple=1,
                                     process=(0, 4))


if __name__ == "__main__":
    worker_main(JOBS)
