"""The port's multi-process runs (hupr_tpu_torch.parallel.multihost and the
Runner under HUPR_MULTIHOST=1) on the CPU: process-sliced batches equal to
the JAX package's, the trueRows batches' mask, the control plane and its
agreement checks across 2 real gloo processes (every process raises
together, none hangs), and the Runner through main.run in 2 processes,
classic and chunk mode, train and eval, against a one-process Runner's
eval of the same checkpoint.

The ranks run this file as a script (tests/test_torch_parallel.py's
workers: the port and no JAX, a file:// rendezvous, one thread, a timeout
on every wait); the parent, which has JAX, compares."""

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.parallel import multihost
from test_torch_parallel import _load, _save, spawn, worker_main

torch.set_num_threads(1)

AP_ATOL = 5e-3              # tests/test_golden_ap.py's PROTOCOL_ATOL


# ------------------------------------------------------------- workers

def _cfg(tmp: Path):
    return port_config.config_from_dict(
        json.loads((tmp / "cfg.json").read_text()))


def _args(dir_name, eval_mode=False, **kw):
    return argparse.Namespace(seed=0, dir=dir_name, visDir="none",
                              eval=eval_mode, sampling_ratio=1,
                              keypoints=False, **kw)


def _raises(fn) -> str:
    """The RuntimeError `fn` raised, as text; "" when it did not raise."""
    try:
        fn()
    except RuntimeError as exc:
        return str(exc)
    return ""


def job_control(tmp: Path, rank: int, world: int) -> None:
    """The control plane across real processes: barrier, broadcast,
    allgather; assert_agreement agreeing and disagreeing;
    assert_shared_dir on a shared directory and on per-process ones; the
    collective warm-up."""
    from hupr_tpu_torch.parallel import make_mesh

    out = {}
    multihost.barrier("start")
    out["bcast"] = multihost.broadcast_scalar(10.0 + rank)
    out["gather"] = multihost.allgather_scalar(float(rank))
    out["agree"] = _raises(lambda: multihost.assert_agreement("size", 4.0))
    out["disagree"] = _raises(
        lambda: multihost.assert_agreement("dataset size", 4.0 + rank))
    out["shared"] = _raises(lambda: multihost.assert_shared_dir(
        str(tmp / "shared")))
    out["not_shared"] = _raises(lambda: multihost.assert_shared_dir(
        str(tmp / f"own{rank}")))
    multihost.warmup_device_collectives(make_mesh("cpu"))
    out["after"] = multihost.allgather_scalar(1.0)
    _save(tmp, "control", rank, out)


def job_resume(tmp: Path, rank: int, world: int) -> None:
    """A Runner whose processes disagree on the resume: rank 1 cannot see
    the checkpoint rank 0 finds; then rank 1 reads another epoch."""
    from hupr_tpu_torch.engine import runner as runner_mod

    os.environ["HUPR_MULTIHOST"] = "1"
    runner = runner_mod.Runner(_args("resume"), _cfg(tmp), device="cpu")
    out = {}
    real_find, real_load = runner_mod.find_checkpoint, \
        runner_mod.load_checkpoint
    if rank == 1:
        runner_mod.find_checkpoint = lambda d, mode: None
    out["visibility"] = _raises(lambda: runner.load_model_weight(
        "checkpoint"))
    runner_mod.find_checkpoint = real_find
    if rank == 1:
        runner_mod.load_checkpoint = lambda *a: (
            lambda e, acc, lr: (e + 1, acc, lr))(*real_load(*a))
    out["epoch"] = _raises(lambda: runner.load_model_weight("checkpoint"))
    runner_mod.load_checkpoint = real_load
    out["agreed"] = _raises(lambda: runner.load_model_weight("checkpoint"))
    out["start_epoch"] = runner.start_epoch
    _save(tmp, "resume", rank, out)


def job_runner(tmp: Path, rank: int, world: int) -> None:
    """main.run under HUPR_MULTIHOST=1 (the group is this worker's):
    train, then --eval; records each epoch's losses, the checkpoint
    files this process wrote, and every AP eval returned."""
    from hupr_tpu_torch import main as cli
    from hupr_tpu_torch.engine import runner as runner_mod
    from hupr_tpu_torch.engine.checkpoint import AsyncCheckpointer

    os.environ["HUPR_MULTIHOST"] = "1"
    losses, saves, aps = [], [], []
    real_save_list = runner_mod.Runner.save_loss_list
    real_save = AsyncCheckpointer.save
    real_eval = runner_mod.Runner.eval

    def save_loss_list(self, epoch, loss_list, mode):
        losses.append(list(loss_list))
        return real_save_list(self, epoch, loss_list, mode)

    def save(self, paths, *args, **kwargs):
        saves.extend(os.path.basename(p) for p in paths)
        return real_save(self, paths, *args, **kwargs)

    def evaluate(self, *args, **kwargs):
        aps.append(real_eval(self, *args, **kwargs))
        return aps[-1]

    runner_mod.Runner.save_loss_list = save_loss_list
    AsyncCheckpointer.save = save
    runner_mod.Runner.eval = evaluate
    cfg = _cfg(tmp)
    trained = cli.run(_args("mh"), cfg, device="cpu")
    cli.run(_args("mh", True), cfg, device="cpu")
    loader = trained._chunk_loader or trained.train_loader
    _save(tmp, "runner", rank, {
        "losses": losses, "saves": saves, "aps": aps,
        "chunk": trained._chunk_loader is not None,
        "process": loader.process, "world": trained.mesh.world})


JOBS = {"control": job_control, "resume": job_resume, "runner": job_runner}


# ------------------------------------------------------------ host side

def test_assert_agreement_unit(monkeypatch):
    """assert_agreement raises with the per-process values when they
    differ, passes when they agree, and does nothing in one process
    (tests/test_multihost.py's unit test)."""
    multihost.assert_agreement("anything", 3.0)   # one process: no-op

    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "allgather_scalar", lambda v: [v, v])
    multihost.assert_agreement("dataset size", 4.0)

    monkeypatch.setattr(multihost, "allgather_scalar",
                        lambda v: [v, v + 1.0])
    with pytest.raises(RuntimeError, match=r"disagreement on dataset size.*"
                                           r"\[4\.0, 5\.0\]"):
        multihost.assert_agreement("dataset size", 4.0)


@pytest.mark.parametrize("nproc,sampling_ratio", [(2, 1), (3, 2)])
def test_batch_loader_process_blocks_equal_jax(tmp_path, nproc,
                                               sampling_ratio):
    """Each process's BatchLoader(process=, padded_rows=) batches equal
    the JAX package's over two shuffled epochs (the same permutation on
    every process, its own sampling stream, the padding repeating the last
    sample), carry trueRows, and hold padded_rows / nproc rows each."""
    from hupr_tpu.data import dataset as jax_dataset
    from hupr_tpu_torch.data import dataset
    from test_torch_data import tiny_workspace

    jcfg, pcfg = tiny_workspace(tmp_path, duration=8, seqs=(1, 2))
    padded = 3 + (-3) % nproc
    for pid in range(nproc):
        kw = dict(shuffle=True, seed=7, process=(pid, nproc),
                  padded_rows=padded)
        want = jax_dataset.BatchLoader(
            jax_dataset.get_dataset("train", jcfg, sampling_ratio), 3, **kw)
        got = dataset.BatchLoader(
            dataset.get_dataset("train", pcfg, sampling_ratio), 3, **kw)
        for _ in range(2):
            pairs = list(zip(got, want))
            assert len(pairs) == len(want) == 6 // sampling_ratio
            for a, b in pairs:
                assert a.keys() == b.keys() and "trueRows" in a
                assert a["hori"].shape[0] == padded // nproc
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        dataset.BatchLoader(dataset.get_dataset("train", pcfg), 3,
                            process=(0, 2), padded_rows=3)


def test_device_prefetch_true_rows_batches(monkeypatch):
    """A trueRows batch keeps its rows (this process's block) and gets the
    mask of its global rows: 5 real rows of 8 over 2 processes gives
    rank 1 the mask [1, 0, 0, 0]; the JAX package's global_shard_batch
    gives the same block mask."""
    from hupr_tpu.parallel import multihost as jax_multihost
    from hupr_tpu_torch.utils.prefetch import device_prefetch

    rng = np.random.default_rng(0)
    block = {"hori": rng.standard_normal((4, 3)).astype(np.float32),
             "vert": rng.standard_normal((4, 3)).astype(np.float32),
             "jointsGroup": rng.uniform(0, 9, (4, 14, 2)), "trueRows": 5}
    for mod in (multihost, jax_multihost):
        monkeypatch.setattr(mod, "process_count", lambda: 2)
        monkeypatch.setattr(mod, "process_index", lambda: 1)
    ((dev, host, true_b),) = list(device_prefetch([block], "cpu",
                                                  pad_to=8))
    assert true_b == 5 and host is block
    np.testing.assert_array_equal(dev["mask"].numpy(), [1, 0, 0, 0])
    assert jax_multihost.local_row_range(8) == multihost.local_row_range(8)
    for k in ("hori", "vert", "jointsGroup"):
        np.testing.assert_array_equal(dev[k].numpy(), block[k])


def test_control_plane_across_two_processes(tmp_path):
    """2 gloo processes: the broadcast is rank 0's value and the
    allgather every rank's in order; a disagreement and a directory only
    one process sees raise on BOTH, naming the values and the process;
    agreement and a shared directory pass; and both go on to the next
    sync (nobody was left behind)."""
    spawn(Path(__file__), "control", tmp_path)
    ranks = _load(tmp_path, "control")
    for r in ranks:
        assert r["bcast"] == 10.0 and r["gather"] == [0.0, 1.0]
        assert r["agree"] == "" and r["shared"] == ""
        assert "disagreement on dataset size" in r["disagree"]
        assert "[4.0, 5.0]" in r["disagree"]
        assert "process(es) [1] cannot see" in r["not_shared"]
        assert r["after"] == [1.0, 1.0]
    assert not list(tmp_path.glob("shared/.hupr_shared_fs_probe"))


def _tiny(root, chunk=False):
    """tests/test_torch_runner.py's workspace over two 8-frame sequences
    (each process evaluates one): 16x16 maps, GT boxes 1500x1500, train
    and test batch 3 (4 padded rows over 2 processes), one epoch; the
    config is written for the workers."""
    from test_torch_data import tiny_workspace

    _, cfg = tiny_workspace(root, duration=8, seqs=(1, 2))
    for phase in ("train", "val", "test"):
        path = os.path.join(cfg.DATASET.dataDir,
                            f"hrnet_annot_{phase}.json")
        with open(path) as fp:
            annots = json.load(fp)
        for seq in annots:
            for block in seq:
                block["bbox"] = [0.0, 0.0, 1500.0, 1500.0]
        with open(path, "w") as fp:
            json.dump(annots, fp)
    cfg.TRAINING.batchSize = cfg.TEST.batchSize = 3
    cfg.TRAINING.epochs = 1
    cfg.TRAINING.chunkTrain = chunk
    (root / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    return cfg


def test_resume_disagreement_raises_on_every_process(tmp_path):
    """A checkpoint one process cannot see, then one at another epoch:
    load_model_weight raises on both processes each time (so neither
    waits at a later collective), and agreeing processes resume."""
    from test_torch_runner import _seed_checkpoint

    cfg = _tiny(tmp_path)
    _seed_checkpoint(tmp_path, cfg, "resume")
    spawn(Path(__file__), "resume", tmp_path)
    for r in _load(tmp_path, "resume"):
        assert "process(es) [1] did not find a 'checkpoint'" in \
            r["visibility"]
        assert "epoch differs across hosts" in r["epoch"]
        assert r["agreed"] == "" and r["start_epoch"] == 0


@pytest.mark.parametrize("chunk", [False, True], ids=["classic", "chunk"])
def test_two_process_runner_train_and_eval(tmp_path, chunk):
    """main.run in 2 gloo processes with HUPR_MULTIHOST=1: one epoch
    (process-sliced loader; chunk mode's blocks of both padded axes) with
    the val eval split by sequence, then --eval on the test split. Both
    processes log the same losses and APs; process 0 alone wrote the
    checkpoints and the merged results (image ids sorted, both sequences,
    no rank file left); each AP equals a one-process Runner's eval of the
    same checkpoint within tests/test_golden_ap.py's 5e-3. A one-process
    Runner's epoch from the same seed logs the same losses (rtol 1e-5)
    and ends at the same weights (atol 1e-5)."""
    from hupr_tpu_torch.engine.runner import Runner

    cfg = _tiny(tmp_path, chunk)
    spawn(Path(__file__), "runner", tmp_path)
    r0, r1 = _load(tmp_path, "runner")
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 1
    # 16 windows in batches of 3, or 2 sequences in chunks of 3, 3 and 2
    assert len(r0["losses"][0]) == 6
    assert r0["aps"] == r1["aps"] and len(r0["aps"]) == 2
    assert (r0["chunk"], r0["world"]) == (chunk, 2)
    assert (r0["process"], r1["process"]) == ((0, 2), (1, 2))
    assert r1["saves"] == []
    assert sorted(r0["saves"]) == ["checkpoint.pth", "checkpoint_0.pth",
                                   "model_best.pth"]
    log_dir = tmp_path / "logs" / "mh"
    assert not list(log_dir.glob("*rank*"))
    for phase in ("val", "test"):
        with open(log_dir / f"{phase}_results.json") as fp:
            ids = [b["image_id"] for b in json.load(fp)]
        assert len(ids) == 16 and ids == sorted(ids)
        assert {i // 100000 for i in ids} == {1, 2}

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        alone = Runner(_args("one"), cfg, device="cpu")
        alone.train()
        with open("logs/one/train_loss_list_0.json") as fp:
            np.testing.assert_allclose(r0["losses"][0], json.load(fp),
                                       rtol=1e-5)
        mh = torch.load("logs/mh/checkpoint.pth", weights_only=False)
        for k, v in alone.model.state_dict().items():
            torch.testing.assert_close(mh["model_state_dict"][k], v,
                                       rtol=0, atol=1e-5, msg=k)
        for eval_phase, mode, want in (("val", "checkpoint", r0["aps"][0]),
                                       ("test", "model_best",
                                        r0["aps"][1])):
            one = Runner(_args("mh", True, evalPhase=eval_phase), cfg,
                         device="cpu")
            one.load_model_weight(mode)
            assert one.mesh.world == 1
            np.testing.assert_allclose(one.eval(visualization=False), want,
                                       rtol=0, atol=AP_ATOL)
    finally:
        os.chdir(cwd)




def test_dp_scaling_script_on_cpu():
    """hupr_tpu_torch.scripts.dp_scaling with --device cpu: worlds of 1
    and 2 gloo processes at numFilters 2 on 16x16 maps print one JSON line
    whose world of two holds against the world of one (losses 2e-4,
    each leaf's update 5e-2) and exit 0."""
    import subprocess
    import sys

    from test_torch_parallel import REPO

    out = subprocess.run(
        [sys.executable, "-m", "hupr_tpu_torch.scripts.dp_scaling",
         "--device", "cpu", "--worlds", "1", "2", "--filters", "2",
         "--spatial", "16", "--rows", "4", "--steps", "2"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])["dp_scaling"]
    assert line["within_bars"] and line["backend"] == "gloo"
    assert sorted(line["worlds"]) == ["1", "2"]
    two = line["worlds"]["2"]
    assert two["loss_max_rel_err"] <= 2e-4
    assert two["update_max_rel_err"] <= 5e-2
    assert len(two["losses"]) == 2 and two["ms_per_step"] > 0


if __name__ == "__main__":
    worker_main(JOBS)
