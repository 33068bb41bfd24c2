"""The data-parallel train step over several cards: one process per rank,
NCCL on the card (gloo with --device cpu), at each world size asked for.

    python -m hupr_tpu_torch.scripts.dp_scaling --worlds 1 2 4
    python -m hupr_tpu_torch.scripts.dp_scaling --device cpu --worlds 1 2 \\
        --filters 2 --spatial 16 --steps 3

Each world size starts its ranks (this module with --worker, RANK,
WORLD_SIZE, LOCAL_RANK = rank, MASTER_ADDR 127.0.0.1 and a free
MASTER_PORT), and every rank takes --steps steps of the flagship recipe's
data-parallel step (engine/steps.make_train_step(mesh=)) from N(0, 0.03)
weights of seed 0 on its block of one global batch: --rows - 1 real rows
of the N(0, 1) batch of seed 3 (utils/synthetic.synthetic_train_batch),
padded to a multiple of the world size (parallel.shard_batch). Strong
scaling: the global batch stays the same as the world grows. Prints one
JSON line `dp_scaling`, per world size:

  ms_per_step            rank 0's mean over the steps after the first
                         (host clock, the loss read back each step)
  samples_per_sec        real rows / ms_per_step
  loss_max_rel_err       against the world of one, the worst step
  update_max_rel_err     each leaf's update from the weights, against the
                         world of one's, in L2 norm relative to it (the
                         worst leaf; chip_smoke.py's runner bar is 5e-2)

A world asks for that many cards (or CPU processes). Exits 1 when a
world's losses or updates fall outside the bars it prints.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import torch

LOSS_RTOL, UPDATE_RTOL = 2e-4, 5e-2


def _cfg(args):
    from hupr_tpu_torch.config import flagship_training_config

    cfg = flagship_training_config()
    cfg.MODEL.numFilters = args.filters
    d = cfg.DATASET
    d.rangeSize = d.azimuthSize = d.heatmapSize = args.spatial
    d.imgSize = 4 * args.spatial
    return cfg


def worker(args) -> None:
    """One rank: init the group, take the steps, rank 0 saves its losses,
    times and final weights to args.out."""
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.parallel import (make_mesh, multihost,
                                         replicate_state, shard_batch)
    from hupr_tpu_torch.utils.synthetic import (synthetic_state_dict,
                                                synthetic_train_batch)

    device = "cpu" if args.device == "cpu" else None
    multihost.initialize(device)
    try:
        torch.set_num_threads(max(1, args.threads))
        mesh = make_mesh(device)
        cfg = _cfg(args)
        d, t = cfg.DATASET, cfg.TRAINING
        model = build_model(cfg, mesh.device)
        w0 = synthetic_state_dict(model, seed=0, scale=0.03)
        model.load_state_dict(w0)
        tx = make_optimizer(cfg, model)
        state = replicate_state(TrainState(model, tx), mesh)
        step = make_train_step(model, tx, t.lossDecay,
                               (d.numKeypoints, d.heatmapSize, d.imgSize),
                               mesh=mesh)
        full = synthetic_train_batch(cfg, args.rows, mesh.device, seed=3)
        batch, _ = shard_batch({k: v[:args.rows - 1]
                                for k, v in full.items()}, mesh,
                               pad_to=args.rows)
        multihost.warmup_device_collectives(mesh)
        losses, seconds = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, t.lr, 0.0)
            losses.append(metrics["loss"].item())
            seconds.append(time.perf_counter() - t0)
        if mesh.rank == 0:
            torch.save({"losses": losses, "seconds": seconds, "w0": w0,
                        "state": {k: v.detach().cpu() for k, v in
                                  model.state_dict().items()}}, args.out)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(args, world: int, out: str) -> dict:
    """Start `world` ranks, wait for each within args.timeout, return rank
    0's saved result; raise with the ranks' output on a failure."""
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(world)}
    argv = [sys.executable, "-m", "hupr_tpu_torch.scripts.dp_scaling",
            "--worker", "--out", out, "--device", args.device,
            "--filters", str(args.filters), "--spatial", str(args.spatial),
            "--rows", str(args.rows), "--steps", str(args.steps),
            "--threads", str(args.threads)]
    procs = [subprocess.Popen(argv, env={**env, "RANK": str(r),
                                         "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + args.timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate(timeout=30)
        raise RuntimeError(f"world {world}: the ranks did not finish in "
                           f"{args.timeout} s")
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"world {world}, rank {r} exited "
                               f"{p.returncode}:\n{text[-4000:]}")
    return torch.load(out, weights_only=False)


def update_rel_err(run: dict, ref: dict) -> tuple:
    """(worst leaf, its update's L2 distance from ref's update relative to
    ref's), over the floating-point leaves that moved."""
    out = {}
    for key, w in run["w0"].items():
        if not w.is_floating_point():
            continue
        d = (run["state"][key] - w).double()
        d_ref = (ref["state"][key] - w).double()
        if d_ref.norm() > 0:
            out[key] = ((d - d_ref).norm() / d_ref.norm()).item()
    worst = max(out, key=out.get)
    return worst, out[worst]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--spatial", type=int, default=64)
    p.add_argument("--rows", type=int, default=20,
                   help="global padded batch; rows - 1 are real")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--timeout", type=float, default=900)
    p.add_argument("--worker", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "--device cpu to run on the CPU")
        if max(args.worlds) > torch.cuda.device_count():
            raise RuntimeError(f"--worlds {args.worlds} needs "
                               f"{max(args.worlds)} cards, this host has "
                               f"{torch.cuda.device_count()}")
    results, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        runs = {w: run_world(args, w, os.path.join(tmp, f"world{w}.pt"))
                for w in args.worlds}
    ref = runs[min(args.worlds)]
    for world, run in runs.items():
        ms = 1e3 * statistics.mean(run["seconds"][1:])
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(run["losses"], ref["losses"]))
        leaf, update = update_rel_err(run, ref)
        results[world] = {"ms_per_step": ms,
                          "samples_per_sec": 1e3 * (args.rows - 1) / ms,
                          "losses": run["losses"],
                          "loss_max_rel_err": loss_rel,
                          "update_max_rel_err": update,
                          "update_worst_leaf": leaf}
        ok = ok and loss_rel <= LOSS_RTOL and update <= UPDATE_RTOL
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({"dp_scaling": {
        "device": card, "backend": "nccl" if args.device == "cuda"
        else "gloo", "rows": args.rows, "real_rows": args.rows - 1,
        "steps": args.steps, "filters": args.filters,
        "spatial": args.spatial, "reference_world": min(args.worlds),
        "bars": {"loss_rtol": LOSS_RTOL, "update_rtol": UPDATE_RTOL},
        "within_bars": ok, "worlds": results}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
