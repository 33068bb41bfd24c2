"""Data-parallel training over `world` cards, one rank process each.

The recipe's step, engine/steps.make_train_step(mesh=), over a process
group on NCCL (gloo on the CPU): a global batch of `batch` rows, each rank
its contiguous block, BN synced over the real rows of every rank, one flat
gradient sum a step. `distinct` global batches are drawn from the seed on
every rank alike and cycled; losses are read one step late. The run's
process is rank 0: it starts the other ranks (this module with --rank), on
a TCP store at a free port of localhost, and alone prints the result.

Rank 0 decides when the window ends; its decision travels with each step
as a one-element broadcast that every rank reads one step late, beside the
loss, so that every rank takes the same steps. The set-up takes the first
`check_steps` steps and `warmup_steps` more; the window keeps the losses
of its first `window_steps` steps and the parameters after them, as
train_steps does. The reference replays those steps on one card over the
whole global batch: the losses, the first gradient as Adam got it on rank
0, and each leaf's change.

Mix parameters: world, batch, distinct, check_steps, warmup_steps,
window_steps, tail_units.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from gpubench import harness, trace
from gpubench.traffic import train_steps

START_TIMEOUT_S = 600
# how rank 0 starts each other rank: this module, with the rank's options
RANK_COMMAND = [sys.executable, "-m", "gpubench.traffic.train_dp"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Rank:
    """What every rank holds and does; rank 0 decides."""

    def __init__(self, config, traffic, seed, rank, world, port, device):
        from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                                 make_train_step)
        from hupr_tpu_torch.models.hupr import build_model
        from hupr_tpu_torch.parallel.mesh import Mesh, shard_batch

        cpu = device == "cpu"
        dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
        if not cpu:
            torch.cuda.set_device(dev)
            # NVLink carries the ranks' traffic: nothing through /dev/shm
            os.environ["NCCL_SHM_DISABLE"] = "1"
        dist.init_process_group(
            "gloo" if cpu else "nccl", init_method=f"tcp://127.0.0.1:{port}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=START_TIMEOUT_S))
        self.rank, self.dev = rank, dev
        self.mesh = Mesh(rank, world, dev)
        self.traffic = traffic
        cfg = harness.port_config(config)
        g = harness.geometry(config)
        self.state = harness.draw_state(config, seed, dev)
        self.batches = train_steps.draw_batches(config, traffic, seed, dev)
        self.blocks = [shard_batch(b, self.mesh)[0] for b in self.batches]
        net = build_model(cfg, dev)
        net.load_state_dict(self.state, strict=True)
        tx = make_optimizer(cfg, net)
        self.step = make_train_step(net, tx, cfg.TRAINING.lossDecay,
                                    (g["keypoints"], g["heatmap"], g["img"]),
                                    mesh=self.mesh)
        self.train_state, self.net = TrainState(net, tx), net
        self.lr = cfg.TRAINING.lr
        self.taken = 0
        flag = torch.ones(1, device=dev)
        dist.all_reduce(flag)            # NCCL's communicator, built here
        losses, grad = [], None
        for _ in range(traffic["check_steps"]):
            m = self.run_step()
            losses.append((m["loss1"].item(), m["loss2"].item()))
            if grad is None:
                grad = train_steps.first_gradient(net, tx)
        self.readings = {"losses": losses, "grad": grad,
                         "weights": train_steps.parameters(net)}
        for _ in range(traffic["warmup_steps"]):
            self.run_step()["loss"].item()

    def run_step(self) -> dict:
        block = self.blocks[self.taken % len(self.blocks)]
        self.train_state, metrics = self.step(self.train_state, block,
                                              self.lr, 0.0)
        self.taken += 1
        return metrics

    def decide(self, value: bool) -> torch.Tensor:
        """Rank 0's `value` on every rank (a card tensor, read later)."""
        flag = torch.tensor([float(value)], device=self.dev)
        dist.broadcast(flag, 0)
        return flag

    def window(self, seconds: float) -> dict:
        keep = self.traffic["window_steps"]
        n, failed, last, kept, weights = 0, 0, None, [], None
        t0 = time.perf_counter()
        while True:
            metrics = self.run_step()
            n += 1
            if n <= keep:
                kept.append((metrics["loss1"], metrics["loss2"]))
                if n == keep:
                    weights = train_steps.parameters(self.net)
            go = self.decide(time.perf_counter() - t0 < seconds or n < keep)
            if last is not None:
                failed += not math.isfinite(last[0]["loss"].item())
                if not last[1].item():
                    break
            last = (metrics, go)
        failed += not math.isfinite(metrics["loss"].item())
        wall = time.perf_counter() - t0
        self.readings.update(
            window_losses=[(a.item(), b.item()) for a, b in kept],
            window_weights=weights)
        return {"attempted": n, "failed": failed, "units": n, "wall_s": wall,
                "metrics": {"dp_train_samples_per_s":
                            n * self.traffic["batch"] / wall}}

    def tail_steps(self):
        last = None
        for _ in range(self.traffic["tail_units"]):
            metrics = self.run_step()
            if last is not None:
                last["loss"].item()
            last = metrics
        last["loss"].item()

    def close(self):
        dist.barrier()
        dist.destroy_process_group()


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        world = traffic["world"]
        port = free_port()
        argv = [*RANK_COMMAND, "--world", str(world), "--port", str(port),
                "--seed", str(seed), "--device", str(device),
                "--config", json.dumps(config),
                "--traffic", json.dumps(traffic)]
        self.procs = [subprocess.Popen(argv + ["--rank", str(r)])
                      for r in range(1, world)]
        try:
            self.rank0 = Rank(config, traffic, seed, 0, world, port, device)
        except BaseException:
            self.stop_ranks(kill=True)
            raise
        self.state = self.rank0.state
        self.readings = self.rank0.readings
        self.frames_per_unit = traffic["batch"]
        self.flop_shapes = {"frames": 0, "windows": traffic["batch"],
                            "train": True}
        rows = traffic["batch"] // world
        self.attention = {"rows": rows, "bwd_rows": rows, "lse": True}

    def window(self, seconds: float) -> dict:
        return self.rank0.window(seconds)

    def tail(self) -> trace.Trace:
        self.rank0.decide(True).item()
        units = self.traffic["tail_units"]
        return trace.traced(self.rank0.tail_steps, units,
                            units * self.frames_per_unit)

    def release(self):
        """Every rank leaves the group and exits; rank 0 keeps the state
        the reference needs."""
        self.rank0.decide(False).item()
        self.rank0.close()
        self.stop_ranks()
        self.batches = train_steps.replayed(self.rank0.batches, self.traffic)
        del self.rank0

    def stop_ranks(self, kill=False):
        for p in self.procs:
            if kill:
                p.kill()
        for p in self.procs:
            if p.wait(timeout=START_TIMEOUT_S) != 0 and not kill:
                raise RuntimeError(f"a rank exited {p.returncode}")

    def check(self) -> dict:
        ref = train_steps.reference_readings(self.state, self.batches,
                                             self.config, self.traffic)
        return harness.train_gaps(self.readings, ref,
                                  train_steps.initial_weights(self.state))


# the control and the half batch: the reference over the global batch on
# one card, as for one-card training
control = train_steps.control


def rank_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of train_dp")
    for name in ("rank", "world", "port", "seed"):
        p.add_argument(f"--{name}", type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    args = p.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    rank = Rank(json.loads(args.config), json.loads(args.traffic), args.seed,
                args.rank, args.world, args.port, args.device)
    rank.window(float("inf"))
    if rank.decide(False).item():
        rank.tail_steps()
        rank.decide(False).item()
    rank.close()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main())
