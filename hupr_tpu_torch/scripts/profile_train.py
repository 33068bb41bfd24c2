"""Profile the flagship train step (or the serving program with MODE=serve)
on the card and print per-kernel time attribution from torch.profiler
(counterpart of `scripts/profile_train.py`).

Usage: [MODE=serve] [PROF_BATCH=128 PROF_DTYPE=bfloat16 PROF_REMAT=1]
       python -m hupr_tpu_torch.scripts.profile_train [--device cpu]
       [--filters 2]

The flagship width (numFilters 32, 64x64 maps, 8-frame windows,
MODEL.attention pallas) with N(0, 0.03) weights from seed 0: the train
step on an N(0, 1) batch of PROF_BATCH rows (20 by default; Adam at lr
1e-4), or one request of 32 raw frames per view through make_e2e_infer.
The PROF_* knobs profile other train operating points (e.g. the
config/mscsa_prgcn_tpu_max.yaml composition). One warm-up call, then one
profiled call, the process's first profiler run (a later run would drop
some of the card's events). Time is summed per kernel name (template
arguments and parameters cut) over the card's kernels; copies and memsets
are left out, so the sum attributes compute, not wall time. On the CPU
(--device cpu, with --filters for a narrow model) it attributes the host
ops' self time instead. Ends with the attention wrappers' launch counts
over both calls.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict

import numpy as np
import torch

from hupr_tpu_torch.config import config_from_dict
from hupr_tpu_torch.engine.pipeline import make_e2e_infer
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.ops import attention, kernels
from hupr_tpu_torch.scripts.remat_memory import build
from hupr_tpu_torch.utils.device import resolve_device
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

SERVE_FRAMES = 32
TOP = 25


def kernel_name(name: str) -> str:
    """A kernel's name without 'void ', '(anonymous namespace)::', template
    arguments or parameters: the instances of one kernel add up on one
    line."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0]


def attribute(prof, device: torch.device) -> dict:
    """{name: ms} of the card's compute kernels (or, on the CPU, of the
    host ops' self time) in one torch.profiler run."""
    per_op = defaultdict(float)
    for e in prof.key_averages():
        if device.type == "cuda":
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    getattr(e, "is_user_annotation", False) or \
                    e.key.startswith(("Memcpy", "Memset")):
                continue
            us = e.self_device_time_total
        else:
            us = e.self_cpu_time_total
        if us > 0:
            per_op[kernel_name(e.key)] += us / 1e3
    return dict(per_op)


def serve_call(cfg, device):
    """One request's call: 32 N(0, 1) float32 frames per view plane."""
    model = build_model(cfg, device=device)
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    rng = np.random.default_rng(0)
    shape = (SERVE_FRAMES, 4, 192, 256)
    planes = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device) for _ in range(4)]
    run = make_e2e_infer(model, state, duration=SERVE_FRAMES, device=device)
    return lambda: run(*planes)[1].sum().item()


def train_call(cfg, device):
    """One train step's call (Adam at lr 1e-4), the loss read back."""
    step, state, batch, _ = build(cfg, device)

    def call():
        nonlocal state
        state, metrics = step(state, batch, 1e-4, 0.0)
        return metrics["loss"].item()
    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from torch.profiler import ProfilerActivity, profile

    mode = os.environ.get("MODE", "train")
    cfg = config_from_dict({
        "MODEL": {"numFilters": args.filters, "attention": "pallas",
                  "computeDtype": os.environ.get("PROF_DTYPE", "float32"),
                  "remat": os.environ.get("PROF_REMAT", "0") == "1"},
        "TRAINING": {"batchSize": int(os.environ.get("PROF_BATCH", "20"))}})
    kernels.reset_launch_counts()
    call = (serve_call if mode == "serve" else train_call)(cfg, device)
    call()                                   # warm-up: cuDNN plans, caches
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        call()
    per_op = attribute(prof, device)
    total = sum(per_op.values())
    print(f"total attributed compute: {total:.2f} ms")
    for name, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"{ms:9.3f} ms  {100*ms/max(total,1e-9):5.1f}%  {name}")
    launches = {fn.__name__: dict(fn.launches_by_mode)
                for fn in (attention.attention_fwd, attention.attention_bwd)}
    print(f"attention launches: {json.dumps(launches)}", flush=True)
    return {"mode": mode, "total_ms": total, "per_op_ms": per_op,
            "launches": launches}


if __name__ == "__main__":
    main()
