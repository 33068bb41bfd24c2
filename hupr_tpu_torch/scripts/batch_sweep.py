"""Train-step batch-size sweep: ms/step, samples/s, TFLOP/s and MFU per batch
(counterpart of `scripts/batch_sweep.py`).

The flagship trains at the reference's batch 20; a production run may raise
it, and this maps the throughput and MFU curve so that the choice is
measured. MODEL.remat trades FLOPs for activation memory when a batch stops
fitting the card.

    python -m hupr_tpu_torch.scripts.batch_sweep            # B = 20 40 64
    BS_LIST=20,64 BS_REMAT=1 python -m hupr_tpu_torch.scripts.batch_sweep
    BS_DTYPE=bfloat16 python -m hupr_tpu_torch.scripts.batch_sweep
    BS_LIST=2 python -m hupr_tpu_torch.scripts.batch_sweep --device cpu \
        --filters 2

Knobs: BS_LIST (batches), BS_REMAT (1: MODEL.remat), BS_DTYPE
(MODEL.computeDtype), BS_REPS (timed steps, 5) and BENCH_PEAK_TFLOPS (989,
the H100 SXM's dense bfloat16 peak). Each batch builds the flagship model
(MODEL.attention pallas) with N(0, 0.03) weights from seed 0 on an N(0, 1)
batch (scripts/remat_memory.build). FLOPs: torch.utils.flop_counter over
one step, plus the decoder's 12 attentions forward and backward
(ops/attention.mscsa_attention_flops) where the kernels ran, which the
counter cannot see. One JSON line per batch. A batch that runs out of the
card's memory prints its error on its line and the sweep goes on.

Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from hupr_tpu_torch.config import config_from_dict
from hupr_tpu_torch.ops.attention import mscsa_attention_flops
from hupr_tpu_torch.scripts.remat_memory import build
from hupr_tpu_torch.utils.device import resolve_device


def step_flops(cfg, step, state, batch, lr) -> tuple:
    """(state, metrics, FLOPs) of one train step: the step taken under
    torch's flop counter, plus the attention kernels' FLOPs on the
    card."""
    with FlopCounterMode(display=False) as counter:
        state, metrics = step(state, batch, lr, 0.0)
    if not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"non-finite loss {metrics['loss'].item()}")
    flops = counter.get_total_flops()
    device = next(state.model.parameters()).device
    if device.type == "cuda" and cfg.MODEL.attention != "xla":
        d = cfg.DATASET
        flops += mscsa_attention_flops(cfg.TRAINING.batchSize, d.heatmapSize,
                                       cfg.MODEL.numFilters,
                                       include_backward=True)
    return state, metrics, flops


def sweep_one(cfg, device, reps: int, peak: float) -> dict:
    b = cfg.TRAINING.batchSize
    step, state, batch, lr = build(cfg, device)
    state, _, flops = step_flops(cfg, step, state, batch, lr)  # + warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, metrics = step(state, batch, lr, 0.0)
    metrics["loss"].item()                     # the card done
    dt = (time.perf_counter() - t0) / reps
    return {"ms_per_step": dt * 1e3, "samples_per_sec": b / dt,
            "tflops_per_step": flops / 1e12,
            "tflops_per_sec": flops / dt / 1e12,
            "mfu_vs_bf16_peak": flops / dt / peak}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--filters", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sizes = [int(b) for b in os.environ.get("BS_LIST", "20,40,64").split(",")]
    remat = os.environ.get("BS_REMAT", "0") == "1"
    dtype = os.environ.get("BS_DTYPE", "float32")
    peak = float(os.environ.get("BENCH_PEAK_TFLOPS", "989")) * 1e12
    reps = int(os.environ.get("BS_REPS", "5"))

    lines = []
    for b in sizes:
        cfg = config_from_dict({
            "MODEL": {"numFilters": args.filters, "remat": remat,
                      "computeDtype": dtype, "attention": "pallas"},
            "TRAINING": {"batchSize": b}})
        line = {"batch": b, "remat": remat, "dtype": dtype}
        try:
            line |= sweep_one(cfg, device, reps, peak)
        except torch.cuda.OutOfMemoryError as exc:  # report, sweep on
            line |= {"error": type(exc).__name__, "detail": str(exc)[:200]}
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
