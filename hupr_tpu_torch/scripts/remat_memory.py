"""A/B of MODEL.remat on the flagship train step (counterpart of
`scripts/remat_memory.py`): what the recompute of the 3-D encoders
(models/hupr.py) saves in memory and costs in time.

    python -m hupr_tpu_torch.scripts.remat_memory             # memory A/B
    python -m hupr_tpu_torch.scripts.remat_memory --time 5    # + ms/step
    python -m hupr_tpu_torch.scripts.remat_memory --batch 64  # scaling
    python -m hupr_tpu_torch.scripts.remat_memory --device cpu --filters 2 \
        --batch 2

Each variant (remat off, then on) builds the flagship model
(MODEL.attention pallas, BENCH_ATTN to change it) with N(0, 0.03) weights
from seed 0 and takes a warm-up step and a measured step on an N(0, 1)
batch (utils/synthetic.synthetic_train_batch). Prints one JSON line, per
variant `base_*` / `remat_*`:

  *_peak_mb       torch.cuda.max_memory_allocated over the measured step
                  (weights, Adam's state and the batch included; on the
                  card only), and peak_saved_mb = base - remat
  *_autograd_mb   the distinct storages autograd saved for the backward in
                  the measured step (saved_tensors_hooks; inside a
                  checkpoint only its input and outputs), and
                  autograd_saved_mb = base - remat
  *_ms_per_step   with --time N, the mean of N more steps (host clock,
                  the card synchronized)

Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import torch

from hupr_tpu_torch.config import config_from_dict
from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                         make_train_step)
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.utils.device import resolve_device
from hupr_tpu_torch.utils.synthetic import (synthetic_state_dict,
                                            synthetic_train_batch)


def build(cfg, device, seed: int = 0):
    """(train_step, state, batch, lr) for `cfg` on `device`: N(0, 0.03)
    weights from `seed`, cfg.TRAINING.batchSize rows of the N(0, 1) batch."""
    model = build_model(cfg, device=device)
    model.load_state_dict(synthetic_state_dict(model, seed=seed, scale=0.03))
    tx = make_optimizer(cfg, model)
    d = cfg.DATASET
    step = make_train_step(model, tx, cfg.TRAINING.lossDecay,
                           (d.numKeypoints, d.heatmapSize, d.imgSize))
    batch = synthetic_train_batch(cfg, cfg.TRAINING.batchSize, device,
                                  seed=seed + 1)
    return step, TrainState(model, tx), batch, cfg.TRAINING.lr


def autograd_saved_bytes(fn) -> tuple:
    """(fn(), bytes of the distinct storages autograd saved for the
    backward while fn ran)."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def measure(cfg, device, reps: int = 0) -> dict:
    """The readings of one variant (keys without the base_ / remat_
    prefix)."""
    step, state, batch, lr = build(cfg, device)
    state, metrics = step(state, batch, lr, 0.0)          # warm-up
    if not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"non-finite loss {metrics['loss'].item()}")
    out = {}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    (state, metrics), saved = autograd_saved_bytes(
        lambda: step(state, batch, lr, 0.0))
    out["loss"] = metrics["loss"].item()
    out["autograd_mb"] = saved / 1e6
    if cuda:
        out["peak_mb"] = torch.cuda.max_memory_allocated(device) / 1e6
    if reps:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            state, metrics = step(state, batch, lr, 0.0)
        metrics["loss"].item()                 # the card done
        out["ms_per_step"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=20)
    ap.add_argument("--filters", type=int, default=32)
    ap.add_argument("--time", type=int, default=0, metavar="REPS",
                    help="also run REPS timed steps per variant")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = {"batch": args.batch, "filters": args.filters,
           "device": str(device)}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    for remat in (False, True):
        tag = "remat" if remat else "base"
        cfg = config_from_dict({
            "MODEL": {"numFilters": args.filters, "remat": remat,
                      "attention": os.environ.get("BENCH_ATTN", "pallas")},
            "TRAINING": {"batchSize": args.batch}})
        for key, value in measure(cfg, device, args.time).items():
            out[f"{tag}_{key}"] = value
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if "base_peak_mb" in out:
        out["peak_saved_mb"] = out["base_peak_mb"] - out["remat_peak_mb"]
    out["autograd_saved_mb"] = out["base_autograd_mb"] - \
        out["remat_autograd_mb"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
