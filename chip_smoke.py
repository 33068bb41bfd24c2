#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the process-wide
   TF32 flags, which it leaves at PyTorch's defaults: the port's entry
   points pin TF32 off for their own calls.
2. Builds every CUDA kernel of the port from hupr_tpu_torch/csrc, one nvcc
   per source, all started together, and prints ptxas's registers and
   spills.
3. Holds each kernel against its plain PyTorch version at the shapes its
   path gives it (the forward at B=32 as served, the backward and the
   forward's log-sum-exp at B=20 as trained), and times kernel, plain
   version and the library call that computes the same function.
4. Serves requests of 32 raw int16 ADC frames per radar view through
   make_e2e_infer at the flagship width (config/mscsa_prgcn_tpu.yaml:
   numFilters 32, 64x64 maps, 8-frame windows, MODEL.attention pallas),
   with seeded synthetic weights; checks the launch counts, the output
   shapes and finiteness, and the agreement with the same requests served
   through the plain attention (MODEL.attention xla).
5. Trains the flagship recipe (batch 20, Adam at lr 1e-4) for a few steps
   of bench.py's synthetic batch, driven as Runner.train drives its train
   step, through the kernels and, from the same weights, through the plain
   attention; checks the launch counts, finite losses, and that losses and
   weights agree between the two; profiles one step of each.
6. Ends with one JSON line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

KERNELS = ("attention_fwd", "attention_bwd")   # hupr_tpu_torch/csrc/*.cu
REQUESTS = 8            # timed requests of the serving slice
FRAMES = 32             # raw frames per request and radar view (bench.py)
ATTN_BATCH = 32         # windows per request = the attention's batch
ATTN_TOL = 1e-4         # kernel vs plain, max abs error (float32 vs float32)
MAXVAL_TOL = 1e-4       # pallas vs xla serving, max abs error of maxvals
TRAIN_BATCH = 20        # the flagship's TRAINING.batchSize (bench.py)
TRAIN_STEPS = 4         # timed train steps per path, after one warm-up step
# backward kernel vs plain: the bar of tests/test_attention.py for the
# Pallas backward, atol + rtol * |plain|
GRAD_ATOL, GRAD_RTOL = 1e-3, 1e-4
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# kernel path vs plain-attention path over the train steps: the bars of
# tests/test_reference_parity.py (loss per step; weights and BN statistics)
LOSS_RTOL = 2e-4
PARAM_ATOL, PARAM_RTOL = 7e-4, 1e-3
# (N, C) of the 12 attention calls per forward: 4 at each MSCSA scale
ATTN_SHAPES = ((256, 256), (1024, 128), (4096, 64))

# float32 FMA-pipe peak (flop/s) and memory rate (byte/s) from NVIDIA's
# H100 data sheet, dense, at the full power limit of each variant
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12),
         "SXM": (66.9e12, 3.35e12)}


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_attention(torch, peak_flops, peak_bytes):
    """Kernel vs plain version at the three path shapes; returns per-shape
    results."""
    import torch.nn.functional as F

    from hupr_tpu_torch.ops.attention import (attention_flops,
                                              attention_fwd, attention_plain)
    from hupr_tpu_torch.utils.device import float32_math

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for n, c in ATTN_SHAPES:
        k, q, m = (torch.randn((ATTN_BATCH, n, c), generator=gen,
                               device="cuda") for _ in range(3))
        with torch.inference_mode(), float32_math():
            got = attention_fwd(k, q, m)
            want = attention_plain(k, q, m)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            kernel_ms = cuda_ms(torch, lambda: attention_fwd(k, q, m), 10)
            plain_ms = cuda_ms(torch, lambda: attention_plain(k, q, m), 5)
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, m, scale=1.0), 10)
        flops = attention_flops(ATTN_BATCH, n, c)
        nbytes = 4 * ATTN_BATCH * n * c * 4     # k, q, m read, out written
        ops_ms, bytes_ms = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bytes
        bound_ms = max(ops_ms, bytes_ms)
        row = {"kernel": "attention_fwd", "B": ATTN_BATCH, "N": n, "C": c,
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": flops / kernel_ms / 1e9}
        print(json.dumps(row), flush=True)
        if not err <= ATTN_TOL:
            raise AssertionError(f"attention_fwd at N={n}, C={c}: max abs "
                                 f"error {err} > {ATTN_TOL}")
        rows.append(row)
        del k, q, m, got, want
    return rows


def allclose_excess(a, b, atol, rtol) -> float:
    """max(|a - b| - (atol + rtol |b|)): <= 0 where torch.allclose holds."""
    return ((a - b).abs() - (atol + rtol * b.abs())).max().item()


def check_attention_bwd(torch, peak_flops, peak_bytes):
    """Backward kernel vs plain version, and the forward's log-sum-exp vs
    torch.logsumexp, at the three path shapes with the training batch;
    returns per-shape results."""
    import torch.nn.functional as F

    from hupr_tpu_torch.ops.attention import (BWD_MATMULS, attention_bwd,
                                              attention_bwd_plain,
                                              attention_fwd)
    from hupr_tpu_torch.utils.device import float32_math

    gen = torch.Generator(device="cuda").manual_seed(2)
    b = TRAIN_BATCH
    rows = []
    for n, c in ATTN_SHAPES:
        k, q, m, g = (torch.randn((b, n, c), generator=gen, device="cuda")
                      for _ in range(4))
        # logits of unit spread, so that each query's softmax spreads over
        # many keys and every gradient sums many terms of similar size (at
        # N(0, 1) inputs the softmax is nearly one-hot)
        k, q = k * c ** -0.25, q * c ** -0.25
        with torch.inference_mode(), float32_math():
            out, lse = attention_fwd(k, q, m, with_lse=True)
            want_lse = torch.logsumexp(torch.einsum("bic,bjc->bij", k, q),
                                       dim=1)
            lse_excess = allclose_excess(lse, want_lse, LSE_ATOL, LSE_RTOL)
            lse_err = (lse - want_lse).abs().max().item()
            del want_lse
            got = attention_bwd(k, q, m, out, lse, g)
            want = attention_bwd_plain(k, q, m, out, lse, g)
            torch.cuda.synchronize()
            errs = {name: (a - w).abs().max().item()
                    for name, a, w in zip(("dk", "dq", "dm"), got, want)}
            scale = {name: w.abs().max().item()
                     for name, w in zip(("dk", "dq", "dm"), want)}
            excess = max(allclose_excess(a, w, GRAD_ATOL, GRAD_RTOL)
                         for a, w in zip(got, want))
            del got, want
            kernel_ms = cuda_ms(torch, lambda: attention_bwd(
                k, q, m, out, lse, g), 10)
            # the forward as training launches it, with the LSE store
            fwd_lse_ms = cuda_ms(torch, lambda: attention_fwd(
                k, q, m, with_lse=True), 10)
            plain_ms = cuda_ms(torch, lambda: attention_bwd_plain(
                k, q, m, out, lse, g), 5)
        # the library's backward alone: SDPA (query q, key k, value m, no
        # scale) differentiated with its graph kept between calls
        with float32_math():
            qs, ks, ms_ = (x.clone().requires_grad_(True) for x in (q, k, m))
            o = F.scaled_dot_product_attention(qs, ks, ms_, scale=1.0)
            library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                o, (qs, ks, ms_), g, retain_graph=True), 10)
            del o, qs, ks, ms_
        flops = 2 * b * n * n * c * BWD_MATMULS
        # k, q, m, out, g and lse read, dk, dq, dm written
        nbytes = 4 * (8 * b * n * c + b * n)
        ops_ms, bytes_ms = 1e3 * flops / peak_flops, 1e3 * nbytes / peak_bytes
        row = {"kernel": "attention_bwd", "B": b, "N": n, "C": c,
               "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
               "max_abs_by_grad": scale,
               "allclose_excess": excess, "lse_max_abs_err": lse_err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(ops_ms, bytes_ms),
               "fwd_with_lse_ms": fwd_lse_ms,
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": flops / kernel_ms / 1e9}
        print(json.dumps(row), flush=True)
        if not excess <= 0:
            raise AssertionError(f"attention_bwd at N={n}, C={c}: errors "
                                 f"{errs} exceed atol {GRAD_ATOL} + rtol "
                                 f"{GRAD_RTOL}")
        if not lse_excess <= 0:
            raise AssertionError(f"attention_fwd's lse at N={n}, C={c}: max "
                                 f"abs error {lse_err}")
        rows.append(row)
        del k, q, m, g, out, lse
    return rows


def serve_slice(torch, requests, card: str):
    """Serve `requests` through the flagship config with the kernel, then
    through the plain attention; returns the slice's results."""
    import numpy as np

    from hupr_tpu_torch.config import ModelConfig, flagship_serving_config
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops.attention import attention_bwd, attention_fwd
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    cfg = flagship_serving_config()
    if cfg.MODEL.attention != "pallas":
        raise AssertionError("the flagship serving config runs the kernel")
    model = build_model(cfg)
    # N(0, 0.03) keeps the flagship's heatmap peaks spread out: at 0.05 the
    # PRGCN's sums over 1024 nodes saturate the sigmoid at 1 everywhere
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    ds = cfg.DATASET
    run = make_e2e_infer(model, state, ds.radar_params(), duration=FRAMES,
                         group=ds.numGroupFrames, num_frames=ds.numFrames)
    cfg_x = flagship_serving_config()
    cfg_x.MODEL = ModelConfig(numFilters=cfg.MODEL.numFilters,
                              attention="xla")
    run_x = make_e2e_infer(build_model(cfg_x), state, ds.radar_params(),
                           duration=FRAMES, group=ds.numGroupFrames,
                           num_frames=ds.numFrames)

    def serve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(*req) for req in requests]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    for fn in (run, run_x):                 # warm-up: cuDNN plans, caches
        fn(*requests[0])
    # in turns on one card: plain attention, kernel, plain attention
    _, elapsed_x1 = serve(run_x)
    attention_fwd.launches = attention_bwd.launches = 0
    outs, elapsed = serve(run)
    launches = attention_fwd.launches
    bwd_launches = attention_bwd.launches
    outs_x, elapsed_x2 = serve(run_x)

    per_request = 12
    if launches != per_request * len(requests) or bwd_launches != 0:
        raise AssertionError(f"serving launched attention_fwd {launches} and "
                             f"attention_bwd {bwd_launches} times for "
                             f"{len(requests)} requests, expected "
                             f"{per_request} and 0 each")
    k = ds.numKeypoints
    for pred, maxv in outs:
        if tuple(pred.shape) != (FRAMES, k, 2) or \
                tuple(maxv.shape) != (FRAMES, k, 1):
            raise AssertionError(f"output shapes {tuple(pred.shape)}, "
                                 f"{tuple(maxv.shape)}")
        if not (torch.isfinite(pred).all() and torch.isfinite(maxv).all()):
            raise AssertionError("non-finite serving output")
        if not (maxv.std().item() > 1e-3 and maxv.max().item() < 1.0):
            raise AssertionError("heatmap peaks are flat or saturated: the "
                                 "comparison below would be vacuous")

    maxval_err = max((mv - mx).abs().max().item()
                     for (_, mv), (_, mx) in zip(outs, outs_x))
    same = np.mean([(p == px).float().mean().item()
                    for (p, _), (px, _) in zip(outs, outs_x)])
    frames = FRAMES * len(requests)
    result = {"card": card, "requests": len(requests),
              "frames_per_request": FRAMES,
              "seconds": elapsed,
              "frames_per_s": frames / elapsed,
              "frames_per_s_xla": [frames / elapsed_x1, frames / elapsed_x2],
              "attention_launches": launches,
              "maxvals_max_abs_err_vs_xla": maxval_err,
              "pred2d_identical_share_vs_xla": float(same)}
    print(json.dumps({"slice": result}), flush=True)
    if not maxval_err <= MAXVAL_TOL:
        raise AssertionError(f"maxvals differ from the plain-attention "
                             f"path by {maxval_err} > {MAXVAL_TOL}")
    return result, run


def profile(torch, path: str, fn, top: int = 12):
    """One call of fn under torch.profiler: device time by kernel, the time
    the device was busy (the union of its events' spans, so that work that
    overlaps on two streams counts once), and the device's idle share of
    the call's wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == cuda and e.self_device_time_total > 0]
    kernels.sort(key=lambda x: -x[1])
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if e.device_type == cuda):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy_ms = busy_us / 1e3
    out = {"path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "kernel_ms_total": sum(ms for _, ms, _ in kernels),
           "idle_share": (1 - busy_ms / wall_ms) if kernels else None,
           "top": [[name[:90], ms, n] for name, ms, n in kernels[:top]]}
    print(json.dumps({"profile": out}), flush=True)


def train_slice(torch, card: str):
    """The flagship training step through the kernels and, from the same
    weights, through the plain attention, on bench.py's batch; returns the
    slice's results and, for each path, a function that takes one more
    step."""
    from hupr_tpu_torch.config import ModelConfig, flagship_training_config
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops.attention import attention_bwd, attention_fwd
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    cfg = flagship_training_config()
    if cfg.MODEL.attention != "pallas":
        raise AssertionError("the flagship training config runs the kernels")
    cfg_x = flagship_training_config()
    cfg_x.MODEL = ModelConfig(numFilters=cfg.MODEL.numFilters,
                              attention="xla")
    t, ds = cfg.TRAINING, cfg.DATASET
    if t.batchSize != TRAIN_BATCH:
        raise AssertionError(f"flagship batch {t.batchSize}")
    geometry = (ds.numKeypoints, ds.heatmapSize, ds.imgSize)

    # bench.py's batch: N(0, 1) windows per view, joints uniform in
    # (20, 230), made on the card from a seed
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (t.batchSize, ds.numGroupFrames, ds.numFrames, 2, ds.rangeSize,
             ds.azimuthSize, ds.elevationSize)
    batch = {"hori": torch.randn(shape, generator=gen, device="cuda"),
             "vert": torch.randn(shape, generator=gen, device="cuda"),
             "jointsGroup": 20 + 210 * torch.rand(
                 (t.batchSize, ds.numKeypoints, 2), generator=gen,
                 device="cuda", dtype=torch.float64)}

    paths = {}
    for name, c in (("pallas", cfg), ("xla", cfg_x)):
        model = build_model(c)
        if name == "pallas":
            # N(0, 0.03) as serving draws them (see serve_slice)
            weights = synthetic_state_dict(model, seed=0, scale=0.03)
        model.load_state_dict(weights, strict=True)
        tx = make_optimizer(c, model)
        paths[name] = {"state": TrainState(model, tx),
                       "step": make_train_step(model, tx, t.lossDecay,
                                               geometry),
                       "lr": t.lr, "alpha": 0.0, "idx": 0, "losses": []}

    def drive(p, steps):
        """Runner.train's loop body: alpha advanced before the step, the lr
        adjusted after every lrDecayIter-th step (idx 0 included)."""
        for _ in range(steps):
            if p["alpha"] < 1.0:
                p["alpha"] += t.lossDecay
            p["state"], metrics = p["step"](p["state"], batch, p["lr"],
                                            p["alpha"])
            p["losses"].append(metrics["loss"])
            if p["idx"] % t.lrDecayIter == 0:     # Runner.adjust_lr, epoch 0
                p["lr"] *= t.warmupGrowth if 0 < t.warmupEpoch else t.lrDecay
            p["idx"] += 1

    for name in ("pallas", "xla"):          # warm-up: cuDNN plans, caches
        drive(paths[name], 1)
    timing = {}
    # in turns on one card: the kernel path, then the plain attention
    for name in ("pallas", "xla"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention_fwd.launches = attention_bwd.launches = 0
        t0 = time.perf_counter()
        drive(paths[name], TRAIN_STEPS)
        torch.cuda.synchronize()
        timing[name] = {
            "seconds": time.perf_counter() - t0,
            "launches": (attention_fwd.launches, attention_bwd.launches),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}

    want = (12 * TRAIN_STEPS, 12 * TRAIN_STEPS)
    if timing["pallas"]["launches"] != want or \
            timing["xla"]["launches"] != (0, 0):
        raise AssertionError(f"train steps launched (attention_fwd, "
                             f"attention_bwd) {timing['pallas']['launches']} "
                             f"times through the kernels and "
                             f"{timing['xla']['launches']} through the plain "
                             f"attention; expected {want} and (0, 0)")
    losses = {name: [x.item() for x in p["losses"]]
              for name, p in paths.items()}
    if not all(map(math.isfinite, losses["pallas"] + losses["xla"])):
        raise AssertionError(f"non-finite train losses {losses}")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["pallas"], losses["xla"]))
    sd, sd_x = (p["state"].model.state_dict() for p in paths.values())
    param_excess = max(allclose_excess(sd[key], sd_x[key], PARAM_ATOL,
                                       PARAM_RTOL)
                       for key in sd if sd[key].is_floating_point())
    param_err = max((sd[key] - sd_x[key]).abs().max().item()
                    for key in sd if sd[key].is_floating_point())
    b = TRAIN_BATCH
    ms = {name: 1e3 * tm["seconds"] / TRAIN_STEPS
          for name, tm in timing.items()}
    result = {"card": card, "batch": b, "steps": 1 + TRAIN_STEPS,
              "timed_steps": TRAIN_STEPS,
              "train_ms_per_step": ms["pallas"],
              "train_samples_per_sec": 1e3 * b / ms["pallas"],
              "train_ms_per_step_xla": ms["xla"],
              "train_samples_per_sec_xla": 1e3 * b / ms["xla"],
              "losses": losses["pallas"], "losses_xla": losses["xla"],
              "loss_max_rel_err_vs_xla": loss_rel,
              "param_max_abs_err_vs_xla": param_err,
              "param_allclose_excess": param_excess,
              "attention_fwd_launches": timing["pallas"]["launches"][0],
              "attention_bwd_launches": timing["pallas"]["launches"][1],
              "max_memory_allocated": timing["pallas"]["max_memory_allocated"],
              "max_memory_allocated_xla":
                  timing["xla"]["max_memory_allocated"]}
    print(json.dumps({"train": result}), flush=True)
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError(f"train losses differ from the plain-attention "
                             f"path by {loss_rel} relative > {LOSS_RTOL}")
    if not param_excess <= 0:
        raise AssertionError(f"weights after the steps differ from the "
                             f"plain-attention path by up to {param_err}")
    return result, {name: (lambda p=p: drive(p, 1))
                    for name, p in paths.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hupr_tpu_torch.ops.cuda_build import build

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    # left at PyTorch's defaults: make_e2e_infer and the comparisons below
    # pin TF32 off themselves (utils.device.float32_math)
    print(f"process-wide cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    variant, (peak_flops, peak_bytes) = card_peaks(
        torch.cuda.get_device_name(0))
    print(f"bound uses H100 {variant} data-sheet peaks: "
          f"{peak_flops / 1e12} TFLOP/s float32, "
          f"{peak_bytes / 1e12} TB/s", flush=True)

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(build, KERNELS)))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error")):
                print(f"  {name}: {line.strip()}", flush=True)

    rows = check_attention(torch, peak_flops, peak_bytes)
    bwd_rows = check_attention_bwd(torch, peak_flops, peak_bytes)

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (FRAMES, 4, 192, 256)
    requests = [tuple(torch.randint(-300, 300, shape, generator=gen,
                                    device="cuda", dtype=torch.int16)
                      for _ in range(4)) for _ in range(REQUESTS)]
    sl, run = serve_slice(torch, requests, smi)
    profile(torch, "serve", lambda: run(*requests[0]))
    del requests, run
    tr, one_step = train_slice(torch, smi)
    # every kernel of the step, so that the two paths can be compared
    profile(torch, "train", one_step["pallas"], top=200)
    profile(torch, "train_plain_attention", one_step["xla"], top=200)

    def row(name, rows, launches, per):
        # per request or per step: 4 launches at each shape
        total = {key: 4 * sum(r[key] for r in rows)
                 for key in ("kernel_ms", "plain_ms", "library_ms",
                             "bound_ms")}
        return {
            "name": name, "route": "cuda",
            "source": f"hupr_tpu_torch/csrc/{name}.cu",
            "replaces": {"attention_fwd": "hupr_tpu/ops/attention.py:90",
                         "attention_bwd": "hupr_tpu/ops/attention.py:188",
                         }[name],
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": "operations" if all(r["bound_by"] == "operations"
                                            for r in rows) else "bytes",
            "library_ms": total["library_ms"], "per": per}

    shapes = "4 at each (N, C) of (256, 256), (1024, 128), (4096, 64)"
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [
        row("attention_fwd", rows,
            {"serve": sl["attention_launches"],
             "train": tr["attention_fwd_launches"]},
            f"one request: 12 launches, {shapes}, B={ATTN_BATCH}"),
        row("attention_bwd", bwd_rows,
            {"serve": 0, "train": tr["attention_bwd_launches"]},
            f"one train step: 12 launches, {shapes}, B={TRAIN_BATCH}"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
