#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the process-wide
   TF32 flags, which it leaves at PyTorch's defaults: the port's entry
   point pins TF32 off for its own calls.
2. Builds every CUDA kernel of the serving path from hupr_tpu_torch/csrc.
3. Holds each kernel against its plain PyTorch version at the shapes the
   serving path gives it, and times kernel, plain version and the library
   call that computes the same function.
4. Serves requests of 32 raw int16 ADC frames per radar view through
   make_e2e_infer at the flagship width (config/mscsa_prgcn_tpu.yaml:
   numFilters 32, 64x64 maps, 8-frame windows, MODEL.attention pallas),
   with seeded synthetic weights; checks the launch counts, the output
   shapes and finiteness, and the agreement with the same requests served
   through the plain attention (MODEL.attention xla).
5. Ends with one JSON line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REQUESTS = 8            # timed requests of the serving slice
FRAMES = 32             # raw frames per request and radar view (bench.py)
ATTN_BATCH = 32         # windows per request = the attention's batch
ATTN_TOL = 1e-4         # kernel vs plain, max abs error (float32 vs float32)
MAXVAL_TOL = 1e-4       # pallas vs xla serving, max abs error of maxvals
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


def serve_slice(torch, requests, card: str):
    """Serve `requests` through the flagship config with the kernel, then
    through the plain attention; returns the slice's results."""
    import numpy as np

    from hupr_tpu_torch.config import ModelConfig, flagship_serving_config
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops.attention import attention_fwd
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
    attention_fwd.launches = 0
    outs, elapsed = serve(run)
    launches = attention_fwd.launches
    outs_x, elapsed_x2 = serve(run_x)

    per_request = 12
    if launches != per_request * len(requests):
        raise AssertionError(f"attention_fwd launched {launches} times for "
                             f"{len(requests)} requests, expected "
                             f"{per_request} each")
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


def profile_request(torch, run, request, top: int = 12):
    """One request under torch.profiler: device busy time by kernel, and the
    device's idle share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*request)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    kernels.sort(key=lambda x: -x[1])
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if kernels else None,
           "top": [[name[:90], ms, n] for name, ms, n in kernels[:top]]}
    print(json.dumps({"profile": out}), flush=True)


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

    t0 = time.perf_counter()
    log = build("attention_fwd")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"  attention_fwd: {line.strip()}", flush=True)

    rows = check_attention(torch, peak_flops, peak_bytes)

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (FRAMES, 4, 192, 256)
    requests = [tuple(torch.randint(-300, 300, shape, generator=gen,
                                    device="cuda", dtype=torch.int16)
                      for _ in range(4)) for _ in range(REQUESTS)]
    sl, run = serve_slice(torch, requests, smi)
    profile_request(torch, run, requests[0])

    # per request: 4 launches at each shape
    total = {key: 4 * sum(r[key] for r in rows)
             for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "hupr_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "hupr_tpu/ops/attention.py:90",
        "launches": sl["attention_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in rows) else "bytes",
        "library_ms": total["library_ms"],
        "per": "one request: 12 launches, 4 at each (N, C) of "
               "(256, 256), (1024, 128), (4096, 64), B=32"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
