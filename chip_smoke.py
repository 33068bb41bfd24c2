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
   forward's log-sum-exp at B=20 as trained, the forward at B=1 as
   streamed, in modes f32 and bf16), and times kernel, plain version and
   the library call that computes the same function.
4. Serves requests of 32 raw int16 ADC frames per radar view through
   make_e2e_infer at the flagship width (config/mscsa_prgcn_tpu.yaml:
   numFilters 32, 64x64 maps, 8-frame windows, MODEL.attention pallas),
   with seeded synthetic weights; checks the launch counts, the output
   shapes and finiteness, and the agreement with the same requests served
   through the plain attention (MODEL.attention xla).
5. Trains the flagship recipe (batch 20, Adam at lr 1e-4) for a few steps
   of bench.py's synthetic batch, driven as Runner.train drives its train
   step, through the kernels and, from the same weights, through the plain
   attention; checks the launch counts, finite losses, and that the first
   step's gradients of the attention projections, the losses, the weights
   and the BN statistics agree between the two; profiles one step of each.
6. The bfloat16 modes of both kernels (bfloat16 inputs; bfloat16 operands
   on float32 inputs; bfloat16 operands on bfloat16 inputs) against their
   plain twins and the float32 ideal at the three path shapes, on three
   draws of inputs each (the backward called twice on each, bit-identical),
   timed beside the twins and SDPA in bfloat16, with the backward's time
   split between its two passes.
7. The fast config (config/mscsa_prgcn_tpu_fast.yaml: MODEL.computeDtype
   bfloat16) served and trained as in 4 and 5, against its eager attention
   and against the float32 slice from the same weights; profiles of both.
8. MODEL.attention pallas_bf16: two requests and one train step in each
   compute dtype, launching the bfloat16-operand modes on the model's path;
   the step held against the same step through the eager attention.
9. The port's attention microbenchmark (hupr_tpu_torch.scripts.
   attn_microbench) at (32, 4096, 64), which drives the unfolded forward,
   after that kernel is held against its twin in both modes (float32 at
   ATTN_TOL and REL_F32_FWD, f32_bf16ops at the bf16 bars), bit-identical
   on a second call.
10. The Runner (hupr_tpu_torch.main.run, the CLI's flow) on the flagship
   recipe over one synthetic sequence of 64 full-size frames: two epochs of
   training with sequence-mode val eval, through the kernels and through
   the plain attention from the same checkpoint.pth, held together (losses,
   weights, each leaf's update from the checkpoint); the kernel path's eval against the plain path's and sequence eval against
   classic eval on the same weights; the resume from model_best.pth and
   checkpoint.pth; the train loop's, the loader's and both eval paths'
   rates, and a profile of one epoch's train loop.
11. Streaming (engine/streaming.StreamingPoseEstimator), run before any
   profiler, in the flagship (float32) and fast (bfloat16) configs: one
   sequence of 32 raw int16 frames per view through the CUDA graph step,
   held against make_e2e_infer on the same frames (the lag and the flush
   applied) and against the eager step; stream_latency_ms of the graph and
   the eager step as bench.py times it. Near the end, under the profiler:
   a frame of each (the host's launch calls, the card's kernels) and the
   sequence again, where the card's trace must show the 12 forward
   attention kernels in every replayed frame (a replay calls no wrapper,
   so the wrappers count only the eager steps and the capture).
12. The fast recipe's Runner (fast_training_config(): chunk-mode training
   from raw ADC, raw-ADC sequence eval, bfloat16) through main.run over
   one synthetic sequence of 64 raw captures: two epochs with no fallback
   notice, 12 forward and 12 backward launches a step; in float32 from the
   same weights, the raw-ADC chunk step against the cube chunk step and
   the chunk step against the classic step on the same windows, and three
   planted faults the first hold must catch; the chunk-mode epoch's rate
   (median of 8 epochs after a warm-up one) and raw-ADC eval's.
13. Prints the `kernels` line (every kernel and mode), then ends with one
   JSON line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# hupr_tpu_torch/csrc/*.cu
KERNELS = ("attention_fwd", "attention_bwd", "attention_fwd_unfolded")
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
# and each float32 gradient's relative norm error against the plain version,
# which tells 3xTF32 from one TF32 product: the CPU model of the kernel's
# arithmetic (tests/test_torch_tf32.py) reads at most 9.3e-7 in 3xTF32 and
# at least 4.1e-4 in one TF32 product, at two of the model's shapes; the
# bar is 16x over the first (the card's sums run in another order, and
# its tensor cores may not round their float32 sums to nearest) and 27x
# under the second
REL_F32_BWD = 2.0 ** -16
# the float32 forward's output against the plain version, the same way: the
# CPU model of its 3xTF32 arithmetic (tests/test_torch_tf32.py) reads at
# most 7.3e-7 on logits of unit spread and 2.6e-6 on N(0, 1) inputs (a
# nearly one-hot softmax, as check_attention draws them), and at least
# 3.95e-4 in one TF32 product; the bar is 6x over the worst of the first and
# 26x under the second. It holds the unfolded forward too, whose 3xTF32
# model reads at most 7.3e-7 and 2.6e-6 the same ways, and one TF32 product
# at least 4.1e-4
REL_F32_FWD = 2.0 ** -16
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# kernel path vs plain-attention path over the train steps: the weights
# within the bars of tests/test_reference_parity.py in both compute dtypes
PARAM_ATOL, PARAM_RTOL = 7e-4, 1e-3
# In bfloat16 the two paths' activations differ by about 0.5 % (any two
# implementations do: each rounding to bfloat16 that lands the other way
# spreads through the layers), so a ReLU whose input sits that close to 0
# takes one branch in one path and the other in the other. At the first
# step both paths hold the same weights, so a weight whose gradient is
# exactly 0 in one path and not in the other sits behind such a branch.
# Adam (its L2 term moves even a weight with no gradient by about lr a
# step) can then move it by about lr a step one way in one path and the
# other way in the other: up to 10 lr apart after 5 steps, past PARAM_ATOL,
# however right both paths are. So every weight is held to the bars above
# after the first step, and every weight but those branch flips after the
# last; the flips are counted, and their count is held to BRANCH_FLIPS_MAX:
# 88 to 93 of 35.5M weights on the H100 with the bf16 fast recipe on
# bench.py's batch (two versions of the kernels), twice the most. A fault
# that moves the activations by more than bfloat16's noise flips many more.
BRANCH_FLIPS_MAX = 186
# (N, C) of the 12 attention calls per forward: 4 at each MSCSA scale
ATTN_SHAPES = ((256, 256), (1024, 128), (4096, 64))
# the bfloat16 modes: (name, input dtype, bf16_ops)
BF16_MODES = (("bf16", "bfloat16", False), ("f32_bf16ops", "float32", True),
              ("bf16_bf16ops", "bfloat16", True))
# bfloat16 bars, relative norm errors (bfloat16 rounds to 2^-9 relative):
# kernel vs the float32 ideal on the same values 2^-8.5 (the bar of
# tests/test_attention.py for bfloat16 gradients); kernel vs its twin 2^-7.5
# (each within 2^-8.5 of the ideal; they round p against other maxima)
REL_IDEAL, REL_TWIN = 2.0 ** -8.5, 2.0 ** -7.5
# The backward and its twin share every rounding point and the forward's out
# and lse; they differ only where a float32 sum in another order lands on
# the other side of a bfloat16 rounding boundary (<= 3.6e-5 relative on the
# H100). Moving one rounding point (p, dS or D rounded or not) moves the
# twin by more (tests/test_torch_bf16.py::test_bwd_twin_bar_sees_rounding).
REL_TWIN_BWD = 2.0 ** -12
# independent inputs per (mode, shape) for the bfloat16 error readings: a
# relative norm error over >= 1.3M roundings varies by about 1 % from draw
# to draw, so the worst of three sits where the bar expects it
DRAWS = 3
# bfloat16 serving against the eager attention in bfloat16, which rounds its
# softmax to bfloat16 where the kernels keep it float32
MAXVAL_TOL_BF16 = 1e-2
# Train steps, kernel path vs eager path in the same compute dtype, per
# dtype: the loss per step (relative), the BN running statistics (atol,
# rtol) and the gradients of the decoder's 24 attention projections at the
# first step, from the same weights (relative norm error). Those weights
# get their gradient only through the attention's dk and dq, so the last
# bar holds the backward kernel on the model's path, where a wrong dk or dq
# reads O(1); Adam moves each weight by about lr whatever its gradient, so
# losses and weights cannot. float32: the bars of
# tests/test_reference_parity.py; the projections read 6.8e-5 on the H100
# (float32 sums in another order, over many cancelling terms): bar 1e-3.
# bfloat16: the paths round at other points (the eager softmax), so losses
# read 1.0e-4 and 6.4e-5 after 5 steps on the H100: bar 5x the worst; the
# statistics at the bar of tests/test_torch_bf16.py (they average bfloat16
# activations); the projections read 3.3e-3 to 9.0e-3 in the three bf16
# modes on the H100: bar 2^-4.
TRAIN_BARS = {"f32": {"loss_rtol": 2e-4, "stats": (7e-4, 1e-3),
                      "proj_grad_rel": 1e-3},
              "bf16": {"loss_rtol": 5e-4, "stats": (5e-3, 2e-2),
                       "proj_grad_rel": 2.0 ** -4}}
# bfloat16 against float32 from the same weights: the JAX package's own
# bars (tests/test_bf16_compute.py)
HEATMAP_TOL_VS_F32, DECODE_AGREE_VS_F32 = 0.05, 0.75
MICRO_SHAPE = (32, 4096, 64)   # the JAX microbenchmark's default
# the runner phase: one synthetic sequence of full-size frames
# (bench.py's _bench_seq_eval duration), trained for two epochs
RUNNER_FRAMES, RUNNER_EPOCHS = 64, 2
# AP and its stats, kernel path vs plain path and sequence vs classic eval:
# tests/test_golden_ap.py's protocol tier
PROTOCOL_ATOL = 5e-3
# Each leaf's update over the runner's train steps (final weights or BN
# statistics less the seeded checkpoint's), kernel path vs plain path, in
# L2 norm relative to the plain path's update. RUNNER_EPOCHS x 4 Adam steps
# at lr 1e-4 move a weight by about 8e-4, at or below PARAM_ATOL + rtol, so
# the weights bar alone would pass a leaf left untrained (it reads 1 here).
RUNNER_UPDATE_RTOL = 5e-2
# runner_fast's chunk-mode epochs timed one by one after a warm-up epoch
FAST_TIMED_EPOCHS = 8

# the stream phase: one sequence of raw frames per view (bench.py's
# request), then stream_latency_ms as bench.py times it (3 warm-up frames,
# 20 timed)
STREAM_FRAMES, STREAM_WARM, STREAM_TIMED = 32, 3, 20
# keypoints decoded to the same bin as make_e2e_infer's on the same frames:
# the stream runs each window at B=1, the batch path at B=32, so the card's
# sums run in other orders and a near-tied argmax may flip
STREAM_AGREE = {"f32": 0.99, "bf16": 0.95}

# Peaks of each H100 variant at its full power limit, dense: float32
# FMA-pipe, bfloat16 and TF32 tensor-core flop/s and the memory rate
# (NVIDIA's data sheet); the SFU's exp rate, 16 a clock per SM (CUDA
# programming guide, arithmetic throughput, compute capability 9.0) x SMs x
# boost clock
PEAKS = {"PCIe": {"f32": 51.2e12, "bf16": 756e12, "tf32": 378e12,
                  "bytes": 2.0e12, "sfu": 16 * 114 * 1.755e9},
         "NVL": {"f32": 60.0e12, "bf16": 835e12, "tf32": 417.5e12,
                 "bytes": 3.9e12, "sfu": 16 * 132 * 1.785e9},
         "SXM": {"f32": 66.9e12, "bf16": 989e12, "tf32": 495e12,
                 "bytes": 3.35e12, "sfu": 16 * 132 * 1.98e9}}


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


def sdpa(q, k, m):
    """The library yardstick: F.scaled_dot_product_attention with query q,
    key k, value m and no scale, on (B, 1, N, C) views of the (B, N, C)
    tensors (one head; a 3-D call takes SDPA's math backend), returned as
    (B, N, C)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q[:, None], k[:, None], m[:, None],
                                          scale=1.0)[:, 0]


def product_route(a: str, b: str, peaks):
    """(pipe, seconds per flop) of one product of operands of precisions a
    and b ("f32" or "bf16") at the cheapest route that keeps them: two
    bfloat16 operands one tensor-core product; a float32 operand against a
    bfloat16 one two bfloat16 products (the float32 side split into hi and
    lo terms) or the FMA pipe; two float32 operands three TF32 products
    (3xTF32) or the FMA pipe, whichever is faster."""
    fma = 1 / peaks["f32"]
    if a == b == "bf16":
        return "tensor", 1 / peaks["bf16"]
    tensor = 2 / peaks["bf16"] if "bf16" in (a, b) else 3 / peaks["tf32"]
    return ("tensor", tensor) if tensor <= fma else ("fma", fma)


def attention_bound(kind: str, b: int, n: int, c: int, mode: str, peaks,
                    lse: bool = False):
    """(bound ms, bound_by) of one attention call in `mode`: the larger of
    the bytes term (each input read once, each output written once, at the
    memory rate) and the operations term, the slowest of the pipes the work
    needs, which run side by side: the tensor cores, the float32 FMA pipes
    and the SFU for the B*N^2 exps. Each product of 2*B*N^2*C flops goes
    to its cheapest route (product_route). `kind` is "fwd" or "unfolded"
    (logits, p.m) or "bwd" (logits, dP, then dq, dk, dm). The logits and dP
    take the mode's input operands (bfloat16 but in mode f32); p and dS are
    float32 but under bf16_ops."""
    product = 2 * b * n * n * c
    ops = "bf16" if mode.endswith("bf16ops") else "f32"
    ins = "f32" if mode == "f32" else "bf16"
    pairs = [(ins, ins), (ops, ins)] if kind != "bwd" \
        else [(ins, ins)] * 2 + [(ops, ins)] * 3
    terms = {"tensor": 0.0, "fma": 0.0, "sfu": b * n * n / peaks["sfu"]}
    for pair in pairs:
        pipe, per_flop = product_route(*pair, peaks)
        terms[pipe] += product * per_flop
    size = 2 if mode.startswith("bf16") else 4
    if kind == "bwd":     # k, q, m, out, g and lse read; dk, dq, dm written
        nbytes = 8 * b * n * c * size + 4 * b * n
    else:                 # k, q, m read; out (and lse) written
        nbytes = 4 * b * n * c * size + (4 * b * n if lse else 0)
    terms["bytes"] = nbytes / peaks["bytes"]
    worst = max(terms, key=terms.get)
    return 1e3 * terms[worst], "bytes" if worst == "bytes" else "operations"


def check_attention(torch, peaks):
    """Kernel (float32: 3xTF32 on the tensor cores) vs plain version at the
    three path shapes, at ATTN_TOL and REL_F32_FWD, bit-identical on a
    second call; returns per-shape results."""
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
            again = attention_fwd(k, q, m)
            want = attention_plain(k, q, m)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = rel_err(got, want)
            repeats = torch.equal(got, again)
            kernel_ms = cuda_ms(torch, lambda: attention_fwd(k, q, m), 10)
            plain_ms = cuda_ms(torch, lambda: attention_plain(k, q, m), 5)
            library_ms = cuda_ms(torch, lambda: sdpa(q, k, m), 10)
        flops = attention_flops(ATTN_BATCH, n, c)
        bound_ms, bound_by = attention_bound("fwd", ATTN_BATCH, n, c, "f32",
                                             peaks)
        row = {"kernel": "attention_fwd", "mode": "f32", "B": ATTN_BATCH,
               "N": n, "C": c,
               "max_abs_err": err, "rel_err": rel,
               "repeats_bit_for_bit": repeats, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "tflops": flops / kernel_ms / 1e9}
        print(json.dumps(row), flush=True)
        if not (err <= ATTN_TOL and rel <= REL_F32_FWD):
            raise AssertionError(f"attention_fwd at N={n}, C={c}: max abs "
                                 f"error {err} > {ATTN_TOL} or relative "
                                 f"error {rel} > {REL_F32_FWD}")
        if not repeats:
            raise AssertionError(f"attention_fwd at N={n}, C={c}: two calls "
                                 f"gave different bits")
        rows.append(row)
        del k, q, m, got, again, want
    return rows


def allclose_excess(a, b, atol, rtol) -> float:
    """max(|a - b| - (atol + rtol |b|)): <= 0 where torch.allclose holds."""
    return ((a - b).abs() - (atol + rtol * b.abs())).max().item()


def check_attention_bwd(torch, peaks):
    """Backward kernel (float32: 3xTF32 on the tensor cores) vs plain
    version, at the bar of tests/test_attention.py and at REL_F32_BWD per
    gradient, bit-identical on a second call; and the forward's log-sum-exp
    vs torch.logsumexp; at the three path shapes with the training batch.
    Returns per-shape results."""
    from hupr_tpu_torch.ops.attention import (BWD_MATMULS, attention_bwd,
                                              attention_bwd_plain,
                                              attention_fwd, attention_plain)
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
            again = attention_bwd(k, q, m, out, lse, g)
            repeats = all(torch.equal(a, w) for a, w in zip(got, again))
            del again
            want = attention_bwd_plain(k, q, m, out, lse, g)
            torch.cuda.synchronize()
            errs = {name: (a - w).abs().max().item()
                    for name, a, w in zip(("dk", "dq", "dm"), got, want)}
            rels = {name: rel_err(a, w)
                    for name, a, w in zip(("dk", "dq", "dm"), got, want)}
            scale = {name: w.abs().max().item()
                     for name, w in zip(("dk", "dq", "dm"), want)}
            excess = max(allclose_excess(a, w, GRAD_ATOL, GRAD_RTOL)
                         for a, w in zip(got, want))
            del got, want
            kernel_ms = cuda_ms(torch, lambda: attention_bwd(
                k, q, m, out, lse, g), 10)
            # the forward as training launches it, with the LSE store, its
            # plain version with the LSE, and SDPA's forward at this batch
            fwd_lse_ms = cuda_ms(torch, lambda: attention_fwd(
                k, q, m, with_lse=True), 10)
            fwd_lse_plain_ms = cuda_ms(torch, lambda: attention_plain(
                k, q, m, with_lse=True), 5)
            fwd_lse_library_ms = cuda_ms(torch, lambda: sdpa(q, k, m), 10)
            plain_ms = cuda_ms(torch, lambda: attention_bwd_plain(
                k, q, m, out, lse, g), 5)
        # the library's backward alone: SDPA (query q, key k, value m, no
        # scale) differentiated with its graph kept between calls
        with float32_math():
            qs, ks, ms_ = (x.clone().requires_grad_(True) for x in (q, k, m))
            o = sdpa(qs, ks, ms_)
            library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                o, (qs, ks, ms_), g, retain_graph=True), 10)
            del o, qs, ks, ms_
        flops = 2 * b * n * n * c * BWD_MATMULS
        bound_ms, bound_by = attention_bound("bwd", b, n, c, "f32", peaks)
        row = {"kernel": "attention_bwd", "mode": "f32", "B": b, "N": n,
               "C": c,
               "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
               "max_abs_by_grad": scale,
               "allclose_excess": excess, "rel_err_by_grad": rels,
               "rel_err": max(rels.values()),
               "repeats_bit_for_bit": repeats, "lse_max_abs_err": lse_err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "fwd_with_lse_ms": fwd_lse_ms,
               "fwd_with_lse_plain_ms": fwd_lse_plain_ms,
               "fwd_with_lse_library_ms": fwd_lse_library_ms,
               "fwd_with_lse_bound_ms": attention_bound(
                   "fwd", b, n, c, "f32", peaks, lse=True)[0],
               "bound_by": bound_by,
               "tflops": flops / kernel_ms / 1e9}
        print(json.dumps(row), flush=True)
        if not excess <= 0:
            raise AssertionError(f"attention_bwd at N={n}, C={c}: errors "
                                 f"{errs} exceed atol {GRAD_ATOL} + rtol "
                                 f"{GRAD_RTOL}")
        if not row["rel_err"] <= REL_F32_BWD:
            raise AssertionError(f"attention_bwd at N={n}, C={c}: relative "
                                 f"errors {rels} exceed {REL_F32_BWD}")
        if not repeats:
            raise AssertionError(f"attention_bwd at N={n}, C={c}: two calls "
                                 f"gave different bits")
        if not lse_excess <= 0:
            raise AssertionError(f"attention_fwd's lse at N={n}, C={c}: max "
                                 f"abs error {lse_err}")
        rows.append(row)
        del k, q, m, g, out, lse
    return rows


def unit_spread(torch, gen, shape, dtype, count):
    """`count` N(0, 1) tensors on the card, the first two (k and q) scaled
    by C^-1/4 so that the logits have unit spread, cast to `dtype`."""
    c = shape[-1]
    ts = [torch.randn(shape, generator=gen, device="cuda")
          for _ in range(count)]
    ts[0], ts[1] = ts[0] * c ** -0.25, ts[1] * c ** -0.25
    return [t.to(dtype) for t in ts]


def rel_err(a, w) -> float:
    """Relative norm error of a against w, in float32."""
    a, w = a.float(), w.float()
    return ((a - w).norm() / w.norm()).item()


def operand_values(torch, ts, bf16_ops):
    """The float32 values a mode computes with: rounded to bfloat16 under
    bf16_ops."""
    return [(t.to(torch.bfloat16) if bf16_ops else t).float() for t in ts]


def check_bf16_rel(what, errs, twin_bar=REL_TWIN):
    """Raise unless every error is within its bar."""
    if not (errs["rel_err_vs_twin"] <= twin_bar
            and errs["rel_err_vs_ideal"] <= REL_IDEAL):
        raise AssertionError(f"{what}: relative errors {errs} exceed "
                             f"{twin_bar} (twin) or {REL_IDEAL} (ideal)")


def worst_of(draws):
    """Each error's largest value over the draws (other keys from the
    first), and the ideal's error per draw."""
    out = dict(draws[0])
    for key in ("max_abs_err", "rel_err_vs_twin", "rel_err_vs_ideal",
                "lse_max_abs_err"):
        if key in out:
            out[key] = max(d[key] for d in draws)
    if "rel_err_vs_twin_by_grad" in out:
        out["rel_err_vs_twin_by_grad"] = {
            name: max(d["rel_err_vs_twin_by_grad"][name] for d in draws)
            for name in out["rel_err_vs_twin_by_grad"]}
    out["rel_err_vs_ideal_by_draw"] = [d["rel_err_vs_ideal"] for d in draws]
    return out


def check_attention_modes(torch, peaks):
    """Both kernels in each bfloat16 mode against their plain twins (the
    same rounding points, the working dtype) and the float32 ideal on the
    mode's values, at the three path shapes: the forward at B=32 as served,
    the forward with its LSE and the backward at B=20 as trained. Times
    kernel, twin, and SDPA in bfloat16 (its backward for the backward).
    Returns per-(mode, shape) results."""
    from hupr_tpu_torch.ops.attention import (BWD_MATMULS, attention_bwd,
                                              attention_bwd_plain,
                                              attention_flops, attention_fwd,
                                              attention_plain)
    from hupr_tpu_torch.utils.device import float32_math

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16 = torch.bfloat16
    rows = []
    for mode, dtype_name, ops in BF16_MODES:
        dtype = getattr(torch, dtype_name)
        for n, c in ATTN_SHAPES:
            # serving: the forward at B=32, held on DRAWS inputs; the last
            # is timed
            draws = []
            for _ in range(DRAWS):
                k, q, m = unit_spread(torch, gen, (ATTN_BATCH, n, c), dtype,
                                      3)
                with torch.inference_mode(), float32_math():
                    got = attention_fwd(k, q, m, bf16_ops=ops)
                    want = attention_plain(k, q, m, bf16_ops=ops)
                    ideal = attention_plain(*operand_values(torch, (k, q, m),
                                                            ops))
                    draws.append({"dtype": str(got.dtype),
                                  "max_abs_err": (got.float() - want.float())
                                  .abs().max().item(),
                                  "rel_err_vs_twin": rel_err(got, want),
                                  "rel_err_vs_ideal": rel_err(got, ideal)})
                    del got, want, ideal
            fwd = worst_of(draws)
            kb, qb, mb = (t.to(bf16) for t in (k, q, m))
            with torch.inference_mode(), float32_math():
                fwd["kernel_ms"] = cuda_ms(torch, lambda: attention_fwd(
                    k, q, m, bf16_ops=ops), 10)
                fwd["plain_ms"] = cuda_ms(torch, lambda: attention_plain(
                    k, q, m, bf16_ops=ops), 5)
                fwd["library_ms"] = cuda_ms(torch, lambda: sdpa(qb, kb, mb),
                                            10)
            fwd["bound_ms"], fwd["bound_by"] = attention_bound(
                "fwd", ATTN_BATCH, n, c, mode, peaks)
            fwd["tflops"] = attention_flops(ATTN_BATCH, n, c) \
                / fwd["kernel_ms"] / 1e9
            del k, q, m, kb, qb, mb

            # training: the forward with its LSE and the backward at B=20,
            # held on DRAWS inputs; the last is timed
            b = TRAIN_BATCH
            draws = []
            for _ in range(DRAWS):
                k, q, m, g = unit_spread(torch, gen, (b, n, c), dtype, 4)
                with torch.inference_mode(), float32_math():
                    out, lse = attention_fwd(k, q, m, with_lse=True,
                                             bf16_ops=ops)
                    vals = operand_values(torch, (k, q, m, g), ops)
                    ideal_out, ideal_lse = attention_plain(*vals[:3],
                                                           with_lse=True)
                    got = attention_bwd(k, q, m, out, lse, g, bf16_ops=ops)
                    again = attention_bwd(k, q, m, out, lse, g, bf16_ops=ops)
                    repeats = all(torch.equal(a, w)
                                  for a, w in zip(got, again))
                    del again
                    want = attention_bwd_plain(k, q, m, out, lse, g, ops)
                    ideal = attention_bwd_plain(*vals[:3], ideal_out,
                                                ideal_lse, vals[3])
                    draws.append({
                        "dtypes": [str(t.dtype) for t in got],
                        "lse_dtype": str(lse.dtype),
                        "repeats_bit_for_bit": repeats,
                        "lse_max_abs_err": (lse - ideal_lse).abs().max()
                        .item(),
                        "max_abs_err": max((a.float() - w.float()).abs()
                                           .max().item()
                                           for a, w in zip(got, want)),
                        "rel_err_vs_twin": max(rel_err(a, w)
                                               for a, w in zip(got, want)),
                        "rel_err_vs_twin_by_grad": {
                            name: rel_err(a, w) for name, a, w in zip(
                                ("dk", "dq", "dm"), got, want)},
                        "rel_err_vs_ideal": max(rel_err(a, i)
                                                for a, i in zip(got, ideal))})
                    del got, want, ideal, vals, ideal_out, ideal_lse
            bwd = worst_of(draws)
            kb, qb, mb, gb = (t.to(bf16) for t in (k, q, m, g))
            with torch.inference_mode(), float32_math():
                bwd["kernel_ms"] = cuda_ms(torch, lambda: attention_bwd(
                    k, q, m, out, lse, g, bf16_ops=ops), 10)
                bwd["plain_ms"] = cuda_ms(torch, lambda: attention_bwd_plain(
                    k, q, m, out, lse, g, ops), 5)
                with_lse = {
                    "kernel_ms": cuda_ms(torch, lambda: attention_fwd(
                        k, q, m, with_lse=True, bf16_ops=ops), 10),
                    "plain_ms": cuda_ms(torch, lambda: attention_plain(
                        k, q, m, True, ops), 5),
                    "library_ms": cuda_ms(torch, lambda: sdpa(qb, kb, mb),
                                          10)}
            with float32_math():
                qs, ks, ms_ = (x.clone().requires_grad_(True)
                               for x in (qb, kb, mb))
                o = sdpa(qs, ks, ms_)
                bwd["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
                    o, (qs, ks, ms_), gb, retain_graph=True), 10)
                del o, qs, ks, ms_
            bwd["bound_ms"], bwd["bound_by"] = attention_bound(
                "bwd", b, n, c, mode, peaks)
            bwd["tflops"] = 2 * b * n * n * c * BWD_MATMULS \
                / bwd["kernel_ms"] / 1e9
            with_lse["bound_ms"], with_lse["bound_by"] = attention_bound(
                "fwd", b, n, c, mode, peaks, lse=True)
            row = {"kernel": "attention", "mode": mode, "N": n, "C": c,
                   "fwd_B32": fwd, "fwd_with_lse_B20": with_lse,
                   "bwd_B20": bwd}
            print(json.dumps(row), flush=True)
            del k, q, m, g, kb, qb, mb, gb, out, lse
            check_bf16_rel(f"attention_fwd {mode} N={n} C={c}", fwd)
            check_bf16_rel(f"attention_bwd {mode} N={n} C={c}", bwd,
                           REL_TWIN_BWD)
            if fwd["dtype"] != str(dtype) or bwd["dtypes"] != [str(dtype)] * 3:
                raise AssertionError(f"{mode}: output dtypes {fwd['dtype']}, "
                                     f"{bwd['dtypes']}, expected {dtype}")
            if not all(d["repeats_bit_for_bit"] for d in draws):
                raise AssertionError(f"attention_bwd {mode} N={n} C={c}: two "
                                     f"calls gave different bits")
            if bwd["lse_dtype"] != "torch.float32" or \
                    not bwd["lse_max_abs_err"] <= LSE_ATOL:
                raise AssertionError(f"{mode} LSE: {bwd['lse_dtype']}, max "
                                     f"abs error {bwd['lse_max_abs_err']}")
            rows.append(row)
    return rows


def decode_vs(outs, ref):
    """(max |maxvals - ref maxvals|, share of keypoints decoded to the same
    bin) over paired serving outputs."""
    import numpy as np

    err = max((mv - mr).abs().max().item()
              for (_, mv), (_, mr) in zip(outs, ref))
    agree = np.mean([(p == pr).all(dim=-1).float().mean().item()
                     for (p, _), (pr, _) in zip(outs, ref)])
    return err, float(agree)


def serve_slice(torch, requests, card: str, cfg=None, label: str = "slice",
                mode: str = "f32", maxval_tol: float = MAXVAL_TOL,
                vs_f32=None):
    """Serve `requests` through `cfg` (the flagship config by default) with
    the kernel, then through the eager attention in the same compute dtype;
    with `vs_f32`, also against the float32 slice's outputs. Returns the
    slice's results, the kernel path's run and its outputs."""
    import copy

    import numpy as np

    from hupr_tpu_torch.config import flagship_serving_config
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    cfg = cfg or flagship_serving_config()
    if cfg.MODEL.attention != "pallas":
        raise AssertionError("the serving config runs the kernel")
    model = build_model(cfg)
    # N(0, 0.03) keeps the flagship's heatmap peaks spread out: at 0.05 the
    # PRGCN's sums over 1024 nodes saturate the sigmoid at 1 everywhere
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    ds = cfg.DATASET
    run = make_e2e_infer(model, state, ds.radar_params(), duration=FRAMES,
                         group=ds.numGroupFrames, num_frames=ds.numFrames)
    cfg_x = copy.deepcopy(cfg)
    cfg_x.MODEL.attention = "xla"
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
    attention.reset_launch_counts()
    outs, elapsed = serve(run)
    launches = attention.attention_fwd.launches
    by_mode = dict(attention.attention_fwd.launches_by_mode)
    bwd_launches = attention.attention_bwd.launches
    outs_x, elapsed_x2 = serve(run_x)

    per_request = 12
    if by_mode != {mode: per_request * len(requests)} or bwd_launches != 0:
        raise AssertionError(f"serving launched attention_fwd {by_mode} and "
                             f"attention_bwd {bwd_launches} times for "
                             f"{len(requests)} requests, expected "
                             f"{per_request} each in mode {mode} and 0")
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
              "compute_dtype": cfg.MODEL.computeDtype,
              "seconds": elapsed,
              "frames_per_s": frames / elapsed,
              "frames_per_s_xla": [frames / elapsed_x1, frames / elapsed_x2],
              "attention_launches": launches,
              "attention_launches_by_mode": by_mode,
              "maxvals_max_abs_err_vs_xla": maxval_err,
              "pred2d_identical_share_vs_xla": float(same)}
    if vs_f32 is not None:
        err, agree = decode_vs(outs, vs_f32)
        result["maxvals_max_abs_err_vs_f32"] = err
        result["keypoint_agreement_vs_f32"] = agree
    print(json.dumps({label: result}), flush=True)
    if not maxval_err <= maxval_tol:
        raise AssertionError(f"maxvals differ from the plain-attention "
                             f"path by {maxval_err} > {maxval_tol}")
    if vs_f32 is not None and not (
            result["maxvals_max_abs_err_vs_f32"] <= HEATMAP_TOL_VS_F32
            and result["keypoint_agreement_vs_f32"] >= DECODE_AGREE_VS_F32):
        raise AssertionError(f"{label} against the float32 slice: maxvals "
                             f"within {result['maxvals_max_abs_err_vs_f32']},"
                             f" agreement "
                             f"{result['keypoint_agreement_vs_f32']}")
    return result, run, outs


def kernel_times(torch, prof):
    """(kernel name, device ms, calls) of each CUDA kernel a torch.profiler
    run saw, the longest first."""
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    return sorted(kernels, key=lambda x: -x[1])


def device_busy_ms(torch, prof) -> float:
    """The time the device was busy in a torch.profiler run: the union of
    its events' spans, so that work that overlaps on two streams counts
    once."""
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us / 1e3


def profile(torch, path: str, fn, top: int = 12):
    """One call of fn under torch.profiler: device time by kernel, the time
    the device was busy (the union of its events' spans, so that work that
    overlaps on two streams counts once), and the device's idle share of
    the call's wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = kernel_times(torch, prof)
    busy_ms = device_busy_ms(torch, prof)
    out = {"path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "kernel_ms_total": sum(ms for _, ms, _ in kernels),
           "idle_share": (1 - busy_ms / wall_ms) if kernels else None,
           "top": [[name[:90], ms, n] for name, ms, n in kernels[:top]]}
    print(json.dumps({"profile": out}), flush=True)


def bench_batch(torch, cfg):
    """bench.py's batch: N(0, 1) windows per view, joints uniform in
    (20, 230), made on the card from a seed."""
    t, ds = cfg.TRAINING, cfg.DATASET
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (t.batchSize, ds.numGroupFrames, ds.numFrames, 2, ds.rangeSize,
             ds.azimuthSize, ds.elevationSize)
    return {"hori": torch.randn(shape, generator=gen, device="cuda"),
            "vert": torch.randn(shape, generator=gen, device="cuda"),
            "jointsGroup": 20 + 210 * torch.rand(
                (t.batchSize, ds.numKeypoints, 2), generator=gen,
                device="cuda", dtype=torch.float64)}


def projection_grads(torch, model):
    """The gradients of the decoder's 24 attention projections (phi_*,
    theta_*), one flat float32 tensor: they reach those weights only
    through the attention's dk and dq."""
    from hupr_tpu_torch.models.mscsa import PROJECTIONS

    dec = model.radarDecoder
    return torch.cat([conv.weight.grad.flatten() for name in PROJECTIONS
                      for conv in getattr(dec, name)])


def train_slice(torch, card: str, make_cfg=None, label: str = "train",
                mode: str = "f32"):
    """The training step of `make_cfg()` (the flagship recipe by default)
    through the kernels in `mode` and, from the same weights, through the
    eager attention in the same compute dtype, on bench.py's batch: the
    projections' gradients and every weight at the first step, then the
    losses, the weights (but the first step's branch flips, which are
    counted: see PARAM_ATOL) and BN statistics after the timed steps, at
    TRAIN_BARS[mode] and the weights' bars; returns the
    slice's results and, for each path, a function that takes one more
    step."""
    from hupr_tpu_torch.config import flagship_training_config
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    make_cfg = make_cfg or flagship_training_config
    cfg, cfg_x = make_cfg(), make_cfg()
    if cfg.MODEL.attention != "pallas":
        raise AssertionError("the training config runs the kernels")
    cfg_x.MODEL.attention = "xla"
    t, ds = cfg.TRAINING, cfg.DATASET
    if t.batchSize != TRAIN_BATCH:
        raise AssertionError(f"flagship batch {t.batchSize}")
    geometry = (ds.numKeypoints, ds.heatmapSize, ds.imgSize)
    batch = bench_batch(torch, cfg)

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

    def flat_params(p):
        return torch.cat([v.detach().flatten()
                          for v in p["state"].model.parameters()])

    grads, zero, first = {}, {}, {}
    for name in ("pallas", "xla"):          # warm-up: cuDNN plans, caches
        drive(paths[name], 1)
        model = paths[name]["state"].model
        grads[name] = projection_grads(torch, model)
        # which weights got an exactly-zero gradient at the first step
        zero[name] = torch.cat([(prm.grad == 0).flatten()
                                for prm in model.parameters()])
        first[name] = flat_params(paths[name])
    grad_rel = rel_err(grads["pallas"], grads["xla"])
    # every weight after the first step, both paths from the same weights
    first_excess = allclose_excess(first["pallas"], first["xla"],
                                   PARAM_ATOL, PARAM_RTOL)
    first_err = (first["pallas"] - first["xla"]).abs().max().item()
    # weights behind a branch the two paths took apart (see PARAM_ATOL)
    branch_flips = zero["pallas"] != zero["xla"] if mode != "f32" \
        else torch.zeros_like(zero["pallas"])
    del grads, zero, first
    timing = {}
    # in turns on one card: the kernel path, then the plain attention
    for name in ("pallas", "xla"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attention.reset_launch_counts()
        t0 = time.perf_counter()
        drive(paths[name], TRAIN_STEPS)
        torch.cuda.synchronize()
        timing[name] = {
            "seconds": time.perf_counter() - t0,
            "launches": (attention.attention_fwd.launches,
                         attention.attention_bwd.launches),
            "by_mode": (dict(attention.attention_fwd.launches_by_mode),
                        dict(attention.attention_bwd.launches_by_mode)),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}

    want = {mode: 12 * TRAIN_STEPS}
    if timing["pallas"]["by_mode"] != (want, want) or \
            timing["xla"]["launches"] != (0, 0):
        raise AssertionError(f"train steps launched (attention_fwd, "
                             f"attention_bwd) {timing['pallas']['by_mode']} "
                             f"times through the kernels and "
                             f"{timing['xla']['launches']} through the plain "
                             f"attention; expected {want} each and (0, 0)")
    losses = {name: [x.item() for x in p["losses"]]
              for name, p in paths.items()}
    if not all(map(math.isfinite, losses["pallas"] + losses["xla"])):
        raise AssertionError(f"non-finite train losses {losses}")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["pallas"], losses["xla"]))
    bars = TRAIN_BARS[mode]
    models = [p["state"].model for p in paths.values()]
    stats, stats_x = ({k: v for k, v in mdl.named_buffers()
                       if v.is_floating_point()} for mdl in models)
    flat, flat_x = (flat_params(p) for p in paths.values())
    diff = (flat - flat_x).abs()
    keep = ~branch_flips
    param_excess = (diff - (PARAM_ATOL + PARAM_RTOL * flat_x.abs()))[keep] \
        .max().item()
    param_err = diff[keep].max().item()
    flips = int(branch_flips.sum())
    flip_err = diff[branch_flips].max().item() if flips else 0.0
    del flat, flat_x, diff, keep
    stats_excess = max(allclose_excess(stats[key], stats_x[key],
                                       *bars["stats"]) for key in stats)
    stats_err = max((stats[key] - stats_x[key]).abs().max().item()
                    for key in stats)
    b = TRAIN_BATCH
    ms = {name: 1e3 * tm["seconds"] / TRAIN_STEPS
          for name, tm in timing.items()}
    result = {"card": card, "batch": b, "steps": 1 + TRAIN_STEPS,
              "compute_dtype": cfg.MODEL.computeDtype,
              "timed_steps": TRAIN_STEPS,
              "train_ms_per_step": ms["pallas"],
              "train_samples_per_sec": 1e3 * b / ms["pallas"],
              "train_ms_per_step_xla": ms["xla"],
              "train_samples_per_sec_xla": 1e3 * b / ms["xla"],
              "losses": losses["pallas"], "losses_xla": losses["xla"],
              "loss_max_rel_err_vs_xla": loss_rel,
              "param_max_abs_err_after_first_step": first_err,
              "param_allclose_excess_after_first_step": first_excess,
              "param_max_abs_err_vs_xla": param_err,
              "param_allclose_excess": param_excess,
              "param_branch_flips": flips,
              "param_branch_flip_max_abs_err": flip_err,
              "bn_stats_max_abs_err_vs_xla": stats_err,
              "bn_stats_allclose_excess": stats_excess,
              "projection_grad_rel_err_vs_xla": grad_rel,
              "attention_fwd_launches": timing["pallas"]["launches"][0],
              "attention_bwd_launches": timing["pallas"]["launches"][1],
              "launches_by_mode": timing["pallas"]["by_mode"],
              "max_memory_allocated": timing["pallas"]["max_memory_allocated"],
              "max_memory_allocated_xla":
                  timing["xla"]["max_memory_allocated"]}
    print(json.dumps({label: result}), flush=True)
    if not grad_rel <= bars["proj_grad_rel"]:
        raise AssertionError(f"the projections' gradients at the first step "
                             f"differ from the plain-attention path by "
                             f"{grad_rel} relative > {bars['proj_grad_rel']}")
    if not loss_rel <= bars["loss_rtol"]:
        raise AssertionError(f"train losses differ from the plain-attention "
                             f"path by {loss_rel} relative > "
                             f"{bars['loss_rtol']}")
    if not first_excess <= 0:
        raise AssertionError(f"after the first step, weights differ from the "
                             f"plain-attention path by up to {first_err}")
    if not flips <= BRANCH_FLIPS_MAX:
        raise AssertionError(f"{flips} weights behind a branch the paths "
                             f"took apart at the first step > "
                             f"{BRANCH_FLIPS_MAX}")
    if not (param_excess <= 0 and stats_excess <= 0):
        raise AssertionError(f"after the steps, weights differ from the "
                             f"plain-attention path by up to {param_err} "
                             f"(not counting the {flips} branch flips) and "
                             f"BN statistics by up to {stats_err}")
    return result, {name: (lambda p=p: drive(p, 1))
                    for name, p in paths.items()}


def pallas_bf16_phase(torch, requests, card: str, outs_f32):
    """MODEL.attention pallas_bf16 on the model's path, in each compute
    dtype: two requests served (against the float32 slice's outputs at the
    JAX package's bfloat16 bars) and one train step of the flagship recipe,
    whose loss and projection gradients are held against the same step
    through the eager attention at the bfloat16 TRAIN_BARS; returns the
    launches by mode."""
    from hupr_tpu_torch.config import (flagship_serving_config,
                                       flagship_training_config)
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    reqs = requests[:2]
    result = {"card": card, "requests": len(reqs)}
    launches = {}
    for compute in ("float32", "bfloat16"):
        mode = ("bf16" if compute == "bfloat16" else "f32") + "_bf16ops"
        cfg = flagship_serving_config()
        cfg.MODEL.computeDtype, cfg.MODEL.attention = compute, "pallas_bf16"
        model = build_model(cfg)
        ds = cfg.DATASET
        run = make_e2e_infer(model, synthetic_state_dict(model, seed=0,
                                                         scale=0.03),
                             ds.radar_params(), duration=FRAMES,
                             group=ds.numGroupFrames,
                             num_frames=ds.numFrames)
        attention.reset_launch_counts()
        outs = [run(*req) for req in reqs]
        torch.cuda.synchronize()
        serve_fwd = dict(attention.attention_fwd.launches_by_mode)
        err, agree = decode_vs(outs, outs_f32[:len(reqs)])
        del model, run

        cfg = flagship_training_config()
        cfg.MODEL.computeDtype = compute
        t, ds = cfg.TRAINING, cfg.DATASET
        batch = bench_batch(torch, cfg)
        steps = {}
        for impl in ("pallas_bf16", "xla"):
            cfg.MODEL.attention = impl
            model = build_model(cfg)
            if impl == "pallas_bf16":
                weights = synthetic_state_dict(model, seed=0, scale=0.03)
            model.load_state_dict(weights, strict=True)
            tx = make_optimizer(cfg, model)
            step = make_train_step(model, tx, t.lossDecay, (
                ds.numKeypoints, ds.heatmapSize, ds.imgSize))
            attention.reset_launch_counts()
            _, metrics = step(TrainState(model, tx), batch, t.lr, 0.0)
            steps[impl] = (metrics["loss"].item(),
                           projection_grads(torch, model),
                           (dict(attention.attention_fwd.launches_by_mode),
                            dict(attention.attention_bwd.launches_by_mode)))
            del model, tx, step, metrics
        del batch, weights
        (loss, grads, train), (loss_x, grads_x, train_x) = steps.values()
        loss_rel = abs(loss - loss_x) / abs(loss_x)
        grad_rel = rel_err(grads, grads_x)
        del steps, grads, grads_x
        result[compute] = {"mode": mode, "serve_attention_fwd": serve_fwd,
                           "maxvals_max_abs_err_vs_f32": err,
                           "keypoint_agreement_vs_f32": agree,
                           "train_launches": train, "train_loss": loss,
                           "train_loss_xla": loss_x,
                           "loss_rel_err_vs_xla": loss_rel,
                           "projection_grad_rel_err_vs_xla": grad_rel}
        launches[mode] = {"fwd": serve_fwd.get(mode, 0)
                          + train[0].get(mode, 0),
                          "bwd": train[1].get(mode, 0)}
        if serve_fwd != {mode: 12 * len(reqs)} or \
                train != ({mode: 12}, {mode: 12}) or train_x != ({}, {}):
            raise AssertionError(f"pallas_bf16 {compute}: launches {serve_fwd}"
                                 f" serving, {train} training ({train_x} "
                                 f"through the eager attention); expected "
                                 f"mode {mode} only")
        bars = TRAIN_BARS["bf16"]
        if not (math.isfinite(loss) and err <= HEATMAP_TOL_VS_F32
                and agree >= DECODE_AGREE_VS_F32
                and loss_rel <= bars["loss_rtol"]
                and grad_rel <= bars["proj_grad_rel"]):
            raise AssertionError(f"pallas_bf16 {compute}: {result[compute]}")
    print(json.dumps({"pallas_bf16": result}), flush=True)
    return launches


def microbench_phase(torch, peaks):
    """The unfolded forward against its twin (float32 and bf16_ops) at the
    microbenchmark's shape, bit-identical on a second call, then the port's
    microbenchmark itself, whose unfolded launches are counted; returns the
    per-mode results, the launches and the microbenchmark's times."""
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.scripts.attn_microbench import run as microbench
    from hupr_tpu_torch.utils.device import float32_math

    b, n, c = MICRO_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    k, q, m = unit_spread(torch, gen, MICRO_SHAPE, torch.float32, 3)
    kb, qb, mb = (t.to(torch.bfloat16) for t in (k, q, m))
    rows = {}
    for mode, ops in (("f32", False), ("f32_bf16ops", True)):
        with torch.inference_mode(), float32_math():
            got = attention.attention_fwd_unfolded(k, q, m, bf16_ops=ops)
            again = attention.attention_fwd_unfolded(k, q, m, bf16_ops=ops)
            want = attention.attention_unfolded_plain(k, q, m, ops)
            ideal = attention.attention_unfolded_plain(*operand_values(
                torch, (k, q, m), ops))
            torch.cuda.synchronize()
            row = {"max_abs_err": (got - want).abs().max().item(),
                   "rel_err_vs_twin": rel_err(got, want),
                   "rel_err_vs_ideal": rel_err(got, ideal),
                   "repeats_bit_for_bit": torch.equal(got, again)}
            del got, again, want, ideal
            row["kernel_ms"] = cuda_ms(
                torch, lambda: attention.attention_fwd_unfolded(
                    k, q, m, bf16_ops=ops), 10)
            row["plain_ms"] = cuda_ms(
                torch, lambda: attention.attention_unfolded_plain(
                    k, q, m, ops), 5)
            lib = (qb, kb, mb) if ops else (q, k, m)
            row["library_ms"] = cuda_ms(torch, lambda: sdpa(*lib), 10)
        row["bound_ms"], row["bound_by"] = attention_bound(
            "unfolded", b, n, c, mode, peaks)
        rows[mode] = row
        if ops:
            check_bf16_rel(f"attention_fwd_unfolded {mode}", row)
        elif not (row["max_abs_err"] <= ATTN_TOL
                  and row["rel_err_vs_twin"] <= REL_F32_FWD):
            raise AssertionError(f"attention_fwd_unfolded: max abs error "
                                 f"{row['max_abs_err']} > {ATTN_TOL} or "
                                 f"relative error {row['rel_err_vs_twin']} "
                                 f"> {REL_F32_FWD}")
        if not row["repeats_bit_for_bit"]:
            raise AssertionError(f"attention_fwd_unfolded {mode}: two calls "
                                 f"gave different bits")
    del k, q, m, kb, qb, mb
    attention.reset_launch_counts()
    times = microbench(b, n, c, inner=5, reps=2)
    launches = dict(attention.attention_fwd_unfolded.launches_by_mode)
    print(json.dumps({"microbench": {"B": b, "N": n, "C": c,
                                     "unfolded": rows, "times_ms": times,
                                     "unfolded_launches": launches}}),
          flush=True)
    if set(launches) != {"f32", "f32_bf16ops"}:
        raise AssertionError(f"the microbenchmark launched the unfolded "
                             f"forward {launches}")
    return rows, launches, times


def backward_passes(torch, reps: int = 3):
    """The backward's device ms per call in each of its passes (dq, dkdm),
    in each mode at each path shape, B=20, from torch.profiler over `reps`
    calls after a warm-up call: each pass's time over the launches the
    profiler recorded (late in a process that has profiled before, it can
    miss a call's kernels). It runs after every other timing, so that no
    time is taken under or after this profiler's hooks."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from hupr_tpu_torch.ops.attention import attention_bwd, attention_fwd
    from hupr_tpu_torch.utils.device import float32_math

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for mode, dtype_name, ops in (("f32", "float32", False),) + BF16_MODES:
        for n, c in ATTN_SHAPES:
            k, q, m, g = unit_spread(torch, gen, (TRAIN_BATCH, n, c),
                                     getattr(torch, dtype_name), 4)
            with torch.inference_mode(), float32_math():
                o, lse = attention_fwd(k, q, m, with_lse=True, bf16_ops=ops)
                attention_bwd(k, q, m, o, lse, g, bf16_ops=ops)
                torch.cuda.synchronize()
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        attention_bwd(k, q, m, o, lse, g, bf16_ops=ops)
                    torch.cuda.synchronize()
            passes = {}
            for key, ms, count in kernel_times(torch, prof):
                found = re.search(r"attention_bwd\w*", key)
                if found:
                    ms0, count0 = passes.get(found.group(0), (0.0, 0))
                    passes[found.group(0)] = (ms0 + ms, count0 + count)
            out[f"{mode} N={n} C={c}"] = {
                name: {"ms": ms / count, "launches_seen": count}
                for name, (ms, count) in passes.items()}
            del k, q, m, g, o, lse
    print(json.dumps({"backward_passes_ms": out}), flush=True)
    return out


def write_sequence(root: str, frames: int, spatial: int = 64,
                   seed: int = 0) -> str:
    """One synthetic sequence (single_1) of `frames` complex64 radar cubes
    (16 chirps, spatial x spatial, 8 elevation bins) per view under
    root/data, and its annotations for the train, val and test splits:
    joints uniform in (40, 210) of a 256-pixel image, every GT box
    1500x1500 as tests/test_golden_ap.py inflates them (OKS divides by the
    gt area, and with the natural boxes a random model scores exactly 0).
    Returns the data directory."""
    import numpy as np

    rng = np.random.default_rng(seed)
    data = os.path.join(root, "data")
    blocks = []
    for view in ("hori", "vert"):
        os.makedirs(os.path.join(data, "single_1", view))
    for f in range(frames):
        for view in ("hori", "vert"):
            cube = np.empty((16, spatial, spatial, 8), np.complex64)
            cube.real = rng.standard_normal(cube.shape, np.float32)
            cube.imag = rng.standard_normal(cube.shape, np.float32)
            np.save(os.path.join(data, "single_1", view, f"{f:09d}.npy"),
                    cube)
        blocks.append({"image": f"{f:09d}.jpg",
                       "joints": rng.uniform(40, 210, (14, 2)).tolist(),
                       "bbox": [0.0, 0.0, 1500.0, 1500.0]})
    for phase in ("train", "val", "test"):
        with open(os.path.join(data, f"hrnet_annot_{phase}.json"), "w") as fp:
            json.dump([blocks], fp)
    return data


def runner_config(data_dir: str, attention: str = "pallas"):
    """config/mscsa_prgcn_tpu.yaml's recipe (flagship_training_config:
    numFilters 32, 64x64 maps, 8-frame windows, train batch 20, test batch
    32) over the one RUNNER_FRAMES-frame sequence of write_sequence, for
    RUNNER_EPOCHS epochs."""
    from hupr_tpu_torch.config import flagship_training_config

    cfg = flagship_training_config()
    cfg.MODEL.attention = attention
    d = cfg.DATASET
    d.dataDir, d.duration = data_dir, RUNNER_FRAMES
    d.trainName = d.valName = d.testName = [1]
    cfg.TRAINING.epochs = RUNNER_EPOCHS
    return cfg


def runner_args(dir_name: str, eval_mode: bool = False):
    import argparse
    return argparse.Namespace(seed=0, dir=dir_name, visDir="none",
                              eval=eval_mode, sampling_ratio=1,
                              keypoints=False)


def seed_checkpoint(cfg, dir_name: str) -> None:
    """./logs/<dir_name>/checkpoint.pth: seeded N(0, 0.03) weights (see
    serve_slice), an optimizer that has taken no step, epoch 0."""
    from hupr_tpu_torch.engine.checkpoint import snapshot, write_checkpoint
    from hupr_tpu_torch.engine.steps import make_optimizer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    model = build_model(cfg, device="cpu")
    model.load_state_dict(synthetic_state_dict(model, seed=0, scale=0.03))
    os.makedirs(os.path.join("logs", dir_name), exist_ok=True)
    write_checkpoint(os.path.join("logs", dir_name, "checkpoint.pth"),
                     snapshot(model, make_optimizer(cfg, model), 0, -1.0))


def eval_outputs(runner):
    """(maxvals (N, K, 1), pred2d (N, K, 2)) over the runner's eval split,
    through its own eval path, the padded rows dropped."""
    import numpy as np

    maxvals, preds = [], []
    for out, _, _, true_b in runner._eval_batches():
        maxvals.append(out["maxvals"][:true_b].cpu().numpy())
        preds.append(out["pred2d"][:true_b].cpu().numpy())
    return np.concatenate(maxvals), np.concatenate(preds)


def timed(torch, fn):
    """(fn(), seconds) on the host clock, the card synchronized before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loader_rate(cfg) -> tuple:
    """BatchLoader alone, as bench.py's _bench_loader measures it: batch 8,
    numWorkers 4, a fresh dataset (cold FrameCache) per pass over warm
    page cache, best of 3 after one pass that absorbs the cold page cache.
    Returns (samples/s, whether the native loader served every pass)."""
    from hupr_tpu_torch.data.dataset import BatchLoader, get_dataset

    def one_pass():
        ds = get_dataset("val", cfg, 1)
        t0 = time.perf_counter()
        n = sum(len(b["imageId"]) for b in BatchLoader(ds, 8, workers=4))
        return n / (time.perf_counter() - t0), ds.use_native

    rates = [one_pass() for _ in range(4)]
    return max(r for r, _ in rates[1:]), all(native for _, native in rates)


def runner_phase(torch, card: str):
    """hupr_tpu_torch.main.run, the CLI's flow, on the flagship recipe over
    one synthetic RUNNER_FRAMES-frame sequence: RUNNER_EPOCHS epochs of
    training (64 windows: 3 full batches of 20 and a masked one of 4) with
    sequence-mode val eval after each, from one seeded checkpoint.pth,
    through the kernels and, from the same file, through the plain
    attention (MODEL.attention xla). Holds the two runs together (per-step
    losses, final weights and BN statistics, each leaf's update from the
    checkpoint, val AP), the kernel path's eval against the plain path's
    on the same weights (maxvals, AP), sequence eval against classic eval (maxvals, AP), and the resume
    (model_best.pth's AP, checkpoint.pth's epoch and lr). Times an epoch
    of the train loop, the loader alone and both eval paths, profiles one
    epoch's train loop, and returns the results with the main run's
    launches."""
    import shutil
    import tempfile

    import numpy as np

    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.main import run
    from hupr_tpu_torch.ops import attention

    root = tempfile.mkdtemp(prefix="hupr_runner_")
    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        data = write_sequence(root, RUNNER_FRAMES)
        setup_s = time.perf_counter() - t0
        os.chdir(root)
        cfgs = {name: runner_config(data, name) for name in ("pallas", "xla")}
        for name, cfg in cfgs.items():
            seed_checkpoint(cfg, name)
        w0 = torch.load(os.path.join("logs", "pallas", "checkpoint.pth"),
                        weights_only=True)["model_state_dict"]

        def cli_run(name):
            return run(runner_args(name), cfgs[name])

        # the main path: the CLI's flow through the kernels
        attention.reset_launch_counts()
        trained, train_s = timed(torch, lambda: cli_run("pallas"))
        launches = {"attention_fwd": attention.attention_fwd.launches,
                    "attention_bwd": attention.attention_bwd.launches}
        trained_x, train_s_x = timed(torch, lambda: cli_run("xla"))
        if attention.attention_fwd.launches != launches["attention_fwd"] or \
                attention.attention_bwd.launches != launches["attention_bwd"]:
            raise AssertionError("the plain-attention run launched kernels")
        t, b = cfgs["pallas"].TRAINING, cfgs["pallas"].TEST.batchSize
        steps = RUNNER_EPOCHS * -(-RUNNER_FRAMES // t.batchSize)
        evals = RUNNER_EPOCHS * -(-RUNNER_FRAMES // b)
        want = {"attention_fwd": 12 * (steps + evals),
                "attention_bwd": 12 * steps}
        if launches != want:
            raise AssertionError(f"the Runner launched {launches}, expected "
                                 f"{want} ({steps} train steps, {evals} "
                                 f"eval batches)")

        losses = {}
        for name in ("pallas", "xla"):
            losses[name] = []
            for e in range(RUNNER_EPOCHS):
                with open(f"logs/{name}/train_loss_list_{e}.json") as fp:
                    losses[name] += json.load(fp)
        if len(losses["pallas"]) != steps or not all(
                map(math.isfinite, losses["pallas"] + losses["xla"])):
            raise AssertionError(f"train losses {losses}")
        loss_rel = max(abs(a - c) / abs(c)
                       for a, c in zip(losses["pallas"], losses["xla"]))
        sd, sd_x = trained.model.state_dict(), trained_x.model.state_dict()
        params = {k for k, _ in trained.model.named_parameters()}
        param_excess, stats_excess, update_rel = [], [], {}
        for key, v in sd.items():
            if not v.is_floating_point():
                continue
            (param_excess if key in params else stats_excess).append(
                allclose_excess(v, sd_x[key], PARAM_ATOL, PARAM_RTOL))
            d = (v.cpu() - w0[key]).double()
            d_x = (sd_x[key].cpu() - w0[key]).double()
            update_rel[key] = ((d - d_x).norm() / d_x.norm()).item() \
                if d_x.norm() > 0 else math.inf
        param_excess, stats_excess = max(param_excess), max(stats_excess)
        update_worst = max(update_rel, key=update_rel.get)
        param_err = max((sd[k] - sd_x[k]).abs().max().item() for k in params)

        # the train loop alone, as Runner.train runs it (loader, prefetch,
        # step, deferred fetch), one epoch from the seed weights: eval and
        # checkpoints stubbed out of this instance
        def loop_runner(dir_name):
            seed_checkpoint(cfgs["pallas"], dir_name)
            r = Runner(runner_args(dir_name), cfgs["pallas"])
            r.load_model_weight("checkpoint")
            r.cfg.TRAINING.epochs = 1
            r.eval = lambda **_: 0.0
            r.save_model_weight = lambda *_: None
            return r

        looped = loop_runner("loop")
        _, epoch_s = timed(torch, looped.train)
        looped = loop_runner("profile")
        profile(torch, "runner_epoch", looped.train, top=20)
        del looped
        cfgs["pallas"].TRAINING.epochs = RUNNER_EPOCHS

        # eval on the best weights: kernel vs plain, sequence vs classic
        def evaluator(name, sequence=True):
            cfg = runner_config(data, name)
            cfg.TEST.sequenceEval = sequence
            r = Runner(runner_args("pallas", True), cfg)
            r.load_model_weight("model_best")
            return r

        ev = {"seq": evaluator("pallas"), "xla": evaluator("xla"),
              "classic": evaluator("pallas", sequence=False)}
        outs = {k: eval_outputs(r) for k, r in ev.items()}
        aps, eval_s = {}, {}
        for k, r in ev.items():
            r.eval(visualization=False)                 # warm-up
            aps[k], eval_s[k] = timed(torch, lambda r=r: r.eval(
                visualization=False))
        maxval_err_x = float(np.abs(outs["seq"][0] - outs["xla"][0]).max())
        maxval_err_c = float(np.abs(outs["seq"][0]
                                    - outs["classic"][0]).max())
        flips = int((outs["seq"][1] != outs["classic"][1]).any(-1).sum())
        flips_x = int((outs["seq"][1] != outs["xla"][1]).any(-1).sum())
        loader_sps, use_native = loader_rate(cfgs["pallas"])

        # resume: the CLI's --eval from model_best.pth, and checkpoint.pth
        # in train mode (the reference resumes at the saved epoch)
        resumed = run(runner_args("pallas", True), cfgs["pallas"])
        resumed_ap = resumed.test_set.evaluate(resumed.dir, verbose=False)
        best_ap = trained.logger.show_best_ap()
        back = Runner(runner_args("pallas"), cfgs["pallas"])
        back.load_model_weight("checkpoint")

        aps_by_epoch = {"pallas": trained.epoch_aps,
                        "xla": trained_x.epoch_aps}
        for name in ("pallas", "xla"):
            with open(f"logs/{name}/val_results.json") as fp:
                n_val = len(json.load(fp))
            if n_val != RUNNER_FRAMES or \
                    len(aps_by_epoch[name]) != RUNNER_EPOCHS:
                raise AssertionError(f"{name}: {n_val} val keypoints, APs "
                                     f"{aps_by_epoch[name]}")
        # every dataset the phase read, the main path's first: a failed
        # native load drops a dataset to the NumPy loader for good
        use_native = use_native and all(
            ds.use_native for ds in (
                trained.train_set, trained.test_set, trained_x.train_set,
                trained_x.test_set, resumed.test_set,
                *(r.test_set for r in ev.values())))
        result = {
            "card": card, "frames": RUNNER_FRAMES, "epochs": RUNNER_EPOCHS,
            "train_batch": t.batchSize, "test_batch": b,
            "setup_s": setup_s, "cli_run_s": train_s, "cli_run_s_xla":
                train_s_x,
            "epoch_samples_per_sec": RUNNER_FRAMES / epoch_s,
            "loader_samples_per_sec": loader_sps,
            "seq_eval_frames_per_sec": RUNNER_FRAMES / eval_s["seq"],
            "classic_eval_frames_per_sec": RUNNER_FRAMES / eval_s["classic"],
            "seq_eval_frames_per_sec_xla": RUNNER_FRAMES / eval_s["xla"],
            "use_native": use_native,
            "launches": launches,
            "losses": losses["pallas"], "losses_xla": losses["xla"],
            "loss_max_rel_err_vs_xla": loss_rel,
            "param_max_abs_err_vs_xla": param_err,
            "param_allclose_excess": param_excess,
            "bn_stats_allclose_excess": stats_excess,
            "update_max_rel_err_vs_xla": update_rel[update_worst],
            "update_worst_leaf": update_worst,
            "val_ap_by_epoch": aps_by_epoch["pallas"],
            "val_ap_by_epoch_xla": aps_by_epoch["xla"], "best_ap": best_ap,
            "eval_ap": aps,
            "maxvals_max_abs_err_vs_xla": maxval_err_x,
            "maxvals_max_abs_err_seq_vs_classic": maxval_err_c,
            "argmax_flips_seq_vs_classic": flips,
            "argmax_flips_vs_xla": flips_x,
            "resumed_eval_ap": resumed_ap,
            "resume_start_epoch": back.start_epoch, "resume_lr": back.lr,
            "trained_lr": trained.lr}
        print(json.dumps({"runner": result}), flush=True)
        bars = TRAIN_BARS["f32"]
        checks = {
            "use_native": use_native,
            "losses vs xla": loss_rel <= bars["loss_rtol"],
            "weights vs xla": param_excess <= 0,
            "BN statistics vs xla": stats_excess <= 0,
            "updates vs xla": update_rel[update_worst] <= RUNNER_UPDATE_RTOL,
            "val APs vs xla": all(
                abs(a - c) <= PROTOCOL_ATOL for a, c in
                zip(aps_by_epoch["pallas"], aps_by_epoch["xla"])),
            "eval maxvals vs xla": maxval_err_x <= MAXVAL_TOL,
            "eval AP vs xla": abs(aps["seq"] - aps["xla"]) <= PROTOCOL_ATOL,
            "seq maxvals vs classic": maxval_err_c <= MAXVAL_TOL,
            "seq AP vs classic": abs(aps["seq"] - aps["classic"])
                <= PROTOCOL_ATOL,
            "AP not degenerate": 0.0 < aps["seq"] < 1.0,
            "resumed eval AP": abs(resumed_ap - best_ap) <= PROTOCOL_ATOL,
            "resume epoch": back.start_epoch == RUNNER_EPOCHS - 1,
            "resume lr": back.lr == trained.lr,
        }
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"runner checks failed: {failed}")
        return result
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


def check_attention_b1(torch, peaks):
    """The forward kernel at B=1, as the stream launches it (one window a
    frame), at the three path shapes, in modes f32 (against the plain
    version at ATTN_TOL and REL_F32_FWD, as check_attention) and bf16
    (against its twin at REL_TWIN and the float32 ideal at REL_IDEAL, on
    DRAWS inputs, as check_attention_modes); timed beside the plain version
    and SDPA in the same dtype. Returns per-(mode, shape) results."""
    from hupr_tpu_torch.ops.attention import attention_fwd, attention_plain
    from hupr_tpu_torch.utils.device import float32_math

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for mode in ("f32", "bf16"):
        for n, c in ATTN_SHAPES:
            draws = []
            for _ in range(1 if mode == "f32" else DRAWS):
                if mode == "f32":
                    k, q, m = (torch.randn((1, n, c), generator=gen,
                                           device="cuda") for _ in range(3))
                else:
                    k, q, m = unit_spread(torch, gen, (1, n, c),
                                          torch.bfloat16, 3)
                with torch.inference_mode(), float32_math():
                    got = attention_fwd(k, q, m)
                    want = attention_plain(k, q, m)
                    ideal = attention_plain(*(t.float() for t in (k, q, m)))
                    draws.append({"max_abs_err": (got.float() - want.float())
                                  .abs().max().item(),
                                  "rel_err_vs_twin": rel_err(got, want),
                                  "rel_err_vs_ideal": rel_err(got, ideal)})
            row = worst_of(draws)
            with torch.inference_mode(), float32_math():
                row["kernel_ms"] = cuda_ms(torch, lambda: attention_fwd(
                    k, q, m), 20)
                row["plain_ms"] = cuda_ms(torch, lambda: attention_plain(
                    k, q, m), 10)
                row["library_ms"] = cuda_ms(torch, lambda: sdpa(q, k, m), 20)
            row["bound_ms"], row["bound_by"] = attention_bound(
                "fwd", 1, n, c, mode, peaks)
            row.update(kernel="attention_fwd", mode=mode, B=1, N=n, C=c)
            print(json.dumps(row), flush=True)
            del k, q, m, got, want, ideal
            if mode == "f32" and not (row["max_abs_err"] <= ATTN_TOL and
                                      row["rel_err_vs_twin"] <= REL_F32_FWD):
                raise AssertionError(f"attention_fwd f32 B=1 N={n} C={c}: "
                                     f"{row}")
            if mode == "bf16":
                check_bf16_rel(f"attention_fwd bf16 B=1 N={n} C={c}", row)
            rows.append(row)
    return rows


def stream_sequence(est, frames):
    """Every pose of one sequence through a StreamingPoseEstimator, in
    frame order: the first latency_frames outputs dropped and the flush
    appended (the consumer rule of its flush). Returns (pred2d (F, K, 2),
    maxvals (F, K, 1)) numpy arrays."""
    import numpy as np

    out = []
    hr, hi, vr, vi = frames
    for t in range(hr.shape[0]):
        got = est.process_frame((hr[t], hi[t]), (vr[t], vi[t]))
        if t >= est.latency_frames:
            out.append(got)
    out += est.flush()
    return (np.stack([p for p, _ in out]), np.stack([m for _, m in out]))


def wrapper_launches(attention) -> dict:
    """{wrapper name: {mode: launches}}, a copy of every kernel wrapper's
    counts."""
    return {fn.__name__: dict(fn.launches_by_mode)
            for fn in (attention.attention_fwd, attention.attention_bwd,
                       attention.attention_fwd_unfolded)}


# the forward attention kernels' names in the card's trace: the float32
# body and the bfloat16 modes' wgmma body (not the unfolded forward's)
ATTN_FWD_TRACE = ("::attention_fwd_tf32<", "::attention_fwd_tc<")


def frame_launches(torch, step) -> dict:
    """One call of step under torch.profiler: the runtime's kernel and
    graph launch calls on the host, the kernels the card ran and how many
    of them were the forward attention kernel, the wall time and the time
    the card was busy."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    return {"host_launch_calls_per_frame": sum(
                1 for e in events if "Launch" in e.name
                and e.device_type == cpu),
            "device_kernels_per_frame": sum(
                1 for e in events if e.device_type == cuda
                and not e.name.startswith(("Memcpy", "Memset"))),
            "attention_fwd_kernels": sum(
                1 for e in events if e.device_type == cuda
                and any(n in e.name for n in ATTN_FWD_TRACE)),
            "wall_ms": wall_ms, "device_busy_ms": device_busy_ms(torch, prof)}


def stream_phase(torch, card: str):
    """StreamingPoseEstimator in the flagship config (float32) and the fast
    config (bfloat16), at full width with the slices' synthetic weights:
    one sequence of STREAM_FRAMES raw int16 frames per view through the
    CUDA graph step, with the kernel counts zeroed just before and read
    just after, held against make_e2e_infer on the same frames (the lag
    and the flush applied) and against the eager step; then
    stream_latency_ms as bench.py measures it (inputs on the card, STREAM
    warm-up frames, the packed fetch included) for the graph and the eager
    step. The wrappers count the eager steps (the first frame, the flush,
    the capture's warm-up step) and the capture, never a replay: the
    kernels the replays ran are counted from the card's trace, late
    (stream_launches). Returns the results by dtype and, for
    stream_launches, what it profiles: one more frame of each timed
    estimator and the main path's sequence again."""
    import numpy as np

    from hupr_tpu_torch.config import (fast_serving_config,
                                       flagship_serving_config)
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = [torch.randint(-300, 300, (STREAM_FRAMES, 4, 192, 256),
                            generator=gen, device="cuda", dtype=torch.int16)
              for _ in range(4)]
    out, later = {}, {}
    for dtype, make_cfg, mode, maxval_tol, agree_bar in (
            ("float32", flagship_serving_config, "f32", MAXVAL_TOL,
             STREAM_AGREE["f32"]),
            ("bfloat16", fast_serving_config, "bf16", MAXVAL_TOL_BF16,
             STREAM_AGREE["bf16"])):
        cfg = make_cfg()
        ds = cfg.DATASET
        model = build_model(cfg)
        model.load_state_dict(synthetic_state_dict(model, seed=0,
                                                   scale=0.03))
        rp = ds.radar_params()
        want_pred, want_maxv = (t.cpu().numpy() for t in make_e2e_infer(
            model, None, rp, duration=STREAM_FRAMES, group=ds.numGroupFrames,
            num_frames=ds.numFrames)(*frames))

        def estimator(graph):
            return StreamingPoseEstimator(model, None, rp, ds.numGroupFrames,
                                          ds.numFrames, cuda_graph=graph)

        # the main path: one sequence through the graph step
        est = estimator(True)
        attention.reset_launch_counts()
        pred, maxv = stream_sequence(est, frames)
        torch.cuda.synchronize()
        launches = wrapper_launches(attention)["attention_fwd"]
        pred_e, maxv_e = stream_sequence(estimator(False), frames)
        lag = est.latency_frames
        # the eager first frame, the capture's warm-up step, the capture
        # and the flushed frames
        want_launches = {mode: 12 * (3 + lag)}

        timing = {}
        frame = ((frames[0][0], frames[1][0]), (frames[2][0], frames[3][0]))
        for name, graph in (("graph", True), ("eager", False)):
            est = estimator(graph)
            for _ in range(STREAM_WARM):
                est.process_frame(*frame)
            attention.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STREAM_TIMED):
                est.process_frame(*frame)
            ms = 1e3 * (time.perf_counter() - t0) / STREAM_TIMED
            per_frame = {m: n / STREAM_TIMED for m, n in
                         attention.attention_fwd.launches_by_mode.items()}
            timing[name] = {"stream_latency_ms": ms,
                            "wrapper_launches_per_frame": per_frame}
            # profiled after every other timing (see backward_passes)
            later[f"{mode} {name}"] = \
                lambda est=est, frame=frame: est.process_frame(*frame)
        later[f"{mode} sequence"] = \
            lambda est=estimator(True): stream_sequence(est, frames)
        agree = float((pred == want_pred).all(-1).mean())
        result = {
            "card": card, "compute_dtype": dtype, "frames": STREAM_FRAMES,
            "latency_frames": lag,
            "stream_latency_ms": timing["graph"]["stream_latency_ms"],
            "stream_latency_ms_eager": timing["eager"]["stream_latency_ms"],
            "timing": timing, "sequence_wrapper_launches": launches,
            "maxvals_max_abs_err_vs_e2e": float(np.abs(maxv - want_maxv)
                                                .max()),
            "keypoint_agreement_vs_e2e": agree,
            "maxvals_max_abs_err_graph_vs_eager": float(
                np.abs(maxv - maxv_e).max()),
            "keypoints_graph_equal_eager": bool((pred == pred_e).all())}
        checks = {
            "launches": launches == want_launches,
            # a replay calls no wrapper; an eager step launches 12
            "per-frame wrapper launches":
                timing["graph"]["wrapper_launches_per_frame"] == {}
                and timing["eager"]["wrapper_launches_per_frame"]
                == {mode: 12.0},
            "shapes": pred.shape == want_pred.shape
            and maxv.shape == want_maxv.shape,
            "finite": bool(np.isfinite(maxv).all()),
            "peaks spread": 1e-3 < float(maxv.std()) and maxv.max() < 1.0,
            "maxvals vs e2e": result["maxvals_max_abs_err_vs_e2e"]
            <= maxval_tol,
            "keypoints vs e2e": agree >= agree_bar,
            "graph vs eager maxvals":
                result["maxvals_max_abs_err_graph_vs_eager"] <= 1e-5,
            "graph vs eager keypoints":
                result["keypoints_graph_equal_eager"]}
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"stream {dtype} checks failed: {failed}: "
                                 f"{result}")
        out[mode] = result
        del model
    return out, later


def stream_launches(torch, results: dict, frames: dict):
    """Under torch.profiler, what stream_phase left to profile: one frame
    of each timed estimator (the host's launch calls, the card's kernels
    and its busy time) and the main path's sequence again through a new
    graph estimator. Checks from the card's trace that a replayed frame
    ran the 12 forward attention kernels, as an eager frame does, and that
    the sequence ran 12 a frame, 12 a flushed frame and 12 for the
    capture's warm-up step; adds these counts to stream_phase's `results`
    and prints them as the `stream` lines, then the `stream_launches`
    line."""
    out = {name: frame_launches(torch, step) for name, step in frames.items()}
    for mode, result in results.items():
        frame = {name: out[f"{mode} {name}"]["attention_fwd_kernels"]
                 for name in ("graph", "eager")}
        sequence = out.pop(f"{mode} sequence")["attention_fwd_kernels"]
        result["traced_attention_fwd_kernels"] = {
            "per_replayed_frame": frame["graph"],
            "per_eager_frame": frame["eager"], "sequence": sequence}
        print(json.dumps({"stream": result}), flush=True)
        lag = result["latency_frames"]
        if not (frame == {"graph": 12, "eager": 12}
                and sequence == 12 * (STREAM_FRAMES + lag + 1)):
            raise AssertionError(
                f"stream {mode}: traced forward attention kernels "
                f"{result['traced_attention_fwd_kernels']}")
    print(json.dumps({"stream_launches": out}), flush=True)
    return out


def write_adc_sequence(torch, root: str, frames: int, seed: int = 0) -> str:
    """One synthetic sequence (single_1) of `frames` raw frames per view as
    DCA1000 captures (root/raw/single_1/{hori,vert}/adc_data.bin, int16
    uniform in [-300, 300), drawn on the card from a seed), the .npy cubes
    the port's DSP makes from them (root/data, complex64) with the
    Doppler-0 plane set to its exact value, zero (ROADMAP C, "Doppler-0
    residue": the cube-fed path is then held to the raw-ADC path with that
    plane pinned there too), and annotations as write_sequence writes
    them. Returns the capture root."""
    import numpy as np

    from hupr_tpu_torch.ops.dsp import (RadarParams, decode_dca1000,
                                        radar_cube_single_frame)

    rp = RadarParams()
    s = 2 * rp.num_rx * rp.num_chirp * rp.num_adc_samples
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data, raw = os.path.join(root, "data"), os.path.join(root, "raw")
    for view in ("hori", "vert"):
        os.makedirs(os.path.join(raw, "single_1", view))
        os.makedirs(os.path.join(data, "single_1", view))
        stream = torch.randint(-300, 300, (frames, s), generator=gen,
                               device="cuda", dtype=torch.int16)
        stream.cpu().numpy().tofile(os.path.join(raw, "single_1", view,
                                                 "adc_data.bin"))
        for f in range(frames):
            cube = radar_cube_single_frame(decode_dca1000(stream[f], rp),
                                           rp)
            cube[rp.num_kept_chirps // 2] = 0
            np.save(os.path.join(data, "single_1", view, f"{f:09d}.npy"),
                    cube.cpu().numpy())
    rng = np.random.default_rng(seed)
    blocks = [{"image": f"{f:09d}.jpg",
               "joints": rng.uniform(40, 210, (14, 2)).tolist(),
               "bbox": [0.0, 0.0, 1500.0, 1500.0]} for f in range(frames)]
    for phase in ("train", "val", "test"):
        with open(os.path.join(data, f"hrnet_annot_{phase}.json"), "w") as fp:
            json.dump([blocks], fp)
    return root


def fast_runner_config(root: str, compute: str = "bfloat16"):
    """fast_training_config() (config/mscsa_prgcn_tpu_fast.yaml: bfloat16
    compute and wire, chunk-mode training from raw ADC, raw-ADC sequence
    eval) over the sequence of write_adc_sequence, for RUNNER_EPOCHS
    epochs; `compute` float32 (and float32 wire) for the holds against the
    cube-fed and classic steps."""
    from hupr_tpu_torch.config import fast_training_config

    cfg = fast_training_config()
    d = cfg.DATASET
    d.dataDir, d.adcDir = os.path.join(root, "data"), os.path.join(root,
                                                                   "raw")
    d.duration = RUNNER_FRAMES
    d.trainName = d.valName = d.testName = [1]
    cfg.TRAINING.epochs = RUNNER_EPOCHS
    if compute == "float32":
        cfg.MODEL.computeDtype = cfg.SETUP.transferDtype = "float32"
    return cfg


def leaf_updates(torch, models, w0):
    """Each floating leaf's update from w0 in the first model against the
    second's, in L2 norm relative to the second's: {key: rel}."""
    sd, sd_x = (m.state_dict() for m in models)
    out = {}
    for key, v in sd.items():
        if not v.is_floating_point():
            continue
        d = (v.cpu() - w0[key]).double()
        d_x = (sd_x[key].cpu() - w0[key]).double()
        out[key] = ((d - d_x).norm() / d_x.norm()).item() \
            if d_x.norm() > 0 else math.inf
    return out


def hold_steps(torch, name, results, models, w0):
    """hold_readings, raising past a bar. Returns the readings."""
    out, ok = hold_readings(torch, results, models, w0)
    if not ok:
        raise AssertionError(f"{name}: {out}")
    return out


def hold_readings(torch, results, models, w0):
    """Losses, weights, BN statistics and each leaf's update of a path
    (results[0], models[0]) against another's, at the runner phase's
    float32 bars. Returns (the readings, whether all are within their
    bars)."""
    losses, losses_x = results
    bars = TRAIN_BARS["f32"]
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(losses, losses_x))
    sd, sd_x = (m.state_dict() for m in models)
    excess = max(allclose_excess(v, sd_x[k], PARAM_ATOL, PARAM_RTOL)
                 for k, v in sd.items() if v.is_floating_point())
    updates = leaf_updates(torch, models, w0)
    worst = max(updates, key=updates.get)
    out = {"losses": losses, "losses_other": losses_x,
           "loss_max_rel_err": loss_rel, "allclose_excess": excess,
           "update_max_rel_err": updates[worst], "update_worst_leaf": worst}
    return out, (loss_rel <= bars["loss_rtol"] and excess <= 0
                 and updates[worst] <= RUNNER_UPDATE_RTOL)


def runner_fast_phase(torch, card: str):
    """hupr_tpu_torch.main.run with fast_training_config() over one
    synthetic RUNNER_FRAMES-frame sequence of raw captures
    (write_adc_sequence): RUNNER_EPOCHS epochs of chunk-mode training from
    raw ADC with raw-ADC sequence val eval after each, from a seeded
    checkpoint.pth, with the kernel counts zeroed just before and read just
    after: no fallback notice, finite losses, 12 forward and 12 backward
    launches a step in mode bf16. Then, in float32 from the same weights on
    the same windows (the runner phase's 8 steps: every chunk in order,
    twice; the last of each epoch padded), the raw-ADC chunk step against
    the cube chunk step, and the cube chunk step against the classic step,
    at the runner phase's bars; and three planted faults that the first
    hold must catch (the I and Q lanes swapped in the decode, the frames
    off by one, one leaf left untrained). Times FAST_TIMED_EPOCHS epochs
    of the chunk-mode train loop one by one after a warm-up epoch, and
    raw-ADC sequence eval. Returns the results."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from hupr_tpu_torch.data.adc import ADCFrameSource
    from hupr_tpu_torch.data.dataset import get_dataset
    from hupr_tpu_torch.engine import chunk_train
    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.main import run
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention

    root = tempfile.mkdtemp(prefix="hupr_fast_")
    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        write_adc_sequence(torch, root, RUNNER_FRAMES)
        setup_s = time.perf_counter() - t0
        os.chdir(root)
        cfg = fast_runner_config(root)
        seed_checkpoint(cfg, "fast")
        w0 = torch.load(os.path.join("logs", "fast", "checkpoint.pth"),
                        weights_only=True)["model_state_dict"]

        # the main path: the CLI's flow on the fast recipe
        printed = io.StringIO()
        attention.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            trained, train_s = timed(torch, lambda: run(runner_args("fast"),
                                                        cfg))
        launches = wrapper_launches(attention)
        print(printed.getvalue(), end="", flush=True)
        t, b = cfg.TRAINING, cfg.TEST.batchSize
        steps = RUNNER_EPOCHS * -(-RUNNER_FRAMES // t.batchSize)
        evals = RUNNER_EPOCHS * -(-RUNNER_FRAMES // b)
        want = {"attention_fwd": {"bf16": 12 * (steps + evals)},
                "attention_bwd": {"bf16": 12 * steps},
                "attention_fwd_unfolded": {}}
        losses = []
        for e in range(RUNNER_EPOCHS):
            with open(f"logs/fast/train_loss_list_{e}.json") as fp:
                losses += json.load(fp)

        # the chunk-mode train loop alone (eval and checkpoints stubbed out
        # of this instance), one epoch to warm up and FAST_TIMED_EPOCHS
        # timed one by one (an epoch ends where its eval is called), and
        # raw-ADC sequence eval
        seed_checkpoint(cfg, "loop")
        looped = Runner(runner_args("loop"), cfg)
        looped.load_model_weight("checkpoint")
        looped.cfg.TRAINING.epochs = 1 + FAST_TIMED_EPOCHS
        marks = []

        def epoch_end(**_):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return 0.0

        looped.eval = epoch_end
        looped.save_model_weight = lambda *_: None
        timed(torch, looped.train)
        epoch_rates = sorted(RUNNER_FRAMES / (b - a)
                             for a, b in zip(marks, marks[1:]))
        cfg.TRAINING.epochs = RUNNER_EPOCHS
        evaluator = Runner(runner_args("fast", True), cfg)
        evaluator.load_model_weight("model_best")
        evaluator.eval(visualization=False)              # warm-up
        eval_ap, eval_s = timed(torch, lambda: evaluator.eval(
            visualization=False))
        del looped, evaluator

        # float32 holds from the seeded weights, over the same steps
        cfg32 = fast_runner_config(root, "float32")
        d = cfg32.DATASET
        geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
        rp = d.radar_params()
        ds = get_dataset("train", cfg32)
        cube_loader = chunk_train.ChunkTrainLoader(ds, t.batchSize,
                                                   shuffle=False)
        adc_loader = chunk_train.ADCChunkLoader(
            ds, t.batchSize, ADCFrameSource(d.adcDir, rp), shuffle=False)
        # the chunks in order, for as many steps as the runner phase
        # takes: Adam's first steps move each weight by about lr whatever
        # its gradient's size, so a few steps hold the updates loosely
        picks = list(range(len(cube_loader))) * RUNNER_EPOCHS
        classic = {}

        def classic_batch(ci):
            if ci not in classic:
                chunk = cube_loader.chunks[ci]
                rows = [ds.raw_sample(chunk["row0"] + i)
                        for i in range(chunk["true_b"])]
                rows += [rows[-1]] * (t.batchSize - len(rows))
                classic[ci] = {k: np.stack([r[k] for r in rows])
                               for k in ("hori", "vert", "jointsGroup")}
                classic[ci]["mask"] = (np.arange(t.batchSize)
                                       < chunk["true_b"]).astype(np.float32)
            return classic[ci]

        cube = chunk_train.radar_cube_frames

        def pinned(frames, params):
            c = cube(frames, params)
            c[:, params.num_kept_chirps // 2] = 0
            return c

        def drive(kind):
            model = build_model(cfg32)
            model.load_state_dict(w0)
            tx = make_optimizer(cfg32, model)
            state = TrainState(model, tx)
            if kind == "classic":
                step = make_train_step(model, tx, t.lossDecay, geometry)
            elif kind == "cube":
                step = chunk_train.make_chunk_train_step(model, tx, geometry)
            else:
                step = chunk_train.make_adc_chunk_train_step(
                    model, tx, geometry, radar_params=rp,
                    num_frames=d.numFrames)
            losses = []
            for i, ci in enumerate(picks):
                if kind == "classic":
                    batch = classic_batch(ci)
                else:
                    loader = adc_loader if kind == "adc" else cube_loader
                    batch, _ = chunk_train.device_put_chunk(
                        loader._assemble(loader.chunks[ci]))
                state, m = step(state, batch, t.lr * t.lrDecay ** i, 0.0)
                losses.append(m["loss"].item())
            return losses, model

        def adc_drive(dsp):
            chunk_train.radar_cube_frames = dsp
            try:
                return drive("adc")
            finally:
                chunk_train.radar_cube_frames = cube

        paths = {kind: drive(kind) for kind in ("classic", "cube")}
        classic.clear()
        paths["adc"] = adc_drive(pinned)
        # planted faults that the raw-ADC hold must catch: the decode's I
        # and Q lanes swapped, each chunk's frames off by one, and the
        # leaf that reads the hold's worst update left untrained
        untrained = build_model(cfg32)
        untrained.load_state_dict(paths["adc"][1].state_dict())
        leaf = "RAchirpNet.temporalConvWx1x1.weight"
        with torch.no_grad():
            untrained.get_parameter(leaf).copy_(w0[leaf])
        faulty = {
            "iq_swapped": adc_drive(
                lambda f, p: pinned(1j * f.conj(), p)),
            "frames_off_by_one": adc_drive(
                lambda f, p: pinned(f.roll(1, 0), p)),
            "leaf_untrained": (paths["adc"][0], untrained)}
        planted = {}
        for fault, (f_losses, f_model) in faulty.items():
            reading, passed = hold_readings(
                torch, (f_losses, paths["cube"][0]),
                (f_model, paths["cube"][1]), w0)
            planted[fault] = {key: reading[key] for key in (
                "loss_max_rel_err", "allclose_excess", "update_max_rel_err",
                "update_worst_leaf")} | {"caught": not passed}
        del faulty, untrained
        holds = {
            "adc_vs_cube": hold_steps(
                torch, "ADC chunk step vs cube chunk step",
                (paths["adc"][0], paths["cube"][0]),
                (paths["adc"][1], paths["cube"][1]), w0),
            "chunk_vs_classic": hold_steps(
                torch, "cube chunk step vs classic step",
                (paths["cube"][0], paths["classic"][0]),
                (paths["cube"][1], paths["classic"][1]), w0)}
        del paths

        result = {
            "card": card, "frames": RUNNER_FRAMES, "epochs": RUNNER_EPOCHS,
            "compute_dtype": cfg.MODEL.computeDtype,
            "loader": type(trained._chunk_loader).__name__,
            "eval_source": "adc" if trained._seq_eval.adc is not None
            else "cubes",
            "train_batch": t.batchSize, "test_batch": b, "setup_s": setup_s,
            "cli_run_s": train_s,
            # the median of the timed epochs, and their spread
            "epoch_samples_per_sec": statistics.median(epoch_rates),
            "epoch_samples_per_sec_min_max": [epoch_rates[0],
                                              epoch_rates[-1]],
            "epochs_timed": len(epoch_rates),
            "seq_eval_frames_per_sec": RUNNER_FRAMES / eval_s,
            "launches": launches, "losses": losses,
            "val_ap_by_epoch": trained.epoch_aps, "eval_ap": eval_ap,
            "holds_f32": holds, "planted_faults": planted}
        print(json.dumps({"runner_fast": result}), flush=True)
        checks = {
            "no fallback notice": "requested" not in printed.getvalue(),
            "raw-ADC chunk loader": result["loader"] == "ADCChunkLoader",
            "raw-ADC eval": result["eval_source"] == "adc",
            "launches": launches == want,
            "losses": len(losses) == steps
            and all(map(math.isfinite, losses)),
            "val APs": len(trained.epoch_aps) == RUNNER_EPOCHS,
            "eval AP": 0.0 <= eval_ap <= 1.0,
            "epochs timed": len(epoch_rates) == FAST_TIMED_EPOCHS,
            "planted faults caught": all(
                f["caught"] for f in planted.values())}
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"runner_fast checks failed: {failed}")
        return result
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)


def kernel_entry(name, mode, source, replaces, launches, rows, scale, per,
                 **extra):
    """One object of the `kernels` line: times and bounds summed over
    `rows` (per-shape dicts), each taken `scale` times."""
    total = {key: scale * sum(r[key] for r in rows)
             for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": name, "mode": mode, "route": "cuda",
            "source": f"hupr_tpu_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["kernel_ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            # what bounds the shape that takes most of the bound's time
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total["library_ms"], "per": per, **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hupr_tpu_torch.config import fast_serving_config, fast_training_config
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
    variant, peaks = card_peaks(torch.cuda.get_device_name(0))
    print(f"bound uses H100 {variant} peaks: {peaks['f32'] / 1e12} TFLOP/s "
          f"float32, {peaks['bf16'] / 1e12} TFLOP/s bfloat16 tensor, "
          f"{peaks['tf32'] / 1e12} TFLOP/s TF32 tensor, "
          f"{peaks['sfu'] / 1e12:.3f} T exp/s, {peaks['bytes'] / 1e12} TB/s",
          flush=True)

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

    rows = check_attention(torch, peaks)
    bwd_rows = check_attention_bwd(torch, peaks)
    mode_rows = check_attention_modes(torch, peaks)
    b1_rows = check_attention_b1(torch, peaks)
    # before any profiler run: it leaves later launches slower on the host
    st, stream_frames = stream_phase(torch, smi)

    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (FRAMES, 4, 192, 256)
    requests = [tuple(torch.randint(-300, 300, shape, generator=gen,
                                    device="cuda", dtype=torch.int16)
                      for _ in range(4)) for _ in range(REQUESTS)]
    sl, run, outs_f32 = serve_slice(torch, requests, smi)
    profile(torch, "serve", lambda: run(*requests[0]))
    del run
    sl16, run, _ = serve_slice(torch, requests, smi, fast_serving_config(),
                               "slice_bf16", "bf16", MAXVAL_TOL_BF16,
                               vs_f32=outs_f32)
    profile(torch, "serve_bf16", lambda: run(*requests[0]))
    del run
    tr, one_step = train_slice(torch, smi)
    # every kernel of the step, so that the two paths can be compared
    profile(torch, "train", one_step["pallas"], top=200)
    profile(torch, "train_plain_attention", one_step["xla"], top=200)
    del one_step
    tr16, one_step = train_slice(torch, smi, fast_training_config,
                                 "train_bf16", "bf16")
    profile(torch, "train_bf16", one_step["pallas"], top=200)
    profile(torch, "train_bf16_plain_attention", one_step["xla"], top=200)
    del one_step
    ops_launches = pallas_bf16_phase(torch, requests, smi, outs_f32)
    del requests, outs_f32
    micro_rows, micro_launches, _ = microbench_phase(torch, peaks)
    rr = runner_phase(torch, smi)
    rf = runner_fast_phase(torch, smi)
    stream_launches(torch, st, stream_frames)
    del stream_frames
    backward_passes(torch)

    shapes = "4 at each (N, C) of (256, 256), (1024, 128), (4096, 64)"
    per_request = f"one request: 12 launches, {shapes}, B={ATTN_BATCH}"
    per_step = f"one train step: 12 launches, {shapes}, B={TRAIN_BATCH}"
    fwd_src, bwd_src = "hupr_tpu/ops/attention.py:90", \
        "hupr_tpu/ops/attention.py:188"
    per_frame = f"one streamed frame: 12 launches, {shapes}, B=1"

    def b1(mode):
        return {key: 4 * sum(r[key] for r in b1_rows if r["mode"] == mode)
                for key in ("kernel_ms", "plain_ms", "library_ms",
                            "bound_ms")} | {"per": per_frame}

    lse_keys = {"kernel_ms": "fwd_with_lse_ms",
                "plain_ms": "fwd_with_lse_plain_ms",
                "library_ms": "fwd_with_lse_library_ms",
                "bound_ms": "fwd_with_lse_bound_ms"}
    entries = [
        kernel_entry("attention_fwd", "f32", "attention_fwd", fwd_src,
                     {"serve": sl["attention_launches"],
                      "train": tr["attention_fwd_launches"],
                      "runner": rr["launches"]["attention_fwd"],
                      "stream":
                          st["f32"]["sequence_wrapper_launches"]["f32"]},
                     rows, 4, per_request, stream_B1=b1("f32"),
                     stream_traced=st["f32"][
                         "traced_attention_fwd_kernels"],
                     body="attention_fwd_tf32 (3xTF32 on mma.sync, "
                          "csrc/tf32.cuh)",
                     rel_err=max(r["rel_err"] for r in rows),
                     with_lse_per_step={key: 4 * sum(r[name]
                                                     for r in bwd_rows)
                                        for key, name in lse_keys.items()}),
        kernel_entry("attention_bwd", "f32", "attention_bwd", bwd_src,
                     {"serve": 0, "train": tr["attention_bwd_launches"],
                      "runner": rr["launches"]["attention_bwd"]},
                     bwd_rows, 4, per_step,
                     body="attention_bwd_dq_tf32, attention_bwd_dkdm_tf32 "
                          "(3xTF32 on mma.sync, csrc/tf32.cuh)",
                     rel_err=max(r["rel_err"] for r in bwd_rows)),
    ]
    for mode, _, _ in BF16_MODES:
        mine = [r for r in mode_rows if r["mode"] == mode]
        extra = {}
        if mode == "bf16":
            fast = rf["launches"]
            fwd_launches = {"serve_bf16": sl16["attention_launches"],
                            "train_bf16": tr16["attention_fwd_launches"],
                            "stream_bf16": st["bf16"][
                                "sequence_wrapper_launches"]["bf16"],
                            "runner_fast": fast["attention_fwd"]["bf16"]}
            bwd_launches = {"train_bf16": tr16["attention_bwd_launches"],
                            "runner_fast": fast["attention_bwd"]["bf16"]}
            extra["stream_B1"] = b1("bf16")
            extra["stream_traced"] = \
                st["bf16"]["traced_attention_fwd_kernels"]
        else:
            fwd_launches = {"pallas_bf16": ops_launches[mode]["fwd"]}
            bwd_launches = {"pallas_bf16": ops_launches[mode]["bwd"]}
        with_lse = [r["fwd_with_lse_B20"] for r in mine]
        entries.append(kernel_entry(
            f"attention_fwd_{mode}", mode, "attention_fwd", fwd_src,
            fwd_launches, [r["fwd_B32"] for r in mine], 4, per_request,
            with_lse_per_step={key: 4 * sum(r[key] for r in with_lse)
                               for key in ("kernel_ms", "plain_ms",
                                           "library_ms", "bound_ms")},
            **extra))
        entries.append(kernel_entry(
            f"attention_bwd_{mode}", mode, "attention_bwd", bwd_src,
            bwd_launches, [r["bwd_B20"] for r in mine], 4, per_step))
    micro_src = "scripts/attn_microbench.py:73"
    for mode, suffix, body in (
            ("f32", "", "attention_fwd_unfolded_tf32 (3xTF32 on mma.sync, "
                        "csrc/tf32.cuh; two passes)"),
            ("f32_bf16ops", "_bf16ops", "attention_fwd_unfolded_tc (wgmma, "
                                        "csrc/hopper.cuh; two passes)")):
        entries.append(kernel_entry(
            f"attention_fwd_unfolded{suffix}", mode, "attention_fwd_unfolded",
            micro_src, {"microbench": micro_launches.get(mode, 0)},
            [micro_rows[mode]], 1,
            f"one call at (B, N, C) = {MICRO_SHAPE}", body=body,
            rel_err=micro_rows[mode]["rel_err_vs_twin"]))
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
