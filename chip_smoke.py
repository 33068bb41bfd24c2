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
   the library call that computes the same function. The float32 conv
   kernel (conv3d_fprop) at each Encoder3D shape at B=32, 20, 5 and 1
   (served, trained, a data parallel rank's rows, streamed), within
   ops/conv.REL_TOL of F.conv3d in float32 (TF32 off) and in float64; its
   plain version is the library's call, F.conv3d (cuDNN). The conv's
   gradients at each Encoder3D shape at B=5 and B=20 (data parallel
   training's rows a card, the flagship batch): the weight gradient
   (conv3d_wgrad) and the input gradient through conv3d_fprop, within
   ops/conv.REL_TOL of float64, cuDNN's float32 error beside them, timed
   against cuDNN's.
4. Serves requests of 32 raw int16 ADC frames per radar view through
   make_e2e_infer at the flagship width (config/mscsa_prgcn_tpu.yaml:
   numFilters 32, 64x64 maps, 8-frame windows, MODEL.attention pallas),
   with seeded synthetic weights; checks the launch counts (12 attention
   and 32 conv launches a float32 request), the output shapes and
   finiteness, and the agreement with the same requests served through
   the plain attention (MODEL.attention xla) and cuDNN's convolutions
   (plain_convs). The stream, export and shard phases and the train steps
   count the conv kernel's launches too: 32 to each 12 attention launches
   of a float32 forward at B >= 4 (20 at the stream's B = 1, where the
   16x16 convs' grids stay on cuDNN: conv.MIN_BLOCKS), none in bfloat16;
   a float32 train step at batch 20 launches conv3d_fprop 62 times (32
   forwards, 30 input gradients) and conv3d_wgrad 32 times.
5. Trains the flagship recipe (batch 20, Adam at lr 1e-4) for a few steps
   of bench.py's synthetic batch, driven as Runner.train drives its train
   step, through the kernels and, from the same weights, through the plain
   attention and cuDNN's convolutions (plain_convs); checks the launch
   counts, finite losses, and that the first
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
   the eager step as bench.py times it. After the float32 requests of 4,
   as the process's first profiler run (card_trace): a frame of each (the host's launch calls, the card's kernels) and the
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
13. The max-throughput recipe (max_training_config(),
   config/mscsa_prgcn_tpu_max.yaml: the fast recipe at batch 128 with
   MODEL.remat) as bench.py's train_max times it: the classic step on
   bench.py's batch at 128 rows, with and without remat from the same
   weights, in turns: 12 + 12 bf16 launches a step in both, the two held
   together, remat's max_memory_allocated lower; ms/step, samples/s and
   MFU of each; a profile of one step of each.
14. The learning proofs at full width (tests/test_learning.py and
   tests/test_learning_fast.py's data, batches and steps, at the recipes'
   own lr): the flagship float32 recipe, and the fast recipe's chunk-mode
   raw-ADC training and raw-ADC sequence eval in bfloat16, each through
   the kernels and through the plain attention from the same
   initialization, each to the JAX tests' loss bars and AP > 0.1.
15. The radar's two ends on one synthetic full-geometry capture per view
   (64 frames): the preprocessing CLI's RadarPreprocessor makes the cubes
   on the card (held against the CPU's and the NumPy oracle's); the parity
   audit's body scores them with a seeded flagship model_best.pth (exit
   codes 2, 0 and 1, its AP equal to Runner.eval's); live serving's body
   serves the same captures replayed over loopback UDP through the C++
   reassembler (every byte, no resync, the poses held against the
   estimator fed the captures directly). No profiler runs here.
16. Data parallel on the one card (parallel_phase): two ranks, each a
   process this script starts (--dp-worker), sharing the card over gloo
   (NCCL refuses two ranks on one device): the flagship float32 step and
   the fast recipe's raw-ADC chunk step in float32 and bfloat16 on 19 real
   rows padded to 20, 8 steps from seeded weights, held against the
   one-rank step on the card (12 + 12 launches a step on each rank); the
   Runner under HUPR_MULTIHOST=1 over two 64-frame sequences (process-0
   checkpoints, merged rank files, its AP against a one-process eval);
   and main.run in a world of one on NCCL against the plain Runner. Its
   ms per step (dp_shared_card_ms_per_step) is two ranks time-slicing
   one card, not a scaling number. No profiler runs here.
17. Frame-axis sharding of one request (shard_phase): two ranks sharing
   the card over gloo, each called with the whole request, split its 32
   frames (make_e2e_infer(mesh=), the window's halo exchanged), in the
   float32 and bfloat16 serving configs, and an 8-frame request of two
   4-frame sequences (blocks smaller than the halo); sequence eval
   (SequenceEvaluator(mesh=)) over one 64-frame sequence at batch 32.
   Each rank's results held to this process's at the stream's bars (12
   launches a request and 24 a sequence on each rank); a world of one on
   NCCL equal to the unsharded entry bit for bit. Its frames/s
   (shard_frames_per_sec) is two ranks time-slicing one card, not a
   scaling number. No profiler runs here.
18. The graft entry points (hupr_tpu_torch/graft_entry.py, graft_phase):
   entry()'s flagship forward through the kernel (12 launches a call)
   held to the same model and weights through the plain attention, and
   dryrun_multichip(2) on the card: two ranks sharing it over gloo run
   the mini epoch at the flagship geometry (train steps with a padded
   remainder, eval, checkpoint resume, sharded serving, sequence eval,
   chunk and ADC chunk steps, ADC sequence eval) with every stage run and
   each rank's launches counted, then the flagship shape pass at world 8
   on meta tensors in this process.
19. AOT serving export (engine/export.py), right after the float32 and
   the bfloat16 slices: each config's program exported on the CPU with
   the slice's weights into build/export/, loaded onto the card and
   serving the slice's requests in turns with make_e2e_infer (12 launches
   a request; float32 within 1e-6 and 99 % of keypoints equal, bfloat16
   within 1e-2 and 95 %); for float32 also a new process that imports
   engine.export alone loads the file and serves a request through the
   kernel, and an artifact exported on the card serves what the
   CPU-exported one serves. Artifact MB, export and load seconds,
   frames/s beside make_e2e_infer's.
20. scripts/profile_train.py in a process of its own per mode (train and
   serve): the attention kernels among its attributed names, its launch
   counts, its total beside the `profile` line's busy ms (read, not held).
21. scripts/conv_microbench.py at its defaults in float32 and bfloat16,
   its own agreement assert holding each reformulation to cuDNN's.
22. Prints the `kernels` line (every kernel and mode), then ends with one
   JSON line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA device or without the
rest of the repository beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from gpubench.roofline import (PEAKS, attention_bound, card_peaks,
                               product_route)
from hupr_tpu_torch.ops import kernels
from hupr_tpu_torch.ops.attention import (ATTN_TOL, REL_F32_BWD, REL_F32_FWD,
                                          REL_IDEAL, REL_TWIN, REL_TWIN_BWD)

# hupr_tpu_torch/csrc/*.cu
KERNELS = ("attention_fwd", "attention_bwd", "attention_fwd_unfolded",
           "conv3d_fprop", "conv3d_wgrad")
REQUESTS = 8            # timed requests of the serving slice
FRAMES = 32             # raw frames per request and radar view (bench.py)
ATTN_BATCH = 32         # windows per request = the attention's batch
MAXVAL_TOL = 1e-4       # pallas vs xla serving, max abs error of maxvals
TRAIN_BATCH = 20        # the flagship's TRAINING.batchSize (bench.py)
TRAIN_STEPS = 4         # timed train steps per path, after one warm-up step
# backward kernel vs plain: the bar of tests/test_attention.py for the
# Pallas backward, atol + rtol * |plain|
GRAD_ATOL, GRAD_RTOL = 1e-3, 1e-4
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
# ((Cin, D, H, W), Cout, bias, convs a forward) of the 3x3x3 convs of the two
# Encoder3Ds at the flagship width (models/encoder3d.py: each has the stem,
# one BasicBlock of 3 convs at 64x64 and two BasicBlocks of 2 + 3 at each
# of the other two scales): 32 launches of conv3d_fprop a float32 forward
# at B >= 4, fewer where a shape's grid falls under conv.MIN_BLOCKS (20 at
# the stream's B = 1)
CONV_SHAPES = (((32, 8, 64, 64), 64, True, 2),
               ((64, 8, 64, 64), 64, False, 6),
               ((64, 4, 32, 32), 128, False, 4),
               ((128, 4, 32, 32), 128, False, 8),
               ((128, 2, 16, 16), 256, False, 4),
               ((256, 2, 16, 16), 256, False, 8))
CONV_PER_FORWARD = sum(n for *_, n in CONV_SHAPES)
# the bfloat16 modes: (name, input dtype, bf16_ops)
BF16_MODES = (("bf16", "bfloat16", False), ("f32_bf16ops", "float32", True),
              ("bf16_bf16ops", "bfloat16", True))
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
# train_max: config/mscsa_prgcn_tpu_max.yaml's batch, and the timed steps
# per variant after the flop-counted first step
MAX_BATCH, MAX_STEPS = 128, 3
# the learning phases: the JAX tests' data, batches and steps
# (tests/test_learning.py, tests/test_learning_fast.py), at the recipes'
# own lr, 1e-4: the tests' 1e-3 and 3e-3 are set for numFilters 2, and at
# numFilters 32 Adam there saturates the heatmaps (PERF.md section 6)
LEARN_FRAMES, LEARN_BATCH, LEARN_STEPS = 8, 4, 150
LEARN_FAST_FRAMES, LEARN_FAST_BATCH, LEARN_FAST_STEPS = 16, 12, 160
LEARN_FAST_TEST_BATCH = 8
# the front_end phase: one synthetic full-geometry capture per view (HuPR's
# are 600 frames), the preprocessor's batch (its CLI's default), and the
# cubes' bars, relative to the cube's peak: card against CPU (FFT libraries
# differ in the last bits), and tests/test_preprocess.py's bar against the
# NumPy oracle
FRONT_FRAMES, FRONT_BATCH, FRONT_SEED = 64, 30, 12
CUBE_PEAK_REL, ORACLE_PEAK_REL = 1e-5, 1e-4

# the stream phase: one sequence of raw frames per view (bench.py's
# request), then stream_latency_ms as bench.py times it (3 warm-up frames,
# 20 timed)
STREAM_FRAMES, STREAM_WARM, STREAM_TIMED = 32, 3, 20
# keypoints decoded to the same bin as make_e2e_infer's on the same frames:
# the stream runs each window at B=1, the batch path at B=32, so the card's
# sums run in other orders and a near-tied argmax may flip
STREAM_AGREE = {"f32": 0.99, "bf16": 0.95}

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


def check_conv(torch, peaks):
    """The float32 conv kernel (csrc/conv3d_fprop.cu, 3xTF32 on wgmma) at
    each Encoder3D shape, at B=ATTN_BATCH as served, B=TRAIN_BATCH and 5 as
    trained on one card and on a data parallel rank, and B=1 as streamed
    (each row says whether conv.fprop_takes sends the shape to it): max
    |error| over max |reference| within conv.REL_TOL of
    F.conv3d in float32 with TF32 off and of F.conv3d in float64,
    bit-identical on a second call; timed beside the plain version, which is
    the library's call (F.conv3d: cuDNN, TF32 off). The bound is the larger
    of the 3xTF32 products (product_route) and the bytes of input, weights
    and output. Returns per-shape results."""
    import torch.nn.functional as F

    from hupr_tpu_torch.ops import conv
    from hupr_tpu_torch.utils.device import float32_math

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for b in (ATTN_BATCH, TRAIN_BATCH, 5, 1):
        for (cin, d, h, w), cout, with_bias, per in CONV_SHAPES:
            x = torch.randn((b, cin, d, h, w), generator=gen, device="cuda")
            wt = torch.randn((cout, cin, 3, 3, 3), generator=gen,
                             device="cuda") / math.sqrt(27 * cin)
            bias = torch.randn((cout,), generator=gen, device="cuda") \
                if with_bias else None
            with torch.inference_mode(), float32_math():
                got = conv.conv3d_3x3x3(x, wt, bias)
                again = conv.conv3d_3x3x3(x, wt, bias)
                want = conv.conv_plain(x, wt, bias)
                want64 = F.conv3d(x.double(), wt.double(), None if bias is None
                                  else bias.double(), padding=1)
                scale = want64.abs().max().item()
                err = (got - want).abs().max().item()
                row = {"kernel": "conv3d_fprop", "mode": "f32", "B": b,
                       "Cin": cin, "DHW": [d, h, w], "Cout": cout,
                       "bias": with_bias, "per_forward": per,
                       "taken": conv.fprop_takes(x.shape, cout),
                       "max_abs_err": err, "rel_err": err / scale,
                       "rel_err_vs_f64": (got.double() - want64).abs().max()
                       .item() / scale,
                       "plain_rel_err_vs_f64": (want.double() - want64).abs()
                       .max().item() / scale,
                       "repeats_bit_for_bit": torch.equal(got, again)}
                del again, want, want64
                reps = 10 if b > 1 else 20
                row["kernel_ms"] = cuda_ms(torch, lambda: conv.conv3d_3x3x3(
                    x, wt, bias), reps)
                row["plain_ms"] = cuda_ms(torch, lambda: conv.conv_plain(
                    x, wt, bias), reps)
            row["library_ms"] = row["plain_ms"]
            flops = 2 * b * d * h * w * cout * 27 * cin
            nbytes = 4 * (x.numel() + wt.numel() + got.numel()
                          + (cout if with_bias else 0))
            ops_s = flops * product_route("f32", "f32", peaks)[1]
            bytes_s = nbytes / peaks["bytes"]
            row["bound_ms"] = 1e3 * max(ops_s, bytes_s)
            row["bound_by"] = "operations" if ops_s >= bytes_s else "bytes"
            row["tflops"] = flops / row["kernel_ms"] / 1e9
            print(json.dumps(row), flush=True)
            if not (row["rel_err"] <= conv.REL_TOL
                    and row["rel_err_vs_f64"] <= conv.REL_TOL):
                raise AssertionError(f"conv3d_fprop at {tuple(x.shape)} -> "
                                     f"{cout}: {row}, bar {conv.REL_TOL}")
            if not row["repeats_bit_for_bit"]:
                raise AssertionError(f"conv3d_fprop at {tuple(x.shape)} -> "
                                     f"{cout}: two calls gave different bits")
            rows.append(row)
            del x, wt, bias, got
    return rows


def check_conv_grads(torch, peaks):
    """The float32 conv's gradients at each Encoder3D shape at B=5 and
    B=TRAIN_BATCH: the weight gradient (csrc/conv3d_wgrad.cu) and, where
    conv.dgrad_takes, the input gradient through the forward kernel on dY
    with conv.dgrad_weight, each within conv.REL_TOL of float64 (max |error|
    over max |reference|) with cuDNN's float32 error beside it, the weight
    gradient bit-identical on a second call; timed beside cuDNN's (aten's
    convolution_backward, TF32 off: the plain version and the library
    call), with the kernel's TFLOP/s and its share of the bound, the larger
    of the 3xTF32 products and the bytes of the two inputs and the output.
    Returns per-shape rows."""
    from hupr_tpu_torch.ops import conv
    from hupr_tpu_torch.utils.device import float32_math

    def cudnn(dy, x, wt, mask):
        return torch.ops.aten.convolution_backward(
            dy, x, wt, None, [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
            mask)

    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for b in (5, TRAIN_BATCH):
        for (cin, d, h, w), cout, _, per in CONV_SHAPES:
            shape = (b, cin, d, h, w)
            x = torch.randn(shape, generator=gen, device="cuda")
            dy = torch.randn((b, cout, d, h, w), generator=gen, device="cuda")
            wt = torch.randn((cout, cin, 3, 3, 3), generator=gen,
                             device="cuda") / math.sqrt(27 * cin)
            passes = [("conv3d_wgrad", 1, lambda: conv.conv3d_wgrad(x, dy),
                       x)]
            if conv.dgrad_takes(shape, cout):
                passes.append(("conv3d_dgrad", 0, lambda: conv.conv3d_3x3x3(
                    dy, conv.dgrad_weight(wt)), dy))
            for name, which, kernel, src in passes:
                mask = [which == 0, which == 1, False]
                with torch.no_grad(), float32_math():
                    got, again = kernel(), kernel()
                    want = cudnn(dy, x, wt, mask)[which]
                    want64 = cudnn(dy.double(), x.double(), wt.double(),
                                   mask)[which]
                    scale = want64.abs().max().item()
                    row = {"kernel": name, "mode": "f32", "B": b, "Cin": cin,
                           "DHW": [d, h, w], "Cout": cout, "per_step": per,
                           "max_abs_err": (got.double() - want64).abs().max()
                           .item(),
                           "rel_err_vs_f64": (got.double() - want64).abs()
                           .max().item() / scale,
                           "cudnn_rel_err_vs_f64": (want.double() - want64)
                           .abs().max().item() / scale,
                           "repeats_bit_for_bit": torch.equal(got, again)}
                    del again, want, want64
                    row["kernel_ms"] = cuda_ms(torch, kernel, 10)
                    row["plain_ms"] = cuda_ms(torch, lambda: cudnn(
                        dy, x, wt, mask), 10)
                row["library_ms"] = row["plain_ms"]
                flops = 2 * b * d * h * w * cout * 27 * cin
                nbytes = 4 * (x.numel() + dy.numel() + wt.numel())
                ops_s = flops * product_route("f32", "f32", peaks)[1]
                bytes_s = nbytes / peaks["bytes"]
                row["bound_ms"] = 1e3 * max(ops_s, bytes_s)
                row["bound_by"] = "operations" if ops_s >= bytes_s \
                    else "bytes"
                row["tflops"] = flops / row["kernel_ms"] / 1e9
                row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
                print(json.dumps(row), flush=True)
                if not row["rel_err_vs_f64"] <= conv.REL_TOL:
                    raise AssertionError(f"{name} at {shape} -> {cout}: "
                                         f"{row}, bar {conv.REL_TOL}")
                if not row["repeats_bit_for_bit"]:
                    raise AssertionError(f"{name} at {shape} -> {cout}: two "
                                         f"calls gave different bits")
                rows.append(row)
                del got
            del x, dy, wt, passes
    return rows


def conv_train_launches(batch: int = TRAIN_BATCH) -> tuple:
    """(conv3d_fprop, conv3d_wgrad) launches of a float32 train step at
    `batch` windows: each conv of CONV_SHAPES whose forward the kernel
    takes (conv.routes) launches it once, and once more for its input
    gradient where conv.dgrad_takes, and conv3d_wgrad for its weight
    gradient where conv.wgrad_takes."""
    from hupr_tpu_torch.ops import conv

    fprop = wgrad = 0
    for (cin, d, h, w), cout, _, n in CONV_SHAPES:
        r = conv.routes((batch, cin, d, h, w), cout)
        if r["fprop"]:
            fprop += n * (1 + r["dgrad"])
            wgrad += n * r["wgrad"]
    return fprop, wgrad


@contextlib.contextmanager
def plain_convs():
    """Within the body models/blocks.Conv3d sends every conv to F.conv3d
    (cuDNN), as it does where conv.takes_kernel and conv.takes_window
    refuse one: the plain route of a comparison."""
    from hupr_tpu_torch.ops import conv

    takes = conv.takes_kernel, conv.takes_window
    conv.takes_kernel = conv.takes_window = lambda *args, **kwargs: False
    try:
        yield
    finally:
        conv.takes_kernel, conv.takes_window = takes


def conv_per_forward(batch: int, spatial: int = 64) -> int:
    """conv3d_fprop's launches in a float32 forward without gradients at
    `batch` windows of spatial x spatial maps: the convs of CONV_SHAPES
    (at 64x64), their maps scaled, whose grid conv.takes_kernel takes."""
    from hupr_tpu_torch.ops import conv

    return sum(n for (cin, d, h, w), cout, _, n in CONV_SHAPES
               if conv.grid_blocks((batch, cin, d, h * spatial // 64,
                                    w * spatial // 64), cout)
               >= conv.MIN_BLOCKS)


def conv_launches_want(attention_launches: int, mode: str,
                       batch: int = ATTN_BATCH, spatial: int = 64) -> int:
    """conv3d_fprop's launches beside `attention_launches` forward
    attention launches of forwards without gradients at `batch` windows of
    spatial x spatial maps: conv_per_forward(batch, spatial) to each 12 in
    float32 (mode f32), none in bfloat16."""
    return conv_per_forward(batch, spatial) * attention_launches // 12 \
        if mode == "f32" else 0


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
    the kernels, then through the eager attention and cuDNN's convolutions
    (plain_convs) in the same compute dtype; with `vs_f32`, also against
    the float32 slice's outputs. Returns the slice's results, the kernel
    path's run and its outputs."""
    import copy

    import numpy as np

    from hupr_tpu_torch.config import flagship_serving_config
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention, conv
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
    plain = make_e2e_infer(build_model(cfg_x), state, ds.radar_params(),
                           duration=FRAMES, group=ds.numGroupFrames,
                           num_frames=ds.numFrames)

    def run_x(*req):
        with plain_convs():
            return plain(*req)

    def serve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(*req) for req in requests]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    for fn in (run, run_x):                 # warm-up: cuDNN plans, caches
        fn(*requests[0])
    # in turns on one card: plain route, kernels, plain route
    _, elapsed_x1 = serve(run_x)
    kernels.reset_launch_counts()
    outs, elapsed = serve(run)
    launches = attention.attention_fwd.launches
    by_mode = dict(attention.attention_fwd.launches_by_mode)
    bwd_launches = attention.attention_bwd.launches
    conv_launches = conv.conv3d_3x3x3.launches
    kernels.reset_launch_counts()
    outs_x, elapsed_x2 = serve(run_x)
    conv_launches_x = conv.conv3d_3x3x3.launches

    per_request = 12
    if by_mode != {mode: per_request * len(requests)} or bwd_launches != 0:
        raise AssertionError(f"serving launched attention_fwd {by_mode} and "
                             f"attention_bwd {bwd_launches} times for "
                             f"{len(requests)} requests, expected "
                             f"{per_request} each in mode {mode} and 0")
    conv_want = conv_launches_want(launches, mode)
    if conv_launches != conv_want or conv_launches_x != 0:
        raise AssertionError(f"serving launched conv3d_fprop "
                             f"{conv_launches} times for {len(requests)} "
                             f"requests and {conv_launches_x} on the plain "
                             f"route, expected {conv_want} and 0")
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
              "conv_launches": conv_launches,
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


# idle seconds inside each torch.profiler window, before and after the work
# it traces: once a process has profiled and then run unprofiled work on
# the card, the profiler drops some of the card's events from later
# windows, fewer of them with the card idle around the work
TRACE_PAD_S = 0.25


@contextlib.contextmanager
def card_trace(torch, activities):
    """torch.profiler over the body, the card idle and the window padded
    by TRACE_PAD_S on both sides; yields the profiler."""
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def on_card(torch, e) -> bool:
    """A profiler event of the card's own work: not a host event, and not
    the card's mirror of a record_function range (the program's spans)."""
    return e.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(e, "is_user_annotation", False)


def kernel_times(torch, prof):
    """(kernel name, device ms, calls) of each CUDA kernel a torch.profiler
    run saw, the longest first."""
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if on_card(torch, e) and e.self_device_time_total > 0]
    return sorted(kernels, key=lambda x: -x[1])


def device_busy_ms(torch, prof) -> float:
    """The time the device was busy in a torch.profiler run: the union of
    its events' spans, so that work that overlaps on two streams counts
    once."""
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if on_card(torch, e)):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return busy_us / 1e3


def profile(torch, path: str, fn, top: int = 12):
    """One call of fn under torch.profiler: device time by kernel, the time
    the device was busy (the union of its events' spans, so that work that
    overlaps on two streams counts once), and the device's idle share of
    the call's wall time."""
    from torch.profiler import ProfilerActivity

    with card_trace(torch, [ProfilerActivity.CPU,
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
    return out


def bench_batch(torch, cfg):
    """bench.py's batch: N(0, 1) windows per view, joints uniform in
    (20, 230), cfg.TRAINING.batchSize rows made on the card from seed 3
    (utils/synthetic.synthetic_train_batch)."""
    from hupr_tpu_torch.utils.synthetic import synthetic_train_batch

    return synthetic_train_batch(cfg, cfg.TRAINING.batchSize, "cuda", seed=3)


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
    eager attention and cuDNN's convolutions (plain_convs) in the same
    compute dtype, on bench.py's batch: the
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
    from hupr_tpu_torch.ops import attention, conv
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
                       # the plain route: cuDNN's convs as well
                       "convs": plain_convs if name == "xla"
                       else contextlib.nullcontext,
                       "lr": t.lr, "alpha": 0.0, "idx": 0, "losses": []}

    def drive(p, steps):
        """Runner.train's loop body: alpha advanced before the step, the lr
        adjusted after every lrDecayIter-th step (idx 0 included)."""
        with p["convs"]():
            for _ in range(steps):
                if p["alpha"] < 1.0:
                    p["alpha"] += t.lossDecay
                p["state"], metrics = p["step"](p["state"], batch, p["lr"],
                                                p["alpha"])
                p["losses"].append(metrics["loss"])
                if p["idx"] % t.lrDecayIter == 0:  # Runner.adjust_lr, epoch 0
                    p["lr"] *= (t.warmupGrowth if 0 < t.warmupEpoch
                                else t.lrDecay)
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
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        drive(paths[name], TRAIN_STEPS)
        torch.cuda.synchronize()
        timing[name] = {
            "seconds": time.perf_counter() - t0,
            "launches": (attention.attention_fwd.launches,
                         attention.attention_bwd.launches),
            "conv_launches": conv.conv3d_3x3x3.launches,
            "wgrad_launches": conv.conv3d_wgrad.launches,
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
    conv_launches = [(t["conv_launches"], t["wgrad_launches"])
                     for t in timing.values()]
    fprop, wgrad = conv_train_launches() if mode == "f32" else (0, 0)
    conv_want = [(TRAIN_STEPS * fprop, TRAIN_STEPS * wgrad), (0, 0)]
    if conv_launches != conv_want:
        raise AssertionError(f"train steps launched (conv3d_fprop, "
                             f"conv3d_wgrad) {conv_launches} times through "
                             f"the kernels and the plain route, expected "
                             f"{conv_want}")
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
              "conv_launches": timing["pallas"]["conv_launches"],
              "wgrad_launches": timing["pallas"]["wgrad_launches"],
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
        kernels.reset_launch_counts()
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
            kernels.reset_launch_counts()
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
    kernels.reset_launch_counts()
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
    profiler recorded (late in a process that has profiled before, it
    misses calls, card_trace's padding or not). It runs after every other timing, so that no
    time is taken under or after this profiler's hooks."""
    from torch.profiler import ProfilerActivity

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
                with card_trace(torch, [ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        attention_bwd(k, q, m, o, lse, g, bf16_ops=ops)
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
                   seed: int = 0, seqs=(1,)) -> str:
    """Synthetic sequences (single_1, ... by `seqs`) of `frames` complex64
    radar cubes each (16 chirps, spatial x spatial, 8 elevation bins) per
    view under root/data, and their annotations for the train, val and
    test splits: joints uniform in (40, 210) of a 256-pixel image, every
    GT box 1500x1500 as tests/test_golden_ap.py inflates them (OKS divides
    by the gt area, and with the natural boxes a random model scores
    exactly 0). Returns the data directory."""
    import numpy as np

    rng = np.random.default_rng(seed)
    data = os.path.join(root, "data")
    annots = []
    for seq in seqs:
        blocks = []
        for view in ("hori", "vert"):
            os.makedirs(os.path.join(data, f"single_{seq}", view))
        for f in range(frames):
            for view in ("hori", "vert"):
                cube = np.empty((16, spatial, spatial, 8), np.complex64)
                cube.real = rng.standard_normal(cube.shape, np.float32)
                cube.imag = rng.standard_normal(cube.shape, np.float32)
                np.save(os.path.join(data, f"single_{seq}", view,
                                     f"{f:09d}.npy"), cube)
            blocks.append({"image": f"{f:09d}.jpg",
                           "joints": rng.uniform(40, 210, (14, 2)).tolist(),
                           "bbox": [0.0, 0.0, 1500.0, 1500.0]})
        annots.append(blocks)
    for phase in ("train", "val", "test"):
        with open(os.path.join(data, f"hrnet_annot_{phase}.json"), "w") as fp:
            json.dump(annots, fp)
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


def seed_checkpoint(cfg, dir_name: str, name: str = "checkpoint.pth"):
    """./logs/<dir_name>/<name>: seeded N(0, 0.03) weights (see
    serve_slice), an optimizer that has taken no step, epoch 0."""
    from hupr_tpu_torch.engine.checkpoint import snapshot, write_checkpoint
    from hupr_tpu_torch.engine.steps import make_optimizer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    model = build_model(cfg, device="cpu")
    model.load_state_dict(synthetic_state_dict(model, seed=0, scale=0.03))
    os.makedirs(os.path.join("logs", dir_name), exist_ok=True)
    write_checkpoint(os.path.join("logs", dir_name, name),
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
        kernels.reset_launch_counts()
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
    from torch.profiler import ProfilerActivity

    with card_trace(torch, [ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    return {"host_launch_calls_per_frame": sum(
                1 for e in events if "Launch" in e.name
                and e.device_type == cpu),
            "device_kernels_per_frame": sum(
                1 for e in events if on_card(torch, e)
                and not e.name.startswith(("Memcpy", "Memset"))),
            "attention_fwd_kernels": sum(
                1 for e in events if on_card(torch, e)
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
    kernels the replays ran are counted from the card's trace, by the
    first profiler run (stream_launches). Returns the results by dtype and, for
    stream_launches, what it profiles: one more frame of each timed
    estimator and the main path's sequence again."""
    import numpy as np

    from hupr_tpu_torch.config import (fast_serving_config,
                                       flagship_serving_config)
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention, conv
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
        kernels.reset_launch_counts()
        pred, maxv = stream_sequence(est, frames)
        torch.cuda.synchronize()
        launches = wrapper_launches(attention)["attention_fwd"]
        conv_launches = conv.conv3d_3x3x3.launches
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
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STREAM_TIMED):
                est.process_frame(*frame)
            ms = 1e3 * (time.perf_counter() - t0) / STREAM_TIMED
            per_frame = {m: n / STREAM_TIMED for m, n in
                         attention.attention_fwd.launches_by_mode.items()}
            timing[name] = {
                "stream_latency_ms": ms,
                "wrapper_launches_per_frame": per_frame,
                "conv_launches_per_frame":
                    conv.conv3d_3x3x3.launches / STREAM_TIMED}
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
            "sequence_conv_launches": conv_launches,
            "maxvals_max_abs_err_vs_e2e": float(np.abs(maxv - want_maxv)
                                                .max()),
            "keypoint_agreement_vs_e2e": agree,
            "maxvals_max_abs_err_graph_vs_eager": float(
                np.abs(maxv - maxv_e).max()),
            "keypoints_graph_equal_eager": bool((pred == pred_e).all())}
        checks = {
            "launches": launches == want_launches,
            "conv launches": conv_launches
            == conv_launches_want(12 * (3 + lag), mode, 1),
            # a replay calls no wrapper; an eager step launches 12
            "per-frame wrapper launches":
                timing["graph"]["wrapper_launches_per_frame"] == {}
                and timing["eager"]["wrapper_launches_per_frame"]
                == {mode: 12.0},
            "per-frame conv launches":
                timing["graph"]["conv_launches_per_frame"] == 0
                and timing["eager"]["conv_launches_per_frame"]
                == conv_launches_want(12, mode, 1),
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
    write_annotations(data, frames, seed)
    return root


def write_annotations(data: str, frames: int, seed: int = 0) -> None:
    """Annotations of one sequence (single_1) of `frames` frames for the
    train, val and test splits under `data`, as write_sequence makes them:
    joints uniform in (40, 210) of a 256-pixel image, every GT box
    1500x1500."""
    import numpy as np

    rng = np.random.default_rng(seed)
    blocks = [{"image": f"{f:09d}.jpg",
               "joints": rng.uniform(40, 210, (14, 2)).tolist(),
               "bbox": [0.0, 0.0, 1500.0, 1500.0]} for f in range(frames)]
    for phase in ("train", "val", "test"):
        with open(os.path.join(data, f"hrnet_annot_{phase}.json"), "w") as fp:
            json.dump([blocks], fp)


def make_learnable_dataset(root: str, duration: int = 8, seed: int = 0):
    """tests/test_learning.py's data, numpy only: cubes with a spike at
    (range=y/4, azimuth=x/4) across all chirps and elevations, all 14
    joints colocated at the frame's (x, y)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "single_1/hori"), exist_ok=True)
    os.makedirs(os.path.join(root, "single_1/vert"), exist_ok=True)
    blocks = []
    for f in range(duration):
        x = float(rng.uniform(48, 208))
        y = float(rng.uniform(48, 208))
        cube = (0.05 * (rng.standard_normal((16, 64, 64, 8))
                        + 1j * rng.standard_normal((16, 64, 64, 8)))
                ).astype(np.complex64)
        cube[:, int(y / 4), int(x / 4), :] += 3.0 + 3.0j
        np.save(os.path.join(root, f"single_1/hori/{f:09d}.npy"), cube)
        np.save(os.path.join(root, f"single_1/vert/{f:09d}.npy"), cube)
        blocks.append({"image": "%09d.jpg" % f, "joints": [[x, y]] * 14,
                       "bbox": [x - 50, y - 50, x + 50, y + 50]})
    for phase in ("train", "val", "test"):
        with open(os.path.join(root, f"hrnet_annot_{phase}.json"), "w") as fp:
            json.dump([blocks], fp)


# tests/test_learning_fast.py's reduced capture geometry (32x32 cubes)
LEARN_ADC_PARAMS = dict(num_adc_samples=128, num_chirp=96, idx_proc_chirp=32,
                        num_group_chirp=2, range_gate_start=94)


def point_target_frame(r_out: int, a_out: int, rp, amp: float = 300.0,
                       doppler: int = 1):
    """tests/test_learning_fast.py's point target, numpy only: one frame of
    complex ADC (RX, num_chirp, num_adc) whose radar cube peaks at
    (range_bin=r_out, azimuth_bin=a_out), on Doppler bin `doppler`, with a
    Hamming taper across the 8-element virtual aperture."""
    import numpy as np

    nab = rp.num_angle_bins
    kr = rp.range_gate_start - r_out
    ka = (nab // 2 - 1 - a_out) % nab
    t = np.arange(rp.num_adc_samples)
    j = np.arange(rp.num_chirp)
    rx = np.arange(rp.num_rx)
    rng_ph = np.exp(2j * np.pi * kr * t / rp.num_adc_samples)
    dop_ph = np.exp(2j * np.pi * doppler * (j // 3) / rp.idx_proc_chirp)
    n = rx[:, None] + np.where(j % 3 == 0, 0,
                               np.where(j % 3 == 1, 2, 4))[None, :]
    ant_ph = np.exp(2j * np.pi * ka * n / nab)
    ant_ph = ant_ph * (0.54 - 0.46 * np.cos(2 * np.pi * n / 7))
    return (amp * ant_ph[:, :, None] * dop_ph[None, :, None]
            * rng_ph[None, None, :])


def serialize_dca1000(complex_data):
    """(RX, chirps, ADC) complex -> the DCA1000's int16 stream (the
    inverse of ops/dsp.decode_dca1000), numpy only."""
    import numpy as np

    i_flat = np.real(complex_data).transpose(1, 0, 2).reshape(-1)
    q_flat = np.imag(complex_data).transpose(1, 0, 2).reshape(-1)
    raw = np.zeros((i_flat.size // 2, 4), dtype=np.int16)
    raw[:, 0] = i_flat[0::2]
    raw[:, 1] = i_flat[1::2]
    raw[:, 2] = q_flat[0::2]
    raw[:, 3] = q_flat[1::2]
    return raw.reshape(-1)


def make_learnable_adc_dataset(root: str, rp, duration: int = 80,
                               seed: int = 0, img_size: int = 128) -> str:
    """tests/test_learning_fast.py's data, numpy only: point-target raw
    captures (root/adc/single_1/{hori,vert}/adc_data.bin) with joints
    colocated at the target, the horizontal view carrying y on its range
    axis and x on its azimuth axis and the vertical view the transpose,
    and annotations; no .npy cube. Returns the capture root."""
    import numpy as np

    rng = np.random.default_rng(seed)
    adc_dir = os.path.join(root, "adc")
    frames_h, frames_v, blocks = [], [], []
    for f in range(duration):
        x = float(rng.uniform(24, img_size - 24))
        y = float(rng.uniform(24, img_size - 24))
        for sig, frames in ((point_target_frame(int(y / 4), int(x / 4), rp),
                             frames_h),
                            (point_target_frame(int(x / 4), int(y / 4), rp),
                             frames_v)):
            noise = (rng.integers(-10, 10, sig.shape)
                     + 1j * rng.integers(-10, 10, sig.shape))
            frames.append(np.round(sig.real) + 1j * np.round(sig.imag)
                          + noise)
        blocks.append({"image": "%09d.jpg" % f, "joints": [[x, y]] * 14,
                       "bbox": [x - 25, y - 25, x + 25, y + 25]})
    for view, frames in (("hori", frames_h), ("vert", frames_v)):
        d = os.path.join(adc_dir, "single_1", view)
        os.makedirs(d, exist_ok=True)
        stream = np.concatenate([serialize_dca1000(fr) for fr in frames])
        stream.tofile(os.path.join(d, "adc_data.bin"))
    for phase in ("train", "val", "test"):
        with open(os.path.join(root, f"hrnet_annot_{phase}.json"),
                  "w") as fp:
            json.dump([blocks], fp)
    return adc_dir


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
    at the runner phase's bars, each step of the first path taken from the
    weights, BN statistics and Adam state that the second holds before its
    own step: the two then differ by that step's computation alone, where
    two trajectories left to run apart on rounding read each leaf's update
    up to the bar on right code (PERF.md section 6); and three planted
    faults that the first hold must catch (the I and Q lanes swapped in
    the decode, the frames off by one, one leaf left untrained). Times
    FAST_TIMED_EPOCHS epochs of the chunk-mode train loop one by one after
    a warm-up epoch, and raw-ADC sequence eval. Returns the results."""
    import contextlib
    import copy
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
        kernels.reset_launch_counts()
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

        def path(kind):
            model = build_model(cfg32)
            model.load_state_dict(w0)
            tx = make_optimizer(cfg32, model)
            if kind == "classic":
                step = make_train_step(model, tx, t.lossDecay, geometry)
            elif kind == "cube":
                step = chunk_train.make_chunk_train_step(model, tx, geometry)
            else:
                step = chunk_train.make_adc_chunk_train_step(
                    model, tx, geometry, radar_params=rp,
                    num_frames=d.numFrames)
            return TrainState(model, tx), step

        def batch_of(kind, ci):
            if kind == "classic":
                return classic_batch(ci)
            loader = adc_loader if kind == "adc" else cube_loader
            batch, _ = chunk_train.device_put_chunk(
                loader._assemble(loader.chunks[ci]))
            return batch

        def drive(kind, ref, dsp=pinned):
            """`kind`'s steps beside `ref`'s over the picks, each of
            `kind`'s taken from the weights, BN statistics and Adam state
            that `ref` holds before its own step, with `dsp` as the raw-ADC
            path's cube DSP. Returns ((kind's losses, ref's), (w0 plus the
            sum of kind's steps, ref's state)) for hold_readings."""
            state, step = path(kind)
            ref_state, ref_step = path(ref)
            total = {k: v.detach().clone()
                     for k, v in state.model.state_dict().items()}
            losses, ref_losses = [], []
            chunk_train.radar_cube_frames = dsp
            try:
                for i, ci in enumerate(picks):
                    lr = t.lr * t.lrDecay ** i
                    before = {k: v.detach().clone() for k, v in
                              ref_state.model.state_dict().items()}
                    state.model.load_state_dict(before)
                    state.optimizer.load_state_dict(
                        copy.deepcopy(ref_state.optimizer.state_dict()))
                    state, m = step(state, batch_of(kind, ci), lr, 0.0)
                    ref_state, m_ref = ref_step(ref_state, batch_of(ref, ci),
                                                lr, 0.0)
                    for k, v in state.model.state_dict().items():
                        if v.is_floating_point():
                            total[k] += v - before[k]
                        else:
                            total[k] = v.clone()
                    losses.append(m["loss"].item())
                    ref_losses.append(m_ref["loss"].item())
            finally:
                chunk_train.radar_cube_frames = cube
            return ((losses, ref_losses),
                    (_StateDict(total), ref_state.model))

        pairs = {"adc_vs_cube": drive("adc", "cube"),
                 "chunk_vs_classic": drive("cube", "classic")}
        classic.clear()
        # planted faults that the raw-ADC hold must catch: the decode's I
        # and Q lanes swapped, each chunk's frames off by one, and the
        # leaf that reads the hold's worst update left untrained
        (adc_losses, cube_losses), (adc_sd, cube_model) = pairs["adc_vs_cube"]
        leaf = "RAchirpNet.temporalConvWx1x1.weight"
        untrained = dict(adc_sd.state_dict())
        untrained[leaf] = w0[leaf].to(untrained[leaf].device)
        faulty = {
            "iq_swapped": drive(
                "adc", "cube", lambda f, p: pinned(1j * f.conj(), p)),
            "frames_off_by_one": drive(
                "adc", "cube", lambda f, p: pinned(f.roll(1, 0), p)),
            "leaf_untrained": ((adc_losses, cube_losses),
                               (_StateDict(untrained), cube_model))}
        planted = {}
        for fault, (f_losses, f_models) in faulty.items():
            reading, passed = hold_readings(torch, f_losses, f_models, w0)
            planted[fault] = {key: reading[key] for key in (
                "loss_max_rel_err", "allclose_excess", "update_max_rel_err",
                "update_worst_leaf")} | {"caught": not passed}
        del faulty, untrained
        names = {"adc_vs_cube": "ADC chunk step vs cube chunk step",
                 "chunk_vs_classic": "cube chunk step vs classic step"}
        holds = {key: hold_steps(torch, names[key], *pair, w0)
                 for key, pair in pairs.items()}
        del pairs, adc_sd, cube_model

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


def train_max_phase(torch, card: str, peaks):
    """bench.py's train_max protocol (bench.py:172-203) on the port:
    max_training_config()'s classic train step (B=128, bfloat16, remat,
    the kernels) on bench.py's N(0, 1) batch at 128 rows from N(0, 0.03)
    weights (seed 0), against the same step with remat off from the same
    weights, in turns on one card. The first step of each runs under
    torch's flop counter (scripts/batch_sweep.step_flops: the recompute
    counted, the kernels' FLOPs added); then MAX_STEPS timed steps each
    with the counts zeroed just before and read just after: 12 + 12 bf16
    launches a step in both (the recompute launches none). The two compute
    the same math and on the card differ by cuDNN's non-deterministic
    weight gradients, so it holds the losses of every step at
    TRAIN_BARS['bf16'], every weight after the first step at PARAM_ATOL /
    PARAM_RTOL, and after the last step the BN statistics at the bf16 bars
    and num_batches_tracked exactly (a recompute that moved BN's buffers
    would count every step twice). The weights after the last step are
    read, not held: ~20k of the 35.5M weights get first-step gradients of
    opposite signs in the two runs, and Adam moves each weight by up to lr
    a step whatever its gradient's size, so two right runs drift apart by
    up to 2 lr a step, past PARAM_ATOL from the third step on at lr 2.5e-4
    (PERF.md section 6). remat's max_memory_allocated over its
    steps must be lower. Returns the results and, for each variant, a
    function that takes one more step."""
    from hupr_tpu_torch.config import max_training_config
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.scripts.batch_sweep import step_flops
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    cfgs = {"remat": max_training_config(), "no_remat": max_training_config()}
    cfgs["no_remat"].MODEL.remat = False
    cfg = cfgs["remat"]
    t, ds = cfg.TRAINING, cfg.DATASET
    if (t.batchSize, cfg.MODEL.computeDtype, cfg.MODEL.attention) != \
            (MAX_BATCH, "bfloat16", "pallas"):
        raise AssertionError(f"max recipe {t.batchSize} "
                             f"{cfg.MODEL.computeDtype} "
                             f"{cfg.MODEL.attention}")
    geometry = (ds.numKeypoints, ds.heatmapSize, ds.imgSize)
    batch = bench_batch(torch, cfg)
    paths, weights = {}, None
    for name, c in cfgs.items():
        model = build_model(c)
        if weights is None:
            weights = synthetic_state_dict(model, seed=0, scale=0.03)
        model.load_state_dict(weights, strict=True)
        tx = make_optimizer(c, model)
        paths[name] = {"state": TrainState(model, tx), "cfg": c,
                       "step": make_train_step(model, tx, t.lossDecay,
                                               geometry), "losses": []}
    del weights

    def flat_params(p):
        return torch.cat([v.detach().flatten()
                          for v in p["state"].model.parameters()])

    first = {}
    for name, p in paths.items():       # the first step, FLOPs counted
        p["state"], metrics, p["flops"] = step_flops(
            p["cfg"], p["step"], p["state"], batch, t.lr)
        p["losses"].append(metrics["loss"])
        first[name] = flat_params(p)
    first_excess = allclose_excess(first["remat"], first["no_remat"],
                                   PARAM_ATOL, PARAM_RTOL)
    first_err = (first["remat"] - first["no_remat"]).abs().max().item()
    del first

    timing = {}
    for name, p in paths.items():       # in turns on one card
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(MAX_STEPS):
            p["state"], metrics = p["step"](p["state"], batch, t.lr, 0.0)
            p["losses"].append(metrics["loss"])
        torch.cuda.synchronize()
        timing[name] = {"seconds": time.perf_counter() - t0,
                        "by_mode": wrapper_launches(attention),
                        "peak": torch.cuda.max_memory_allocated(),
                        "resident": resident}
    want = {"attention_fwd": {"bf16": 12 * MAX_STEPS},
            "attention_bwd": {"bf16": 12 * MAX_STEPS},
            "attention_fwd_unfolded": {}}
    losses = {name: [x.item() for x in p["losses"]]
              for name, p in paths.items()}
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["remat"], losses["no_remat"]))
    bufs, bufs_x = ({k: v for k, v in p["state"].model.named_buffers()}
                    for p in paths.values())
    stats = [k for k, v in bufs.items() if v.is_floating_point()]
    counts_equal = all(torch.equal(bufs[k], bufs_x[k]) for k in bufs
                       if k not in stats)
    bars = TRAIN_BARS["bf16"]
    stats_excess = max(allclose_excess(bufs[k], bufs_x[k], *bars["stats"])
                       for k in stats)
    stats_err = max((bufs[k] - bufs_x[k]).abs().max().item() for k in stats)
    last_excess = allclose_excess(*(flat_params(p) for p in paths.values()),
                                  PARAM_ATOL, PARAM_RTOL)
    result = {"card": card, "batch": MAX_BATCH, "steps": 1 + MAX_STEPS,
              "timed_steps": MAX_STEPS, "compute_dtype": "bfloat16"}
    for name in paths:
        sfx = "" if name == "remat" else "_no_remat"
        ms = 1e3 * timing[name]["seconds"] / MAX_STEPS
        flops = paths[name]["flops"]
        result |= {
            f"train_max_ms_per_step{sfx}": ms,
            f"train_max_samples_per_sec{sfx}": 1e3 * MAX_BATCH / ms,
            f"train_max_tflops_per_step{sfx}": flops / 1e12,
            f"train_max_mfu_vs_bf16_peak{sfx}":
                flops / (ms / 1e3) / peaks["bf16"],
            f"max_memory_allocated{sfx}": timing[name]["peak"],
            f"memory_allocated_before_steps{sfx}": timing[name]["resident"],
            f"launches_by_mode{sfx}": timing[name]["by_mode"],
            f"losses{sfx}": losses[name]}
    fwd = timing["remat"]["by_mode"]["attention_fwd"].get("bf16", 0)
    bwd = timing["remat"]["by_mode"]["attention_bwd"].get("bf16", 0)
    result |= {"bf16_peak_tflops": peaks["bf16"] / 1e12,
               "loss_max_rel_err_vs_no_remat": loss_rel,
               "param_max_abs_err_after_first_step": first_err,
               "param_allclose_excess_after_first_step": first_excess,
               "param_allclose_excess_after_last_step_read": last_excess,
               "bn_stats_max_abs_err_vs_no_remat": stats_err,
               "bn_stats_allclose_excess": stats_excess,
               "bn_counts_equal": counts_equal,
               "attention_fwd_launches": fwd, "attention_bwd_launches": bwd}
    print(json.dumps({"train_max": result}), flush=True)
    del bufs, bufs_x
    for name in timing:
        if timing[name]["by_mode"] != want:
            raise AssertionError(f"train_max {name} launched "
                                 f"{timing[name]['by_mode']}; expected "
                                 f"{want}")
    if not all(map(math.isfinite, losses["remat"] + losses["no_remat"])):
        raise AssertionError(f"non-finite train_max losses {losses}")
    if not loss_rel <= bars["loss_rtol"]:
        raise AssertionError(f"train_max losses differ from the step "
                             f"without remat by {loss_rel} relative > "
                             f"{bars['loss_rtol']}")
    if not first_excess <= 0:
        raise AssertionError(f"after the first step, weights differ from "
                             f"the step without remat by up to {first_err}")
    if not (stats_excess <= 0 and counts_equal):
        raise AssertionError(f"after the steps, BN statistics differ from "
                             f"the step without remat by up to {stats_err},"
                             f" num_batches_tracked equal: {counts_equal}")
    if not result["max_memory_allocated"] < \
            result["max_memory_allocated_no_remat"]:
        raise AssertionError(
            f"remat's max_memory_allocated {result['max_memory_allocated']}"
            f" is not under the step's without remat "
            f"{result['max_memory_allocated_no_remat']}")
    return result, {name: (lambda p=p: p["step"](p["state"], batch, t.lr,
                                                 0.0))
                    for name, p in paths.items()}


def learn_run(torch, cfg, state, step, epoch, steps: int, lr: float,
              runner_dir: str, eval_step=None, eval_batches=None):
    """`steps` SGD steps of `step` from `state` over epoch after epoch of
    batches (`epoch()` returns one epoch's iterator), then
    the Runner's eval of the test split on the trained weights (main.run's
    eval flow: sequence eval, from raw ADC where cfg asks for it); with
    `eval_step`, the decoded pixel error on `eval_batches` as
    tests/test_learning.py reads it. The kernel counts are zeroed just
    before the steps and read after them and after the evals. Returns the
    readings."""
    import itertools

    import numpy as np

    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.ops import attention

    epochs = itertools.chain.from_iterable(
        epoch() for _ in itertools.count())
    losses = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for batch in itertools.islice(epochs, steps):
        state, metrics = step(state, batch, lr, 0.0)
        losses.append(metrics["loss"])
    losses = [x.item() for x in losses]
    out = {"first_loss": losses[0], "last_loss": losses[-1],
           "steps": len(losses), "train_s": time.perf_counter() - t0,
           "train_launches": wrapper_launches(attention)}
    if eval_step is not None:
        errs = []
        for b in eval_batches:
            pred = eval_step(state, b)["pred2d"].cpu().numpy() * 4.0
            errs.append(np.abs(pred - b["jointsGroup"].cpu().numpy()).mean())
        out["pixel_error"] = float(np.mean(errs))
    runner = Runner(runner_args(runner_dir, True), cfg)
    runner.model.load_state_dict(state.model.state_dict())
    out["ap"] = runner.eval(visualization=False)
    out["sequence_eval"] = runner._seq_eval is not None
    out["sequence_eval_adc"] = out["sequence_eval"] and \
        runner._seq_eval.adc is not None
    out["launches"] = wrapper_launches(attention)
    out["losses"] = losses
    return out


def check_learning(card: str, label: str, results: dict, mode: str,
                   steps: int, loss_ratio: float, pixel_bar=None) -> dict:
    """Prints the `label` line of a learning phase's runs (attention ->
    learn_run readings) and holds each run to its bars: finite losses,
    last < loss_ratio x first, AP > 0.1, the pixel error under
    `pixel_bar` where given; 12 forward and 12 backward launches a step in
    `mode` through the kernels and more forward launches in its eval, none
    through xla. Returns the line's object."""
    line = {"card": card}
    for attn, r in results.items():
        line[attn] = {k: v for k, v in r.items() if k != "losses"}
        line[attn]["losses_every_10th"] = r["losses"][::10]
    print(json.dumps({label: line}), flush=True)
    for attn, r in results.items():
        want = {"attention_fwd": {mode: 12 * steps},
                "attention_bwd": {mode: 12 * steps},
                "attention_fwd_unfolded": {}} if attn == "pallas" else \
            {"attention_fwd": {}, "attention_bwd": {},
             "attention_fwd_unfolded": {}}
        evals = r["launches"]["attention_fwd"].get(mode, 0) - \
            want["attention_fwd"].get(mode, 0)
        if r["train_launches"] != want or (attn == "pallas" and evals <= 0) \
                or (attn == "xla" and r["launches"] != want) or \
                r["launches"]["attention_bwd"] != want["attention_bwd"]:
            raise AssertionError(f"{label} {attn}: launched "
                                 f"{r['train_launches']} in training, "
                                 f"{r['launches']} in all; expected {want} "
                                 f"and more forward launches in the eval")
        if not (math.isfinite(r["last_loss"]) and r["steps"] == steps
                and r["last_loss"] < loss_ratio * r["first_loss"]):
            raise AssertionError(f"{label} {attn}: losses {r['first_loss']}"
                                 f" -> {r['last_loss']} over {r['steps']} "
                                 f"steps; the bar is < {loss_ratio} x first")
        if pixel_bar is not None and not r["pixel_error"] < pixel_bar:
            raise AssertionError(f"{label} {attn}: pixel error "
                                 f"{r['pixel_error']} >= {pixel_bar}")
        if not r["ap"] > 0.1:
            raise AssertionError(f"{label} {attn}: AP {r['ap']} <= 0.1")
    return line


def learn_phase(torch, card: str):
    """tests/test_learning.py's recipe at full width through the kernels:
    flagship_training_config() (numFilters 32, 64x64 maps, float32) on
    make_learnable_dataset's LEARN_FRAMES frames, batch LEARN_BATCH,
    LEARN_STEPS Adam steps at the recipe's lr (1e-4) from the port's own
    initialization (torch's defaults, seed 0), then the decoded pixel
    error on the train windows and the Runner's AP (sequence eval); again
    from the same weights through MODEL.attention xla. Each run must clear
    the JAX test's bars: last loss < 0.5 x first, pixel error < 25, AP >
    0.1.
    Returns the `learn` line."""
    import shutil
    import tempfile

    from hupr_tpu_torch.config import flagship_training_config
    from hupr_tpu_torch.data.dataset import BatchLoader, get_dataset
    from hupr_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                             make_optimizer, make_train_step)
    from hupr_tpu_torch.models.hupr import build_model

    root = tempfile.mkdtemp(prefix="hupr_learn_")
    cwd = os.getcwd()
    try:
        data_dir = os.path.join(root, "data")
        make_learnable_dataset(data_dir, LEARN_FRAMES)
        os.chdir(root)
        torch.manual_seed(0)
        weights = build_model(flagship_training_config(),
                              "cpu").state_dict()
        results = {}
        for attn in ("pallas", "xla"):
            cfg = flagship_training_config()
            d = cfg.DATASET
            d.dataDir, d.duration = data_dir, LEARN_FRAMES
            d.trainName = d.valName = d.testName = [1]
            cfg.MODEL.attention = attn
            cfg.TRAINING.batchSize = cfg.TEST.batchSize = LEARN_BATCH
            cfg.TRAINING.epochs = 1
            geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
            batches = [{k: torch.as_tensor(b[k], device="cuda")
                        for k in ("hori", "vert", "jointsGroup")}
                       for b in BatchLoader(get_dataset("train", cfg),
                                            LEARN_BATCH)]
            model = build_model(cfg)
            model.load_state_dict(weights)
            tx = make_optimizer(cfg, model)
            results[attn] = learn_run(
                torch, cfg, TrainState(model, tx),
                make_train_step(model, tx, geometry=geometry),
                lambda: iter(batches), LEARN_STEPS, cfg.TRAINING.lr,
                f"learn_{attn}", make_eval_step(model, geometry=geometry),
                batches)
            del batches, model, tx
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return check_learning(card, "learn", results, "f32", LEARN_STEPS, 0.5,
                          pixel_bar=25.0)


def learn_fast_phase(torch, card: str):
    """tests/test_learning_fast.py's recipe at numFilters 32 through the
    kernels: fast_training_config() (bfloat16 compute and wire, chunk-mode
    training from raw ADC, raw-ADC sequence eval) on
    make_learnable_adc_dataset's LEARN_FAST_FRAMES point-target captures
    at that test's 32x32 geometry (LEARN_ADC_PARAMS), chunk batch
    LEARN_FAST_BATCH, LEARN_FAST_STEPS Adam steps at the recipe's lr (a
    reshuffled epoch of chunks after another) from the port's own
    initialization (torch's defaults, seed 0), then the Runner's raw-ADC
    sequence eval; again from the same weights through MODEL.attention
    xla. The kernels take C in {64, 128, 256}, so the width stays 32 where
    the CPU test runs 2. Each run must clear the JAX test's bars: last
    loss < 0.2 x first, AP > 0.1. Returns the `learn_fast` line."""
    import shutil
    import tempfile

    from hupr_tpu_torch.config import fast_training_config
    from hupr_tpu_torch.data.adc import ADCFrameSource
    from hupr_tpu_torch.data.dataset import get_dataset
    from hupr_tpu_torch.engine.chunk_train import (ADCChunkLoader,
                                                   device_put_chunk,
                                                   make_adc_chunk_train_step)
    from hupr_tpu_torch.engine.steps import TrainState, make_optimizer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops.dsp import RadarParams

    def config(attn):
        cfg = fast_training_config()
        d = cfg.DATASET
        d.dataDir, d.adcDir = data_dir, adc_dir
        d.adcParams, d.duration = dict(LEARN_ADC_PARAMS), LEARN_FAST_FRAMES
        d.trainName = d.valName = d.testName = [1]
        d.rangeSize = d.azimuthSize = d.heatmapSize = 32
        d.imgSize = 128
        cfg.MODEL.attention = attn
        t = cfg.TRAINING
        t.batchSize, t.epochs = LEARN_FAST_BATCH, 1
        cfg.TEST.batchSize = LEARN_FAST_TEST_BATCH
        return cfg

    root = tempfile.mkdtemp(prefix="hupr_learn_fast_")
    cwd = os.getcwd()
    try:
        data_dir = os.path.join(root, "data")
        os.makedirs(data_dir)
        rp = RadarParams(**LEARN_ADC_PARAMS)
        adc_dir = make_learnable_adc_dataset(data_dir, rp, LEARN_FAST_FRAMES)
        os.chdir(root)
        torch.manual_seed(0)
        weights = build_model(config("pallas"), "cpu").state_dict()
        results = {}
        for attn in ("pallas", "xla"):
            cfg = config(attn)
            d = cfg.DATASET
            if d.radar_params() != rp:
                raise AssertionError("learn_fast: capture geometry")
            loader = ADCChunkLoader(get_dataset("train", cfg),
                                    LEARN_FAST_BATCH,
                                    ADCFrameSource(adc_dir, rp), seed=0,
                                    shuffle=True)
            model = build_model(cfg)
            model.load_state_dict(weights)
            tx = make_optimizer(cfg, model)
            step = make_adc_chunk_train_step(
                model, tx, (d.numKeypoints, d.heatmapSize, d.imgSize),
                radar_params=rp, num_frames=d.numFrames)
            results[attn] = learn_run(
                torch, cfg, TrainState(model, tx), step,
                lambda: (device_put_chunk(b)[0] for b in loader),
                LEARN_FAST_STEPS, cfg.TRAINING.lr, f"learn_fast_{attn}")
            del loader, model, tx, step
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    return check_learning(card, "learn_fast", results, "bf16",
                          LEARN_FAST_STEPS, 0.2)


def front_end_phase(torch, card: str):
    """The system's two ends, chained on one synthetic capture: a
    full-geometry DCA1000 capture per view (FRONT_FRAMES frames of 4 RX x
    192 chirps x 256 samples, int16 uniform in [-300, 300) from a seed)
    written as preprocessing/raw_data/iwr1843/HuPR/single_1/{hori,vert}/
    adc_data.bin in a scratch working directory, then
    - preprocess: the preprocessing CLI's RadarPreprocessor on the card
      (batch_frames FRONT_BATCH) writes data/HuPR/single_1's cubes; every
      cube held within CUBE_PEAK_REL of its peak against the port's
      radar_cube_frames on the CPU, the first and last frame of each view
      within ORACLE_PEAK_REL against tests/oracles.oracle_radar_cube;
    - audit: those cubes with write_sequence's kind of annotations, the
      flagship recipe (runner_config, the kernels) and a seeded
      model_best.pth: the parity audit's body exits 2 before the weights
      exist, 0 with them (its AP equal to Runner.eval's from the same
      .pth), and 1 with --expected-ap at AP + 0.1;
    - live: the same two captures replayed over loopback UDP through live
      serving's body at full width (flagship float32, the kernels, the
      same .pth, the C++ reassembler asked for), every byte received, no
      late byte, overflow or resync, and its poses held against a
      StreamingPoseEstimator fed the captures' int16 planes directly, at
      the stream phase's bars.
    The kernel counts are zeroed just before the audit's and live
    serving's runs and read just after. No profiler runs here. Returns
    the `front_end` line's object."""
    import shutil
    import tempfile

    import numpy as np

    from hupr_tpu_torch.config import flagship_serving_config
    from hupr_tpu_torch.data.capture import stream_to_iq_planes
    from hupr_tpu_torch.engine.runner import Runner
    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.ops.dsp import (RadarParams, frames_from_adc,
                                        radar_cube_frames)
    from hupr_tpu_torch.preprocessing.process_iwr1843 import (
        RadarPreprocessor, decode_dca1000_np)
    from hupr_tpu_torch.scripts import live_serve, parity_audit

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from oracles import oracle_radar_cube

    rp = RadarParams()
    samples = 2 * rp.num_rx * rp.num_chirp * rp.num_adc_samples
    frames = FRONT_FRAMES
    views = ("hori", "vert")
    line = {"card": card, "frames": frames}
    root = tempfile.mkdtemp(prefix="hupr_front_end_")
    cwd = os.getcwd()
    try:
        os.chdir(root)
        rng = np.random.default_rng(FRONT_SEED)
        raw = os.path.join("preprocessing", "raw_data", "iwr1843", "HuPR",
                           "single_1")
        streams = {}
        for view in views:
            os.makedirs(os.path.join(raw, view))
            streams[view] = rng.integers(-300, 300, frames * samples
                                         ).astype(np.int16)
            streams[view].tofile(os.path.join(raw, view, "adc_data.bin"))

        # ---- preprocess: the CLI's body on the card
        pre = RadarPreprocessor(num_sequences=1, batch_frames=FRONT_BATCH)
        _, seconds = timed(torch, pre.process_radar_data_hori_vert)
        print(flush=True)        # the CLI's progress line ends with \r
        cube_err, oracle_err = 0.0, 0.0
        out = os.path.join("data", "HuPR", "single_1")
        for view in views:
            adc = decode_dca1000_np(streams[view], rp)
            x = frames_from_adc(torch.from_numpy(adc), rp)
            for start in range(0, frames, 16):
                stop = min(start + 16, frames)
                with torch.inference_mode():
                    want = radar_cube_frames(x[start:stop], rp).numpy()
                for k, f in enumerate(range(start, stop)):
                    got = np.load(os.path.join(out, view, f"{f:09d}.npy"))
                    if got.shape != (16, 64, 64, 8) or \
                            got.dtype != np.complex64:
                        raise AssertionError(f"front_end: cube {view} {f}: "
                                             f"{got.shape} {got.dtype}")
                    cube_err = max(cube_err, float(
                        np.abs(got - want[k]).max() / np.abs(want[k]).max()))
                    if f in (0, frames - 1):
                        o = oracle_radar_cube(
                            adc[:, rp.num_chirp * f:rp.num_chirp * (f + 1)])
                        oracle_err = max(oracle_err, float(
                            np.abs(got - o).max() / np.abs(o).max()))
        line["preprocess"] = {
            "preprocess_frames_per_sec": len(views) * frames / seconds,
            "seconds": seconds, "batch_frames": FRONT_BATCH,
            "cube_rel_err_vs_cpu": cube_err,
            "oracle_rel_err_frames_first_last": oracle_err}

        # ---- audit: the parity audit's body on those cubes
        data = os.path.join("data", "HuPR")
        write_annotations(data, frames, FRONT_SEED)
        cfg = runner_config(data, "pallas")
        cfg.DATASET.duration = frames
        parse = parity_audit.build_arg_parser().parse_args
        rc_missing, _ = parity_audit.run_audit(parse(["--dir", "front_end"]),
                                               cfg)
        seed_checkpoint(cfg, "front_end", "model_best.pth")
        kernels.reset_launch_counts()
        (rc, report), audit_s = timed(torch, lambda: parity_audit.run_audit(
            parse(["--dir", "front_end"]), cfg))
        audit_launches = wrapper_launches(attention)["attention_fwd"]
        if report is None:
            raise AssertionError(f"front_end: the audit exited {rc} with "
                                 f"the cubes and the weights in place")
        ap = report["AP"]
        rc_gate, gate = parity_audit.run_audit(parse(
            ["--dir", "front_end", "--expected-ap", str(ap + 0.1)]), cfg)
        runner = Runner(runner_args("front_end", eval_mode=True), cfg)
        runner.load_model_weight("model_best")
        runner_ap = runner.eval(visualization=False)
        del runner
        eval_batches = -(-frames // cfg.TEST.batchSize)
        line["audit"] = {"exit_codes": {"missing": rc_missing, "ran": rc,
                                        "gate_missed": rc_gate},
                         "report": report, "runner_eval_ap": runner_ap,
                         "seconds": audit_s,
                         "attention_fwd_launches": audit_launches}

        # ---- live: the same captures over loopback UDP
        with open("/proc/sys/net/core/rmem_max") as fp:
            rmem_max = int(fp.read())
        print(f"net.core.rmem_max {rmem_max}", flush=True)
        ckpt = os.path.join("logs", "front_end", "model_best.pth")
        args = live_serve.build_arg_parser().parse_args(
            ["--checkpoint", ckpt, "--frames", str(frames)])
        live_cfg = flagship_serving_config()
        kernels.reset_launch_counts()
        result = live_serve.serve(args, live_cfg, streams=streams,
                                  native=True)
        live_launches = wrapper_launches(attention)["attention_fwd"]
        # the estimator fed the captures' int16 planes straight from the
        # .bin files
        ds = live_cfg.DATASET
        model = build_model(live_cfg)
        state = torch.load(ckpt, weights_only=True)["model_state_dict"]
        est = StreamingPoseEstimator(model, state, ds.radar_params(),
                                     ds.numGroupFrames, ds.numFrames)
        files = {v: np.fromfile(os.path.join(raw, v, "adc_data.bin"),
                                np.int16) for v in views}
        want = [est.process_frame(*(stream_to_iq_planes(
            files[v][f * samples:(f + 1) * samples], rp) for v in views))
            for f in range(frames)]
        want_pred = np.stack([p for p, _ in want])
        want_maxv = np.stack([m for _, m in want])
        del model, est
        full = frames * samples * 2
        agree = float((result["pred2d"] == want_pred).all(-1).mean()) \
            if result["pred2d"].shape == want_pred.shape else 0.0
        maxv_err = float(np.abs(result["maxvals"] - want_maxv).max()) \
            if result["maxvals"].shape == want_maxv.shape else math.inf
        line["live"] = {
            "live_frames_per_sec": result["fps"],
            "process_frame_ms_mean": result["process_frame_ms"],
            "served": result["served"], "seconds": result["seconds"],
            "resyncs": result["resyncs"], "native": result["native"],
            "stats": result["stats"], "rmem_max": rmem_max,
            "maxvals_max_abs_err_vs_estimator": maxv_err,
            "keypoint_agreement_vs_estimator": agree,
            "attention_fwd_launches": live_launches}
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    print(f"live process_frame {line['live']['process_frame_ms_mean']} ms "
          f"mean", flush=True)
    print(json.dumps({"front_end": line}), flush=True)
    lag = live_cfg.DATASET.numGroupFrames // 2 - 1   # latency_frames
    checks = {
        "preprocess cubes vs cpu": cube_err <= CUBE_PEAK_REL,
        "preprocess cubes vs oracle": oracle_err <= ORACLE_PEAK_REL,
        "audit exit codes": (rc_missing, rc, rc_gate) == (2, 0, 1),
        "audit AP": 0.0 <= ap <= 1.0 and gate["AP"] == ap,
        "audit AP equals Runner.eval": abs(ap - runner_ap) <= 1e-12,
        # 12 a sequence-eval batch
        "audit launches": audit_launches == {"f32": 12 * eval_batches},
        "live served": result["served"] == frames,
        "live native": result["native"],
        "live bytes": all(result["stats"][v]["bytes"] == full
                          for v in views),
        "live late/overflow": all(
            result["stats"][v]["late_bytes"] == 0
            and result["stats"][v]["overflow_frames"] == 0 for v in views),
        "live resyncs": result["resyncs"] == 0,
        "live maxvals vs estimator": maxv_err <= MAXVAL_TOL,
        "live keypoints vs estimator": agree >= STREAM_AGREE["f32"],
        # the warm-up's first frame, its capture warm-up step and its
        # capture, the sequence's first frame and its flushed frames; a
        # replay calls no wrapper
        "live launches": live_launches == {"f32": 12 * (4 + lag)},
        "live peaks spread": 1e-3 < float(want_maxv.std())}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"front_end checks failed: {failed}")
    return line


# the parallel phase: data parallel across processes. The card machine has
# one card, so two ranks share it over gloo (NCCL refuses two ranks on one
# device): this checks the path, it measures no scaling. The flagship
# batch's first DP_REAL_ROWS rows, padded to 20 (10 a rank), for DP_STEPS
# steps from seeded N(0, 0.03) weights; the Runner over DP_SEQS synthetic
# RUNNER_FRAMES-frame sequences (each rank evaluates one) for
# RUNNER_EPOCHS epochs
DP_WORLD, DP_REAL_ROWS, DP_STEPS, DP_SEQS = 2, 19, 8, (1, 2)
DP_TIMEOUT_S = 600      # for all the ranks of one spawn


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_spawn(job: str, root: str, world: int, env=None,
             opts=None) -> list:
    """Run `world` ranks of `job` (this script with --dp-worker, each
    joining a gloo group through a file:// rendezvous under `root`, its
    card cuda:0 as LOCAL_RANK 0) and wait for each within DP_TIMEOUT_S;
    raise with their output on a timeout or a non-zero exit. Returns the
    results each rank saved."""
    import torch

    rdv = os.path.join(root, f"rendezvous-{job}-{time.time_ns()}")
    procs = []
    for rank in range(world):
        full_env = {**os.environ, "LOCAL_RANK": "0", "RANK": str(rank),
                    "WORLD_SIZE": str(world), **(env or {})}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", job,
             root, str(rank), str(world), rdv, json.dumps(opts or {})],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=full_env))
    deadline = time.monotonic() + DP_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = [p.communicate(timeout=30)[0][-3000:] for p in procs]
        raise AssertionError(f"the ranks of {job} did not finish in "
                             f"{DP_TIMEOUT_S} s:\n" + "\n----\n".join(tails))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of {job} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return [torch.load(os.path.join(root, f"{job}-rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def dp_config(kind: str, spatial: int = 64):
    """The flagship float32 recipe ("f32", its classic step) or the fast
    recipe's raw-ADC chunk step, in bfloat16 ("bf16_chunk") or in float32
    ("f32_chunk", as runner_fast holds it); spatial < 64 shrinks the maps
    of "f32" (numFilters stays 32: the kernels take C in {64, 128,
    256})."""
    from hupr_tpu_torch.config import (fast_training_config,
                                       flagship_training_config)

    if kind == "f32":
        cfg = flagship_training_config()
        d = cfg.DATASET
        d.rangeSize = d.azimuthSize = d.heatmapSize = spatial
        d.imgSize = 4 * spatial
        return cfg
    cfg = fast_training_config()
    if kind == "f32_chunk":
        cfg.MODEL.computeDtype = cfg.SETUP.transferDtype = "float32"
    return cfg


def dp_chunk_batch(torch, cfg, world: int, rank: int) -> dict:
    """One chunk batch of the fast recipe, made on the card from a seed:
    DP_REAL_ROWS consecutive windows (rows 8.. of a RUNNER_FRAMES-frame
    sequence) of raw int16 frames, both axes padded to a multiple of
    `world` as ChunkTrainLoader pads them, and `rank`'s block of each."""
    import numpy as np

    from hupr_tpu_torch.data.dataset import window_indices

    d, b = cfg.DATASET, cfg.TRAINING.batchSize
    rp = d.radar_params()
    g = d.numGroupFrames
    rows = window_indices(RUNNER_FRAMES, RUNNER_FRAMES, g)[
        8:8 + DP_REAL_ROWS]
    lo, n_frames = int(rows.min()), int(rows.max() - rows.min() + 1)
    rows_pad = b + (-b) % world
    f = b + g - 1
    f_pad = f + (-f) % world
    rel = np.empty((rows_pad, g), np.int64)
    rel[:DP_REAL_ROWS] = rows - lo
    rel[DP_REAL_ROWS:] = rel[DP_REAL_ROWS - 1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    samples = 2 * rp.num_rx * rp.num_chirp * rp.num_adc_samples
    frames = {v: torch.randint(-300, 300, (n_frames, samples), generator=gen,
                               device="cuda", dtype=torch.int16)
              for v in ("hori", "vert")}
    clamp = torch.arange(f_pad, device="cuda").clamp(max=n_frames - 1)
    joints = 20 + 210 * torch.rand((DP_REAL_ROWS, 14, 2), generator=gen,
                                   device="cuda", dtype=torch.float64)
    joints = torch.cat([joints, joints[-1:].expand(
        rows_pad - DP_REAL_ROWS, 14, 2)])
    mask = (torch.arange(rows_pad, device="cuda") < DP_REAL_ROWS).float()
    fb, rb = f_pad // world, rows_pad // world
    fr = slice(rank * fb, (rank + 1) * fb)
    rr = slice(rank * rb, (rank + 1) * rb)
    return {"hori": frames["hori"][clamp][fr],
            "vert": frames["vert"][clamp][fr],
            "rel": torch.from_numpy(rel[rr]).cuda(),
            "jointsGroup": joints[rr], "mask": mask[rr],
            "trueB": DP_REAL_ROWS}


def dp_run(torch, kind: str, mesh, w0: dict, steps: int = DP_STEPS,
           spatial: int = 64) -> dict:
    """`steps` train steps of `kind` (dp_config) from the weights w0 on
    the first DP_REAL_ROWS rows of its batch padded to 20: with `mesh`
    (more than one rank) this rank's block and the data-parallel step,
    with None the one-rank masked step on the card. Returns the losses,
    ms per step after the first (host clock, each step read back), the
    launches counted over the steps, which weights got an exactly-zero
    gradient at the first step, and the final state_dict on the host."""
    from hupr_tpu_torch.engine import chunk_train
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.parallel import Mesh, replicate_state, shard_batch

    cfg = dp_config(kind, spatial)
    d, t = cfg.DATASET, cfg.TRAINING
    geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
    one = mesh is None
    mesh = mesh or Mesh(0, 1, torch.device("cuda"))
    model = build_model(cfg, mesh.device)
    model.load_state_dict(w0)
    tx = make_optimizer(cfg, model)
    state = replicate_state(TrainState(model, tx), mesh)
    if kind == "f32":
        step = make_train_step(model, tx, t.lossDecay, geometry,
                               mesh=None if one else mesh)
        full = bench_batch(torch, cfg)
        batch, _ = shard_batch({k: v[:DP_REAL_ROWS] for k, v in full.items()},
                               mesh, pad_to=t.batchSize)
    else:
        step = chunk_train.make_adc_chunk_train_step(
            model, tx, geometry, mesh=None if one else mesh,
            radar_params=d.radar_params(), num_frames=d.numFrames)
        batch = dp_chunk_batch(torch, cfg, mesh.world, mesh.rank)
    kernels.reset_launch_counts()
    losses, seconds, zero = [], [], None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, t.lr, 0.0)
        losses.append(metrics["loss"].item())
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            zero = torch.cat([(p.grad == 0).flatten()
                              for p in model.parameters()]).cpu()
    return {"losses": losses,
            "ms_per_step": 1e3 * statistics.mean(seconds[1:]),
            "launches": (dict(attention.attention_fwd.launches_by_mode),
                         dict(attention.attention_bwd.launches_by_mode)),
            "zero": zero, "rows": int(batch["mask"].shape[0]),
            "state": {k: v.detach().cpu()
                      for k, v in model.state_dict().items()}}


class _StateDict:
    """A state_dict standing in for a model in hold_readings."""

    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd


def dp_hold(torch, kind: str, ranks: list, one: dict, w0: dict,
            params: list) -> dict:
    """The ranks' run of `kind` against the one-rank run from the same
    weights. float32: hold_readings (losses, weights and BN statistics,
    each leaf's update). bfloat16: the losses and BN statistics at the
    bf16 train bars; the weights that got an exactly-zero gradient at the
    first step in one run and not in the other, and each parameter's
    update on the rest, are read, not held (`params`: the parameters'
    names in the model's order). The ranks encode 14 frames a conv call
    and the one rank 27, and their BN statistics combine in another
    order, so the bfloat16 activations round apart and far more weights
    sit behind a branch the runs took apart than between two
    implementations on one batch (6356 on the H100, against
    BRANCH_FLIPS_MAX's 186), and an update of a one-element PReLU slope
    read 0.13; `flips_by_leaf` says where. The float32 chunk step holds
    the same path at the update bar. Both: the replicas equal bit for
    bit, the same global losses on every rank, finite. Returns the
    readings; raises past a bar."""
    r0 = ranks[0]
    same = all(r["losses"] == r0["losses"] and all(
        torch.equal(v, r["state"][k]) for k, v in r0["state"].items())
        for r in ranks[1:])
    finite = all(map(math.isfinite, r0["losses"] + one["losses"]))
    if kind != "bf16_chunk":
        out, ok = hold_readings(torch, (r0["losses"], one["losses"]),
                                (_StateDict(r0["state"]),
                                 _StateDict(one["state"])), w0)
    else:
        bars = TRAIN_BARS["bf16"]
        loss_rel = max(abs(a - c) / abs(c)
                       for a, c in zip(r0["losses"], one["losses"]))
        flips = r0["zero"] != one["zero"]
        updates, flips_by_leaf, offset = {}, {}, 0
        for key in params:
            n = w0[key].numel()
            keep = ~flips[offset:offset + n].reshape(w0[key].shape)
            offset += n
            if not keep.all():
                flips_by_leaf[key] = int((~keep).sum())
            d = (r0["state"][key] - w0[key]).double()[keep]
            d_x = (one["state"][key] - w0[key]).double()[keep]
            updates[key] = ((d - d_x).norm() / d_x.norm()).item() \
                if d_x.norm() > 0 else 0.0
        stats_excess = max(
            allclose_excess(v, one["state"][k], *bars["stats"])
            for k, v in r0["state"].items()
            if v.is_floating_point() and k not in updates)
        worst = max(updates, key=updates.get)
        out = {"losses": r0["losses"], "losses_other": one["losses"],
               "loss_max_rel_err": loss_rel,
               "bn_stats_allclose_excess": stats_excess,
               "param_branch_flips": int(flips.sum()),
               "flips_by_leaf": dict(sorted(flips_by_leaf.items(),
                                            key=lambda kv: -kv[1])[:8]),
               "update_max_rel_err": updates[worst],
               "update_worst_leaf": worst}
        ok = loss_rel <= bars["loss_rtol"] and stats_excess <= 0
    out.update(replicas_equal=same, finite=finite)
    if not (ok and same and finite):
        raise AssertionError(f"parallel {kind}: {out}")
    return out


def dp_step_phase(torch, kind: str, root: str, steps: int = DP_STEPS,
                  spatial: int = 64) -> dict:
    """`kind`'s step on two ranks sharing the card (gloo) against the
    one-rank step, from seeded N(0, 0.03) weights (dp_run, dp_hold):
    12 forward and 12 backward launches a step on each rank. Returns the
    readings, the ranks' ms per step beside the one-rank step's, and the
    launches."""
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    mode = "bf16" if kind == "bf16_chunk" else "f32"
    model = build_model(dp_config(kind, spatial), "cpu")
    w0 = synthetic_state_dict(model, seed=0, scale=0.03)
    params = [k for k, _ in model.named_parameters()]
    torch.save(w0, os.path.join(root, f"w0-{kind}.pt"))
    ranks = dp_spawn(f"step_{kind}", root, DP_WORLD,
                     opts={"steps": steps, "spatial": spatial})
    one = dp_run(torch, kind, None, w0, steps, spatial)
    readings = dp_hold(torch, kind, ranks, one, w0, params)
    want = ({mode: 12 * steps}, {mode: 12 * steps})
    launches = [r["launches"] for r in ranks]
    if any(tuple(lc) != want for lc in launches) or \
            any(r["rows"] != 20 // DP_WORLD for r in ranks):
        raise AssertionError(f"parallel {kind}: ranks launched {launches} "
                             f"(expected {want} each) on "
                             f"{[r['rows'] for r in ranks]} rows")
    out = {**readings, "world": DP_WORLD, "steps": steps,
            "real_rows": DP_REAL_ROWS,
            "dp_shared_card_ms_per_step": max(r["ms_per_step"]
                                              for r in ranks),
            "rank_ms_per_step": [r["ms_per_step"] for r in ranks],
            "one_rank_ms_per_step": one["ms_per_step"],
            "launches_by_rank": [{"attention_fwd": lc[0][mode],
                                  "attention_bwd": lc[1][mode]}
                                 for lc in launches]}
    print(json.dumps({f"parallel_{kind}": {
        k: v for k, v in out.items() if k not in ("losses",
                                                  "losses_other")}}),
          flush=True)
    return out


def dp_runner_phase(torch, root: str, data: str) -> dict:
    """hupr_tpu_torch.main.run under HUPR_MULTIHOST=1 in two ranks sharing
    the card (gloo, set up by the ranks), from one seeded checkpoint.pth,
    RUNNER_EPOCHS epochs over the DP_SEQS sequences: the same losses and
    APs on both ranks; process 0 alone wrote checkpoints; the val results
    merged (every frame, image ids sorted, both sequences, no rank file);
    the last epoch's AP equal, within PROTOCOL_ATOL, to a one-process
    Runner's eval of the same checkpoint.pth. Returns the readings."""
    from hupr_tpu_torch.engine.runner import Runner

    cwd = os.getcwd()
    os.chdir(root)
    try:
        cfg = dp_runner_config(data)
        seed_checkpoint(cfg, "mh")
        r0, r1 = dp_spawn("runner", root, DP_WORLD)
        args = runner_args("mh", True)
        args.evalPhase = "val"
        one = Runner(args, cfg)
        one.load_model_weight("checkpoint")
        one_ap = one.eval(visualization=False)
        with open(os.path.join("logs", "mh", "val_results.json")) as fp:
            ids = [b["image_id"] for b in json.load(fp)]
        left = [f for f in os.listdir(os.path.join("logs", "mh"))
                if "rank" in f]
    finally:
        os.chdir(cwd)
    t = cfg.TRAINING
    n = RUNNER_FRAMES * len(DP_SEQS)
    steps = RUNNER_EPOCHS * -(-n // t.batchSize)
    evals = RUNNER_EPOCHS * -(-RUNNER_FRAMES // cfg.TEST.batchSize)
    want = {"attention_fwd": 12 * (steps + evals),
            "attention_bwd": 12 * steps}
    out = {"epochs": RUNNER_EPOCHS, "sequences": len(DP_SEQS),
           "frames_per_sequence": RUNNER_FRAMES,
           "losses": r0["losses"], "val_ap_by_epoch": r0["aps"],
           "one_process_eval_ap": one_ap, "saves_by_rank": [r0["saves"],
                                                           r1["saves"]],
           "launches_by_rank": [r0["launches"], r1["launches"]],
           "merged_val_results": len(ids), "epoch_s_by_rank":
               [r0["seconds"], r1["seconds"]]}
    checks = {
        "losses equal": r0["losses"] == r1["losses"]
            and len(r0["losses"]) == steps
            and all(map(math.isfinite, r0["losses"])),
        "APs equal": r0["aps"] == r1["aps"]
            and len(r0["aps"]) == RUNNER_EPOCHS,
        "process 0 alone saves": r1["saves"] == [] and
            "checkpoint.pth" in r0["saves"],
        "merged": ids == sorted(ids) and len(ids) == n and not left
            and {i // 100000 for i in ids} == set(DP_SEQS),
        "AP vs one process": abs(r0["aps"][-1] - one_ap) <= PROTOCOL_ATOL,
        "launches": r0["launches"] == r1["launches"] == want,
    }
    print(json.dumps({"parallel_runner": out}), flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"parallel runner checks failed: {failed}: "
                             f"{out}")
    return out


def dp_runner_config(data: str):
    cfg = runner_config(data)
    d = cfg.DATASET
    d.trainName = d.valName = d.testName = list(DP_SEQS)
    return cfg


def dp_nccl_phase(torch, root: str, data: str) -> dict:
    """main.run with HUPR_MULTIHOST=1 in a world of one on NCCL (its own
    process: RANK 0, WORLD_SIZE 1, a MASTER_PORT), one epoch over the
    DP_SEQS sequences from a seeded checkpoint.pth, against the plain
    Runner's epoch from the same file in the same process: the group was
    nccl, the warm-up ran, and the losses, weights, each leaf's update and
    the val AP hold at the runner bars. Returns the readings."""
    (r,) = dp_spawn("nccl", root, 1, env={
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())},
        opts={"data": data})
    out, ok = hold_readings(
        torch, (r["losses"], r["losses_plain"]),
        (_StateDict(r["state"]), _StateDict(r["state_plain"])), r["w0"])
    out.update(backend=r.get("backend"), world=r.get("world"),
               val_ap=r["ap"], val_ap_plain=r["ap_plain"],
               group_left=r["group_left"],
               max_abs_err=max((v - r["state_plain"][k]).abs().max().item()
                               for k, v in r["state"].items()
                               if v.is_floating_point()))
    print(json.dumps({"parallel_nccl_world1": out}), flush=True)
    if not (ok and r.get("backend") == "nccl" and r.get("world") == 1
            and not r["group_left"]
            and abs(r["ap"] - r["ap_plain"]) <= PROTOCOL_ATOL):
        raise AssertionError(f"parallel nccl: {out}")
    return out


def parallel_phase(torch, card: str) -> dict:
    """The data-parallel and multi-process path on the one card:
    dp_step_phase for the flagship float32 step and the fast recipe's
    raw-ADC chunk step in float32 and bfloat16, dp_runner_phase,
    dp_nccl_phase. Prints the `parallel` line; returns its readings."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="hupr_parallel_")
    try:
        t0 = time.perf_counter()
        result = {"card": card}
        for kind in ("f32", "f32_chunk", "bf16_chunk"):
            result[kind] = dp_step_phase(torch, kind, root)
        data = write_sequence(root, RUNNER_FRAMES, seqs=DP_SEQS)
        result["runner"] = dp_runner_phase(torch, root, data)
        result["nccl_world1"] = dp_nccl_phase(torch, root, data)
        result["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"dp_shared_card_ms_per_step "
          f"{result['f32']['dp_shared_card_ms_per_step']:.2f} (two ranks "
          f"on one card, 10 rows each, not a scaling number) beside the "
          f"one-rank step {result['f32']['one_rank_ms_per_step']:.2f} "
          f"(19 rows)", flush=True)
    print(json.dumps({"parallel": result}), flush=True)
    return result


def shard_main(torch, card: str, sl: dict, sl16: dict) -> dict:
    """shard_phase at full width in a directory of its own; prints
    shard_frames_per_sec per config beside the one-process slice's
    frames/s."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="hupr_shard_")
    try:
        result = shard_phase(torch, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for mode, slice_result in (("f32", sl), ("bf16", sl16)):
        r = result[mode]
        ms = ", ".join(f"{m:.2f}" for m in r["rank_ms_per_request"])
        print(f"shard_frames_per_sec {mode} "
              f"{r['shard_frames_per_sec']:.2f} (two ranks sharing one "
              f"card over gloo, {FRAMES // SHARD_WORLD} frames each, not a "
              f"scaling number; rank ms a request {ms}) beside the "
              f"one-process slice {slice_result['frames_per_s']:.2f}",
              flush=True)
    return result


def dp_worker(argv) -> int:
    """A rank of the parallel phase: `--dp-worker job root rank world
    rendezvous opts`. Saves its result to root/<job>-rank<rank>.pt."""
    import torch
    import torch.distributed as dist

    job, root, rank, world, rdv, opts = argv
    rank, world, opts = int(rank), int(world), json.loads(opts)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hupr_tpu_torch.parallel import make_mesh, multihost

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if job == "nccl":
        result = dp_nccl_worker(torch, root, opts["data"])
    elif job == "shard_nccl":
        result = shard_nccl_worker(torch)
    else:
        multihost.initialize(backend="gloo", init_method=f"file://{rdv}")
        try:
            if job == "runner":
                result = dp_runner_worker(torch, root)
            elif job == "shard":
                result = shard_worker(torch, root, opts)
            else:
                kind = job[len("step_"):]
                w0 = torch.load(os.path.join(root, f"w0-{kind}.pt"))
                result = dp_run(torch, kind, make_mesh(), w0,
                                opts["steps"], opts["spatial"])
        finally:
            dist.destroy_process_group()
    torch.save(result, os.path.join(root, f"{job}-rank{rank}.pt"))
    return 0


def dp_runner_worker(torch, root: str) -> dict:
    """main.run(HUPR_MULTIHOST=1) in this rank's group: the losses each
    epoch logged, the checkpoint files this rank wrote, the val APs, the
    launches, the seconds of the run."""
    from hupr_tpu_torch.engine import runner as runner_mod
    from hupr_tpu_torch.engine.checkpoint import AsyncCheckpointer
    from hupr_tpu_torch.main import run
    from hupr_tpu_torch.ops import attention

    os.environ["HUPR_MULTIHOST"] = "1"
    os.chdir(root)
    losses, saves = [], []
    save_list, save = runner_mod.Runner.save_loss_list, AsyncCheckpointer.save

    def logged(self, epoch, loss_list, mode):
        losses.extend(loss_list)
        return save_list(self, epoch, loss_list, mode)

    def saved(self, paths, *args, **kwargs):
        saves.extend(os.path.basename(p) for p in paths)
        return save(self, paths, *args, **kwargs)

    runner_mod.Runner.save_loss_list = logged
    AsyncCheckpointer.save = saved
    kernels.reset_launch_counts()
    runner, seconds = timed(torch, lambda: run(
        runner_args("mh"), dp_runner_config(os.path.join(root, "data"))))
    return {"losses": losses, "saves": saves, "aps": runner.epoch_aps,
            "seconds": seconds,
            "launches": {"attention_fwd": attention.attention_fwd.launches,
                         "attention_bwd": attention.attention_bwd.launches}}


def dp_nccl_worker(torch, root: str, data: str) -> dict:
    """The plain Runner's epoch, then main.run's with HUPR_MULTIHOST=1
    (a world of one from the environment: nccl on the card), from the same
    seeded checkpoint.pth, in this process."""
    import torch.distributed as dist

    from hupr_tpu_torch.main import run
    from hupr_tpu_torch.parallel import multihost

    os.chdir(root)
    cfg = dp_runner_config(data)
    cfg.TRAINING.epochs = 1
    for name in ("plain", "nccl"):
        seed_checkpoint(cfg, name)
    w0 = torch.load(os.path.join("logs", "plain", "checkpoint.pth"),
                    weights_only=True)["model_state_dict"]
    seen = {}
    warmup = multihost.warmup_device_collectives

    def warm(mesh):
        if multihost.is_initialized():
            seen.update(backend=dist.get_backend(), world=mesh.world)
        return warmup(mesh)

    multihost.warmup_device_collectives = warm
    os.environ.pop("HUPR_MULTIHOST", None)
    plain = run(runner_args("plain"), cfg)
    os.environ["HUPR_MULTIHOST"] = "1"
    nccl = run(runner_args("nccl"), cfg)
    out = {"w0": w0, "ap": nccl.epoch_aps[-1], "ap_plain": plain.epoch_aps[-1],
           "group_left": multihost.is_initialized(), **seen}
    for key, name in (("", "nccl"), ("_plain", "plain")):
        with open(os.path.join("logs", name, "train_loss_list_0.json")) as fp:
            out["losses" + key] = json.load(fp)
        out["state" + key] = torch.load(
            os.path.join("logs", name, "checkpoint.pth"),
            weights_only=True)["model_state_dict"]
    return out


# the shard phase: one request's frames split over two ranks sharing the
# card (gloo: NCCL refuses two ranks on one device), in the flagship
# float32 and the fast bfloat16 serving configs: SHARD_REQUESTS timed
# FRAMES-frame requests after a warm-up one (FRAMES / SHARD_WORLD frames a
# rank), and a SHARD_SMALL request (frames, duration) whose blocks are
# smaller than the window's halo and end at a sequence boundary; sequence
# eval over one RUNNER_FRAMES-frame sequence at TEST.batchSize 32. Each
# is held against the same entry in this one process on the card at the
# stream's bars (a rank encodes and decodes 16 frames a call where one
# process does 32, so the card sums in other orders); a world of one on
# NCCL against the unsharded entry bit for bit. Two ranks time-slice one
# card: its frames/s is not a scaling number
SHARD_WORLD, SHARD_REQUESTS, SHARD_SMALL = 2, 4, (8, 4)
SHARD_BARS = {"f32": (MAXVAL_TOL, STREAM_AGREE["f32"]),
              "bf16": (MAXVAL_TOL_BF16, STREAM_AGREE["bf16"])}
# sequence eval's losses, one process against two ranks: the runner's
# float32 loss bar
SHARD_LOSS_RTOL = TRAIN_BARS["f32"]["loss_rtol"]


def shard_config(mode: str, spatial: int = 64):
    """The flagship float32 ("f32") or the fast bfloat16 ("bf16") serving
    config; spatial 32 takes a reduced capture (128 ADC samples, 48
    chirps: 8 kept chirps, 32x32 maps) at the kernels' width (numFilters
    32)."""
    from hupr_tpu_torch.config import (fast_serving_config,
                                       flagship_serving_config)

    cfg = flagship_serving_config() if mode == "f32" \
        else fast_serving_config()
    if spatial != 64:
        d = cfg.DATASET
        d.adcParams = dict(num_adc_samples=128, num_chirp=48,
                           idx_proc_chirp=16, num_group_chirp=2)
        d.rangeSize = d.azimuthSize = d.heatmapSize = spatial
        d.imgSize, d.numChirps = 4 * spatial, 8
    return cfg


def shard_requests(torch, cfg, frames: int, count: int, seed: int) -> list:
    """`count` requests of `frames` raw int16 frames per view, made on the
    card from `seed` (the same in every process)."""
    rp = cfg.DATASET.radar_params()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (frames, rp.num_rx, rp.num_chirp, rp.num_adc_samples)
    return [tuple(torch.randint(-300, 300, shape, generator=gen,
                                device="cuda", dtype=torch.int16)
                  for _ in range(4)) for _ in range(count)]


def shard_serve(torch, mesh, mode: str, spatial: int) -> dict:
    """make_e2e_infer on `mode`'s config with the slice's seeded N(0, 0.03)
    weights, over `mesh` (None: this process alone): a warm-up request,
    SHARD_REQUESTS timed ones (host clock, the card synchronized after
    each) and one SHARD_SMALL request. Returns the outputs on the host,
    ms a request, and the launches of the timed requests and of the small
    one (attention by mode, conv)."""
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention, conv
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    cfg = shard_config(mode, spatial)
    ds = cfg.DATASET
    model = build_model(cfg, "cpu")
    state = synthetic_state_dict(model, seed=0, scale=0.03)

    def entry(duration):
        return make_e2e_infer(model, state, ds.radar_params(),
                              duration=duration, group=ds.numGroupFrames,
                              num_frames=ds.numFrames, device="cuda",
                              mesh=mesh)

    run = entry(FRAMES)
    requests = shard_requests(torch, cfg, FRAMES, 1 + SHARD_REQUESTS, 7)
    run(*requests[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs, ms = [], []
    for req in requests[1:]:
        t0 = time.perf_counter()
        outs.append(run(*req))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(attention.attention_fwd.launches_by_mode)
    conv_launches = conv.conv3d_3x3x3.launches
    frames, duration = SHARD_SMALL
    small = shard_requests(torch, cfg, frames, 1, 8)[0]
    run_small = entry(duration)
    kernels.reset_launch_counts()
    outs.append(run_small(*small))
    torch.cuda.synchronize()
    return {"outs": [tuple(t.cpu() for t in o) for o in outs], "ms": ms,
            "launches": launches, "conv_launches": conv_launches,
            "small_launches": dict(attention.attention_fwd.launches_by_mode),
            "small_conv_launches": conv.conv3d_3x3x3.launches}


def shard_seq_eval(torch, mesh, data: str) -> dict:
    """SequenceEvaluator over `mesh` (None: this process alone) on the
    flagship recipe with the seeded N(0, 0.03) weights, over the one
    RUNNER_FRAMES-frame test sequence under `data` at TEST.batchSize 32.
    Returns the batches on the host, the launches (attention by mode,
    conv) and the seconds."""
    from hupr_tpu_torch.data.dataset import get_dataset
    from hupr_tpu_torch.engine.seq_eval import SequenceEvaluator
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention, conv
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    cfg = runner_config(data)
    model = build_model(cfg, "cuda")
    model.load_state_dict(synthetic_state_dict(model, seed=0, scale=0.03))
    ev = SequenceEvaluator(model, cfg, mesh=mesh)
    if (ev.mesh is None) != (mesh is None):
        raise AssertionError("SequenceEvaluator's gate refused the mesh")
    ds = get_dataset("test", cfg)
    kernels.reset_launch_counts()
    batches, seconds = timed(torch, lambda: [
        ({k: v.cpu() for k, v in out.items()}, ids, t)
        for out, ids, _, t in ev.eval_batches(ds)])
    return {"batches": batches, "seconds": seconds,
            "launches": dict(attention.attention_fwd.launches_by_mode),
            "conv_launches": conv.conv3d_3x3x3.launches}


def shard_worker(torch, root: str, opts: dict) -> dict:
    """A rank of the shard phase (its gloo group set up by dp_worker)."""
    from hupr_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    out = {mode: shard_serve(torch, mesh, mode, opts["spatial"])
           for mode in opts["modes"]}
    if opts.get("data"):
        out["seq"] = shard_seq_eval(torch, mesh, opts["data"])
    return out


def shard_nccl_worker(torch) -> dict:
    """make_e2e_infer over a world of one on NCCL (this process's group,
    from the environment) against the unsharded entry, on one request in
    each config."""
    import torch.distributed as dist

    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.parallel import make_mesh, multihost
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    multihost.initialize()
    try:
        mesh = make_mesh()
        out = {"backend": dist.get_backend(), "world": mesh.world}
        for mode in ("f32", "bf16"):
            cfg = shard_config(mode)
            ds = cfg.DATASET
            model = build_model(cfg, "cpu")
            state = synthetic_state_dict(model, seed=0, scale=0.03)
            req = shard_requests(torch, cfg, FRAMES, 1, 7)[0]
            got = [make_e2e_infer(model, state, ds.radar_params(),
                                  duration=FRAMES, group=ds.numGroupFrames,
                                  num_frames=ds.numFrames, mesh=m)(*req)
                   for m in (mesh, None)]
            out[mode] = all(torch.equal(a, b) for a, b in zip(*got))
    finally:
        dist.destroy_process_group()
    return out


def shard_hold(torch, label: str, ranks: list, one: list, bars) -> dict:
    """Every rank's outputs against the one process's: the replicas equal
    bit for bit, shapes, finite, peaks spread; maxvals and keypoints at
    `bars`. Returns the readings; raises past a bar."""
    tol, agree_bar = bars
    err, agree = decode_vs(ranks[0], one)
    same = all(torch.equal(a, b) for r in ranks[1:]
               for got, ref in zip(r, ranks[0]) for a, b in zip(got, ref))
    ok_shapes = all(tuple(p.shape) == tuple(q.shape) and tuple(m.shape)
                    == tuple(n.shape) and torch.isfinite(m).all()
                    for (p, m), (q, n) in zip(ranks[0], one))
    spread = all(m.std().item() > 1e-3 and m.max().item() < 1.0
                 for _, m in one)
    out = {"maxvals_max_abs_err": err, "keypoint_agreement": agree,
           "replicas_equal": same}
    if not (err <= tol and agree >= agree_bar and same and ok_shapes
            and spread):
        raise AssertionError(f"shard {label}: {out}, shapes and finite "
                             f"{ok_shapes}, peaks spread {spread}")
    return out


def shard_phase(torch, card: str, root: str, spatial: int = 64,
                modes=("f32", "bf16"), seq_eval: bool = True,
                world_one: bool = True) -> dict:
    """The frame-axis sharding of one request on the card: shard_worker
    in SHARD_WORLD ranks sharing the card, against shard_serve and
    shard_seq_eval in this process on the same requests and weights (12
    launches a request and 24 a 64-frame sequence on each rank); with
    `world_one`, shard_nccl_worker, while this process computes its
    references (so this process times nothing). Prints the `shard` line;
    returns its readings."""
    t0 = time.perf_counter()
    data = write_sequence(root, RUNNER_FRAMES) if seq_eval else None
    opts = {"spatial": spatial, "modes": list(modes), "data": data}
    ranks = dp_spawn("shard", root, SHARD_WORLD, opts=opts)
    with ThreadPoolExecutor(1) as pool:
        world1 = pool.submit(dp_spawn, "shard_nccl", root, 1, env={
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(free_port())}) if world_one else None
        result = shard_holds(torch, card, ranks, modes, spatial, data)
        if world1 is not None:
            (w1,) = world1.result()
    failed = result.pop("failed")
    if world_one:
        result["nccl_world1"] = w1
        if not (w1["backend"] == "nccl" and w1["world"] == 1
                and w1["f32"] and w1["bf16"]):
            failed.append(f"nccl world of one {w1}")
    result["seconds"] = time.perf_counter() - t0
    print(json.dumps({"shard": result}), flush=True)
    if failed:
        raise AssertionError(f"shard checks failed: {failed}")
    return result


def shard_holds(torch, card: str, ranks: list, modes, spatial: int,
                data) -> dict:
    """shard_phase's holds of the ranks' results against this process's
    on the same requests and weights, and their readings; the failed
    checks under "failed"."""
    result = {"card": card, "world": SHARD_WORLD, "spatial": spatial,
              "frames_per_request": FRAMES, "requests": SHARD_REQUESTS,
              "small_request": {"frames": SHARD_SMALL[0],
                                "duration": SHARD_SMALL[1]}}
    failed = []
    for mode in modes:
        one = shard_serve(torch, None, mode, spatial)
        per_rank = [r[mode] for r in ranks]
        want = {mode: 12 * SHARD_REQUESTS}
        launches = [r["launches"] for r in per_rank]
        small = [r["small_launches"] for r in per_rank]
        wall = max(sum(r["ms"]) for r in per_rank)
        result[mode] = {
            **shard_hold(torch, mode, [r["outs"] for r in per_rank],
                         one["outs"], SHARD_BARS[mode]),
            "shard_frames_per_sec": 1e3 * FRAMES * SHARD_REQUESTS / wall,
            "rank_ms_per_request": [statistics.mean(r["ms"])
                                    for r in per_rank],
            "launches_by_rank": [lc.get(mode, 0) for lc in launches],
            "small_launches_by_rank": [lc.get(mode, 0) for lc in small],
            "conv_launches_by_rank": [r["conv_launches"] for r in per_rank],
            "small_conv_launches_by_rank": [r["small_conv_launches"]
                                            for r in per_rank]}
        if any(lc != want for lc in launches) or \
                any(lc != {mode: 12} for lc in small):
            failed.append(f"{mode} launches {launches}, small {small}")
        # each rank serves its share of the frames: one window a frame
        conv_want = (conv_launches_want(12 * SHARD_REQUESTS, mode,
                                        FRAMES // SHARD_WORLD, spatial),
                     conv_launches_want(12, mode,
                                        SHARD_SMALL[0] // SHARD_WORLD,
                                        spatial))
        if any((r["conv_launches"], r["small_conv_launches"]) != conv_want
               for r in per_rank):
            failed.append(f"{mode} conv launches "
                          f"{result[mode]['conv_launches_by_rank']}, small "
                          f"{result[mode]['small_conv_launches_by_rank']}, "
                          f"expected {conv_want}")
    if data:
        one = shard_seq_eval(torch, None, data)
        r0 = ranks[0]["seq"]
        loss_rel = max(abs(got[k].item() - ref[k].item()) / abs(ref[k].item())
                       for (got, _, _), (ref, _, _) in
                       zip(r0["batches"], one["batches"])
                       for k in ("loss1", "loss2"))
        outs = [[(o["pred2d"][:t], o["maxvals"][:t])
                 for o, _, t in r["seq"]["batches"]] for r in ranks]
        ref = [(o["pred2d"][:t], o["maxvals"][:t])
               for o, _, t in one["batches"]]
        same_ids = all([i.tolist() for _, i, _ in r["seq"]["batches"]]
                       == [i.tolist() for _, i, _ in one["batches"]]
                       for r in ranks)
        launches = [r["seq"]["launches"] for r in ranks]
        n_batches = -(-RUNNER_FRAMES // 32)
        result["seq_eval"] = {
            **shard_hold(torch, "seq_eval", outs, ref, SHARD_BARS["f32"]),
            "loss_max_rel_err": loss_rel, "batches": len(ref),
            "ids_equal": same_ids,
            "seconds_by_rank": [r["seq"]["seconds"] for r in ranks],
            "launches_by_rank": [lc.get("f32", 0) for lc in launches],
            "conv_launches_by_rank": [r["seq"]["conv_launches"]
                                      for r in ranks]}
        if not (loss_rel <= SHARD_LOSS_RTOL and same_ids
                and len(ref) == n_batches):
            failed.append(f"seq_eval losses {loss_rel}, ids {same_ids}")
        if any(lc != {"f32": 12 * n_batches} for lc in launches):
            failed.append(f"seq_eval launches {launches}")
        conv_want = conv_launches_want(12 * n_batches, "f32",
                                       32 // SHARD_WORLD)
        if result["seq_eval"]["conv_launches_by_rank"] != \
                [conv_want] * len(ranks):
            failed.append(f"seq_eval conv launches "
                          f"{result['seq_eval']['conv_launches_by_rank']}, "
                          f"expected {conv_want}")
    result["failed"] = failed
    return result


# the graft entry points (hupr_tpu_torch/graft_entry.py): entry()'s timed
# calls, the dryrun's ranks (sharing the card over gloo), and each rank's
# launches at the flagship geometry: 3 train steps, the eval step, the
# resumed step, one served request, the window step, the chunk and ADC
# chunk steps and the ADC window step, 12 forward launches each, and 12
# backward launches in each of the 6 steps
GRAFT_CALLS, GRAFT_WORLD = 3, 2
GRAFT_RANK_LAUNCHES = {"attention_fwd": {"f32": 12 * 10},
                       "attention_bwd": {"f32": 12 * 6}}


def graft_phase(torch, card: str) -> dict:
    """The graft entry points on the card: entry()'s flagship forward
    (default weights, N(0, 0.05)) through the kernel, GRAFT_CALLS timed
    calls of 12 launches each, held to the same model and weights through
    the plain attention (MODEL.attention xla) on the same inputs at
    MAXVAL_TOL on both heatmaps, with the share of their values off the
    sigmoid's rails beside it; then dryrun_multichip(GRAFT_WORLD) on the
    card: every stage, none skipped, GRAFT_RANK_LAUNCHES on each rank, its
    flagship shape pass in this process. Prints the `graft` line; returns
    its readings."""
    import copy

    from hupr_tpu_torch import graft_entry
    from hupr_tpu_torch.config import flagship_serving_config
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention
    from hupr_tpu_torch.utils.device import float32_math
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    t0 = time.perf_counter()
    forward, (hori, vert) = graft_entry.entry()
    cfg_x = copy.deepcopy(flagship_serving_config())
    cfg_x.MODEL.attention = "xla"
    plain_model = build_model(cfg_x, "cpu")
    plain_model.load_state_dict(synthetic_state_dict(plain_model, seed=0,
                                                     scale=0.05))
    plain_model = plain_model.to("cuda").eval()

    def plain(h, v):
        with torch.inference_mode(), float32_math():
            return plain_model(h, v)

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs = [fn(hori, vert) for _ in range(GRAFT_CALLS)]
        torch.cuda.synchronize()
        return outs, 1e3 * (time.perf_counter() - start) / GRAFT_CALLS

    forward(hori, vert)                  # warm-up: cuDNN plans, caches
    plain(hori, vert)
    kernels.reset_launch_counts()
    outs, ms = timed(forward)
    by_mode = dict(attention.attention_fwd.launches_by_mode)
    bwd = attention.attention_bwd.launches
    refs, plain_ms = timed(plain)
    errs = {name: max((o[i] - r[i]).abs().max().item()
                      for o, r in zip(outs, refs))
            for i, name in enumerate(("heatmap", "gcn_heatmap"))}
    live = {name: ((refs[0][i] > 1e-3) & (refs[0][i] < 1 - 1e-3))
            .float().mean().item()
            for i, name in enumerate(("heatmap", "gcn_heatmap"))}
    shapes = [tuple(t.shape) for t in outs[0]]
    finite = all(bool(torch.isfinite(t).all()) for o in outs for t in o)
    entry_s = time.perf_counter() - t0
    del outs, refs, forward, plain_model, hori, vert
    torch.cuda.empty_cache()

    dry = graft_entry.dryrun_multichip(GRAFT_WORLD)
    result = {"card": card, "entry_ms_per_call": ms,
              "entry_plain_ms_per_call": plain_ms,
              "entry_launches": by_mode, "entry_bwd_launches": bwd,
              "entry_max_abs_err_vs_plain": errs,
              "entry_unsaturated_share": live, "entry_shapes": shapes,
              "entry_finite": finite, "entry_seconds": entry_s,
              "dryrun_world": dry["world"], "dryrun_backend": dry["backend"],
              "dryrun_skipped": dry["skipped"],
              "dryrun_seconds": dry["seconds"],
              "dryrun_launches_by_rank": [r["launches"]
                                          for r in dry["ranks"]],
              "dryrun_losses_rank0": dry["ranks"][0]["losses"],
              "seconds": time.perf_counter() - t0}
    print(json.dumps({"graft": result}), flush=True)
    failed = []
    if by_mode != {"f32": 12 * GRAFT_CALLS} or bwd != 0:
        failed.append(f"entry launched {by_mode} forward and {bwd} backward "
                      f"for {GRAFT_CALLS} calls")
    if shapes != [(2, 14, 1, 64, 64), (2, 1, 14, 64, 64)] or not finite:
        failed.append(f"entry outputs {shapes}, finite {finite}")
    if max(errs.values()) > MAXVAL_TOL:
        failed.append(f"entry against the plain attention {errs}")
    if live["heatmap"] < 0.99 or live["gcn_heatmap"] < 0.3:
        failed.append(f"entry's heatmaps on the rails: {live}, the hold "
                      f"would be vacuous")
    if dry["skipped"] or dry["world"] != GRAFT_WORLD:
        failed.append(f"dryrun skipped {dry['skipped']}")
    for r in dry["ranks"]:
        if r["launches"] != GRAFT_RANK_LAUNCHES:
            failed.append(f"dryrun rank {r['rank']} launched "
                          f"{r['launches']}, expected "
                          f"{GRAFT_RANK_LAUNCHES}")
    if failed:
        raise AssertionError(f"graft checks failed: {failed}")
    return result


# the export phase: the artifacts (144 MB each) under the gitignored
# build/, and the fresh process's time to load and serve one request
EXPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "export")
EXPORT_TIMEOUT_S = 300
# the artifact against make_e2e_infer on the same requests: float32 at
# tests/test_export.py's bars (one program, one card), bfloat16 at the
# stream's (STREAM_AGREE)
EXPORT_BARS = {"f32": (1e-6, 0.99), "bf16": (MAXVAL_TOL_BF16, 0.95)}

_EXPORT_FRESH = """
import json, sys
import torch
from hupr_tpu_torch.engine.export import load_artifact
from hupr_tpu_torch.ops import attention, conv, kernels
serve = load_artifact(sys.argv[1])
request = torch.load(sys.argv[2])
serve(*request)
kernels.reset_launch_counts()
pred, maxv = serve(*request)
torch.cuda.synchronize()
torch.save((pred.cpu(), maxv.cpu()), sys.argv[3])
print(json.dumps({"launches": attention.attention_fwd.launches_by_mode,
                  "conv_launches": conv.conv3d_3x3x3.launches,
                  "model_code": sorted(m for m in sys.modules if m.startswith(
                      ("hupr_tpu_torch.models", "hupr_tpu_torch.engine.pipeline",
                       "jax")))}))
"""


def export_phase(torch, requests, card: str, cfg, label: str, mode: str,
                 run, outs_live, fresh: bool = False):
    """Export `cfg`'s serving program with the slice's N(0, 0.03) seed-0
    weights on the CPU into build/, load it onto the card and serve the
    slice's requests, in turns with make_e2e_infer's `run` (whose outputs
    on them are `outs_live`): 12 wrapper launches a request in `mode` and
    conv_launches_want's conv launches, the outputs at EXPORT_BARS. With `fresh`, also a new process that imports
    engine.export alone loads the file and serves one request through the
    kernel, and an artifact exported on the card serves what the
    CPU-exported one serves."""
    from hupr_tpu_torch.engine.export import (artifact_info, export_serving,
                                              load_artifact, load_serving,
                                              save_artifact)
    from hupr_tpu_torch.models.hupr import build_model
    from hupr_tpu_torch.ops import attention, conv
    from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

    ds = cfg.DATASET
    model = build_model(cfg, device="cpu")
    state = synthetic_state_dict(model, seed=0, scale=0.03)
    kw = dict(params=ds.radar_params(), frames=FRAMES,
              group=ds.numGroupFrames, num_frames=ds.numFrames)
    t0 = time.perf_counter()
    blob = export_serving(model, state, **kw)
    export_s = time.perf_counter() - t0
    os.makedirs(EXPORT_DIR, exist_ok=True)
    path = os.path.join(EXPORT_DIR, f"serving_{label}.pt2")
    save_artifact(path, blob)
    info = artifact_info(blob)
    t0 = time.perf_counter()
    serve = load_artifact(path)
    load_s = time.perf_counter() - t0

    def timed_serve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(*req) for req in requests]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    serve(*requests[0])                     # warm-up: cuDNN plans, caches
    _, live1 = timed_serve(run)
    kernels.reset_launch_counts()
    outs, elapsed = timed_serve(serve)
    by_mode = dict(attention.attention_fwd.launches_by_mode)
    bwd = attention.attention_bwd.launches
    conv_launches = conv.conv3d_3x3x3.launches
    _, live2 = timed_serve(run)
    frames = FRAMES * len(requests)
    err, agree = decode_vs(outs, outs_live)
    tol, agree_bar = EXPORT_BARS[mode]
    result = {"card": card, "compute_dtype": cfg.MODEL.computeDtype,
              "artifact_mb": info["bytes"] / 1e6,
              "platforms": info["platforms"], "in_avals": info["in_avals"],
              "out_avals": info["out_avals"],
              "calling_convention_version":
                  info["calling_convention_version"],
              "export_s": export_s, "load_s": load_s,
              "requests": len(requests), "frames_per_s": frames / elapsed,
              "frames_per_s_make_e2e_infer": [frames / live1,
                                              frames / live2],
              "attention_launches": sum(by_mode.values()),
              "attention_launches_by_mode": by_mode,
              "conv_launches": conv_launches,
              "maxvals_max_abs_err_vs_live": err,
              "keypoint_agreement_vs_live": agree}
    fresh_launches = fresh_conv_launches = 0
    if fresh:
        req_path = os.path.join(EXPORT_DIR, "request.pt")
        out_path = os.path.join(EXPORT_DIR, "fresh_out.pt")
        torch.save([t.cpu() for t in requests[0]], req_path)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _EXPORT_FRESH, path, req_path, out_path],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=EXPORT_TIMEOUT_S,
            env={**os.environ, "PYTHONPATH": os.path.dirname(
                os.path.abspath(__file__))})
        if proc.returncode != 0:
            raise AssertionError(f"the fresh process exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        seen = json.loads(proc.stdout.strip().splitlines()[-1])
        fresh_out = torch.load(out_path)
        ferr, fagree = decode_vs([tuple(t.cuda() for t in fresh_out)],
                                 outs[:1])
        fresh_launches = sum(seen["launches"].values())
        fresh_conv_launches = seen["conv_launches"]
        result["fresh_process"] = {
            "seconds": time.perf_counter() - t0, **seen,
            "maxvals_max_abs_err_vs_artifact": ferr,
            "keypoint_agreement_vs_artifact": fagree}
        model_card = build_model(cfg)
        t0 = time.perf_counter()
        blob_card = export_serving(model_card, state, device="cuda", **kw)
        card_s = time.perf_counter() - t0
        got = load_serving(blob_card)(*requests[0])
        cerr, cagree = decode_vs([got], outs[:1])
        result["exported_on_card"] = {
            "export_s": card_s, "artifact_mb": len(blob_card) / 1e6,
            "maxvals_max_abs_err_vs_cpu_export": cerr,
            "keypoint_agreement_vs_cpu_export": cagree}
        del model_card, blob_card
    print(json.dumps({label: result}), flush=True)
    per_request = 12
    if by_mode != {mode: per_request * len(requests)} or bwd != 0:
        raise AssertionError(f"the artifact launched attention_fwd {by_mode}"
                             f" and attention_bwd {bwd} times for "
                             f"{len(requests)} requests")
    conv_want = conv_launches_want(per_request * len(requests), mode)
    if conv_launches != conv_want:
        raise AssertionError(f"the artifact launched conv3d_fprop "
                             f"{conv_launches} times for {len(requests)} "
                             f"requests, expected {conv_want}")
    if not (err <= tol and agree >= agree_bar):
        raise AssertionError(f"the artifact against make_e2e_infer: maxvals"
                             f" within {err} (bar {tol}), keypoints "
                             f"{agree} (bar {agree_bar})")
    if fresh:
        fr, ec = result["fresh_process"], result["exported_on_card"]
        if fr["launches"] != {mode: per_request} or fr["model_code"] or \
                fr["conv_launches"] != conv_launches_want(per_request, mode):
            raise AssertionError(f"the fresh process: {fr}")
        for e, a in ((fr["maxvals_max_abs_err_vs_artifact"],
                      fr["keypoint_agreement_vs_artifact"]),
                     (ec["maxvals_max_abs_err_vs_cpu_export"],
                      ec["keypoint_agreement_vs_cpu_export"])):
            if not (e <= tol and a >= agree_bar):
                raise AssertionError(f"fresh process or card export: {fr}, "
                                     f"{ec}")
    return {"launches": by_mode.get(mode, 0),
            "fresh_launches": fresh_launches, "conv_launches": conv_launches,
            "fresh_conv_launches": fresh_conv_launches}


# profile_train's attention kernels: the forward in mode f32, and the
# backward's two passes in the train step
PROFILE_KERNELS = {"serve": ("attention_fwd_tf32",),
                   "train": ("attention_fwd_tf32", "attention_bwd_dq_tf32",
                             "attention_bwd_dkdm_tf32")}


def profile_train_phase(card: str, busy: dict) -> dict:
    """scripts/profile_train.py in a process of its own per mode (its first
    profiler run): its total attributed compute beside the `profile`
    line's device_busy_ms of the same path (`busy`, read, not held), the
    attention kernels among its lines, and its launch counts (one warm-up
    call and one profiled: 24 forward launches, and in train 24
    backward)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for mode in ("train", "serve"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hupr_tpu_torch.scripts.profile_train"],
            cwd=root, capture_output=True, text=True,
            timeout=EXPORT_TIMEOUT_S,
            env={**os.environ, "PYTHONPATH": root, "MODE": mode})
        if proc.returncode != 0:
            raise AssertionError(f"profile_train MODE={mode} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        total = float(re.search(r"total attributed compute: ([\d.]+) ms",
                                proc.stdout).group(1))
        names = [ln.split("%  ", 1)[1] for ln in lines
                 if re.match(r" *[\d.]+ ms +[\d.]+%  ", ln)]
        launches = json.loads(lines[-1].split("attention launches: ", 1)[1])
        out[mode] = {"seconds": time.perf_counter() - t0,
                     "total_attributed_ms": total,
                     "profile_device_busy_ms": busy[mode],
                     "lines": len(names), "top": names[:6],
                     "launches": launches}
        missing = [k for k in PROFILE_KERNELS[mode]
                   if not any(n.endswith("::" + k) or n == k for n in names)]
        want = {"attention_fwd": {"f32": 24},
                "attention_bwd": {"f32": 24} if mode == "train" else {}}
        if missing or launches != want:
            print(json.dumps({"profile_train": out}), flush=True)
            raise AssertionError(f"profile_train MODE={mode}: kernels "
                                 f"{missing} not among its lines, or "
                                 f"launches {launches} != {want}")
    print(json.dumps({"profile_train": {"card": card, **out}}), flush=True)
    return out


def conv_micro_phase(torch, card: str) -> list:
    """scripts/conv_microbench.py at its defaults, float32 and bfloat16;
    its own agreement assert holds each reformulation to native."""
    from hupr_tpu_torch.scripts import conv_microbench

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = conv_microbench.main([])
    print(json.dumps({"conv_micro": {
        "card": card, "shape": "(B, T, H, W, C) = (32, 8, 64, 64, 64)",
        "seconds": time.perf_counter() - t0, "rows": rows}}), flush=True)
    torch.cuda.empty_cache()
    return rows


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
    from hupr_tpu_torch.config import (fast_serving_config,
                                       fast_training_config,
                                       flagship_serving_config)
    from hupr_tpu_torch.ops import conv
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
    conv_rows = check_conv(torch, peaks)
    grad_rows = check_conv_grads(torch, peaks)
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
    # the first profiler run: later ones drop some of the card's events
    stream_launches(torch, st, stream_frames)
    del stream_frames
    busy = {"serve": profile(torch, "serve",
                             lambda: run(*requests[0]))["device_busy_ms"]}
    ex = export_phase(torch, requests, smi, flagship_serving_config(),
                      "export", "f32", run, outs_f32, fresh=True)
    del run
    sl16, run, outs16 = serve_slice(torch, requests, smi,
                                    fast_serving_config(), "slice_bf16",
                                    "bf16", MAXVAL_TOL_BF16, vs_f32=outs_f32)
    profile(torch, "serve_bf16", lambda: run(*requests[0]))
    ex16 = export_phase(torch, requests, smi, fast_serving_config(),
                        "export_bf16", "bf16", run, outs16)
    del run, outs16
    tr, one_step = train_slice(torch, smi)
    # every kernel of the step, so that the two paths can be compared
    busy["train"] = profile(torch, "train", one_step["pallas"],
                            top=200)["device_busy_ms"]
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
    tm, one_step = train_max_phase(torch, smi, peaks)
    # the recompute beside the step without it
    profile(torch, "train_max", one_step["remat"], top=30)
    profile(torch, "train_max_no_remat", one_step["no_remat"], top=30)
    del one_step
    torch.cuda.empty_cache()
    ln = learn_phase(torch, smi)
    lf = learn_fast_phase(torch, smi)
    fe = front_end_phase(torch, smi)
    torch.cuda.empty_cache()
    par = parallel_phase(torch, smi)
    sh = shard_main(torch, smi, sl, sl16)
    gr = graft_phase(torch, smi)
    pt = profile_train_phase(smi, busy)
    conv_micro_phase(torch, smi)
    backward_passes(torch)

    shapes = "4 at each (N, C) of (256, 256), (1024, 128), (4096, 64)"
    per_request = f"one request: 12 launches, {shapes}, B={ATTN_BATCH}"
    per_step = f"one train step: 12 launches, {shapes}, B={TRAIN_BATCH}"
    fwd_src, bwd_src = "hupr_tpu/ops/attention.py:90", \
        "hupr_tpu/ops/attention.py:188"
    per_frame = f"one streamed frame: 12 launches, {shapes}, B=1"

    def by_rank(name, runs, key):
        """The parallel phase's launches of `key`, one entry per rank."""
        return {f"{name}_rank{r}": lc[key] for r, lc in enumerate(runs)}

    def shard_launches(result, name):
        """The shard phase's launches, one entry per rank, the small
        request's apart."""
        out = {f"{name}_rank{r}": n
               for r, n in enumerate(result["launches_by_rank"])}
        out.update({f"{name}_small_rank{r}": n for r, n in
                    enumerate(result.get("small_launches_by_rank", []))})
        return out

    def graft_launches(result, name):
        """The dryrun's float32 launches of kernel `name`, by rank."""
        return {f"dryrun_rank{r}": lc[name].get("f32", 0) for r, lc in
                enumerate(result["dryrun_launches_by_rank"])}

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
                      "learn":
                          ln["pallas"]["launches"]["attention_fwd"]["f32"],
                      "export": ex["launches"],
                      "export_fresh_process": ex["fresh_launches"],
                      "profile_train":
                          pt["train"]["launches"]["attention_fwd"]["f32"],
                      "profile_train_serve":
                          pt["serve"]["launches"]["attention_fwd"]["f32"],
                      "stream":
                          st["f32"]["sequence_wrapper_launches"]["f32"],
                      "audit":
                          fe["audit"]["attention_fwd_launches"]["f32"],
                      "live": fe["live"]["attention_fwd_launches"]["f32"],
                      **by_rank("parallel_step",
                                par["f32"]["launches_by_rank"],
                                "attention_fwd"),
                      **by_rank("parallel_chunk",
                                par["f32_chunk"]["launches_by_rank"],
                                "attention_fwd"),
                      **by_rank("parallel_runner",
                                par["runner"]["launches_by_rank"],
                                "attention_fwd"),
                      **shard_launches(sh["f32"], "shard"),
                      **shard_launches(sh["seq_eval"], "shard_seq_eval"),
                      "graft_entry": gr["entry_launches"]["f32"],
                      **graft_launches(gr, "attention_fwd")},
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
                      "runner": rr["launches"]["attention_bwd"],
                      "learn":
                          ln["pallas"]["launches"]["attention_bwd"]["f32"],
                      "profile_train":
                          pt["train"]["launches"]["attention_bwd"]["f32"],
                      **by_rank("parallel_step",
                                par["f32"]["launches_by_rank"],
                                "attention_bwd"),
                      **by_rank("parallel_chunk",
                                par["f32_chunk"]["launches_by_rank"],
                                "attention_bwd"),
                      **by_rank("parallel_runner",
                                par["runner"]["launches_by_rank"],
                                "attention_bwd"),
                      "graft_entry": gr["entry_bwd_launches"],
                      **graft_launches(gr, "attention_bwd")},
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
                            "export_bf16": ex16["launches"],
                            "train_bf16": tr16["attention_fwd_launches"],
                            "stream_bf16": st["bf16"][
                                "sequence_wrapper_launches"]["bf16"],
                            "runner_fast": fast["attention_fwd"]["bf16"],
                            "train_max": tm["attention_fwd_launches"],
                            "learn_fast": lf["pallas"]["launches"][
                                "attention_fwd"]["bf16"],
                            **by_rank("parallel_chunk",
                                      par["bf16_chunk"]["launches_by_rank"],
                                      "attention_fwd"),
                            **shard_launches(sh["bf16"], "shard_bf16")}
            bwd_launches = {"train_bf16": tr16["attention_bwd_launches"],
                            "runner_fast": fast["attention_bwd"]["bf16"],
                            "train_max": tm["attention_bwd_launches"],
                            "learn_fast": lf["pallas"]["launches"][
                                "attention_bwd"]["bf16"],
                            **by_rank("parallel_chunk",
                                      par["bf16_chunk"]["launches_by_rank"],
                                      "attention_bwd")}
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
    def per_step_rows(kernel, b):
        """The gradient rows of `kernel` at batch b, each taken as often as
        a train step runs its shape."""
        return [{**r, **{key: r["per_step"] * r[key] for key in
                         ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}}
                for r in grad_rows if r["kernel"] == kernel and r["B"] == b]

    def grad_sums(kernel, b):
        rows = per_step_rows(kernel, b)
        return {key: sum(r[key] for r in rows) for key in
                ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}

    # a forward's convs: each shape's row taken as often as a forward runs it
    per_conv = (f"one request: {CONV_PER_FORWARD} launches, the Encoder3Ds' "
                f"3x3x3 convs at B={ATTN_BATCH}")
    conv_b32, conv_b1 = ([{**r, **{key: r["per_forward"] * r[key] for key in
                                   ("kernel_ms", "plain_ms", "library_ms",
                                    "bound_ms")}}
                          for r in conv_rows if r["B"] == b]
                         for b in (ATTN_BATCH, 1))
    b1_taken = [r for r in conv_b1 if conv.grid_blocks(
        (1, r["Cin"], *r["DHW"]), r["Cout"]) >= conv.MIN_BLOCKS]
    entries.append(kernel_entry(
        "conv3d_fprop", "f32", "conv3d_fprop", None,
        {"serve": sl["conv_launches"], "serve_bf16": sl16["conv_launches"],
         "train": tr["conv_launches"], "train_bf16": tr16["conv_launches"],
         "export": ex["conv_launches"],
         "export_fresh_process": ex["fresh_conv_launches"],
         "export_bf16": ex16["conv_launches"],
         "stream": st["f32"]["sequence_conv_launches"],
         "stream_bf16": st["bf16"]["sequence_conv_launches"],
         **{f"shard_rank{r}": n for r, n in
            enumerate(sh["f32"]["conv_launches_by_rank"])},
         **{f"shard_small_rank{r}": n for r, n in
            enumerate(sh["f32"]["small_conv_launches_by_rank"])},
         **{f"shard_seq_eval_rank{r}": n for r, n in
            enumerate(sh["seq_eval"]["conv_launches_by_rank"])}},
        conv_b32, 1, per_conv,
        stream_B1={key: sum(r[key] for r in b1_taken)
                   for key in ("kernel_ms", "plain_ms", "library_ms",
                               "bound_ms")}
        | {"per": f"one streamed frame: {conv_per_forward(1)} launches, "
                  f"B=1 (the other convs stay on cuDNN)"},
        body="conv3d_fprop_wgmma<W> (3xTF32 on wgmma, csrc/tf32.cuh; "
             "pack_weights before it)",
        rel_err=max(r["rel_err"] for r in conv_rows),
        rel_err_vs_f64=max(r["rel_err_vs_f64"] for r in conv_rows),
        library="F.conv3d (cuDNN, TF32 off), also the plain version",
        **{f"dgrad_B{b}": grad_sums("conv3d_dgrad", b) for b in
           (5, TRAIN_BATCH)}))
    entries.append(kernel_entry(
        "conv3d_wgrad", "f32", "conv3d_wgrad", None,
        {"train": tr["wgrad_launches"], "train_bf16": tr16["wgrad_launches"]},
        per_step_rows("conv3d_wgrad", TRAIN_BATCH), 1,
        f"one train step: {conv_train_launches()[1]} launches, the "
        f"Encoder3Ds' 3x3x3 convs' weight gradients at B={TRAIN_BATCH}",
        B5=grad_sums("conv3d_wgrad", 5),
        body="conv3d_wgrad_wgmma<W> (3xTF32 on wgmma, csrc/tf32.cuh), "
             "the splits added by torch's sum",
        rel_err_vs_f64=max(r["rel_err_vs_f64"] for r in grad_rows
                           if r["kernel"] == "conv3d_wgrad"),
        library="aten convolution_backward (cuDNN, TF32 off), also the plain "
                "version"))
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
    sys.exit(dp_worker(sys.argv[2:]) if sys.argv[1:2] == ["--dp-worker"]
             else main())
