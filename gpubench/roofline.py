"""The yardstick's arithmetic: the card's peaks, the attention kernels'
bound from their shapes, and the model's FLOPs counted on the benchmark's
own reference.

Peaks are those of each H100 variant at its full power limit, dense:
float32 FMA-pipe, bfloat16 and TF32 tensor-core flop/s and the memory rate
(NVIDIA's data sheet); the SFU's exp rate, 16 a clock per SM (NVIDIA's
arithmetic throughput table for compute capability 9.0) x SMs x boost
clock.
"""

from __future__ import annotations

import torch

from gpubench.reference import model
from gpubench.reference.precision import Precision

PEAKS = {"PCIe": {"f32": 51.2e12, "bf16": 756e12, "tf32": 378e12,
                  "bytes": 2.0e12, "sfu": 16 * 114 * 1.755e9},
         "NVL": {"f32": 60.0e12, "bf16": 835e12, "tf32": 417.5e12,
                 "bytes": 3.9e12, "sfu": 16 * 132 * 1.785e9},
         "SXM": {"f32": 66.9e12, "bf16": 989e12, "tf32": 495e12,
                 "bytes": 3.35e12, "sfu": 16 * 132 * 1.98e9}}


def card_peaks(name: str):
    """(variant, peaks) of the card named `name` (SXM unless it says
    PCIe or NVL)."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


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
    """(bound ms, bound_by) of one attention call in `mode` ("f32", "bf16",
    "f32_bf16ops" or "bf16_bf16ops"): the larger of the bytes term (each
    input read once, each output written once, at the memory rate) and
    the operations term, the slowest of the pipes the work needs, which
    run side by side: the tensor cores, the float32 FMA pipes and the SFU
    for the B*N^2 exps. Each product of 2*B*N^2*C flops goes to its
    cheapest route (product_route). `kind` is "fwd" (logits, p.m) or
    "bwd" (logits, dP, then dq, dk, dm). The logits and dP take the mode's
    input operands (bfloat16 but in mode f32); p and dS are float32 but
    under bf16_ops."""
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


def attention_shapes(num_filters: int, heatmap: int) -> dict:
    """{channels C: positions N} of the decoder's attentions: (H/4)^2 at
    8F, (H/2)^2 at 4F, H^2 at 2F."""
    return {num_filters * m: (heatmap // d) ** 2
            for d, m in ((4, 8), (2, 4), (1, 2))}


def mfu_peak(compute: str, peaks) -> float:
    """flop/s of the arithmetic a recipe keeps: bfloat16 on the tensor
    cores; float32 as three TF32 products (3xTF32), the cheapest route
    that keeps float32's accuracy."""
    return peaks["bf16"] if compute == "bfloat16" else peaks["tf32"] / 3


def model_flops(geometry: dict, frames: int, windows: int,
                train: bool = False) -> int:
    """FLOPs of the reference, counted by torch's FlopCounterMode on meta
    tensors: the chirp encode of `frames` frames and the pose of `windows`
    windows; with `train`, the forward of `windows` training windows
    (each window's frames encoded in it, as a train step does) and its
    backward."""
    from torch.utils.flop_counter import FlopCounterMode

    f, g, c = geometry["numFilters"], geometry["group"], geometry["chirps"]
    r, a, e = geometry["range"], geometry["azimuth"], geometry["elevation"]
    meta = torch.device("meta")
    P = {k: torch.empty(s, device=meta,
                        dtype=torch.int64 if k.endswith("num_batches_tracked")
                        else torch.float32)
         for k, s in model.state_shapes(f, g, geometry["keypoints"],
                                        geometry["heatmap"]).items()}
    prec = Precision("float32")
    with FlopCounterMode(display=False) as counter:
        if train:
            for k in P:
                if model.is_parameter(k):
                    P[k].requires_grad_(True)
            x = torch.empty((windows, g, c, 2, r, a, e), device=meta)
            heat, refined = model.forward(P, x, x, prec, train=True,
                                          num_frames=c)
            (heat.sum() + refined.sum()).backward()
        else:
            x = torch.empty((frames, 1, c, 2, r, a, e), device=meta)
            model.chirp_maps(P, x, x, prec, c)
            maps = torch.empty((windows, g, r, a, f), device=meta)
            model.pose_from_maps(P, maps, maps, prec)
    return counter.get_total_flops()
