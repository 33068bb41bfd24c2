"""Is cuDNN's 3-D convolution at the dominant Encoder3D stage-1 shape
beatable by a reformulation? (counterpart of `scripts/conv_microbench.py`)
Times, at (B=32, T=8, 64, 64, Cin=64) -> Cout=64 with a 3x3x3 SAME kernel
(the encoders' widest convolution, which serving and training run most):

  native    torch conv3d (cuDNN) on NCDHW input, as the model runs it
  shift     27 shifted-slice matmuls accumulated (K=Cin per tap), NDHWC
  im2col    explicit patch extraction + one (27*Cin) GEMM, NDHWC (about
            7.2 GB of float32 patches at the defaults)
  kernel    the port's own, ops/conv.conv3d_3x3x3 on NCDHW input: on the
            card csrc/conv3d_fprop.cu, an implicit GEMM in 3xTF32 (float32
            only); on the CPU its plain version

each in float32 with TF32 off (utils.device.float32_math, as the model's
float32 path runs) and, all but the kernel, again in bfloat16
(MODEL.computeDtype bfloat16, the fast recipes). cuDNN's float32
convolutions took most of a float32 request and take most of a float32
train step, so these numbers say whether a reformulation could move them.

Usage: python -m hupr_tpu_torch.scripts.conv_microbench [B T H C inner reps]
       [--device cpu]

Defaults 32 8 64 64 8 3. ms per conv: `inner` chained calls timed with
CUDA events (the host clock on the CPU), the best of `reps`, after one
warm-up chain. Each reformulation must agree with native on the same
input: within 1e-2 in float32 (the JAX script's assert), and in bfloat16
within 2e-2 + 2^-6 of native's magnitude, one bfloat16 rounding of the
output apart plus the shift form's 27 rounded partial sums. Runs on the
card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from hupr_tpu_torch.ops.conv import conv3d_3x3x3
from hupr_tpu_torch.utils.device import float32_math, resolve_device

BF16_BAR = (2e-2, 2.0 ** -6)        # atol, rtol against native in bfloat16


def inputs(b: int, t: int, h: int, c: int, seed: int = 0) -> tuple:
    """The JAX script's draws: x (B, T, H, H, C) N(0, 1) and w (3, 3, 3, C,
    C) N(0, 0.05^2), float32 NDHWC / DHWIO numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, h, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, c, c)) * 0.05).astype(np.float32)
    return x, w


def native(x, w):
    """x (B, C, T, H, W), w (Cout, Cin, 3, 3, 3) -> (B, Cout, T, H, W)."""
    return F.conv3d(x, w, padding=1)


def _pad(x):
    return F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))       # T, H, W of NDHWC


def shift(x, w):
    """x (B, T, H, W, C), w (3, 3, 3, Cin, Cout) -> (B, T, H, W, Cout):
    one (B*T*H*W, Cin) x (Cin, Cout) product per tap, summed in float32."""
    b, t, h, wd, _ = x.shape
    xp = _pad(x)
    acc = torch.zeros((b, t, h, wd, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dt in range(3):
        for dy in range(3):
            for dx in range(3):
                sl = xp[:, dt:dt + t, dy:dy + h, dx:dx + wd, :]
                acc += torch.matmul(sl, w[dt, dy, dx])
    return acc.to(x.dtype)


def im2col(x, w):
    """x (B, T, H, W, C), w (3, 3, 3, Cin, Cout) -> (B, T, H, W, Cout):
    the 27 shifted slices side by side, (B*T*H*W, 27*Cin), times the
    (27*Cin, Cout) kernel."""
    b, t, h, wd, c = x.shape
    xp = _pad(x)
    cols = torch.cat([xp[:, dt:dt + t, dy:dy + h, dx:dx + wd, :]
                      for dt in range(3) for dy in range(3)
                      for dx in range(3)], dim=-1)
    return torch.matmul(cols, w.reshape(27 * c, -1))


# name -> (function, input layout); F32_FORMS adds the float32-only kernel
FORMS = {"native": (native, "ncdhw"), "shift": (shift, "ndhwc"),
         "im2col": (im2col, "ndhwc")}
F32_FORMS = {**FORMS, "kernel": (conv3d_3x3x3, "ncdhw")}


def operands(x, w, layout: str, device, dtype) -> tuple:
    """The numpy draws as one form's tensors on `device` in `dtype`."""
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    if layout == "ncdhw":
        x, w = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
    return (x.contiguous().to(device=device, dtype=dtype),
            w.contiguous().to(device=device, dtype=dtype))


def to_ndhwc(out, layout: str):
    return out.permute(0, 2, 3, 4, 1) if layout == "ncdhw" else out


def ms_per_conv(op, x, w, inner: int, reps: int, device) -> float:
    """Best of `reps` chains of `inner` calls, ms per call, after one
    warm-up chain."""
    def chain():
        y = x
        for _ in range(inner):
            y = op(y, w)
        return y

    cuda = device.type == "cuda"
    chain()
    best = float("inf")
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            chain()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            chain()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms)
    return best / inner


def check_agreement(name: str, got, ref, dtype) -> float:
    """Max |got - ref|; raises past the dtype's bar."""
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        bad = err.max().item() >= 1e-2
    else:
        atol, rtol = BF16_BAR
        bad = (err - atol - rtol * ref.float().abs()).max().item() > 0
    if bad:
        raise AssertionError(f"{name} diverges in {dtype}: {err.max()}")
    return err.max().item()


def run(b, t, h, c, inner, reps, device, dtype) -> list:
    """One row per form: ms per conv and max abs error against native."""
    x_np, w_np = inputs(b, t, h, c)
    rows, ref = [], None
    forms = F32_FORMS if dtype == torch.float32 else FORMS
    for name, (op, layout) in forms.items():
        x, w = operands(x_np, w_np, layout, device, dtype)
        out = to_ndhwc(op(x, w), layout)
        if ref is None:
            ref, err = out, 0.0
        else:
            err = check_agreement(name, out, ref, dtype)
        del out
        ms = ms_per_conv(op, x, w, inner, reps, device)
        dname = str(dtype).removeprefix("torch.")
        print(f"{name:8s} {dname:8s} {ms:8.3f} ms", flush=True)
        rows.append({"form": name, "dtype": dname, "ms": ms,
                     "max_abs_err_vs_native": err})
        del x, w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


DEFAULTS = (32, 8, 64, 64, 8, 3)      # B T H C inner reps


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int,
                    help="B T H C inner reps (32 8 64 64 8 3)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    return ap


def dims(shape: list) -> tuple:
    """(B, T, H, C, inner, reps): the numbers given, the defaults after
    them."""
    if len(shape) > len(DEFAULTS):
        raise SystemExit("at most six numbers: B T H C inner reps")
    return tuple(shape) + DEFAULTS[len(shape):]


def main(argv=None) -> list:
    args = build_arg_parser().parse_args(argv)
    b, t, h, c, inner, reps = dims(args.shape)
    device = resolve_device(args.device)
    print(f"conv3d 3x3x3 SAME at (B, T, H, W, C) = {(b, t, h, h, c)}, "
          f"{inner} chained calls, best of {reps}, on {device}", flush=True)
    rows = []
    with torch.inference_mode(), float32_math():
        for dtype in (torch.float32, torch.bfloat16):
            rows += run(b, t, h, c, inner, reps, device, dtype)
    return rows


if __name__ == "__main__":
    main()
