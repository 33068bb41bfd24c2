"""Microbenchmark of the MSCSA spatial attention's variants on one CUDA card
(counterpart of `scripts/attn_microbench.py`).

    python -m hupr_tpu_torch.scripts.attn_microbench [B N C inner reps]

At (B, N, C), by default the flagship serving shape (32, 4096, 64) (the
finest decoder scale), it times each variant as a chain of `inner`
dependent calls whose output feeds the next call's m, as the JAX script
chains them, with CUDA events around the chain; per-op time is the best of
`reps` chains over `inner`. Variants:

  plain                  attention_plain, float32 einsums (TF32 off)
  folded                 attention_fwd, the model's forward kernel, float32
  folded_bf16ops         the same with bfloat16 operands (pallas_bf16)
  unfolded               attention_fwd_unfolded (softmax normalized first)
  unfolded_bf16ops       the same with bfloat16 operands
  bwd_<mode>             attention_bwd in each mode, dm fed back as g
  library_sdpa           F.scaled_dot_product_attention(q, k, m, scale=1)
                         on (B, 1, N, C) views, the library yardstick
                         (float32)

Prints one line per variant. Runs on the card only.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from hupr_tpu_torch.ops.attention import (attention_bwd, attention_fwd,
                                          attention_fwd_unfolded,
                                          attention_plain, kernel_mode)
from hupr_tpu_torch.utils.device import float32_math, resolve_device

BWD_MODES = ((torch.float32, False), (torch.bfloat16, False),
             (torch.float32, True), (torch.bfloat16, True))


def _chain_ms(step, x0, inner: int, reps: int) -> float:
    """Best per-op device time of `inner` chained calls x <- step(x)."""
    step(x0)                                  # warm-up (and kernel build)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        x = x0
        start.record()
        for _ in range(inner):
            x = step(x)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


@torch.inference_mode()
def run(b: int = 32, n: int = 4096, c: int = 64, inner: int = 10,
        reps: int = 3, seed: int = 0) -> dict:
    """{variant: ms per op} at (b, n, c) on the card."""
    dev = resolve_device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, q, m = (torch.randn((b, n, c), generator=gen, device=dev)
               for _ in range(3))
    ops = {
        "plain": lambda x: attention_plain(k, q, x),
        "folded": lambda x: attention_fwd(k, q, x),
        "folded_bf16ops": lambda x: attention_fwd(k, q, x, bf16_ops=True),
        "unfolded": lambda x: attention_fwd_unfolded(k, q, x),
        "unfolded_bf16ops": lambda x: attention_fwd_unfolded(
            k, q, x, bf16_ops=True),
        "library_sdpa": lambda x: F.scaled_dot_product_attention(
            q[:, None], k[:, None], x[:, None], scale=1.0)[:, 0],
    }
    out = {}
    with float32_math():
        for name, op in ops.items():
            out[name] = _chain_ms(op, m, inner, reps)
            print(f"{name:24s}{out[name]:10.3f} ms", flush=True)
        for dtype, bf16_ops in BWD_MODES:
            kk, qq, mm = (t.to(dtype) for t in (k, q, m))
            o, lse = attention_fwd(kk, qq, mm, with_lse=True,
                                   bf16_ops=bf16_ops)
            name = "bwd_" + kernel_mode(dtype, bf16_ops)

            def bwd(g, kk=kk, qq=qq, mm=mm, o=o, lse=lse, bf16_ops=bf16_ops):
                return attention_bwd(kk, qq, mm, o, lse, g,
                                     bf16_ops=bf16_ops)[2]

            out[name] = _chain_ms(bwd, mm, inner, reps)
            print(f"{name:24s}{out[name]:10.3f} ms", flush=True)
    return out


def main(argv=None) -> int:
    args = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    names = ("b", "n", "c", "inner", "reps")
    run(**dict(zip(names, args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
