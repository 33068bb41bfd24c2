"""The MSCSA attention kernels' share of their roofline in the traced
span, in %: the sum of each kernel's bound (gpubench.roofline.
attention_bound at its shape) over the sum of their device time.

A kernel is matched by its name: the forward `attention_fwd_{tf32,tc}<C`
and the backward's two passes `attention_bwd_{dq,dkdm}_{tf32,tc}<C`; its
channels C give the positions N from the geometry, the rows come from the
cell. A backward call is bounded once for its two passes.
"""

import re

from gpubench import roofline

PATTERN = re.compile(r"attention_(fwd|bwd_dq|bwd_dkdm)_(?:tf32|tc)<(\d+)")


def read(metric, ctx):
    att = ctx.attention
    mode = "bf16" if ctx.compute == "bfloat16" else "f32"
    shapes = roofline.attention_shapes(ctx.geometry["numFilters"],
                                       ctx.geometry["heatmap"])
    bound_ms = device_ms = 0.0
    for name, start, end in ctx.trace.kernels:
        found = PATTERN.search(name)
        if not found or int(found.group(2)) not in shapes:
            continue
        c = int(found.group(2))
        kind = "fwd" if found.group(1) == "fwd" else "bwd"
        rows = att["rows"] if kind == "fwd" else att["bwd_rows"]
        ms, _ = roofline.attention_bound(kind, rows, shapes[c], c, mode,
                                         ctx.peaks, lse=att["lse"])
        bound_ms += ms if kind == "fwd" else ms / 2
        device_ms += (end - start) / 1e3
    return 100.0 * bound_ms / device_ms if device_ms else None
