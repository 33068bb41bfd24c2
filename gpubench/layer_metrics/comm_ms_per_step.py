"""Device ms of the collectives per step of the traced span on rank 0:
the NCCL kernels (the gradient sum, the synced BN's reductions, the
window's one-element broadcast)."""


def read(metric, ctx):
    t = ctx.trace
    ms = sum(end - start for name, start, end in t.kernels
             if "nccl" in name.lower()) / 1e3
    return ms / t.units if ms and t.units else None
