"""Host ms per train step of the traced span: the host seconds inside the
program's span `hupr.train.step` (the call's Python, launches and waits;
on rank 0 in the data-parallel cell), over the steps. Near the traced
step's wall time, the host sets the pace. Read from the program's span
table (hupr_tpu_torch.utils.profiling.table); nothing where the program
has none."""

from hupr_tpu_torch.utils import profiling


def read(metric, ctx):
    if not hasattr(profiling, "table") or not ctx.trace.units:
        return None
    span = profiling.table()["spans"].get("hupr.train.step")
    return 1e3 * span["host_s"] / ctx.trace.units if span else None
