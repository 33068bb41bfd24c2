"""Collectives the program issues per train step of the traced span on rank
0: the program's counter `hupr.collectives` (one for each all_reduce,
all_gather or broadcast it calls) over the steps. Read from the program's
span table (hupr_tpu_torch.utils.profiling.table); nothing where the
program has none."""

from hupr_tpu_torch.utils import profiling


def read(metric, ctx):
    if not hasattr(profiling, "table") or not ctx.trace.units:
        return None
    issued = profiling.table()["counters"].get("hupr.collectives")
    return issued / ctx.trace.units if issued else None
