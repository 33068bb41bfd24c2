"""The card's idle share of the traced span, in %: 1 - (the union of its
events' spans) / (the span's wall time)."""


def read(metric, ctx):
    t = ctx.trace
    if not t.kernels or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
