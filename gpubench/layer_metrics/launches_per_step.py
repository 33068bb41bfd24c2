"""Host launch calls per step of the traced span: the runtime's kernel,
graph and copy launches (the host events whose name holds `Launch`)."""


def read(metric, ctx):
    t = ctx.trace
    return t.host_launches / t.units if t.units else None
