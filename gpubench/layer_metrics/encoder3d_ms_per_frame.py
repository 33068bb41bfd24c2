"""Device ms of the two Encoder3Ds per frame of the traced span: the card's
time between the CUDA events that the program's span `hupr.encoder3d`
records around each encoder call, summed, over the frames. Read from the
program's span table (hupr_tpu_torch.utils.profiling.table); nothing
where the program has none."""

from hupr_tpu_torch.utils import profiling


def read(metric, ctx):
    if not hasattr(profiling, "table") or not ctx.trace.frames:
        return None
    span = profiling.table()["spans"].get("hupr.encoder3d")
    if not span or "device_s" not in span:
        return None
    return 1e3 * span["device_s"] / ctx.trace.frames
