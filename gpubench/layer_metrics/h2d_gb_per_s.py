"""GB/s of the program's copies from host memory to the card in the traced
span: the counter `hupr.h2d_bytes` over the host seconds of the copy's
span, `hupr.serve.h2d` (a request's four planes) for `.serve` and
`hupr.stream.h2d` (a frame's) for `.stream`. Read from the program's span
table (hupr_tpu_torch.utils.profiling.table); nothing where the program
has none."""

from hupr_tpu_torch.utils import profiling

SPANS = {"serve": "hupr.serve.h2d", "stream": "hupr.stream.h2d"}


def read(metric, ctx):
    if not hasattr(profiling, "table"):
        return None
    table = profiling.table()
    span = table["spans"].get(SPANS[metric.split(".")[1]])
    copied = table["counters"].get("hupr.h2d_bytes")
    if not span or not copied or span["host_s"] <= 0:
        return None
    return copied / span["host_s"] / 1e9
