"""One run of one cell of the benchmark of hupr_tpu_torch.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Builds the cell's program, weights and
traffic from the seed (the set-up, `setup_s`, timed from the start of the
process), drives the traffic for `--seconds` (the window), then with
`--trace 1` profiles a short tail of the same work, frees the program and
holds what the window produced to the benchmark's plain reference. The
last line on standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` a `breakdown`, and
last `checks`, each compared number beside its limit, which also close
standard error.

Exits 2 with no result when the card or the cards the cell asks for are
missing (there is no fallback to the CPU), and 3 when the process has
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hupr_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run_cell(bench, cell: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", config=None, traffic=None) -> dict:
    """One run of `cell` on `device`; `config` and `traffic` replace the
    cell's own (tests run small sizes on the CPU)."""
    import torch

    from gpubench import harness, roofline
    from gpubench.reference.precision import full_float32

    config = config or bench.config(cell["config"])
    traffic = traffic or bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    module = bench.traffic_module(traffic["kind"])
    on_card = device == "cuda"
    load = module.Load(config, traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _T0
    window = load.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    t1 = time.perf_counter()
    tail = load.tail() if traced else None
    t2 = time.perf_counter()
    load.release()
    if on_card:
        torch.cuda.empty_cache()
    with full_float32():
        checks = load.check()
    phases = {"setup": setup_s, "window": window["wall_s"],
              "trace": t2 - t1, "reference": time.perf_counter() - t2}
    if set(checks) != set(limits):
        raise ValueError(f"checks {sorted(checks)} against limits "
                         f"{sorted(limits)}")
    correct = window["failed"] == 0 and all(
        checks[k] <= limits[k] for k in limits)

    if traced:
        ctx = SimpleNamespace(
            trace=tail, window=window, flop_shapes=load.flop_shapes,
            attention=load.attention, geometry=harness.geometry(config),
            compute=config["MODEL"].get("computeDtype", "float32"),
            peaks=roofline.card_peaks(kind)[1], chips=cell["chips"])
        metrics = {}
        for m in bench.per_layer(cell["name"]):
            value = bench.reader(m["name"])(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(cell["name"])}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tail.busy_s
        dev["window_s"] = tail.wall_s
        result["breakdown"] = {"device_ops": tail.device_ops,
                               "idle_gaps": tail.idle_gaps}
    result["phases_s"] = phases
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in sorted(limits)}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpubench.catalog import Benchmark

    bench = Benchmark()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    smi = power_limit()
    result = run_cell(bench, cell, args.seed, args.seconds,
                      bool(args.trace))
    result["device"]["nvidia_smi"] = smi
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
