"""The readings that set the limits of `correct`, beside the program's own.

    python3 -m gpubench.control --workload <cell> --seeds 11 12 13 \\
        [--fault altered|half_batch]

For each seed, the cell's inputs and weights are drawn as a run draws
them, and the reference is put in the program's place: computed one notch
below the precision the configuration states (the control: TF32 operands
for float32, float8 e4m3 for bfloat16), or with `--fault` at the stated
precision with a fault planted (`altered`: one answer altered where it is
produced, serving and streaming; `half_batch`: half of each batch left
out and the mean taken over the rest, training; `frozen_window`: the
state left as the set-up leaves it from the window's first step on,
training). Each seed prints one JSON
line of the numbers `correct` compares; the benchmark's runs never run
this. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault",
                   choices=("altered", "half_batch", "frozen_window"))
    args = p.parse_args(argv)

    import torch

    from gpubench.catalog import Benchmark
    from gpubench.reference.precision import full_float32

    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = Benchmark()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    module = bench.traffic_module(traffic["kind"])
    for seed in args.seeds:
        with full_float32():
            readings = module.control(config, traffic, seed, "cuda",
                                      args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or "control",
                          "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
