"""The port's CLI (counterpart of the repo's main.py; parity: the
reference's main.py).

    python -m hupr_tpu_torch.main --config mscsa_prgcn_tpu.yaml --dir X
    python -m hupr_tpu_torch.main --config mscsa_prgcn_tpu.yaml --dir X --eval

train (resuming from ./logs/X/checkpoint.pth when there is one), or
evaluate ./logs/X/model_best.pth.

Runs on the CUDA card, and fails without one; HUPR_PLATFORM=cpu asks for
the CPU. The Runner refuses HUPR_MULTIHOST=1 (multi-host runs are not
ported, ROADMAP A9). Reading a YAML config needs PyYAML; `run(args, cfg)`
takes a config built from the dataclasses instead
(config.flagship_*_config), as chip_smoke.py does.
"""

from __future__ import annotations

import os

from hupr_tpu_torch.config import (build_arg_parser, load_config,
                                   resolve_config_path)
from hupr_tpu_torch.engine.runner import Runner


def requested_device():
    """'cpu' when HUPR_PLATFORM=cpu; None (the card) when it is unset; any
    other value is refused."""
    platform = os.environ.get("HUPR_PLATFORM", "")
    if platform not in ("", "cpu"):
        raise ValueError(f"HUPR_PLATFORM={platform!r}: the port runs on the "
                         f"card (unset) or on the CPU ('cpu')")
    return platform or None


def run(args, cfg, device=None) -> Runner:
    """main.py's flow on a parsed `args` and a built `cfg`: evaluate the
    best checkpoint with --eval, else resume from the latest one (or start
    from scratch) and train. Returns the Runner."""
    runner = Runner(args, cfg, device=device)
    vis = args.visDir != "none"
    if args.eval:
        runner.load_model_weight("model_best")
        runner.eval(visualization=vis)
    else:
        runner.load_model_weight("checkpoint")
        runner.train()
    return runner


def main(argv=None) -> Runner:
    device = requested_device()
    args = build_arg_parser().parse_args(argv)
    cfg = load_config(resolve_config_path(args.config))
    return run(args, cfg, device=device)


if __name__ == "__main__":
    main()
