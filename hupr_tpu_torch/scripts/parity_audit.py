"""One-command real-data AP parity audit against the reference benchmark
(counterpart of the repo's scripts/parity_audit.py).

The final parity bar: evaluate the released reference weights
(`model_best.pth`, which the port reads natively) on the real HuPR val or
test split and reproduce the reference's COCO keypoint APs. Neither the
dataset nor the weights are in the repo; this script is the turnkey last
mile for the day they are present.

    # place the dataset under DATASET.dataDir (default data/HuPR) and the
    # released weights at logs/<dir>/model_best.pth, then:
    python -m hupr_tpu_torch.scripts.parity_audit --dir mscsa_prgcn
    python -m hupr_tpu_torch.scripts.parity_audit --split val \\
        --expected-ap 0.643 --tolerance 0.005                     # gated

Exit codes: 0 = audit ran (and matched, if --expected-ap was given),
2 = required assets missing (a checklist of exactly what to supply is
printed), 1 = ran but missed the --expected-ap gate.

Prints a final JSON report line (machine-readable) after the human-readable
COCO summary. Runs on the CUDA card, and fails without one; HUPR_PLATFORM=cpu
asks for the CPU. Reading a YAML config needs PyYAML; `run_audit(args, cfg)`
takes a config built from the dataclasses instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from hupr_tpu_torch.config import load_config, resolve_config_path
from hupr_tpu_torch.engine.checkpoint import find_checkpoint
from hupr_tpu_torch.engine.runner import Runner
from hupr_tpu_torch.eval import KeypointEvaluator
from hupr_tpu_torch.utils.device import resolve_device


def check_assets(cfg, log_dir: str, split: str):
    """Return a list of human-actionable missing-asset strings (empty =
    ready). Checks exactly what the eval path will read. A JAX-package
    model_best.ckpt in place of the .pth raises (find_checkpoint)."""
    d = cfg.DATASET
    missing = []
    annot = os.path.join(d.dataDir, f"hrnet_annot_{split}.json")
    if not os.path.isfile(annot):
        missing.append(
            f"annotation file {annot} (HuPR release: hrnet_annot_*.json)")
    seqs = d.split_names(split)
    if not seqs:
        missing.append(f"config lists no sequences for split '{split}'")
    bad_seqs = []
    for s in seqs:
        for view in ("hori", "vert"):
            vdir = os.path.join(d.dataDir, f"single_{s}", view)
            # the loader reads %09d.npy for frames 0..duration-1; spot-check
            # the first and last instead of listing 600 files per sequence
            first = os.path.join(vdir, "%09d.npy" % 0)
            last = os.path.join(vdir, "%09d.npy" % (d.duration - 1))
            if not (os.path.isfile(first) and os.path.isfile(last)):
                bad_seqs.append(f"single_{s}/{view}")
    if bad_seqs:
        shown = ", ".join(bad_seqs[:6]) + (" …" if len(bad_seqs) > 6 else "")
        missing.append(
            f"{len(bad_seqs)} sequence dir(s) under {d.dataDir} lack frames "
            f"0..{d.duration - 1} ({shown}) — run the preprocessing CLI "
            f"(python -m hupr_tpu_torch.preprocessing.process_iwr1843) on "
            f"the raw captures or download the preprocessed cubes")
    if find_checkpoint(log_dir, "model_best") is None:
        missing.append(
            f"weights: no model_best.pth under {log_dir}/ (the released "
            f"reference .pth loads directly)")
    return missing


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Real-data AP parity audit (reference README eval run)")
    ap.add_argument("--config", default="mscsa_prgcn.yaml",
                    help="config under ./config/ (parity default; the "
                         "tuned variants evaluate identically)")
    ap.add_argument("--dir", default="mscsa_prgcn",
                    help="logs/<dir> holding model_best.pth")
    ap.add_argument("--split", choices=("val", "test"), default="test")
    ap.add_argument("--expected-ap", type=float, default=None,
                    help="gate: fail (exit 1) unless |AP - expected| <= "
                         "tolerance (e.g. the reference checkpoint's "
                         "published AP for this split)")
    ap.add_argument("--tolerance", type=float, default=0.005)
    ap.add_argument("--keypoints", action="store_true",
                    help="also report per-keypoint APs")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run_audit(args, cfg, device=None):
    """The audit on parsed `args` and a built `cfg`, on the card unless
    `device` says otherwise. Returns (exit code, the report dict, or None
    when assets are missing)."""
    device = resolve_device(device)
    log_dir = os.path.join("./logs", args.dir)
    missing = check_assets(cfg, log_dir, args.split)
    if missing:
        print("parity audit blocked — supply these assets and re-run:")
        for m in missing:
            print(f"  - {m}")
        print("(dataset + released weights: see the reference README's "
              "download section; .npy layout and annot schema are read "
              "as-is — MIGRATION.md)")
        return 2, None

    # the reference CLI's eval flow (main.py:36-38), split selectable.
    # Always eval-mode: a --split val audit must not construct the train
    # loader (the train annotations/sequences may be absent on an
    # eval-only host and check_assets deliberately doesn't require them) —
    # evalPhase points the eval at the requested split instead
    run_args = argparse.Namespace(seed=args.seed, dir=args.dir,
                                  visDir="none", eval=True,
                                  evalPhase=args.split,
                                  sampling_ratio=1, keypoints=args.keypoints)
    runner = Runner(run_args, cfg, device=device)
    runner.load_model_weight("model_best")
    ap_value = runner.eval(visualization=False)

    # full 10-stat vector + optional per-keypoint APs from the written
    # results JSON (same artifact the reference's evaluate() consumes)
    res_file = os.path.join(log_dir, f"{runner.test_set.phase}_results.json")
    with open(res_file) as fp:
        dts = json.load(fp)
    ev = KeypointEvaluator(runner.test_set.gt_dataset, dts)
    stats = [float(v) for v in ev.run(verbose=False)]
    report = {
        "split": runner.test_set.phase,
        "config": args.config,
        "checkpoint_dir": log_dir,
        "AP": stats[0], "AP50": stats[1], "AP75": stats[2],
        "APm": stats[3], "APl": stats[4],
        "AR": stats[5], "AR50": stats[6], "AR75": stats[7],
        "ARm": stats[8], "ARl": stats[9],
    }
    if args.keypoints:
        names = cfg.DATASET.idxToJoints
        report["per_keypoint_AP"] = {
            n: float(ev.run(idx_keypoint=k, verbose=False)[0])
            for k, n in enumerate(names)}
    if args.expected_ap is not None:
        report["expected_AP"] = args.expected_ap
        report["delta"] = stats[0] - args.expected_ap
        report["within_tolerance"] = abs(report["delta"]) <= args.tolerance
    print(json.dumps(report))
    assert abs(ap_value - stats[0]) < 1e-9  # same artifact, same protocol
    if args.expected_ap is not None and not report["within_tolerance"]:
        return 1, report
    return 0, report


def main(argv=None) -> int:
    from hupr_tpu_torch.main import requested_device

    args = build_arg_parser().parse_args(argv)
    device = resolve_device(requested_device())  # no card: refused here
    cfg_path = resolve_config_path(args.config)
    if not os.path.isfile(cfg_path):
        print(f"missing: config {cfg_path}", file=sys.stderr)
        return 2
    cfg = load_config(cfg_path)
    return run_audit(args, cfg, device)[0]


if __name__ == "__main__":
    sys.exit(main())
