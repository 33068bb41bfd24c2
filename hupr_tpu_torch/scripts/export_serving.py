"""Export the e2e serving program (raw ADC -> keypoints) to an AOT artifact
(engine/export.py) from the config/checkpoint surface (counterpart of
`scripts/export_serving.py`):

    python -m hupr_tpu_torch.scripts.export_serving \\
        --config mscsa_prgcn_tpu.yaml \\
        --checkpoint logs/mscsa_prgcn/model_best.pth \\
        --frames 32 --out serving_f32.pt2 --platforms cuda,cpu

`--checkpoint` reads a `.pth` (engine/checkpoint.load_checkpoint); omit it
to export synthetic weights (a deployment-shape smoke artifact). The export
traces the program on the CPU, with fake tensors: it computes nothing and
needs no card, and the artifact it writes launches the attention kernels
when it is loaded onto one (`load_artifact(path)`; `device='cpu'` serves it
on the CPU).

Reading a YAML config needs PyYAML; `export(args, cfg)` takes a config
built from the dataclasses instead.
"""

from __future__ import annotations

import argparse

import torch

from hupr_tpu_torch.config import load_config, resolve_config_path
from hupr_tpu_torch.engine.checkpoint import load_checkpoint
from hupr_tpu_torch.engine.export import (artifact_info, export_serving,
                                          save_artifact)
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="mscsa_prgcn.yaml")
    ap.add_argument("--checkpoint", default=None,
                    help=".pth; synthetic weights when omitted")
    ap.add_argument("--frames", type=int, default=32,
                    help="exported frame-stack size (static shape)")
    ap.add_argument("--out", default="serving.pt2")
    ap.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated devices the artifact may be "
                         "loaded onto")
    ap.add_argument("--dtype", default="int16", choices=("int16", "float32"),
                    help="ingest dtype (int16 = DCA1000 native)")
    return ap


def export(args, cfg) -> dict:
    """Write the artifact of `cfg`'s model to args.out; returns its
    artifact_info."""
    d = cfg.DATASET
    model = build_model(cfg, device="cpu")
    if args.checkpoint:
        epoch, _, _ = load_checkpoint(args.checkpoint, model)
        print(f"loaded {args.checkpoint} (epoch {epoch})")
    else:
        model.load_state_dict(synthetic_state_dict(model))
        print("exporting SYNTHETIC weights (no --checkpoint given)")

    # the capture geometry and window length come from the config: a
    # DATASET.adcParams overlay gives an artifact of the weights' geometry
    blob = export_serving(
        model, params=d.radar_params(), frames=args.frames,
        group=d.numGroupFrames, num_frames=d.numFrames,
        dtype={"int16": torch.int16, "float32": torch.float32}[args.dtype],
        platforms=args.platforms.split(","))
    save_artifact(args.out, blob)
    info = artifact_info(blob)
    print(f"wrote {args.out}: {info['bytes'] / 1e6:.1f} MB, "
          f"platforms={info['platforms']}, in={info['in_avals'][0]}, "
          f"out={info['out_avals']}", flush=True)
    return info


def main(argv=None) -> dict:
    args = build_arg_parser().parse_args(argv)
    return export(args, load_config(resolve_config_path(args.config)))


if __name__ == "__main__":
    main()
