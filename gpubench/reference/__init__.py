"""The benchmark's plain reference of HuPR: what the program under test is
held to.

Plain torch only: it imports nothing of the program and takes nothing the
program made. The harness hands it the same raw frames, batches and state
dict as the program, and it works out the cubes, windows, targets and
training state itself.

  dsp        raw I/Q frames -> radar cubes -> normalized chirp input
  model      HuPRNet as functions of a state dict
  train      targets, BCE, Adam
  precision  where products round (the recipes, and the control below them)
"""

from __future__ import annotations

import torch

from gpubench.reference import dsp, model
from gpubench.reference.precision import Precision


@torch.no_grad()
def frame_maps(P, planes, prec: Precision, block: int = 32,
               num_frames: int = 8):
    """Raw frames (hori_re, hori_im, vert_re, vert_im), each (F, 4, 192,
    256) -> per-frame chirp maps (F, R, A, F') per view, in blocks of
    `block` frames."""
    ra, re = [], []
    for lo in range(0, planes[0].shape[0], block):
        hr, hi, vr, vi = (p[lo:lo + block] for p in planes)
        a, e = model.chirp_maps(P, dsp.frame_input(hr, hi, num_frames),
                                dsp.frame_input(vr, vi, num_frames), prec,
                                num_frames)
        ra.append(a[:, 0])
        re.append(e[:, 0])
    return torch.cat(ra), torch.cat(re)


def clamped_windows(centres: torch.Tensor, group: int, last: int):
    """(B,) centre frames -> (B, G) frame indices centre - G/2 + j,
    clamped to [0, last]."""
    offsets = torch.arange(group, device=centres.device) - group // 2
    return (centres[:, None] + offsets).clamp(0, last)


@torch.no_grad()
def refined_heatmaps(P, ra, re, windows: torch.Tensor, prec: Precision,
                     block: int = 8) -> torch.Tensor:
    """Per-frame maps (F, R, A, F') per view and (B, G) window indices ->
    the refined heatmaps (B, K, H, W) float32, in blocks of `block`
    windows, in eval mode."""
    out = []
    for lo in range(0, windows.shape[0], block):
        idx = windows[lo:lo + block]
        _, gcn = model.pose_from_maps(P, ra[idx], re[idx], prec)
        out.append(gcn)
    return torch.cat(out)
