"""End-to-end serving: raw ADC frames -> keypoints (counterpart of
`hupr_tpu/engine/pipeline.py`).

  raw I/Q planes -> radar cubes (ops.dsp) -> per-plane normalize ->
  MNet chirp encoding once per frame -> replicate-clamped windows of the
  encoded maps -> Encoder3D x2, MSCSA decoder, PRGCN -> argmax decode.

The per-frame MNet encoding depends only on single frames, so it runs once
per distinct frame and the window stacks F-channel maps, not raw cubes. The
reference's boundary-clamped window table is replicate padding in time.
"""

from __future__ import annotations

import torch

from hupr_tpu_torch.ops.dsp import RadarParams, radar_cube_frames
from hupr_tpu_torch.ops.heatmap import get_max_preds
from hupr_tpu_torch.ops.normalize import normalize_radar_window
from hupr_tpu_torch.utils.device import float32_math, resolve_device


def replicate_pad(x: torch.Tensor, group: int) -> torch.Tensor:
    """(F, ...) -> (F + G - 1, ...) with
    padded[j] == x[clamp(j - G//2, 0, F-1)]."""
    f = x.shape[0]
    idx = torch.arange(f + group - 1, device=x.device) - group // 2
    return x[idx.clamp(0, f - 1)]


def window_stack(x: torch.Tensor, group: int) -> torch.Tensor:
    """(F, ...) per-frame values -> (F, G, ...) replicate-clamped windows."""
    xp = replicate_pad(x, group)
    f = x.shape[0]
    return torch.stack([xp[j:j + f] for j in range(group)], dim=1)


def window_stack_sequences(x: torch.Tensor, group: int,
                           duration: int) -> torch.Tensor:
    """window_stack clamped per `duration`-frame sequence (the reference's
    `index % duration`): windows never cross a sequence boundary. F must be
    whole sequences, or one partial sequence (F <= duration)."""
    f = x.shape[0]
    if f <= duration:
        return window_stack(x, group)
    if f % duration != 0:
        raise ValueError(
            f"frame stack of {f} must be whole {duration}-frame sequences")
    return torch.cat([window_stack(seq, group)
                      for seq in x.split(duration)], dim=0)


def cube_chirp_input(cubes_real, cubes_imag, num_frames: int = 8):
    """(F, numChirps, R, A, E) cube halves -> normalized per-frame model
    input (F, 1, C, 2, R, A, E), C = the central `num_frames` chirps."""
    c0 = cubes_real.shape[1] // 2 - num_frames // 2
    x = torch.stack([cubes_real[:, c0:c0 + num_frames],
                     cubes_imag[:, c0:c0 + num_frames]], dim=2)
    return normalize_radar_window(x)[:, None]


def make_e2e_infer(model, state=None, params: RadarParams = RadarParams(),
                   duration: int = 600, group: int = 8, num_frames: int = 8,
                   device=None):
    """Returns run(hori_re, hori_im, vert_re, vert_im) -> (pred2d (F, K, 2),
    maxvals (F, K, 1)) over F raw ADC frames of one sequence per radar
    view, each plane (F, RX=4, 192, ADC=256), int16 (the DCA1000's sample
    format) or float, numpy or torch. `state`, when given, is loaded into
    `model` strictly. Runs on the card unless `device` says otherwise, in
    full float32 (TF32 off for the call)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if state is not None:
        model.load_state_dict(state, strict=True)

    def cube(re, im):
        re = torch.as_tensor(re, device=dev).to(torch.float32)
        im = torch.as_tensor(im, device=dev).to(torch.float32)
        c = radar_cube_frames(torch.complex(re, im), params)
        return c.real, c.imag

    @torch.inference_mode()
    @float32_math()
    def run(hori_re, hori_im, vert_re, vert_im):
        hori = cube_chirp_input(*cube(hori_re, hori_im), num_frames)
        vert = cube_chirp_input(*cube(vert_re, vert_im), num_frames)
        ra, re = model.chirp_maps(hori, vert)
        ra = window_stack_sequences(ra[:, 0], group, duration)  # (F,G,R,A,C)
        re = window_stack_sequences(re[:, 0], group, duration)
        _, gcn = model.pose_from_maps(ra, re)
        k, h = gcn.shape[2], gcn.shape[3]
        return get_max_preds(gcn.reshape(-1, k, h, h))

    return run
