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
from torch import nn

from hupr_tpu_torch.ops.dsp import RadarParams, radar_cube_frames
from hupr_tpu_torch.ops.heatmap import get_max_preds
from hupr_tpu_torch.ops.normalize import normalize_radar_window
from hupr_tpu_torch.utils import profiling
from hupr_tpu_torch.utils.device import float32_math, resolve_device


def replicate_pad(x: torch.Tensor, group: int,
                  pad_to: int | None = None) -> torch.Tensor:
    """(F, ...) -> (pad_to + G - 1, ...) with
    padded[j] == x[clamp(j - G//2, 0, F-1)]; pad_to defaults to F, and a
    larger one extends the right edge (whole window batches at the end of
    a sequence, whose extra windows the caller masks out)."""
    f = x.shape[0]
    pad_to = f if pad_to is None else pad_to
    idx = torch.arange(pad_to + group - 1, device=x.device) - group // 2
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


class ServingProgram(nn.Module):
    """The serving body: (hori_re, hori_im, vert_re, vert_im), each
    (F, RX=4, chirps, ADC) int16 or float raw I/Q frames of one sequence
    per radar view on the model's device -> (pred2d (F, K, 2), maxvals
    (F, K, 1)). `make_e2e_infer` runs it live and engine/export.py traces
    it, so the two cannot drift apart. The model's compute dtype holds
    where it has one (the chirp maps are windowed in it)."""

    def __init__(self, model: nn.Module, params: RadarParams = RadarParams(),
                 duration: int = 600, group: int = 8, num_frames: int = 8):
        super().__init__()
        self.model = model
        self.params = params
        self.duration, self.group, self.num_frames = \
            duration, group, num_frames

    def _cube_input(self, re, im):
        c = radar_cube_frames(torch.complex(re.to(torch.float32),
                                            im.to(torch.float32)),
                              self.params)
        return cube_chirp_input(c.real, c.imag, self.num_frames)

    def chirp_maps(self, hori_re, hori_im, vert_re, vert_im):
        """Raw I/Q frames -> the per-frame encoded maps (F, R, A, C) per
        view: the DSP, the normalized chirp input and the MNet encode."""
        with profiling.annotate("hupr.dsp"):
            hori = self._cube_input(hori_re, hori_im)
            vert = self._cube_input(vert_re, vert_im)
        ra, re = self.model.chirp_maps(hori, vert)
        return ra[:, 0], re[:, 0]

    def keypoints(self, ra, re):
        """Windows of the encoded maps (B, G, R, A, C) per view ->
        (pred2d (B, K, 2), maxvals (B, K, 1))."""
        _, gcn = self.model.pose_from_maps(ra, re)
        k, h = gcn.shape[2], gcn.shape[3]
        with profiling.annotate("hupr.decode"):
            return get_max_preds(gcn.reshape(-1, k, h, h))

    def forward(self, hori_re, hori_im, vert_re, vert_im):
        ra, re = self.chirp_maps(hori_re, hori_im, vert_re, vert_im)
        return self.keypoints(
            window_stack_sequences(ra, self.group, self.duration),
            window_stack_sequences(re, self.group, self.duration))


def _to_card(planes, device) -> list:
    """The request's planes as tensors on `device`, inside the span
    `hupr.serve.h2d`; counts the bytes that came from host memory.

    On a card each plane in host memory is copied by the host's intra-op
    threads into a pinned block of torch's caching host allocator, and the
    block's copy to the card is queued on the current stream, so one
    plane's DMA runs while the host stages the next. Every byte is read
    from the caller's memory before it returns; the allocator hands a
    block out again only once the copy that reads it has run. Planes
    already on the card pass through; on the CPU a plane is
    `torch.as_tensor`'s copy."""
    with profiling.annotate("hupr.serve.h2d"):
        profiling.count_h2d(*planes)
        if torch.device(device).type != "cuda":
            return [torch.as_tensor(x, device=device) for x in planes]
        return [_staged(x, device) for x in planes]


def _staged(x, device):
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        return torch.as_tensor(x, device=device)
    host = torch.as_tensor(x)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _sharded_serving(program: ServingProgram, mesh):
    """ServingProgram's body with the frame axis split over `mesh`'s
    ranks: every rank is called with the whole request and runs the DSP
    and the chirp encode on its frame block only, its windows after the
    halo exchange, and the pose decode on them; pred2d and maxvals are
    gathered, so every rank returns the whole request's."""
    from hupr_tpu_torch.parallel.halo import frame_block, window_stack_sharded
    from hupr_tpu_torch.parallel.mesh import gather_blocks

    def run(hori_re, hori_im, vert_re, vert_im):
        f = hori_re.shape[0]
        lo, hi = frame_block(f, mesh)
        ra, re = program.chirp_maps(*_to_card(
            [x[lo:hi] for x in (hori_re, hori_im, vert_re, vert_im)],
            mesh.device))
        pred, maxv = program.keypoints(*(
            window_stack_sharded(m, mesh, program.group, program.duration, f)
            for m in (ra, re)))
        return gather_blocks(pred, mesh), gather_blocks(maxv, mesh)

    return run


def make_e2e_infer(model, state=None, params: RadarParams = RadarParams(),
                   duration: int = 600, group: int = 8, num_frames: int = 8,
                   device=None, mesh=None):
    """Returns run(hori_re, hori_im, vert_re, vert_im) -> (pred2d (F, K, 2),
    maxvals (F, K, 1)) over F raw ADC frames of one sequence per radar
    view, each plane (F, RX=4, 192, ADC=256), int16 (the DCA1000's sample
    format) or float, numpy or torch. `state`, when given, is loaded into
    `model` strictly. Runs `ServingProgram` on the card unless `device`
    says otherwise, in the model's compute dtype where it has one and in
    full float32 elsewhere (TF32 off for the call).

    With `mesh` (parallel.mesh.Mesh) of more than one rank, every rank
    calls run with the whole request and the frame axis is split over the
    ranks (parallel/halo.py): the weights are the same on every rank, each
    encodes its own frame block on `mesh.device`, the sliding window's
    edge frames are exchanged, and every rank returns the whole result.
    F must divide by the world size. A world of one is the unsharded
    program."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model = model.to(dev).eval()
    if state is not None:
        model.load_state_dict(state, strict=True)
    program = ServingProgram(model, params, duration, group,
                             num_frames).eval()
    if mesh is not None and mesh.parallel:
        body = _sharded_serving(program, mesh)
    else:
        def body(*planes):
            return program(*_to_card(planes, dev))

    @torch.inference_mode()
    @float32_math()
    def run(hori_re, hori_im, vert_re, vert_im):
        with profiling.annotate("hupr.serve.request"):
            return body(hori_re, hori_im, vert_re, vert_im)

    return run
