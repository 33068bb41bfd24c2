"""Streaming (per-frame, latency-oriented) pose estimation (counterpart of
`hupr_tpu/engine/streaming.py`).

The batch pipeline (engine/pipeline.py) serves frame stacks for
throughput; this module serves one frame at a time with the same
semantics: a rolling window of the last G per-frame chirp-encoded maps
feeds the pose decoder, and the start of a sequence is replicate-padded
as the reference's boundary clamp pads it (datasets/dataset.py:126-138).
The offline window is centred (G/2 - 1 frames of lookahead), and a causal
stream cannot see the future, so the pose a frame emits is the one of the
frame G/2 - 1 steps back: `latency_frames`.

Everything stays on the card between frames. Per frame the host copies
the raw ADC planes in (int16 planes travel at their own width and are cast
on the card), runs one step (encode, push into the window, decode) and
copies one packed (K, 3) result out: keypoints and maxvals together.

On the card the step is a CUDA graph, the counterpart of the JAX package's
one fused dispatch per frame: static input buffers that each frame's
planes are copied into, the window as a persistent tensor updated in
place, captured once per input dtype after a warm-up step (which builds
the kernels, caches cuFFT's plans and picks cuDNN's algorithms) and inside
the float32 pin (TF32 off), and replayed every frame. A failed capture or
replay raises; it never falls back to the eager step. The first frame of
a sequence and the end-of-sequence flush run eagerly: once a sequence
each. On the CPU every step runs eagerly.

The kernel wrappers count the calls that launch their kernels: the warm-up
step's and the capture's (which records the launches into the graph). A
replay calls no wrapper, so the kernels a replay runs are counted from the
card's trace (chip_smoke.py's `stream` lines).
"""

from __future__ import annotations

import torch

from hupr_tpu_torch.engine.pipeline import cube_chirp_input
from hupr_tpu_torch.ops.dsp import RadarParams, radar_cube_frames
from hupr_tpu_torch.ops.heatmap import get_max_preds
from hupr_tpu_torch.utils.device import float32_math, resolve_device


class StreamingPoseEstimator:
    """`model` (a HuPRNet) with `state` loaded strictly when given, on the
    card unless `device` says otherwise. `cuda_graph=False` runs every step
    eagerly on the card too."""

    def __init__(self, model, state=None, params: RadarParams = RadarParams(),
                 group: int = 8, num_frames: int = 8, device=None,
                 cuda_graph: bool = True):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if state is not None:
            self.model.load_state_dict(state, strict=True)
        self.params = params
        self.group = group
        self.num_frames = num_frames
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        # rolling (G, R, A, F) chirp maps per view in the model's compute
        # dtype: made at the first frame and only written in place after
        # it, since a captured graph holds its address
        self._window = None
        self._started = False
        self._count = 0
        self._graphs: dict = {}      # input dtypes -> captured step

    @property
    def latency_frames(self) -> int:
        """Poses lag the newest frame by G/2 - 1 frames (the centred
        window's lookahead)."""
        return self.group // 2 - 1

    def reset(self):
        """Start a new sequence at the next frame."""
        self._started = False
        self._count = 0

    # ------------- the step's parts, on tensors on the model's device ----

    def _encode(self, hori_re, hori_im, vert_re, vert_im):
        def cube(re, im):
            c = radar_cube_frames(torch.complex(
                re.to(torch.float32), im.to(torch.float32))[None],
                self.params)
            return c.real, c.imag

        hori = cube_chirp_input(*cube(hori_re, hori_im), self.num_frames)
        vert = cube_chirp_input(*cube(vert_re, vert_im), self.num_frames)
        ra, re = self.model.chirp_maps(hori, vert)
        return ra[0, 0], re[0, 0]                     # (R, A, F) each

    def _push(self, new):
        for w, x in zip(self._window, new):
            w.copy_(torch.cat([w[1:], x[None]]))

    def _decode(self):
        ra, re = self._window
        _, gcn = self.model.pose_from_maps(ra[None], re[None])
        k, h = gcn.shape[2], gcn.shape[3]
        pred2d, maxvals = get_max_preds(gcn.reshape(-1, k, h, h))
        # one (K, 3) tensor, so that a frame makes one host copy
        return torch.cat([pred2d[0], maxvals[0]], dim=-1)

    def _step(self, *planes):
        self._push(self._encode(*planes))
        return self._decode()

    def _first_step(self, *planes):
        """Sequence start: the window full of the first frame."""
        new = self._encode(*planes)
        if self._window is None:
            self._window = [x.expand(self.group, *x.shape).clone()
                            for x in new]
        else:
            for w, x in zip(self._window, new):
                w.copy_(x.expand_as(w))
        return self._decode()

    # ------------- the CUDA graph of _step -------------

    def _capture(self, planes):
        dev = self.device
        inputs = [torch.empty(p.shape, dtype=p.dtype, device=dev)
                  for p in planes]
        for buf, p in zip(inputs, planes):
            buf.copy_(p)
        saved = [w.clone() for w in self._window]
        # warm-up on a side stream, as torch.cuda.graphs asks: the
        # kernels, cuFFT's plans and cuDNN's algorithms are made here, and
        # the capture keeps what was chosen
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step(*inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self._step(*inputs)
        for w, s in zip(self._window, saved):
            w.copy_(s)
        return {"graph": graph, "inputs": inputs, "out": out}

    def _graph_step(self, planes):
        key = tuple(p.dtype for p in planes)
        if key not in self._graphs:
            self._graphs[key] = self._capture(planes)
        g = self._graphs[key]
        for buf, p in zip(g["inputs"], planes):
            buf.copy_(p)
        g["graph"].replay()
        return g["out"]

    # ------------- the public interface -------------

    @staticmethod
    def _split(frame):
        """(re, im) planes of one view's frame: a (re, im) tuple keeps its
        dtype (int16 ADC planes travel at half the bytes and are cast on
        the card, exactly); a complex frame gives float32 planes."""
        if isinstance(frame, tuple):
            return tuple(torch.as_tensor(x) for x in frame)
        frame = torch.as_tensor(frame)
        return frame.real.to(torch.float32), frame.imag.to(torch.float32)

    def process_frame(self, hori_frame, vert_frame, fetch: bool = True):
        """One raw ADC frame per view, each (RX=4, 192, 256) complex or a
        (re, im) tuple of float32 or int16 planes, numpy or torch, on the
        host or the card -> (keypoints (K, 2) in heatmap coordinates,
        maxvals (K, 1)).

        The first frame of a sequence fills the window with itself (the
        start clamp); every frame emits the pose of the window centred
        G/2 - 1 frames back. With fetch=False the two are tensors on the
        card, read when the caller reads them (a graph step's output is
        copied first, since the next replay overwrites it)."""
        planes = self._split(hori_frame) + self._split(vert_frame)
        with torch.inference_mode(), float32_math():
            if not self._started:
                packed = self._first_step(
                    *(p.to(self.device) for p in planes))
                self._started = True
            elif self.cuda_graph:
                packed = self._graph_step(planes)
                if not fetch:
                    packed = packed.clone()
            else:
                packed = self._step(*(p.to(self.device) for p in planes))
        self._count += 1
        if not fetch:
            return packed[:, :2], packed[:, 2:]
        arr = packed.cpu().numpy()              # one host copy per frame
        return arr[:, :2], arr[:, 2:]

    def flush(self):
        """End of sequence: emit the remaining min(frames processed,
        G/2 - 1) poses by re-pushing the last frame (the offline
        end-of-sequence clamp), then reset for the next sequence.

        For a sequence shorter than the lookahead (F <= G/2 - 1) every
        valid pose comes from the flush: the first (G/2 - 1) - F flush
        windows are still warming up and are pushed but not emitted, so a
        consumer that drops the first `latency_frames` outputs of
        process_frame and appends every flush output ends up with exactly
        F poses."""
        out = []
        if not self._started:
            return out
        skip = max(0, self.latency_frames - self._count)
        with torch.inference_mode(), float32_math():
            for i in range(self.latency_frames):
                self._push([w[-1] for w in self._window])
                packed = self._decode()
                if i >= skip:
                    arr = packed.cpu().numpy()
                    out.append((arr[:, :2], arr[:, 2:]))
        self.reset()
        return out
