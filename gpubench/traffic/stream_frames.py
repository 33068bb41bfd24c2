"""One live rig: raw frames pushed one at a time, back to back.

The frames of a `capture`-frame recording per view (int16 I/Q planes
(4, 192, 256), real and imaginary per view, in pageable host memory, as
a capture thread hands them over) are drawn from the seed and cycled as
one endless sequence. Each goes through
engine/streaming.StreamingPoseEstimator.process_frame(fetch=True), and its
latency runs from the call to the pose on the host. The set-up pushes the
first `warmup_frames`: the eager first frame and the CUDA graph's capture.

The pose a call returns is that of the frame `latency_frames` back, over
the window of the last G frames, clamped at the sequence's start. A
`sample` of the window's calls, drawn from the seed, is compared with the
reference over those windows once the window has closed.

Mix parameters: capture, adc_low, adc_high, warmup_frames, sample,
tail_units.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpubench import harness, reference, trace
from gpubench.reference import model as ref_model


def draw_capture(traffic: dict, seed: int, device) -> list:
    """Four int16 planes (capture, 4, 192, 256), drawn on `device` and
    moved to pageable host memory."""
    gen = harness.generator(seed, device, 3)
    planes = torch.randint(traffic["adc_low"], traffic["adc_high"],
                           (4, traffic["capture"], 4, 192, 256),
                           generator=gen, device=device,
                           dtype=torch.int16).cpu()
    return list(planes.unbind(0))


def sample_calls(first: int, count: int, size: int, seed: int) -> list:
    """`size` calls of [first, first + count) drawn from the seed, with the
    last always among them."""
    gen = torch.Generator().manual_seed(seed)
    picked = torch.randperm(count, generator=gen)[:size - 1] + first
    return sorted(set(picked.tolist()) | {first + count - 1})


def reference_heatmaps(state, capture, calls, config, lower=False,
                       device=None):
    """The reference's refined heatmaps (len(calls), K, H, W) of the poses
    the given calls return (call t: the window of frames t - G + 1 .. t,
    clamped at 0; frame t is capture frame t % len(capture))."""
    prec = harness.precision(config, lower)
    g = harness.geometry(config)
    length = capture[0].shape[0]
    planes = [p.to(device) for p in capture]
    ra, re = reference.frame_maps(state, planes, prec,
                                  num_frames=g["chirps"])
    calls = torch.tensor(calls, device=ra.device)
    centres = calls - (g["group"] // 2 - 1)
    windows = reference.clamped_windows(centres, g["group"],
                                        int(calls.max()))
    return reference.refined_heatmaps(state, ra, re, windows % length, prec)


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
        from hupr_tpu_torch.models.hupr import build_model

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        cfg = harness.port_config(config)
        ds = cfg.DATASET
        self.state = harness.draw_state(config, seed, device)
        self.capture = draw_capture(traffic, seed, device)
        self.estimator = StreamingPoseEstimator(
            build_model(cfg, device), self.state, ds.radar_params(),
            group=ds.numGroupFrames, num_frames=ds.numFrames, device=device)
        self.pushed = 0
        for _ in range(traffic["warmup_frames"]):
            self.push()
        self.first = self.pushed
        self.poses = []
        self.frames_per_unit = 1
        self.flop_shapes = {"frames": 1, "windows": 1}
        self.attention = {"rows": 1, "bwd_rows": None, "lse": False}

    def push(self):
        t = self.pushed % self.capture[0].shape[0]
        hr, hi, vr, vi = (p[t] for p in self.capture)
        self.pushed += 1
        return self.estimator.process_frame((hr, hi), (vr, vi), fetch=True)

    def window(self, seconds: float) -> dict:
        latencies, failed = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            pred2d, maxvals = self.push()
            latencies.append(time.perf_counter() - start)
            failed += not (np.isfinite(pred2d).all()
                           and np.isfinite(maxvals).all())
            self.poses.append((pred2d, maxvals))
        wall = time.perf_counter() - t0
        n = len(latencies)
        return {"attempted": n, "failed": failed, "units": n, "wall_s": wall,
                "metrics": {"frame_latency_p95_ms":
                            1e3 * float(np.percentile(latencies, 95))}}

    def tail(self) -> trace.Trace:
        units = self.traffic["tail_units"]

        def work():
            for _ in range(units):
                self.push()

        return trace.traced(work, units, units)

    def release(self):
        del self.estimator

    def check(self) -> dict:
        """A sample of the window's poses against the reference's."""
        calls = sample_calls(self.first, len(self.poses),
                             min(self.traffic["sample"], len(self.poses)),
                             self.seed)
        heat = reference_heatmaps(self.state, self.capture, calls,
                                  self.config, device=self.device)
        poses = [self.poses[c - self.first] for c in calls]
        pred2d = torch.from_numpy(np.stack([p for p, _ in poses]))
        maxvals = torch.from_numpy(np.stack([m for _, m in poses]))
        return harness.pose_gaps(pred2d, maxvals, heat)


def control(config, traffic, seed, device, fault=None) -> dict:
    """The numbers of the reference put in the program's place over a
    sample of the capture's first lap after the warm-up: one notch below
    the configuration's precision (fault None), or at its precision with
    one answer altered (fault 'altered')."""
    state = harness.draw_state(config, seed, device)
    capture = draw_capture(traffic, seed, device)
    calls = sample_calls(traffic["warmup_frames"], traffic["capture"],
                         traffic["sample"], seed)
    ref = reference_heatmaps(state, capture, calls, config, device=device)
    got = reference_heatmaps(state, capture, calls, config,
                             lower=fault is None, device=device)
    pred2d, maxvals = ref_model.max_preds(got)
    if fault == "altered":
        pred2d, maxvals = harness.alter(pred2d, maxvals)
    return harness.pose_gaps(pred2d, maxvals, ref)
