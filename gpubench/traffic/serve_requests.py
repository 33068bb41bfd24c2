"""Serving requests in a closed loop with one client.

A request is `frames` consecutive raw frames per radar view: int16 I/Q
planes (frames, 4, 192, 256), real and imaginary per view, in pageable
host memory as a recording read from disk. `distinct` requests are drawn
from the seed and cycled. The client sends a request through
engine/pipeline.make_e2e_infer, copies its keypoints and maxvals to the
host, and sends the next. Every served answer is compared with the
reference's answer to its request once the window has closed.

Mix parameters: frames, distinct, adc_low, adc_high, tail_units.
"""

from __future__ import annotations

import time

import torch

from gpubench import harness, reference, trace
from gpubench.reference import model as ref_model

def draw_requests(traffic: dict, seed: int, device) -> list:
    """`distinct` requests of four int16 planes each, drawn on `device`
    and moved to pageable host memory."""
    gen = harness.generator(seed, device, 1)
    shape = (traffic["frames"], 4, 192, 256)
    out = []
    for _ in range(traffic["distinct"]):
        planes = torch.randint(traffic["adc_low"], traffic["adc_high"],
                               (4,) + shape, generator=gen, device=device,
                               dtype=torch.int16).cpu()
        out.append(tuple(planes.unbind(0)))
    return out


def reference_heatmaps(state, requests, config, lower=False, device=None):
    """The reference's refined heatmaps (F, K, H, W) of each request,
    windows clamped at the request's edges."""
    prec = harness.precision(config, lower)
    g = harness.geometry(config)
    out = []
    for planes in requests:
        planes = [p.to(device) for p in planes]
        f = planes[0].shape[0]
        ra, re = reference.frame_maps(state, planes, prec,
                                      num_frames=g["chirps"])
        windows = reference.clamped_windows(
            torch.arange(f, device=ra.device), g["group"], f - 1)
        out.append(reference.refined_heatmaps(state, ra, re, windows, prec))
    return out


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from hupr_tpu_torch.engine.pipeline import make_e2e_infer
        from hupr_tpu_torch.models.hupr import build_model

        self.config, self.traffic, self.device = config, traffic, device
        cfg = harness.port_config(config)
        ds = cfg.DATASET
        self.state = harness.draw_state(config, seed, device)
        self.requests = draw_requests(traffic, seed, device)
        self.program = make_e2e_infer(
            build_model(cfg, device), self.state, ds.radar_params(),
            duration=traffic["frames"], group=ds.numGroupFrames,
            num_frames=ds.numFrames, device=device)
        for planes in self.requests[:2]:
            self.serve(planes)
        self.frames_per_unit = traffic["frames"]
        self.flop_shapes = {"frames": traffic["frames"],
                            "windows": traffic["frames"]}
        self.attention = {"rows": traffic["frames"], "bwd_rows": None,
                          "lse": False}
        self.served = []

    def serve(self, planes):
        pred2d, maxvals = self.program(*planes)
        return pred2d.cpu(), maxvals.cpu()

    def window(self, seconds: float) -> dict:
        n, failed = 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            which = n % len(self.requests)
            pred2d, maxvals = self.serve(self.requests[which])
            if not (torch.isfinite(pred2d).all()
                    and torch.isfinite(maxvals).all()):
                failed += 1
            self.served.append((which, pred2d, maxvals))
            n += 1
        wall = time.perf_counter() - t0
        frames = n * self.traffic["frames"]
        return {"attempted": n, "failed": failed, "units": n,
                "wall_s": wall,
                "metrics": {"frames_per_s": frames / wall}}

    def tail(self) -> trace.Trace:
        units = self.traffic["tail_units"]

        def work():
            for i in range(units):
                self.serve(self.requests[i % len(self.requests)])

        return trace.traced(work, units, units * self.frames_per_unit)

    def release(self):
        """Free the program's state before the reference runs."""
        del self.program

    def check(self) -> dict:
        """Every served answer against the reference's answer to its
        request."""
        heat = reference_heatmaps(self.state, self.requests, self.config,
                                  device=self.device)
        return harness.worst([harness.pose_gaps(p, m, heat[which])
                              for which, p, m in self.served])


def control(config, traffic, seed, device, fault=None) -> dict:
    """The numbers of the reference put in the program's place: one notch
    below the configuration's precision (fault None), or at its precision
    with one answer altered where it is produced (fault 'altered')."""
    state = harness.draw_state(config, seed, device)
    requests = draw_requests(traffic, seed, device)
    ref = reference_heatmaps(state, requests, config, device=device)
    served = reference_heatmaps(state, requests, config,
                                lower=fault is None, device=device)
    out = []
    for heat, got in zip(ref, served):
        pred2d, maxvals = ref_model.max_preds(got)
        if fault == "altered":
            pred2d, maxvals = harness.alter(pred2d, maxvals)
        out.append(harness.pose_gaps(pred2d, maxvals, heat))
    return harness.worst(out)

