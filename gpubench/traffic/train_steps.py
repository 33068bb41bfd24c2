"""Training steps back to back on one card.

The recipe's step, engine/steps.make_train_step, at `batch` rows with the
configuration's optimizer and learning rate, over `distinct` card-resident
batches drawn from the seed and cycled: N(0, 1) raw windows per view and
joints uniform in (20, 230). Losses are read one step late, as the Runner
reads them, so one step is in flight while the host waits for the last.

The set-up builds the one train state the window goes on with and drives
it through its first `check_steps` steps, on the first batches, by the
window's own call, then `warmup_steps` more. The window keeps, on the
card, the losses of its first `window_steps` steps and the parameters
after them; it runs at least that many. Once the window has closed, the
reference replays every one of those steps from the same weights and
batches: each set-up step's losses, the first gradient as Adam got it
(read from its first moment), each leaf's change over the set-up steps,
and the same losses and change over the window's first steps.

Mix parameters: batch, distinct, check_steps, warmup_steps, window_steps,
tail_units.
"""

from __future__ import annotations

import math
import time

import torch

from gpubench import harness, trace
from gpubench.reference import model as ref_model
from gpubench.reference import train as ref_train


def draw_batches(config: dict, traffic: dict, seed: int, device) -> list:
    g = harness.geometry(config)
    gen = harness.generator(seed, device, 2)
    b = traffic["batch"]
    shape = (b, g["group"], g["chirps"], 2, g["range"], g["azimuth"],
             g["elevation"])
    return [{"hori": torch.randn(shape, generator=gen, device=device),
             "vert": torch.randn(shape, generator=gen, device=device),
             "jointsGroup": 20 + 210 * torch.rand(
                 (b, g["keypoints"], 2), generator=gen, device=device,
                 dtype=torch.float64)}
            for _ in range(traffic["distinct"])]


def first_gradient(model, tx) -> dict:
    """Each leaf's gradient in the optimizer's first step, weight decay
    included, from Adam's first moment after it: m_1 = (1 - beta1) g_1. A
    leaf the step never reached reads 0."""
    beta1 = tx.param_groups[0]["betas"][0]
    out = {}
    for name, p in model.named_parameters():
        st = tx.state.get(p, {})
        out[name] = (st["exp_avg"] / (1 - beta1) if "exp_avg" in st
                     else torch.zeros_like(p)).detach().clone()
    return out


def replayed(batches: list, traffic: dict) -> list:
    """The batches of the steps the reference replays, in order: the
    set-up's and the window's first, cycled as the program takes them."""
    steps = traffic["check_steps"] + traffic["warmup_steps"] \
        + traffic["window_steps"]
    return [batches[i % len(batches)] for i in range(steps)]


def reference_readings(state, batches, config, traffic,
                       lower=False) -> dict:
    """The reference's readings over `batches` (replayed), as the program
    takes them in the set-up and in the window."""
    t = config["TRAINING"]
    check, last = traffic["check_steps"], len(batches)
    losses, grad, kept = ref_train.train_steps(
        state, batches, t["lr"], t["weightDecay"],
        harness.precision(config, lower), config["DATASET"]["numFrames"],
        keep=(check, last))
    return {"losses": losses[:check], "grad": grad, "weights": kept[check],
            "window_losses": losses[last - traffic["window_steps"]:],
            "window_weights": kept[last]}


def parameters(net) -> dict:
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def window_steps(run_step, seconds: float, keep: int, net):
    """Steps back to back for `seconds`, and at least `keep` of them, each
    loss read one step late; the first `keep` steps' losses and the
    parameters after them are kept on the card and read at the end.
    Returns (steps, failed, wall seconds, their readings)."""
    n, failed, last, kept, weights = 0, 0, None, [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or n < keep:
        metrics = run_step()
        n += 1
        if n <= keep:
            kept.append((metrics["loss1"], metrics["loss2"]))
            if n == keep:
                weights = parameters(net)
        if last is not None:
            failed += not math.isfinite(last["loss"].item())
        last = metrics
    failed += not math.isfinite(last["loss"].item())
    wall = time.perf_counter() - t0
    return n, failed, wall, {
        "window_losses": [(a.item(), b.item()) for a, b in kept],
        "window_weights": weights}


def initial_weights(state) -> dict:
    return {k: v for k, v in state.items() if ref_model.is_parameter(k)}


class Load:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                                 make_train_step)
        from hupr_tpu_torch.models.hupr import build_model

        self.config, self.traffic = config, traffic
        cfg = harness.port_config(config)
        g = harness.geometry(config)
        self.state = harness.draw_state(config, seed, device)
        self.batches = draw_batches(config, traffic, seed, device)
        net = build_model(cfg, device)
        net.load_state_dict(self.state, strict=True)
        tx = make_optimizer(cfg, net)
        self.step = make_train_step(net, tx, cfg.TRAINING.lossDecay,
                                    (g["keypoints"], g["heatmap"], g["img"]))
        self.train_state, self.net = TrainState(net, tx), net
        self.lr = cfg.TRAINING.lr
        self.taken = 0
        losses, grad = [], None
        for _ in range(traffic["check_steps"]):
            m = self.run_step()
            losses.append((m["loss1"].item(), m["loss2"].item()))
            if grad is None:
                grad = first_gradient(net, tx)
        self.readings = {"losses": losses, "grad": grad,
                         "weights": parameters(net)}
        for _ in range(traffic["warmup_steps"]):
            self.run_step()["loss"].item()
        self.frames_per_unit = traffic["batch"]
        self.flop_shapes = {"frames": 0, "windows": traffic["batch"],
                            "train": True}
        self.attention = {"rows": traffic["batch"],
                          "bwd_rows": traffic["batch"], "lse": True}

    def run_step(self) -> dict:
        batch = self.batches[self.taken % len(self.batches)]
        self.train_state, metrics = self.step(self.train_state, batch,
                                              self.lr, 0.0)
        self.taken += 1
        return metrics

    def window(self, seconds: float) -> dict:
        n, failed, wall, readings = window_steps(
            self.run_step, seconds, self.traffic["window_steps"], self.net)
        self.readings.update(readings)
        rows = n * self.traffic["batch"]
        return {"attempted": n, "failed": failed, "units": n, "wall_s": wall,
                "metrics": {"train_samples_per_s": rows / wall}}

    def tail(self) -> trace.Trace:
        units = self.traffic["tail_units"]

        def work():
            last = None
            for _ in range(units):
                metrics = self.run_step()
                if last is not None:
                    last["loss"].item()
                last = metrics
            last["loss"].item()

        return trace.traced(work, units, units * self.frames_per_unit)

    def release(self):
        """Free the program's state before the reference runs: only the
        batches of the steps it replays stay."""
        del self.step, self.train_state, self.net
        self.batches = replayed(self.batches, self.traffic)

    def check(self) -> dict:
        ref = reference_readings(self.state, self.batches, self.config,
                                 self.traffic)
        return harness.train_gaps(self.readings, ref,
                                  initial_weights(self.state))


def frozen_window(state, batches, config, traffic) -> dict:
    """The reference's readings with its state left as the set-up leaves
    it from the window's first step on: the window's losses taken at those
    weights, and those weights in place of the window's."""
    t = config["TRAINING"]
    prec = harness.precision(config)
    frames = config["DATASET"]["numFrames"]
    check = traffic["check_steps"]
    set_up = check + traffic["warmup_steps"]
    losses, grad, kept = ref_train.train_steps(
        state, batches[:set_up], t["lr"], t["weightDecay"], prec, frames,
        keep=(check, set_up))
    frozen = dict(state, **kept[set_up])
    with torch.no_grad():
        window = [tuple(x.item() for x in
                        ref_train.losses(frozen, b, prec, frames))
                  for b in batches[set_up:]]
    return {"losses": losses[:check], "grad": grad, "weights": kept[check],
            "window_losses": window, "window_weights": kept[set_up]}


def control(config, traffic, seed, device, fault=None) -> dict:
    """The numbers of the reference put in the program's place: one notch
    below the configuration's precision (fault None), or at its precision
    on the first half of each batch's rows (fault 'half_batch'), or with
    its state left unchanged from the window's first step on (fault
    'frozen_window')."""
    state = harness.draw_state(config, seed, device)
    batches = replayed(draw_batches(config, traffic, seed, device), traffic)
    ref = reference_readings(state, batches, config, traffic)
    if fault == "frozen_window":
        got = frozen_window(state, batches, config, traffic)
    elif fault == "half_batch":
        half = traffic["batch"] // 2
        got = reference_readings(state, [{k: v[:half] for k, v in b.items()}
                                         for b in batches], config, traffic)
    else:
        got = reference_readings(state, batches, config, traffic,
                                 lower=True)
    return harness.train_gaps(got, ref, initial_weights(state))
