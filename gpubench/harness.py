"""What every traffic module shares: the configuration's sizes, the
weights drawn from the seed, and the numbers that decide `correct`."""

from __future__ import annotations

import statistics

import torch

from gpubench.catalog import CONFIG_SECTIONS
from gpubench.reference import model
from gpubench.reference.precision import Precision


def geometry(config: dict) -> dict:
    """The sizes the reference and the yardstick need, from a
    configuration file."""
    ds, md = config["DATASET"], config["MODEL"]
    return {"numFilters": md["numFilters"], "group": ds["numGroupFrames"],
            "chirps": ds["numFrames"], "range": ds["rangeSize"],
            "azimuth": ds["azimuthSize"], "elevation": ds["elevationSize"],
            "keypoints": ds["numKeypoints"], "heatmap": ds["heatmapSize"],
            "img": ds["imgSize"]}


def precision(config: dict, lower: bool = False) -> Precision:
    return Precision(config["MODEL"].get("computeDtype", "float32"), lower)


def port_config(config: dict):
    """The program's Config of a configuration file."""
    from hupr_tpu_torch.config import config_from_dict

    return config_from_dict({k: config[k] for k in CONFIG_SECTIONS
                             if k in config})


def draw_state(config: dict, seed: int, device) -> dict:
    """The state dict from `seed`, made on `device` in one draw: every
    float entry N(0, weights_std), BatchNorm's running variances |x| + 1
    (a negative variance fills the forward with NaNs), the counters 0."""
    g = geometry(config)
    shapes = model.state_shapes(g["numFilters"], g["group"], g["keypoints"],
                                g["heatmap"])
    floats = {k: s for k, s in shapes.items()
              if not k.endswith("num_batches_tracked")}
    sizes = [torch.Size(s).numel() for s in floats.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat.mul_(config["weights_std"])
    state = {}
    for (key, shape), part in zip(floats.items(), flat.split(sizes)):
        state[key] = part.view(shape)
        if key.endswith("running_var"):
            state[key] = state[key].abs() + 1.0
    for key in shapes:
        if key.endswith("num_batches_tracked"):
            state[key] = torch.zeros((), dtype=torch.int64, device=device)
    return {k: state[k] for k in shapes}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator of its own for each kind of input drawn from `seed`."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (2 ** 63))


# ------------------------------------------------------------ the numbers

def pose_gaps(pred2d, maxvals, ref_heatmaps) -> dict:
    """Served poses (B, K, 2) xy and maxvals (B, K, 1) against the
    reference's refined heatmaps (B, K, H, W): `pose_gap`, the widest gap
    of an answer, the larger of |maxval - the reference's maximum| and
    the gap by which the reference's heatmap at the served keypoint lies
    below its maximum (0 wherever the served keypoint is a maximum of the
    reference, so a tie between equal peaks costs nothing)."""
    b, k, h, w = ref_heatmaps.shape
    flat = ref_heatmaps.reshape(b, k, h * w).to(torch.float32)
    best = flat.amax(dim=2)
    pred = pred2d.to(flat.device).round().long()
    idx = (pred[..., 1] * w + pred[..., 0]).clamp(0, h * w - 1)
    at = flat.gather(2, idx[..., None])[..., 0]
    mv = maxvals.to(flat.device).reshape(b, k).to(torch.float32)
    return {"pose_gap": max((mv - best).abs().max().item(),
                            (best - at).max().item())}


def alter(pred2d, maxvals):
    """One answer altered where it is produced: the first keypoint of the
    first pose moved to the map's corner and its maxval raised by a
    hundredth."""
    pred2d, maxvals = pred2d.clone(), maxvals.clone()
    pred2d[0, 0] = 0.0
    maxvals[0, 0] += 1e-2
    return pred2d, maxvals


def worst(readings: list) -> dict:
    """{name: the largest of the readings} over a list of dicts."""
    out = {}
    for r in readings:
        for name, value in r.items():
            out[name] = max(out.get(name, value), value)
    return out


def leaf_norm_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's |norm(program) - norm(reference)|, each against the
    larger of that leaf's reference norm and the median leaf's. `keep`
    names the leaves compared (all by default)."""
    names = [k for k in reference if keep is None or k in keep]
    norms = {k: reference[k].to(torch.float32).norm().item() for k in names}
    median = statistics.median(norms.values())
    gap = 0.0
    for k in names:
        p = program[k].to(torch.float32).norm().item()
        gap = max(gap, abs(p - norms[k]) / max(norms[k], median))
    return gap


def moving_leaves(ref_grads: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm. Under Adam the others
    move by round-off alone."""
    norms = {k: g.to(torch.float32).norm().item()
             for k, g in ref_grads.items()}
    floor = 1e-3 * statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= floor}


def train_gaps(program: dict, reference: dict, w0: dict) -> dict:
    """The training numbers: `loss_gap`, the widest relative gap of a
    set-up step's loss1 or loss2; `grad_gap`, the first gradient's worst
    leaf (leaf_norm_gap); `change_gap`, the worst moving leaf's change
    from w0 over the set-up steps; `grad_diff_gap` (leaf_diff_gap); and,
    where the readings hold the window's first steps, `window_loss_gap`
    and `window_change_gap`, the same over those steps' losses and the
    parameters after them. `program` and `reference` hold 'losses'
    [(loss1, loss2)], 'grad' {leaf: tensor} and 'weights' {leaf: tensor},
    and may hold 'window_losses' and 'window_weights'."""
    keep = moving_leaves(reference["grad"])

    def change(weights):
        return {k: weights[k] - w0[k] for k in keep}

    gaps = {"loss_gap": loss_gap(program["losses"], reference["losses"]),
            "grad_gap": leaf_norm_gap(program["grad"], reference["grad"]),
            "change_gap": leaf_norm_gap(change(program["weights"]),
                                        change(reference["weights"])),
            "grad_diff_gap": leaf_diff_gap(program["grad"],
                                           reference["grad"])}
    if "window_losses" in reference:
        gaps["window_loss_gap"] = loss_gap(program["window_losses"],
                                           reference["window_losses"])
        gaps["window_change_gap"] = leaf_norm_gap(
            change(program["window_weights"]),
            change(reference["window_weights"]))
    return gaps


def loss_gap(program: list, reference: list) -> float:
    """The widest relative gap of a step's loss1 or loss2."""
    if len(program) != len(reference):
        raise ValueError(f"{len(program)} steps against {len(reference)}")
    return max(abs(p - r) / abs(r) for ps, rs in zip(program, reference)
               for p, r in zip(ps, rs))


def leaf_diff_gap(program: dict, reference: dict) -> float:
    """The worst leaf's norm(program - reference), against the larger of
    that leaf's reference norm and the median leaf's: the first
    gradient's direction, which rows left out of a batch turn."""
    norms = {k: r.to(torch.float32).norm().item()
             for k, r in reference.items()}
    median = statistics.median(norms.values())
    return max((program[k].to(torch.float32)
                - reference[k].to(torch.float32)).norm().item()
               / max(norms[k], median) for k in reference)
