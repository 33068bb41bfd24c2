"""The plain reference against the program's eager path on the CPU, at a
tiny size, on the same weights and inputs."""

import numpy as np
import pytest
import torch

from gpubench import harness, reference
from gpubench.reference import model, train
from gpubench.reference.precision import Precision, round_fp8, round_tf32


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def test_state_names_and_shapes_are_the_programs(bench):
    from hupr_tpu_torch.models.hupr import build_model

    cfg = harness.port_config(bench.config("hupr_flagship_f32"))
    net = build_model(cfg, device="cpu")
    spec = model.state_shapes()
    assert list(spec) == list(net.state_dict())
    assert all(tuple(v.shape) == spec[k]
               for k, v in net.state_dict().items())


@pytest.mark.parametrize("cell", ["serve_f32.req32", "stream_bf16.live"])
def test_serving_and_stream_windows(tiny, cell):
    """Every frame of a request through make_e2e_infer, and the stream's
    poses through StreamingPoseEstimator, against the reference."""
    from hupr_tpu_torch.engine.pipeline import make_e2e_infer
    from hupr_tpu_torch.engine.streaming import StreamingPoseEstimator
    from hupr_tpu_torch.models.hupr import build_model

    _, config, traffic = tiny(cell)
    cfg = harness.port_config(config)
    state = harness.draw_state(config, 5, "cpu")
    gen = torch.Generator().manual_seed(6)
    frames = 6
    planes = [torch.randint(-300, 300, (frames, 4, 192, 256), generator=gen,
                            dtype=torch.int16) for _ in range(4)]
    prec = harness.precision(config)
    ra, re = reference.frame_maps(state, planes, prec)
    if cell.startswith("serve"):
        run = make_e2e_infer(build_model(cfg, "cpu"), state,
                             duration=frames, device="cpu")
        pred2d, maxvals = run(*planes)
        windows = reference.clamped_windows(torch.arange(frames), 8,
                                            frames - 1)
    else:
        est = StreamingPoseEstimator(build_model(cfg, "cpu"), state,
                                     device="cpu")
        got = [est.process_frame((planes[0][t], planes[1][t]),
                                 (planes[2][t], planes[3][t]))
               for t in range(frames)]
        pred2d = torch.from_numpy(np.stack([p for p, _ in got]))
        maxvals = torch.from_numpy(np.stack([m for _, m in got]))
        # call t returns the window of frames t - 7 .. t, clamped at 0
        windows = reference.clamped_windows(torch.arange(frames) - 3, 8,
                                            frames - 1)
    heat = reference.refined_heatmaps(state, ra, re, windows, prec)
    gaps = harness.pose_gaps(pred2d, maxvals, heat)
    assert gaps["pose_gap"] <= 1e-6
    assert maxvals.std() > 1e-3


@pytest.mark.parametrize("cell", ["train_bf16.b20", "serve_f32.req32"])
def test_train_steps_with_adam(tiny, cell):
    """Two steps of make_train_step with torch's Adam against the
    reference's steps and Adam, in both recipes."""
    from hupr_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                             make_train_step)
    from hupr_tpu_torch.models.hupr import build_model
    from gpubench.traffic.train_steps import (draw_batches, first_gradient,
                                              initial_weights)

    _, config, _ = tiny(cell)
    cfg = harness.port_config(config)
    state = harness.draw_state(config, 7, "cpu")
    batches = draw_batches(config, {"batch": 2, "distinct": 2}, 8, "cpu")
    net = build_model(cfg, "cpu")
    net.load_state_dict(state)
    tx = make_optimizer(cfg, net)
    step, ts = make_train_step(net, tx), TrainState(net, tx)
    losses, grad = [], None
    for b in batches:
        ts, m = step(ts, b, 1e-4, 0.0)
        losses.append((m["loss1"].item(), m["loss2"].item()))
        if grad is None:
            grad = first_gradient(net, tx)
    program = {"losses": losses, "grad": grad, "weights": {
        n: p.detach() for n, p in net.named_parameters()}}
    ref_losses, ref_grad, ref_weights = train.train_steps(
        state, batches, 1e-4, 1e-4, harness.precision(config))
    gaps = harness.train_gaps(program, {"losses": ref_losses,
                                        "grad": ref_grad,
                                        "weights": ref_weights[2]},
                              initial_weights(state))
    # float32: the same arithmetic; bfloat16: BN and the attention's
    # backward round at other points than autograd's plain path does
    bars = {"float32": 1e-4, "bfloat16": 5e-2}[config["MODEL"]
                                              ["computeDtype"]]
    assert gaps["loss_gap"] <= 1e-5
    assert gaps["grad_gap"] <= bars and gaps["change_gap"] <= bars


def test_rounding_of_the_controls():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -3.0]
    assert round_fp8(torch.tensor([1.0625, 1.2])).tolist() == [1.0, 1.25]
    low = Precision("bfloat16", lower=True)
    assert low.operand(torch.tensor([1.0625])).dtype == torch.bfloat16
    assert Precision("float32").operand(x).equal(x)
    w = x.clone().requires_grad_(True)
    y = Precision("float32", lower=True).operand(w)
    y.sum().backward()
    assert y.tolist() == [1.0, 1.0 + 2 ** -9, -3.0]
    assert w.grad.tolist() == [1.0, 1.0, 1.0]


def test_targets_are_the_programs():
    from hupr_tpu_torch.ops.heatmap import generate_target_batch

    joints = 20 + 210 * torch.rand((3, 14, 2), dtype=torch.float64,
                                   generator=torch.Generator().manual_seed(1))
    joints[0, 0] = torch.tensor([-40.0, 300.0])   # off the map
    want, _ = generate_target_batch(joints)
    assert torch.equal(train.targets(joints), want)
