"""engine/pipeline._to_card, the copy of a served request's planes to the
device, on the CPU: on a CPU device it hands back `torch.as_tensor`'s
tensors, and serving takes each request through it once. The staged path
itself (pinned blocks, non_blocking copies) runs on the card:
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from hupr_tpu_torch.engine import pipeline


def _planes(kind, dtype, frames=5):
    rng = np.random.default_rng(3)
    planes = [rng.integers(-300, 300, (frames, 4, 6, 8)).astype(dtype)
              for _ in range(4)]
    return planes if kind == "numpy" else [torch.from_numpy(p)
                                           for p in planes]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_on_the_cpu_planes_are_as_tensor_copies(kind, dtype):
    """_to_card on a CPU device is the former copy-in: each plane is
    torch.as_tensor(plane, device), dtype and values kept; a CPU tensor
    is handed back as itself."""
    planes = _planes(kind, dtype)
    got = pipeline._to_card(planes, torch.device("cpu"))
    for g, p in zip(got, planes):
        want = torch.as_tensor(p, device="cpu")
        assert g.device.type == "cpu" and g.dtype == want.dtype
        assert torch.equal(g, want)
        if kind == "torch":
            assert g is p


def test_cpu_serving_runs_through_to_card(monkeypatch):
    """make_e2e_infer takes each request's four planes through one
    _to_card call, on the program's device, and serves what it returns."""
    calls = []
    real = pipeline._to_card

    def spy(planes, device):
        got = real(planes, device)
        calls.append((len(planes), torch.device(device)))
        return got

    from hupr_tpu_torch.models.hupr import HuPRNet
    from hupr_tpu_torch.ops.dsp import RadarParams

    monkeypatch.setattr(pipeline, "_to_card", spy)
    rp = RadarParams(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                     num_group_chirp=2)
    torch.manual_seed(0)
    run = pipeline.make_e2e_infer(HuPRNet(num_filters=2, heatmap_size=32),
                                  None, rp, duration=4, device="cpu")
    rng = np.random.default_rng(1)
    planes = [rng.integers(-300, 300, (4, 4, 48, 128)).astype(np.int16)
              for _ in range(4)]
    pred, maxv = run(*planes)
    again = run(*planes)
    assert calls == [(4, torch.device("cpu"))] * 2
    assert pred.shape == (4, 14, 2) and maxv.shape == (4, 14, 1)
    assert torch.equal(again[0], pred) and torch.equal(again[1], maxv)
