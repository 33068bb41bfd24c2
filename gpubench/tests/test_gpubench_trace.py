"""The traced span's reading: busy time as the union of the card's spans,
the span's own mirror on the card left out, idle gaps named by what the
host ran, launches counted."""

from types import SimpleNamespace

import pytest
import torch

from gpubench import roofline, trace
from gpubench.layer_metrics import attn_roofline, idle_share, mfu
from gpubench.roofline import PEAKS

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def fake_trace():
    events = [
        event(trace.SPAN, 0, 2000),
        event(trace.SPAN, 5, 2000, CUDA, annotation=True),
        event("aten::conv", 10, 1100),
        event("cudaLaunchKernel", 20, 30),
        event("cudaGraphLaunch", 1350, 1360),
        event("cudaStreamSynchronize", 1700, 1990),
        event("void attention_fwd_tf32<64>(float const*)", 100, 1100, CUDA),
        event("conv_kernel", 1050, 1300, CUDA),
        event("Memcpy HtoD (Pageable -> Device)", 1500, 1600, CUDA),
    ]
    prof = SimpleNamespace(events=lambda: events)
    return trace.read(prof, wall_s=2000e-6, units=2, frames=64)


def test_busy_idle_and_launches():
    t = fake_trace()
    assert t.busy_s == pytest.approx(1300e-6)     # 100-1300, 1500-1600
    assert t.host_launches == 2
    assert [k[0] for k in t.kernels] == [
        "void attention_fwd_tf32<64>(float const*)", "conv_kernel",
        "Memcpy HtoD (Pageable -> Device)"]
    gaps = dict(t.idle_gaps)
    assert gaps == pytest.approx({"aten::conv": 100e-6, "python": 200e-6,
                                  "cudaStreamSynchronize": 400e-6})
    assert t.device_ops[0][0] == "void attention_fwd_tf32<64>(float const*)"


def test_readers_on_the_fake_trace(monkeypatch):
    t = fake_trace()
    # a unit of work of 1e12 FLOPs: mfu's own arithmetic, not the count's
    monkeypatch.setattr(roofline, "model_flops",
                        lambda geometry, frames, windows: 1e12)
    ctx = SimpleNamespace(
        trace=t, window={"units": 10, "wall_s": 2.0},
        flop_shapes={"frames": 32, "windows": 32},
        attention={"rows": 32, "bwd_rows": None, "lse": False},
        geometry={"numFilters": 32, "heatmap": 64}, compute="float32",
        peaks=PEAKS["SXM"], chips=1)
    assert idle_share.read("idle_share.serve", ctx) == pytest.approx(35.0)
    assert mfu.read("mfu.serve", ctx) == pytest.approx(
        100 * 5e12 / 165e12)
    # one (32, 4096, 64) forward in 1 ms against its 0.833 ms bound
    assert attn_roofline.read("attn_roofline.serve", ctx) == pytest.approx(
        83.31, rel=1e-3)
