"""The readers of the program's spans and counters on a hand-built span
table: each metric's arithmetic, and nothing read where the program has no
table (a checkout before the program had one) or not the span."""

from types import SimpleNamespace

import pytest

from gpubench.layer_metrics import (collectives_per_step,
                                    encoder3d_ms_per_frame, h2d_gb_per_s,
                                    host_ms_per_step)
from hupr_tpu_torch.utils import profiling

TABLE = {"spans": {
    "hupr.serve.h2d": {"count": 3, "host_s": 0.03, "self_host_s": 0.03},
    "hupr.stream.h2d": {"count": 60, "host_s": 0.024, "self_host_s": 0.024},
    "hupr.encoder3d": {"count": 6, "host_s": 0.01, "self_host_s": 0.01,
                       "device_s": 0.288},
    "hupr.train.step": {"count": 4, "host_s": 0.4, "self_host_s": 0.1}},
    "counters": {"hupr.h2d_bytes": 150_000_000, "hupr.collectives": 248}}

READERS = [(h2d_gb_per_s, "h2d_gb_per_s.serve", 5.0),
           (h2d_gb_per_s, "h2d_gb_per_s.stream", 6.25),
           (encoder3d_ms_per_frame, "encoder3d_ms_per_frame.serve", 3.0),
           (host_ms_per_step, "host_ms_per_step.train", 100.0),
           (host_ms_per_step, "host_ms_per_step.dp", 100.0),
           (collectives_per_step, "collectives_per_step.dp", 62.0)]


def ctx(units=4, frames=96):
    return SimpleNamespace(trace=SimpleNamespace(units=units, frames=frames))


@pytest.mark.parametrize("reader,metric,want", READERS,
                         ids=[r[1] for r in READERS])
def test_reader_on_a_hand_built_table(monkeypatch, reader, metric, want):
    monkeypatch.setattr(profiling, "table", lambda: TABLE)
    assert reader.read(metric, ctx()) == pytest.approx(want)


@pytest.mark.parametrize("reader,metric,want", READERS,
                         ids=[r[1] for r in READERS])
def test_reader_reads_nothing_without_the_table(monkeypatch, reader, metric,
                                                want):
    monkeypatch.delattr(profiling, "table")
    assert reader.read(metric, ctx()) is None


@pytest.mark.parametrize("reader,metric,want", READERS,
                         ids=[r[1] for r in READERS])
def test_reader_reads_nothing_without_the_span(monkeypatch, reader, metric,
                                               want):
    monkeypatch.setattr(profiling, "table",
                        lambda: {"spans": {}, "counters": {}})
    assert reader.read(metric, ctx()) is None


def test_encoder3d_reads_nothing_without_device_time(monkeypatch):
    """A run on the CPU: the span has no device events."""
    host_only = {"spans": {"hupr.encoder3d": {"count": 2, "host_s": 0.01,
                                              "self_host_s": 0.01}},
                 "counters": {}}
    monkeypatch.setattr(profiling, "table", lambda: host_only)
    assert encoder3d_ms_per_frame.read("encoder3d_ms_per_frame.serve",
                                       ctx()) is None
