"""The port's streaming estimator (engine/streaming.py) and raw-ADC decode
(ops/dsp.py) against hupr_tpu's, on the CPU at the reduced capture
geometry of tests/test_streaming.py (cubes of 8 chirps, 32x32 maps,
numFilters 2): decode_dca1000 and frames_from_adc bit for bit; the
estimator frame by frame against JAX's with the Doppler-0 chirp plane
pinned to zero on both sides (tests/test_torch_pipeline.py says why);
and against the port's own make_e2e_infer with the lag and the flush
applied."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hupr_tpu.engine.streaming as jax_streaming
import hupr_tpu_torch.engine.streaming as port_streaming
from hupr_tpu.ops import dsp as jax_dsp
from hupr_tpu_torch.engine.pipeline import make_e2e_infer
from hupr_tpu_torch.ops import attention, dsp, kernels
from test_torch_pipeline import SMALL, _nets

torch.set_num_threads(2)

RP = dsp.RadarParams(**SMALL)
FRAME = (RP.num_rx, RP.num_chirp, RP.num_adc_samples)
# maxvals are sigmoid outputs; float32 FFT, conv and attention rounding
# between the two libraries reads ~1e-7 here
MAXVAL_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    return _nets(num_filters=2, heatmap=32)


def _frames(seed, f):
    rng = np.random.default_rng(seed)
    return [rng.integers(-300, 300, (f,) + FRAME).astype(np.int16)
            for _ in range(4)]


def _port(**kw):
    _, _, port, state = _setup()
    return port_streaming.StreamingPoseEstimator(port, state, RP,
                                                 device="cpu", **kw)


def _stream(est, planes):
    """Every pose of one sequence through `est`: the first `lag` outputs
    dropped, the flush appended (the consumer rule of flush's docstring)."""
    hr, hi, vr, vi = planes
    out = []
    for t in range(len(hr)):
        pred, maxv = est.process_frame((hr[t], hi[t]), (vr[t], vi[t]))
        if t >= est.latency_frames:
            out.append((pred, maxv))
    return out + est.flush()


@pytest.mark.parametrize("frames", [1, 3])
def test_decode_dca1000_and_frames_equal_jax_bit_for_bit(frames):
    s = 2 * RP.num_rx * RP.num_chirp * RP.num_adc_samples
    raw = np.random.default_rng(frames).integers(
        -32768, 32768, (frames * s,)).astype(np.int16)
    jrp = jax_dsp.RadarParams(**SMALL)
    want = np.asarray(jax_dsp.decode_dca1000(jnp.asarray(raw), jrp))
    got = dsp.decode_dca1000(torch.from_numpy(raw), RP).numpy()
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    want_f = np.asarray(jax_dsp.frames_from_adc(jnp.asarray(want), jrp))
    got_f = dsp.frames_from_adc(torch.from_numpy(got), RP)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    # per-frame stream slices decode to the same frames
    per_frame = dsp.decode_dca1000(torch.from_numpy(raw.reshape(frames, s)),
                                   RP)
    np.testing.assert_array_equal(per_frame.numpy(), want_f)
    assert RP.num_frames == jrp.num_frames == 600


def test_frames_from_adc_drops_a_partial_frame():
    adc = torch.zeros((4, 2 * RP.num_chirp + 5, RP.num_adc_samples),
                      dtype=torch.complex64)
    assert dsp.frames_from_adc(adc, RP).shape == (2,) + FRAME


def test_stream_equals_jax_frame_by_frame_doppler0_pinned(monkeypatch):
    """Each frame's pose, the first frame's and the flush's included:
    keypoints equal, maxvals within 1e-5."""
    jax_model, variables, _, _ = _setup()
    d0 = RP.num_kept_chirps // 2             # Doppler bin 0 after the crop
    jax_cube, port_cube = (jax_streaming.radar_cube_single_frame,
                           port_streaming.radar_cube_frames)

    def port_pinned(frames, params):
        c = port_cube(frames, params)
        c[:, d0] = 0
        return c

    monkeypatch.setattr(jax_streaming, "radar_cube_single_frame",
                        lambda fr, p: jax_cube(fr, p).at[d0].set(0))
    monkeypatch.setattr(port_streaming, "radar_cube_frames", port_pinned)
    ref = jax_streaming.StreamingPoseEstimator(
        jax_model, variables, params=jax_dsp.RadarParams(**SMALL))
    est = _port()
    hr, hi, vr, vi = _frames(3, 6)
    pairs = [(est.process_frame((hr[t], hi[t]), (vr[t], vi[t])),
              ref.process_frame((hr[t], hi[t]), (vr[t], vi[t])))
             for t in range(6)]
    pairs += list(zip(est.flush(), ref.flush()))
    assert len(pairs) == 6 + est.latency_frames
    for (pred, maxv), (want_pred, want_maxv) in pairs:
        np.testing.assert_array_equal(pred, want_pred)
        np.testing.assert_allclose(maxv, want_maxv, rtol=0, atol=MAXVAL_ATOL)
    assert np.std([m for (_, m), _ in pairs]) > 1e-3     # peaks not flat


@pytest.mark.parametrize("f", [8, 2], ids=["full", "shorter-than-lag"])
def test_stream_equals_e2e_infer_with_the_lag(f):
    """The poses a consumer collects (the first latency_frames dropped,
    the flush appended) are make_e2e_infer's on the same frames, one per
    frame, for a sequence shorter than the lag too (F=2 < G/2-1=3); the
    flush resets the estimator."""
    _, _, port, state = _setup()
    planes = _frames(5 + f, f)
    want_pred, want_maxv = make_e2e_infer(port, state, RP, duration=f,
                                          device="cpu")(*planes)
    est = _port()
    got = _stream(est, planes)
    assert len(got) == f
    for i, (pred, maxv) in enumerate(got):
        np.testing.assert_array_equal(pred, want_pred[i].numpy())
        np.testing.assert_allclose(maxv, want_maxv[i].numpy(), rtol=0,
                                   atol=MAXVAL_ATOL)
    assert not est._started and est._count == 0


def test_int16_ingest_equals_float_and_complex():
    """int16 (re, im) planes, the DCA1000's own format, give the same poses
    as float32 planes and as a complex frame: the cast on the card is
    exact."""
    hr, hi, vr, vi = (x[0] for x in _frames(2, 1))
    want = _port().process_frame((hr, hi), (vr, vi))
    f32 = _port().process_frame(
        (hr.astype(np.float32), hi.astype(np.float32)),
        (vr.astype(np.float32), vi.astype(np.float32)))
    cplx = _port().process_frame(hr + 1j * hi.astype(np.complex64),
                                 vr + 1j * vi.astype(np.complex64))
    for got in (f32, cplx):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_reset_and_device_results():
    """reset() starts a new sequence (the same frame gives the same pose
    again); fetch=False returns tensors that the next frame leaves alone."""
    hr, hi, vr, vi = _frames(1, 2)
    est = _port()
    p1, m1 = est.process_frame((hr[0], hi[0]), (vr[0], vi[0]))
    est.process_frame((hr[1], hi[1]), (vr[1], vi[1]))
    est.reset()
    pred, maxv = est.process_frame((hr[0], hi[0]), (vr[0], vi[0]),
                                   fetch=False)
    assert isinstance(pred, torch.Tensor) and pred.shape == (14, 2)
    kept = maxv.clone()
    est.process_frame((hr[1], hi[1]), (vr[1], vi[1]))
    assert torch.equal(maxv, kept)
    np.testing.assert_array_equal(pred.numpy(), p1)
    np.testing.assert_array_equal(maxv.numpy(), m1)
    assert est.latency_frames == 3


def test_eager_step_counts_its_launches_and_pins_float32(monkeypatch):
    """On the CPU the step runs eagerly (no graph to capture), inside the
    float32 pin; the attention wrappers count nothing on CPU tensors."""
    est = _port()
    assert est.cuda_graph is False
    seen, chirp_maps = [], est.model.chirp_maps

    def spy(*args):
        seen.append(torch.backends.cudnn.allow_tf32)
        return chirp_maps(*args)

    monkeypatch.setattr(est.model, "chirp_maps", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    kernels.reset_launch_counts()
    hr, hi, vr, vi = _frames(4, 2)
    for t in range(2):
        est.process_frame((hr[t], hi[t]), (vr[t], vi[t]))
    assert seen == [False, False] and torch.backends.cudnn.allow_tf32
    assert attention.attention_fwd.launches == 0


def test_window_is_written_in_place_across_sequences():
    """The window keeps its storage from the first frame on, through the
    flush and the next sequence's first frame (a captured graph holds its
    address), and a second sequence through the same estimator gives a
    fresh estimator's poses."""
    first, second = _frames(11, 5), _frames(12, 5)
    est = _port()
    est.process_frame((first[0][0], first[1][0]), (first[2][0], first[3][0]))
    ptrs = [w.data_ptr() for w in est._window]
    _stream(est, [x[1:] for x in first])
    got = _stream(est, second)
    assert [w.data_ptr() for w in est._window] == ptrs
    want = _stream(_port(), second)
    assert len(got) == len(want) == 5
    for (p, m), (pw, mw) in zip(got, want):
        np.testing.assert_array_equal(p, pw)
        np.testing.assert_array_equal(m, mw)
