"""The port's serving slice against hupr_tpu's: windowing, the normalized
chirp input, and raw ADC frames -> keypoints through make_e2e_infer, at
reduced geometry and once at the flagship width.

The Doppler-0 chirp plane is mathematically zero after clutter removal and
sits among the chirps the model reads. Each FFT library leaves its own
rounding residue there (~1e-10 of the cube's peak), and the per-plane
min-max normalization blows that residue up to O(1) values that differ
between libraries. So a raw-ADC comparison of the two pipelines as they
stand cannot hold 1e-4. These tests instead either hand the SAME cubes to
both sides (the port's own DSP, then everything after it against JAX), or
pin that plane to its exact value, zero, on both sides, as the TPU's FFT
computes it; the DSP itself is held to JAX's relative to the cube's peak in
tests/test_torch_ops.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hupr_tpu.engine.pipeline as jax_pipeline
import hupr_tpu_torch.engine.pipeline as port_pipeline
from hupr_tpu.models import HuPRNet as JaxHuPRNet
from hupr_tpu.ops import dsp as jax_dsp
from hupr_tpu.ops.heatmap import get_max_preds as jax_get_max_preds
from hupr_tpu.utils.synthetic import synthetic_variables
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.models.hupr import HuPRNet
from hupr_tpu_torch.ops import dsp
from hupr_tpu_torch.ops.attention import attention_fwd

torch.set_num_threads(2)

# maxvals are sigmoid outputs in (0, 1); 1e-4 is the network parity bar of
# tests/test_reference_parity.py, met here with float32 FFT, conv and
# attention rounding (~1e-6) between the libraries
ATOL = 1e-4
SMALL = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
             num_group_chirp=2)


def _adc(seed, f, rp):
    rng = np.random.default_rng(seed)
    return [rng.integers(-300, 300, (f, rp.num_rx, rp.num_chirp,
                                     rp.num_adc_samples)).astype(np.int16)
            for _ in range(4)]


def _nets(num_filters, heatmap, seed=0, scale=0.1):
    """Both models on the same synthetic weights, at a scale that keeps the
    heatmap peaks spread out (neither a flat 0.5 nor saturated at 1)."""
    jax_model = JaxHuPRNet(num_filters=num_filters, heatmap_size=heatmap)
    variables = jax.tree_util.tree_map(np.asarray, synthetic_variables(
        jax_model, (1, 8, 8, 2, heatmap, heatmap, 8), seed=seed,
        scale=scale))
    port = HuPRNet(num_filters=num_filters, heatmap_size=heatmap,
                   attn_impl="pallas")
    return jax_model, variables, port, state_dict_from_jax(variables)


def _jax_from_cubes(jax_model, variables, duration):
    """hupr_tpu's make_e2e_infer body after the DSP, jitted, on given cube
    halves (re, im) per view."""
    @jax.jit
    def run(hr, hi, vr, vi):
        hori = jax_pipeline.cube_chirp_input(hr, hi, 8)
        vert = jax_pipeline.cube_chirp_input(vr, vi, 8)
        ra, re = jax_model.apply(variables, hori, vert, method="chirp_maps")
        ra = jax_pipeline.window_stack_sequences(ra[:, 0], 8, duration)
        re = jax_pipeline.window_stack_sequences(re[:, 0], 8, duration)
        _, gcn = jax_model.apply(variables, ra, re, method="pose_from_maps")
        k, h = gcn.shape[2], gcn.shape[3]
        return jax_get_max_preds(gcn.reshape(-1, k, h, h))
    return run


def _port_cubes(re, im, rp):
    c = dsp.radar_cube_frames(torch.complex(torch.from_numpy(re).float(),
                                            torch.from_numpy(im).float()), rp)
    return c.real.numpy(), c.imag.numpy()


def _assert_same_keypoints(got, want):
    pred, maxv = (t.numpy() for t in got)
    np.testing.assert_allclose(maxv, np.asarray(want[1]), atol=ATOL)
    np.testing.assert_array_equal(pred, np.asarray(want[0]))
    assert maxv.std() > 1e-3 and maxv.max() < 1.0


@pytest.mark.parametrize("f", [8, 12, 3, 1])
def test_windowing_matches_jax(f):
    x = np.random.default_rng(f).standard_normal((f, 3, 2)).astype(
        np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        port_pipeline.replicate_pad(t, 8).numpy(),
        np.asarray(jax_pipeline.replicate_pad(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(
        port_pipeline.window_stack(t, 8).numpy(),
        np.asarray(jax_pipeline.window_stack(jnp.asarray(x), 8)))


@pytest.mark.parametrize("duration,seqs", [(8, 3), (4, 2), (24, 1)])
def test_window_stack_sequences_matches_jax(duration, seqs):
    f = duration * seqs if seqs > 1 else 5
    x = np.random.default_rng(duration).standard_normal((f, 2, 3)).astype(
        np.float32)
    got = port_pipeline.window_stack_sequences(torch.from_numpy(x), 8,
                                               duration)
    want = jax_pipeline.window_stack_sequences(jnp.asarray(x), 8, duration)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="whole"):
        port_pipeline.window_stack_sequences(torch.zeros(10, 2), 8, 4)


def test_cube_chirp_input_matches_jax():
    rng = np.random.default_rng(5)
    cr, ci = (rng.standard_normal((3, 16, 8, 8, 8)).astype(np.float32) * 1e4
              for _ in range(2))
    ci[1, 8] = 0.0                            # a zero (Doppler-0-like) plane
    got = port_pipeline.cube_chirp_input(torch.from_numpy(cr),
                                         torch.from_numpy(ci))
    want = jax_pipeline.cube_chirp_input(jnp.asarray(cr), jnp.asarray(ci))
    assert got.shape == (3, 1, 8, 2, 8, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@functools.lru_cache(maxsize=None)
def _small_setup():
    rp = dsp.RadarParams(**SMALL)
    return rp, _nets(num_filters=2, heatmap=32), _adc(7, 8, rp)


def test_e2e_raw_adc_matches_jax_after_the_same_dsp():
    """The port's whole pipeline on raw int16 ADC against hupr_tpu's
    pipeline body run on the port's own cubes."""
    rp, (jax_model, variables, port, state), adc = _small_setup()
    run = port_pipeline.make_e2e_infer(port, state, rp, duration=8,
                                       device="cpu")
    got = run(*adc)
    assert got[0].shape == (8, 14, 2) and got[1].shape == (8, 14, 1)
    cubes = _port_cubes(*adc[:2], rp) + _port_cubes(*adc[2:], rp)
    want = _jax_from_cubes(jax_model, variables, 8)(*cubes)
    _assert_same_keypoints(got, want)


def test_e2e_matches_jax_make_e2e_infer_with_doppler0_pinned(monkeypatch):
    """Both make_e2e_infer on the same raw frames, each with its own DSP,
    with the Doppler-0 chirp plane set to its exact value (zero) on both
    sides: every other plane differs only by float32 FFT rounding."""
    rp, (jax_model, variables, port, state), adc = _small_setup()
    jp = jax_dsp.RadarParams(**SMALL)
    d0 = rp.num_kept_chirps // 2             # Doppler bin 0 after the crop
    jax_cube, port_cube = (jax_pipeline.radar_cube_single_frame,
                           port_pipeline.radar_cube_frames)

    def port_pinned(frames, params):
        c = port_cube(frames, params)
        c[:, d0] = 0
        return c

    monkeypatch.setattr(jax_pipeline, "radar_cube_single_frame",
                        lambda fr, p: jax_cube(fr, p).at[d0].set(0))
    monkeypatch.setattr(port_pipeline, "radar_cube_frames", port_pinned)
    want = jax_pipeline.make_e2e_infer(jax_model, variables, jp,
                                       duration=8)(*adc)
    got = port_pipeline.make_e2e_infer(port, state, rp, duration=8,
                                       device="cpu")(*adc)
    _assert_same_keypoints(got, want)


def test_e2e_int16_ingest_equals_float():
    rp, (_, _, port, state), adc = _small_setup()
    run = port_pipeline.make_e2e_infer(port, state, rp, duration=4,
                                       device="cpu")
    a = run(*adc)
    b = run(*(x.astype(np.float32) for x in adc))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_e2e_pins_float32_math_for_the_call(monkeypatch):
    """make_e2e_infer owns the float32 compute dtype: its run turns TF32 off
    in cuDNN and cuBLAS (cuDNN's is on by default) and restores the
    caller's flags afterwards."""
    rp, (_, _, port, state), adc = _small_setup()
    run = port_pipeline.make_e2e_infer(port, state, rp, duration=8,
                                       device="cpu")
    seen, chirp_maps = [], port.chirp_maps

    def spy(*args):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return chirp_maps(*args)

    monkeypatch.setattr(port, "chirp_maps", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    run(*adc)
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_e2e_full_width_matches_jax():
    """Flagship width: 64x64 maps, numFilters 32, 8-frame windows, the IWR1843
    capture geometry; one raw frame, which replicate padding turns into one
    full window. The port runs MODEL.attention pallas (its kernel wrapper;
    on the CPU the plain version), hupr_tpu the einsum."""
    rp = dsp.RadarParams()
    jax_model, variables, port, state = _nets(num_filters=32, heatmap=64,
                                              seed=1, scale=0.03)
    adc = _adc(11, 1, rp)
    before = attention_fwd.launches
    got = port_pipeline.make_e2e_infer(port, state, rp, duration=1,
                                       device="cpu")(*adc)
    assert attention_fwd.launches == before   # CPU: plain version, no kernel
    assert got[0].shape == (1, 14, 2) and got[1].shape == (1, 14, 1)
    cubes = _port_cubes(*adc[:2], rp) + _port_cubes(*adc[2:], rp)
    want = _jax_from_cubes(jax_model, variables, 1)(*cubes)
    _assert_same_keypoints(got, want)
