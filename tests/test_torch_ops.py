"""The port's ops against their hupr_tpu twins on the same numpy inputs:
radar DSP, per-plane normalize, align-corners resize, argmax decode and the
MSCSA attention (the plain version against the Pallas kernel run in
interpret mode, and the kernel wrapper's CPU and argument handling)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hupr_tpu.ops import attention as jax_attention
from hupr_tpu.ops import dsp as jax_dsp
from hupr_tpu.ops.heatmap import get_max_preds as jax_get_max_preds
from hupr_tpu.ops.normalize import normalize_radar_window as jax_normalize
from hupr_tpu.ops.resize import scale_by_factor as jax_scale
from hupr_tpu_torch.ops import attention, dsp
from hupr_tpu_torch.ops.heatmap import get_max_preds
from hupr_tpu_torch.ops.normalize import normalize_radar_window
from hupr_tpu_torch.ops.resize import scale_by_factor

torch.set_num_threads(1)

# reduced capture geometry of tests/test_pipeline.py: 32 angle bins, 8 kept
# chirps
SMALL = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
             num_group_chirp=2)


def _adc(rng, shape):
    """int16-valued I/Q, as the DCA1000 delivers them."""
    return (rng.integers(-300, 300, shape)
            + 1j * rng.integers(-300, 300, shape)).astype(np.complex64)


@pytest.mark.parametrize("geometry", [{}, SMALL], ids=["full", "reduced"])
def test_radar_cube_matches_jax(geometry):
    """Relative to the cube's largest magnitude (~1e5): float32 FFTs in
    two libraries round differently, ~1e-7 of the peak; 1e-5 is the bar."""
    jp, tp = jax_dsp.RadarParams(**geometry), dsp.RadarParams(**geometry)
    rng = np.random.default_rng(0)
    frames = _adc(rng, (2, tp.num_rx, tp.num_chirp, tp.num_adc_samples))
    want = np.asarray(jax_dsp.radar_cube_frames(jnp.asarray(frames), jp))
    got = dsp.radar_cube_frames(torch.from_numpy(frames), tp).numpy()
    assert got.shape == want.shape == (
        2, tp.num_kept_chirps, tp.num_angle_bins, tp.num_angle_bins,
        tp.num_ele_bins)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_radar_params_match_jax():
    for geometry in ({}, SMALL):
        jp, tp = jax_dsp.RadarParams(**geometry), dsp.RadarParams(**geometry)
        assert (dataclasses.astuple(jp), jp.num_angle_bins,
                jp.num_kept_chirps) == (dataclasses.astuple(tp),
                                        tp.num_angle_bins, tp.num_kept_chirps)


def test_normalize_matches_jax_and_zero_plane():
    """1e-5: min-max then standardize on O(1) values, float32 reductions in
    another order."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 2, 16, 16, 4)).astype(np.float32) * 50
    x[0, 1, 0, :, :, 2] = 0.0                      # a degenerate plane
    want = np.asarray(jax_normalize(jnp.asarray(x)))
    got = normalize_radar_window(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[0, 1, 0, :, :, 2] == 0.0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("factor,spatial", [
    (2.0, (8, 8)), (0.5, (16, 16)), (0.5, (8, 16, 16)), (2.0, (3, 5, 7)),
])
def test_resize_matches_jax(factor, spatial):
    """1e-5: separable interpolation matrices (JAX) against torch's
    direct align-corners interpolation, float32."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3) + spatial).astype(np.float32)
    nd = len(spatial)
    got = scale_by_factor(torch.from_numpy(x), factor).numpy()
    x_last = np.moveaxis(x, 1, -1)                 # channels-last for JAX
    want = np.asarray(jax_scale(jnp.asarray(x_last), factor,
                                axes=tuple(range(1, nd + 1))))
    np.testing.assert_allclose(got, np.moveaxis(want, -1, 1), atol=1e-5)


def test_get_max_preds_matches_jax():
    rng = np.random.default_rng(3)
    hm = rng.standard_normal((3, 14, 16, 16)).astype(np.float32)
    hm[0, 0] = -1.0                                # peak <= 0: zeroed coords
    hm[1, 1] = 0.0
    hm[1, 1, 4, 5] = hm[1, 1, 9, 2] = 2.0          # tie: the first one wins
    want_p, want_v = jax_get_max_preds(jnp.asarray(hm))
    got_p, got_v = get_max_preds(torch.from_numpy(hm))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_p[1, 1].tolist() == [5.0, 4.0]


def _qkv(b, n, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, c)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("b,n,c,q_block", [
    (2, 256, 64, 256),     # one q-block
    (1, 1024, 32, 256),    # four q-blocks
])
def test_attention_plain_matches_pallas_interpret(b, n, c, q_block):
    """atol 1e-4, the bar of tests/test_attention.py for the Pallas kernel
    against the einsum."""
    k, q, m = _qkv(b, n, c, seed=n)
    want = jax_attention.fused_spatial_attention(
        jnp.asarray(k), jnp.asarray(q), jnp.asarray(m), q_block, True)
    got = attention.attention_plain(*map(torch.from_numpy, (k, q, m)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_attention_fwd_on_cpu_is_the_plain_version_uncounted():
    k, q, m = map(torch.from_numpy, _qkv(2, 64, 16, seed=4))
    before = attention.attention_fwd.launches
    got = attention.attention_fwd(k, q, m)
    assert torch.equal(got, attention.attention_plain(k, q, m))
    assert attention.attention_fwd.launches == before


@pytest.mark.parametrize("case,exc", [
    ("bf16", TypeError), ("shape", ValueError), ("noncontig", ValueError),
    ("channels", ValueError), ("grad", RuntimeError), ("meta", ValueError),
])
def test_attention_fwd_rejects_what_the_kernel_does_not_take(case, exc):
    """Non-CPU tensors never fall back to the plain version: the wrapper
    checks them (here on the meta device, which has no kernel) and raises
    before any launch."""
    def mk(shape=(2, 256, 64), dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    k, q, m = mk(), mk(), mk()
    if case == "bf16":
        k = mk(dtype=torch.bfloat16)
    elif case == "shape":
        q = mk((2, 128, 64))
    elif case == "noncontig":
        m = mk((2, 64, 256)).transpose(1, 2)
    elif case == "channels":
        k, q, m = mk((2, 256, 48)), mk((2, 256, 48)), mk((2, 256, 48))
    elif case == "grad":
        q.requires_grad_(True)
    before = attention.attention_fwd.launches
    with pytest.raises(exc):
        attention.attention_fwd(k, q, m)
    assert attention.attention_fwd.launches == before


def test_attention_flops_match_jax():
    assert attention.attention_flops(3, 256, 64) == \
        jax_attention.attention_flops(3, 256, 64)
    for bwd in (False, True):
        assert attention.mscsa_attention_flops(32, include_backward=bwd) == \
            jax_attention.mscsa_attention_flops(32, include_backward=bwd)
    # 4 * B * N^2 * C per forward call
    assert attention.attention_flops(1, 4096, 64) == 4 * 4096 ** 2 * 64
