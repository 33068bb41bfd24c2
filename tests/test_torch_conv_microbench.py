"""The port's convolution microbenchmark (hupr_tpu_torch/scripts/
conv_microbench.py) on the CPU at a tiny shape: each form of the 3x3x3
SAME convolution (the port's own kernel form in float32 too) against
jax.lax.conv_general_dilated on the same numpy input, the agreement bars,
and the script's argv and output."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hupr_tpu_torch.scripts import conv_microbench as cm

torch.set_num_threads(2)

TINY = (1, 2, 8, 4)                  # B T H C


def _jax_conv(x, w):
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    return np.array(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), "SAME",
        dimension_numbers=dn))


@pytest.mark.parametrize("form", list(cm.F32_FORMS))
def test_form_equals_jax_conv(form):
    """float32: within 1e-4 of XLA's convolution, after the NDHWC <->
    NCDHW transposes."""
    x, w = cm.inputs(*TINY)
    op, layout = cm.F32_FORMS[form]
    with cm.float32_math():
        got = cm.to_ndhwc(op(*cm.operands(x, w, layout, "cpu",
                                          torch.float32)), layout)
    np.testing.assert_allclose(got.numpy(), _jax_conv(x, w), atol=1e-4)


@pytest.mark.parametrize("form", list(cm.FORMS))
def test_bf16_form_within_bar_of_float32(form):
    """bfloat16: each form within the script's bfloat16 bar of XLA's
    float32 convolution of the bfloat16-rounded operands."""
    x, w = cm.inputs(*TINY)
    xr, wr = (np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
              for a in (x, w))
    op, layout = cm.FORMS[form]
    got = cm.to_ndhwc(op(*cm.operands(x, w, layout, "cpu",
                                      torch.bfloat16)), layout)
    cm.check_agreement(form, got, torch.from_numpy(_jax_conv(xr, wr)),
                       torch.bfloat16)


def test_inputs_are_the_jax_scripts_draws():
    x, w = cm.inputs(*TINY)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x, rng.standard_normal((1, 2, 8, 8, 4)).astype(np.float32))
    np.testing.assert_array_equal(
        w, (rng.standard_normal((3, 3, 3, 4, 4)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_agreement_check_catches_a_wrong_form(dtype):
    """A form whose taps are off by one frame fails the bar."""
    x, w = cm.inputs(*TINY)
    ref = cm.to_ndhwc(cm.native(*cm.operands(x, w, "ncdhw", "cpu", dtype)),
                      "ncdhw")
    bad = torch.roll(ref, 1, dims=1)
    with pytest.raises(AssertionError, match="diverges"):
        cm.check_agreement("shift", bad, ref, dtype)
    assert cm.check_agreement("shift", ref.clone(), ref, dtype) == 0.0


def test_script_on_cpu_prints_each_form_and_dtype(capsys):
    rows = cm.main(["1", "2", "8", "4", "1", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("conv3d 3x3x3 SAME at (B, T, H, W, C) = "
                               "(1, 2, 8, 8, 4)")
    assert [(r["form"], r["dtype"]) for r in rows] == [
        (f, "float32") for f in cm.F32_FORMS] + [
        (f, "bfloat16") for f in cm.FORMS]
    for row, line in zip(rows, lines[1:]):
        assert re.fullmatch(r"(native|shift|im2col|kernel) +(float32|bfloat16)"
                            r" +"
                            r"\d+\.\d{3} ms", line), line
        assert row["ms"] > 0
    assert all(r["max_abs_err_vs_native"] < 1e-2 for r in rows)


@pytest.mark.parametrize("argv,want", [
    ([], (32, 8, 64, 64, 8, 3)), (["1", "2"], (1, 2, 64, 64, 8, 3)),
    (["1", "2", "8", "4", "1", "1"], (1, 2, 8, 4, 1, 1))])
def test_argv_defaults_are_the_jax_scripts(argv, want):
    assert cm.dims(cm.build_arg_parser().parse_args(argv).shape) == want
