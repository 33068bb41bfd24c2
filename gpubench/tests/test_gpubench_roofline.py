"""The yardstick's arithmetic: the attention bound and the FLOP count."""

import pytest

from gpubench import roofline

SXM = roofline.PEAKS["SXM"]
FLAGSHIP = {"numFilters": 32, "group": 8, "chirps": 8, "range": 64,
            "azimuth": 64, "elevation": 8, "keypoints": 14, "heatmap": 64}


@pytest.mark.parametrize("kind, b, n, c, mode, lse, ms", [
    # the bound column of PERF.md's kernel table
    ("fwd", 32, 4096, 64, "f32", False, 0.833),
    ("fwd", 32, 1024, 128, "f32", False, 0.104),
    ("fwd", 20, 4096, 64, "f32", True, 0.521),
    ("bwd", 20, 4096, 64, "f32", False, 1.302),
    ("fwd", 32, 4096, 64, "bf16", False, 0.208),
    ("bwd", 20, 4096, 64, "bf16", False, 0.347),
    ("fwd", 1, 4096, 64, "bf16", False, 0.0065),
])
def test_bound_reproduces_the_kernel_table(kind, b, n, c, mode, lse, ms):
    got, _ = roofline.attention_bound(kind, b, n, c, mode, SXM, lse=lse)
    assert got == pytest.approx(ms, rel=5e-3, abs=5e-5)


def test_peaks_and_shapes():
    assert roofline.card_peaks("NVIDIA H100 80GB HBM3")[0] == "SXM"
    assert roofline.card_peaks("NVIDIA H100 PCIe")[0] == "PCIe"
    assert roofline.mfu_peak("bfloat16", SXM) == 989e12
    assert roofline.mfu_peak("float32", SXM) == pytest.approx(165e12)
    assert roofline.attention_shapes(32, 64) == {256: 256, 128: 1024,
                                                  64: 4096}


def test_flop_count_repeats_exactly():
    serve = [roofline.model_flops(FLAGSHIP, 32, 32) for _ in range(2)]
    train = [roofline.model_flops(FLAGSHIP, 0, 20, train=True)
             for _ in range(2)]
    assert serve[0] == serve[1] == 4_384_914_931_712
    assert train[0] == train[1] == 8_223_872_450_560
    # the attention's share: 4 B N^2 C a call, 12 calls
    attention = sum(4 * 32 * n * n * c * 4 for c, n in
                    roofline.attention_shapes(32, 64).items())
    assert attention < serve[0]
