"""The port's preprocessing CLI (hupr_tpu_torch/preprocessing/) against
hupr_tpu's, on the CPU: the host-side decode bit for bit; the preprocessor
on a 2-frame capture of tests/test_preprocess.py's kind writes the same
files, with cubes within 1e-5 of the cube's peak of JAX's and both within
1e-4 of the NumPy oracle; the CLI under HUPR_PLATFORM=cpu writes the JAX
CLI's tree; the GT heatmap bit for bit; the diagnostic panels the same
PNGs. FFT libraries differ in the last bits, so cubes are compared relative
to the cube's peak (ROADMAP C, "Doppler-0 residue")."""

import os

import numpy as np
import pytest
import torch

from hupr_tpu.preprocessing import plot_utils as jax_plot_utils
from hupr_tpu.preprocessing import process_iwr1843 as jax_pre
from hupr_tpu_torch.preprocessing import plot_utils, process_iwr1843
from oracles import oracle_radar_cube
from test_preprocess import _serialize_dca1000

torch.set_num_threads(2)

PEAK_REL = 1e-5          # port vs JAX, relative to the cube's peak
ORACLE_REL = 1e-4        # tests/test_preprocess.py's bar against the oracle
N_FRAMES = 2


def _capture(seed=1, n_frames=N_FRAMES):
    """(4, 192 * F, 256) complex int-valued ADC samples, as
    tests/test_preprocess.py draws them (the int16 stream holds them
    exactly)."""
    rng = np.random.default_rng(seed)
    shape = (4, 192 * n_frames, 256)
    return (rng.integers(-300, 300, shape)
            + 1j * rng.integers(-300, 300, shape)).astype(np.complex128)


def _write_raw(raw_base, data, seq=1):
    raw_dir = os.path.join(raw_base, "iwr1843", "HuPR", f"single_{seq}")
    for view in ("hori", "vert"):
        os.makedirs(os.path.join(raw_dir, view))
        # the vert view gets other samples: a swapped view must show
        _serialize_dca1000(data if view == "hori" else data[::-1]).tofile(
            os.path.join(raw_dir, view, "adc_data.bin"))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_same_cubes(port_root, jax_root):
    """The same files; every cube complex64 (16, 64, 64, 8) and within
    PEAK_REL of JAX's cube's peak."""
    names = _tree(jax_root)
    assert names and _tree(port_root) == names
    for name in names:
        got = np.load(os.path.join(port_root, name))
        want = np.load(os.path.join(jax_root, name))
        assert got.shape == want.shape == (16, 64, 64, 8), name
        assert got.dtype == want.dtype == np.complex64, name
        assert np.abs(got - want).max() / np.abs(want).max() < PEAK_REL, name
    return names


@pytest.mark.parametrize("frames", [1, 3])
def test_decode_equals_jax_bit_for_bit(frames):
    raw = np.random.default_rng(frames).integers(
        -32768, 32768, frames * 4 * 192 * 256 * 2).astype(np.int16)
    want = jax_pre.decode_dca1000_np(raw)
    got = process_iwr1843.decode_dca1000_np(raw)
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape == (4, 192 * frames, 256)
    np.testing.assert_array_equal(got, want)


def test_preprocessor_writes_what_jax_writes(tmp_path):
    data = _capture()
    _write_raw(str(tmp_path / "raw_data"), data)
    for pkg, out in ((process_iwr1843, "port"), (jax_pre, "jax")):
        kw = {"device": "cpu"} if pkg is process_iwr1843 else {}
        pkg.RadarPreprocessor(num_sequences=1,
                              raw_base=str(tmp_path / "raw_data"),
                              out_base=str(tmp_path / out), batch_frames=2,
                              **kw).process_radar_data_hori_vert()
    names = _assert_same_cubes(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert names == [f"HuPR/single_1/{v}/{f:09d}.npy"
                     for v in ("hori", "vert") for f in range(N_FRAMES)]
    for view, adc in (("hori", data), ("vert", data[::-1])):
        for f in range(N_FRAMES):
            want = oracle_radar_cube(adc[:, 192 * f: 192 * (f + 1)])
            for out in ("port", "jax"):
                got = np.load(tmp_path / out / "HuPR" / "single_1" / view
                              / f"{f:09d}.npy")
                assert np.abs(got - want).max() / np.abs(want).max() \
                    < ORACLE_REL, (out, view, f)


def test_preprocessor_batches_and_skips_like_jax(tmp_path):
    """batch_frames that does not divide the frame count, a partial last
    frame in the capture, and a sequence with one view only (skipped)."""
    data = _capture(seed=4, n_frames=3)
    raw_base = str(tmp_path / "raw_data")
    _write_raw(raw_base, data)
    half = os.path.join(raw_base, "iwr1843", "HuPR", "single_2", "hori")
    os.makedirs(half)
    _serialize_dca1000(data).tofile(os.path.join(half, "adc_data.bin"))
    # a partial frame at the end of sequence 1's captures: 5 more chirps
    # (4 RX x 256 samples x I/Q each)
    for view in ("hori", "vert"):
        path = os.path.join(raw_base, "iwr1843", "HuPR", "single_1", view,
                            "adc_data.bin")
        with open(path, "ab") as fp:
            fp.write(np.ones(5 * 4 * 256 * 2, np.int16).tobytes())
    for pkg, out in ((process_iwr1843, "port"), (jax_pre, "jax")):
        kw = {"device": "cpu"} if pkg is process_iwr1843 else {}
        pkg.RadarPreprocessor(num_sequences=2, raw_base=raw_base,
                              out_base=str(tmp_path / out), batch_frames=2,
                              **kw).process_radar_data_hori_vert()
    names = _assert_same_cubes(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(names) == 6 and not any("single_2" in n for n in names)


def test_cli_writes_the_jax_tree(tmp_path, monkeypatch):
    """python -m hupr_tpu_torch.preprocessing.process_iwr1843 with
    HUPR_PLATFORM=cpu, from a working directory holding the default raw
    layout, writes the tree the JAX CLI writes; HUPR_PLATFORM=tpu is
    refused."""
    _write_raw(str(tmp_path / "preprocessing" / "raw_data"), _capture(7))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HUPR_PLATFORM", "cpu")
    argv = ["--sequences", "1", "--num-sequences", "3", "--batch-frames", "1"]
    process_iwr1843.main(argv)
    os.rename("data", "data_port")
    monkeypatch.setattr("sys.argv", ["process_iwr1843.py"] + argv)
    jax_pre.main()
    names = _assert_same_cubes("data_port", "data")
    assert names[0] == "HuPR/single_1/hori/000000000.npy"
    monkeypatch.setenv("HUPR_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="HUPR_PLATFORM"):
        process_iwr1843.main(argv)


@pytest.mark.parametrize("seed", [2, 3, 5])
def test_composite_gt_heatmap_bit_equal(seed):
    rng = np.random.default_rng(seed)
    # some joints off the image too: their Gaussians are clipped or skipped
    joints = rng.integers(-40, 300, (14, 2))
    want = jax_plot_utils.composite_gt_heatmap(joints)
    got = plot_utils.composite_gt_heatmap(joints)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got32 = plot_utils.composite_gt_heatmap(joints / 4, heatmap_size=32,
                                            img_size=64, sigma=1.5)
    np.testing.assert_array_equal(got32, jax_plot_utils.composite_gt_heatmap(
        joints / 4, heatmap_size=32, img_size=64, sigma=1.5))


def test_plot_maps_and_load_data_plot_write_the_same_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    import json

    rng = np.random.default_rng(6)
    out_dir = tmp_path / "cubes"
    for view in ("hori", "vert"):
        os.makedirs(out_dir / view)
        for f in range(2):
            cube = (rng.standard_normal((4, 16, 16, 2))
                    + 1j * rng.standard_normal((4, 16, 16, 2))
                    ).astype(np.complex64)
            np.save(out_dir / view / f"{f:09d}.npy", cube)
    annot = tmp_path / "annot.json"
    annot.write_text(json.dumps(
        [{"joints": rng.uniform(0, 256, (14, 2)).tolist()} for _ in range(2)]))
    rgb = tmp_path / "rgb"
    os.makedirs(rgb)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
                    ).save(rgb / f"{0:09d}.jpg")      # frame 1 has none
    for pkg, vis in ((process_iwr1843, "port"), (jax_pre, "jax")):
        pkg.load_data_plot(str(out_dir), str(annot), str(rgb),
                           str(tmp_path / vis), num_frames=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["000000000.png", "000000001.png"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        with Image.open(tmp_path / "port" / name) as got, \
                Image.open(tmp_path / "jax" / name) as want:
            assert got.size == want.size == (1000, 1000)
    hori = np.mean(np.abs(np.load(out_dir / "hori" / f"{0:09d}.npy")),
                   axis=(0, 3))
    heat = plot_utils.composite_gt_heatmap(np.full((14, 2), 128.0))
    for mod, name in ((plot_utils, "port.png"), (jax_plot_utils, "jax.png")):
        mod.plot_maps(str(tmp_path / name), [-45, 0, 45], [0, 10], 0, hori,
                      np.zeros((8, 8, 3), np.uint8), heat)
    with Image.open(tmp_path / "port.png") as got, \
            Image.open(tmp_path / "jax.png") as want:
        assert got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
