"""The port's data layer against hupr_tpu's on the same files: the window
table, the GT JSON, samples and shuffled batches from the same seed, the
native and NumPy frame loaders, the bfloat16 wire format, and the
host-to-device staging of the Runner's loops (utils/prefetch.py) on the
CPU. Every comparison is exact unless it says otherwise."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from hupr_tpu.data import dataset as jax_dataset
from hupr_tpu.data.annot import generate_gt_annotations as jax_gt
from hupr_tpu_torch import config as port_config
from hupr_tpu_torch.data import dataset
from hupr_tpu_torch.data.annot import generate_gt_annotations
from hupr_tpu_torch.utils import prefetch, transfer
from test_e2e import make_tiny_dataset, tiny_cfg

torch.set_num_threads(1)

SPATIAL = 16                       # 16x16 maps: the tests' cubes stay small


def tiny_workspace(root, duration=8, spatial=SPATIAL, seqs=(1,)):
    """The tiny dataset of tests/test_e2e.py at `spatial` x `spatial` maps
    under root/data; returns (JAX config, port config) of the same dict."""
    data_dir = str(root / "data")
    make_tiny_dataset(data_dir, list(seqs), duration=duration, r=spatial,
                      a=spatial, img_size=4 * spatial)
    jcfg = tiny_cfg(data_dir, duration=duration, spatial=spatial)
    jcfg.DATASET.trainName = jcfg.DATASET.valName = \
        jcfg.DATASET.testName = list(seqs)
    return jcfg, port_cfg_of(jcfg)


def port_cfg_of(jcfg):
    """The port's config with every field of the JAX package's."""
    import dataclasses
    return port_config.config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("n,duration,group", [
    (20, 10, 8), (600, 600, 8), (24, 6, 4), (9, 9, 5)])
def test_window_indices_equal_jax(n, duration, group):
    np.testing.assert_array_equal(
        dataset.window_indices(n, duration, group),
        jax_dataset.window_indices(n, duration, group))


def test_gt_json_is_byte_identical(tmp_path):
    jcfg, pcfg = tiny_workspace(tmp_path, seqs=(1, 2))
    for phase in ("train", "val", "test"):
        with open(jax_gt(jcfg, phase), "rb") as f:
            want = f.read()
        with open(generate_gt_annotations(pcfg, phase), "rb") as f:
            got = f.read()
        assert got == want
    with pytest.raises(ValueError):
        pcfg.DATASET.split_names("eval")


def test_raw_sample_equals_jax(tmp_path):
    jcfg, pcfg = tiny_workspace(tmp_path, duration=6, seqs=(1, 2))
    want = jax_dataset.get_dataset("val", jcfg)
    got = dataset.get_dataset("val", pcfg)
    assert len(got) == len(want) == 12
    np.testing.assert_array_equal(got.windows, want.windows)
    for i in (0, 3, 5, 6, 11):
        a, b = got.raw_sample(i), want.raw_sample(i)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("sampling_ratio", [1, 2])
def test_shuffled_batches_equal_jax_over_epochs(tmp_path, sampling_ratio):
    """The seed- and epoch-keyed permutation and the per-row sampling
    stream are the JAX package's: every batch of two epochs is equal."""
    jcfg, pcfg = tiny_workspace(tmp_path, duration=8, seqs=(1, 2))
    want = jax_dataset.BatchLoader(
        jax_dataset.get_dataset("train", jcfg, sampling_ratio), 3,
        shuffle=True, seed=7, workers=2)
    got = dataset.BatchLoader(
        dataset.get_dataset("train", pcfg, sampling_ratio), 3,
        shuffle=True, seed=7, workers=2)
    assert len(got) == len(want)
    for _ in range(2):
        pairs = list(zip(got, want))
        assert len(pairs) == len(want)
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_native_loader_equals_numpy(tmp_path):
    """The shared native/npy_loader.cc, built for the port, reads the same
    values as the NumPy path, and builds outside native/build/."""
    from hupr_tpu_torch.data import native_loader

    _, pcfg = tiny_workspace(tmp_path)
    if not native_loader.native_available():
        pytest.skip("no C++ toolchain to build native/npy_loader.cc")
    assert os.path.dirname(native_loader._LIB_PATH).endswith(
        os.path.join("build", "hupr_tpu_torch"))
    native = dataset.get_dataset("test", pcfg, use_native=True)
    plain = dataset.get_dataset("test", pcfg, use_native=False)
    a = list(dataset.BatchLoader(native, 3, workers=2))
    b = list(dataset.BatchLoader(plain, 3, workers=1))
    assert native.use_native and not plain.use_native
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_bfloat16_wire_equals_jax(tmp_path):
    """SETUP.transferDtype bfloat16: the port's torch bfloat16 planes hold
    the values of the JAX package's ml_dtypes bfloat16 planes."""
    from hupr_tpu.utils.transfer import transfer_dtype as jax_wire

    jcfg, pcfg = tiny_workspace(tmp_path)
    want = next(iter(jax_dataset.BatchLoader(
        jax_dataset.get_dataset("val", jcfg), 4,
        transfer_dtype=jax_wire("bfloat16"))))
    got = next(iter(dataset.BatchLoader(
        dataset.get_dataset("val", pcfg), 4,
        transfer_dtype=transfer.transfer_dtype("bfloat16"))))
    for k in ("hori", "vert"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      want[k].astype(np.float32))
    assert transfer.transfer_dtype("float32") == torch.float32
    with pytest.raises(ValueError, match="transferDtype"):
        transfer.transfer_dtype("int8")


def test_frame_cache_byte_bound():
    c = dataset.FrameCache(max_items=100, max_bytes=4096)
    a = np.zeros(256, np.float32)  # 1 KiB
    for i in range(10):
        c.put(i, (a, a))           # 2 KiB per entry -> at most 2 fit
    assert not c.has(0) and c.has(9)
    assert c._bytes <= 4096 and len(c._d) == 2
    c.put(9, (a, a))               # re-put must not double-count
    assert c._bytes == 4096


def test_batch_loader_abandoned_iterator_releases_producer(tmp_path):
    _, pcfg = tiny_workspace(tmp_path)
    ds = dataset.get_dataset("val", pcfg)
    before = threading.active_count()
    it = iter(dataset.BatchLoader(ds, 2, prefetch=1))
    next(it)
    it.close()
    deadline = time.monotonic() + 10.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch thread leaked"


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_device_prefetch_pads_the_last_batch_as_shard_batch(wire):
    """A short batch is padded to pad_to by repeating its last sample and
    carries a 0/1 mask (hupr_tpu/parallel/mesh.py:shard_batch); a full one
    carries no mask. The host batch and its true size come along. Planes
    in the bfloat16 wire format arrive as torch tensors and stay so. A
    process-sliced batch (trueRows) is not padded and carries the mask of
    its rows."""
    from hupr_tpu.parallel.mesh import _pad_batch_axis

    rng = np.random.default_rng(0)
    dtype = transfer.transfer_dtype(wire)
    batches = [{"hori": transfer.cast_for_transfer(
                    rng.standard_normal((n, 2, 3)).astype(np.float32), dtype),
                "vert": transfer.cast_for_transfer(
                    rng.standard_normal((n, 2, 3)).astype(np.float32), dtype),
                "jointsGroup": rng.uniform(0, 9, (n, 14, 2))}
               for n in (4, 4, 3)]
    out = list(prefetch.device_prefetch(iter(batches), "cpu", pad_to=4))
    assert [t for _, _, t in out] == [4, 4, 3]
    for (dev, host, _), src in zip(out, batches):
        assert host is src
        assert dev["hori"].dtype == dtype
        for k in ("hori", "vert", "jointsGroup"):
            want = torch.as_tensor(src[k]).float().numpy()
            np.testing.assert_array_equal(dev[k].float().numpy(),
                                          _pad_batch_axis(want, 4))
    assert "mask" not in out[0][0]
    np.testing.assert_array_equal(out[2][0]["mask"].numpy(), [1, 1, 1, 0])
    # a process-sliced batch (multi-process) holds its rows of the padded
    # global batch: no padding, its rows' mask (one process: rows 0-3)
    ((dev, _, t),) = prefetch.device_prefetch(
        iter([dict(batches[2], trueRows=2)]), "cpu", pad_to=4)
    assert t == 2 and dev["hori"].shape[0] == 3
    np.testing.assert_array_equal(dev["mask"].numpy(), [1, 1, 0])


def test_pending_fetch_reads_copies():
    t = torch.arange(6.0).reshape(2, 3)
    f = prefetch.PendingFetch({"x": t, "s": t.sum()})
    t.add_(1)                      # later work does not reach the copies
    got = f.get()
    np.testing.assert_array_equal(got["x"], np.arange(6.0).reshape(2, 3))
    assert float(got["s"]) == 15.0


def test_get_paths_and_annots(tmp_path):
    for d in ("a", "b"):
        os.makedirs(tmp_path / "root" / d / "m")
        (tmp_path / "root" / d / "m" / "x.json").write_text(f'["{d}"]')
    root = str(tmp_path / "root")
    paths = dataset.get_paths([root], [["a", "b"]], "m", ["f0", "f1"])
    assert paths == jax_dataset.get_paths([root], [["a", "b"]], "m",
                                          ["f0", "f1"])
    assert dataset.get_annots([root], [["a", "b"]], "m", "x.json") == \
        ["a", "b"]
