"""The port's chunk-mode and raw-ADC training and raw-ADC sequence eval
against hupr_tpu's, on the CPU at the reduced capture geometry of
tests/test_adc_train.py (cubes of 8 chirps, 32x32 maps, numFilters 2, one
8-frame sequence): the ADC frame source, the chunk table and one epoch of
loader batches equal to JAX's; the chunk step against the port's classic
step and against JAX's chunk step; raw ADC against cubes, in training and
in eval. The Runner's chunk and ADC paths: tests/test_torch_chunk_runner.py.

The .npy cubes here are made from the raw captures by the port's own DSP,
so the raw-ADC paths and the cube paths see the same cubes. Where the
port's raw-ADC path meets JAX's, the Doppler-0 chirp plane is pinned to
zero on both sides (tests/test_torch_pipeline.py says why)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from hupr_tpu.data import get_dataset as jax_get_dataset
from hupr_tpu.data.adc import ADCFrameSource as JaxADCFrameSource
from hupr_tpu.engine import chunk_train as jax_chunk
from hupr_tpu.engine import steps as jax_steps
from hupr_tpu.models import build_model as jax_build_model
from hupr_tpu.models.torch_convert import convert_state_dict
from hupr_tpu.ops import dsp as jax_dsp
from hupr_tpu.utils.transfer import transfer_dtype as jax_transfer_dtype
from hupr_tpu_torch.data import get_dataset
from hupr_tpu_torch.data.adc import ADCFrameSource
from hupr_tpu_torch.engine import chunk_train
from hupr_tpu_torch.engine import steps
from hupr_tpu_torch.engine.seq_eval import SequenceEvaluator
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.ops import dsp
from hupr_tpu_torch.utils.transfer import transfer_dtype
from test_e2e import tiny_cfg
from test_torch_data import port_cfg_of

torch.set_num_threads(1)

TINY_ADC = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                num_group_chirp=2, range_gate_start=94)
RP = dsp.RadarParams(**TINY_ADC)
D0 = RP.num_kept_chirps // 2          # Doppler bin 0 after the crop
# the train slice's bars (tests/test_torch_train.py)
LOSS_RTOL = 2e-4
PARAM_ATOL, PARAM_RTOL = 7e-4, 1e-3


def adc_workspace(root, duration=8, seed=0):
    """One sequence of raw int16 captures under root/raw, the .npy cubes
    the port's DSP makes from them under root/data, and annotations with
    1500x1500 GT boxes (so that OKS grades a random model's AP above 0).
    Returns (JAX config, port config) with adcDir and adcParams set."""
    data_dir, adc_dir = str(root / "data"), str(root / "raw")
    rng = np.random.default_rng(seed)
    s = 2 * RP.num_rx * RP.num_chirp * RP.num_adc_samples
    for view in ("hori", "vert"):
        os.makedirs(os.path.join(adc_dir, "single_1", view))
        os.makedirs(os.path.join(data_dir, "single_1", view))
        stream = rng.integers(-300, 300, (duration, s)).astype(np.int16)
        stream.tofile(os.path.join(adc_dir, "single_1", view,
                                   "adc_data.bin"))
        cubes = dsp.radar_cube_frames(dsp.decode_dca1000(
            torch.from_numpy(stream), RP), RP).numpy()
        for f in range(duration):
            np.save(os.path.join(data_dir, f"single_1/{view}/{f:09d}.npy"),
                    cubes[f])
    blocks = [{"image": "%09d.jpg" % f,
               "joints": rng.uniform(20, 105, (14, 2)).tolist(),
               "bbox": [0.0, 0.0, 1500.0, 1500.0]} for f in range(duration)]
    for phase in ("train", "val", "test"):
        with open(os.path.join(data_dir, f"hrnet_annot_{phase}.json"),
                  "w") as fp:
            json.dump([blocks], fp)
    jcfg = tiny_cfg(data_dir, duration=duration, spatial=32)
    d = jcfg.DATASET
    d.numChirps = RP.num_kept_chirps          # the cubes keep all 8
    d.adcDir = adc_dir
    d.adcParams = dict(TINY_ADC)
    return jcfg, port_cfg_of(jcfg)


def _geometry(cfg):
    d = cfg.DATASET
    return (d.numKeypoints, d.heatmapSize, d.imgSize)


def _jax_state(jcfg):
    model = jax_build_model(jcfg)
    tx = jax_steps.make_optimizer(jcfg)
    return model, tx, jax_steps.init_state(model, jcfg, jax.random.PRNGKey(0),
                                           tx=tx)


def _port_state(cfg, jstate):
    """The port's model, optimizer and TrainState on JAX's weights."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    tx = steps.make_optimizer(cfg, model)
    return steps.TrainState(model, tx)


def _assert_states_close(model, want_params, want_stats):
    """The port's weights and BN statistics against a JAX tree's, at the
    bars of tests/test_torch_train.py."""
    got = convert_state_dict({k: v.detach().clone()
                              for k, v in model.state_dict().items()})
    for tree, want in (("params", want_params), ("batch_stats", want_stats)):
        leaves = jax.tree_util.tree_leaves_with_path(got[tree])
        ref = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(leaves) == len(ref)
        for path, leaf in leaves:
            np.testing.assert_allclose(
                np.asarray(leaf), np.asarray(ref[path]), atol=PARAM_ATOL,
                rtol=PARAM_RTOL, err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------ host side

def test_adc_source_reads_equal_jax(tmp_path):
    jcfg, cfg = adc_workspace(tmp_path)
    ds = get_dataset("train", cfg)
    src = ADCFrameSource(cfg.DATASET.adcDir, RP)
    ref = JaxADCFrameSource(jcfg.DATASET.adcDir, jax_dsp.RadarParams(
        **TINY_ADC))
    assert src.frame_samples == ref.frame_samples
    for lo, n in ((0, 8), (2, 3), (7, 1)):
        got = np.zeros((n, src.frame_samples), np.int16)
        want = np.ones((n, ref.frame_samples), np.int16)
        src.read_frames(ds.image_ids, lo, n, "vert", got)
        ref.read_frames(ds.image_ids, lo, n, "vert", want)
        np.testing.assert_array_equal(got, want)
    ids = ds.image_ids
    for case in (ids, ids + [100000 + 999], ids + [200000]):
        assert src.available(case) == ref.available(case)
    assert src.available(ids) and not ADCFrameSource("", RP).available(ids)
    with pytest.raises(ValueError, match="contiguous"):
        src.read_frames(ids + [100005], 7, 2, "hori",
                        np.empty((2, src.frame_samples), np.int16))


@pytest.mark.parametrize("n,duration,group,b,pad", [
    (20, 10, 8, 4, 0), (16, 8, 8, 5, 0), (12, 6, 4, 3, 4), (9, 9, 5, 9, 0)])
def test_chunk_table_equals_jax(n, duration, group, b, pad):
    from hupr_tpu_torch.data.dataset import window_indices
    windows = window_indices(n, duration, group)
    got = chunk_train.chunk_table(windows, duration, b, pad)
    want = jax_chunk.chunk_table(windows, duration, b, pad)
    assert len(got) == len(want) == (n // duration) * -(-duration // b)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_chunk_loader_epochs_equal_jax(tmp_path, wire):
    """Two shuffled epochs of chunk batches (batch 3: chunks of 3, 3 and 2
    windows) equal JAX's leaf for leaf in each wire dtype; the raw-ADC
    loader's equal JAX's too."""
    jcfg, cfg = adc_workspace(tmp_path)
    ds, jds = get_dataset("train", cfg), jax_get_dataset("train", jcfg)
    pairs = [(chunk_train.ChunkTrainLoader(ds, 3, seed=5,
                                           transfer_dtype=transfer_dtype(wire)),
              jax_chunk.ChunkTrainLoader(jds, 3, seed=5,
                                         transfer_dtype=jax_transfer_dtype(
                                             wire)))]
    if wire == "float32":
        pairs.append((chunk_train.ADCChunkLoader(
            ds, 3, ADCFrameSource(cfg.DATASET.adcDir, RP), seed=5),
            jax_chunk.ADCChunkLoader(jds, 3, JaxADCFrameSource(
                jcfg.DATASET.adcDir, jax_dsp.RadarParams(**TINY_ADC)),
                seed=5)))
    for port, ref in pairs:
        assert len(port) == len(ref) == 3
        for _ in range(2):
            got, want = list(port), list(ref)
            assert [b["trueB"] for b in got] == [b["trueB"] for b in want]
            assert sorted(b["trueB"] for b in got) == [2, 3, 3]
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    gv = g[k].float().numpy() if isinstance(
                        g[k], torch.Tensor) else np.asarray(g[k])
                    np.testing.assert_array_equal(
                        gv, np.asarray(w[k]).astype(gv.dtype), err_msg=k)
                if isinstance(port, chunk_train.ADCChunkLoader):
                    assert g["hori"].dtype == np.int16
                elif wire == "bfloat16":
                    assert g["hori"].dtype == torch.bfloat16


def test_one_card_only(tmp_path):
    """What one card only once allowed and now runs (data parallel,
    tests/test_torch_parallel.py): the padded axes (pad_multiple 8: 8
    rows, 16 frames), process blocks (rank 1 of 2: rows 2-3 and frames
    4-7 of 4 and 8), and the step and device_put_chunk with a mesh of one
    rank (the single-card step, on the mesh's device)."""
    from hupr_tpu_torch.parallel import make_mesh

    _, cfg = adc_workspace(tmp_path)
    ds = get_dataset("train", cfg)
    padded = chunk_train.ChunkTrainLoader(ds, 4, pad_multiple=8,
                                          shuffle=False)
    assert (padded.rows_pad, padded.f_pad) == (8, 16)
    block = chunk_train.ChunkTrainLoader(ds, 4, pad_multiple=2,
                                         process=(1, 2), shuffle=False)
    batch = block._assemble(block.chunks[0])
    assert batch["hori"].shape[0] == 6 and batch["rel"].shape[0] == 2
    np.testing.assert_array_equal(batch["mask"], [1.0, 1.0])
    mesh = make_mesh("cpu")
    dev, true_b = chunk_train.device_put_chunk(batch, mesh=mesh)
    assert true_b == 4 and dev["rel"].device == mesh.device
    model = build_model(cfg, device="cpu")
    tx = steps.make_optimizer(cfg, model)
    one = chunk_train.make_chunk_train_step(model, tx, _geometry(cfg),
                                            mesh=mesh)
    loader = chunk_train.ChunkTrainLoader(ds, 4, shuffle=False)
    _, m = one(steps.TrainState(model, tx),
               loader._assemble(loader.chunks[0]), 1e-4, 0.0)
    assert np.isfinite(m["loss"].item())


# ----------------------------------------------------------- train steps

def _classic_batch(ds, chunk, batch_size):
    """The classic loader's window batch of the chunk's rows, padded by
    repeating the last real row under mask 0."""
    true_b = chunk["true_b"]
    rows = [ds.raw_sample(chunk["row0"] + i) for i in range(true_b)]
    rows += [rows[-1]] * (batch_size - true_b)
    batch = {k: np.stack([r[k] for r in rows])
             for k in ("hori", "vert", "jointsGroup")}
    batch["mask"] = (np.arange(batch_size) < true_b).astype(np.float32)
    return batch


@pytest.mark.parametrize("b,true_b", [(4, 4), (5, 3)],
                         ids=["full", "padded-remainder"])
def test_chunk_step_equals_classic_step(tmp_path, b, true_b):
    """One chunk step and one classic step of the port from the same
    weights on the same windows: losses, weights and BN statistics. In the
    padded case (8 windows in chunks of 5) the last 2 rows carry mask 0."""
    jcfg, cfg = adc_workspace(tmp_path)
    ds = get_dataset("train", cfg)
    _, _, jstate = _jax_state(jcfg)
    loader = chunk_train.ChunkTrainLoader(ds, b, shuffle=False)
    chunk = next(c for c in loader.chunks if c["true_b"] == true_b)
    batch, got_b = chunk_train.device_put_chunk(loader._assemble(chunk),
                                                "cpu")
    assert got_b == true_b and batch["rel"].dtype == torch.int64
    assert batch["mask"].tolist() == [1.0] * true_b + [0.0] * (b - true_b)

    results = []
    for make, feed in ((steps.make_train_step,
                        _classic_batch(ds, chunk, b)),
                       (chunk_train.make_chunk_train_step, batch)):
        state = _port_state(cfg, jstate)
        step = make(state.model, state.optimizer, geometry=_geometry(cfg)) \
            if make is chunk_train.make_chunk_train_step else \
            make(state.model, state.optimizer, -1.0, _geometry(cfg))
        state, m = step(state, feed, 1e-4, 0.0)
        results.append((state, m))
    (classic, mc), (chunked, mk) = results
    assert chunked.step == 1 and not chunked.model.training
    for key in ("loss", "loss1", "loss2"):
        np.testing.assert_allclose(mk[key].item(), mc[key].item(),
                                   rtol=LOSS_RTOL, err_msg=key)
    want = convert_state_dict({k: v.detach().clone() for k, v in
                               classic.model.state_dict().items()})
    _assert_states_close(chunked.model, want["params"], want["batch_stats"])
    # without trueB the step reads the mask, as make_train_step does
    state = _port_state(cfg, jstate)
    step = chunk_train.make_chunk_train_step(state.model, state.optimizer,
                                             geometry=_geometry(cfg))
    no_count = {k: v for k, v in batch.items() if k != "trueB"}
    _, m = step(state, no_count, 1e-4, 0.0)
    assert m["loss"].item() == mk["loss"].item()


def test_chunk_steps_equal_jax(tmp_path):
    """Two chunk steps (a full chunk of 5, then the padded one of 3) from
    the same weights, the port's against JAX's make_chunk_train_step."""
    jcfg, cfg = adc_workspace(tmp_path)
    jmodel, jtx, jstate = _jax_state(jcfg)
    state = _port_state(cfg, jstate)
    jstep = jax_chunk.make_chunk_train_step(jmodel, jtx, _geometry(jcfg))
    step = chunk_train.make_chunk_train_step(state.model, state.optimizer,
                                             _geometry(cfg))
    port_loader = chunk_train.ChunkTrainLoader(get_dataset("train", cfg), 5,
                                               shuffle=False)
    jax_loader = jax_chunk.ChunkTrainLoader(jax_get_dataset("train", jcfg),
                                            5, shuffle=False)
    for i, (pc, jc) in enumerate(zip(port_loader.chunks, jax_loader.chunks)):
        lr = 1e-4 * 0.999 ** i
        jdev, _ = jax_chunk.device_put_chunk(jax_loader._assemble(jc))
        jstate, jm = jstep(jstate, jdev, lr, 0.0)
        state, m = step(state, port_loader._assemble(pc), lr, 0.0)
        for key in ("loss", "loss1", "loss2"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"{key} step {i}")
    assert i == 1 and state.step == 2
    _assert_states_close(state.model, jstate.params, jstate.batch_stats)


def test_adc_chunk_step_equals_cube_chunk_step(tmp_path):
    """The raw-ADC chunk step against the cube chunk step on the same
    windows from the same weights (the cubes are the same DSP's output):
    losses, weights and BN statistics."""
    jcfg, cfg = adc_workspace(tmp_path)
    ds = get_dataset("train", cfg)
    _, _, jstate = _jax_state(jcfg)
    cube_loader = chunk_train.ChunkTrainLoader(ds, 4, shuffle=False)
    adc_loader = chunk_train.ADCChunkLoader(
        ds, 4, ADCFrameSource(cfg.DATASET.adcDir, RP), shuffle=False)
    results = []
    for loader, make in (
            (cube_loader, chunk_train.make_chunk_train_step),
            (adc_loader, lambda m, tx, g: chunk_train.make_adc_chunk_train_step(
                m, tx, g, radar_params=RP, num_frames=8))):
        state = _port_state(cfg, jstate)
        step = make(state.model, state.optimizer, _geometry(cfg))
        batch = loader._assemble(loader.chunks[0])
        results.append(step(state, batch, 1e-4, 0.0))
    (cube, mc), (adc, ma) = results
    assert adc_loader._assemble(adc_loader.chunks[0])["hori"].dtype == \
        np.int16
    for key in ("loss1", "loss2"):
        np.testing.assert_allclose(ma[key].item(), mc[key].item(),
                                   rtol=LOSS_RTOL)
    want = convert_state_dict({k: v.detach().clone() for k, v in
                               cube.model.state_dict().items()})
    _assert_states_close(adc.model, want["params"], want["batch_stats"])


# -------------------------------------------------------------- eval

def test_adc_sequence_eval_equals_cube_eval(tmp_path):
    """Batch for batch (test batch 3: 3 + 3 + 2, the last masked): the same
    ids and boxes, pred2d equal, maxvals and losses within 1e-6."""
    jcfg, cfg = adc_workspace(tmp_path)
    cfg.TEST.batchSize = 3
    ds = get_dataset("test", cfg)
    _, _, jstate = _jax_state(jcfg)
    model = _port_state(cfg, jstate).model
    adc = ADCFrameSource(cfg.DATASET.adcDir, RP)
    assert SequenceEvaluator.adc_applicable(ds, cfg, adc)
    assert not SequenceEvaluator.adc_applicable(
        ds, cfg, ADCFrameSource(str(tmp_path / "nowhere"), RP))
    assert not SequenceEvaluator.adc_applicable(ds, cfg, None)
    got = {name: list(SequenceEvaluator(model, cfg, adc_source=src)
                      .eval_batches(ds))
           for name, src in (("cubes", None), ("adc", adc))}
    assert [t for *_, t in got["adc"]] == [t for *_, t in got["cubes"]] \
        == [3, 3, 2]
    for (oa, ida, bba, t), (oc, idc, bbc, _) in zip(got["adc"],
                                                    got["cubes"]):
        np.testing.assert_array_equal(ida, idc)
        np.testing.assert_array_equal(bba, bbc)
        np.testing.assert_array_equal(oa["pred2d"].numpy(),
                                      oc["pred2d"].numpy())
        for k in ("maxvals", "loss", "loss2"):
            np.testing.assert_allclose(oa[k].numpy(), oc[k].numpy(),
                                       rtol=0, atol=1e-6)
    cfg.TRAINING.lossDecay = 0.1
    assert not SequenceEvaluator.adc_applicable(ds, cfg, adc)


def test_device_prefetch_stages_chunk_batches(tmp_path):
    """A chunk batch keeps its rows (no padding: its loader pads it), its
    gather table arrives as int64, trueB and imageId pass through as they
    are, and a multi-process batch keeps its rows and gets its mask."""
    from hupr_tpu_torch.utils.prefetch import device_prefetch

    _, cfg = adc_workspace(tmp_path)
    loader = chunk_train.ChunkTrainLoader(get_dataset("train", cfg), 5,
                                          shuffle=False)
    staged = list(device_prefetch(loader, "cpu", keys=chunk_train.CHUNK_KEYS))
    assert [t for *_, t in staged] == [5, 3]
    for dev, host, true_b in staged:
        assert dev["rel"].dtype == torch.int64
        assert dev["hori"].shape[0] == loader.f_pad == 12
        assert dev["mask"].shape == (5,) and dev["trueB"] == true_b
        np.testing.assert_array_equal(dev["imageId"], host["imageId"])
        for k in chunk_train.CHUNK_KEYS:
            np.testing.assert_array_equal(dev[k].numpy(),
                                          np.asarray(host[k]))
    # a process-sliced batch (trueRows) gets its rows' mask, no padding
    ((dev, _, true_b),) = device_prefetch(
        [{"hori": np.zeros((3, 2)), "vert": np.zeros((3, 2)),
          "jointsGroup": np.zeros((3, 14, 2)), "trueRows": 2}], "cpu",
        pad_to=5)
    assert true_b == 2 and dev["mask"].tolist() == [1.0, 1.0, 0.0]
