"""One request's frames split over ranks (hupr_tpu_torch.parallel.halo,
make_e2e_infer(mesh=), SequenceEvaluator(mesh=)) against hupr_tpu's
frame-axis sharding on the CPU, at the reduced geometry of
tests/test_torch_chunk.py (numFilters 2, 32x32 maps, cubes of 8 chirps):

  * window_stack_sharded over 2 and 4 gloo ranks equals JAX's
    window_stack_sequences on the whole stack exactly, at frame counts
    whose windows cross rank boundaries, blocks of 2 frames under a halo
    of 4, and sequence boundaries inside a block and at a block's edge;
  * make_e2e_infer over 2 and 4 ranks equals the port's one-process
    make_e2e_infer and JAX's make_e2e_infer (the Doppler-0 plane pinned
    on both sides, as tests/test_torch_pipeline.py says why);
  * SequenceEvaluator over 2 ranks equals the port's unsharded evaluator
    and JAX's SequenceEvaluator(mesh=make_mesh()) on the 8-device CPU
    mesh, from cubes and from raw ADC, and falls through to the unsharded
    programs at a batch size the world does not divide;
  * a world of one gives the unsharded results bit for bit.

The ranks are worker processes running this file as a script, which
imports the port and no JAX (tests/test_torch_parallel.py's harness);
this process computes the references and compares.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from hupr_tpu_torch.data import get_dataset
from hupr_tpu_torch.data.adc import ADCFrameSource
from hupr_tpu_torch.engine import chunk_train
from hupr_tpu_torch.engine import pipeline as port_pipeline
from hupr_tpu_torch.engine.seq_eval import SequenceEvaluator
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.ops import dsp
from hupr_tpu_torch.parallel import Mesh, make_mesh
from hupr_tpu_torch.parallel.halo import (frame_block, halo_exchange,
                                          window_stack_sharded)
from test_torch_parallel import _load, _save, join_ranks, start_ranks, \
    worker_main

torch.set_num_threads(1)

# tests/test_torch_chunk.py's reduced capture: cubes of 8 chirps, 32x32
TINY_ADC = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
                num_group_chirp=2, range_gate_start=94)
RP = dsp.RadarParams(**TINY_ADC)
D0 = RP.num_kept_chirps // 2          # Doppler bin 0 after the crop
GROUP = 8
# (frames, duration) of the window stacks each world checks: F=16 over 2
# ranks; 24 frames of 8-frame sequences (a boundary inside each block)
# and of 6-frame ones; 8 frames over 4 ranks (blocks of 2 under a halo of
# 4), whole and as two 4-frame sequences (a boundary at a block's edge)
WINDOW_CASES = {2: [(16, 16), (24, 8), (24, 6), (8, 4)],
                4: [(8, 8), (8, 4), (16, 16)]}
# (frames, duration) of the requests each world serves: JAX's sharded
# pipeline test's 16 frames, and 8 frames of two 4-frame sequences
SERVE_CASES = {2: [(16, 16), (8, 4)], 4: [(8, 4)]}
# SequenceEvaluator's runs over 2 ranks: (name, TEST.batchSize, raw ADC).
# Batch 8 shards (4 windows a rank; JAX shards it over its 8 devices);
# batch 6 shards into batches of 6 and 2, where rank 1 holds no real row
# of the second; batch 3 does not divide 2, so the gate runs unsharded
SEQ_CASES = [("cube", 8, False), ("cube_partial", 6, False),
             ("adc", 8, True), ("fall_through", 3, False)]
# the sharded programs against the port's one-process ones: the same
# float32 ops on fewer frames a call; measured on an x86 CPU: maxvals
# within 1.2e-7, losses within 8.6e-8 relative, eval heatmaps equal
PORT_MAXVAL_ATOL, PORT_LOSS_RTOL = 1e-5, 1e-5
# against JAX: tests/test_torch_pipeline.py's bar for serving, and
# tests/test_seq_eval.py's sharded-eval bars (losses 1e-4 relative, 95 %
# of keypoints) with tests/test_torch_runner.py's 1e-4 on maxvals;
# measured: maxvals within 1.8e-7, losses within 8.1e-5 relative (the
# masked last batch of two real rows), every keypoint equal
JAX_MAXVAL_ATOL, JAX_LOSS_RTOL, JAX_AGREE = 1e-4, 1e-4, 0.95
OUT_KEYS = ("loss", "loss1", "loss2", "pred2d", "gt2d", "maxvals",
            "predHeatmap")


def _frames(seed, f, feature=(3, 2)):
    return np.random.default_rng(seed).standard_normal(
        (f,) + feature).astype(np.float32)


def _adc(seed, f):
    rng = np.random.default_rng(seed)
    return [rng.integers(-300, 300, (f, RP.num_rx, RP.num_chirp,
                                     RP.num_adc_samples)).astype(np.int16)
            for _ in range(4)]


def _pin_doppler0(module, name):
    """Replace module.name (the port's radar_cube_frames) by a twin that
    sets the Doppler-0 chirp plane to its exact value, zero."""
    cube = getattr(module, name)

    def pinned(frames, params):
        c = cube(frames, params)
        c[:, D0] = 0
        return c

    setattr(module, name, pinned)
    return cube


def _collect(batches):
    return [({k: o[k].numpy() for k in OUT_KEYS}, np.asarray(ids),
             np.asarray(bb), t) for o, ids, bb, t in batches]


def _port_model(inputs):
    model = build_model(inputs["cfg"], device="cpu")
    model.load_state_dict(inputs["state"])
    return model


def _evaluate(model, cfg, batch_size, adc, mesh=None):
    """SequenceEvaluator's batches over cfg's test split at `batch_size`,
    from raw ADC (the Doppler-0 plane pinned) or from the cubes."""
    cfg.TEST.batchSize = batch_size
    source = None
    if adc:
        source = ADCFrameSource(cfg.DATASET.adcDir, RP)
        cube = _pin_doppler0(chunk_train, "radar_cube_frames")
    try:
        ev = SequenceEvaluator(model, cfg, adc_source=source, mesh=mesh)
        return ev, _collect(ev.eval_batches(get_dataset("test", cfg)))
    finally:
        if adc:
            chunk_train.radar_cube_frames = cube


def _serve(model, adc, duration, mesh=None):
    cube = _pin_doppler0(port_pipeline, "radar_cube_frames")
    try:
        run = port_pipeline.make_e2e_infer(model, None, RP, duration, GROUP,
                                           device="cpu", mesh=mesh)
        return [t.numpy() for t in run(*adc)]
    finally:
        port_pipeline.radar_cube_frames = cube


# ------------------------------------------------------------- workers

def job_shard(tmp: Path, rank: int, world: int) -> None:
    """This rank's window stacks and halo, served requests and (world 2)
    sequence-eval batches."""
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    mesh = make_mesh(device="cpu")
    out = {"windows": {}, "serve": {}, "seq": {}}
    for f, duration in WINDOW_CASES[world]:
        lo, hi = frame_block(f, mesh)
        local = torch.from_numpy(_frames(f, f)[lo:hi])
        out["windows"][f, duration] = window_stack_sharded(
            local, mesh, GROUP, duration, f).numpy()
    lo, hi = frame_block(8, mesh)
    out["halo"] = halo_exchange(torch.from_numpy(_frames(8, 8)[lo:hi]),
                                mesh, 4, 3).numpy()
    model = _port_model(inputs)
    for f, duration in SERVE_CASES[world]:
        out["serve"][f, duration] = _serve(model, inputs["adc"][f],
                                           duration, mesh)
    if world == 2:
        for name, batch, adc in SEQ_CASES:
            ev, got = _evaluate(model, inputs["cfg"], batch, adc, mesh)
            out["seq"][name] = (ev.mesh is not None, got)
    _save(tmp, f"w{world}", rank, out)


JOBS = {"w2": job_shard, "w4": job_shard}


# ---------------------------------------------------- parent references

@functools.lru_cache(maxsize=None)
def _jax_mesh():
    from hupr_tpu.parallel import make_mesh as jax_make_mesh
    return jax_make_mesh()


def _jax_serve(jmodel, variables, adc, duration):
    """JAX's make_e2e_infer on `adc`, the Doppler-0 plane pinned."""
    import hupr_tpu.engine.pipeline as jax_pipeline
    from hupr_tpu.ops import dsp as jax_dsp

    cube = jax_pipeline.radar_cube_single_frame
    jax_pipeline.radar_cube_single_frame = \
        lambda fr, p: cube(fr, p).at[D0].set(0)
    try:
        run = jax_pipeline.make_e2e_infer(
            jmodel, variables, jax_dsp.RadarParams(**TINY_ADC),
            duration=duration, group=GROUP)
        return [np.asarray(t) for t in run(*adc)]
    finally:
        jax_pipeline.radar_cube_single_frame = cube


def _jax_evaluate(jmodel, jcfg, variables, batch_size, adc):
    """JAX's SequenceEvaluator(mesh=make_mesh()) over the test split, from
    raw ADC with the Doppler-0 plane pinned, or from the cubes."""
    from hupr_tpu.data import get_dataset as jax_get_dataset
    from hupr_tpu.data.adc import ADCFrameSource as JaxADCFrameSource
    from hupr_tpu.engine.seq_eval import SequenceEvaluator as JaxEvaluator
    from hupr_tpu.ops import dsp as jax_dsp

    jcfg.TEST.batchSize = batch_size
    source = None
    cube = jax_dsp.radar_cube_single_frame
    if adc:
        source = JaxADCFrameSource(jcfg.DATASET.adcDir,
                                   jax_dsp.RadarParams(**TINY_ADC))
        jax_dsp.radar_cube_single_frame = \
            lambda fr, p: cube(fr, p).at[D0].set(0)
    try:
        ev = JaxEvaluator(jmodel, jcfg, mesh=_jax_mesh(), adc_source=source)
        return [({k: np.asarray(o[k]) for k in OUT_KEYS}, np.asarray(ids),
                 np.asarray(bb), t) for o, ids, bb, t in
                ev.eval_batches(jax_get_dataset("test", jcfg), variables)]
    finally:
        jax_dsp.radar_cube_single_frame = cube


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (worlds 2 and 4) beside the references: JAX's
    window stacks, served requests and sequence eval, and the port's
    one-process ones."""
    import jax

    import hupr_tpu.engine.pipeline as jax_pipeline
    from hupr_tpu.models import build_model as jax_build_model
    from hupr_tpu.utils.synthetic import synthetic_variables
    from hupr_tpu_torch.models.convert import state_dict_from_jax
    from test_torch_chunk import adc_workspace

    tmp = tmp_path_factory.mktemp("shard")
    jcfg, cfg = adc_workspace(tmp)
    jmodel = jax_build_model(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, synthetic_variables(
        jmodel, (1, GROUP, 8, 2, 32, 32, 8), seed=0, scale=0.1))
    inputs = {"cfg": cfg, "state": state_dict_from_jax(variables),
              "adc": {f: _adc(f, f) for f in (8, 16)}}
    torch.save(inputs, tmp / "inputs.pt")
    ranks = {w: start_ranks(__file__, f"w{w}", tmp, world=w)
             for w in (2, 4)}

    ref = {"windows": {}, "jax_serve": {}, "serve": {}, "jax_seq": {},
           "seq": {}}
    for f, duration in {c for cs in WINDOW_CASES.values() for c in cs}:
        ref["windows"][f, duration] = np.asarray(
            jax_pipeline.window_stack_sequences(
                jax.numpy.asarray(_frames(f, f)), GROUP, duration))
    model = _port_model(inputs)
    for f, duration in {c for cs in SERVE_CASES.values() for c in cs}:
        adc = inputs["adc"][f]
        ref["jax_serve"][f, duration] = _jax_serve(jmodel, variables, adc,
                                                   duration)
        ref["serve"][f, duration] = _serve(model, adc, duration)
    for name, batch, adc in SEQ_CASES:
        ref["jax_seq"][name] = _jax_evaluate(jmodel, jcfg, variables, batch,
                                             adc)
        ref["seq"][name] = _evaluate(model, cfg, batch, adc)[1]
    for w, procs in ranks.items():
        join_ranks(procs, f"w{w}")
    return {"ranks": {w: _load(tmp, f"w{w}", w) for w in (2, 4)},
            "ref": ref, "inputs": inputs}


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("total,world", [(10, 4), (7, 2), (3, 4)])
def test_frame_block_refuses_uneven_split(total, world):
    with pytest.raises(ValueError, match="split evenly"):
        frame_block(total, Mesh(0, world, torch.device("cpu")))


def test_frame_blocks_tile_the_request():
    blocks = [frame_block(24, Mesh(r, 4, torch.device("cpu")))
              for r in range(4)]
    assert blocks == [(0, 6), (6, 12), (12, 18), (18, 24)]


@pytest.mark.parametrize("world,case", [
    (w, c) for w, cs in WINDOW_CASES.items() for c in cs],
    ids=lambda v: f"w{v}" if isinstance(v, int) else "F%d-d%d" % v)
def test_window_stack_sharded_equals_jax(runs, world, case):
    """The ranks' windows, in rank order, are JAX's window stack of the
    whole request exactly: windows across rank boundaries read the
    neighbours' frames, windows at a sequence boundary clamp."""
    got = np.concatenate([r["windows"][case] for r in runs["ranks"][world]])
    np.testing.assert_array_equal(got, runs["ref"]["windows"][case])


def test_halo_exchange_reaches_over_several_ranks(runs):
    """Blocks of 2 frames under a halo of 4 before and 3 after: each of
    the 4 ranks gets global frames clamp(lo - 4 .. hi + 2)."""
    x = _frames(8, 8)
    for rank, r in enumerate(runs["ranks"][4]):
        want = x[np.clip(np.arange(2 * rank - 4, 2 * rank + 5), 0, 7)]
        np.testing.assert_array_equal(r["halo"], want)


@pytest.mark.parametrize("world,case", [
    (w, c) for w, cs in SERVE_CASES.items() for c in cs],
    ids=lambda v: f"w{v}" if isinstance(v, int) else "F%d-d%d" % v)
def test_sharded_serving_equals_one_process(runs, world, case):
    """Every rank returns the whole request's pred2d and maxvals, equal
    to the one-process make_e2e_infer's."""
    pred, maxv = runs["ref"]["serve"][case]
    for r in runs["ranks"][world]:
        got_pred, got_maxv = r["serve"][case]
        assert got_pred.shape == pred.shape == (case[0], 14, 2)
        np.testing.assert_allclose(got_maxv, maxv, rtol=0,
                                   atol=PORT_MAXVAL_ATOL)
        np.testing.assert_array_equal(got_pred, pred)
    assert maxv.std() > 1e-3 and maxv.max() < 1.0


@pytest.mark.parametrize("world,case", [
    (w, c) for w, cs in SERVE_CASES.items() for c in cs],
    ids=lambda v: f"w{v}" if isinstance(v, int) else "F%d-d%d" % v)
def test_sharded_serving_equals_jax(runs, world, case):
    """Rank 0's result against JAX's make_e2e_infer on the same frames,
    each with its own DSP and the Doppler-0 plane pinned."""
    pred, maxv = runs["ranks"][world][0]["serve"][case]
    want_pred, want_maxv = runs["ref"]["jax_serve"][case]
    np.testing.assert_allclose(maxv, want_maxv, atol=JAX_MAXVAL_ATOL)
    np.testing.assert_array_equal(pred, want_pred)


def _assert_batches_close(got, want, maxval_atol, loss_rtol, agree):
    assert [t for *_, t in got] == [t for *_, t in want]
    for (o, ids, bb, t), (w, wids, wbb, _) in zip(got, want):
        np.testing.assert_array_equal(ids, wids)
        np.testing.assert_array_equal(bb, wbb)
        for k in ("loss", "loss1", "loss2"):
            np.testing.assert_allclose(o[k], w[k], rtol=loss_rtol, err_msg=k)
        np.testing.assert_allclose(o["maxvals"][:t], w["maxvals"][:t],
                                   rtol=0, atol=maxval_atol)
        np.testing.assert_array_equal(o["gt2d"][:t], w["gt2d"][:t])
        same = np.mean(o["pred2d"][:t] == w["pred2d"][:t])
        assert same >= agree, same
        assert o["maxvals"][:t].std() > 1e-3          # peaks not flat


@pytest.mark.parametrize("name", [c[0] for c in SEQ_CASES])
def test_sharded_seq_eval_equals_unsharded(runs, name):
    """Every rank yields the unsharded evaluator's tuples: the same
    batches, ids and boxes, global losses, the whole batch's outputs.
    At a batch size the world does not divide it runs unsharded."""
    want = runs["ref"]["seq"][name]
    for r in runs["ranks"][2]:
        sharded, got = r["seq"][name]
        assert sharded == (name != "fall_through")
        _assert_batches_close(got, want, PORT_MAXVAL_ATOL, PORT_LOSS_RTOL,
                              1.0)
        for (o, *_), (w, *_) in zip(got, want):
            np.testing.assert_allclose(o["predHeatmap"], w["predHeatmap"],
                                       rtol=0, atol=PORT_MAXVAL_ATOL)


@pytest.mark.parametrize("name", [c[0] for c in SEQ_CASES])
def test_sharded_seq_eval_equals_jax(runs, name):
    """Rank 0's batches against JAX's SequenceEvaluator(mesh=make_mesh())
    on the 8-device CPU mesh (which shards batch 8 and runs batches 6 and
    3 unsharded)."""
    _assert_batches_close(runs["ranks"][2][0]["seq"][name][1],
                          runs["ref"]["jax_seq"][name], JAX_MAXVAL_ATOL,
                          JAX_LOSS_RTOL, JAX_AGREE)


# ---------------------------------------------------- a world of one

ONE = Mesh(0, 1, torch.device("cpu"))


@pytest.mark.parametrize("f,duration", [(16, 16), (24, 8), (5, 8)])
def test_world_of_one_windows_are_unsharded(f, duration):
    x = torch.from_numpy(_frames(f, f))
    want = port_pipeline.window_stack_sequences(x, GROUP, duration)
    assert torch.equal(window_stack_sharded(x, ONE, GROUP, duration, f),
                       want)
    assert torch.equal(halo_exchange(x, ONE, 4, 3),
                       x[torch.arange(-4, f + 3).clamp(0, f - 1)])


def test_world_of_one_serving_is_unsharded(runs):
    model = _port_model(runs["inputs"])
    adc = runs["inputs"]["adc"][8]
    want = _serve(model, adc, 4)
    for got, w in zip(_serve(model, adc, 4, mesh=ONE), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("adc", [False, True], ids=["cube", "adc"])
def test_world_of_one_seq_eval_is_unsharded(runs, adc):
    model = _port_model(runs["inputs"])
    cfg = runs["inputs"]["cfg"]
    ev, got = _evaluate(model, cfg, 4, adc, mesh=ONE)
    assert ev.mesh is None
    want = _evaluate(model, cfg, 4, adc)[1]
    for (o, *_), (w, *_) in zip(got, want):
        for k in OUT_KEYS:
            np.testing.assert_array_equal(o[k], w[k], err_msg=k)


if __name__ == "__main__":
    worker_main(JOBS)
