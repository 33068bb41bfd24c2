"""The port's flagship shape pass (hupr_tpu_torch.graft_entry.flagship_shapes)
against tests/test_flagship_lowering.py's programs on the CPU.

JAX lowers every sharded program at the flagship geometry (64x64 maps,
numFilters 32, 600-frame sequences, batch 20 / 32 padded to the mesh) on
abstract inputs over its 8-device CPU mesh. The port runs the same
programs on meta tensors over torch's fake process group, as rank 0 and
rank 7 of a world of 8, through the attention ops' shape functions: every
block, pad, halo table and collective runs, no arithmetic does. Each
program's outputs (shapes and dtypes, and the train steps' model state)
must be JAX's, which jax.eval_shape gives without compiling. A 600-frame
request over 7 ranks must raise frame_block's ValueError, and the pass
leaves no process group and launches nothing."""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hupr_tpu_torch import graft_entry
from hupr_tpu_torch.ops import attention, kernels

NDEV = graft_entry.SHAPE_WORLD


def _spec(x) -> tuple:
    return tuple(x.shape), str(np.dtype(x.dtype))


@functools.lru_cache(maxsize=None)
def _port(rank: int) -> dict:
    return graft_entry.flagship_shapes(rank, NDEV)


@pytest.fixture(scope="module")
def jax_shapes():
    """{program: {output: (shape, dtype)}} of hupr_tpu's programs from
    jax.eval_shape at test_flagship_lowering.py's inputs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from hupr_tpu.config import Config, load_config
    from hupr_tpu.engine.chunk_train import (make_adc_chunk_train_step,
                                             make_chunk_train_step)
    from hupr_tpu.engine.pipeline import make_e2e_infer
    from hupr_tpu.engine.seq_eval import (make_adc_sequence_encoder,
                                          make_sequence_encoder,
                                          make_window_eval_step)
    from hupr_tpu.engine.steps import (init_state, make_eval_step,
                                       make_optimizer, make_train_step)
    from hupr_tpu.models import build_model
    from hupr_tpu.ops.dsp import RadarParams
    from hupr_tpu.parallel.mesh import make_mesh
    from hupr_tpu.utils.synthetic import synthetic_variables
    from hupr_tpu_torch.models.convert import state_dict_from_jax

    mesh = make_mesh(jax.devices()[:NDEV])
    rep = NamedSharding(mesh, PartitionSpec())
    shard = NamedSharding(mesh, PartitionSpec("data"))

    def sds(shape, dtype, sharding=shard):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=sharding)

    def abstract_state(cfg, model, tx):
        state = jax.eval_shape(lambda r: init_state(model, cfg, r, tx),
                               jax.random.PRNGKey(0))
        return jax.tree.map(lambda l: sds(l.shape, l.dtype, rep), state)

    def state_specs(state):
        zeros = jax.tree.map(lambda l: np.zeros(l.shape, np.float32),
                             {"params": state.params,
                              "batch_stats": state.batch_stats})
        return {f"state.{k}": (tuple(v.shape),
                               str(v.dtype).removeprefix("torch."))
                for k, v in state_dict_from_jax(zeros).items()}

    def step_out(fn, *args):
        state, metrics = jax.eval_shape(fn, *args)
        return {**{k: _spec(v) for k, v in metrics.items()},
                **state_specs(state)}

    cfg = Config()
    d = cfg.DATASET
    model, tx = build_model(cfg), make_optimizer(cfg)
    state = abstract_state(cfg, model, tx)
    geometry = (d.numKeypoints, d.heatmapSize, d.imgSize)
    spatial = (d.numGroupFrames, d.numFrames, 2, d.rangeSize, d.azimuthSize,
               d.elevationSize)
    lr, alpha = np.float32(1e-4), np.float32(0.0)

    def batch(rows):
        return {"hori": sds((rows,) + spatial, np.float32),
                "vert": sds((rows,) + spatial, np.float32),
                "jointsGroup": sds((rows, d.numKeypoints, 2), np.float32),
                "mask": sds((rows,), np.float32)}

    b, bt, g = cfg.TRAINING.batchSize, cfg.TEST.batchSize, d.numGroupFrames
    out = {"train": step_out(make_train_step(model, tx, geometry=geometry),
                             state, batch(b + (-b) % NDEV), lr, alpha),
           "eval": {k: _spec(v) for k, v in jax.eval_shape(
               make_eval_step(model, geometry=geometry), state, batch(bt),
               alpha).items()}}

    rp = RadarParams()
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    serve = make_e2e_infer(model, synthetic_variables(
        model, (1,) + spatial), params=rp, duration=32, mesh=mesh)
    adc = sds((32, rp.num_rx, rp.num_chirp, rp.num_adc_samples), np.float32)
    out["serve"] = dict(zip(("pred2d", "maxvals"), map(
        _spec, jax.eval_shape(serve, adc, adc, adc, adc))))

    f = d.duration
    pad_to = -(-f // bt) * bt
    samples = 2 * rp.num_rx * rp.num_chirp * rp.num_adc_samples
    plane = sds((f, d.numFrames, d.rangeSize, d.azimuthSize,
                 d.elevationSize), np.float32)
    stream = sds((f, samples), np.int16)
    encode = make_sequence_encoder(model, group=g, mesh=mesh)
    aencode = make_adc_sequence_encoder(model, group=g, mesh=mesh,
                                        radar_params=rp,
                                        num_frames=d.numFrames)
    for name, fn, views in (("seq_encode", encode, (plane,) * 4),
                            ("adc_seq_encode", aencode, (stream,) * 2)):
        out[name] = dict(zip(("ra_pad", "re_pad"), map(
            _spec, jax.eval_shape(lambda v, *p, fn=fn: fn(v, *p, pad_to),
                                  variables, *views))))
    maps = sds((pad_to + g - 1, d.rangeSize, d.azimuthSize,
                cfg.MODEL.numFilters), np.float32, rep)
    wstep = make_window_eval_step(model, group=g, geometry=geometry,
                                  batch_size=bt, mesh=mesh)
    out["seq_window"] = {k: _spec(v) for k, v in jax.eval_shape(
        wstep, variables, maps, maps, sds((bt, d.numKeypoints, 2),
                                          np.float32),
        sds((bt,), np.float32), sds((), np.int32, rep)).items()}

    rows_pad = b + (-b) % NDEV
    f_pad = (b + g - 1) + (-(b + g - 1)) % NDEV
    common = {"rel": sds((rows_pad, g), np.int32),
              "jointsGroup": sds((rows_pad, d.numKeypoints, 2), np.float32),
              "mask": sds((rows_pad,), np.float32)}
    frames = sds((f_pad,) + spatial[1:], np.float32)
    out["chunk_train"] = step_out(
        make_chunk_train_step(model, tx, geometry, mesh=mesh), state,
        dict(common, hori=frames, vert=frames), lr, alpha)
    streams = sds((f_pad, samples), np.int16)
    out["adc_chunk_train"] = step_out(
        make_adc_chunk_train_step(model, tx, geometry, mesh=mesh,
                                  radar_params=rp, num_frames=d.numFrames),
        state, dict(common, hori=streams, vert=streams), lr, alpha)

    # the max recipe as tests/test_flagship_lowering.py lowers it: the
    # einsum attention, the Pallas kernel having no CPU lowering
    mcfg = load_config(os.path.join(os.path.dirname(__file__), "..",
                                    "config", "mscsa_prgcn_tpu_max.yaml"))
    mcfg.MODEL.attention = "xla"
    mmodel, mtx = build_model(mcfg), make_optimizer(mcfg)
    out["max_train"] = step_out(
        make_train_step(mmodel, mtx, geometry=geometry),
        abstract_state(mcfg, mmodel, mtx), batch(mcfg.TRAINING.batchSize),
        np.float32(2.5e-4), alpha)
    return out


@pytest.mark.parametrize("program", graft_entry.PROGRAMS)
@pytest.mark.parametrize("rank", graft_entry.SHAPE_RANKS)
def test_flagship_shapes_equal_jax(jax_shapes, program, rank):
    """The program's outputs on this rank of 8 (global: gathered or
    reduced over the ranks) have the shapes and dtypes of hupr_tpu's at
    the flagship geometry; the train steps' state is JAX's state's."""
    got = _port(rank)[program]
    assert got == jax_shapes[program]


def test_flagship_shape_pass_ranks_agree_and_launch_nothing():
    before = (attention.attention_fwd.launches,
              attention.attention_bwd.launches)
    shapes = {r: _port(r) for r in graft_entry.SHAPE_RANKS}
    assert "world 8" in graft_entry.check_flagship_shapes(shapes)
    assert not dist.is_initialized()
    assert (attention.attention_fwd.launches,
            attention.attention_bwd.launches) == before


def test_planted_fault_request_the_world_does_not_divide():
    """A 600-frame request over 7 ranks: frame_block refuses it, and the
    fake group is gone after."""
    with pytest.raises(ValueError,
                       match="600 frames do not split evenly over 7 ranks"):
        graft_entry.flagship_shapes(0, 7, programs=("serve",),
                                    serve_frames=600)
    assert not dist.is_initialized()


def test_meta_stands_for_card_only_within_the_pass():
    """Within meta_stands_for_card a meta call of the kernels' shapes
    answers with its shape and launches nothing; outside it, and within it
    at a channel count the kernels are not built for, it raises."""
    meta = [torch.empty((2, 256, 64), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="not meta"):
        attention.attention_fwd(*meta)
    with kernels.meta_stands_for_card():
        out, lse = attention.attention_fwd(*meta, with_lse=True)
        assert (out.shape, lse.shape, out.device.type) == \
            ((2, 256, 64), (2, 256), "meta")
        grads = attention.attention_bwd(*meta, out, lse, meta[0])
        assert [tuple(t.shape) for t in grads] == [(2, 256, 64)] * 3
        odd = [torch.empty((2, 256, 48), device="meta") for _ in range(3)]
        with pytest.raises(ValueError, match="built for C"):
            attention.attention_fwd(*odd)
    with pytest.raises(ValueError, match="not meta"):
        attention.attention_fwd(*meta)
