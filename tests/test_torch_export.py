"""The port's AOT serving export (hupr_tpu_torch/engine/export.py) on the
CPU: the attention kernels as torch.library custom ops, the artifact
against the port's live serving and against hupr_tpu's artifact on the
same weights, and the export script. Reduced geometry (numFilters 2, 32x32
maps), as tests/test_export.py.

hupr_tpu's artifact runs its own DSP: the Doppler-0 chirp plane is pinned
to zero on both sides before export (tests/test_torch_pipeline.py says
why)."""

import collections
import io
import os
import subprocess
import sys
import zipfile

import jax
import numpy as np
import pytest
import torch

import hupr_tpu.engine.export as jax_export
import hupr_tpu.engine.pipeline as jax_pipeline
import hupr_tpu_torch.engine.pipeline as port_pipeline
from hupr_tpu.models import HuPRNet as JaxHuPRNet
from hupr_tpu.ops import dsp as jax_dsp
from hupr_tpu.utils.synthetic import synthetic_variables
from hupr_tpu_torch.config import config_from_dict
from hupr_tpu_torch.engine import export
from hupr_tpu_torch.models.convert import state_dict_from_jax
from hupr_tpu_torch.models.hupr import build_model
from hupr_tpu_torch.ops import attention
from hupr_tpu_torch.ops.dsp import RadarParams
from hupr_tpu_torch.scripts import export_serving as export_script

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 4
SMALL = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
             num_group_chirp=2)
RP = RadarParams(**SMALL)
# tests/test_export.py's bars for the artifact against live serving, and
# tests/test_torch_pipeline.py's for the port against JAX
MAXVAL_TOL_LIVE, AGREE_LIVE = 1e-6, 0.99
MAXVAL_TOL_JAX = 1e-4


def _cfg(attn="pallas"):
    return config_from_dict({
        "MODEL": {"numFilters": 2, "attention": attn},
        "DATASET": {"rangeSize": 32, "azimuthSize": 32, "heatmapSize": 32,
                    "imgSize": 128}})


def _adc(dtype=np.int16, seed=7):
    rng = np.random.default_rng(seed)
    shape = (FRAMES, RP.num_rx, RP.num_chirp, RP.num_adc_samples)
    return tuple(rng.integers(-300, 300, shape).astype(dtype)
                 for _ in range(4))


@pytest.fixture(scope="module")
def nets():
    """hupr_tpu's model and variables, and the port's model on the same
    weights (N(0, 0.1): heatmap peaks neither flat nor saturated)."""
    jax_model = JaxHuPRNet(num_filters=2, heatmap_size=32)
    variables = jax.tree_util.tree_map(np.asarray, synthetic_variables(
        jax_model, (1, 8, 8, 2, 32, 32, 8), seed=0, scale=0.1))
    return jax_model, variables, state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def artifact(nets):
    state = nets[2]
    model = build_model(_cfg(), device="cpu")
    blob = export.export_serving(model, state, RP, frames=FRAMES,
                                 platforms=("cpu",))
    return model, state, blob


@pytest.fixture(scope="module")
def served(artifact):
    return export.load_serving(artifact[2], "cpu")


def _relisted(blob, platforms: str):
    """`blob` with its stored platform list replaced."""
    src = zipfile.ZipFile(io.BytesIO(blob[len(export.MAGIC):]))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as dst:
        for info in src.infolist():
            data = src.read(info)
            if info.filename.endswith("/" + export._PLATFORMS_FILE):
                data = platforms.encode()
            dst.writestr(info, data)
    return export.MAGIC + buf.getvalue()


def _graph_targets(blob):
    exported = export._load(blob)
    return collections.Counter(str(n.target) for n in exported.graph.nodes
                               if n.op == "call_function")


def _assert_same(got, want, tol, agree):
    pred, maxv = (np.asarray(t) for t in got)
    np.testing.assert_allclose(maxv, np.asarray(want[1]), atol=tol)
    same = np.mean(pred == np.asarray(want[0]))
    assert same >= agree, f"only {same:.2%} of coordinates match"
    assert maxv.std() > 1e-3 and maxv.max() < 1.0     # not vacuous


# ------------------------------------------------------- the custom ops

def _op_cases():
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for bf16_ops in (False, True):
            cases.append(("attention_fwd", dtype, bf16_ops))
            cases.append(("attention_fwd_lse", dtype, bf16_ops))
            cases.append(("attention_bwd", dtype, bf16_ops))
    return cases + [("attention_fwd_unfolded", torch.float32, b)
                    for b in (False, True)]


@pytest.mark.parametrize("name,dtype,bf16_ops", _op_cases(),
                         ids=lambda v: str(v).removeprefix("torch."))
def test_op_opcheck_and_cpu_kernel_is_the_twin(name, dtype, bf16_ops):
    """torch.library.opcheck passes on the CPU (schema, fake kernel,
    autograd registration, AOT dispatch), and the op's CPU kernel equals
    its plain twin bit for bit, with no launch counted."""
    gen = torch.Generator().manual_seed(len(name) + int(bf16_ops))
    k, q, m, g = (torch.randn((2, 48, 16), generator=gen).to(dtype)
                  for _ in range(4))
    op = getattr(torch.ops.hupr_tpu_torch, name)
    if name == "attention_bwd":
        out, lse = attention.attention_plain(k, q, m, True, bf16_ops)
        args = (k, q, m, out, lse, g, bf16_ops)
        want = attention.attention_bwd_plain(*args)
    elif name == "attention_fwd_unfolded":
        args = (k, q, m, bf16_ops)
        want = attention.attention_unfolded_plain(*args)
    else:
        args = (k, q, m, bf16_ops)
        want = attention.attention_plain(k, q, m, name.endswith("lse"),
                                         bf16_ops)
    torch.library.opcheck(op, args)
    before = {fn.__name__: fn.launches for fn in (
        attention.attention_fwd, attention.attention_bwd,
        attention.attention_fwd_unfolded)}
    got = op(*args)
    got, want = (x if isinstance(x, (tuple, list)) else (x,)
                 for x in (got, want))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {fn.__name__: fn.launches for fn in (
        attention.attention_fwd, attention.attention_bwd,
        attention.attention_fwd_unfolded)} == before


def test_wrappers_call_the_ops():
    """The public wrappers, and the autograd Function's forward and
    backward, reach the kernels through the ops (the profiler records each
    op's call by its qualified name)."""
    from torch.profiler import ProfilerActivity, profile

    k, q, m = (torch.randn((1, 8, 16)) for _ in range(3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out, lse = attention.attention_fwd(k, q, m, with_lse=True)
        attention.attention_fwd(k, q, m)
        attention.attention_bwd(k, q, m, out, lse, torch.ones_like(m))
        attention.attention_fwd_unfolded(k, q, m)
        attention.spatial_attention(*(t.clone().requires_grad_(True)
                                      for t in (k, q, m))).sum().backward()
    calls = [e.name.split("::")[1] for e in sorted(
        prof.events(), key=lambda e: e.time_range.start)
        if e.name.startswith("hupr_tpu_torch::")]
    assert calls == ["attention_fwd_lse", "attention_fwd", "attention_bwd",
                     "attention_fwd_unfolded", "attention_fwd_lse",
                     "attention_bwd"]


# ---------------------------------------------------------- the artifact

def test_exported_graph_holds_the_kernel_ops(artifact):
    """MODEL.attention pallas: 12 attention_fwd nodes (4 attentions at 3
    scales), no inlined plain attention (its einsums and softmax), the
    DSP's FFTs kept; xla: the plain attention inline, no op."""
    pallas = _graph_targets(artifact[2])
    assert pallas["hupr_tpu_torch.attention_fwd.default"] == 12
    assert not [t for t in pallas if "einsum" in t or "softmax" in t
                or t.startswith("hupr_tpu_torch.") and "fwd.default"
                not in t]
    assert pallas["aten.fft_fft2.default"] and pallas["aten.fft_fft.default"]
    blob = export.export_serving(build_model(_cfg("xla"), device="cpu"),
                                 artifact[1], RP, frames=FRAMES,
                                 platforms=("cpu",))
    xla = _graph_targets(blob)
    assert not [t for t in xla if t.startswith("hupr_tpu_torch.")]
    assert xla["aten.einsum.default"] == 24
    assert xla["aten.softmax.int"] == 12


def test_round_trip_equals_live_serving(artifact, served, tmp_path):
    """Through bytes and through a file, the artifact serves what the
    port's make_e2e_infer serves (tests/test_export.py's bars)."""
    model, state, blob = artifact
    args = _adc()
    live = port_pipeline.make_e2e_infer(model, state, RP, duration=FRAMES,
                                        device="cpu")(*args)
    _assert_same(served(*args), live,
                 MAXVAL_TOL_LIVE, AGREE_LIVE)
    path = str(tmp_path / "serving.pt2")
    export.save_artifact(path, blob)
    got = export.load_artifact(path, "cpu")(*(torch.from_numpy(a)
                                              for a in args))
    _assert_same(got, live, MAXVAL_TOL_LIVE, AGREE_LIVE)
    assert got[0].shape == (FRAMES, 14, 2) and got[1].shape == (FRAMES, 14, 1)


def test_artifact_equals_jax_artifact_with_doppler0_pinned(nets,
                                                           monkeypatch):
    """The port's artifact against hupr_tpu's load_serving(export_serving)
    on the same weights and int16 frames, the Doppler-0 plane pinned to
    zero on both sides before export: maxvals within 1e-4 and the same
    keypoints."""
    jax_model, variables, state = nets
    jp = jax_dsp.RadarParams(**SMALL)
    d0 = RP.num_kept_chirps // 2             # Doppler bin 0 after the crop
    jax_cube, port_cube = (jax_pipeline.radar_cube_single_frame,
                           port_pipeline.radar_cube_frames)

    def port_pinned(frames, params):
        c = port_cube(frames, params)
        c[:, d0] = 0
        return c

    monkeypatch.setattr(jax_pipeline, "radar_cube_single_frame",
                        lambda fr, p: jax_cube(fr, p).at[d0].set(0))
    monkeypatch.setattr(port_pipeline, "radar_cube_frames", port_pinned)
    jax_blob = jax_export.export_serving(jax_model, variables, params=jp,
                                         frames=FRAMES, platforms=("cpu",))
    blob = export.export_serving(build_model(_cfg(), device="cpu"), state,
                                 RP, frames=FRAMES, platforms=("cpu",))
    monkeypatch.undo()                       # the artifacts hold the pin
    args = _adc()
    want = jax_export.load_serving(jax_blob)(*args)
    got = export.load_serving(blob, "cpu")(*args)
    _assert_same(got, want, MAXVAL_TOL_JAX, 1.0)


def test_artifact_info_has_jax_keys(artifact):
    blob = artifact[2]
    info = export.artifact_info(blob)
    assert set(info) == {"platforms", "in_avals", "out_avals",
                         "calling_convention_version", "bytes"}
    assert info["platforms"] == ["cpu"]
    assert info["in_avals"] == [f"int16[{FRAMES},{RP.num_rx},{RP.num_chirp},"
                                f"{RP.num_adc_samples}]"] * 4
    assert info["out_avals"] == [f"float32[{FRAMES},14,2]",
                                 f"float32[{FRAMES},14,1]"]
    assert info["bytes"] == len(blob)
    major, minor = map(int, info["calling_convention_version"].split("."))
    assert major >= 1 and minor >= 0


@pytest.mark.parametrize("blob", [b"not an artifact",
                                  jax_export.MAGIC + b"\0" * 8])
def test_bad_magic_rejected(blob):
    with pytest.raises(ValueError, match="magic"):
        export.load_serving(blob, "cpu")
    with pytest.raises(ValueError, match="magic"):
        export.artifact_info(blob)


def test_platforms_refused(artifact):
    """'tpu' is refused at export; a device the artifact does not list is
    refused at load."""
    with pytest.raises(ValueError, match="tpu"):
        export.export_serving(artifact[0], None, RP, frames=FRAMES,
                              platforms=("tpu", "cpu"))
    only_card = _relisted(artifact[2], "cuda")
    assert export.artifact_info(only_card)["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match="platforms"):
        export.load_serving(only_card, "cpu")


def test_int16_and_float32_ingest_agree(artifact, served):
    model, state, blob = artifact
    f32 = export.export_serving(model, state, RP, frames=FRAMES,
                                dtype=torch.float32, platforms=("cpu",))
    assert export.artifact_info(f32)["in_avals"][0].startswith("float32[")
    a = served(*_adc())
    b = export.load_serving(f32, "cpu")(*_adc(np.float32))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_loaded_call_pins_float32_math(served, monkeypatch):
    """The exported graph carries no TF32 flags: the loaded callable turns
    TF32 off in cuDNN and cuBLAS for its call (seen from inside the
    attention op's kernel) and restores the caller's flags."""
    seen, plain = [], attention.attention_plain

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return plain(*args, **kw)

    monkeypatch.setattr(attention, "attention_plain", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    served(*_adc())
    assert seen == [(False, False)] * 12
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


_FRESH = """
import sys
import numpy as np
import torch
from hupr_tpu_torch.engine.export import load_artifact
torch.set_num_threads(int(sys.argv[4]))
args = np.load(sys.argv[2])
pred, maxv = load_artifact(sys.argv[1], device="cpu")(
    *(args[k] for k in ("hr", "hi", "vr", "vi")))
np.savez(sys.argv[3], pred=pred.numpy(), maxv=maxv.numpy())
bad = sorted(m for m in sys.modules if m.split(".")[0] == "jax"
             or m.startswith(("hupr_tpu_torch.models",
                              "hupr_tpu_torch.engine.pipeline")))
print("LOADED", bad)
"""


def test_fresh_process_serves_without_model_code(artifact, served,
                                                 tmp_path):
    """A new process with only engine.export imported loads the file and
    serves it: no model code, no pipeline, no JAX in sys.modules. It runs
    at this process's thread count, whatever the modules collected before
    set: the CPU kernels split their float sums by thread, so two counts
    round differently."""
    model, state, blob = artifact
    path = str(tmp_path / "serving.pt2")
    export.save_artifact(path, blob)
    args = _adc()
    np.savez(tmp_path / "in.npz", **dict(zip(("hr", "hi", "vr", "vi"),
                                             args)))
    out = subprocess.run(
        [sys.executable, "-c", _FRESH, path, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz"), str(torch.get_num_threads())],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    got = np.load(tmp_path / "out.npz")
    want = served(*args)
    np.testing.assert_array_equal(got["pred"], want[0].numpy())
    np.testing.assert_array_equal(got["maxv"], want[1].numpy())


def test_export_script_writes_the_artifact(tmp_path, capsys):
    """The script's body on a built config: synthetic weights, the
    config's capture geometry, the JAX script's 'wrote' line."""
    cfg = _cfg()
    cfg.DATASET.adcParams, cfg.DATASET.numChirps = dict(SMALL), 8
    out = str(tmp_path / "s.pt2")
    args = export_script.build_arg_parser().parse_args(
        ["--frames", str(FRAMES), "--out", out, "--platforms", "cpu"])
    info = export_script.export(args, cfg)
    printed = capsys.readouterr().out
    assert "SYNTHETIC" in printed
    assert f"wrote {out}: " in printed and "platforms=['cpu']" in printed
    assert f"in={info['in_avals'][0]}" in printed
    assert info["in_avals"][0] == f"int16[{FRAMES},4,48,128]"
    pred, maxv = export.load_artifact(out, "cpu")(*_adc())
    assert pred.shape == (FRAMES, 14, 2) and torch.isfinite(maxv).all()


def test_export_script_flags_equal_jax():
    """The JAX script's flags, with the port's defaults for the output
    and the platforms."""
    args = export_script.build_arg_parser().parse_args([])
    assert vars(args) == {"config": "mscsa_prgcn.yaml", "checkpoint": None,
                          "frames": 32, "out": "serving.pt2",
                          "platforms": "cuda,cpu", "dtype": "int16"}
