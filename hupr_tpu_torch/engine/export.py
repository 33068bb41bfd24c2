"""AOT serving export (counterpart of `hupr_tpu/engine/export.py`):
serialize the e2e serving program (raw ADC frames -> keypoints,
engine/pipeline.ServingProgram, the body `make_e2e_infer` runs) to a
`torch.export` artifact, so that a deployment host runs inference without
the model code or the config stack: only torch and this module, whose
import registers the kernels' custom ops (ops/attention.py, ops/conv.py).
Weights are baked into the artifact; shapes are static (a fixed frame-stack
size F), one program per stack size.

The decoder's attentions stay `hupr_tpu_torch::attention_fwd` nodes, and
a float32 model's Encoder3D convolutions `hupr_tpu_torch::conv3d_3x3x3`
nodes, so an artifact exported on a CPU host launches the Hopper kernels
when it is loaded onto the card, and the plain twins when it is loaded onto
the CPU.
The graph is not decomposed: it runs the ATen ops `make_e2e_infer` runs.

    blob = export_serving(model, state, params, frames=32)
    save_artifact("serving_f32.pt2", blob)
    # ... on the deployment host:
    serve = load_artifact("serving_f32.pt2")          # the card
    pred2d, maxvals = serve(hori_re, hori_im, vert_re, vert_im)

The exported graph does not carry the TF32 flags, so the loaded callable
pins full float32 math for its call, as `make_e2e_infer` does. An artifact
is made and loaded by one torch release: torch.export's serialization is
versioned (`artifact_info`'s calling_convention_version) but not promised
across releases.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Sequence

import torch
from torch.export.passes import move_to_device_pass

import hupr_tpu_torch.ops.attention  # noqa: F401  (registers the ops)
import hupr_tpu_torch.ops.conv  # noqa: F401
from hupr_tpu_torch.utils.device import float32_math, resolve_device

MAGIC = b"HUPRTEXP1\n"
PLATFORMS = ("cuda", "cpu")
_PLATFORMS_FILE = "hupr_platforms"


def serving_arg_specs(frames: int, params, dtype=torch.int16,
                      device="cpu") -> tuple:
    """Example tensors of the four serving inputs: per-view I/Q frame stacks
    (F, RX, chirps, ADC) of zeros. int16 by default, the DCA1000's sample
    format (the program casts on the device); float32 exports a
    float-ingest variant. The export traces them as fake tensors: only
    their shape, dtype and device count."""
    shape = (frames, params.num_rx, params.num_chirp, params.num_adc_samples)
    return tuple(torch.zeros(shape, dtype=dtype, device=device)
                 for _ in range(4))


def _platforms(platforms: Sequence[str]) -> list:
    out = [p.strip().lower() for p in platforms]
    bad = [p for p in out if p not in PLATFORMS]
    if bad or not out:
        raise ValueError(f"platforms {list(platforms)}: this port's "
                         f"artifacts run on {list(PLATFORMS)} only"
                         + (" (a TPU artifact comes from hupr_tpu's "
                            "export)" if "tpu" in bad else ""))
    return out


def export_serving(model, state=None, params=None, frames: int = 32,
                   duration: int = None, group: int = 8, num_frames: int = 8,
                   dtype=torch.int16,
                   platforms: Sequence[str] = PLATFORMS,
                   device="cpu") -> bytes:
    """Serialize the e2e serving program to bytes.

    `frames` fixes the stack size; `duration` defaults to `frames`, so one
    exported call is one clamped window sequence, as the serving paths feed
    it. `state`, when given, is loaded into `model` strictly; the weights
    are captured in the artifact. The trace runs on `device`, the CPU by
    default (tracing computes nothing). `platforms` lists the devices the
    artifact may be loaded onto, 'cuda' and/or 'cpu'; it is stored in the
    artifact."""
    from hupr_tpu_torch.engine.pipeline import ServingProgram
    from hupr_tpu_torch.ops.dsp import RadarParams

    platforms = _platforms(platforms)
    params = params or RadarParams()
    dev = torch.device(device)
    model = model.to(dev).eval()
    if state is not None:
        model.load_state_dict(state, strict=True)
    program = ServingProgram(model, params, duration or frames, group,
                             num_frames).eval()
    # no_grad: the decoder takes the forward kernel alone, not the
    # autograd Function
    with torch.no_grad():
        exported = torch.export.export(
            program, serving_arg_specs(frames, params, dtype, dev),
            strict=False)
    exported.example_inputs = None     # F frames of zeros: not worth a byte
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={_PLATFORMS_FILE: ",".join(platforms)})
    return MAGIC + buf.getvalue()


def _payload(blob: bytes) -> bytes:
    if not blob.startswith(MAGIC):
        raise ValueError("not a hupr_tpu_torch serving artifact (bad magic)")
    return blob[len(MAGIC):]


def _stored(blob: bytes) -> tuple:
    """(platforms, 'major.minor' schema version) of an artifact, read from
    its archive without deserializing the program: the platform list
    export_serving stored, and the serialization schema version
    torch.export wrote into the graph (its models/*.json)."""
    with zipfile.ZipFile(io.BytesIO(_payload(blob))) as archive:
        names = archive.namelist()
        listed, = (n for n in names if n.endswith("/" + _PLATFORMS_FILE))
        graph, = (n for n in names if n.split("/")[-2:-1] == ["models"]
                  and n.endswith(".json"))
        platforms = archive.read(listed).decode().split(",")
        version = json.loads(archive.read(graph))["schema_version"]
    return platforms, f"{version['major']}.{version['minor']}"


def _load(blob: bytes):
    return torch.export.load(io.BytesIO(_payload(blob)))


def load_serving(blob: bytes, device=None):
    """Deserialize an export_serving artifact onto `device` (the card
    unless the caller names one; with no card this raises) -> callable
    (hori_re, hori_im, vert_re, vert_im) -> (pred2d, maxvals), taking numpy
    or torch arrays of the exported shape and dtype. A device the artifact
    does not list is refused. The call runs under inference_mode with full
    float32 math (TF32 off), the caller's flags restored after it."""
    dev = resolve_device(device)
    platforms, _ = _stored(blob)
    if dev.type not in platforms:
        raise ValueError(f"the artifact lists platforms {platforms}, not "
                         f"{dev.type}")
    exported = move_to_device_pass(_load(blob), dev)
    program = exported.module()

    @torch.inference_mode()
    @float32_math()
    def serve(hori_re, hori_im, vert_re, vert_im):
        return program(*(torch.as_tensor(x, device=dev)
                         for x in (hori_re, hori_im, vert_re, vert_im)))

    return serve


def save_artifact(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)          # atomic, like engine/checkpoint.py


def load_artifact(path: str, device=None):
    device = resolve_device(device)       # refused before the file is read
    with open(path, "rb") as f:
        return load_serving(f.read(), device)


def _aval(meta) -> str:
    """A tensor's dtype and shape as JAX prints an abstract value:
    int16[32,4,192,256]."""
    dtype = str(meta.dtype).removeprefix("torch.")
    return f"{dtype}[{','.join(str(int(d)) for d in meta.shape)}]"


def artifact_info(blob: bytes) -> dict:
    """Introspection of an artifact (nothing runs): input and output dtypes
    and shapes, the platforms it lists, torch.export's serialization
    schema version, its size."""
    platforms, version = _stored(blob)
    exported = _load(blob)
    user_inputs = set(exported.graph_signature.user_inputs)
    nodes = list(exported.graph.nodes)
    ins = [n.meta["val"] for n in nodes
           if n.op == "placeholder" and n.name in user_inputs]
    outs = [a.meta["val"] for a in nodes[-1].args[0]]
    return {
        "platforms": platforms,
        "in_avals": [_aval(v) for v in ins],
        "out_avals": [_aval(v) for v in outs],
        "calling_convention_version": version,
        "bytes": len(blob),
    }
