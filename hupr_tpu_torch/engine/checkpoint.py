"""Checkpoints in the reference's own `.pth` format (counterpart of
`hupr_tpu/engine/checkpoint.py`; parity: the reference's tools/base.py:75-122).

Each file is the dict the reference saves with torch.save:

  model_state_dict      the reference's keys, which are the port's
  optimizer_state_dict  torch Adam's (or SGD's) state; the learning rate in
                        effect lives in its param_groups
  epoch, accuracy       the epoch that wrote it and the best AP so far

So a released model_best.pth loads into the port with no converter, and
the JAX package's Runner loads a port checkpoint through its `.pth`
fallback. Files are read with torch.load(weights_only=True): loading a
checkpoint from elsewhere runs no pickled code. The JAX package's own
msgpack `.ckpt` files are not read (msgpack is not a dependency of the
port).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch


def _to_host(x):
    """A copy of `x` (nested dicts and lists of tensors) on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def snapshot(model, optimizer, epoch: int, accuracy: float,
             lr: Optional[float] = None) -> dict:
    """The reference's checkpoint dict, every tensor copied to the host
    once; it can then be written to any number of files. `lr`, when given,
    is written into the optimizer's param_groups: it is the learning rate
    the run continues with, which the reference keeps there
    (tools/base.py:66-72, 114)."""
    opt = _to_host(optimizer.state_dict())
    if lr is not None:
        for group in opt["param_groups"]:
            group["lr"] = float(lr)
    return {"epoch": int(epoch),
            "model_state_dict": _to_host(model.state_dict()),
            "optimizer_state_dict": opt,
            "accuracy": float(accuracy) if accuracy is not None else -1.0}


def write_checkpoint(path: str, payload: dict) -> None:
    """torch.save to a process-unique temp file, then an atomic rename: a
    reader never sees a half-written checkpoint."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class AsyncCheckpointer:
    """Checkpoint writer that keeps the caller going: the caller's thread
    makes the one device-to-host copy (snapshot), and the files are written
    on a background thread. `wait()` joins it and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._failure: list = []

    def save(self, paths, model, optimizer, epoch: int, accuracy: float,
             lr: Optional[float] = None):
        """Write the same snapshot to every path in `paths`."""
        self.wait()
        payload = snapshot(model, optimizer, epoch, accuracy, lr)
        paths = list(paths)

        def work():
            try:
                for p in paths:
                    write_checkpoint(p, payload)
            except BaseException as exc:  # surface on the next wait()
                self._failure.append(exc)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._failure:
            raise self._failure.pop()


def _numpy_safe_globals() -> list:
    """Reference checkpoints store 'accuracy' as numpy.float64 (COCOeval's
    stats[0]); the weights-only unpickler rejects numpy scalars unless
    they are allowed."""
    core = getattr(np, "_core", None) or np.core
    out = [core.multiarray.scalar, np.dtype]
    dtypes = getattr(np, "dtypes", None)
    if dtypes is not None:        # numpy >= 1.25 dtype classes
        out.append(dtypes.Float64DType)
    return out


def _check_optimizer_state(optimizer) -> None:
    """Every per-parameter state tensor (Adam's moments, SGD's momentum)
    has its parameter's shape: torch's load_state_dict pairs them by
    position and checks no shape."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            for name, v in optimizer.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.dim() > 0 \
                        and v.shape != p.shape:
                    raise ValueError(
                        f"optimizer state {name!r} of shape {tuple(v.shape)} "
                        f"does not fit a parameter of shape "
                        f"{tuple(p.shape)}")


def load_checkpoint(path: str, model, optimizer=None):
    """Load a `.pth` into `model` (strictly) and, when the file has an
    optimizer state and `optimizer` is given, into `optimizer`. A bare
    state_dict and DataParallel's 'module.' prefixes are accepted. Returns
    (epoch, accuracy, lr); lr comes from the saved param_groups, None when
    the file has none."""
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model_state_dict" not in ckpt:           # a bare state_dict
        ckpt = {"model_state_dict": ckpt}
    sd = {(k[7:] if k.startswith("module.") else k): v
          for k, v in ckpt["model_state_dict"].items()}
    model.load_state_dict(sd, strict=True)
    opt = ckpt.get("optimizer_state_dict")
    lr = None
    if opt:
        if optimizer is not None:
            optimizer.load_state_dict(opt)
            _check_optimizer_state(optimizer)
        groups = opt.get("param_groups", [])
        if groups and "lr" in groups[0]:
            lr = float(groups[0]["lr"])
    acc = ckpt.get("accuracy")
    return (int(ckpt.get("epoch", -1)),
            float(acc) if acc is not None else -1.0, lr)


def find_checkpoint(log_dir: str, mode: str) -> Optional[str]:
    """Resolve 'model_best' / 'checkpoint' / 'checkpoint_N' to its `.pth`
    in `log_dir`; None when there is none. A JAX-package `.ckpt` in its
    place raises, naming the file: the port cannot read it, and training
    from scratch over it would be a silent restart."""
    pth = os.path.join(log_dir, mode + ".pth")
    if os.path.exists(pth):
        return pth
    ckpt = os.path.join(log_dir, mode + ".ckpt")
    if os.path.exists(ckpt):
        raise RuntimeError(
            f"{ckpt} is a checkpoint of the JAX package (msgpack), which "
            f"the port does not read; it reads the reference's .pth format "
            f"only ({pth})")
    return None
