"""How a kernel of csrc/ becomes a torch op, for every op that launches
one (ops/attention, ops/conv).

Each csrc/<name>.cu exposes a C function hupr_<name> that launches its
kernel on device pointers, then ints, then a stream, and returns a CUDA
error code (cuda_build builds and loads it). Here, once for all of them:
the ctypes binding (`bind`); the launch on the current stream, counted on
the wrapper that makes it (`launch`, `counted`, `reset_launch_counts`);
operands on 16-byte boundaries (`aligned`); the input checks every kernel
makes (`check`; each op adds its shapes); and the torch.library custom op
in the namespace hupr_tpu_torch (`op`), which torch.export keeps as one
node (engine/export.py) and whose fake kernel takes meta tensors for the
card's within `meta_stands_for_card`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from hupr_tpu_torch.ops.cuda_build import load_library

NAMESPACE = "hupr_tpu_torch"
POINTER, INT, INT64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CARD = ("cuda",)


@functools.cache
def bind(library: str, symbol: str, argtypes: tuple, restype=INT):
    """The C function `symbol` of csrc/<library>.cu, its library built and
    loaded at the first call, with its ctypes argument and result types."""
    fn = getattr(load_library(library), symbol)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


@functools.cache
def _launcher(library: str, pointers: int, ints: int):
    """hupr_<library>, the C function that launches csrc/<library>.cu:
    `pointers` pointers, `ints` ints, then the stream."""
    return bind(library, f"hupr_{library}",
                (POINTER,) * pointers + (INT,) * ints + (POINTER,))


def stream(device: torch.device) -> int:
    """The handle of the stream that work on card `device` goes to now."""
    return torch.cuda.current_stream(device).cuda_stream


_COUNTED = []


def counted(wrapper):
    """Register `wrapper`, a function that launches kernels through
    `launch`, with the counts `launch` keeps on it: `launches` and
    `launches_by_mode` ({mode: launches})."""
    _COUNTED.append(wrapper)
    wrapper.launches, wrapper.launches_by_mode = 0, {}
    return wrapper


def reset_launch_counts() -> None:
    """Zero the launch counts of every wrapper registered by `counted`."""
    for wrapper in _COUNTED:
        wrapper.launches, wrapper.launches_by_mode = 0, {}


def launch(wrapper, library: str, tensors, ints, mode: str = "f32") -> None:
    """Launch the kernel of csrc/<library>.cu: call hupr_<library> on the
    data pointers of `tensors` (None for one left out), `ints` and the
    current stream of the first tensor's device, and count the launch in
    `wrapper`'s launches and launches_by_mode[mode]. Raise RuntimeError
    if the C function returns a CUDA error."""
    fn = _launcher(library, len(tensors), len(ints))
    err = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints,
             stream(tensors[0].device))
    if err != 0:
        raise RuntimeError(f"{library} kernel launch in mode {mode} failed "
                           f"with CUDA error {err}")
    wrapper.launches += 1
    wrapper.launches_by_mode[mode] = wrapper.launches_by_mode.get(mode, 0) + 1


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it on a 16-byte boundary."""
    return t.clone() if t.data_ptr() % 16 else t


def check(op: str, tensors: dict, dtypes, device_types=CARD,
          float32=()) -> None:
    """Raise unless `tensors` ({name: tensor}) are contiguous, on one
    device of a type in `device_types`, and of one dtype in `dtypes`, but
    those named in `float32`, which are float32 whatever the others are.
    The device's type is asked last, so that an input the kernel would
    refuse anywhere is refused as such on every device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{op} inputs on different devices: {devices}")
    kinds = {t.dtype for name, t in tensors.items() if name not in float32}
    if len(kinds) != 1 or not kinds <= set(dtypes):
        raise TypeError(f"{op} takes inputs of one dtype in {dtypes}; got "
                        f"{ {n: t.dtype for n, t in tensors.items()} }")
    for name, t in tensors.items():
        if name in float32 and t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op} takes contiguous tensors; {name} is not")
    device = devices.pop()
    if device.type not in device_types:
        raise ValueError(f"{op} runs on CUDA or CPU, not {device}")


_meta_as_card = False


@contextlib.contextmanager
def meta_stands_for_card():
    """Within it, the ops take meta tensors as the card's: each is held to
    what the CUDA kernel takes (shapes, dtypes, channels) and answers with
    its output's shape, launching nothing. The flagship shape pass
    (graft_entry.flagship_shapes) runs the programs on meta tensors so.
    Outside it a meta tensor raises, as on any device without a kernel."""
    global _meta_as_card
    saved, _meta_as_card = _meta_as_card, True
    try:
        yield
    finally:
        _meta_as_card = saved


def op(name: str, schema: str, plain, cuda, fake, inputs_check):
    """The custom op NAMESPACE::name of `schema`. The dispatcher picks its
    kernel by the inputs' device: on the CPU `plain`, the plain twin; on
    the card `cuda`, the launch; elsewhere `fake`, the outputs' shapes and
    dtypes (fake tensors under torch.export, meta tensors). Both of the
    last hold their inputs to `inputs_check(name, {schema name: tensor}
    (a None left out), device_types)` unless the inputs stand for the CPU's: a fake tensor
    carries the device it stands for, and a meta tensor stands for the
    card's within meta_stands_for_card and for no device outside it."""
    params = [p.split()[-1] for p in schema[1:schema.index(")")].split(",")]

    def hold(args, device_types):
        inputs_check(name, {p: a for p, a in zip(params, args)
                            if isinstance(a, torch.Tensor)}, device_types)

    def checked_cuda(*args):
        hold(args, CARD)
        return cuda(*args)

    def checked_fake(*args):
        if args[0].device.type != "cpu":
            hold(args, ("cuda", "meta") if _meta_as_card else CARD)
        return fake(*args)

    registered = torch.library.custom_op(f"{NAMESPACE}::{name}", plain,
                                         mutates_args=(), device_types="cpu",
                                         schema=schema)
    registered.register_kernel("cuda", checked_cuda)
    registered.register_fake(checked_fake)
    return registered
