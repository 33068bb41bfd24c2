"""ctypes bindings for the native C++ frame loader (`native/npy_loader.cc`,
shared with the JAX package and built from the same source).

The library is built with g++ at first use into `build/hupr_tpu_torch/` at
the root of the checkout (the JAX package builds its own copy under
`native/build/`), and the caller falls back to the NumPy path when no
toolchain is available. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "npy_loader.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "hupr_tpu_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libhupr_loader.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile to a process-unique temp file and atomically rename into
    place, so that two processes building at once never interleave writes
    into the .so another process is dlopen-ing."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)):
            if not _build():
                # never fall back to an out-of-date binary: one that
                # diverges from the current source is worse than the NumPy
                # path the caller takes anyway
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.hupr_load_frames.restype = ctypes.c_int
            lib.hupr_load_frames.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
                ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.hupr_probe_npy.restype = ctypes.c_int
            lib.hupr_probe_npy.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_int),
            ]
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def load_frames(paths: List[str], chirp_start: int, chirp_count: int,
                inner_shape, n_threads: int = 4):
    """Load `paths` (each a (chirps, *inner_shape) complex .npy) into
    (n, chirp_count, *inner_shape) float32 (real, imag) arrays.

    Returns None if the native library is unavailable or any file fails
    (the caller falls back to NumPy)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    inner = int(np.prod(inner_shape))
    out_re = np.empty((n, chirp_count) + tuple(inner_shape), dtype=np.float32)
    out_im = np.empty_like(out_re)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    loaded = lib.hupr_load_frames(
        arr, n, chirp_start, chirp_count, inner,
        out_re.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads)
    if loaded != n:
        return None
    return out_re, out_im
