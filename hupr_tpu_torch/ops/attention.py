"""MSCSA spatial attention: the plain version and the Hopper kernel's wrapper.

The op, on (B, N, C) tensors (reference layers.py:126-133, channels-last):
    logits[b, i, j] = sum_c k[b, i, c] * q[b, j, c]
    A = softmax(logits, axis=i)            # over key positions, no scale
    out[b, j, c]  = sum_i m[b, i, c] * A[b, i, j]

`attention_fwd` replaces the TPU kernel
hupr_tpu/ops/attention.py:_attention_fwd_pallas with the CUDA kernel in
csrc/attention_fwd.cu. The work is 4*B*N^2*C flops and B*N^2 exps against
16*B*N*C bytes, so it is bound by operations. The TPU kernel holds whole
(N, C) key and value panels in VMEM; a Hopper block cannot (1 MB each at
N=4096, C=64), so the kernel streams key tiles through shared memory with an
online softmax and never writes the (N, N) matrix. It computes in full
float32 FMAs to hold the 1e-4 bar of the float32 reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hupr_tpu_torch.ops.cuda_build import load_library

KERNEL_CHANNELS = (64, 128, 256)

# matmul count per call, as multiples of one (N,N)x(N,C) product's 2*N*N*C
# flops: the forward runs k q^T and p^T m (2); a backward would recompute
# the logits, then da, dq, dk, dm (5)
FWD_MATMULS = 2
BWD_MATMULS = 5


def attention_flops(b: int, n: int, c: int,
                    include_backward: bool = False) -> int:
    """FLOPs of one spatial attention (forward, or forward and backward)."""
    factor = FWD_MATMULS + (BWD_MATMULS if include_backward else 0)
    return 2 * b * n * n * c * factor


def mscsa_attention_flops(batch: int, heatmap_size: int = 64,
                          num_filters: int = 32,
                          include_backward: bool = False) -> int:
    """Attention FLOPs of one HuPRNet forward: 4 attentions at each of the
    decoder's three scales, (H/4)^2 positions at 8F channels, (H/2)^2 at 4F
    and H^2 at 2F."""
    total = 0
    for div, cmul in ((4, 8), (2, 4), (1, 2)):
        n = (heatmap_size // div) ** 2
        total += 4 * attention_flops(batch, n, num_filters * cmul,
                                     include_backward)
    return total


def attention_plain(k: torch.Tensor, q: torch.Tensor,
                    m: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x3 -> (B, N, C), materializing the (B, N, N) logits."""
    logits = torch.einsum("bic,bjc->bij", k, q)
    return torch.einsum("bic,bij->bjc", m, torch.softmax(logits, dim=1))


def _check(k, q, m):
    if not (k.device == q.device == m.device):
        raise ValueError(f"attention inputs on different devices: "
                         f"{k.device}, {q.device}, {m.device}")
    for name, t in (("k", k), ("q", q), ("m", m)):
        if t.dtype != torch.float32:
            raise TypeError(f"attention_fwd takes float32; {name} is "
                            f"{t.dtype} (bfloat16 is not ported yet)")
        if t.dim() != 3 or t.shape != m.shape:
            raise ValueError(f"attention_fwd takes three equal (B, N, C) "
                             f"shapes; got {tuple(k.shape)}, "
                             f"{tuple(q.shape)}, {tuple(m.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"attention_fwd takes contiguous tensors; "
                             f"{name} is not")
        if t.requires_grad:
            raise RuntimeError("attention_fwd is forward-only: run it under "
                               "torch.inference_mode() or torch.no_grad()")
    if m.shape[2] not in KERNEL_CHANNELS:
        raise ValueError(f"attention_fwd is built for C in {KERNEL_CHANNELS}"
                         f"; got C={m.shape[2]}")


@functools.cache
def _kernel():
    lib = load_library("attention_fwd")
    fn = lib.hupr_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def attention_fwd(k: torch.Tensor, q: torch.Tensor,
                  m: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x3 -> (B, N, C). CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, or raise."""
    if k.device.type == q.device.type == m.device.type == "cpu":
        return attention_plain(k, q, m)
    _check(k, q, m)
    if m.device.type != "cuda":
        raise ValueError(f"attention_fwd runs on CUDA or CPU, not "
                         f"{m.device}")
    b, n, c = m.shape
    out = torch.empty_like(m)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = _kernel()(k.data_ptr(), q.data_ptr(), m.data_ptr(), out.data_ptr(),
                    b, n, c, stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed with CUDA "
                           f"error {err}")
    attention_fwd.launches += 1
    return out


attention_fwd.launches = 0
