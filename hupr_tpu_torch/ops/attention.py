"""MSCSA spatial attention: plain versions, the Hopper kernels' wrappers and
their autograd Function.

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
float32 FMAs to hold the 1e-4 bar of the float32 reference. On request it
also returns each query's log-sum-exp, the residual of the backward.

`attention_bwd` replaces hupr_tpu/ops/attention.py:_attention_bwd_pallas
with the two-pass CUDA kernel in csrc/attention_bwd.cu (10*B*N^2*C flops,
bound by operations; the source says how it does without the TPU kernel's
carry across q-blocks). `FusedSpatialAttention` ties the two together as
`fused_spatial_attention`'s custom VJP does, and `spatial_attention` is
what the decoder calls: the Function when autograd records, the forward
kernel alone otherwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hupr_tpu_torch.ops.cuda_build import load_library

KERNEL_CHANNELS = (64, 128, 256)

# matmul count per call, as multiples of one (N,N)x(N,C) product's 2*N*N*C
# flops: the forward runs k q^T and p^T m (2); the backward recomputes the
# logits, then da, dq, dk, dm (5)
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


def attention_plain(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                    with_lse: bool = False):
    """(B, N, C) x3 -> out (B, N, C), materializing the (B, N, N) logits;
    with `with_lse`, (out, lse) with lse[b, j] the log-sum-exp over keys
    of query j's logits, (B, N)."""
    logits = torch.einsum("bic,bjc->bij", k, q)
    out = torch.einsum("bic,bij->bjc", m, torch.softmax(logits, dim=1))
    if with_lse:
        return out, torch.logsumexp(logits, dim=1)
    return out


def attention_bwd_plain(k, q, m, out, lse, g):
    """Gradients (dk, dq, dm) of the attention for output gradient g, from
    the forward's out and lse, written out from the formulas:
        p_ij = exp(k_i . q_j - lse_j),  dP_ij = m_i . g_j,  D_j = g_j . out_j
        dS_ij = p_ij (dP_ij - D_j)
        dm_i = sum_j p_ij g_j,  dk_i = sum_j dS_ij q_j,  dq_j = sum_i dS_ij k_i
    """
    p = torch.exp(torch.einsum("bic,bjc->bij", k, q) - lse[:, None, :])
    dp = torch.einsum("bic,bjc->bij", m, g)
    ds = p * (dp - (g * out).sum(dim=2)[:, None, :])
    dk = torch.einsum("bij,bjc->bic", ds, q)
    dq = torch.einsum("bij,bic->bjc", ds, k)
    dm = torch.einsum("bij,bjc->bic", p, g)
    return dk, dq, dm


def _check(op, tensors, shape):
    """Raise unless every tensor is a contiguous float32 CUDA tensor of the
    (B, N, C) `shape` (a (B, N) shape for names starting with 'lse'), with C
    one the kernels are built for."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{op} inputs on different devices: {devices}")
    for name, t in tensors.items():
        want = shape[:2] if name.startswith("lse") else shape
        if t.dtype != torch.float32:
            raise TypeError(f"{op} takes float32; {name} is {t.dtype} "
                            f"(bfloat16 is not ported yet)")
        if len(shape) != 3 or tuple(t.shape) != tuple(want):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)} for (B, N, C) inputs")
        if not t.is_contiguous():
            raise ValueError(f"{op} takes contiguous tensors; {name} is not")
    if shape[2] not in KERNEL_CHANNELS:
        raise ValueError(f"{op} is built for C in {KERNEL_CHANNELS}; got "
                         f"C={shape[2]}")
    device = devices.pop()
    if device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA or CPU, not {device}")


@functools.cache
def _kernel(name: str):
    """The ctypes function of csrc/<name>.cu: pointers, then b, n, c, then
    the stream."""
    pointers = {"attention_fwd": 5, "attention_bwd": 10}[name]
    fn = getattr(load_library(name), f"hupr_{name}")
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args):
    err = _kernel(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def attention_fwd(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                  with_lse: bool = False):
    """(B, N, C) x3 -> out, or (out, lse) with `with_lse`. CPU tensors take
    the plain version; CUDA tensors launch the kernel on the current stream,
    or raise. Its output records no graph: with autograd recording and an
    input that requires grad it raises (use `spatial_attention`)."""
    if _on_cpu(k, q, m):
        return attention_plain(k, q, m, with_lse)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (k, q, m)):
        raise RuntimeError("attention_fwd is forward-only: call "
                           "spatial_attention, or run it under "
                           "torch.inference_mode() or torch.no_grad()")
    _check("attention_fwd", {"k": k, "q": q, "m": m}, m.shape)
    b, n, c = m.shape
    out = torch.empty_like(m)
    lse = torch.empty((b, n), dtype=m.dtype, device=m.device) \
        if with_lse else None
    _launch("attention_fwd", k.data_ptr(), q.data_ptr(), m.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, n, c,
            torch.cuda.current_stream(m.device).cuda_stream)
    attention_fwd.launches += 1
    return (out, lse) if with_lse else out


attention_fwd.launches = 0


def attention_bwd(k, q, m, out, lse, g):
    """(dk, dq, dm) for output gradient g, from the forward's out and lse.
    CPU tensors take the plain version; CUDA tensors launch the two-pass
    kernel on the current stream, or raise."""
    if _on_cpu(k, q, m, out, lse, g):
        return attention_bwd_plain(k, q, m, out, lse, g)
    _check("attention_bwd", {"k": k, "q": q, "m": m, "out": out,
                             "lse": lse, "g": g}, m.shape)
    b, n, c = m.shape
    dk, dq, dm = (torch.empty_like(m) for _ in range(3))
    dvec = torch.empty((b, n), dtype=m.dtype, device=m.device)
    _launch("attention_bwd", *(t.data_ptr() for t in (
        k, q, m, out, lse, g, dk, dq, dm, dvec)), b, n, c,
        torch.cuda.current_stream(m.device).cuda_stream)
    attention_bwd.launches += 1
    return dk, dq, dm


attention_bwd.launches = 0


class FusedSpatialAttention(torch.autograd.Function):
    """The attention with its hand-written backward: the forward kernel
    keeps the per-query log-sum-exp, the backward kernel reads it
    (counterpart of `fused_spatial_attention`'s custom VJP)."""

    @staticmethod
    def forward(ctx, k, q, m):
        out, lse = attention_fwd(k, q, m, with_lse=True)
        ctx.save_for_backward(k, q, m, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        # the decoder's transpose(1, 2).reshape hands over a strided g
        return attention_bwd(*ctx.saved_tensors, g.contiguous())


def spatial_attention(k: torch.Tensor, q: torch.Tensor,
                      m: torch.Tensor) -> torch.Tensor:
    """MODEL.attention 'pallas': the Function when autograd records and an
    input requires grad, else the forward kernel alone (serving)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (k, q, m)):
        return FusedSpatialAttention.apply(k, q, m)
    return attention_fwd(k, q, m)
