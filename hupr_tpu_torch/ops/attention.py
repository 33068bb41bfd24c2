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
online softmax and never writes the (N, N) matrix. It runs on the tensor
cores in every mode: in float32 as three TF32 products each (3xTF32 on
mma.sync, csrc/tf32.cuh), which keep float32's accuracy and the 1e-4 bar of
the float32 reference; the bfloat16 modes on wgmma. On request it also
returns each query's log-sum-exp, the residual of the backward.

`attention_bwd` replaces hupr_tpu/ops/attention.py:_attention_bwd_pallas
with the two-pass CUDA kernel in csrc/attention_bwd.cu (10*B*N^2*C flops,
bound by operations; the source says how it does without the TPU kernel's
carry across q-blocks), on the tensor cores in every mode: in float32 as
three TF32 products each (3xTF32, csrc/tf32.cuh), which keep float32's
accuracy. `FusedSpatialAttention` ties the two together as
`fused_spatial_attention`'s custom VJP does, and `spatial_attention` is
what the decoder calls: the Function when autograd records, the forward
kernel alone otherwise.

Both kernels run in four modes (`kernel_mode`), as the TPU kernels do: full
float32; bfloat16 inputs with float32 arithmetic (MODEL.computeDtype
bfloat16); and with `bf16_ops` (MODEL.attention 'pallas_bf16') operands
rounded to bfloat16 at the TPU kernels' mxu_bf16 points, on float32 or
bfloat16 inputs. The LSE and the backward's D vector are float32 in every
mode. Each mode has a plain twin with the same rounding points
(`attention_plain`, `attention_bwd_plain`); mode bf16's kernels carry its
float32 p and dS into the tensor cores as two bfloat16 terms, which keeps
them within 2^-17 of those points.

`attention_fwd_unfolded` (csrc/attention_fwd_unfolded.cu) replaces the
microbenchmark's round-1 Pallas body,
scripts/attn_microbench.py:make_pallas(fold=False): the softmax normalized
before the product, in modes f32 (3xTF32 on mma.sync) and f32_bf16ops
(wgmma, bfloat16 operands, the normalized softmax rounded to bfloat16). It
makes two passes over the key tiles, each row's max and sum, then the
recomputed logits' normalized softmax times m: three products where the
TPU body makes two, whose 4*B*N^2*C flops its bound counts.

Each kernel is a torch.library custom op in the namespace hupr_tpu_torch
(`attention_fwd`, `attention_fwd_lse`, `attention_bwd`,
`attention_fwd_unfolded`): the dispatcher hands CUDA tensors to the launch
and CPU tensors to the plain twin, and a program traced by torch.export
keeps the op as one node, so an artifact exported on a CPU host launches
the kernel on the card (engine/export.py). The public wrappers call the
ops and keep the launch counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from hupr_tpu_torch.ops.cuda_build import load_library

KERNEL_CHANNELS = (64, 128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

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


def kernel_mode(dtype: torch.dtype, bf16_ops: bool = False) -> str:
    """The kernels' mode for inputs of `dtype`: 'f32' (full float32),
    'bf16' (bfloat16 inputs, float32 arithmetic: computeDtype bfloat16),
    or with `bf16_ops` 'f32_bf16ops' / 'bf16_bf16ops' (operands rounded to
    bfloat16 for every product, float32 accumulation: 'pallas_bf16')."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    return f"{name}_bf16ops" if bf16_ops else name


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _operands(tensors, bf16_ops: bool):
    """float32 values of the inputs, rounded to bfloat16 under `bf16_ops`
    (a bfloat16 input converts exactly)."""
    return [_round_bf16(t) if bf16_ops else t.to(torch.float32)
            for t in tensors]


def attention_plain(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                    with_lse: bool = False, bf16_ops: bool = False):
    """(B, N, C) x3 -> out (B, N, C), materializing the (B, N, N) logits;
    with `with_lse`, (out, lse) with lse[b, j] the log-sum-exp over keys
    of query j's logits, (B, N) float32. The plain twin of `attention_fwd`
    in each mode, with its rounding points: the arithmetic is float32 on
    the inputs' values (bfloat16 products are exact in float32), `out` is
    rounded once to the inputs' dtype; under `bf16_ops` k, q and m are
    rounded to bfloat16 first, and so is the unnormalized softmax
    p = exp(logits - max) before p.m, while its sum and the division stay
    float32 (the TPU kernel's mxu_bf16 branch)."""
    dtype = m.dtype
    k, q, m = _operands((k, q, m), bf16_ops)
    logits = torch.einsum("bic,bjc->bij", k, q)
    if bf16_ops:
        p = torch.exp(logits - logits.amax(dim=1, keepdim=True))
        out = torch.einsum("bic,bij->bjc", m, _round_bf16(p)) \
            / p.sum(dim=1)[:, :, None]
    else:
        out = torch.einsum("bic,bij->bjc", m, torch.softmax(logits, dim=1))
    out = out.to(dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=1)
    return out


def attention_bwd_plain(k, q, m, out, lse, g, bf16_ops: bool = False):
    """Gradients (dk, dq, dm) of the attention for output gradient g, from
    the forward's out and lse, written out from the formulas:
        p_ij = exp(k_i . q_j - lse_j),  dP_ij = m_i . g_j,  D_j = g_j . out_j
        dS_ij = p_ij (dP_ij - D_j)
        dm_i = sum_j p_ij g_j,  dk_i = sum_j dS_ij q_j,  dq_j = sum_i dS_ij k_i
    The plain twin of `attention_bwd` in each mode: float32 arithmetic on
    the inputs' values, each gradient accumulated in float32 and rounded
    once to the inputs' dtype; under `bf16_ops` k, q, m and g are rounded to
    bfloat16 first, and p and dS before the products they enter."""
    dtype = k.dtype
    k, q, m, g = _operands((k, q, m, g), bf16_ops)
    out = out.to(torch.float32)
    p = torch.exp(torch.einsum("bic,bjc->bij", k, q) - lse[:, None, :])
    dp = torch.einsum("bic,bjc->bij", m, g)
    ds = p * (dp - (g * out).sum(dim=2)[:, None, :])
    if bf16_ops:
        p, ds = _round_bf16(p), _round_bf16(ds)
    dk = torch.einsum("bij,bjc->bic", ds, q)
    dq = torch.einsum("bij,bic->bjc", ds, k)
    dm = torch.einsum("bij,bjc->bic", p, g)
    return dk.to(dtype), dq.to(dtype), dm.to(dtype)


def attention_unfolded_plain(k, q, m, bf16_ops: bool = False):
    """The plain twin of `attention_fwd_unfolded`: the softmax normalized
    in float32 before the product (the microbenchmark's round-1 body,
    scripts/attn_microbench.py:57-69), and under `bf16_ops` k, q, m and the
    normalized softmax rounded to bfloat16."""
    dtype = m.dtype
    k, q, m = _operands((k, q, m), bf16_ops)
    a = torch.softmax(torch.einsum("bic,bjc->bij", k, q), dim=1)
    if bf16_ops:
        a = _round_bf16(a)
    return torch.einsum("bic,bij->bjc", m, a).to(dtype)


def _check(op, tensors, shape, dtypes=KERNEL_DTYPES,
           device_types=("cuda",)):
    """Raise unless every tensor is a contiguous tensor of the (B, N, C)
    `shape` (a (B, N) float32 shape for names starting with 'lse'), all of
    one dtype in `dtypes`, with C one the kernels are built for, on a
    device of a type in `device_types` (the card's)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{op} inputs on different devices: {devices}")
    kinds = {t.dtype for name, t in tensors.items()
             if not name.startswith("lse")}
    if len(kinds) != 1 or not kinds <= set(dtypes):
        raise TypeError(f"{op} takes inputs of one dtype in {dtypes}; got "
                        f"{ {n: t.dtype for n, t in tensors.items()} }")
    for name, t in tensors.items():
        want = shape[:2] if name.startswith("lse") else shape
        if name.startswith("lse") and t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32, not {t.dtype}")
        if len(shape) != 3 or tuple(t.shape) != tuple(want):
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)} for (B, N, C) inputs")
        if not t.is_contiguous():
            raise ValueError(f"{op} takes contiguous tensors; {name} is not")
    if shape[2] not in KERNEL_CHANNELS:
        raise ValueError(f"{op} is built for C in {KERNEL_CHANNELS}; got "
                         f"C={shape[2]}")
    device = devices.pop()
    if device.type not in device_types:
        raise ValueError(f"{op} runs on CUDA or CPU, not {device}")


@functools.cache
def _kernel(name: str):
    """The ctypes function of csrc/<name>.cu: pointers, then b, n, c, the
    mode (inputs bfloat16, bf16_ops), then the stream."""
    pointers = {"attention_fwd": 5, "attention_bwd": 10,
                "attention_fwd_unfolded": 4}[name]
    fn = getattr(load_library(name), f"hupr_{name}")
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, mode: str, pointers, shape, stream):
    """Launch the kernel of wrapper `fn` in `mode` on `stream` and count it;
    raise if the C function returns a CUDA error."""
    name = fn.__name__
    err = _kernel(name)(*pointers, *shape, int(mode.startswith("bf16")),
                        int(mode.endswith("bf16ops")), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch in mode {mode} failed "
                           f"with CUDA error {err}")
    fn.launches += 1
    fn.launches_by_mode[mode] = fn.launches_by_mode.get(mode, 0) + 1


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counts."""
    for fn in (attention_fwd, attention_bwd, attention_fwd_unfolded):
        fn.launches = 0
        fn.launches_by_mode = {}


def _operand_tensors(tensors, mode: str):
    """The operands as the kernels read them, on 16-byte boundaries
    (cp.async's copies; a tensor that starts off one is copied). The
    tensor-core bf16 modes (all but 'f32') take bfloat16 operands:
    f32_bf16ops rounds its float32 inputs here, one cast each, to the values
    the TPU kernel rounds on load."""
    out = []
    for t in tensors:
        if mode != "f32":
            t = t.to(torch.bfloat16)
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# The kernels as torch.library custom ops, so that a traced program
# (engine/export.py) holds them as opaque nodes: each op's CUDA kernel is
# the launch below, its CPU kernel the plain twin, and its fake kernel the
# shapes and dtypes. The dispatcher picks by the inputs' device; on any
# other device (meta) the fake kernel refuses what the CUDA kernel would.
NAMESPACE = "hupr_tpu_torch"


def _op(name: str, schema: str, cpu, cuda, fake):
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda", cuda)
    op.register_fake(fake)
    return op


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


def _fake_check(op, tensors, shape, dtypes=KERNEL_DTYPES):
    """The fake kernels' check: off the CPU, what _check holds the CUDA
    kernel to (a fake tensor carries the device it stands for; a meta
    tensor stands for the card's within meta_stands_for_card)."""
    if next(iter(tensors.values())).device.type != "cpu":
        _check(op, tensors, shape, dtypes, device_types=(
            ("cuda", "meta") if _meta_as_card else ("cuda",)))


def _fwd_cuda(k, q, m, bf16_ops: bool, with_lse: bool):
    _check("attention_fwd", {"k": k, "q": q, "m": m}, m.shape)
    b, n, c = m.shape
    mode = kernel_mode(m.dtype, bf16_ops)
    out = torch.empty_like(m)
    lse = torch.empty((b, n), dtype=torch.float32, device=m.device) \
        if with_lse else None
    k, q, m = _operand_tensors((k, q, m), mode)
    _launch(attention_fwd, mode,
            (k.data_ptr(), q.data_ptr(), m.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr()), (b, n, c), _stream(m))
    return (out, lse) if with_lse else out


def _fwd_fake(k, q, m, bf16_ops: bool, with_lse: bool):
    _fake_check("attention_fwd", {"k": k, "q": q, "m": m}, m.shape)
    out = torch.empty_like(m)
    if with_lse:
        return out, m.new_empty(m.shape[:2], dtype=torch.float32)
    return out


_FWD = "(Tensor k, Tensor q, Tensor m, bool bf16_ops) -> "
_fwd_op = _op(
    "attention_fwd", _FWD + "Tensor",
    lambda k, q, m, bf16_ops: attention_plain(k, q, m, False, bf16_ops),
    lambda k, q, m, bf16_ops: _fwd_cuda(k, q, m, bf16_ops, False),
    lambda k, q, m, bf16_ops: _fwd_fake(k, q, m, bf16_ops, False))
_fwd_lse_op = _op(
    "attention_fwd_lse", _FWD + "(Tensor, Tensor)",
    lambda k, q, m, bf16_ops: attention_plain(k, q, m, True, bf16_ops),
    lambda k, q, m, bf16_ops: _fwd_cuda(k, q, m, bf16_ops, True),
    lambda k, q, m, bf16_ops: _fwd_fake(k, q, m, bf16_ops, True))


def _bwd_cuda(k, q, m, out, lse, g, bf16_ops: bool):
    _check("attention_bwd", {"k": k, "q": q, "m": m, "out": out,
                             "lse": lse, "g": g}, m.shape)
    b, n, c = m.shape
    mode = kernel_mode(m.dtype, bf16_ops)
    dk, dq, dm = (torch.empty_like(m) for _ in range(3))
    dvec = torch.empty((b, n), dtype=torch.float32, device=m.device)
    k, q, m, g = _operand_tensors((k, q, m, g), mode)
    _launch(attention_bwd, mode,
            [t.data_ptr() for t in (k, q, m, out, lse, g, dk, dq, dm, dvec)],
            (b, n, c), _stream(m))
    return dk, dq, dm


def _bwd_fake(k, q, m, out, lse, g, bf16_ops: bool):
    _fake_check("attention_bwd", {"k": k, "q": q, "m": m, "out": out,
                                  "lse": lse, "g": g}, m.shape)
    return tuple(torch.empty_like(k) for _ in range(3))


_bwd_op = _op(
    "attention_bwd", "(Tensor k, Tensor q, Tensor m, Tensor out, Tensor lse,"
    " Tensor g, bool bf16_ops) -> (Tensor, Tensor, Tensor)",
    attention_bwd_plain, _bwd_cuda, _bwd_fake)


def _unfolded_cuda(k, q, m, bf16_ops: bool):
    _check("attention_fwd_unfolded", {"k": k, "q": q, "m": m}, m.shape,
           dtypes=(torch.float32,))
    b, n, c = m.shape
    mode = kernel_mode(m.dtype, bf16_ops)
    out = torch.empty_like(m)
    k, q, m = _operand_tensors((k, q, m), mode)
    _launch(attention_fwd_unfolded, mode,
            [t.data_ptr() for t in (k, q, m, out)], (b, n, c), _stream(m))
    return out


def _unfolded_fake(k, q, m, bf16_ops: bool):
    _fake_check("attention_fwd_unfolded", {"k": k, "q": q, "m": m}, m.shape,
                dtypes=(torch.float32,))
    return torch.empty_like(m)


_unfolded_op = _op("attention_fwd_unfolded", _FWD + "Tensor",
                   attention_unfolded_plain, _unfolded_cuda, _unfolded_fake)


def attention_fwd(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                  with_lse: bool = False, bf16_ops: bool = False):
    """(B, N, C) x3 -> out, or (out, lse) with `with_lse`; float32 or
    bfloat16 inputs of one dtype, out in that dtype, lse float32. The op
    hupr_tpu_torch::attention_fwd (attention_fwd_lse with `with_lse`): CPU
    tensors take the plain twin of the mode; CUDA tensors launch the kernel
    on the current stream, or raise. Its output records no graph: with
    autograd recording and an input that requires grad it raises (use
    `spatial_attention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (k, q, m)):
        raise RuntimeError("attention_fwd is forward-only: call "
                           "spatial_attention, or run it under "
                           "torch.inference_mode() or torch.no_grad()")
    return (_fwd_lse_op if with_lse else _fwd_op)(k, q, m, bf16_ops)


def attention_bwd(k, q, m, out, lse, g, bf16_ops: bool = False):
    """(dk, dq, dm) for output gradient g, from the forward's out and lse,
    in the inputs' dtype (accumulated in float32). The op
    hupr_tpu_torch::attention_bwd: CPU tensors take the plain twin of the
    mode; CUDA tensors launch the two-pass kernel on the current stream,
    or raise."""
    return _bwd_op(k, q, m, out, lse, g, bf16_ops)


def attention_fwd_unfolded(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                           bf16_ops: bool = False) -> torch.Tensor:
    """The microbenchmark's unfolded forward (softmax normalized before the
    product), float32 inputs and output. The op
    hupr_tpu_torch::attention_fwd_unfolded: CPU tensors take its plain
    twin; CUDA tensors launch csrc/attention_fwd_unfolded.cu on operands
    aligned to 16 bytes, rounded to bfloat16 under `bf16_ops`
    (_operand_tensors), or raise. Nothing on the model's path calls it."""
    return _unfolded_op(k, q, m, bf16_ops)


reset_launch_counts()


class FusedSpatialAttention(torch.autograd.Function):
    """The attention with its hand-written backward: the forward kernel
    keeps the per-query log-sum-exp, the backward kernel reads it
    (counterpart of `fused_spatial_attention`'s custom VJP)."""

    @staticmethod
    def forward(ctx, k, q, m, bf16_ops=False):
        out, lse = attention_fwd(k, q, m, with_lse=True, bf16_ops=bf16_ops)
        ctx.save_for_backward(k, q, m, out, lse)
        ctx.bf16_ops = bf16_ops
        return out

    @staticmethod
    def backward(ctx, g):
        # the decoder's transpose(1, 2).reshape hands over a strided g
        return (*attention_bwd(*ctx.saved_tensors, g.contiguous(),
                               bf16_ops=ctx.bf16_ops), None)


def spatial_attention(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                      bf16_ops: bool = False) -> torch.Tensor:
    """MODEL.attention 'pallas' ('pallas_bf16' with `bf16_ops`): the
    Function when autograd records and an input requires grad, else the
    forward kernel alone (serving)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (k, q, m)):
        return FusedSpatialAttention.apply(k, q, m, bf16_ops)
    return attention_fwd(k, q, m, bf16_ops=bf16_ops)
