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

Each kernel is a custom op of ops/kernels, the seam that binds, checks,
launches and counts every kernel of csrc/ (`attention_fwd`,
`attention_fwd_lse`, `attention_bwd`, `attention_fwd_unfolded`): the
dispatcher hands CUDA tensors to the launch and CPU tensors to the plain
twin, and a program traced by torch.export keeps the op as one node, so
an artifact exported on a CPU host launches the kernel on the card
(engine/export.py). The public wrappers call the ops; their launches are
counted on them (kernels.counted).
"""

from __future__ import annotations

import torch

from hupr_tpu_torch.ops import kernels

KERNEL_CHANNELS = (64, 128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The card's bars for the kernels (chip_smoke.py, tests/test_torch_cuda.py).
ATTN_TOL = 1e-4         # kernel vs plain, max abs error (float32 vs float32)
# Each float32 gradient's relative norm error against the plain version,
# which tells 3xTF32 from one TF32 product: the CPU model of the kernel's
# arithmetic (tests/test_torch_tf32.py) reads at most 9.3e-7 in 3xTF32 and
# at least 4.1e-4 in one TF32 product, at two of the model's shapes; the
# bar is 16x over the first (the card's sums run in another order, and
# its tensor cores may not round their float32 sums to nearest) and 27x
# under the second
REL_F32_BWD = 2.0 ** -16
# the float32 forward's output against the plain version, the same way: the
# CPU model of its 3xTF32 arithmetic (tests/test_torch_tf32.py) reads at
# most 7.3e-7 on logits of unit spread and 2.6e-6 on N(0, 1) inputs (a
# nearly one-hot softmax, as chip_smoke.check_attention draws them), and at
# least 3.95e-4 in one TF32 product; the bar is 6x over the worst of the
# first and 26x under the second. It holds the unfolded forward too, whose
# 3xTF32 model reads at most 7.3e-7 and 2.6e-6 the same ways, and one TF32
# product at least 4.1e-4
REL_F32_FWD = 2.0 ** -16
# bfloat16 bars, relative norm errors (bfloat16 rounds to 2^-9 relative):
# kernel vs the float32 ideal on the same values 2^-8.5 (the bar of
# tests/test_attention.py for bfloat16 gradients); kernel vs its twin 2^-7.5
# (each within 2^-8.5 of the ideal; they round p against other maxima)
REL_IDEAL, REL_TWIN = 2.0 ** -8.5, 2.0 ** -7.5
# The backward and its twin share every rounding point and the forward's out
# and lse; they differ only where a float32 sum in another order lands on
# the other side of a bfloat16 rounding boundary (<= 3.6e-5 relative on the
# H100). Moving one rounding point (p, dS or D rounded or not) moves the
# twin by more (tests/test_torch_bf16.py::test_bwd_twin_bar_sees_rounding).
REL_TWIN_BWD = 2.0 ** -12

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


def _check(op, tensors, device_types, dtypes=KERNEL_DTYPES):
    """Raise unless the kernel of `op` takes `tensors` ({name: tensor}):
    kernels.check's rules, the LSE float32; each of m's (B, N, C) shape,
    the LSE (B, N); C one the kernels are built for."""
    kernels.check(op, tensors, dtypes, device_types, float32=("lse",))
    shape = tensors["m"].shape
    for name, t in tensors.items():
        want = shape[:2] if name == "lse" else shape
        if len(shape) != 3 or t.shape != want:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(want)} for (B, N, C) "
                             f"inputs")
    if shape[2] not in KERNEL_CHANNELS:
        raise ValueError(f"{op} is built for C in {KERNEL_CHANNELS}; got "
                         f"C={shape[2]}")


def _operand_tensors(tensors, mode: str):
    """The operands as the kernels read them, on 16-byte boundaries
    (kernels.aligned). The tensor-core bf16 modes (all but 'f32') take
    bfloat16 operands: f32_bf16ops rounds its float32 inputs here, one cast
    each, to the values the TPU kernel rounds on load."""
    return [kernels.aligned(t if mode == "f32" else t.to(torch.bfloat16))
            for t in tensors]


def _launch(wrapper, mode: str, tensors, shape) -> None:
    """Launch the kernel of `wrapper` (csrc/<its name>.cu) in `mode`: the
    C function takes b, n, c, then whether the inputs are bfloat16 and
    whether the operands are (bf16_ops)."""
    kernels.launch(wrapper, wrapper.__name__, tensors,
                   (*shape, int(mode.startswith("bf16")),
                    int(mode.endswith("bf16ops"))), mode)


def _fwd_cuda(k, q, m, bf16_ops: bool, with_lse: bool):
    b, n, c = m.shape
    mode = kernel_mode(m.dtype, bf16_ops)
    out = torch.empty_like(m)
    lse = torch.empty((b, n), dtype=torch.float32, device=m.device) \
        if with_lse else None
    _launch(attention_fwd, mode,
            (*_operand_tensors((k, q, m), mode), out, lse), (b, n, c))
    return (out, lse) if with_lse else out


_FWD = "(Tensor k, Tensor q, Tensor m, bool bf16_ops) -> "
_fwd_op = kernels.op(
    "attention_fwd", _FWD + "Tensor",
    lambda k, q, m, bf16_ops: attention_plain(k, q, m, False, bf16_ops),
    lambda k, q, m, bf16_ops: _fwd_cuda(k, q, m, bf16_ops, False),
    lambda k, q, m, bf16_ops: torch.empty_like(m), _check)
_fwd_lse_op = kernels.op(
    "attention_fwd_lse", _FWD + "(Tensor, Tensor)",
    lambda k, q, m, bf16_ops: attention_plain(k, q, m, True, bf16_ops),
    lambda k, q, m, bf16_ops: _fwd_cuda(k, q, m, bf16_ops, True),
    lambda k, q, m, bf16_ops: (torch.empty_like(m), m.new_empty(
        m.shape[:2], dtype=torch.float32)), _check)


def _bwd_cuda(k, q, m, out, lse, g, bf16_ops: bool):
    b, n, c = m.shape
    mode = kernel_mode(m.dtype, bf16_ops)
    dk, dq, dm = (torch.empty_like(m) for _ in range(3))
    dvec = torch.empty((b, n), dtype=torch.float32, device=m.device)
    k, q, m, g = _operand_tensors((k, q, m, g), mode)
    _launch(attention_bwd, mode, (k, q, m, out, lse, g, dk, dq, dm, dvec),
            (b, n, c))
    return dk, dq, dm


_bwd_op = kernels.op(
    "attention_bwd", "(Tensor k, Tensor q, Tensor m, Tensor out, Tensor lse,"
    " Tensor g, bool bf16_ops) -> (Tensor, Tensor, Tensor)",
    attention_bwd_plain, _bwd_cuda,
    lambda k, *_: tuple(torch.empty_like(k) for _ in range(3)), _check)


def _unfolded_cuda(k, q, m, bf16_ops: bool):
    mode = kernel_mode(m.dtype, bf16_ops)
    out = torch.empty_like(m)
    _launch(attention_fwd_unfolded, mode,
            (*_operand_tensors((k, q, m), mode), out), m.shape)
    return out


_unfolded_op = kernels.op(
    "attention_fwd_unfolded", _FWD + "Tensor", attention_unfolded_plain,
    _unfolded_cuda, lambda k, q, m, bf16_ops: torch.empty_like(m),
    lambda op, tensors, device_types: _check(op, tensors, device_types,
                                             (torch.float32,)))


@kernels.counted
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


@kernels.counted
def attention_bwd(k, q, m, out, lse, g, bf16_ops: bool = False):
    """(dk, dq, dm) for output gradient g, from the forward's out and lse,
    in the inputs' dtype (accumulated in float32). The op
    hupr_tpu_torch::attention_bwd: CPU tensors take the plain twin of the
    mode; CUDA tensors launch the two-pass kernel on the current stream,
    or raise."""
    return _bwd_op(k, q, m, out, lse, g, bf16_ops)


@kernels.counted
def attention_fwd_unfolded(k: torch.Tensor, q: torch.Tensor, m: torch.Tensor,
                           bf16_ops: bool = False) -> torch.Tensor:
    """The microbenchmark's unfolded forward (softmax normalized before the
    product), float32 inputs and output. The op
    hupr_tpu_torch::attention_fwd_unfolded: CPU tensors take its plain
    twin; CUDA tensors launch csrc/attention_fwd_unfolded.cu on operands
    aligned to 16 bytes, rounded to bfloat16 under `bf16_ops`
    (_operand_tensors), or raise. Nothing on the model's path calls it."""
    return _unfolded_op(k, q, m, bf16_ops)


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
