// Forward MSCSA spatial attention for Hopper (sm_90a), float32 arithmetic on
// float32 or bfloat16 inputs.
//
//   out[b, j, :] = sum_i softmax_i(k[b, i, :] . q[b, j, :]) * m[b, i, :]
//
// Softmax over the KEY axis i for each query j, with no 1/sqrt(C) scale.
// Inputs and output are contiguous (B, N, C) tensors of one element type
// `In` (float or __nv_bfloat16); `out` is written in `In`, rounded once from
// the float32 accumulator. When `lse` is not null the kernel also writes
// each query's log-sum-exp of its logits,
// lse[b, j] = max_i s_ij + log(sum_i exp(s_ij - max_i s_ij)), (B, N) float32
// in every mode: the residual the backward kernel (attention_bwd.cu) reads
// instead of recomputing the softmax statistics. Serving passes null and
// does the same work as without it.
//
// Replaces the TPU kernel hupr_tpu/ops/attention.py:_attention_fwd_pallas
// (body _make_attn_kernel), in its three modes:
//   - float32 inputs (In = float, OPS = false);
//   - bfloat16 inputs (In = bf16, OPS = false; MODEL.computeDtype bfloat16):
//     the logits are bf16 x bf16 products, exact in float32, summed in
//     float32; p stays float32 and p.m runs on float32 values;
//   - the mxu_bf16 branch (OPS = true; MODEL.attention pallas_bf16, on
//     float32 or bfloat16 inputs): k, q and m are rounded to bfloat16 on
//     load, and p is rounded to bfloat16 before p.m, while the row sum and
//     the 1/s epilogue stay float32. p is rounded against the running
//     maximum of the online softmax, where the TPU kernel rounds it against
//     the final one: a difference at bfloat16's rounding level.
// That kernel keeps whole (N, C) K and M panels in VMEM; at N = 4096, C = 64
// one panel is 1 MB, far over the 227 KB a Hopper block can address. So this
// kernel streams key tiles through shared memory with an online softmax:
// running max, running sum and a (BQ, C) float32 accumulator per query tile,
// divided once at the end.
//
// Bound: 4*B*N^2*C flops against 16*B*N*C bytes (8*B*N*C in bfloat16), so it
// is bound by operations. It runs FMAs on the float32 (non-tensor) pipes in
// every mode: a bf16 x bf16 product is exact in float32, so on bfloat16
// operands the FMAs compute what the tensor cores would, in another order of
// summation. Tiles are sized so that the inner loops are FMA chains over
// shared memory with conflict-free reads: float tile rows are padded by one
// float, bfloat16 tile rows (half the bytes) by two elements, so that rows
// stay 4-byte aligned and a row's stride is an odd number of 32-bit words.
// Tensor cores (wgmma, TMA) come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;      // queries per block
constexpr int BK = 64;      // keys per shared-memory tile
constexpr int NT = 256;     // threads per block
constexpr int LANES = 16;   // threads sharing one query row (half a warp)
constexpr int TM = BQ / (NT / LANES);  // query rows per thread (4)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element type of the K, Q and M tiles: float in full float32, bfloat16
// when the inputs are bfloat16 or are rounded to it on load.
template <typename In, bool OPS>
using TileT = std::conditional_t<std::is_same_v<In, float> && !OPS, float,
                                 bf16>;

template <typename S, int C>
__host__ __device__ constexpr int row_stride() {
  return C + (sizeof(S) == 4 ? 1 : 2);
}

template <int C, typename In, bool OPS>
constexpr size_t smem_bytes() {
  using S = TileT<In, OPS>;
  constexpr size_t QS = row_stride<S, C>();
  return sizeof(float) * size_t(BQ) * (BK + 1) +
         sizeof(S) * (size_t(BQ) * QS + size_t(BK) * QS + size_t(BK) * C);
}

// Thread t owns query rows rg + 16*i (i < TM) and columns cg + 16*j, with
// rg = t / 16 and cg = t % 16. The 16 threads of a row are one half-warp,
// so row reductions are xor-shuffles within it.
template <int C, typename In, bool OPS>
__global__ void __launch_bounds__(NT)
attention_fwd_kernel(const In* __restrict__ k, const In* __restrict__ q,
                     const In* __restrict__ m, In* __restrict__ out,
                     float* __restrict__ lse, int n) {
  using S = TileT<In, OPS>;
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int TS = BK / LANES;  // logit columns per thread
  constexpr int QS = row_stride<S, C>();  // padded row stride of Q and K
  constexpr int PS = BK + 1;      // padded row stride of the P tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);   // BQ x PS
  S* qs = reinterpret_cast<S*>(ps + BQ * PS);       // BQ x QS
  S* ks = qs + BQ * QS;                             // BK x QS
  S* ms = ks + BK * QS;                             // BK x C

  const int tid = threadIdx.x;
  const int cg = tid % LANES;
  const int rg = tid / LANES;
  const size_t base = size_t(blockIdx.y) * n * C;
  const int q0 = blockIdx.x * BQ;

  for (int e = tid; e < BQ * C; e += NT) {
    const int r = e / C, c = e % C;
    qs[r * QS + c] = from_f32<S>(
        (q0 + r < n) ? to_f32(q[base + size_t(q0 + r) * C + c]) : 0.f);
  }

  float acc[TM][TN];
  float row_max[TM], row_sum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.f;
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[i][t] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int e = tid; e < BK * C; e += NT) {
      const int r = e / C, c = e % C;
      const bool ok = k0 + r < n;
      const size_t g = base + size_t(k0 + r) * C + c;
      ks[r * QS + c] = from_f32<S>(ok ? to_f32(k[g]) : 0.f);
      ms[r * C + c] = from_f32<S>(ok ? to_f32(m[g]) : 0.f);
    }
    __syncthreads();

    // logits s[i][j] = q_row . k_col for this thread's rows and columns
    float s[TM][TS];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float qv[TM], kv[TS];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = to_f32(qs[(rg + 16 * i) * QS + c]);
#pragma unroll
      for (int j = 0; j < TS; ++j) kv[j] = to_f32(ks[(cg + 16 * j) * QS + c]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile's keys; key k0 is always in range, so
    // every row's tile maximum is finite
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        if (k0 + cg + 16 * j >= n) s[i][j] = -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float new_max = fmaxf(row_max[i], tmax);
      const float alpha = expf(row_max[i] - new_max);  // 0 on the first tile
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const float p = expf(s[i][j] - new_max);
        // the sum takes p as computed; the product p.m its bfloat16 value
        ps[(rg + 16 * i) * PS + cg + 16 * j] = OPS ? round_bf16(p) : p;
        tsum += p;
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      row_sum[i] = row_sum[i] * alpha + tsum;
      row_max[i] = new_max;
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] *= alpha;
    }
    __syncthreads();

    // acc += P (BQ x BK) . M (BK x C)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[TM], mv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = ps[(rg + 16 * i) * PS + kk];
#pragma unroll
      for (int t = 0; t < TN; ++t) mv[t] = to_f32(ms[kk * C + cg + 16 * t]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) acc[i][t] = fmaf(pv[i], mv[t], acc[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int t = 0; t < TN; ++t)
      out[base + size_t(row) * C + cg + 16 * t] =
          from_f32<In>(acc[i][t] / row_sum[i]);
    if (lse != nullptr && cg == 0)
      lse[size_t(blockIdx.y) * n + row] = row_max[i] + logf(row_sum[i]);
  }
}

template <int C, typename In, bool OPS>
cudaError_t launch(const void* k, const void* q, const void* m, void* out,
                   float* lse, int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C, In, OPS>();
  static_assert(smem <= 232448, "tile exceeds a Hopper block's shared memory");
  // the shared-memory limit is an attribute of the kernel on each device:
  // set it on a device's first launch only
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<C, In, OPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_kernel<C, In, OPS><<<grid, NT, smem, stream>>>(
      static_cast<const In*>(k), static_cast<const In*>(q),
      static_cast<const In*>(m), static_cast<In*>(out), lse, n);
  return cudaGetLastError();
}

template <typename In, bool OPS>
cudaError_t dispatch(const void* k, const void* q, const void* m, void* out,
                     float* lse, int b, int n, int c, cudaStream_t s) {
  switch (c) {
    case 64: return launch<64, In, OPS>(k, q, m, out, lse, b, n, s);
    case 128: return launch<128, In, OPS>(k, q, m, out, lse, b, n, s);
    case 256: return launch<256, In, OPS>(k, q, m, out, lse, b, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. k, q, m and out are float32 when
// `in_bf16` is 0 and bfloat16 when it is 1; `bf16_ops` selects the mxu_bf16
// rounding. `lse` (float32) may be null. Returns a cudaError_t (0 on
// success); allocates nothing and does not synchronize.
extern "C" int hupr_attention_fwd(const void* k, const void* q, const void* m,
                                  void* out, void* lse, int b, int n, int c,
                                  int in_bf16, int bf16_ops, void* stream) {
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  if (in_bf16)
    return int(bf16_ops ? dispatch<bf16, true>(k, q, m, out, lf, b, n, c, s)
                        : dispatch<bf16, false>(k, q, m, out, lf, b, n, c, s));
  return int(bf16_ops ? dispatch<float, true>(k, q, m, out, lf, b, n, c, s)
                      : dispatch<float, false>(k, q, m, out, lf, b, n, c, s));
}
