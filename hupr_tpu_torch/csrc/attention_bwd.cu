// Backward MSCSA spatial attention for Hopper (sm_90a), float32 arithmetic
// on float32 or bfloat16 inputs.
//
// The forward (attention_fwd.cu) computes, per batch b and query j,
//   s_ij = k_i . q_j,   p_ij = exp(s_ij - lse_j),   out_j = sum_i p_ij m_i
// (softmax over the KEY axis i, no scale). Given g = dLoss/dout, this
// kernel computes
//   dm_i  = sum_j p_ij g_j
//   dP_ij = m_i . g_j,   D_j = g_j . out_j  (= sum_i p_ij dP_ij)
//   dS_ij = p_ij (dP_ij - D_j)
//   dq_j  = sum_i dS_ij k_i,   dk_i = sum_j dS_ij q_j
// on contiguous (B, N, C) tensors of one element type `In` (float or
// __nv_bfloat16), with lse (B, N) float32 from the forward. dq, dk and dm
// are accumulated in float32 registers over every tile and written in `In`,
// rounded once; the D vector is float32 in every mode.
//
// Replaces the TPU kernel hupr_tpu/ops/attention.py:_attention_bwd_pallas
// (body _make_bwd_kernel). Same algebra: with a = p/s there, t/s is dS and
// its c_j is D_j. That kernel walks the q-blocks of a batch in order on one
// core and carries dk and dm in its resident output block from one grid
// step to the next. Hopper blocks run in parallel and in no order, so the
// carry cannot be copied; atomics would make the sums' order, and so the
// result, change from run to run. This kernel runs two passes instead, each
// block owning what it writes:
//   (a) one block per (query tile, batch): D_j once, then stream key tiles;
//       accumulate dq_j. Writes dq and D (B, N) for pass (b).
//   (b) one block per (key tile, batch): stream query tiles with their lse
//       and D; accumulate dk_i and dm_i in registers.
// Both recompute s and dP per tile pair (7 products of 2*N*N*C flops each,
// against the 5 of the TPU kernel) and never write an (N, N) array. Since
// each block owns the dk and dm rows it writes and sums them over all query
// tiles in float32 registers, the gradients are rounded to `In` once at the
// end, the property the TPU kernel gets from its float32 outputs (its _bwd
// casts dk and dm once).
//
// Modes, those of the TPU kernel: float32 inputs; bfloat16 inputs
// (MODEL.computeDtype bfloat16), where every product runs on the inputs'
// float32 values; and the mxu_bf16 branch (OPS = true, MODEL.attention
// pallas_bf16, on float32 or bfloat16 inputs): k, q, m and g are rounded to
// bfloat16 on load, and p and dS are rounded to bfloat16 before the dm, dk
// and dq products. The TPU kernel also rounds 1/s and the products q/s and
// g/s to bfloat16; here the normalization rides on p = exp(s - lse) in
// float32. And it sums D_j from its float32 p and dP, where this kernel
// takes g_j . out_j from the forward's out, which bfloat16 inputs round to
// bfloat16. Both are differences at bfloat16's rounding level.
//
// Bound: 10*B*N^2*C flops (5 products) against 32*B*N*C bytes (half in
// bfloat16), so it is bound by operations. It runs FMAs on the float32
// (non-tensor) pipes in every mode, which meets the float32 reference's
// 1e-3 gradient bar; a bf16 x bf16 product is exact in float32, so on
// bfloat16 operands they compute what the tensor cores would, summed in
// another order. Tensor cores (wgmma, TMA) come later. Tiles: T = 64
// queries and keys at C = 64, 128; T = 32 at C = 256, where four (64, 257)
// float tiles would not fit in a block's 227 KB of shared memory and pass
// (b)'s two (T, C) accumulators would take 128 registers a thread. The K,
// Q, M and G tiles hold bfloat16 when the inputs are bfloat16 or are
// rounded to it, rows padded by two elements (4-byte aligned, an odd
// number of 32-bit words apart); float tiles are padded by one float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads per block
constexpr int LANES = 16;   // threads sharing one tile row (half a warp)
constexpr int ROWS = NT / LANES;  // row groups (16)

template <int C>
__host__ __device__ constexpr int tile() { return C == 256 ? 32 : 64; }

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

// Element type of the K, Q, M and G tiles: float in full float32, bfloat16
// when the inputs are bfloat16 or are rounded to it on load.
template <typename In, bool OPS>
using TileT = std::conditional_t<std::is_same_v<In, float> && !OPS, float,
                                 bf16>;

template <typename S, int C>
__host__ __device__ constexpr int row_stride() {
  return C + (sizeof(S) == 4 ? 1 : 2);
}

template <int C, typename In, bool OPS>
constexpr size_t dq_smem_bytes() {
  using S = TileT<In, OPS>;
  constexpr size_t T = tile<C>();
  return sizeof(float) * T * (T + 1) +
         sizeof(S) * 4 * T * row_stride<S, C>();
}

template <int C, typename In, bool OPS>
constexpr size_t dkdm_smem_bytes() {
  using S = TileT<In, OPS>;
  constexpr size_t T = tile<C>();
  return sizeof(float) * (2 * T * (T + 1) + 2 * T) +
         sizeof(S) * 4 * T * row_stride<S, C>();
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows r0 .. r0+T-1 of a (n, C) panel into a (T, row_stride) tile of
// S, zeros beyond row n (rounded to bfloat16 where S is bfloat16).
template <int C, int T, typename S, typename In>
__device__ __forceinline__ void stage(S* dst, const In* src, size_t base,
                                      int r0, int n) {
  constexpr int QS = row_stride<S, C>();
  for (int e = threadIdx.x; e < T * C; e += NT) {
    const int r = e / C, c = e % C;
    dst[r * QS + c] = from_f32<S>(
        (r0 + r < n) ? to_f32(src[base + size_t(r0 + r) * C + c]) : 0.f);
  }
}

// Thread t owns tile rows rg + 16*i and columns cg + 16*j, rg = t / 16,
// cg = t % 16, as in the forward kernel. Tile rows are padded, so the
// column walks below read 16 distinct banks.

// Pass (a): dq and D for one (query tile, batch).
template <int C, typename In, bool OPS>
__global__ void __launch_bounds__(NT)
attention_bwd_dq_kernel(const In* __restrict__ k,
                        const In* __restrict__ q,
                        const In* __restrict__ m,
                        const In* __restrict__ out,
                        const float* __restrict__ lse,
                        const In* __restrict__ g,
                        In* __restrict__ dq, float* __restrict__ dvec,
                        int n) {
  using S = TileT<In, OPS>;
  constexpr int T = tile<C>();
  constexpr int TM = T / ROWS;    // query rows per thread
  constexpr int TS = T / LANES;   // key columns per thread
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int QS = row_stride<S, C>();
  constexpr int PS = T + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ds = reinterpret_cast<float*>(smem_raw);   // T x PS dS
  S* qs = reinterpret_cast<S*>(ds + T * PS);        // T x QS queries
  S* gs = qs + T * QS;            // T x QS output gradients
  S* ks = gs + T * QS;            // T x QS keys
  S* ms = ks + T * QS;            // T x QS values

  const int tid = threadIdx.x;
  const int cg = tid % LANES;
  const int rg = tid / LANES;
  const size_t base = size_t(blockIdx.y) * n * C;
  const size_t vbase = size_t(blockIdx.y) * n;
  const int q0 = blockIdx.x * T;

  stage<C, T>(qs, q, base, q0, n);
  stage<C, T>(gs, g, base, q0, n);
  __syncthreads();

  // D_j = g_j . out_j, reduced over the half-warp that owns row j
  float dj[TM], lj[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = rg + ROWS * i;
    const bool ok = q0 + row < n;
    float part = 0.f;
    if (ok) {
#pragma unroll
      for (int t = 0; t < TN; ++t)
        part = fmaf(to_f32(gs[row * QS + cg + 16 * t]),
                    to_f32(out[base + size_t(q0 + row) * C + cg + 16 * t]),
                    part);
    }
    dj[i] = half_warp_sum(part);
    lj[i] = ok ? lse[vbase + q0 + row] : 0.f;
    if (ok && cg == 0) dvec[vbase + q0 + row] = dj[i];
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[i][t] = 0.f;

  for (int k0 = 0; k0 < n; k0 += T) {
    __syncthreads();  // the previous key tile and dS are consumed
    stage<C, T>(ks, k, base, k0, n);
    stage<C, T>(ms, m, base, k0, n);
    __syncthreads();

    // s = q_j . k_i and dP = g_j . m_i for this thread's rows and columns
    float s[TM][TS], dp[TM][TS];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float qv[TM], gv[TM], kv[TS], mv[TS];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        qv[i] = to_f32(qs[(rg + ROWS * i) * QS + c]);
        gv[i] = to_f32(gs[(rg + ROWS * i) * QS + c]);
      }
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        kv[j] = to_f32(ks[(cg + LANES * j) * QS + c]);
        mv[j] = to_f32(ms[(cg + LANES * j) * QS + c]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], mv[j], dp[i][j]);
        }
    }
    // dS = p (dP - D); keys beyond n contribute nothing
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const int col = cg + LANES * j;
        const float p = (k0 + col < n) ? expf(s[i][j] - lj[i]) : 0.f;
        const float d = p * (dp[i][j] - dj[i]);
        ds[(rg + ROWS * i) * PS + col] = OPS ? round_bf16(d) : d;
      }
    __syncthreads();

    // dq += dS (T x T) . K (T x C)
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float dv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) dv[i] = ds[(rg + ROWS * i) * PS + kk];
#pragma unroll
      for (int t = 0; t < TN; ++t)
        kv[t] = to_f32(ks[kk * QS + cg + LANES * t]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) acc[i][t] = fmaf(dv[i], kv[t], acc[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + rg + ROWS * i;
    if (row >= n) continue;
#pragma unroll
    for (int t = 0; t < TN; ++t)
      dq[base + size_t(row) * C + cg + LANES * t] = from_f32<In>(acc[i][t]);
  }
}

// Pass (b): dk and dm for one (key tile, batch).
template <int C, typename In, bool OPS>
__global__ void __launch_bounds__(NT)
attention_bwd_dkdm_kernel(const In* __restrict__ k,
                          const In* __restrict__ q,
                          const In* __restrict__ m,
                          const float* __restrict__ lse,
                          const In* __restrict__ g,
                          const float* __restrict__ dvec,
                          In* __restrict__ dk, In* __restrict__ dm,
                          int n) {
  using S = TileT<In, OPS>;
  constexpr int T = tile<C>();
  constexpr int TM = T / ROWS;    // key rows per thread
  constexpr int TS = T / LANES;   // query columns per thread
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int QS = row_stride<S, C>();
  constexpr int PS = T + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);   // T x PS p
  float* ds = ps + T * PS;        // T x PS dS
  float* ls = ds + T * PS;        // T      lse of the query tile
  float* dl = ls + T;             // T      D of the query tile
  S* ks = reinterpret_cast<S*>(dl + T);             // T x QS keys
  S* ms = ks + T * QS;            // T x QS values
  S* qs = ms + T * QS;            // T x QS queries
  S* gs = qs + T * QS;            // T x QS output gradients

  const int tid = threadIdx.x;
  const int cg = tid % LANES;
  const int rg = tid / LANES;
  const size_t base = size_t(blockIdx.y) * n * C;
  const size_t vbase = size_t(blockIdx.y) * n;
  const int i0 = blockIdx.x * T;

  stage<C, T>(ks, k, base, i0, n);
  stage<C, T>(ms, m, base, i0, n);

  float dk_acc[TM][TN], dm_acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < TN; ++t) dk_acc[i][t] = dm_acc[i][t] = 0.f;

  for (int j0 = 0; j0 < n; j0 += T) {
    __syncthreads();  // the previous query tile, p and dS are consumed
    stage<C, T>(qs, q, base, j0, n);
    stage<C, T>(gs, g, base, j0, n);
    for (int e = tid; e < T; e += NT) {
      const bool ok = j0 + e < n;
      ls[e] = ok ? lse[vbase + j0 + e] : 0.f;
      dl[e] = ok ? dvec[vbase + j0 + e] : 0.f;
    }
    __syncthreads();

    // s = k_i . q_j and dP = m_i . g_j for this thread's rows and columns
    float s[TM][TS], dp[TM][TS];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      float kv[TM], mv[TM], qv[TS], gv[TS];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        kv[i] = to_f32(ks[(rg + ROWS * i) * QS + c]);
        mv[i] = to_f32(ms[(rg + ROWS * i) * QS + c]);
      }
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        qv[j] = to_f32(qs[(cg + LANES * j) * QS + c]);
        gv[j] = to_f32(gs[(cg + LANES * j) * QS + c]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(mv[i], gv[j], dp[i][j]);
        }
    }
    // p and dS; queries beyond n contribute nothing
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const int col = cg + LANES * j;
        const float p = (j0 + col < n) ? expf(s[i][j] - ls[col]) : 0.f;
        const float d = p * (dp[i][j] - dl[col]);
        ps[(rg + ROWS * i) * PS + col] = OPS ? round_bf16(p) : p;
        ds[(rg + ROWS * i) * PS + col] = OPS ? round_bf16(d) : d;
      }
    __syncthreads();

    // dm += P (T x T) . G (T x C), dk += dS (T x T) . Q (T x C)
#pragma unroll 2
    for (int jj = 0; jj < T; ++jj) {
      float pv[TM], dv[TM], gv[TN], qv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = ps[(rg + ROWS * i) * PS + jj];
        dv[i] = ds[(rg + ROWS * i) * PS + jj];
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        gv[t] = to_f32(gs[jj * QS + cg + LANES * t]);
        qv[t] = to_f32(qs[jj * QS + cg + LANES * t]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          dm_acc[i][t] = fmaf(pv[i], gv[t], dm_acc[i][t]);
          dk_acc[i][t] = fmaf(dv[i], qv[t], dk_acc[i][t]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i0 + rg + ROWS * i;
    if (row >= n) continue;
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const size_t at = base + size_t(row) * C + cg + LANES * t;
      dk[at] = from_f32<In>(dk_acc[i][t]);
      dm[at] = from_f32<In>(dm_acc[i][t]);
    }
  }
}

template <int C, typename In, bool OPS>
cudaError_t launch(const void* k, const void* q, const void* m,
                   const void* out, const float* lse, const void* g,
                   void* dk, void* dq, void* dm, float* dvec, int b, int n,
                   cudaStream_t stream) {
  constexpr size_t smem_a = dq_smem_bytes<C, In, OPS>();
  constexpr size_t smem_b = dkdm_smem_bytes<C, In, OPS>();
  static_assert(smem_a <= 232448 && smem_b <= 232448,
                "tile exceeds a Hopper block's shared memory");
  // the shared-memory limit is an attribute of each kernel on each device:
  // set it on a device's first launch only
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<C, In, OPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_a));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dkdm_kernel<C, In, OPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_b));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const In* kt = static_cast<const In*>(k);
  const In* qt = static_cast<const In*>(q);
  const In* mt = static_cast<const In*>(m);
  const In* gt = static_cast<const In*>(g);
  constexpr int T = tile<C>();
  const dim3 grid((n + T - 1) / T, b);
  attention_bwd_dq_kernel<C, In, OPS><<<grid, NT, smem_a, stream>>>(
      kt, qt, mt, static_cast<const In*>(out), lse, gt, static_cast<In*>(dq),
      dvec, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdm_kernel<C, In, OPS><<<grid, NT, smem_b, stream>>>(
      kt, qt, mt, lse, gt, dvec, static_cast<In*>(dk), static_cast<In*>(dm),
      n);
  return cudaGetLastError();
}

template <typename In, bool OPS>
cudaError_t dispatch(const void* k, const void* q, const void* m,
                     const void* out, const float* lse, const void* g,
                     void* dk, void* dq, void* dm, float* dvec, int b, int n,
                     int c, cudaStream_t s) {
  switch (c) {
    case 64:
      return launch<64, In, OPS>(k, q, m, out, lse, g, dk, dq, dm, dvec, b,
                                 n, s);
    case 128:
      return launch<128, In, OPS>(k, q, m, out, lse, g, dk, dq, dm, dvec, b,
                                  n, s);
    case 256:
      return launch<256, In, OPS>(k, q, m, out, lse, g, dk, dq, dm, dvec, b,
                                  n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. k, q, m, out, g, dk, dq and dm are
// float32 when `in_bf16` is 0 and bfloat16 when it is 1; `bf16_ops` selects
// the mxu_bf16 rounding. `lse` is the forward's (B, N) float32 residual and
// `dvec` (B, N) float32 scratch that pass (a) fills with D for pass (b).
// Returns a cudaError_t (0 on success); allocates nothing and does not
// synchronize.
extern "C" int hupr_attention_bwd(const void* k, const void* q, const void* m,
                                  const void* out, const void* lse,
                                  const void* g, void* dk, void* dq, void* dm,
                                  void* dvec, int b, int n, int c,
                                  int in_bf16, int bf16_ops, void* stream) {
  const float* lf = static_cast<const float*>(lse);
  float* dvf = static_cast<float*>(dvec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  if (in_bf16)
    return int(bf16_ops
                   ? dispatch<bf16, true>(k, q, m, out, lf, g, dk, dq, dm,
                                          dvf, b, n, c, s)
                   : dispatch<bf16, false>(k, q, m, out, lf, g, dk, dq, dm,
                                           dvf, b, n, c, s));
  return int(bf16_ops ? dispatch<float, true>(k, q, m, out, lf, g, dk, dq, dm,
                                              dvf, b, n, c, s)
                      : dispatch<float, false>(k, q, m, out, lf, g, dk, dq,
                                               dm, dvf, b, n, c, s));
}
