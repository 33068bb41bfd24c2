// Unfolded forward MSCSA spatial attention for Hopper (sm_90a): the softmax
// is normalized before the product with the values, float32 inputs and
// output.
//
//   a[b, i, j] = softmax_i(k[b, i, :] . q[b, j, :]),
//   out[b, j, :] = sum_i a[b, i, j] * m[b, i, :]
//
// Replaces the TPU kernel of scripts/attn_microbench.py, make_pallas with
// fold=False (the round-1 forward body, kept there as the A/B baseline of
// the production kernel, which folds the 1/s normalization into its
// epilogue): logits, jax.nn.softmax over keys in the (N, qb) panel, then
// a^T m. With `bf16_ops` (its mxu_bf16 flag) k, q and m are rounded to
// bfloat16 on load and the NORMALIZED a is rounded to bfloat16 before the
// product, a rounding point unlike the folded kernel's, whose unnormalized
// p is rounded. Accumulation is float32 in both modes.
//
// The TPU body holds the whole (N, qb) panel of a query block; at N = 4096
// that is 1 MB for 64 queries, far over a Hopper block's 227 KB. So each
// block (one 64-query tile of one batch) makes two passes over the key
// tiles and never writes an (N, N) array: the first takes each query's
// running max and sum (its log-sum-exp); the second recomputes the logits,
// forms a = exp(s - lse) and accumulates a.m.
//
// Bound: 4*B*N^2*C flops of products (6*B*N^2*C executed, the logits
// computed in both passes) against 16*B*N*C bytes: bound by operations. It
// runs FMAs on the float32 (non-tensor) pipes as attention_fwd.cu does, with
// the same tiles and thread layout (tile rows padded so the column walks
// read distinct banks). Only the microbenchmark and the smoke test call it;
// the model's path runs the folded kernel.

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

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// K, Q and M tiles: float, or bfloat16 when rounded on load
template <bool OPS>
using TileT = std::conditional_t<OPS, bf16, float>;

template <bool OPS, int C>
__host__ __device__ constexpr int row_stride() {
  return C + (OPS ? 2 : 1);
}

template <int C, bool OPS>
constexpr size_t smem_bytes() {
  constexpr size_t QS = row_stride<OPS, C>();
  return sizeof(float) * size_t(BQ) * (BK + 1) +
         sizeof(TileT<OPS>) *
             (size_t(BQ) * QS + size_t(BK) * QS + size_t(BK) * C);
}

// logits s[i][j] = q_(rg+16i) . k_(cg+16j) for this thread's rows and
// columns of the staged tiles, -inf for keys at or beyond n
template <int C, typename S>
__device__ __forceinline__ void logits(float (&s)[TM][BK / LANES],
                                       const S* qs, const S* ks, int rg,
                                       int cg, int k0, int n) {
  constexpr int TS = BK / LANES;
  constexpr int QS = row_stride<!std::is_same_v<S, float>, C>();
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
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TS; ++j)
      if (k0 + cg + 16 * j >= n) s[i][j] = -INFINITY;
}

// Thread t owns query rows rg + 16*i (i < TM) and columns cg + 16*j, with
// rg = t / 16 and cg = t % 16, as in attention_fwd.cu.
template <int C, bool OPS>
__global__ void __launch_bounds__(NT)
attention_fwd_unfolded_kernel(const float* __restrict__ k,
                              const float* __restrict__ q,
                              const float* __restrict__ m,
                              float* __restrict__ out, int n) {
  using S = TileT<OPS>;
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int TS = BK / LANES;  // logit columns per thread
  constexpr int QS = row_stride<OPS, C>();
  constexpr int PS = BK + 1;

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
    qs[r * QS + c] =
        from_f32<S>((q0 + r < n) ? q[base + size_t(q0 + r) * C + c] : 0.f);
  }

  // pass 1: each row's max and sum over all keys -> its log-sum-exp
  float row_max[TM], row_sum[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int e = tid; e < BK * C; e += NT) {
      const int r = e / C, c = e % C;
      ks[r * QS + c] =
          from_f32<S>((k0 + r < n) ? k[base + size_t(k0 + r) * C + c] : 0.f);
    }
    __syncthreads();
    float s[TM][TS];
    logits<C>(s, qs, ks, rg, cg, k0, n);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TS; ++j) tmax = fmaxf(tmax, s[i][j]);
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // key k0 is in range, so tmax is finite
      const float new_max = fmaxf(row_max[i], tmax);
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < TS; ++j) tsum += expf(s[i][j] - new_max);
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      row_sum[i] = row_sum[i] * expf(row_max[i] - new_max) + tsum;
      row_max[i] = new_max;
    }
  }
  float lse[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) lse[i] = row_max[i] + logf(row_sum[i]);

  // pass 2: a = exp(s - lse), normalized, then acc += a . M
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[i][t] = 0.f;
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tiles and P are consumed
    for (int e = tid; e < BK * C; e += NT) {
      const int r = e / C, c = e % C;
      const bool ok = k0 + r < n;
      const size_t g = base + size_t(k0 + r) * C + c;
      ks[r * QS + c] = from_f32<S>(ok ? k[g] : 0.f);
      ms[r * C + c] = from_f32<S>(ok ? m[g] : 0.f);
    }
    __syncthreads();
    float s[TM][TS];
    logits<C>(s, qs, ks, rg, cg, k0, n);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        const float a = expf(s[i][j] - lse[i]);
        ps[(rg + 16 * i) * PS + cg + 16 * j] = OPS ? round_bf16(a) : a;
      }
    __syncthreads();
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
      out[base + size_t(row) * C + cg + 16 * t] = acc[i][t];
  }
}

template <int C, bool OPS>
cudaError_t launch(const float* k, const float* q, const float* m, float* out,
                   int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C, OPS>();
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
    err = cudaFuncSetAttribute(attention_fwd_unfolded_kernel<C, OPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_unfolded_kernel<C, OPS><<<grid, NT, smem, stream>>>(
      k, q, m, out, n);
  return cudaGetLastError();
}

template <bool OPS>
cudaError_t dispatch(const float* k, const float* q, const float* m,
                     float* out, int b, int n, int c, cudaStream_t s) {
  switch (c) {
    case 64: return launch<64, OPS>(k, q, m, out, b, n, s);
    case 128: return launch<128, OPS>(k, q, m, out, b, n, s);
    case 256: return launch<256, OPS>(k, q, m, out, b, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes, float32 tensors only (`in_bf16` must be
// 0); `bf16_ops` selects the mxu_bf16 rounding. Returns a cudaError_t (0 on
// success); allocates nothing and does not synchronize.
extern "C" int hupr_attention_fwd_unfolded(const void* k, const void* q,
                                           const void* m, void* out, int b,
                                           int n, int c, int in_bf16,
                                           int bf16_ops, void* stream) {
  const float* kf = static_cast<const float*>(k);
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(m);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || in_bf16) return int(cudaErrorInvalidValue);
  return int(bf16_ops ? dispatch<true>(kf, qf, mf, of, b, n, c, s)
                      : dispatch<false>(kf, qf, mf, of, b, n, c, s));
}
