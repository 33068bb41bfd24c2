// Forward MSCSA spatial attention for Hopper (sm_90a), full float32.
//
//   out[b, j, :] = sum_i softmax_i(k[b, i, :] . q[b, j, :]) * m[b, i, :]
//
// Softmax over the KEY axis i for each query j, with no 1/sqrt(C) scale.
// Inputs and output are contiguous (B, N, C) float32. When `lse` is not
// null the kernel also writes each query's log-sum-exp of its logits,
// lse[b, j] = max_i s_ij + log(sum_i exp(s_ij - max_i s_ij)), (B, N) float32:
// the residual the backward kernel (attention_bwd.cu) reads instead of
// recomputing the softmax statistics. Serving passes null and does the
// same work as without it.
//
// Replaces the TPU kernel hupr_tpu/ops/attention.py:_attention_fwd_pallas
// (body _make_attn_kernel). That kernel keeps whole (N, C) K and M panels in
// VMEM; at N = 4096, C = 64 one panel is 1 MB, far over the 227 KB a Hopper
// block can address. So this kernel streams key tiles through shared memory
// with an online softmax: running max, running sum and a (BQ, C) float32
// accumulator per query tile, divided once at the end.
//
// Bound: 4*B*N^2*C flops against 16*B*N*C bytes, so it is bound by
// operations. It runs FMAs on the float32 (non-tensor) pipes so that it
// agrees with the float32 reference to 1e-4; tiles are sized so that the
// inner loops are FMA chains over shared memory with conflict-free reads
// (rows padded by one float). Tensor cores (wgmma, TMA) come later.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;      // queries per block
constexpr int BK = 64;      // keys per shared-memory tile
constexpr int NT = 256;     // threads per block
constexpr int LANES = 16;   // threads sharing one query row (half a warp)
constexpr int TM = BQ / (NT / LANES);  // query rows per thread (4)

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (C + 1) + size_t(BK) * (C + 1) + size_t(BK) * C +
          size_t(BQ) * (BK + 1));
}

// Thread t owns query rows rg + 16*i (i < TM) and columns cg + 16*j, with
// rg = t / 16 and cg = t % 16. The 16 threads of a row are one half-warp,
// so row reductions are xor-shuffles within it.
template <int C>
__global__ void __launch_bounds__(NT)
attention_fwd_kernel(const float* __restrict__ k, const float* __restrict__ q,
                     const float* __restrict__ m, float* __restrict__ out,
                     float* __restrict__ lse, int n) {
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int TS = BK / LANES;  // logit columns per thread
  constexpr int QS = C + 1;       // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;      // padded row stride of the P tile

  extern __shared__ float smem[];
  float* qs = smem;               // BQ x QS
  float* ks = qs + BQ * QS;       // BK x QS
  float* ms = ks + BK * QS;       // BK x C
  float* ps = ms + BK * C;        // BQ x PS

  const int tid = threadIdx.x;
  const int cg = tid % LANES;
  const int rg = tid / LANES;
  const size_t base = size_t(blockIdx.y) * n * C;
  const int q0 = blockIdx.x * BQ;

  for (int e = tid; e < BQ * C; e += NT) {
    const int r = e / C, c = e % C;
    qs[r * QS + c] = (q0 + r < n) ? q[base + size_t(q0 + r) * C + c] : 0.f;
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
      ks[r * QS + c] = ok ? k[g] : 0.f;
      ms[r * C + c] = ok ? m[g] : 0.f;
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
      for (int i = 0; i < TM; ++i) qv[i] = qs[(rg + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < TS; ++j) kv[j] = ks[(cg + 16 * j) * QS + c];
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
        ps[(rg + 16 * i) * PS + cg + 16 * j] = p;
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
      for (int t = 0; t < TN; ++t) mv[t] = ms[kk * C + cg + 16 * t];
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
      out[base + size_t(row) * C + cg + 16 * t] = acc[i][t] / row_sum[i];
    if (lse != nullptr && cg == 0)
      lse[size_t(blockIdx.y) * n + row] = row_max[i] + logf(row_sum[i]);
  }
}

template <int C>
cudaError_t launch(const float* k, const float* q, const float* m, float* out,
                   float* lse, int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
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
    err = cudaFuncSetAttribute(attention_fwd_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_kernel<C><<<grid, NT, smem, stream>>>(k, q, m, out, lse, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `lse` may be null. Returns a cudaError_t
// (0 on success); allocates nothing and does not synchronize.
extern "C" int hupr_attention_fwd(const void* k, const void* q, const void* m,
                                  void* out, void* lse, int b, int n, int c,
                                  void* stream) {
  const float* kf = static_cast<const float*>(k);
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(m);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  switch (c) {
    case 64: return int(launch<64>(kf, qf, mf, of, lf, b, n, s));
    case 128: return int(launch<128>(kf, qf, mf, of, lf, b, n, s));
    case 256: return int(launch<256>(kf, qf, mf, of, lf, b, n, s));
    default: return int(cudaErrorInvalidValue);
  }
}
