// Backward MSCSA spatial attention for Hopper (sm_90a), full float32.
//
// The forward (attention_fwd.cu) computes, per batch b and query j,
//   s_ij = k_i . q_j,   p_ij = exp(s_ij - lse_j),   out_j = sum_i p_ij m_i
// (softmax over the KEY axis i, no scale). Given g = dLoss/dout, this
// kernel computes
//   dm_i  = sum_j p_ij g_j
//   dP_ij = m_i . g_j,   D_j = g_j . out_j  (= sum_i p_ij dP_ij)
//   dS_ij = p_ij (dP_ij - D_j)
//   dq_j  = sum_i dS_ij k_i,   dk_i = sum_j dS_ij q_j
// on contiguous (B, N, C) float32 tensors, with lse (B, N) from the forward.
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
// against the 5 of the TPU kernel) and never write an (N, N) array.
//
// Bound: 10*B*N^2*C flops (5 products) against 32*B*N*C bytes, so it is
// bound by operations. It runs FMAs on the float32 (non-tensor) pipes so
// that it meets the float32 reference's 1e-3 gradient bar; tensor cores
// (wgmma, TMA) come later. Tiles: T = 64 queries and keys at C = 64, 128;
// T = 32 at C = 256, where four (64, 257) float tiles would not fit in a
// block's 227 KB of shared memory and pass (b)'s two (T, C) accumulators
// would take 128 registers a thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int LANES = 16;   // threads sharing one tile row (half a warp)
constexpr int ROWS = NT / LANES;  // row groups (16)

template <int C>
__host__ __device__ constexpr int tile() { return C == 256 ? 32 : 64; }

template <int C>
constexpr size_t dq_smem_bytes() {
  constexpr size_t T = tile<C>();
  return sizeof(float) * (4 * T * (C + 1) + T * (T + 1));
}

template <int C>
constexpr size_t dkdm_smem_bytes() {
  constexpr size_t T = tile<C>();
  return sizeof(float) * (4 * T * (C + 1) + 2 * T * (T + 1) + 2 * T);
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows r0 .. r0+T-1 of a (n, C) panel into a (T, C+1) tile, zeros
// beyond row n.
template <int C, int T>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t base, int r0, int n) {
  for (int e = threadIdx.x; e < T * C; e += NT) {
    const int r = e / C, c = e % C;
    dst[r * (C + 1) + c] =
        (r0 + r < n) ? src[base + size_t(r0 + r) * C + c] : 0.f;
  }
}

// Thread t owns tile rows rg + 16*i and columns cg + 16*j, rg = t / 16,
// cg = t % 16, as in the forward kernel. Tile rows are padded by one float,
// so the column walks below read 16 distinct banks.

// Pass (a): dq and D for one (query tile, batch).
template <int C>
__global__ void __launch_bounds__(NT)
attention_bwd_dq_kernel(const float* __restrict__ k,
                        const float* __restrict__ q,
                        const float* __restrict__ m,
                        const float* __restrict__ out,
                        const float* __restrict__ lse,
                        const float* __restrict__ g,
                        float* __restrict__ dq, float* __restrict__ dvec,
                        int n) {
  constexpr int T = tile<C>();
  constexpr int TM = T / ROWS;    // query rows per thread
  constexpr int TS = T / LANES;   // key columns per thread
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int QS = C + 1;
  constexpr int PS = T + 1;

  extern __shared__ float smem[];
  float* qs = smem;               // T x QS queries
  float* gs = qs + T * QS;        // T x QS output gradients
  float* ks = gs + T * QS;        // T x QS keys
  float* ms = ks + T * QS;        // T x QS values
  float* ds = ms + T * QS;        // T x PS dS

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
        part = fmaf(gs[row * QS + cg + 16 * t],
                    out[base + size_t(q0 + row) * C + cg + 16 * t], part);
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
        qv[i] = qs[(rg + ROWS * i) * QS + c];
        gv[i] = gs[(rg + ROWS * i) * QS + c];
      }
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        kv[j] = ks[(cg + LANES * j) * QS + c];
        mv[j] = ms[(cg + LANES * j) * QS + c];
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
        ds[(rg + ROWS * i) * PS + col] = p * (dp[i][j] - dj[i]);
      }
    __syncthreads();

    // dq += dS (T x T) . K (T x C)
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float dv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) dv[i] = ds[(rg + ROWS * i) * PS + kk];
#pragma unroll
      for (int t = 0; t < TN; ++t) kv[t] = ks[kk * QS + cg + LANES * t];
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
      dq[base + size_t(row) * C + cg + LANES * t] = acc[i][t];
  }
}

// Pass (b): dk and dm for one (key tile, batch).
template <int C>
__global__ void __launch_bounds__(NT)
attention_bwd_dkdm_kernel(const float* __restrict__ k,
                          const float* __restrict__ q,
                          const float* __restrict__ m,
                          const float* __restrict__ lse,
                          const float* __restrict__ g,
                          const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dm,
                          int n) {
  constexpr int T = tile<C>();
  constexpr int TM = T / ROWS;    // key rows per thread
  constexpr int TS = T / LANES;   // query columns per thread
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int QS = C + 1;
  constexpr int PS = T + 1;

  extern __shared__ float smem[];
  float* ks = smem;               // T x QS keys
  float* ms = ks + T * QS;        // T x QS values
  float* qs = ms + T * QS;        // T x QS queries
  float* gs = qs + T * QS;        // T x QS output gradients
  float* ps = gs + T * QS;        // T x PS p
  float* ds = ps + T * PS;        // T x PS dS
  float* ls = ds + T * PS;        // T      lse of the query tile
  float* dl = ls + T;             // T      D of the query tile

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
        kv[i] = ks[(rg + ROWS * i) * QS + c];
        mv[i] = ms[(rg + ROWS * i) * QS + c];
      }
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        qv[j] = qs[(cg + LANES * j) * QS + c];
        gv[j] = gs[(cg + LANES * j) * QS + c];
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
        ps[(rg + ROWS * i) * PS + col] = p;
        ds[(rg + ROWS * i) * PS + col] = p * (dp[i][j] - dl[col]);
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
        gv[t] = gs[jj * QS + cg + LANES * t];
        qv[t] = qs[jj * QS + cg + LANES * t];
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
      dk[at] = dk_acc[i][t];
      dm[at] = dm_acc[i][t];
    }
  }
}

template <int C>
cudaError_t launch(const float* k, const float* q, const float* m,
                   const float* out, const float* lse, const float* g,
                   float* dk, float* dq, float* dm, float* dvec, int b, int n,
                   cudaStream_t stream) {
  constexpr size_t smem_a = dq_smem_bytes<C>();
  constexpr size_t smem_b = dkdm_smem_bytes<C>();
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
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_a));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_dkdm_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_b));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  constexpr int T = tile<C>();
  const dim3 grid((n + T - 1) / T, b);
  attention_bwd_dq_kernel<C><<<grid, NT, smem_a, stream>>>(
      k, q, m, out, lse, g, dq, dvec, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdm_kernel<C><<<grid, NT, smem_b, stream>>>(
      k, q, m, lse, g, dvec, dk, dm, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `dvec` is (B, N) float32 scratch that
// pass (a) fills with D for pass (b). Returns a cudaError_t (0 on success);
// allocates nothing and does not synchronize.
extern "C" int hupr_attention_bwd(const void* k, const void* q, const void* m,
                                  const void* out, const void* lse,
                                  const void* g, void* dk, void* dq, void* dm,
                                  void* dvec, int b, int n, int c,
                                  void* stream) {
  const float* kf = static_cast<const float*>(k);
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(m);
  const float* of = static_cast<const float*>(out);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(g);
  float* dkf = static_cast<float*>(dk);
  float* dqf = static_cast<float*>(dq);
  float* dmf = static_cast<float*>(dm);
  float* dvf = static_cast<float*>(dvec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  switch (c) {
    case 64:
      return int(launch<64>(kf, qf, mf, of, lf, gf, dkf, dqf, dmf, dvf, b, n,
                            s));
    case 128:
      return int(launch<128>(kf, qf, mf, of, lf, gf, dkf, dqf, dmf, dvf, b,
                             n, s));
    case 256:
      return int(launch<256>(kf, qf, mf, of, lf, gf, dkf, dqf, dmf, dvf, b,
                             n, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
