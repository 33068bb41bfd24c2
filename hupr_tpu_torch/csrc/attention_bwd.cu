// Backward MSCSA spatial attention for Hopper (sm_90a).
//
// The forward (attention_fwd.cu) computes, per batch b and query j,
//   s_ij = k_i . q_j,   p_ij = exp(s_ij - lse_j),   out_j = sum_i p_ij m_i
// (softmax over the KEY axis i, no scale). Given g = dLoss/dout, this
// kernel computes
//   dm_i  = sum_j p_ij g_j
//   dP_ij = m_i . g_j,   D_j = g_j . out_j  (= sum_i p_ij dP_ij)
//   dS_ij = p_ij (dP_ij - D_j)
//   dq_j  = sum_i dS_ij k_i,   dk_i = sum_j dS_ij q_j
// on contiguous (B, N, C) tensors, with lse (B, N) float32 from the forward.
// dq, dk and dm are accumulated in float32 registers over every tile and
// written in the mode's output type, rounded once; the D vector is float32
// in every mode.
//
// Replaces the TPU kernel hupr_tpu/ops/attention.py:_attention_bwd_pallas
// (body _make_bwd_kernel). Same algebra: with a = p/s there, t/s is dS and
// its c_j is D_j. That kernel walks the q-blocks of a batch in order on one
// core and carries dk and dm in its resident output block from one grid
// step to the next. Hopper blocks run in parallel and in no order, so the
// carry cannot be copied; atomics would make the sums' order, and so the
// result, change from run to run. This kernel runs two passes instead, each
// block owning what it writes, so that a run repeats bit for bit:
//   (a) one block per (query tile, batch): D_j once, then stream key tiles;
//       accumulate dq_j. Writes dq and D (B, N) for pass (b).
//   (b) one block per (key tile, batch): stream query tiles with their lse
//       and D; accumulate dk_i and dm_i.
// Both recompute s and dP per tile pair and never write an (N, N) array.
// Since each block owns the rows it writes and sums them over all tiles in
// float32 registers, the gradients are rounded once at the end, the
// property the TPU kernel gets from its float32 outputs (its _bwd casts dk
// and dm once).
//
// Modes (ops/attention.kernel_mode), those of the TPU kernel: f32; bf16
// (MODEL.computeDtype bfloat16), bfloat16 inputs and outputs with p and dS
// kept float32; and the mxu_bf16 branch (MODEL.attention pallas_bf16):
// k, q, m and g rounded to bfloat16 (the wrapper casts float32 inputs once
// before the launch), p and dS rounded to bfloat16 before the dm, dk and dq
// products, outputs float32 (f32_bf16ops) or bfloat16 (bf16_bf16ops). The
// TPU kernel also rounds 1/s and the products q/s and g/s to bfloat16; here
// the normalization rides on p = exp(s - lse) in float32. And it sums D_j
// from its float32 p and dP, where this kernel takes g_j . out_j from the
// forward's out, which bfloat16 outputs round to bfloat16. Both are
// differences at bfloat16's rounding level.
//
// Bound: 10*B*N^2*C flops (5 products) and 2*B*N^2 exps against 32*B*N*C
// bytes (half in bfloat16), so it is bound by operations: the tensor cores
// in the bf16 modes. Mode bf16's p and dS are float32, so each of its dm,
// dk and dq products counts twice (two bf16 operands, below).
//
// The bf16 modes (the _tc kernels) run on the tensor cores, as the forward
// does (attention_fwd.cu; the building blocks are in hopper.cuh), on 64-row
// tiles at every C:
//   (a) one warpgroup per 64 query rows: S = Q.K^T and dP = G.M^T by wgmma
//       m64n64k16 from shared memory; p = exp(S - lse) and dS = p (dP - D)
//       in registers; dq += dS.K with dS as the register A operand and K as
//       the MN-major B operand.
//   (b) two warpgroups per 64 key rows, one for dm and one for dk, since
//       the two (64, C) float32 accumulators together would need 256
//       registers a thread at C = 256 (128 at C = 128, with S and dP on top).
//       Warpgroup 0: S^T = K.Q^T, p^T, dm += p^T.G. Warpgroup 1: S^T and
//       dP^T = M.G^T, dS^T, dk += dS^T.Q. G and Q are MN-major B operands.
//       Both recompute S^T: 8 products of 2*N^2*C flops a batch in all,
//       against the TPU kernel's 5; the grid holds B*N/64 blocks per pass.
//       At C = 64 registers are capped at 128 a thread, so that two blocks
//       share an SM (one at 139-148 registers took 1.4x the time).
// Mode bf16 feeds its float32 p and dS as two bf16 operands, hi = bf16(x)
// and lo = bf16(x - hi), into the same accumulator (residual about 2^-17
// of x), so the twin's rounding points hold; under bf16_ops they are
// rounded once, where the twin rounds them. p = exp2f((s - lse) log2 e):
// the difference taken first, as the twin's exp(s - lse) takes it, so that
// p, and where it is rounded its bfloat16 value, stays close to the twin's
// (folding lse into one FMA loses up to 5e-7 of p). Each tile's second
// product is summed apart and added to the running sum in float32
// (hopper.cuh, promote_tiles). Tiles arrive through two-stage rings filled
// by cp.async 16-byte copies (rows >= n zero-filled; keys and queries >= n
// contribute p = 0). No atomics: a run repeats bit for bit.
//
// The f32 mode (the _simt kernels) keeps the float32 FMA body: T = 64 queries
// and keys at C = 64, 128, T = 32 at C = 256, where four (64, 257) float
// tiles would not fit in a block's 227 KB and pass (b)'s two (T, C)
// accumulators would take 128 registers a thread; rows padded by one float.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------ f32: FMAs

namespace simt {

constexpr int NT = 256;     // threads per block
constexpr int LANES = 16;   // threads sharing one tile row (half a warp)
constexpr int ROWS = NT / LANES;  // row groups (16)

template <int C>
__host__ __device__ constexpr int tile() { return C == 256 ? 32 : 64; }

template <int C>
constexpr size_t dq_smem_bytes() {
  constexpr size_t T = tile<C>();
  return sizeof(float) * (T * (T + 1) + 4 * T * (C + 1));
}

template <int C>
constexpr size_t dkdm_smem_bytes() {
  constexpr size_t T = tile<C>();
  return sizeof(float) * (2 * T * (T + 1) + 2 * T + 4 * T * (C + 1));
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows r0 .. r0+T-1 of a (n, C) panel into a (T, C + 1) tile, zeros
// beyond row n.
template <int C, int T>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      size_t base, int r0, int n) {
  constexpr int QS = C + 1;
  for (int e = threadIdx.x; e < T * C; e += NT) {
    const int r = e / C, c = e % C;
    dst[r * QS + c] = (r0 + r < n) ? src[base + size_t(r0 + r) * C + c] : 0.f;
  }
}

// Thread t owns tile rows rg + 16*i and columns cg + 16*j, rg = t / 16,
// cg = t % 16, as in the forward kernel. Tile rows are padded, so the
// column walks below read 16 distinct banks.

// Pass (a): dq and D for one (query tile, batch).
template <int C>
__global__ void __launch_bounds__(NT)
attention_bwd_dq_simt(const float* __restrict__ k,
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

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ds = reinterpret_cast<float*>(smem_raw);   // T x PS dS
  float* qs = ds + T * PS;        // T x QS queries
  float* gs = qs + T * QS;        // T x QS output gradients
  float* ks = gs + T * QS;        // T x QS keys
  float* ms = ks + T * QS;        // T x QS values

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
attention_bwd_dkdm_simt(const float* __restrict__ k,
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

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);   // T x PS p
  float* ds = ps + T * PS;        // T x PS dS
  float* ls = ds + T * PS;        // T      lse of the query tile
  float* dl = ls + T;             // T      D of the query tile
  float* ks = dl + T;             // T x QS keys
  float* ms = ks + T * QS;        // T x QS values
  float* qs = ms + T * QS;        // T x QS queries
  float* gs = qs + T * QS;        // T x QS output gradients

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
cudaError_t launch(const void* k, const void* q, const void* m,
                   const void* out, const float* lse, const void* g,
                   void* dk, void* dq, void* dm, float* dvec, int b, int n,
                   cudaStream_t stream) {
  constexpr size_t smem_a = dq_smem_bytes<C>();
  constexpr size_t smem_b = dkdm_smem_bytes<C>();
  static_assert(smem_a <= 232448 && smem_b <= 232448,
                "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_bwd_dq_simt<C>>(smem_a);
  if (err != cudaSuccess) return err;
  err = allow_smem<attention_bwd_dkdm_simt<C>>(smem_b);
  if (err != cudaSuccess) return err;
  const float* kt = static_cast<const float*>(k);
  const float* qt = static_cast<const float*>(q);
  const float* mt = static_cast<const float*>(m);
  const float* gt = static_cast<const float*>(g);
  constexpr int T = tile<C>();
  const dim3 grid((n + T - 1) / T, b);
  attention_bwd_dq_simt<C><<<grid, NT, smem_a, stream>>>(
      kt, qt, mt, static_cast<const float*>(out), lse, gt,
      static_cast<float*>(dq), dvec, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdm_simt<C><<<grid, NT, smem_b, stream>>>(
      kt, qt, mt, lse, gt, dvec, static_cast<float*>(dk),
      static_cast<float*>(dm), n);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------- bf16 modes: tensor cores

namespace tc {

constexpr int T = 64;  // rows of every tile: wgmma's M, and the keys of S
constexpr int STAGES = 2;

template <int C>
__host__ __device__ constexpr int tile_bytes() { return T * C * 2; }

// 1024 bytes of alignment, two fixed tiles, STAGES x two streamed tiles,
// and (pass b) the streamed tiles' lse and D
template <int C>
constexpr size_t dq_smem_bytes() {
  return 1024 + size_t(2 + 2 * STAGES) * tile_bytes<C>() + 2 * T * 4;
}
template <int C>
constexpr size_t dkdm_smem_bytes() {
  return 1024 + size_t(2 + 2 * STAGES) * tile_bytes<C>() +
         STAGES * 2 * T * 4;
}

// acc += A.B for one tile (hopper.cuh, mma_regs), the tile summed apart
// first where promote_tiles allows.
template <int C, int TERMS>
__device__ __forceinline__ void accumulate(float (&acc)[C / 2],
                                           uint32_t (&a)[TERMS][T / 16][4],
                                           uint32_t b) {
  if constexpr (promote_tiles<C>()) {
    float part[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) part[i] = 0.f;
    mma_regs<C>(part, a, b);
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] += part[i];
  } else {
    mma_regs<C>(acc, a, b);
  }
}

// p and dS in bfloat16 terms: once under bf16_ops, else two (hi + lo)
template <bool OPS>
__host__ __device__ constexpr int terms() { return OPS ? 1 : 2; }

// Pass (a): dq and D for one (query tile, batch); one warpgroup. Out: the
// type of out and dq. OPS: dS rounded to bf16 once; else fed as hi + lo.
template <int C, typename Out, bool OPS>
__global__ void __launch_bounds__(128, 1)
attention_bwd_dq_tc(const bf16* __restrict__ k, const bf16* __restrict__ q,
                    const bf16* __restrict__ m, const Out* __restrict__ out,
                    const float* __restrict__ lse,
                    const bf16* __restrict__ g, Out* __restrict__ dq,
                    float* __restrict__ dvec, int n) {
  constexpr int NT = 128;
  constexpr int TILE = tile_bytes<C>();
  constexpr int KS = C / 16;  // k-steps of S and dP
  constexpr int PS = T / 16;  // k-steps of dS.K
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = smem_base_1k(smem_raw), gs = qs + TILE;
  const uint32_t ring = gs + TILE;  // stage st: K at ring + 2*st*TILE, M next
  float* vec = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw))
                                        + 2 * STAGES * TILE);  // lse, D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = size_t(blockIdx.y) * n * C;
  const size_t vbase = size_t(blockIdx.y) * n;
  const int q0 = blockIdx.x * T;
  const int tiles = (n + T - 1) / T;

  auto fill = [&](int t) {  // K and M of key tile t into its stage
    const uint32_t ks = ring + 2 * (t % STAGES) * TILE;
    const size_t at = base + size_t(t) * T * C;
    stage_tile<T, C, NT>(ks, k + at, n - t * T, tid);
    stage_tile<T, C, NT>(ks + TILE, m + at, n - t * T, tid);
  };
  stage_tile<T, C, NT>(qs, q + base + size_t(q0) * C, n - q0, tid);
  stage_tile<T, C, NT>(gs, g + base + size_t(q0) * C, n - q0, tid);
  fill(0);
  cp_async_commit();
  if (tiles > 1) fill(1);
  cp_async_commit();  // one group per tile, empty past the last

  {  // D_j = g_j . out_j: two threads a row, half of C each
    const int r = tid / 2, row = q0 + r;
    float part = 0.f;
    if (row < n) {
      const size_t at = base + size_t(row) * C + (tid % 2) * (C / 2);
      for (int c = 0; c < C / 2; ++c)
        part = fmaf(to_f32(g[at + c]), to_f32(out[at + c]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (tid % 2 == 0) {
      vec[r] = row < n ? lse[vbase + row] : 0.f;
      vec[T + r] = part;
      if (row < n) dvec[vbase + row] = part;
    }
  }
  __syncthreads();
  // this thread's rows 16*warp + lane/4 + 8r, their lse and D
  float lj[2], dj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + lane / 4 + 8 * r;
    lj[r] = vec[row];
    dj[r] = vec[T + row];
  }
  const int col0 = 2 * (lane % 4);

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const uint32_t ks = ring + 2 * (t % STAGES) * TILE, ms = ks + TILE;
    const int k0 = t * T;
    cp_async_wait<1>();  // tile t has landed
    fence_async_smem();
    __syncthreads();

    float s[T / 2], dp[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_arrive();
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      wgmma_ss_n64(s, desc_k<T>(qs, c), desc_k<T>(ks, c), c > 0);
      wgmma_ss_n64(dp, desc_k<T>(gs, c), desc_k<T>(ms, c), c > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = p (dP - D) in s; keys beyond n contribute nothing
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const int r = (i / 2) % 2;
      const bool ok = k0 + 8 * (i / 4) + col0 + i % 2 < n;
      const float p = ok ? exp2f((s[i] - lj[r]) * LOG2E) : 0.f;
      s[i] = p * (dp[i] - dj[r]);
    }
    uint32_t a[terms<OPS>()][PS][4];
    frags<T, terms<OPS>()>(s, a);
    accumulate<C>(acc, a, ks);  // dq += dS.K

    __syncthreads();  // every warp is done with this stage
    if (t + STAGES < tiles) fill(t + STAGES);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= n) continue;
    Out* dst = dq + base + size_t(row) * C + col0;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      store2(dst + 8 * j, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// Pass (b): dm (warpgroup 0) and dk (warpgroup 1) for one (key tile,
// batch).
template <int C, typename Out, bool OPS>
__global__ void __launch_bounds__(256, C == 64 ? 2 : 1)
attention_bwd_dkdm_tc(const bf16* __restrict__ k, const bf16* __restrict__ q,
                      const bf16* __restrict__ m,
                      const float* __restrict__ lse,
                      const bf16* __restrict__ g,
                      const float* __restrict__ dvec, Out* __restrict__ dk,
                      Out* __restrict__ dm, int n) {
  constexpr int NT = 256;
  constexpr int TILE = tile_bytes<C>();
  constexpr int KS = C / 16;  // k-steps of S^T and dP^T
  constexpr int PS = T / 16;  // k-steps of the second products
  extern __shared__ unsigned char smem_raw[];
  const uint32_t kt = smem_base_1k(smem_raw), mt = kt + TILE;
  const uint32_t ring = mt + TILE;  // stage st: Q at ring + 2*st*TILE, G next
  float* vec = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw))
                                        + 2 * STAGES * TILE);
  // stage st's lse at vec + 2*T*st, its D at T more

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const size_t base = size_t(blockIdx.y) * n * C;
  const size_t vbase = size_t(blockIdx.y) * n;
  const int i0 = blockIdx.x * T;
  const int tiles = (n + T - 1) / T;

  auto fill = [&](int t) {  // Q and G of query tile t into its stage
    const uint32_t qs = ring + 2 * (t % STAGES) * TILE;
    const size_t at = base + size_t(t) * T * C;
    stage_tile<T, C, NT>(qs, q + at, n - t * T, tid);
    stage_tile<T, C, NT>(qs + TILE, g + at, n - t * T, tid);
  };
  stage_tile<T, C, NT>(kt, k + base + size_t(i0) * C, n - i0, tid);
  stage_tile<T, C, NT>(mt, m + base + size_t(i0) * C, n - i0, tid);
  fill(0);
  cp_async_commit();
  if (tiles > 1) fill(1);
  cp_async_commit();  // one group per tile, empty past the last

  const int col0 = 2 * (lane % 4);
  float acc[C / 2];  // dm in warpgroup 0, dk in warpgroup 1
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, j0 = t * T;
    const uint32_t qs = ring + 2 * st * TILE, gs = qs + TILE;
    float* lv = vec + 2 * T * st;
    if (tid < 2 * T) {  // this stage's lse and D; read two tiles ago
      const int j = tid % T;
      const bool ok = j0 + j < n;
      lv[tid] = ok ? (tid < T ? lse : dvec)[vbase + j0 + j] : 0.f;
    }
    cp_async_wait<1>();  // tile t has landed
    fence_async_smem();
    __syncthreads();

    float s[T / 2], dp[T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_arrive();
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      wgmma_ss_n64(s, desc_k<T>(kt, c), desc_k<T>(qs, c), c > 0);
      if (wg == 1)
        wgmma_ss_n64(dp, desc_k<T>(mt, c), desc_k<T>(gs, c), c > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p^T (warpgroup 0) or dS^T (warpgroup 1) in s; queries beyond n
    // contribute nothing
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const int col = 8 * (i / 4) + col0 + i % 2;
      const float p = j0 + col < n ? exp2f((s[i] - lv[col]) * LOG2E) : 0.f;
      s[i] = wg == 0 ? p : p * (dp[i] - lv[T + col]);
    }
    uint32_t a[terms<OPS>()][PS][4];
    frags<T, terms<OPS>()>(s, a);
    accumulate<C>(acc, a, wg == 0 ? gs : qs);  // dm += p^T.G, dk += dS^T.Q

    __syncthreads();  // every warp is done with this stage
    if (t + STAGES < tiles) fill(t + STAGES);
    cp_async_commit();
  }

  Out* dst_base = wg == 0 ? dm : dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= n) continue;
    Out* dst = dst_base + base + size_t(row) * C + col0;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      store2(dst + 8 * j, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int C, typename Out, bool OPS>
cudaError_t launch(const void* k, const void* q, const void* m,
                   const void* out, const float* lse, const void* g,
                   void* dk, void* dq, void* dm, float* dvec, int b, int n,
                   cudaStream_t stream) {
  constexpr size_t smem_a = dq_smem_bytes<C>();
  constexpr size_t smem_b = dkdm_smem_bytes<C>();
  static_assert(smem_a <= 232448 && smem_b <= 232448,
                "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_bwd_dq_tc<C, Out, OPS>>(smem_a);
  if (err != cudaSuccess) return err;
  err = allow_smem<attention_bwd_dkdm_tc<C, Out, OPS>>(smem_b);
  if (err != cudaSuccess) return err;
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* mt = static_cast<const bf16*>(m);
  const bf16* gt = static_cast<const bf16*>(g);
  const dim3 grid((n + T - 1) / T, b);
  attention_bwd_dq_tc<C, Out, OPS><<<grid, 128, smem_a, stream>>>(
      kt, qt, mt, static_cast<const Out*>(out), lse, gt,
      static_cast<Out*>(dq), dvec, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdm_tc<C, Out, OPS><<<grid, 256, smem_b, stream>>>(
      kt, qt, mt, lse, gt, dvec, static_cast<Out*>(dk), static_cast<Out*>(dm),
      n);
  return cudaGetLastError();
}

}  // namespace tc

template <typename Out, bool OPS>
cudaError_t dispatch_tc(const void* k, const void* q, const void* m,
                        const void* out, const float* lse, const void* g,
                        void* dk, void* dq, void* dm, float* dvec, int b,
                        int n, int c, cudaStream_t s) {
  switch (c) {
    case 64:
      return tc::launch<64, Out, OPS>(k, q, m, out, lse, g, dk, dq, dm, dvec,
                                      b, n, s);
    case 128:
      return tc::launch<128, Out, OPS>(k, q, m, out, lse, g, dk, dq, dm,
                                       dvec, b, n, s);
    case 256:
      return tc::launch<256, Out, OPS>(k, q, m, out, lse, g, dk, dq, dm,
                                       dvec, b, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_simt(const void* k, const void* q, const void* m,
                          const void* out, const float* lse, const void* g,
                          void* dk, void* dq, void* dm, float* dvec, int b,
                          int n, int c, cudaStream_t s) {
  switch (c) {
    case 64:
      return simt::launch<64>(k, q, m, out, lse, g, dk, dq, dm, dvec, b, n, s);
    case 128:
      return simt::launch<128>(k, q, m, out, lse, g, dk, dq, dm, dvec, b, n,
                               s);
    case 256:
      return simt::launch<256>(k, q, m, out, lse, g, dk, dq, dm, dvec, b, n,
                               s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. `in_bf16` and `bf16_ops` name the mode:
// (0, 0) f32, everything float32; (1, 0) bf16, everything bfloat16;
// (0, 1) f32_bf16ops and (1, 1) bf16_bf16ops, where k, q, m and g are
// bfloat16 (the wrapper rounds float32 inputs before the launch) and out,
// dk, dq and dm are float32 or bfloat16 as `in_bf16` says. `lse` is the
// forward's (B, N) float32 residual and `dvec` (B, N) float32 scratch that
// pass (a) fills with D for pass (b). The tensor-core modes take k, q, m
// and g on 16-byte boundaries. Returns a cudaError_t (0 on success);
// allocates nothing and does not synchronize.
extern "C" int hupr_attention_bwd(const void* k, const void* q, const void* m,
                                  const void* out, const void* lse,
                                  const void* g, void* dk, void* dq, void* dm,
                                  void* dvec, int b, int n, int c,
                                  int in_bf16, int bf16_ops, void* stream) {
  const float* lf = static_cast<const float*>(lse);
  float* dvf = static_cast<float*>(dvec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  if (!bf16_ops)
    return int(in_bf16 ? dispatch_tc<bf16, false>(k, q, m, out, lf, g, dk, dq,
                                                  dm, dvf, b, n, c, s)
                       : dispatch_simt(k, q, m, out, lf, g, dk, dq, dm, dvf,
                                       b, n, c, s));
  return int(in_bf16 ? dispatch_tc<bf16, true>(k, q, m, out, lf, g, dk, dq,
                                               dm, dvf, b, n, c, s)
                     : dispatch_tc<float, true>(k, q, m, out, lf, g, dk, dq,
                                                dm, dvf, b, n, c, s));
}
