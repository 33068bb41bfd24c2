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
// in every mode. Mode bf16's p and dS are float32, so each of its dm, dk and
// dq products counts twice (two bf16 operands, below); in mode f32 every
// product counts three times (3xTF32, below).
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
// The f32 mode (the _tf32 kernels) runs on the tensor cores in 3xTF32
// (tf32.cuh): each float32 operand is split into hi and lo tf32 terms at
// fragment load, and each product is lo.hi + hi.lo + hi.hi into one float32
// accumulator, which keeps float32's accuracy. Warp-level mma.sync
// m16n8k8, not wgmma: wgmma's tf32 takes only K-major operands, and three
// of the five products contract over the rows of a row-major tile
// (dq += dS.K, dm += p^T.G, dk += dS^T.Q); mma.sync loads its fragments
// thread by thread, so one swizzled float tile serves both orientations
// without a transposed copy. T rows a tile (64 at C = 64, 128; 32 at
// C = 256, for the six (T, C) float tiles to fit 227 KB), 8 warps a block
// in both passes, each warp a 16-row block of every product:
//   (a) S = Q.K^T and dP = G.M^T, two k-steps from each 16-byte load;
//       p = exp2f((s - lse) log2 e) and dS = p (dP - D) in float32
//       registers; dS to a (T, T) shared tile, then dq += dS.K.
//   (b) S^T = K.Q^T and dP^T = M.G^T; p^T and dS^T to two shared tiles;
//       dm += p^T.G, then dk += dS^T.Q, each warp holding its rows of both
//       accumulators (at most 64 registers a thread; no need to split the
//       warps between dm and dk). Each query's lse and D sit side by side,
//       one 16-byte load for two queries.
// p = exp2f of the difference, as in the bf16 modes: cheaper than expf,
// and the same errors against the plain version. p and dS go through
// shared memory because the m16n8 accumulator layout is not the m16n8k8
// A-fragment layout; feeding them from registers by shuffles is left for
// later. Each tile's second product is summed apart and added to the
// running sum in float32, as in the bf16 modes. Tiles arrive through
// two-stage rings of cp.async 16-byte copies (rows >= n zero-filled; keys
// and queries >= n contribute p = 0); k, q, m and g on 16-byte boundaries.
// No atomics: a run repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

// -------------------------------------------- f32: 3xTF32 on mma.sync

namespace f32 {

constexpr int NT = 256;  // threads per block: 8 warps
constexpr int STAGES = 2;

// Rows of every tile, queries and keys: six (T, C) float tiles (two fixed,
// two streamed in two stages) fit a block's 227 KB at T = 64 up to
// C = 128, and at T = 32 at C = 256
template <int C>
__host__ __device__ constexpr int tile() { return C == 256 ? 32 : 64; }

// the (T, C) tiles, then (T, T) dS (pass a) or p^T and dS^T (pass b), then
// the lse and D vectors (pass b: one pair per stage)
template <int C>
constexpr size_t dq_smem_bytes() {
  constexpr size_t T = tile<C>();
  return 4 * ((2 + 2 * STAGES) * T * C + T * T + 2 * T);
}
template <int C>
constexpr size_t dkdm_smem_bytes() {
  constexpr size_t T = tile<C>();
  return 4 * ((2 + 2 * STAGES) * T * C + 2 * T * T + STAGES * 2 * T);
}

// The 8 warps tile each (T, .) product WM x WN: warp w owns rows
// 16 (w % WM) and the (w / WM)-th of WN column blocks, in n-tiles of 8
template <int C>
struct Warps {
  static constexpr int T = tile<C>();
  static constexpr int WM = T / 16, WN = NT / 32 / WM;
  static constexpr int NS = T / (8 * WN);  // n-tiles of S and dP
  static constexpr int NO = C / (8 * WN);  // n-tiles of a gradient
};

// acc += X.Y for the warp's 16 rows at r0 and NO n-tiles at o0, X (T, T)
// stored [m][k], Y (T, C) stored [k][n]. The tile is summed apart and
// added to the running sum in float32: the tensor cores' float32
// accumulation does not round to nearest (hopper.cuh, promote_tiles), and
// chaining every tile of a row (1,536 mma.sync at N = 4096) would bias the
// sums; 24 a tile from zero do not.
template <int C>
__device__ __forceinline__ void accumulate(float (&acc)[Warps<C>::NO][4],
                                           const float* x, const float* y,
                                           int r0, int o0, int lane) {
  constexpr int T = tile<C>(), NO = Warps<C>::NO;
  float part[NO][4] = {};
#pragma unroll
  for (int kk = 0; kk < T; kk += 8) {
    const tf32::FragA a = tf32::load_a<T>(x, r0, kk, lane);
    tf32::FragB b[NO];
#pragma unroll
    for (int j = 0; j < NO; ++j)
      b[j] = tf32::load_b_mn<C>(y, kk, o0 + 8 * j, lane);
    tf32::mma3(part, a, b);
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// s += X.Y^T and dp += Z.V^T over C for the warp's 16 rows at r0 and NS
// n-tiles at s0: X, Z (T, C) and Y, V (T, C), all stored [row][C]; two
// k-steps from each 16-byte load
template <int C>
__device__ __forceinline__ void logits(float (&s)[Warps<C>::NS][4],
                                       float (&dp)[Warps<C>::NS][4],
                                       const float* x, const float* y,
                                       const float* z, const float* v,
                                       int r0, int s0, int lane) {
  constexpr int NS = Warps<C>::NS;
  const int g = lane >> 2, t = lane & 3;
  const tf32::Chunks<C> ra(r0 + g, t), rb(r0 + g + 8, t);
  tf32::Chunks<C> rn[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) rn[j] = tf32::Chunks<C>(s0 + 8 * j + g, t);
#pragma unroll
  for (int c = 0; c < C; c += 16) {
    tf32::FragA ax[2], az[2];
    tf32::frags_a2(ra.load(x, c), rb.load(x, c), ax);
    tf32::frags_a2(ra.load(z, c), rb.load(z, c), az);
    tf32::FragB by[2][NS], bv[2][NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      tf32::frags_b2(rn[j].load(y, c), by[0][j], by[1][j]);
      tf32::frags_b2(rn[j].load(v, c), bv[0][j], bv[1][j]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tf32::mma3(s, ax[h], by[h]);
      tf32::mma3(dp, az[h], bv[h]);
    }
  }
}

// The warp's (16, NO n-tiles) block of a gradient, rows >= n skipped
template <int C>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[Warps<C>::NO][4],
                                           int row0, int o0, int n,
                                           int lane) {
  const int gr = lane / 4, col0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + gr + 8 * h;
    if (row >= n) continue;
    float* p = dst + size_t(row) * C + o0 + col0;
#pragma unroll
    for (int j = 0; j < Warps<C>::NO; ++j)
      store2(p + 8 * j, acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// Pass (a): dq and D for one (query tile, batch).
template <int C>
__global__ void __launch_bounds__(NT, 1)
attention_bwd_dq_tf32(const float* __restrict__ k,
                      const float* __restrict__ q,
                      const float* __restrict__ m,
                      const float* __restrict__ out,
                      const float* __restrict__ lse,
                      const float* __restrict__ g,
                      float* __restrict__ dq, float* __restrict__ dvec,
                      int n) {
  using W = Warps<C>;
  constexpr int T = W::T, TILE = T * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = qs + TILE;
  float* ring = gs + TILE;  // stage st: K at ring + 2*st*TILE, M next
  float* ds = ring + 2 * STAGES * TILE;  // (T, T) dS
  float* vec = ds + T * T;               // lse and D of the query tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * (warp % W::WM);           // the warp's query rows
  const int s0 = (T / W::WN) * (warp / W::WM);  // its keys in S
  const int o0 = (C / W::WN) * (warp / W::WM);  // its columns of dq
  const size_t base = size_t(blockIdx.y) * n * C;
  const size_t vbase = size_t(blockIdx.y) * n;
  const int q0 = blockIdx.x * T;
  const int tiles = (n + T - 1) / T;

  auto fill = [&](int t) {  // K and M of key tile t into its stage
    float* ks = ring + 2 * (t % STAGES) * TILE;
    const size_t at = base + size_t(t) * TILE;
    tf32::stage_tile<T, C, NT>(ks, k + at, n - t * T, tid);
    tf32::stage_tile<T, C, NT>(ks + TILE, m + at, n - t * T, tid);
  };
  tf32::stage_tile<T, C, NT>(qs, q + base + size_t(q0) * C, n - q0, tid);
  tf32::stage_tile<T, C, NT>(gs, g + base + size_t(q0) * C, n - q0, tid);
  fill(0);
  cp_async_commit();
  if (tiles > 1) fill(1);
  cp_async_commit();  // one group per tile, empty past the last

  {  // D_j = g_j . out_j: NT / T neighbouring threads a row
    constexpr int RT = NT / T;
    const int r = tid / RT, row = q0 + r;
    float part = 0.f;
    if (row < n) {
      const size_t at = base + size_t(row) * C;
      for (int c = tid % RT; c < C; c += RT)
        part = fmaf(g[at + c], out[at + c], part);
    }
#pragma unroll
    for (int off = RT / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tid % RT == 0) {
      vec[r] = row < n ? lse[vbase + row] : 0.f;
      vec[T + r] = part;
      if (row < n) dvec[vbase + row] = part;
    }
  }
  __syncthreads();
  const int gr = lane / 4, col0 = 2 * (lane % 4);
  float lj[2], dj[2];  // of rows r0 + gr + 8h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lj[h] = vec[r0 + gr + 8 * h];
    dj[h] = vec[T + r0 + gr + 8 * h];
  }

  float acc[W::NO][4] = {};
  for (int t = 0; t < tiles; ++t) {
    const float* ks = ring + 2 * (t % STAGES) * TILE;
    const int k0 = t * T;
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    float s[W::NS][4] = {}, dp[W::NS][4] = {};
    logits<C>(s, dp, qs, ks, gs, ks + TILE, r0, s0, lane);  // Q.K^T, G.M^T
    // dS = p (dP - D); keys beyond n contribute nothing
#pragma unroll
    for (int j = 0; j < W::NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = s0 + 8 * j + col0;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e] - lj[h];
          const float p = k0 + col + e < n ? exp2f(x * LOG2E) : 0.f;
          v[e] = p * (dp[j][2 * h + e] - dj[h]);
        }
        tf32::store2<T>(ds, r0 + gr + 8 * h, col, v[0], v[1]);
      }
    __syncthreads();
    accumulate<C>(acc, ds, ks, r0, o0, lane);  // dq += dS.K

    __syncthreads();  // every warp is done with this stage and dS
    if (t + STAGES < tiles) fill(t + STAGES);
    cp_async_commit();
  }
  store_rows<C>(dq + base, acc, q0 + r0, o0, n, lane);
}

// Pass (b): dk and dm for one (key tile, batch).
template <int C>
__global__ void __launch_bounds__(NT, 1)
attention_bwd_dkdm_tf32(const float* __restrict__ k,
                        const float* __restrict__ q,
                        const float* __restrict__ m,
                        const float* __restrict__ lse,
                        const float* __restrict__ g,
                        const float* __restrict__ dvec,
                        float* __restrict__ dk, float* __restrict__ dm,
                        int n) {
  using W = Warps<C>;
  constexpr int T = W::T, TILE = T * C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kt = reinterpret_cast<float*>(smem_raw);
  float* mt = kt + TILE;
  float* ring = mt + TILE;  // stage st: Q at ring + 2*st*TILE, G next
  float* ps = ring + 2 * STAGES * TILE;  // (T, T) p^T
  float* ds = ps + T * T;                // (T, T) dS^T
  float* vec = ds + T * T;  // stage st's (lse, D) pairs at vec + 2*T*st

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * (warp % W::WM);           // the warp's key rows
  const int s0 = (T / W::WN) * (warp / W::WM);  // its queries in S^T
  const int o0 = (C / W::WN) * (warp / W::WM);  // its columns of dk, dm
  const size_t base = size_t(blockIdx.y) * n * C;
  const size_t vbase = size_t(blockIdx.y) * n;
  const int i0 = blockIdx.x * T;
  const int tiles = (n + T - 1) / T;

  auto fill = [&](int t) {  // Q and G of query tile t into its stage
    float* qs = ring + 2 * (t % STAGES) * TILE;
    const size_t at = base + size_t(t) * TILE;
    tf32::stage_tile<T, C, NT>(qs, q + at, n - t * T, tid);
    tf32::stage_tile<T, C, NT>(qs + TILE, g + at, n - t * T, tid);
  };
  tf32::stage_tile<T, C, NT>(kt, k + base + size_t(i0) * C, n - i0, tid);
  tf32::stage_tile<T, C, NT>(mt, m + base + size_t(i0) * C, n - i0, tid);
  fill(0);
  cp_async_commit();
  if (tiles > 1) fill(1);
  cp_async_commit();  // one group per tile, empty past the last

  const int gr = lane / 4, col0 = 2 * (lane % 4);
  float dm_acc[W::NO][4] = {}, dk_acc[W::NO][4] = {};
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, j0 = t * T;
    const float* qs = ring + 2 * st * TILE;
    const float* gs = qs + TILE;
    float* lv = vec + 2 * T * st;
    if (tid < 2 * T) {  // this stage's (lse, D) pairs; read two tiles ago
      const int j = tid / 2;
      const bool ok = j0 + j < n;
      lv[tid] = ok ? (tid % 2 ? dvec : lse)[vbase + j0 + j] : 0.f;
    }
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    float s[W::NS][4] = {}, dp[W::NS][4] = {};
    logits<C>(s, dp, kt, qs, mt, gs, r0, s0, lane);  // K.Q^T, M.G^T
    // p^T and dS^T; queries beyond n contribute nothing
#pragma unroll
    for (int j = 0; j < W::NS; ++j) {
      const int col = s0 + 8 * j + col0;
      // (lse, D) of queries col and col + 1
      const float4 ld = *reinterpret_cast<const float4*>(lv + 2 * col);
      const float l[2] = {ld.x, ld.z}, d[2] = {ld.y, ld.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e] - l[e];
          p[e] = j0 + col + e < n ? exp2f(x * LOG2E) : 0.f;
          v[e] = p[e] * (dp[j][2 * h + e] - d[e]);
        }
        tf32::store2<T>(ps, r0 + gr + 8 * h, col, p[0], p[1]);
        tf32::store2<T>(ds, r0 + gr + 8 * h, col, v[0], v[1]);
      }
    }
    __syncthreads();
    accumulate<C>(dm_acc, ps, gs, r0, o0, lane);  // dm += p^T.G
    accumulate<C>(dk_acc, ds, qs, r0, o0, lane);  // dk += dS^T.Q

    __syncthreads();  // every warp is done with this stage, p^T and dS^T
    if (t + STAGES < tiles) fill(t + STAGES);
    cp_async_commit();
  }
  store_rows<C>(dk + base, dk_acc, i0 + r0, o0, n, lane);
  store_rows<C>(dm + base, dm_acc, i0 + r0, o0, n, lane);
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
  cudaError_t err = allow_smem<attention_bwd_dq_tf32<C>>(smem_a);
  if (err != cudaSuccess) return err;
  err = allow_smem<attention_bwd_dkdm_tf32<C>>(smem_b);
  if (err != cudaSuccess) return err;
  const float* kt = static_cast<const float*>(k);
  const float* qt = static_cast<const float*>(q);
  const float* mt = static_cast<const float*>(m);
  const float* gt = static_cast<const float*>(g);
  constexpr int T = tile<C>();
  const dim3 grid((n + T - 1) / T, b);
  attention_bwd_dq_tf32<C><<<grid, NT, smem_a, stream>>>(
      kt, qt, mt, static_cast<const float*>(out), lse, gt,
      static_cast<float*>(dq), dvec, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdm_tf32<C><<<grid, NT, smem_b, stream>>>(
      kt, qt, mt, lse, gt, dvec, static_cast<float*>(dk),
      static_cast<float*>(dm), n);
  return cudaGetLastError();
}

}  // namespace f32

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

cudaError_t dispatch_f32(const void* k, const void* q, const void* m,
                         const void* out, const float* lse, const void* g,
                         void* dk, void* dq, void* dm, float* dvec, int b,
                         int n, int c, cudaStream_t s) {
  switch (c) {
    case 64:
      return f32::launch<64>(k, q, m, out, lse, g, dk, dq, dm, dvec, b, n, s);
    case 128:
      return f32::launch<128>(k, q, m, out, lse, g, dk, dq, dm, dvec, b, n,
                              s);
    case 256:
      return f32::launch<256>(k, q, m, out, lse, g, dk, dq, dm, dvec, b, n,
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
// pass (a) fills with D for pass (b). Every mode takes k, q, m and g on
// 16-byte boundaries. Returns a cudaError_t (0 on success);
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
                       : dispatch_f32(k, q, m, out, lf, g, dk, dq, dm, dvf,
                                      b, n, c, s));
  return int(in_bf16 ? dispatch_tc<bf16, true>(k, q, m, out, lf, g, dk, dq,
                                               dm, dvf, b, n, c, s)
                     : dispatch_tc<float, true>(k, q, m, out, lf, g, dk, dq,
                                                dm, dvf, b, n, c, s));
}
