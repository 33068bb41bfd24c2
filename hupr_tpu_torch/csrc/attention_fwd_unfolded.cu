// Unfolded forward MSCSA spatial attention for Hopper (sm_90a): the softmax
// is normalized before the product with the values; float32 output.
//
//   a[b, i, j] = softmax_i(k[b, i, :] . q[b, j, :]),
//   out[b, j, :] = sum_i a[b, i, j] * m[b, i, :]
//
// Replaces the TPU kernel of scripts/attn_microbench.py, make_pallas with
// fold=False (the round-1 forward body, kept there as the A/B baseline of
// the production kernel, which folds the 1/s normalization into its
// epilogue): logits, jax.nn.softmax over keys in the (N, qb) panel, then
// a^T m. In two modes:
//   - f32 (attention_fwd_unfolded_tf32): float32 inputs, every product in
//     3xTF32 on warp-level mma.sync m16n8k8 (tf32.cuh), float32's accuracy;
//   - f32_bf16ops (attention_fwd_unfolded_tc, its mxu_bf16 flag): k, q and
//     m bfloat16 (the wrapper rounds the float32 inputs once before the
//     launch: the values the TPU body rounds on load), and the NORMALIZED a
//     rounded to bfloat16 before the product, a rounding point unlike the
//     folded kernel's, whose unnormalized p is rounded; wgmma (hopper.cuh).
// Accumulation and output are float32 in both.
//
// The TPU body holds the whole (N, qb) panel of a query block; at N = 4096
// that is 1 MB for 64 queries, far over a Hopper block's 227 KB. So each
// block (64 queries of one batch) makes two passes over the key tiles and
// never writes an (N, N) array: pass 1 streams K alone and takes each
// query's running max and sum; pass 2 recomputes the logits in the same
// order (so they repeat bit for bit and pass 1's max bounds them), forms
// a = exp2f((s - max) log2 e) / sum, the plain version's order, and adds
// each tile's a.m to the output. A one-pass online softmax would compute
// the folded function (attention_fwd.cu under another name), and under
// bf16_ops the rounding of a needs the final sum before any product. Both
// passes run as one loop of 2 x tiles steps through one two-stage cp.async
// ring: pass 2's first tiles are in flight while pass 1 ends.
//
// Bound: the function needs 4*B*N^2*C flops (the logits and a.m) and
// B*N^2 exps against 16*B*N*C bytes (the float32 inputs read, the output
// written), so it is bound by operations. This body does three
// products (the logits twice) and two sets of exps; the bound counts the
// TPU body's two products and one set, the least work for the function.
//
// The f32 body takes attention_fwd_tf32's design (attention_fwd.cu says
// why each part): four warps of 16 query rows, tile<C>() keys a tile, Q
// staged once, K in tf32.cuh's swizzle and M in its pairs layout, the
// logits summed SC columns at a time from zero and added in float32, a
// kept in registers as A (frag_a_pairs, PairCols), each tile's a.m summed
// apart 8 n-tiles of o at a time and added in float32. The f32_bf16ops
// body takes attention_fwd_tc's: one warpgroup of 64 query rows, 64-key
// tiles in the 128-byte swizzle, S by wgmma from shared memory, a rounded
// once into register A operands (frags), M the MN-major operand; each
// tile's a.m summed apart where the registers allow (promote_tiles).
// Neither divides in its epilogue: a is final.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;  // queries per block

// -------------------------------------------- f32: 3xTF32 on mma.sync

namespace f32 {

constexpr int NT = 128;  // threads per block: 4 warps, 16 query rows each
constexpr int STAGES = 2;

// Keys per tile, as attention_fwd.cu's f32::tile: 64 at C = 64 (80 KB of
// shared memory a block), 32 at C = 128 (96 KB) and C = 256 (192 KB)
template <int C>
__host__ __device__ constexpr int tile() { return C == 64 ? 64 : 32; }

// Columns of C a logits chunk, summed from zero and added in float32
constexpr int SC = 32;

template <int C>
constexpr size_t smem_bytes() {
  return 4 * (size_t(BQ) * C + size_t(STAGES) * 2 * tile<C>() * C);
}

// S (16 x T) = Q.K^T of this warp's rows and the tile at ks, keys past n
// masked to -inf. Both passes call it, so the logits repeat bit for bit.
template <int C>
__device__ __forceinline__ void logits(float (&s)[tile<C>() / 8][4],
                                       const float* qs, const float* ks,
                                       const tf32::Chunks<C>& rq,
                                       const tf32::Chunks<C>& rk, int k0,
                                       int n, int t) {
  constexpr int NS = tile<C>() / 8;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += SC) {
    float part[NS][4] = {};
#pragma unroll
    for (int c = c0; c < c0 + SC; c += 16) {
      tf32::FragA a[2];
      tf32::frags_a2(rq.load(qs, c), rq.load(qs + 8 * C, c), a);
      tf32::FragB b[2][NS];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        tf32::frags_b2(rk.load(ks + 8 * j * C, c), b[0][j], b[1][j]);
      tf32::mma3(part, a[0], b[0]);
      tf32::mma3(part, a[1], b[1]);
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
  // key k0 is always in range, so every row's tile maximum is finite
  if (k0 + tile<C>() > n) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + e % 2 >= n) s[j][e] = -INFINITY;
  }
}

// Warp w owns query rows 16w .. 16w + 15 of the block's 64 (this thread
// rows 16w + g and 16w + g + 8, keys 2t and 2t + 1 of each n-tile of S).
// Steps 0 .. tiles-1 are pass 1 (K only), tiles .. 2 tiles-1 pass 2 (K and
// M), one cp.async group each.
template <int C>
__global__ void __launch_bounds__(NT)
attention_fwd_unfolded_tf32(const float* __restrict__ k,
                            const float* __restrict__ q,
                            const float* __restrict__ m,
                            float* __restrict__ out, int n) {
  constexpr int T = tile<C>(), TILE = T * C;
  constexpr int NS = T / 8;  // n-tiles of S, k-steps of a.M
  constexpr int NO = C / 8;  // n-tiles of o
  constexpr int G = 8;       // n-tiles of o an a.M chain
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ring = qs + BQ * C;  // stage st: K at ring + 2*st*TILE, M next

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = size_t(blockIdx.y) * n * C;
  const int q0 = blockIdx.x * BQ;
  const int tiles = (n + T - 1) / T, steps = 2 * tiles;

  auto fill = [&](int i) {  // step i: K of its key tile, and M in pass 2
    const int kt = i < tiles ? i : i - tiles;
    float* ks = ring + 2 * (i % STAGES) * TILE;
    const size_t at = base + size_t(kt) * TILE;
    tf32::stage_tile<T, C, NT>(ks, k + at, n - kt * T, tid);
    if (i >= tiles)
      tf32::stage_tile<T, C, NT, true>(ks + TILE, m + at, n - kt * T, tid);
  };
  tf32::stage_tile<BQ, C, NT>(qs, q + base + size_t(q0) * C, n - q0, tid);
  fill(0);
  cp_async_commit();
  fill(1);  // steps >= 2
  cp_async_commit();

  const tf32::Chunks<C> rq(16 * warp + g, t), rk(g, t);
  const tf32::PairCols<C> cols(lane);

  // pass 1: this thread's rows 16w + g + 8h: running max, partial sums
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const float* ks = ring + 2 * (i % STAGES) * TILE;
    cp_async_wait<1>();  // step i has landed
    __syncthreads();
    float s[NS][4];
    logits<C>(s, qs, ks, rq, rk, i * T, n, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        tmax = fmaxf(tmax, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float nm = fmaxf(mx[h], tmax);
      sum[h] *= exp2f((mx[h] - nm) * LOG2E);  // 0 on the first tile
      mx[h] = nm;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e)
          sum[h] += exp2f((s[j][e] - nm) * LOG2E);
    }
    __syncthreads();  // every warp is done with this stage
    if (i + STAGES < steps) fill(i + STAGES);
    cp_async_commit();
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    inv[h] = 1.f / sum[h];
  }

  // pass 2: a = exp2f((s - max) log2 e) / sum, then o += a.M, 8 n-tiles of
  // o at a time, each summed over the tile apart
  float o[NO][4] = {};
  for (int i = tiles; i < steps; ++i) {
    const float* ks = ring + 2 * (i % STAGES) * TILE;
    const float* ms = ks + TILE;
    cp_async_wait<1>();
    __syncthreads();
    float s[NS][4];
    logits<C>(s, qs, ks, rq, rk, (i - tiles) * T, n, t);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp2f((s[j][e] - mx[e / 2]) * LOG2E) * inv[e / 2];
#pragma unroll
    for (int j0 = 0; j0 < NO; j0 += G) {
      float pm[G][4] = {};
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const tf32::FragA a = tf32::frag_a_pairs(s[st]);
        tf32::FragB b[G];
#pragma unroll
        for (int j = 0; j < G; ++j)
          b[j] = cols.load(ms, 8 * st, 8 * (j0 + j));
        tf32::mma3(pm, a, b);
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j0 + j][e] += pm[j][e];
    }
    __syncthreads();
    if (i + STAGES < steps) fill(i + STAGES);
    cp_async_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= n) continue;
    float* dst = out + base + size_t(row) * C + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      store2(dst + 8 * j, o[j][2 * h], o[j][2 * h + 1]);
  }
}

template <int C>
cudaError_t launch(const void* k, const void* q, const void* m, void* out,
                   int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_fwd_unfolded_tf32<C>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_unfolded_tf32<C><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(q),
      static_cast<const float*>(m), static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------- f32_bf16ops: wgmma, bf16 operands

namespace tc {

constexpr int NT = 128;  // one warpgroup
constexpr int STAGES = 2;
constexpr int BK = 64;   // keys per tile, wgmma's k-steps of a.M

template <int C>
constexpr size_t smem_bytes() {  // Q, then STAGES x (K, M), + alignment
  return 1024 + size_t(BQ) * C * 2 + size_t(STAGES) * 2 * BK * C * 2;
}

// S (64 x BK) = Q.K^T by wgmma from the tiles at shared addresses qs, ks,
// keys past n masked to -inf. Both passes call it.
template <int C>
__device__ __forceinline__ void logits(float (&s)[BK / 2], uint32_t qs,
                                       uint32_t ks, int k0, int n,
                                       int col0) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wg_arrive();
#pragma unroll
  for (int c = 0; c < C / 16; ++c)
    wgmma_ss_n64(s, desc_k<BQ>(qs, c), desc_k<BK>(ks, c), c > 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  if (k0 + BK > n) {  // zero rows of K; key k0 is in range
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (k0 + 8 * (i / 4) + col0 + i % 2 >= n) s[i] = -INFINITY;
  }
}

// Thread t of the warpgroup (warp w, lane l) owns rows 16w + l/4 + 8r of
// S and o (hopper.cuh, accumulators). Steps as in the f32 body.
template <int C>
__global__ void __launch_bounds__(NT, C == 64 ? 4 : 1)
attention_fwd_unfolded_tc(const bf16* __restrict__ k,
                          const bf16* __restrict__ q,
                          const bf16* __restrict__ m,
                          float* __restrict__ out, int n) {
  constexpr int TILE = BK * C * 2;  // bytes of a Q, K or M tile
  constexpr int PS = BK / 16;       // k-steps of a.M
  static_assert(BK == 64, "mma_regs takes 64-row tiles");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = smem_base_1k(smem_raw);
  const uint32_t ring = qs + TILE;  // stage st: K at ring + 2*st*TILE, M next

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = size_t(blockIdx.y) * n * C;
  const int q0 = blockIdx.x * BQ;
  const int tiles = (n + BK - 1) / BK, steps = 2 * tiles;

  auto fill = [&](int i) {  // step i: K of its key tile, and M in pass 2
    const int kt = i < tiles ? i : i - tiles;
    const uint32_t ks = ring + 2 * (i % STAGES) * TILE;
    const size_t at = base + size_t(kt) * BK * C;
    stage_tile<BK, C, NT>(ks, k + at, n - kt * BK, tid);
    if (i >= tiles) stage_tile<BK, C, NT>(ks + TILE, m + at, n - kt * BK, tid);
  };
  stage_tile<BQ, C, NT>(qs, q + base + size_t(q0) * C, n - q0, tid);
  fill(0);
  cp_async_commit();
  fill(1);  // steps >= 2
  cp_async_commit();

  const int col0 = 2 * (lane % 4);
  // pass 1: this thread's rows: running max, partial sums
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const uint32_t ks = ring + 2 * (i % STAGES) * TILE;
    cp_async_wait<1>();  // step i has landed
    fence_async_smem();
    __syncthreads();
    float s[BK / 2];
    logits<C>(s, qs, ks, i * BK, n, col0);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 2; ++j)
      tmax[(j / 2) % 2] = fmaxf(tmax[(j / 2) % 2], s[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float nm = fmaxf(mx[r], tmax[r]);
      sum[r] *= exp2f((mx[r] - nm) * LOG2E);  // 0 on the first tile
      mx[r] = nm;
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j / 2) % 2;
      sum[r] += exp2f((s[j] - mx[r]) * LOG2E);
    }
    __syncthreads();  // every warp is done with this stage
    if (i + STAGES < steps) fill(i + STAGES);
    cp_async_commit();
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
  }

  // pass 2: a = exp2f((s - max) log2 e) / sum rounded to bf16 once, then
  // o += a.M
  float o[C / 2];
#pragma unroll
  for (int j = 0; j < C / 2; ++j) o[j] = 0.f;
  for (int i = tiles; i < steps; ++i) {
    const uint32_t ks = ring + 2 * (i % STAGES) * TILE, ms = ks + TILE;
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    float s[BK / 2];
    logits<C>(s, qs, ks, (i - tiles) * BK, n, col0);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int r = (j / 2) % 2;
      s[j] = exp2f((s[j] - mx[r]) * LOG2E) * inv[r];
    }
    uint32_t a[1][PS][4];
    frags<BK, 1>(s, a);
    if constexpr (promote_tiles<C>()) {  // o += this tile's a.M, in float32
      float pm[C / 2];
#pragma unroll
      for (int j = 0; j < C / 2; ++j) pm[j] = 0.f;
      mma_regs<C>(pm, a, ms);
#pragma unroll
      for (int j = 0; j < C / 2; ++j) o[j] += pm[j];
    } else {
      mma_regs<C>(o, a, ms);
    }
    __syncthreads();
    if (i + STAGES < steps) fill(i + STAGES);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= n) continue;
    float* dst = out + base + size_t(row) * C + col0;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      store2(dst + 8 * j, o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
  }
}

template <int C>
cudaError_t launch(const void* k, const void* q, const void* m, void* out,
                   int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_fwd_unfolded_tc<C>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_unfolded_tc<C><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(q),
      static_cast<const bf16*>(m), static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // namespace tc

template <int C>
cudaError_t launch(bool bf16_ops, const void* k, const void* q,
                   const void* m, void* out, int b, int n, cudaStream_t s) {
  return bf16_ops ? tc::launch<C>(k, q, m, out, b, n, s)
                  : f32::launch<C>(k, q, m, out, b, n, s);
}

}  // namespace

// Plain C entry point for ctypes, the folded entry point's contract
// (attention_fwd.cu) in modes f32 and f32_bf16ops: `in_bf16` must be 0;
// with `bf16_ops` k, q and m are bfloat16 (the wrapper rounds the float32
// inputs before the launch), else float32; out is float32. k, q and m sit
// on 16-byte boundaries. Returns a cudaError_t (0 on success); allocates
// nothing and does not synchronize.
extern "C" int hupr_attention_fwd_unfolded(const void* k, const void* q,
                                           const void* m, void* out, int b,
                                           int n, int c, int in_bf16,
                                           int bf16_ops, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0 || in_bf16) return int(cudaErrorInvalidValue);
  switch (c) {
    case 64: return int(launch<64>(bf16_ops, k, q, m, out, b, n, s));
    case 128: return int(launch<128>(bf16_ops, k, q, m, out, b, n, s));
    case 256: return int(launch<256>(bf16_ops, k, q, m, out, b, n, s));
    default: return int(cudaErrorInvalidValue);
  }
}
