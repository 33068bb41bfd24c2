// Forward MSCSA spatial attention for Hopper (sm_90a).
//
//   out[b, j, :] = sum_i softmax_i(k[b, i, :] . q[b, j, :]) * m[b, i, :]
//
// Softmax over the KEY axis i for each query j, with no 1/sqrt(C) scale, on
// contiguous (B, N, C) tensors. When `lse` is not null the kernel also
// writes each query's log-sum-exp of its logits,
// lse[b, j] = max_i s_ij + log(sum_i exp(s_ij - max_i s_ij)), (B, N) float32
// in every mode: the residual the backward kernel (attention_bwd.cu) reads
// instead of recomputing the softmax statistics. Serving passes null and
// does the same work as without it.
//
// Replaces the TPU kernel hupr_tpu/ops/attention.py:_attention_fwd_pallas
// (body _make_attn_kernel), in its four modes (ops/attention.kernel_mode):
//   - f32: float32 inputs and output, float32 arithmetic;
//   - bf16 (MODEL.computeDtype bfloat16): bfloat16 inputs and output; the
//     logits are bf16 x bf16 products summed in float32, p stays float32
//     and p.m runs on its float32 values;
//   - f32_bf16ops and bf16_bf16ops (the mxu_bf16 branch, MODEL.attention
//     pallas_bf16): k, q and m rounded to bfloat16 (the wrapper casts
//     float32 inputs once before the launch: the values the TPU kernel
//     rounds on load), p rounded to bfloat16 before p.m, the row sum and the
//     1/s epilogue float32, out in the mode's float32 or bfloat16. p is
//     rounded against the running maximum of the online softmax, where the
//     TPU kernel rounds it against the final one: a difference at
//     bfloat16's rounding level.
// That kernel keeps whole (N, C) K and M panels in VMEM; at N = 4096, C = 64
// one panel is 1 MB, far over the 227 KB a Hopper block can address. So
// both bodies here stream key tiles through shared memory with an online
// softmax: running max, running sum and a (64, C) float32 accumulator per
// query tile, divided once at the end.
//
// Bound: 4*B*N^2*C flops and B*N^2 exps against 16*B*N*C bytes (8*B*N*C in
// bfloat16), so it is bound by operations: the tensor cores in every mode
// (each float32 product counts three times in 3xTF32, below), with the
// SFU's exps close behind at C = 64 in the bf16 modes.
//
// The bf16 modes (attention_fwd_tc) run on the tensor cores. One warpgroup
// (128 threads) owns 64 query rows, wgmma's M. Per 64-key tile:
// S = Q.K^T is wgmma m64n64k16 from shared memory (Q and K K-major); the
// online softmax runs on S's accumulator in registers (row reductions are
// two shuffles across the four lanes of a row; the row sums stay partial
// per lane until the epilogue); P goes back into wgmma m64nCk16 as the
// register A operand, and M is the MN-major B operand. Mode bf16 keeps p
// float32: it is fed as two bf16 operands, hi = bf16(p) and lo = bf16(p -
// hi), into the same accumulator (residual about 2^-17 of p). At C <= 128
// each tile's p.m is summed apart and added to the rescaled running sum in
// float32 (hopper.cuh, promote_tiles). p = exp2f((s - max) log2 e), the
// difference first, as the twin's softmax takes it. Tiles arrive through a
// two-stage ring filled by cp.async 16-byte copies (rows >= n zero-filled,
// and their keys masked to -inf); the next tile's copies fly while this
// one is computed. No TMA and no warp specialisation: at 41 to
// 164 KB of shared memory a block, four (C = 64, registers capped at 128 a
// thread for it) to one (C = 256) blocks share an SM, so one block's
// softmax overlaps another's products without a producer warp. The grid
// is one block per 64 queries: at (N, C) = (256, 256) that is 4 x B blocks
// (80 in training, 128 serving) on 132 SMs, so the card is not full there;
// a call at that shape is a few microseconds of work, and splitting it
// (column halves of C, each recomputing S) is left for later.
//
// The f32 mode (attention_fwd_tf32) runs on the tensor cores in 3xTF32
// (tf32.cuh): each float32 operand is split into hi and lo tf32 terms at
// fragment load, and each product is lo.hi + hi.lo + hi.hi into one float32
// accumulator, which keeps float32's accuracy. Warp-level mma.sync
// m16n8k8, not wgmma: wgmma's tf32 takes only K-major operands, and p.m
// contracts over the rows of M. Four warps own 64 query rows, 16 each (the
// m of m16n8k8), and stream key tiles (64 keys at C = 64, 32 at C = 128 and
// 256: tile() says why) through the same two-stage cp.async ring. Per
// tile, each warp takes S = Q.K^T with two k-steps from each 16-byte load
// (Q's fragments are split on every load: holding them split in registers
// at C = 64 took as long), the online softmax on S's accumulator (rows g
// and g + 8 of the warp, keys 2t and 2t + 1 of each n-tile; row reductions
// over lanes 1 and 2), and o += P.M with P never leaving the registers: the
// accumulator's key pairs (2t, 2t + 1) are not m16n8k8's A layout (t,
// t + 4), but a product summed over k in another order is the same
// product, so A takes key 2t as its k = t and key 2t + 1 as k = t + 4, and
// M's B fragment reads rows 2t and 2t + 1 of the tile (tf32.cuh,
// frag_a_pairs and PairCols). M is staged in its own swizzle (the pairs
// layout), which makes those column reads free of bank conflicts; K's key
// would leave them 2-way conflicted. Every float32 sum on the tensor cores
// runs in short chains from zero, added in float32 (the kernel says why):
// the logits 32 columns of C at a time, P.M one tile and 8 n-tiles at a
// time. p = exp2f((s - max) log2 e), as in the bf16 modes. The grid is one
// block per 64 queries, as in the bf16 modes (not grown at (256, 256), where
// the card is already under-filled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile of the bf16 modes

// -------------------------------------------- f32: 3xTF32 on mma.sync

namespace f32 {

constexpr int NT = 128;  // threads per block: 4 warps, 16 query rows each
constexpr int STAGES = 2;

// Keys per tile: 64 at C = 64 (80 KB of shared memory a block); 32 at
// C = 128 (96 KB), where 64 would take 160 KB and leave one block of four
// warps an SM, and at C = 256 (192 KB), where 64 would not fit 227 KB
template <int C>
__host__ __device__ constexpr int tile() { return C == 64 ? 64 : 32; }

// Columns of C a logits chunk: each chunk's products are summed from zero
// and added to the logits in float32 (below)
constexpr int SC = 32;

template <int C>
constexpr size_t smem_bytes() {
  return 4 * (size_t(BQ) * C + size_t(STAGES) * 2 * tile<C>() * C);
}

// Warp w owns query rows 16w .. 16w + 15 of the block's 64. Per key tile:
// S (16 x T) = Q.K^T, the online softmax on S's accumulator in registers,
// then o (16 x C) += P.M with P's A fragments taken from those registers.
// The tensor cores' float32 sums do not round to nearest (hopper.cuh,
// promote_tiles), and the logits feed exp: chaining all of C's 3C/8
// products into one accumulator left outputs up to 1.1e-4 from the plain
// version at (B, N, C) = (32, 256, 256) on N(0, 1) inputs (logits near
// 60) on an H100, past the float32 bar. So every sum runs in short chains
// from zero, added in float32: the logits SC columns at a time, and P.M
// one tile and 8 n-tiles of o at a time.
template <int C>
__global__ void __launch_bounds__(NT)
attention_fwd_tf32(const float* __restrict__ k, const float* __restrict__ q,
                   const float* __restrict__ m, float* __restrict__ out,
                   float* __restrict__ lse, int n) {
  constexpr int T = tile<C>(), TILE = T * C;
  constexpr int NS = T / 8;  // n-tiles of S, k-steps of P.M
  constexpr int NO = C / 8;  // n-tiles of o
  constexpr int G = 8;       // n-tiles of o a P.M chain
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ring = qs + BQ * C;  // stage st: K at ring + 2*st*TILE, M next

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t base = size_t(blockIdx.y) * n * C;
  const int q0 = blockIdx.x * BQ;
  const int tiles = (n + T - 1) / T;

  auto fill = [&](int i) {  // K and M of key tile i into its stage
    float* ks = ring + 2 * (i % STAGES) * TILE;
    const size_t at = base + size_t(i) * TILE;
    tf32::stage_tile<T, C, NT>(ks, k + at, n - i * T, tid);
    tf32::stage_tile<T, C, NT, true>(ks + TILE, m + at, n - i * T, tid);
  };
  tf32::stage_tile<BQ, C, NT>(qs, q + base + size_t(q0) * C, n - q0, tid);
  fill(0);
  cp_async_commit();
  if (tiles > 1) fill(1);
  cp_async_commit();  // one group per tile, empty past the last

  // rows 16w + g (and 8 further, the same swizzle key) of Q; rows g + 8j of
  // K; the keys 2t, 2t + 1 of M
  const tf32::Chunks<C> rq(16 * warp + g, t), rk(g, t);
  const tf32::PairCols<C> cols(lane);

  float o[NO][4] = {};
  // this thread's rows 16w + g + 8h: running max, partial sums
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};

  for (int i = 0; i < tiles; ++i) {
    const float* ks = ring + 2 * (i % STAGES) * TILE;
    const float* ms = ks + TILE;
    const int k0 = i * T;
    cp_async_wait<1>();  // tile i has landed
    __syncthreads();

    // S = Q.K^T, two k-steps from each 16-byte load, SC columns a chain
    float s[NS][4] = {};
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

    // online softmax; keys past n (zero rows of K) masked to -inf, and key
    // k0 is always in range, so every row's tile maximum is finite
    if (k0 + T > n) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + e % 2 >= n) s[j][e] = -INFINITY;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        tmax = fmaxf(tmax, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float nm = fmaxf(mx[h], tmax);
      alpha[h] = exp2f((mx[h] - nm) * LOG2E);  // 0 on the first tile
      mx[h] = nm;
      sum[h] *= alpha[h];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f((s[j][e] - nm) * LOG2E);
          sum[h] += s[j][e];  // the sum takes p as computed
        }
    }

    // o = alpha o + P.M, 8 n-tiles of o at a time, each summed over the tile
    // apart; P's A fragments from the accumulator pairs (tf32.cuh,
    // frag_a_pairs)
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
        for (int e = 0; e < 4; ++e)
          o[j0 + j][e] = fmaf(o[j0 + j][e], alpha[e / 2], pm[j][e]);
    }

    __syncthreads();  // every warp is done with this stage
    if (i + STAGES < tiles) fill(i + STAGES);
    cp_async_commit();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= n) continue;
    float* dst = out + base + size_t(row) * C + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      store2(dst + 8 * j, o[j][2 * h] / sum[h], o[j][2 * h + 1] / sum[h]);
    if (lse != nullptr && t == 0)
      lse[size_t(blockIdx.y) * n + row] = mx[h] + logf(sum[h]);
  }
}

template <int C>
cudaError_t launch(const void* k, const void* q, const void* m, void* out,
                   float* lse, int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_fwd_tf32<C>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_tf32<C><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(q),
      static_cast<const float*>(m), static_cast<float*>(out), lse, n);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------- bf16 modes: tensor cores

namespace tc {

constexpr int NT = 128;  // one warpgroup
constexpr int STAGES = 2;

template <int C>
constexpr size_t smem_bytes() {  // Q, then STAGES x (K, M), + alignment
  return 1024 + size_t(BQ) * C * 2 + size_t(STAGES) * 2 * BK * C * 2;
}

// Out: the output's element type (float under f32_bf16ops). OPS: p rounded
// to bf16 once (the mxu_bf16 modes); else fed in bf16 terms (mode bf16).
template <int C, typename Out, bool OPS>
__global__ void __launch_bounds__(NT, C == 64 ? 4 : 1)
attention_fwd_tc(const bf16* __restrict__ k, const bf16* __restrict__ q,
                 const bf16* __restrict__ m, Out* __restrict__ out,
                 float* __restrict__ lse, int n) {
  constexpr int TILE = BK * C * 2;  // bytes of a Q, K or M tile
  constexpr int KS = C / 16;        // k-steps of the logits
  constexpr int PS = BK / 16;       // k-steps of p.m
  static_assert(BK == 64, "mma_regs takes 64-row tiles");
  constexpr int TERMS = OPS ? 1 : 2;  // p's bfloat16 terms (hopper.cuh)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = smem_base_1k(smem_raw);
  const uint32_t ring = qs + TILE;  // stage st: K at ring + 2*st*TILE, M next

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t base = size_t(blockIdx.y) * n * C;
  const int q0 = blockIdx.x * BQ;
  const int tiles = (n + BK - 1) / BK;

  auto fill = [&](int t) {  // K and M of key tile t into its stage
    const uint32_t ks = ring + 2 * (t % STAGES) * TILE;
    const size_t at = base + size_t(t) * BK * C;
    stage_tile<BK, C, NT>(ks, k + at, n - t * BK, tid);
    stage_tile<BK, C, NT>(ks + TILE, m + at, n - t * BK, tid);
  };
  stage_tile<BQ, C, NT>(qs, q + base + size_t(q0) * C, n - q0, tid);
  fill(0);
  cp_async_commit();
  if (tiles > 1) fill(1);
  cp_async_commit();  // one group per tile, empty past the last

  float o[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
  // this thread's rows 16*warp + lane/4 + 8r: running max, partial sums
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  const int col0 = 2 * (lane % 4);

  for (int t = 0; t < tiles; ++t) {
    const uint32_t ks = ring + 2 * (t % STAGES) * TILE, ms = ks + TILE;
    const int k0 = t * BK;
    cp_async_wait<1>();  // tile t has landed
    fence_async_smem();
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_arrive();
#pragma unroll
    for (int c = 0; c < KS; ++c)
      wgmma_ss_n64(s, desc_k<BQ>(qs, c), desc_k<BK>(ks, c), c > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    if (k0 + BK > n) {  // keys past n: zero rows of K, masked here
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (k0 + 8 * (i / 4) + col0 + i % 2 >= n) s[i] = -INFINITY;
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      tmax[(i / 2) % 2] = fmaxf(tmax[(i / 2) % 2], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float nm = fmaxf(mx[r], tmax[r]);  // finite: key k0 < n
      alpha[r] = exp2f((mx[r] - nm) * LOG2E);  // 0 on the first tile
      mx[r] = nm;
      sum[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      s[i] = exp2f((s[i] - mx[r]) * LOG2E);
      sum[r] += s[i];  // the sum takes p as computed
    }
    uint32_t a[TERMS][PS][4];
    frags<BK, TERMS>(s, a);
    if constexpr (promote_tiles<C>()) {  // o = alpha o + this tile's p.m
      float pm[C / 2];
#pragma unroll
      for (int i = 0; i < C / 2; ++i) pm[i] = 0.f;
      mma_regs<C>(pm, a, ms);
#pragma unroll
      for (int i = 0; i < C / 2; ++i)
        o[i] = fmaf(o[i], alpha[(i / 2) % 2], pm[i]);
    } else {
#pragma unroll
      for (int i = 0; i < C / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      mma_regs<C>(o, a, ms);
    }

    __syncthreads();  // every warp is done with this stage
    if (t + STAGES < tiles) fill(t + STAGES);
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= n) continue;
    Out* dst = out + base + size_t(row) * C + col0;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      store2(dst + 8 * j, o[4 * j + 2 * r] / sum[r],
             o[4 * j + 2 * r + 1] / sum[r]);
    if (lse != nullptr && lane % 4 == 0)
      lse[size_t(blockIdx.y) * n + row] = mx[r] + logf(sum[r]);
  }
}

template <int C, typename Out, bool OPS>
cudaError_t launch(const void* k, const void* q, const void* m, void* out,
                   float* lse, int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_fwd_tc<C, Out, OPS>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_tc<C, Out, OPS><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(q),
      static_cast<const bf16*>(m), static_cast<Out*>(out), lse, n);
  return cudaGetLastError();
}

}  // namespace tc

template <typename Out, bool OPS>
cudaError_t dispatch_tc(const void* k, const void* q, const void* m,
                        void* out, float* lse, int b, int n, int c,
                        cudaStream_t s) {
  switch (c) {
    case 64: return tc::launch<64, Out, OPS>(k, q, m, out, lse, b, n, s);
    case 128: return tc::launch<128, Out, OPS>(k, q, m, out, lse, b, n, s);
    case 256: return tc::launch<256, Out, OPS>(k, q, m, out, lse, b, n, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(const void* k, const void* q, const void* m,
                        void* out, float* lse, int b, int n, int c,
                        cudaStream_t s) {
  switch (c) {
    case 64: return f32::launch<64>(k, q, m, out, lse, b, n, s);
    case 128: return f32::launch<128>(k, q, m, out, lse, b, n, s);
    case 256: return f32::launch<256>(k, q, m, out, lse, b, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. `in_bf16` and `bf16_ops` name the mode:
// (0, 0) f32, everything float32; (1, 0) bf16, everything bfloat16;
// (0, 1) f32_bf16ops and (1, 1) bf16_bf16ops, where k, q and m are
// bfloat16 (the wrapper rounds float32 inputs before the launch) and out is
// float32 or bfloat16 as `in_bf16` says. `lse` (float32) may be null. The
// tensor-core modes take k, q and m on 16-byte boundaries. Returns a
// cudaError_t (0 on success); allocates nothing and does not synchronize.
extern "C" int hupr_attention_fwd(const void* k, const void* q, const void* m,
                                  void* out, void* lse, int b, int n, int c,
                                  int in_bf16, int bf16_ops, void* stream) {
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return int(cudaErrorInvalidValue);
  if (!bf16_ops)
    return int(in_bf16 ? dispatch_tc<bf16, false>(k, q, m, out, lf, b, n, c, s)
                       : dispatch_f32(k, q, m, out, lf, b, n, c, s));
  return int(in_bf16 ? dispatch_tc<bf16, true>(k, q, m, out, lf, b, n, c, s)
                     : dispatch_tc<float, true>(k, q, m, out, lf, b, n, c, s));
}
