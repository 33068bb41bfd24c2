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
// both bodies here stream 64-key tiles through shared memory with an online
// softmax: running max, running sum and a (64, C) float32 accumulator per
// query tile, divided once at the end.
//
// Bound: 4*B*N^2*C flops and B*N^2 exps against 16*B*N*C bytes (8*B*N*C in
// bfloat16), so it is bound by operations: the tensor cores in the bf16
// modes, with the SFU's exps close behind at C = 64.
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
// The f32 mode (attention_fwd_simt) keeps the float32 FMA body: a (64, C)
// query tile per 256 threads, float32 tiles padded by one float so that the
// column walks read 16 distinct banks, P through shared memory. Its next
// body is the backward's (attention_bwd.cu, the _tf32 kernels): 3xTF32 on
// mma.sync (wgmma's tf32 takes only K-major operands, and p.m contracts
// over M's rows), from tf32.cuh's swizzled float tiles, splits, fragment
// loads and mma3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64;  // queries per block
constexpr int BK = 64;  // keys per tile

// ------------------------------------------------------------ f32: FMAs

namespace simt {

constexpr int NT = 256;     // threads per block
constexpr int LANES = 16;   // threads sharing one query row (half a warp)
constexpr int TM = BQ / (NT / LANES);  // query rows per thread (4)

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (BK + 1) + size_t(BQ) * (C + 1) +
                          size_t(BK) * (C + 1) + size_t(BK) * C);
}

// Thread t owns query rows rg + 16*i (i < TM) and columns cg + 16*j, with
// rg = t / 16 and cg = t % 16. The 16 threads of a row are one half-warp,
// so row reductions are xor-shuffles within it.
template <int C>
__global__ void __launch_bounds__(NT)
attention_fwd_simt(const float* __restrict__ k, const float* __restrict__ q,
                   const float* __restrict__ m, float* __restrict__ out,
                   float* __restrict__ lse, int n) {
  constexpr int TN = C / LANES;   // output columns per thread
  constexpr int TS = BK / LANES;  // logit columns per thread
  constexpr int QS = C + 1;       // padded row stride of Q and K
  constexpr int PS = BK + 1;      // padded row stride of the P tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);   // BQ x PS
  float* qs = ps + BQ * PS;                          // BQ x QS
  float* ks = qs + BQ * QS;                          // BK x QS
  float* ms = ks + BK * QS;                          // BK x C

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
cudaError_t launch(const void* k, const void* q, const void* m, void* out,
                   float* lse, int b, int n, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  static_assert(smem <= 232448, "tile exceeds a Hopper block's shared memory");
  cudaError_t err = allow_smem<attention_fwd_simt<C>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BQ - 1) / BQ, b);
  attention_fwd_simt<C><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(q),
      static_cast<const float*>(m), static_cast<float*>(out), lse, n);
  return cudaGetLastError();
}

}  // namespace simt

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

cudaError_t dispatch_simt(const void* k, const void* q, const void* m,
                         void* out, float* lse, int b, int n, int c,
                         cudaStream_t s) {
  switch (c) {
    case 64: return simt::launch<64>(k, q, m, out, lse, b, n, s);
    case 128: return simt::launch<128>(k, q, m, out, lse, b, n, s);
    case 256: return simt::launch<256>(k, q, m, out, lse, b, n, s);
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
                       : dispatch_simt(k, q, m, out, lf, b, n, c, s));
  return int(in_bf16 ? dispatch_tc<bf16, true>(k, q, m, out, lf, b, n, c, s)
                     : dispatch_tc<float, true>(k, q, m, out, lf, b, n, c, s));
}
