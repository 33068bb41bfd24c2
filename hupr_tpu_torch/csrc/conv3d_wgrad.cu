// Weight gradient of a 3-D convolution, 3x3x3 kernel, stride 1, zero
// padding 1 (SAME), float32, for Hopper (sm_90a): the Encoder3Ds'
// convolutions in training.
//
//   dw[o, c, dz, dy, dx] = sum_{b, z, y, x} g[b, o, z, y, x]
//                          * in[b, c, z + dz - 1, y + dy - 1, x + dx - 1]
//
// on contiguous NCDHW input and output gradient g, into a contiguous
// (Cout, Cin, 3, 3, 3) dw; input outside the volume reads as zero.
//
// It replaces no TPU kernel: XLA ran these convolutions' gradients on the
// TPU. It was added because cuDNN runs float32 3-D weight gradients with
// TF32 off on the FFMA pipes (wgrad2d_grouped_direct_kernel,
// wgrad_alg1_nd_float_engine, sm80_xmma_wgrad_implicit_gemm_indexed) at
// about 9 TFLOP/s, the largest block of a float32 train step.
//
// Bound. A GEMM of M = 27 Cin, N = Cout, K = B*D*H*W voxels: at the widest
// shape at batch 20, (20, 64, 8, 64, 64) with 64 output channels, 2*M*N*K =
// 145 GFLOP, 0.88 ms in 3xTF32 at 495/3 = 165 TFLOP/s, against 0.34 GB of
// input and output gradient, 0.10 ms at 3.35 TB/s: the operations bound it.
// A body on warp-level mma.sync reached 46 TFLOP/s here (26 % of the
// bound); mma.sync alone stops near 321 TFLOP/s of TF32 products, so the
// products are wgmma's, as in conv3d_fprop.cu.
//
// 3xTF32 as conv3d_fprop.cu takes it (tf32.cuh): each float32 operand
// split into hi and lo tf32 terms, each product lo.hi + hi.lo + hi.hi into
// a float32 accumulator. The tensor cores' float32 sums do not round to
// nearest, and K runs to 655,360 voxels at batch 20, so the sum is taken
// in three levels, each short: chains of 8 k-steps (64 voxels, 24 wgmma)
// from zero in the tensor cores, each chain added to the block's float32
// accumulator by an FADD, and the blocks' partial sums over their share of
// the voxels written to a workspace, one slice a split, which the wrapper
// (ops/conv.conv3d_wgrad) adds with torch's sum, a reduction in a fixed
// order. No atomics: the same inputs give the same bits on every call.
//
// Why the input is A. wgmma's tf32 operands in shared memory are both
// K-major (tf32 has no transpose bit), and K is the voxels. The output
// gradient's rows run along the voxels in NCDHW, so it is B as it lies in
// memory: N = 64 output channels of a chain's 64 voxels. The input enters
// at 27 shifts, and a shift of one or two columns breaks the 16-byte
// alignment a descriptor needs, so it is A, from registers: each warp loads
// its fragment from the staged input patch at the tap's offset and splits it
// into hi and lo there, as conv3d_fprop.cu does. (The other way round, the
// output gradient as A, would need 27 shifted K-major copies of the patch.)
//
// Design. A block owns 16 input channels x 27 taps (M: 7 m64 tiles of 16
// channels x 4 taps, the 28th tap slot empty) by 64 output channels (N) of
// dw, and a run of consecutive voxel tiles (its split). Three warpgroups:
// two consumers and a producer; setmaxnreg gives the producer's threads 56
// registers and the consumers' 224. Warp w of m64 tile m takes tap 4m + w,
// its rows g and g + 8 input channels g and g + 8. Consumer warpgroup wg
// takes tiles 4wg .. 4wg + 2 whole and columns 32wg .. 32wg + 31 of tile 3
// (m64n32k8), so the two do equal work; a thread holds 3 x 32 + 16
// accumulators of dw, two chains' 32 and two k-steps' fragments. The
// producer keeps two rings full, each stage signalled by an mbarrier:
//   - the input patch of the 16 channels over a voxel tile (2 depths x 128
//     / W rows x W columns) with its halo, by cp.async, laid out as in
//     conv3d_fprop.cu (columns 4 .. W + 3 of a W + 8 wide row, columns 3 and
//     W + 4 zeros written once, rows outside the volume zero-filled) with a
//     channel stride of 4 mod 8 floats, so lane (g, t)'s fragment reads at
//     (channel g, voxel t) hit 32 banks. Each staged value serves all 27
//     taps: tap (dz, dy, dx) reads the patch at an offset of dz planes, dy
//     rows and dx columns. Two stages;
//   - the output gradient of the 64 channels over one chain (64 voxels of
//     one depth, contiguous in memory), read by the producer's threads,
//     split into hi and lo terms in registers and stored in hopper.cuh's
//     128-byte swizzle that the wgmma descriptor names (k-steps 0-7 the hi
//     terms, 8-15 the lo terms, 4 panels of 64 rows x 128 bytes, 32 KB);
//     voxels outside the volume are zeros, so a ragged tile adds nothing.
//     Each staged value serves the block's 448 rows. Two stages.
// A chain is one tile's 8 k-steps, per k-step A_lo.B_hi, A_hi.B_lo, then
// A_hi.B_hi, committed as one group; the next k-step's fragments are loaded
// and split while it runs, once the group before has retired. A warpgroup's
// four chains of a stage run back to back in two sets of registers, each
// added to its accumulator while the next runs; the stage is released when
// its last chain has retired. Blocks of one split and all channel chunks
// are adjacent in the grid, so the output gradient and the patches they
// share are read from L2. The epilogue goes through shared memory, so each
// block writes its (64, 16, 27) share of the workspace in whole rows.
// Shared memory: 2 x 32 KB of output gradient and 2 x 60-72 KB of patch,
// 190-214 KB: one block an SM; 384 threads. The wrapper
// (ops/conv.wgrad_split) gives each block as many tiles as fit the grid in
// WGRAD_WAVES = 1 wave of the card's SMs. On the H100 SXM it runs at 60-66 %
// of the bound at the Encoder3D shapes at B = 20 (PERF.md, section 6).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr int NC = 256;      // consumer threads: two warpgroups
constexpr int NP = 128;      // producer threads: one warpgroup
constexpr int NT = NC + NP;
// registers a thread after setmaxnreg (conv3d_fprop.cu's split): 3 x 168
// at launch, 56 + 2 x 224 after
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int BCO = 64;      // output channels a block: wgmma's N
constexpr int CB = 16;       // input channels a block
constexpr int TAPS = 27;
constexpr int FULL = 3;      // whole m64 tiles a consumer warpgroup
constexpr int BV = 256;      // voxels a tile
constexpr int CHAIN = 8;     // k-steps a chain of tensor-core sums
constexpr int CHAINS = BV / (8 * CHAIN);  // 4 a tile, 2 a depth
// an output-gradient stage: k-steps 0-7 the hi terms of a chain, 8-15 the
// lo terms, in 128-byte panels of 4 k-steps
constexpr int GSTAGE = 4 * BCO * 128;  // bytes
constexpr int GSTAGES = 2;
constexpr int PSTAGES = 2;
// the epilogue's row of one output channel: 16 channels x 27 taps, padded
// to 4 mod 16 floats so that lane (g, t)'s stores hit 32 banks
constexpr int OS = CB * TAPS + 4;

// The smallest n' >= n with n' = 4 mod 8: then g * n' (g < 8) are distinct
// multiples of 4 modulo 32 banks, and a stride stays 16-byte whole
__host__ __device__ constexpr int bank_pad(int n) {
  return n + ((4 - n % 8) + 8) % 8;
}

// Tile geometry at width W: TD depths x TH rows x W columns of voxels, CR
// rows a chain
template <int W>
struct Geo {
  static_assert(W == 8 || W == 16 || W == 32 || W == 64, "width");
  static constexpr int TD = 2;
  static constexpr int TH = BV / (TD * W);   // 16, 8, 4, 2 rows
  static constexpr int CR = 8 * CHAIN / W;   // 8, 4, 2, 1 rows
  static constexpr int PW = W + 8;           // patch row: cols 4 .. W + 3
  static constexpr int PROWS = (TD + 2) * (TH + 2);
  static constexpr int PLANE = (TH + 2) * PW;
  static constexpr int CS = bank_pad((TD + 2) * PLANE);
  static constexpr int PATCH = CB * CS;      // floats
  // output-gradient stages, patch stages, then the mbarriers, from a
  // 1024-byte boundary
  static constexpr int BARS = GSTAGES * GSTAGE + PSTAGES * PATCH * 4;
  static constexpr size_t SMEM =
      1024 + BARS + 8 * (2 * GSTAGES + 2 * PSTAGES);
  static_assert(TH == 2 * CR, "two chains a depth");
  static_assert(BCO * OS * 4 <= BARS, "the epilogue fits in the stages");
  static_assert(SMEM <= 232448, "exceeds a Hopper block's shared memory");
};

// The voxel tile `tile` of the grid's order: batch element b, depths d0,
// d0 + 1, rows h0 .. h0 + TH - 1
template <int W>
struct Tile {
  int b, d0, h0;
  __device__ __forceinline__ Tile(int tile, int tiles_h, int tiles_b) {
    const int tb = tile % tiles_b;
    b = tile / tiles_b;
    d0 = tb / tiles_h * Geo<W>::TD;
    h0 = tb % tiles_h * Geo<W>::TH;
  }
};

// Copy the patch of input channels c0 .. c0 + 15 (zeros past cin) into the
// stage at shared address dst: the producer warpgroup's threads, 16 bytes
// a copy.
template <int W>
__device__ __forceinline__ void stage_patch(uint32_t dst,
                                            const float* __restrict__ x,
                                            int c0, int cin, int depth,
                                            int height, const Tile<W>& at,
                                            int ptid) {
  using G = Geo<W>;
  constexpr int CH = W / 4;  // 16-byte chunks a row
  constexpr int N = CB * G::PROWS * CH;
  static_assert(N % NP == 0, "copies must divide evenly");
#pragma unroll 2
  for (int e = ptid; e < N; e += NP) {
    const int ch = e % CH, r = (e / CH) % G::PROWS, c = e / (CH * G::PROWS);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    const int z = at.d0 + td - 1, y = at.h0 + th - 1;
    const bool ok =
        c0 + c < cin && z >= 0 && z < depth && y >= 0 && y < height;
    const size_t row = (size_t(at.b) * cin + c0 + c) * depth + z;
    const size_t src = ok ? (row * height + y) * W : 0;
    const int to = c * G::CS + td * G::PLANE + th * G::PW + 4 + 4 * ch;
    cp_async16(dst + 4 * to, x + src + 4 * ch, ok);
  }
}

// The hi and lo terms of the output gradient of channels co0 .. co0 + 63
// over the chain of 64 voxels from row y0 of depth z (zeros outside the
// volume) into the stage at shared address dst, in the 128-byte swizzle:
// voxel v of channel o at panel v / 32, row o, 16-byte chunk (v % 32 / 4)
// ^ (o % 8). The producer warpgroup's threads, 16 bytes of g a load; a
// channel's 64 voxels are 256 contiguous bytes, read by 16 threads.
template <int W>
__device__ __forceinline__ void stage_grad(uint32_t dst,
                                           const float* __restrict__ g,
                                           int co0, int cout, int depth,
                                           int height, int b, int z, int y0,
                                           int ptid) {
  constexpr int N = BCO * 16;  // 16-byte chunks of a stage
  constexpr int BATCH = 4;     // loads in flight a thread
  static_assert(N % (NP * BATCH) == 0, "loads must divide evenly");
#pragma unroll 1
  for (int i0 = 0; i0 < N / NP; i0 += BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int q = ptid + NP * (i0 + i), o = q / 16, j = q % 16;
      const bool ok = z < depth && y0 + 4 * j / W < height;
      v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok)
        v[i] = __ldg(reinterpret_cast<const float4*>(
            g + (((size_t(b) * cout + co0 + o) * depth + z) * height + y0) *
                    W + 4 * j));
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int q = ptid + NP * (i0 + i), o = q / 16, j = q % 16;
      const uint32_t at =
          dst + (j / 8) * (BCO * 128) + o * 128 + (((j % 8) ^ (o % 8)) << 4);
      uint32_t hi[4], lo[4];
      tf32::split(v[i].x, hi[0], lo[0]);
      tf32::split(v[i].y, hi[1], lo[1]);
      tf32::split(v[i].z, hi[2], lo[2]);
      tf32::split(v[i].w, hi[3], lo[3]);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3])
                   : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       at + 2 * BCO * 128),
                   "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                   : "memory");
    }
  }
}

// The A operand (hi and lo terms) of k-step k of a chain: p is the patch
// at the chain's first row and the warp's tap, off[h] the thread's channel
// g + 8h at voxel t, one column left of it (tap dx = 0).
template <int W>
__device__ __forceinline__ void load_a(tf32::FragA& a, const float* p,
                                       const int (&off)[2], int k) {
  using G = Geo<W>;
  const float* r = p + (8 * k / W) * G::PW + 8 * k % W;
  tf32::split(r[off[0]], a.x[0][0], a.x[1][0]);
  tf32::split(r[off[1]], a.x[0][1], a.x[1][1]);
  tf32::split(r[off[0] + 4], a.x[0][2], a.x[1][2]);
  tf32::split(r[off[1] + 4], a.x[0][3], a.x[1][3]);
}

// Issue ch = the chain's 8 k-steps of one m64 tile over N columns of the
// output gradient's stage at shared address b, from zero; call done() once
// the groups before the chain's first have retired (the chain before it is
// in its registers then). Returns with the chain's last group in flight.
template <int W, int N, class F>
__device__ __forceinline__ void chain(float (&ch)[N / 2], const float* p,
                                      const int (&off)[2], uint32_t b,
                                      F&& done) {
  tf32::FragA a[2];
  load_a<W>(a[0], p, off, 0);
#pragma unroll
  for (int k = 0; k < CHAIN; ++k) {
    tf32::FragA& cur = a[k & 1];
    fence_regs(ch);
    tf32::fence_frag(cur);
    wg_arrive();
    // the small terms first (tf32.cuh's order)
    if constexpr (N == 64) {
      tf32::wgmma_n64(ch, cur.x[1], desc_k<BCO>(b, k), k > 0);
      tf32::wgmma_n64(ch, cur.x[0], desc_k<BCO>(b, CHAIN + k), 1);
      tf32::wgmma_n64(ch, cur.x[0], desc_k<BCO>(b, k), 1);
    } else {
      tf32::wgmma_n32(ch, cur.x[1], desc_k<BCO>(b, k), k > 0);
      tf32::wgmma_n32(ch, cur.x[0], desc_k<BCO>(b, CHAIN + k), 1);
      tf32::wgmma_n32(ch, cur.x[0], desc_k<BCO>(b, k), 1);
    }
    wg_commit();
    if (k + 1 < CHAIN) {
      wg_wait<1>();  // the previous k-step's group has read its fragments
      if (k == 0) done();
      load_a<W>(a[(k + 1) & 1], p, off, k + 1);
    }
  }
}

// acc += ch, a chain whose groups have retired
template <int N>
__device__ __forceinline__ void add_chain(float (&acc)[N], float (&ch)[N]) {
  fence_regs(ch);
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] += ch[e];
}

// The patch offset of tap (dz, dy, dx); the empty slot 27 reads tap 26
template <int W>
__device__ __forceinline__ int tap_offset(int tap) {
  using G = Geo<W>;
  tap = tap < TAPS ? tap : TAPS - 1;
  return tap / 9 * G::PLANE + tap / 3 % 3 * G::PW + tap % 3;
}

// Each block's share of dw over tiles t0 .. t0 + per - 1 (its split) into
// part[split] ((Cout, Cin, 27) a split)
template <int W>
__global__ void __launch_bounds__(NT, 1)
conv3d_wgrad_wgmma(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ part, int cin, int cout, int depth,
                   int height, int tiles_h, int tiles_b, int tiles,
                   int per) {
  using G = Geo<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t gsm = smem_base_1k(smem_raw);  // output-gradient stages
  const uint32_t psm = gsm + GSTAGES * GSTAGE;  // the patch stages
  float* stages =
      reinterpret_cast<float*>(smem_raw + (gsm - smem_u32(smem_raw)));
  float* patch = stages + GSTAGES * GSTAGE / 4;
  // mbarriers: patch full, patch empty, gradient full, gradient empty
  const uint32_t pfull = gsm + G::BARS, pempty = pfull + 8 * PSTAGES;
  const uint32_t gfull = pempty + 8 * PSTAGES, gempty = gfull + 8 * GSTAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nci = (cin + CB - 1) / CB, nco = cout / BCO;
  const int c0 = (blockIdx.x % nci) * CB;
  const int co0 = (blockIdx.x / nci % nco) * BCO;
  const int split = blockIdx.x / (nci * nco);
  const int t0 = split * per;
  const int n = min(per, tiles - t0);

  // columns 3 and W + 4 of every patch row: the zeros of the x halo
  for (int e = tid; e < PSTAGES * CB * G::PROWS * 2; e += NT) {
    const int side = e % 2, r = e / 2 % G::PROWS, c = e / 2 / G::PROWS % CB,
              s = e / (2 * G::PROWS * CB);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    patch[s * G::PATCH + c * G::CS + td * G::PLANE + th * G::PW +
          (side ? W + 4 : 3)] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(pfull + 8 * s, NP);         // the producer's copies
      mbar_init(pempty + 8 * s, NC / 32);   // each consumer warp
    }
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(gfull + 8 * s, NP);         // the producer's stores
      mbar_init(gempty + 8 * s, NC / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NC / 32) {
    // the producer: for each tile, the patch, then its four chains'
    // output gradient; q counts the chains staged
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int ptid = tid - NC;
    int q = 0;
    for (int s = 0; s < n; ++s) {
      const Tile<W> at(t0 + s, tiles_h, tiles_b);
      const int ps = s % PSTAGES;
      mbar_wait(pempty + 8 * ps, ((s / PSTAGES) & 1) ^ 1);
      stage_patch<W>(psm + ps * G::PATCH * 4, x, c0, cin, depth, height, at,
                     ptid);
      cp_async_arrive(pfull + 8 * ps);
      for (int c = 0; c < CHAINS; ++c, ++q) {
        const int gs = q % GSTAGES;
        mbar_wait(gempty + 8 * gs, ((q / GSTAGES) & 1) ^ 1);
        stage_grad<W>(gsm + gs * GSTAGE, g, co0, cout, depth, height, at.b,
                      at.d0 + c / 2, at.h0 + c % 2 * G::CR, ptid);
        fence_async_smem();  // the stores, visible to wgmma
        mbar_arrive(gfull + 8 * gs);
      }
    }
    cp_async_wait_all();
    return;
  }

  // the consumers: warpgroup wg, warp wq of it: tap 4m + wq of m64 tile m,
  // input channels g and g + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, wq = warp % 4, gr = lane / 4, t = lane % 4;
  const int off[2] = {gr * G::CS + t + 3, (gr + 8) * G::CS + t + 3};
  int toff[FULL + 1];
#pragma unroll
  for (int j = 0; j < FULL; ++j) toff[j] = tap_offset<W>(4 * (4 * wg + j) + wq);
  toff[FULL] = tap_offset<W>(4 * FULL + wq);
  const uint32_t half = wg * 32 * 128;  // tile 3's columns 32 wg ..

  float acc[FULL][32] = {}, acch[16] = {};
  // two chains' registers in turn: one adds into acc while the next runs
  float ch[2][32] = {}, chh[16] = {};
  int q = 0;
  for (int s = 0; s < n; ++s) {
    const int ps = s % PSTAGES;
    mbar_wait(pfull + 8 * ps, (s / PSTAGES) & 1);
    const float* pb = patch + ps * G::PATCH;
#pragma unroll 1
    for (int c = 0; c < CHAINS; ++c, ++q) {
      const int gs = q % GSTAGES;
      mbar_wait(gfull + 8 * gs, (q / GSTAGES) & 1);
      const uint32_t bsm = gsm + gs * GSTAGE;
      const float* pc = pb + c / 2 * G::PLANE + c % 2 * G::CR * G::PW;
#pragma unroll
      for (int j = 0; j < FULL; ++j)
        chain<W, 64>(ch[j % 2], pc + toff[j], off, bsm, [&] {
          if (j > 0) add_chain(acc[j - 1], ch[(j - 1) % 2]);
        });
      chain<W, 32>(chh, pc + toff[FULL], off, bsm + half,
                   [&] { add_chain(acc[FULL - 1], ch[(FULL - 1) % 2]); });
      wg_wait<0>();
      add_chain(acch, chh);
      __syncwarp();
      if (lane == 0) mbar_arrive(gempty + 8 * gs);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(pempty + 8 * ps);
  }

  // the epilogue: acc[j][4i + 2h + e] is row 16 wq + g + 8h of tile 4wg + j
  // (input channel g + 8h, tap 4 (4wg + j) + wq), column 8i + 2t + e; into
  // shared memory as (64, 16, 27), once both warpgroups are done with the
  // stages, then out in whole rows of 16 x 27 (8 x 27 past cin)
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
#pragma unroll
  for (int j = 0; j < FULL; ++j) {
    const int tap = 4 * (4 * wg + j) + wq;
    if (tap < TAPS)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            stages[(8 * i + 2 * t + e) * OS + (gr + 8 * h) * TAPS + tap] =
                acc[j][4 * i + 2 * h + e];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        stages[(32 * wg + 8 * i + 2 * t + e) * OS + (gr + 8 * h) * TAPS +
               4 * FULL + wq] = acch[4 * i + 2 * h + e];
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
  const int row = min(CB, cin - c0) * TAPS / 4;  // 16-byte chunks a row
  float* out = part + (size_t(split) * cout + co0) * cin * TAPS;
  for (int e = tid; e < BCO * row; e += NC) {
    const int o = e / row, i = e % row;
    *reinterpret_cast<float4*>(out + (size_t(o) * cin + c0) * TAPS + 4 * i) =
        *reinterpret_cast<const float4*>(stages + o * OS + 4 * i);
  }
}

template <int W>
cudaError_t launch(const float* x, const float* g, float* part, int b,
                   int cin, int cout, int depth, int height, int per,
                   cudaStream_t stream) {
  using G = Geo<W>;
  cudaError_t err = allow_smem<conv3d_wgrad_wgmma<W>>(G::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_h = (height + G::TH - 1) / G::TH;
  const int tiles_b = (depth + G::TD - 1) / G::TD * tiles_h;
  const long long tiles = (long long)b * tiles_b;
  const long long splits = (tiles + per - 1) / per;
  const long long blocks = splits * ((cin + CB - 1) / CB) * (cout / BCO);
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  conv3d_wgrad_wgmma<W><<<unsigned(blocks), NT, G::SMEM, stream>>>(
      x, g, part, cin, cout, depth, height, tiles_h, tiles_b, int(tiles),
      per);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: x (b, cin, depth, height, width) and the
// output gradient g (b, cout, depth, height, width), contiguous float32 on
// 16-byte boundaries; part, a float32 workspace of splits x cout x cin x 27
// on a 16-byte boundary, for splits = ceil(b * ceil(depth / 2) *
// ceil(height / (128 / width)) / per), into which each split's share of dw
// (cout, cin, 3, 3, 3) is written; cin a multiple of 8, cout of 64, width
// 8, 16, 32 or 64; per >= 1 tiles a block. Returns a cudaError_t (0 on
// success); allocates nothing and does not synchronize.
extern "C" int hupr_conv3d_wgrad(const void* x, const void* g, void* part,
                                 int b, int cin, int cout, int depth,
                                 int height, int width, int per,
                                 void* stream) {
  if (b <= 0 || depth <= 0 || height <= 0 || cin <= 0 || cin % 8 != 0 ||
      cout <= 0 || cout % BCO != 0 || per <= 0)
    return int(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8:
      return int(launch<8>(xf, gf, pf, b, cin, cout, depth, height, per, s));
    case 16:
      return int(launch<16>(xf, gf, pf, b, cin, cout, depth, height, per, s));
    case 32:
      return int(launch<32>(xf, gf, pf, b, cin, cout, depth, height, per, s));
    case 64:
      return int(launch<64>(xf, gf, pf, b, cin, cout, depth, height, per, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
