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
// Bound. A GEMM of M = Cout, N = 27 Cin, K = B*D*H*W voxels: at the widest
// shape at batch 20, (20, 64, 8, 64, 64) with 64 output channels, 2*M*N*K =
// 145 GFLOP, 0.88 ms in 3xTF32 at 495/3 = 165 TFLOP/s, against 0.34 GB of
// input and output gradient, 0.10 ms at 3.35 TB/s: the operations bound it.
//
// 3xTF32 as conv3d_fprop.cu takes it (tf32.cuh): each float32 operand
// split into hi and lo tf32 terms at fragment load, each product lo.hi +
// hi.lo + hi.hi into a float32 accumulator. The tensor cores' float32 sums
// do not round to nearest, and K runs to 655,360 voxels at batch 20, so
// the sum is taken in three levels, each short: chains of 8 k-steps (64
// voxels, 24 mma.sync) from zero in the tensor cores, each chain added to
// the block's float32 accumulator by an FADD, and the blocks' partial sums
// over their share of the voxels written to a workspace, one slice a
// split, which the wrapper (ops/conv.conv3d_wgrad) adds with torch's sum,
// a reduction in a fixed order. No atomics: the same inputs give the same
// bits on every call.
//
// Design. The GEMM is taken with the output gradient as mma.sync's A (m16
// rows of output channels, K-major: voxels along x are contiguous in
// NCDHW) and the input as its B (n8 columns of input channels at one tap).
// A block owns 64 output channels x 8 input channels x 27 taps of dw, and
// a run of consecutive voxel tiles (its split): per tile it stages,
// through a two-stage cp.async ring,
//   - the output gradient of its 64 channels over the tile's 256 voxels,
//     2 depths x 256 / (2 W) rows x W columns (as conv3d_fprop.cu's tile),
//     rows outside the volume zero-filled by the copy (src-size 0), so a
//     ragged tile adds nothing; a row stride of 260 floats (4 mod 32) puts
//     lane (g, t)'s A reads at (row g, voxel t) on 32 distinct banks;
//   - the input patch of its 8 channels with its halo, laid out as in
//     conv3d_fprop.cu (columns 4 .. W + 3 of a W + 8 wide row, columns 3 and
//     W + 4 zeros written once), with a channel stride of 4 mod 8 floats, so
//     lane (g, t)'s B reads at (channel g, voxel t) hit 32 banks. Each staged
//     value serves all 27 taps: tap (dz, dy, dx) reads the patch at an
//     offset of dz planes, dy rows and dx columns.
// Its 9 warps take one (dz, dy) each and its three dx: 4 m16 x 3 n8 tiles,
// each A fragment split once and used for three taps, each B fragment for
// four m-tiles. A k-step is 8 voxels of one row; a chain, 64 voxels, lies
// in one depth of the tile. With 104 KB a stage, two stages fit one block
// a Hopper SM. Blocks of one split and all input-channel chunks run next
// to each other, so the output gradient they share is read from L2; the
// wrapper (ops/conv.wgrad_split) gives each block enough tiles that the
// grid makes about four waves of the card's SMs (132 on the H100 SXM) at
// batch 5 and at batch 20.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr int NT = 288;      // 9 warps: one (dz, dy) of the taps each
constexpr int BCO = 64;      // output channels a block (4 m16 tiles)
constexpr int CB = 8;        // input channels a block (one n8 tile a tap)
constexpr int BV = 256;      // voxels a tile (32 k-steps)
constexpr int TAPS = 27;
constexpr int MI = 4;        // m16 tiles a warp
constexpr int NJ = 3;        // n8 tiles a warp: the taps dx = 0, 1, 2
constexpr int CHAIN = 8;     // k-steps a chain of tensor-core sums
constexpr int AS = BV + 4;   // output-gradient row stride, 4 mod 32
constexpr int STAGES = 2;

// The smallest n' >= n with n' = 4 mod 8: then g * n' (g < 8) are distinct
// multiples of 4 modulo 32 banks, and a stride stays 16-byte whole
__host__ __device__ constexpr int bank_pad(int n) {
  return n + ((4 - n % 8) + 8) % 8;
}

// Tile geometry at width W: TD depths x TH rows x W columns of voxels
template <int W>
struct Geo {
  static_assert(W == 8 || W == 16 || W == 32 || W == 64, "width");
  static constexpr int TD = 2;
  static constexpr int TH = BV / (TD * W);   // 2, 4, 8, 16 rows
  static constexpr int CR = 8 * CHAIN / W;   // rows a chain
  static constexpr int PW = W + 8;           // patch row: cols 4 .. W + 3
  static constexpr int PROWS = (TD + 2) * (TH + 2);
  static constexpr int PLANE = (TH + 2) * PW;
  static constexpr int CS = bank_pad((TD + 2) * PLANE);
  static constexpr int GRAD = BCO * AS;      // floats
  static constexpr int STAGE = GRAD + CB * CS;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE * 4;
  static_assert(TH % CR == 0, "a chain's rows lie in one depth");
  static_assert(SMEM <= 232448, "exceeds a Hopper block's shared memory");
};

// Copy tile `tile` into buf: the output gradient of channels co0 .. co0 +
// 63, then the input patch of channels c0 .. c0 + 7. Every thread of the
// block takes part.
template <int W>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ x,
                                      const float* __restrict__ g, int tile,
                                      int c0, int co0, int cin, int cout,
                                      int depth, int height, int tiles_h,
                                      int tiles_b, int tid) {
  using G = Geo<W>;
  constexpr int CH = W / 4;  // 16-byte chunks a row
  const int b = tile / tiles_b, tb = tile % tiles_b;
  const int d0 = (tb / tiles_h) * G::TD, h0 = (tb % tiles_h) * G::TH;
  const uint32_t base = smem_u32(buf);
  constexpr int NG = BCO * G::TD * G::TH * CH;
#pragma unroll 1
  for (int i = 0; i < (NG + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (e >= NG) break;
    const int ch = e % CH, r = (e / CH) % (G::TD * G::TH),
              o = e / (CH * G::TD * G::TH);
    const int z = d0 + r / G::TH, y = h0 + r % G::TH;
    const bool ok = z < depth && y < height;
    const size_t row = (size_t(b) * cout + co0 + o) * depth + z;
    const size_t at = ok ? (row * height + y) * W : 0;
    cp_async16(base + 4 * (o * AS + r * W + 4 * ch), g + at + 4 * ch, ok);
  }
  constexpr int NX = CB * G::PROWS * CH;
  const uint32_t pbase = base + 4 * G::GRAD;
#pragma unroll 1
  for (int i = 0; i < (NX + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (e >= NX) break;
    const int ch = e % CH, r = (e / CH) % G::PROWS, c = e / (CH * G::PROWS);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    const int z = d0 + td - 1, y = h0 + th - 1;
    const bool ok = z >= 0 && z < depth && y >= 0 && y < height;
    const size_t row = (size_t(b) * cin + c0 + c) * depth + z;
    const size_t at = ok ? (row * height + y) * W : 0;
    const int to = c * G::CS + td * G::PLANE + th * G::PW + 4 + 4 * ch;
    cp_async16(pbase + 4 * to, x + at + 4 * ch, ok);
  }
}

// Each block's share of dw over tiles t0 .. t0 + per - 1 (its split) into
// part[split] ((Cout, Cin, 27) a split)
template <int W>
__global__ void __launch_bounds__(NT, 1)
conv3d_wgrad_tf32(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, int cin, int cout, int depth,
                  int height, int tiles_h, int tiles_b, int tiles, int per) {
  using G = Geo<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const int dz = warp / 3, dy = warp % 3;
  const int nci = cin / CB, nco = cout / BCO;
  const int c0 = (blockIdx.x % nci) * CB;
  const int co0 = (blockIdx.x / nci % nco) * BCO;
  const int split = blockIdx.x / (nci * nco);
  const int t0 = split * per;
  const int n = min(per, tiles - t0);

  // columns 3 and W + 4 of every patch row: the zeros of the x halo
  for (int e = tid; e < STAGES * CB * G::PROWS * 2; e += NT) {
    const int side = e % 2, r = e / 2 % G::PROWS, c = e / 2 / G::PROWS % CB,
              s = e / (2 * G::PROWS * CB);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    sm[s * G::STAGE + G::GRAD + c * G::CS + td * G::PLANE + th * G::PW +
       (side ? W + 4 : 3)] = 0.f;
  }

  stage<W>(sm, x, g, t0, c0, co0, cin, cout, depth, height, tiles_h,
           tiles_b, tid);
  cp_async_commit();
  if (n > 1)
    stage<W>(sm + G::STAGE, x, g, t0 + 1, c0, co0, cin, cout, depth, height,
             tiles_h, tiles_b, tid);
  cp_async_commit();  // one group a stage, empty past the last

  // lane (g, t): A at output channel gr, voxel t; B at input channel gr,
  // voxel t read at tap (dz, dy, 0): one column left of it, + 3, not + 4
  const int aoff = gr * AS + t;
  const int boff = G::GRAD + gr * G::CS + dz * G::PLANE + dy * G::PW + t + 3;

  float acc[MI][NJ][4] = {};
  for (int s = 0; s < n; ++s) {
    cp_async_wait<1>();  // tile s has landed
    __syncthreads();
    const float* buf = sm + (s % STAGES) * G::STAGE;
#pragma unroll 1
    for (int c = 0; c < BV / (8 * CHAIN); ++c) {
      // the chain's rows c CR .. c CR + CR - 1 of the tile, in one depth
      const int row0 = c * G::CR;
      const float* pa = buf + aoff + c * 8 * CHAIN;
      const float* pb = buf + boff + (row0 / G::TH) * G::PLANE +
                        (row0 % G::TH) * G::PW;
      float chain[MI][NJ][4];
#pragma unroll
      for (int k = 0; k < CHAIN; ++k) {
        tf32::FragA a[MI];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float* p = pa + 16 * i * AS + 8 * k;
          tf32::split(p[0], a[i].x[0][0], a[i].x[1][0]);
          tf32::split(p[8 * AS], a[i].x[0][1], a[i].x[1][1]);
          tf32::split(p[4], a[i].x[0][2], a[i].x[1][2]);
          tf32::split(p[8 * AS + 4], a[i].x[0][3], a[i].x[1][3]);
        }
        tf32::FragB f[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* p = pb + (8 * k / W) * G::PW + 8 * k % W + j;
          tf32::split(p[0], f[j].x[0][0], f[j].x[1][0]);
          tf32::split(p[4], f[j].x[0][1], f[j].x[1][1]);
        }
        // each term over every tile in turn, the small terms first
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (k == 0)
              tf32::mma_from_zero(chain[i][j], a[i].x[1], f[j].x[0]);
            else
              tf32::mma(chain[i][j], a[i].x[1], f[j].x[0]);
          }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            tf32::mma(chain[i][j], a[i].x[0], f[j].x[1]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            tf32::mma(chain[i][j], a[i].x[0], f[j].x[0]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += chain[i][j][e];
    }
    __syncthreads();  // every warp is done with this stage
    if (s + STAGES < n)
      stage<W>(sm + (s % STAGES) * G::STAGE, x, g, t0 + s + STAGES, c0, co0,
               cin, cout, depth, height, tiles_h, tiles_b, tid);
    cp_async_commit();
  }

  // accumulator element e: output channel row g + 8 (e / 2), input channel
  // column 2t + e % 2, of the warp's taps (dz, dy, j)
  float* out = part + size_t(split) * cout * cin * TAPS;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = co0 + 16 * i + gr + 8 * (e / 2);
      const int ci = c0 + 2 * t + e % 2;
      float* dst = out + (size_t(co) * cin + ci) * TAPS + 9 * dz + 3 * dy;
#pragma unroll
      for (int j = 0; j < NJ; ++j) dst[j] = acc[i][j][e];
    }
}

template <int W>
cudaError_t launch(const float* x, const float* g, float* part, int b,
                   int cin, int cout, int depth, int height, int per,
                   cudaStream_t stream) {
  using G = Geo<W>;
  cudaError_t err = allow_smem<conv3d_wgrad_tf32<W>>(G::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_h = (height + G::TH - 1) / G::TH;
  const int tiles_b = (depth + G::TD - 1) / G::TD * tiles_h;
  const long long tiles = (long long)b * tiles_b;
  const long long splits = (tiles + per - 1) / per;
  const long long blocks = splits * (cin / CB) * (cout / BCO);
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  conv3d_wgrad_tf32<W><<<unsigned(blocks), NT, G::SMEM, stream>>>(
      x, g, part, cin, cout, depth, height, tiles_h, tiles_b, int(tiles),
      per);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: x (b, cin, depth, height, width) and the
// output gradient g (b, cout, depth, height, width), contiguous float32 on
// 16-byte boundaries; part, a float32 workspace of splits x cout x cin x 27
// for splits = ceil(b * ceil(depth / 2) * ceil(height / (128 / width)) /
// per), into which each split's share of dw (cout, cin, 3, 3, 3) is
// written; cin a multiple of 8, cout of 64, width 8, 16, 32 or 64; per >= 1
// tiles a block. Returns a cudaError_t (0 on success); allocates nothing
// and does not synchronize.
extern "C" int hupr_conv3d_wgrad(const void* x, const void* g, void* part,
                                 int b, int cin, int cout, int depth,
                                 int height, int width, int per,
                                 void* stream) {
  if (b <= 0 || depth <= 0 || height <= 0 || cin <= 0 || cin % CB != 0 ||
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
