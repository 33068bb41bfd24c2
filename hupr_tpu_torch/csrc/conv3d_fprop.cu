// Forward 3-D convolution, 3x3x3 kernel, stride 1, zero padding 1 (SAME),
// float32, for Hopper (sm_90a): the Encoder3Ds' convolutions in serving.
//
//   out[b, o, z, y, x] = bias[o] + sum_{c, dz, dy, dx} w[o, c, dz, dy, dx]
//                        * in[b, c, z + dz - 1, y + dy - 1, x + dx - 1]
//
// on contiguous NCDHW input and output and (Cout, Cin, 3, 3, 3) weights,
// bias optional; input outside the volume reads as zero.
//
// It replaces no TPU kernel: XLA ran these convolutions on the TPU. It was
// added because cuDNN runs float32 3-D convolutions with TF32 off on the
// FFMA pipes (sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw),
// at about 43 TFLOP/s at the widest shape, and they took about 70 % of a
// served float32 request.
//
// Bound. An implicit GEMM of M = B*D*H*W voxels, N = Cout, K = 27*Cin: at
// the widest shape, (32, 64, 8, 64, 64) -> 64 channels, 2*M*N*K = 232 GFLOP.
// In 3xTF32 (below) that is 1.41 ms at 495/3 = 165 TFLOP/s, against 0.54 GB
// of input and output, 0.16 ms at 3.35 TB/s: the operations bound it.
//
// 3xTF32 (tf32.cuh): each float32 operand is split into hi and lo tf32
// terms at fragment load, and each product is lo.hi + hi.lo + hi.hi into a
// float32 accumulator, which keeps float32's accuracy (about 2^-21 of each
// product; one TF32 product alone is off by about 2^-11). The tensor cores'
// float32 sums do not round to nearest (hopper.cuh, promote_tiles), so the
// products run in chains of 9 taps (27 mma.sync a chain and accumulator)
// from zero, each chain added to the output's float32 accumulator by an
// FADD: a sum over all of K in one accumulator would carry a bias of a few
// ulps per mma.sync into each output.
//
// Design. The GEMM is taken transposed, out^T = W . in^T: the weights are
// mma.sync's A (m16 rows of output channels, K-major as they lie in
// memory), the voxels its B (n8 columns along x, the contiguous axis of
// NCDHW), so each accumulator pair is two neighbouring voxels of one output
// row and the stores are whole 32-byte sectors. A block owns 64 output
// channels of 256 voxels of one batch element: 2 depths x 256 / (2 W) rows
// x all W columns (W in {8, 16, 32, 64}). Its 8 warps take 32 channels x 64
// voxels each (2 m16 x 8 n8 tiles). K runs in stages of 8 input channels x
// 27 taps; per stage the block stages, through a two-stage cp.async ring:
//   - the input patch of its 8 channels with its halo, (2 + 2) depths x
//     (rows + 2) rows x W columns, rows outside the volume zero-filled by the
//     copy (src-size 0); each row sits at columns 4 .. W + 3 of a W + 8 wide
//     patch row, so the 16-byte copies stay aligned, and columns 3 and W + 4
//     are zeros written once: the halo is masked in the staging, and no
//     padded copy of the input exists. Each staged value serves all 27 taps:
//     the B fragment of tap (dz, dy, dx) is the patch read at an offset of
//     dz planes, dy rows and dx columns, so the inner loop computes no
//     address and tests no mask;
//   - the 64 channels' weights of those 8 input channels, 216 contiguous
//     floats a row as they lie in memory.
// A k-step (k8 of mma.sync) is one tap over the 8 channels: k = t and t + 4
// are channels t and t + 4 of lane (g, t). Its B fragment reads channel t's
// patch at row offset + g: with the patch's channel stride CS = 8 or 24
// mod 32 floats the 32 lanes hit 32 banks. Its A fragment reads weight
// (row g, column 27t + tap): a row stride of 220 floats (28 mod 32) makes
// those 32 lanes distinct banks too.
// The patch and the weights of a stage take 87-93 KB; two stages fit one
// block a Hopper SM (8 warps, up to 255 registers a thread: 2 x 64
// accumulators and the split fragments). Each n-tile's B fragment is split
// and used at once, its three products into both m-tiles' accumulators, and
// the staging loops stay rolled: B fragments held for a whole tap, or the
// staging's address arithmetic unrolled, crowded the accumulators into
// spills and cost 16-27 % of the time at the Encoder3D shapes (PERF.md,
// section 6).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;      // 8 warps: 2 along the channels x 4 along voxels
constexpr int BCO = 64;      // output channels a block
constexpr int BV = 256;      // voxels a block
constexpr int CB = 8;        // input channels a stage (one k8 step a tap)
constexpr int TAPS = 27;
constexpr int AS = CB * TAPS + 4;  // weight row stride, 220 = 28 mod 32
constexpr int MI = 2;        // m16 tiles a warp: 32 output channels
constexpr int NJ = 8;        // n8 tiles a warp: 64 voxels
constexpr int CHAIN = 9;     // taps a chain of tensor-core sums (one dz)
constexpr int STAGES = 2;

// The smallest n' >= n with n' = 8 mod 16: then 8 t * CS (t < 4) are
// distinct multiples of 8 modulo 32 banks, and a stride stays 16-byte whole
__host__ __device__ constexpr int bank_pad(int n) {
  return n + ((8 - n % 16) + 16) % 16;
}

// Tile geometry at width W: TD depths x TH rows x W columns of output
template <int W>
struct Geo {
  static_assert(W == 8 || W == 16 || W == 32 || W == 64, "width");
  static constexpr int TD = 2;
  static constexpr int TH = BV / (TD * W);   // 2, 4, 8, 16 rows
  static constexpr int RW = 64 / W;          // rows a voxel warp
  static constexpr int PW = W + 8;           // patch row: cols 4 .. W + 3
  static constexpr int PROWS = (TD + 2) * (TH + 2);
  static constexpr int PLANE = (TH + 2) * PW;
  static constexpr int CS = bank_pad((TD + 2) * PLANE);
  static constexpr int PATCH = CB * CS;      // floats
  static constexpr int STAGE = PATCH + BCO * AS;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE * 4;
  static_assert(TH % RW == 0, "a warp's rows lie in one depth");
  static_assert(SMEM <= 232448, "exceeds a Hopper block's shared memory");
};

// Copy stage c0 (input channels c0 .. c0 + 7) into buf: the patch, then the
// weights. Every thread of the block takes part.
template <int W>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ x,
                                      const float* __restrict__ wt, int c0,
                                      int cin, int depth, int height, int b,
                                      int d0, int h0, int co0, int tid) {
  using G = Geo<W>;
  constexpr int CH = W / 4;  // 16-byte chunks a row
  constexpr int N = CB * G::PROWS * CH;
  const uint32_t base = smem_u32(buf);
#pragma unroll 1
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (N % NT != 0 && e >= N) break;
    const int ch = e % CH, r = (e / CH) % G::PROWS, c = e / (CH * G::PROWS);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    const int z = d0 + td - 1, y = h0 + th - 1;
    const bool ok = z >= 0 && z < depth && y >= 0 && y < height;
    const size_t row = (size_t(b) * cin + c0 + c) * depth + z;
    const size_t at = ok ? (row * height + y) * W : 0;
    const int to = c * G::CS + td * G::PLANE + th * G::PW + 4 + 4 * ch;
    cp_async16(base + 4 * to, x + at + 4 * ch, ok);
  }
  constexpr int WCH = CB * TAPS / 4;  // 54 chunks a weight row
  const uint32_t wbase = base + 4 * G::PATCH;
#pragma unroll 1
  for (int i = 0; i < (BCO * WCH + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (e >= BCO * WCH) break;
    const int r = e / WCH, ch = e % WCH;
    cp_async16(wbase + 4 * (r * AS + 4 * ch),
               wt + (size_t(co0 + r) * cin + c0) * TAPS + 4 * ch, true);
  }
}

template <int W>
__global__ void __launch_bounds__(NT, 1)
conv3d_fprop_tf32(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int cin, int cout, int depth, int height, int tiles_h,
                  int tiles_b) {
  using G = Geo<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wc = warp / 4, wv = warp % 4;  // channel warp, voxel warp
  // blocks of one patch (the channel blocks) run next to each other
  const int nco = cout / BCO;
  const int co0 = (blockIdx.x % nco) * BCO;
  const int tile = blockIdx.x / nco;
  const int b = tile / tiles_b, tb = tile % tiles_b;
  const int d0 = (tb / tiles_h) * G::TD, h0 = (tb % tiles_h) * G::TH;

  // columns 3 and W + 4 of every patch row: the zeros of the x halo
  for (int e = tid; e < STAGES * CB * G::PROWS * 2; e += NT) {
    const int side = e % 2, r = e / 2 % G::PROWS, c = e / 2 / G::PROWS % CB,
              s = e / (2 * G::PROWS * CB);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    sm[s * G::STAGE + c * G::CS + td * G::PLANE + th * G::PW +
       (side ? W + 4 : 3)] = 0.f;
  }

  const int stages = cin / CB;
  stage<W>(sm, x, wt, 0, cin, depth, height, b, d0, h0, co0, tid);
  cp_async_commit();
  if (stages > 1)
    stage<W>(sm + G::STAGE, x, wt, CB, cin, depth, height, b, d0, h0, co0,
             tid);
  cp_async_commit();  // one group a stage, empty past the last

  // the warp's voxels: rows row0 .. row0 + RW - 1 of the block's TD x TH
  const int row0 = wv * G::RW;
  const int td = row0 / G::TH, th0 = row0 % G::TH;
  // lane (g, t): B at channel t, the warp's first row, column g (tap (0, 0,
  // 0) reads one column left of it: + 3, not + 4); A at row 32 wc + g,
  // channel t
  const int boff = t * G::CS + td * G::PLANE + th0 * G::PW + g + 3;
  const int aoff = G::PATCH + (32 * wc + g) * AS + t * TAPS;

  float acc[MI][NJ][4] = {};
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<1>();  // stage s has landed
    __syncthreads();
    float* buf = sm + (s % STAGES) * G::STAGE;
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
      const float* pa = buf + aoff + CHAIN * dz;
      const float* pb = buf + boff + dz * G::PLANE;
      float part[MI][NJ][4];
#pragma unroll
      for (int tap = 0; tap < CHAIN; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        tf32::FragA a[MI];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float* p = pa + 16 * i * AS + tap;
          tf32::split(p[0], a[i].x[0][0], a[i].x[1][0]);
          tf32::split(p[8 * AS], a[i].x[0][1], a[i].x[1][1]);
          tf32::split(p[4 * TAPS], a[i].x[0][2], a[i].x[1][2]);
          tf32::split(p[8 * AS + 4 * TAPS], a[i].x[0][3], a[i].x[1][3]);
        }
        // one n-tile's B fragment at a time, its three products into each
        // m-tile's accumulator, the small terms first (tf32.cuh's order)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* p =
              pb + (dy + 8 * j / W) * G::PW + dx + 8 * j % W;
          tf32::FragB f;
          tf32::split(p[0], f.x[0][0], f.x[1][0]);
          tf32::split(p[4 * G::CS], f.x[0][1], f.x[1][1]);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            if (tap == 0)
              tf32::mma_from_zero(part[i][j], a[i].x[1], f.x[0]);
            else
              tf32::mma(part[i][j], a[i].x[1], f.x[0]);
            tf32::mma(part[i][j], a[i].x[0], f.x[1]);
            tf32::mma(part[i][j], a[i].x[0], f.x[0]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    __syncthreads();  // every warp is done with this stage
    if (s + STAGES < stages)
      stage<W>(buf, x, wt, (s + STAGES) * CB, cin, depth, height, b, d0, h0,
               co0, tid);
    cp_async_commit();
  }

  const size_t plane_out = size_t(depth) * height * W;
  const int z = d0 + td;
  if (z >= depth) return;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + 32 * wc + 16 * i + g + 8 * h;
      const float bv = bias != nullptr ? bias[co] : 0.f;
      float* dst = out + (size_t(b) * cout + co) * plane_out +
                   size_t(z) * height * W + 2 * t;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int y = h0 + th0 + 8 * j / W;
        if (y < height)
          store2(dst + size_t(y) * W + 8 * j % W, acc[i][j][2 * h] + bv,
                 acc[i][j][2 * h + 1] + bv);
      }
    }
}

template <int W>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int b, int cin, int cout, int depth,
                   int height, cudaStream_t stream) {
  using G = Geo<W>;
  cudaError_t err = allow_smem<conv3d_fprop_tf32<W>>(G::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_h = (height + G::TH - 1) / G::TH;
  const int tiles_b = (depth + G::TD - 1) / G::TD * tiles_h;
  const long long blocks = (long long)b * tiles_b * (cout / BCO);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  conv3d_fprop_tf32<W><<<unsigned(blocks), NT, G::SMEM, stream>>>(
      x, w, bias, out, cin, cout, depth, height, tiles_h, tiles_b);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: x (b, cin, depth, height, width), w (cout,
// cin, 3, 3, 3), bias (cout) or null, out (b, cout, depth, height, width),
// all contiguous float32; x and w on 16-byte boundaries; cin a multiple of
// 8, cout of 64, width 8, 16, 32 or 64. Returns a cudaError_t (0 on
// success); allocates nothing and does not synchronize.
extern "C" int hupr_conv3d_fprop(const void* x, const void* w,
                                 const void* bias, void* out, int b, int cin,
                                 int cout, int depth, int height, int width,
                                 void* stream) {
  if (b <= 0 || depth <= 0 || height <= 0 || cin <= 0 || cin % CB != 0 ||
      cout <= 0 || cout % BCO != 0)
    return int(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 8:
      return int(launch<8>(xf, wf, bf, of, b, cin, cout, depth, height, s));
    case 16:
      return int(launch<16>(xf, wf, bf, of, b, cin, cout, depth, height, s));
    case 32:
      return int(launch<32>(xf, wf, bf, of, b, cin, cout, depth, height, s));
    case 64:
      return int(launch<64>(xf, wf, bf, of, b, cin, cout, depth, height, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
