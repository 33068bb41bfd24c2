// Forward 3-D convolution, 3x3x3 kernel, stride 1, zero padding 1 (SAME),
// float32, for Hopper (sm_90a): the Encoder3Ds' convolutions in serving and,
// on the flipped weight, their input gradients in training.
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
// of input and output, 0.16 ms at 3.35 TB/s: the tensor cores bound it. A
// body on warp-level mma.sync reached 202 TFLOP/s of TF32 products here
// (42 % of the bound), and mma.sync alone stops at about 321 (65 %); only
// wgmma reaches the card's 495. With tf32's k8 a wgmma reads 32 bytes of B
// a row for every 64 x 8 products, so B alone takes half of shared memory's
// bandwidth at the full rate: what else the body reads or writes there
// (the A fragments, the staging) is what keeps it under the bound.
//
// 3xTF32 (tf32.cuh): each float32 operand is split into hi and lo tf32
// terms, and each product is lo.hi + hi.lo + hi.hi into a float32
// accumulator, which keeps float32's accuracy (about 2^-21 of each product;
// one TF32 product alone is off by about 2^-11). The tensor cores' float32
// sums do not round to nearest (hopper.cuh, promote_tiles), so the products
// run in chains of 9 taps (one dz: 27 wgmma a chain and accumulator) from
// zero, each chain added to the output's float32 accumulator by an FADD: a
// sum over all of K in one accumulator would carry a bias of a few ulps per
// product into each output.
//
// Why the voxels are A. wgmma's tf32 operands in shared memory are both
// K-major (tf32 has no transpose bit), and the voxels lie along x, MN-major
// for a GEMM whose K is the input channels. So the voxels are the M side, A,
// which wgmma takes from registers: each warp loads its A fragment from the
// staged input patch with ld.shared and splits it into hi and lo there. The
// weights are B in shared memory, K-major as they lie in memory (each output
// channel's row runs along the input channels).
//
// Design. A tile is 64 output channels (N) of 256 voxels of one batch
// element: 2 depths x 256 / (2 W) rows x all W columns (W in {8, 16, 32,
// 64}). A block is three warpgroups: two consumers of two m64 tiles each
// (one depth a warpgroup), and a producer that keeps two rings of stages
// full, each stage signalled by an mbarrier. setmaxnreg gives the
// producer's threads 56 registers and the consumers' 224. The block is
// persistent: one a SM, walking the tiles in steps of the grid, so the
// producer stages the next tile while the consumers store this one. The
// stages:
//   - the input patch of 8 input channels with its halo, (2 + 2) depths x
//     (rows + 2) rows x W columns, by the producer's cp.async, rows outside
//     the volume zero-filled (src-size 0); each row sits at columns 4 .. W +
//     3 of a W + 8 wide patch row, so the 16-byte copies stay aligned, and
//     columns 3 and W + 4 are zeros written once: the halo is masked in the
//     staging, and no padded copy of the input exists. Each staged value
//     serves all 27 taps: the A fragment of tap (dz, dy, dx) is the patch
//     read at an offset of dz planes, dy rows and dx columns, so the inner
//     loop computes no address and tests no mask. Lane (g, t) reads voxel
//     rows g and g + 8 (along x) of channels t and t + 4; with a channel
//     stride CS = 8 or 24 mod 32 floats the 32 lanes hit 32 banks. Two
//     stages;
//   - the weights of those 8 channels at one dz (9 taps), hi and lo tf32
//     terms, by one bulk copy of the copy engine: a launch of pack_weights
//     before the kernel writes them once a call in the byte image of the
//     stage, K ordered (tap, channel) so that a k8 step is one tap over the
//     8 channels, in hopper.cuh's 128-byte swizzle that the wgmma
//     descriptor names (k-steps 0-8 the hi terms, 9-17 the lo terms, 5
//     panels of 64 rows x 128 bytes, 40 KB). Three stages.
// A k8 step is one tap: per m64 tile A_lo.B_hi, A_hi.B_lo, then A_hi.B_hi
// (m64n64k8), committed as one group; the A fragments of the next tap are
// loaded and split while that group runs, once the group before it has
// retired (wgmma.wait_group 1), so two taps' fragments are held. Each chain
// ends with wait_group 0, the FADD into the running accumulators, and the
// consumer warps' arrivals on the stage's empty barrier. The accumulators
// hold, per thread, voxels g and g + 8 of channels 2t, 2t + 1 (+ 8j), so
// each store instruction of the epilogue writes four channels' whole
// 32-byte sectors of 8 consecutive voxels. No atomics and no split of K:
// the same bits on every call.
// Shared memory: 3 x 40 KB of weights and 2 x 31-37 KB of patch, 186-198
// KB, one block an SM; 384 threads; a consumer thread holds 2 x 32
// accumulators of the output, 2 x 32 of the chain and two taps' fragments.
// On the H100 SXM it runs at 69-76 % of the bound at the Encoder3D shapes
// at B = 32 (PERF.md, section 6).

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
// registers a thread after setmaxnreg: three warps share each SM
// sub-partition's 16384 registers (one of each warpgroup), 3 x 168 at
// launch, 56 + 2 x 224 after (40 for the producer spilled its loop)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;
constexpr int BCO = 64;      // output channels a block: wgmma's N
constexpr int BV = 256;      // voxels a block
constexpr int MT = 2;        // m64 tiles a warpgroup
constexpr int CB = 8;        // input channels a group (one k8 step a tap)
constexpr int TAPS = 27;
constexpr int CHAIN = 9;     // taps a chain of tensor-core sums (one dz)
// a weight stage: k-steps 0-8 the hi terms of the chain's 9 taps, 9-17 the
// lo terms, in 128-byte panels of 4 k-steps (the last half empty)
constexpr int WPANELS = 5;
constexpr int WSTAGE = WPANELS * BCO * 128;  // bytes
constexpr int WSTAGES = 3;
constexpr int PSTAGES = 2;

// The smallest n' >= n with n' = 8 mod 16: then 8 t * CS (t < 4) are
// distinct multiples of 8 modulo 32 banks, and a stride stays 16-byte whole
__host__ __device__ constexpr int bank_pad(int n) {
  return n + ((8 - n % 16) + 16) % 16;
}

// Tile geometry at width W: TD depths x TH rows x W columns of output, one
// depth a warpgroup, 64 / W rows an m64 tile
template <int W>
struct Geo {
  static_assert(W == 8 || W == 16 || W == 32 || W == 64, "width");
  static constexpr int TD = 2;
  static constexpr int TH = BV / (TD * W);   // 16, 8, 4, 2 rows
  static constexpr int PW = W + 8;           // patch row: cols 4 .. W + 3
  static constexpr int PROWS = (TD + 2) * (TH + 2);
  static constexpr int PLANE = (TH + 2) * PW;
  static constexpr int CS = bank_pad((TD + 2) * PLANE);
  static constexpr int PATCH = CB * CS;      // floats
  static constexpr int MSTEP = 64 / W * PW;  // the next m64 tile's rows
  // weights, patches, then the mbarriers, from a 1024-byte boundary
  static constexpr int BARS = WSTAGES * WSTAGE + PSTAGES * PATCH * 4;
  static constexpr size_t SMEM =
      1024 + BARS + 8 * (2 * PSTAGES + 2 * WSTAGES);
  static_assert(TH * W == NC / 2, "a warpgroup's voxels are one depth");
  static_assert(SMEM <= 232448, "exceeds a Hopper block's shared memory");
};

// Float offset of tf32 value (row r, k-step s, channel ci) in a weight
// stage: panel s / 4, 16-byte chunk 2 (s % 4) + ci / 4 of the 128-byte row,
// swizzled by r % 8 (hopper.cuh's layout)
__device__ __forceinline__ int packed_at(int r, int s, int ci) {
  const int j = 2 * (s % 4) + ci / 4;
  return (s / 4) * (BCO * 32) + r * 32 + ((j ^ (r % 8)) << 2) + ci % 4;
}

// The weights (cout, cin, 27) as the kernel stages them: for each 64 output
// channels, 8 input channels and dz, one WSTAGE-byte stage of hi and lo
// terms (tf32::split). One thread a weight.
__global__ void pack_weights(const float* __restrict__ w,
                             uint32_t* __restrict__ packed, int cin, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tap = i % TAPS, c = i / TAPS % cin, co = i / (TAPS * cin);
  uint32_t hi, lo;
  tf32::split(w[i], hi, lo);
  const int r = co % BCO, ci = c % CB, s = tap % CHAIN;
  uint32_t* st = packed + (size_t((co / BCO) * (cin / CB) + c / CB) * 3 +
                           tap / CHAIN) * (WSTAGE / 4);
  st[packed_at(r, s, ci)] = hi;
  st[packed_at(r, CHAIN + s, ci)] = lo;
}

// Copy the patch of input channels c0 .. c0 + 7 into the stage at shared
// address dst: the producer warpgroup's threads, 16 bytes a copy.
template <int W>
__device__ __forceinline__ void stage_patch(uint32_t dst,
                                            const float* __restrict__ x,
                                            int c0, int cin, int depth,
                                            int height, int b, int d0,
                                            int h0, int ptid) {
  using G = Geo<W>;
  constexpr int CH = W / 4;  // 16-byte chunks a row
  constexpr int N = CB * G::PROWS * CH;
  static_assert(N % NP == 0, "copies must divide evenly");
#pragma unroll 4
  for (int e = ptid; e < N; e += NP) {
    const int ch = e % CH, r = (e / CH) % G::PROWS, c = e / (CH * G::PROWS);
    const int td = r / (G::TH + 2), th = r % (G::TH + 2);
    const int z = d0 + td - 1, y = h0 + th - 1;
    const bool ok = z >= 0 && z < depth && y >= 0 && y < height;
    const size_t row = (size_t(b) * cin + c0 + c) * depth + z;
    const size_t at = ok ? (row * height + y) * W : 0;
    const int to = c * G::CS + td * G::PLANE + th * G::PW + 4 + 4 * ch;
    cp_async16(dst + 4 * to, x + at + 4 * ch, ok);
  }
}

// The A operands (hi and lo terms) of tap (dy, dx) of a chain for the
// thread's MT m64 tiles: p is the patch at the chain's depth, off[h] the
// thread's voxel row g + 8h at channel t and tap (0, 0); channels t, t + 4.
template <int W>
__device__ __forceinline__ void load_a(tf32::FragA (&a)[MT], const float* p,
                                       const int (&off)[2], int tap) {
  using G = Geo<W>;
  const float* q = p + tap / 3 * G::PW + tap % 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* r = q + i * G::MSTEP;
    tf32::split(r[off[0]], a[i].x[0][0], a[i].x[1][0]);
    tf32::split(r[off[1]], a[i].x[0][1], a[i].x[1][1]);
    tf32::split(r[off[0] + 4 * G::CS], a[i].x[0][2], a[i].x[1][2]);
    tf32::split(r[off[1] + 4 * G::CS], a[i].x[0][3], a[i].x[1][3]);
  }
}

// Output tile `tile` of the grid: the channel blocks of one voxel tile are
// consecutive, so blocks that run together share their patches in L2
template <int W>
struct Tile {
  int co0, b, d0, h0;
  __device__ __forceinline__ Tile(int tile, int cout, int tiles_h,
                                  int tiles_b) {
    const int nco = cout / BCO, vt = tile / nco, tb = vt % tiles_b;
    co0 = tile % nco * BCO;
    b = vt / tiles_b;
    d0 = tb / tiles_h * Geo<W>::TD;
    h0 = tb % tiles_h * Geo<W>::TH;
  }
};

template <int W>
__global__ void __launch_bounds__(NT, 1)
conv3d_fprop_wgmma(const float* __restrict__ x,
                   const uint32_t* __restrict__ packed,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int cin, int cout, int depth, int height, int tiles_h,
                   int tiles_b, int tiles) {
  using G = Geo<W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t wsm = smem_base_1k(smem_raw);  // the weight stages
  const uint32_t psm = wsm + WSTAGES * WSTAGE;  // the patch stages
  float* patch =
      reinterpret_cast<float*>(smem_raw + (psm - smem_u32(smem_raw)));
  // mbarriers: patch full, patch empty, weights full, weights empty
  const uint32_t pfull = wsm + G::BARS, pempty = pfull + 8 * PSTAGES;
  const uint32_t wfull = pempty + 8 * PSTAGES, wempty = wfull + 8 * WSTAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = cin / CB;

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
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(wfull + 8 * s, 1);          // one arrival and the bytes
      mbar_init(wempty + 8 * s, NC / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NC / 32) {
    // the producer: for each group of each tile, the patch, then its three
    // weight stages; n counts the groups staged, q = 3 n + dz the stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int ptid = tid - NC;
    int n = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const Tile<W> at(tile, cout, tiles_h, tiles_b);
      const char* wsrc = reinterpret_cast<const char*>(packed) +
                         size_t(at.co0 / BCO) * groups * 3 * WSTAGE;
      for (int cg = 0; cg < groups; ++cg, ++n) {
        const int ps = n % PSTAGES;
        mbar_wait(pempty + 8 * ps, ((n / PSTAGES) & 1) ^ 1);
        stage_patch<W>(psm + ps * G::PATCH * 4, x, cg * CB, cin, depth,
                       height, at.b, at.d0, at.h0, ptid);
        cp_async_arrive(pfull + 8 * ps);
        for (int dz = 0; dz < 3; ++dz) {
          const int q = 3 * n + dz, ws = q % WSTAGES;
          mbar_wait(wempty + 8 * ws, ((q / WSTAGES) & 1) ^ 1);
          if (ptid == 0) {
            mbar_expect_tx(wfull + 8 * ws, WSTAGE);
            bulk_copy(wsm + ws * WSTAGE,
                      wsrc + size_t(3 * cg + dz) * WSTAGE, WSTAGE,
                      wfull + 8 * ws);
          }
        }
      }
    }
    cp_async_wait_all();
    return;
  }

  // the consumers: warpgroup wg takes depth d0 + wg, warp wq of it voxels
  // 16 wq .. 16 wq + 15 of each of its m64 tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t = lane % 4;
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = 16 * wq + g + 8 * h;
    // tap (0, 0, 0) reads one column left of the voxel: + 3, not + 4
    off[h] = t * G::CS + wg * G::PLANE + v / W * G::PW + v % W + 3;
  }

  float part[MT][32] = {};
  int n = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile<W> at(tile, cout, tiles_h, tiles_b);
    float acc[MT][32] = {};
    for (int cg = 0; cg < groups; ++cg, ++n) {
      const int ps = n % PSTAGES;
      mbar_wait(pfull + 8 * ps, (n / PSTAGES) & 1);
      const float* pb = patch + ps * G::PATCH;
#pragma unroll 1
      for (int dz = 0; dz < 3; ++dz) {
        const int q = 3 * n + dz, ws = q % WSTAGES;
        mbar_wait(wfull + 8 * ws, (q / WSTAGES) & 1);
        const uint32_t bsm = wsm + ws * WSTAGE;
        const float* pz = pb + dz * G::PLANE;
        tf32::FragA a[2][MT];
        load_a<W>(a[0], pz, off, 0);
#pragma unroll
        for (int tap = 0; tap < CHAIN; ++tap) {
          tf32::FragA(&cur)[MT] = a[tap & 1];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            fence_regs(part[i]);
            tf32::fence_frag(cur[i]);
          }
          wg_arrive();
          // the small terms first (tf32.cuh's order)
#pragma unroll
          for (int i = 0; i < MT; ++i)
            tf32::wgmma_n64(part[i], cur[i].x[1], desc_k<BCO>(bsm, tap),
                            tap > 0);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            tf32::wgmma_n64(part[i], cur[i].x[0],
                            desc_k<BCO>(bsm, CHAIN + tap), 1);
#pragma unroll
          for (int i = 0; i < MT; ++i)
            tf32::wgmma_n64(part[i], cur[i].x[0], desc_k<BCO>(bsm, tap), 1);
          wg_commit();
          if (tap + 1 < CHAIN) {
            wg_wait<1>();  // the previous tap's group has read its fragments
            load_a<W>(a[(tap + 1) & 1], pz, off, tap + 1);
          }
        }
        wg_wait<0>();
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          fence_regs(part[i]);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[i][e] += part[i][e];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(wempty + 8 * ws);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(pempty + 8 * ps);
    }

    // acc[i][4j + 2h + e]: voxel row g + 8h of m64 tile i, channel 8j +
    // 2t + e; the producer meanwhile stages the next tile
    const int z = at.d0 + wg;
    if (z >= depth) continue;
    const size_t plane_out = size_t(depth) * height * W;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bv =
            bias != nullptr ? bias[at.co0 + 8 * j + 2 * t + e] : 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = 64 * i + 16 * wq + g + 8 * h;
            const int y = at.h0 + v / W;
            if (y < height)
              out[(size_t(at.b) * cout + at.co0 + 8 * j + 2 * t + e) *
                      plane_out +
                  (size_t(z) * height + y) * W + v % W] =
                  acc[i][4 * j + 2 * h + e] + bv;
          }
      }
  }
}

// The SMs of the current device (one resident block each)
cudaError_t sm_count(int& sms) {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  sms = counts[dev];
  return cudaSuccess;
}

template <int W>
cudaError_t launch(const float* x, const uint32_t* packed, const float* bias,
                   float* out, int b, int cin, int cout, int depth,
                   int height, cudaStream_t stream) {
  using G = Geo<W>;
  cudaError_t err = allow_smem<conv3d_fprop_wgmma<W>>(G::SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const int tiles_h = (height + G::TH - 1) / G::TH;
  const int tiles_b = (depth + G::TD - 1) / G::TD * tiles_h;
  const long long tiles = (long long)b * tiles_b * (cout / BCO);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int blocks = int(tiles < sms ? tiles : sms);
  conv3d_fprop_wgmma<W><<<blocks, NT, G::SMEM, stream>>>(
      x, packed, bias, out, cin, cout, depth, height, tiles_h, tiles_b,
      int(tiles));
  return cudaGetLastError();
}

}  // namespace

// Bytes of the packed weights hupr_conv3d_fprop writes for cin input and
// cout output channels: a stage for each 64 output channels, 8 input
// channels and kernel depth.
extern "C" long long hupr_conv3d_fprop_packed_bytes(int cin, int cout) {
  return (long long)(cout / BCO) * (cin / CB) * 3 * WSTAGE;
}

// Plain C entry point for ctypes: x (b, cin, depth, height, width), w (cout,
// cin, 3, 3, 3), bias (cout) or null, packed (hupr_conv3d_fprop_packed_bytes
// of scratch, on a 16-byte boundary), out (b, cout, depth, height, width),
// all contiguous float32; x on a 16-byte boundary; cin a multiple of 8,
// cout of 64, width 8, 16, 32 or 64. Launches pack_weights, then the
// kernel. Returns a cudaError_t (0 on success); allocates nothing and does
// not synchronize.
extern "C" int hupr_conv3d_fprop(const void* x, const void* w,
                                 const void* bias, void* packed, void* out,
                                 int b, int cin, int cout, int depth,
                                 int height, int width, void* stream) {
  if (b <= 0 || depth <= 0 || height <= 0 || cin <= 0 || cin % CB != 0 ||
      cout <= 0 || cout % BCO != 0)
    return int(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(bias);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = cout * cin * TAPS;
  pack_weights<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(w),
                                               pk, cin, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  switch (width) {
    case 8:
      return int(launch<8>(xf, pk, bf, of, b, cin, cout, depth, height, s));
    case 16:
      return int(launch<16>(xf, pk, bf, of, b, cin, cout, depth, height, s));
    case 32:
      return int(launch<32>(xf, pk, bf, of, b, cin, cout, depth, height, s));
    case 64:
      return int(launch<64>(xf, pk, bf, of, b, cin, cout, depth, height, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
