// Float32 products on Hopper's tensor cores in 3xTF32: the building blocks
// of the attention kernels' float32 bodies (attention_fwd.cu's and
// attention_bwd.cu's _tf32 kernels) and the conv kernels'. Warp-level
// mma.sync m16n8k8 with tf32 operands and float32 accumulators, fed from
// float32 tiles in shared memory; and warpgroup wgmma m64n64k8 and m64n32k8
// with a tf32 A from registers (below, the conv kernels').
//
// 3xTF32. A float32 x is split once into two tf32 terms, hi = rna(x) and
// lo = x - hi (rna: round to nearest, ties away, to tf32's 10-bit mantissa;
// x - hi is exact in float32, and the tensor core truncates it to tf32). A
// product a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into one
// float32 accumulator, the small terms first (CUTLASS's order); a_lo.b_lo
// is dropped. Products of tf32 values are exact in float32, so what is
// left is about 2^-21 of each product: float32's accuracy, the result that
// the TF32 pin of the entry points (utils/device.float32_math: TF32 off in
// cuBLAS and cuDNN) protects. One TF32 product alone would be off by about
// 2^-11.
//
// The split happens at fragment load (three operations in registers per
// value, split below), not at staging: hi and lo tiles in shared memory
// would double it, past a block's 227 KB for pass (b) of the backward at
// C = 128 (416 KB with its two-stage ring).
//
// Tile layout. A (ROWS, W) float32 tile (W a multiple of 32) is stored
// row-major with each row's 16-byte chunks permuted: chunk j of row r sits
// at chunk j ^ key(r), key(r) = 4 (r % 2) + 2 ((r / 2) % 2) + (r / 4) % 2,
// which keeps cp.async's 16-byte copies whole. Every way the kernels read
// or write a tile is then free of bank conflicts (lane l of a warp,
// g = l / 4, t = l % 4; rows r0 and columns c0 multiples of 8):
//   - 16-byte loads along the row (Chunks: the contraction runs along W),
//     lane (g, t) reading chunk c0/4 + t of row r0 + g: the two rows of a
//     quarter-warp differ in bit 2 of their keys;
//   - 4-byte loads along the row (load_a), lane (g, t) reading element
//     (r0 + g, c0 + t): key(g) is 8 distinct values;
//   - 4-byte loads down the column (load_b_mn: the contraction runs along
//     the rows), lane (g, t) reading (r0 + t, c0 + g) or (r0 + t + 4,
//     c0 + g): the chunks c0/4 + g/4 xor key are 8 distinct values;
//   - 8-byte stores of an accumulator's pairs (store2), (r0 + g, c0 + 2t);
//   - 4-byte loads down the column two rows apart (PairCols), under the
//     pairs layout below.
// Padding rows by 4 floats instead would leave the column loads 2-way
// conflicted. mma.sync takes its fragments thread by thread, so one layout
// serves A and B in both orientations: no transposed copies.
//
// Fragments of m16n8k8 (PTX ISA, "matrix fragments for mma.m16n8k8",
// .tf32): A (16 x 8, row) a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4); B (8 x 8, col) b0 = (k t, n g), b1 = (k t + 4, n g);
// C and D (16 x 8) d[e] = (g + 8 (e / 2), 2t + e % 2).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tf32 {

// Chunk permutation of tile row r
__device__ __forceinline__ int swz_key(int r) {
  return ((r & 1) << 2) | (r & 2) | ((r >> 2) & 1);
}

// The pairs layout: chunk permutation r & 6, for a tile that is read only
// down its columns at rows r0 + 2t and r0 + 2t + 1 (the forward's M, whose
// B fragments for P.M take the keys of the logits' accumulator pairs). Lane
// (g, t) reads chunk c0/4 + g/4 of row r0 + 2t (+ 1): swz_key gives rows 0,
// 2, 4 and 6 the keys 0, 2, 1 and 3, which leave 4 distinct chunks and a
// 2-way conflict; r & 6 moves bits 1 and 2 of the chunk by t and leaves bit
// 0 to g/4, 8 distinct chunks.
__device__ __forceinline__ int swz_key_pairs(int r) { return r & 6; }

// Float offset of element (r, c) of a swizzled tile with W floats a row
template <int W, bool PAIRS = false>
__device__ __forceinline__ int swz(int r, int c) {
  const int key = PAIRS ? swz_key_pairs(r) : swz_key(r);
  return r * W + ((((c >> 2) ^ key) << 2) | (c & 3));
}

// Copy rows 0..ROWS-1 of the (., W) float32 panel at src into the swizzled
// tile dst (the pairs layout with PAIRS), zero-filling rows >= valid. All
// NT threads of the block take part, 16 bytes a copy; src must sit on a
// 16-byte boundary.
template <int ROWS, int W, int NT, bool PAIRS = false>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int valid, int tid) {
  constexpr int CHUNKS = W / 4;
  static_assert(W % 32 == 0, "rows of whole swizzle groups");
  static_assert(ROWS * CHUNKS % NT == 0, "copies must divide evenly");
  const uint32_t base = hopper::smem_u32(dst);
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / CHUNKS, j = e % CHUNKS;
    const bool ok = r < valid;
    hopper::cp_async16(base + 4 * swz<W, PAIRS>(r, 4 * j),
                       src + size_t(ok ? r : 0) * W + 4 * j, ok);
  }
}

// x as hi + lo tf32 terms. hi = rna(x), as cvt.rna.tf32.f32 gives it for
// finite x, in two integer operations (half of the dropped bits' weight
// added to the magnitude, then those bits cleared), which take fewer
// instruction slots than the cvt. lo = x - hi, exact in float32, is passed as it is:
// the tensor core reads the tf32 bits of its operands, so lo is truncated
// to tf32, within 2^-10 of itself and 2^-21 of x.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Fragments as tf32 terms: [0] hi, [1] lo
struct FragA {
  uint32_t x[2][4];
};
struct FragB {
  uint32_t x[2][2];
};

// A fragment of the m-tile at rows r0.., k-step at columns c0.. of a
// swizzled tile stored [m][k] (K-major), one 4-byte load per value
template <int W>
__device__ __forceinline__ FragA load_a(const float* s, int r0, int c0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  FragA f;
  split(s[swz<W>(r0 + g, c0 + t)], f.x[0][0], f.x[1][0]);
  split(s[swz<W>(r0 + g + 8, c0 + t)], f.x[0][1], f.x[1][1]);
  split(s[swz<W>(r0 + g, c0 + t + 4)], f.x[0][2], f.x[1][2]);
  split(s[swz<W>(r0 + g + 8, c0 + t + 4)], f.x[0][3], f.x[1][3]);
  return f;
}

// B fragment of the n-tile at n0.., k-step at k0.., from a swizzled tile
// stored [k][n] (MN-major: rows k0.., columns n0..)
template <int W>
__device__ __forceinline__ FragB load_b_mn(const float* s, int k0, int n0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  FragB f;
  split(s[swz<W>(k0 + t, n0 + g)], f.x[0][0], f.x[1][0]);
  split(s[swz<W>(k0 + t + 4, n0 + g)], f.x[0][1], f.x[1][1]);
  return f;
}

// Offsets of the 16-byte chunks lane (g, t) reads from row r of a swizzled
// tile with W floats a row for two k-steps at columns c0 .. c0 + 15 (c0 a
// multiple of 16): chunk c0/4 + t. Two per row, one for each value of bit 4
// of c0, since key(r) < 8 leaves the bits of c0 above 4 alone.
template <int W>
struct Chunks {
  int off[2];
  Chunks() = default;
  __device__ __forceinline__ Chunks(int r, int t)
      : off{swz<W>(r, 4 * t), swz<W>(r, 16 + 4 * t)} {}
  __device__ __forceinline__ float4 load(const float* s, int c0) const {
    return *reinterpret_cast<const float4*>(s + off[(c0 >> 4) & 1] +
                                            (c0 & ~31));
  }
};

// The fragments of two k-steps from 16-byte loads (Chunks). k-step h takes
// columns 4t + 2h and 4t + 2h + 1 of c0 .. c0 + 15 as its k = t and t + 4:
// the two k-steps cover the 16 columns once, and a product summed over k in
// that order is the same product, as long as A and B take the same order.
// A of the m-tile at rows (r0 + g, r0 + g + 8), read as ra and rb; B of the
// n-tile at row n0 + g of a tile stored [n][k], read as rn.
__device__ __forceinline__ void frags_a2(float4 ra, float4 rb,
                                         FragA (&f)[2]) {
  split(ra.x, f[0].x[0][0], f[0].x[1][0]);
  split(rb.x, f[0].x[0][1], f[0].x[1][1]);
  split(ra.y, f[0].x[0][2], f[0].x[1][2]);
  split(rb.y, f[0].x[0][3], f[0].x[1][3]);
  split(ra.z, f[1].x[0][0], f[1].x[1][0]);
  split(rb.z, f[1].x[0][1], f[1].x[1][1]);
  split(ra.w, f[1].x[0][2], f[1].x[1][2]);
  split(rb.w, f[1].x[0][3], f[1].x[1][3]);
}
__device__ __forceinline__ void frags_b2(float4 rn, FragB& f0, FragB& f1) {
  split(rn.x, f0.x[0][0], f0.x[1][0]);
  split(rn.y, f0.x[0][1], f0.x[1][1]);
  split(rn.z, f1.x[0][0], f1.x[1][0]);
  split(rn.w, f1.x[0][1], f1.x[1][1]);
}

// d += a.b, m16n8k8, tf32 operands, float32 accumulators. Not volatile:
// a pure function of its operands, which the compiler may schedule.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a.b, m16n8k8, tf32 operands, float32 accumulators: the first product
// of a chain of sums, from zero
__device__ __forceinline__ void mma_from_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d[j] += a.b[j] for J n-tiles in 3xTF32: lo.hi, hi.lo, then hi.hi, each
// term over every n-tile in turn, so that consecutive mma.sync write
// different accumulators instead of waiting on each other
template <int J>
__device__ __forceinline__ void mma3(float (&d)[J][4], const FragA& a,
                                     const FragB (&b)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.x[1], b[j].x[0]);
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.x[0], b[j].x[1]);
#pragma unroll
  for (int j = 0; j < J; ++j) mma(d[j], a.x[0], b[j].x[0]);
}

// The A fragment of the k-step over keys 8s .. 8s + 7 from the logits'
// accumulator pairs: n-tile s of an m16n8 accumulator holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), and A takes key 2t as its
// k = t and key 2t + 1 as k = t + 4. B must take its keys in the same
// order (PairCols).
__device__ __forceinline__ FragA frag_a_pairs(const float (&d)[4]) {
  FragA f;
  split(d[0], f.x[0][0], f.x[1][0]);
  split(d[2], f.x[0][1], f.x[1][1]);
  split(d[1], f.x[0][2], f.x[1][2]);
  split(d[3], f.x[0][3], f.x[1][3]);
  return f;
}

// Offsets of the values lane (g, t) reads for the B fragments that go with
// frag_a_pairs, from a tile stored [key][n] in the pairs layout: rows k0 +
// 2t and k0 + 2t + 1 of column n0 + g (k0, n0 multiples of 8). The chunk is
// (n0/4 + g/4) ^ 2t = 8 (n0/32) + 2 ((n0/8 % 4) ^ t) + g/4: four offsets a
// thread, one for each n0/8 % 4.
template <int W>
struct PairCols {
  int off[4];
  __device__ __forceinline__ explicit PairCols(int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      off[b] = 2 * t * W + (((2 * (b ^ t)) | (g >> 2)) << 2) + (g & 3);
  }
  __device__ __forceinline__ FragB load(const float* s, int k0,
                                        int n0) const {
    const float* p = s + k0 * W + off[(n0 >> 3) & 3] + (n0 & ~31);
    FragB f;
    split(p[0], f.x[0][0], f.x[1][0]);
    split(p[W], f.x[0][1], f.x[1][1]);
    return f;
  }
};

// ------------------------------------------------- wgmma with tf32 operands
//
// wgmma.mma_async m64nNk8 .tf32 takes A from registers or shared memory and
// B from shared memory, both K-major: tf32 has no transpose bit. A
// (M, K) = (64, 8) register operand holds, in warp w of the warpgroup, the
// m16n8k8 A fragment of rows 16w .. 16w + 15: a[0] = (g, t), a[1] =
// (g + 8, t), a[2] = (g, t + 4), a[3] = (g + 8, t + 4), so FragA's hi or lo
// terms serve as they are. B is a K-major tile in hopper.cuh's 128-byte
// swizzle: 32 tf32 values a 128-byte row are 4 k8 steps, and k-step s of a
// ROWS-row tile is hopper::desc_k<ROWS>(tile, s), the bytes of a bf16 k16
// step. The accumulator is hopper.cuh's m64nN layout.

// d (64 x 64) = a . b + (accumulate ? d : 0), a from registers (tf32 bits:
// the tensor core reads the top 19 bits of each), b by its descriptor.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 32) = a . b + (accumulate ? d : 0): wgmma_n64 on 32 columns, b
// the descriptor of a K-major tile's rows from its first.
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Keep the compiler from moving register traffic of an A operand across a
// wgmma fence, as hopper::fence_regs does for accumulators.
__device__ __forceinline__ void fence_frag(FragA& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.x[h][i])::"memory");
}

// Two consecutive elements (r, c), (r, c + 1) of a swizzled tile (c even)
template <int W>
__device__ __forceinline__ void store2(float* s, int r, int c, float a,
                                       float b) {
  *reinterpret_cast<float2*>(s + swz<W>(r, c)) = make_float2(a, b);
}

}  // namespace tf32
