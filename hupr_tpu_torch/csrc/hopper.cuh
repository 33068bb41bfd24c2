// Hopper (sm_90a) building blocks of the attention kernels' tensor-core
// bodies and the conv forward's: cp.async staging of bfloat16 tiles into the
// 128-byte-swizzled layout that wgmma's shared-memory descriptors name, the
// descriptors, the warpgroup matrix multiply-accumulate (wgmma, bf16
// operands, float32 accumulators) and its fences; mbarriers and the copy
// engine's bulk copies for a producer warp's ring of stages. Inline PTX
// only: no CuTe templates, so the 30-odd kernel instantiations of the
// sources build in seconds.
//
// Tile layout. A (ROWS, C) bf16 tile of a row-major (n, C) panel is stored
// as C/64 column panels of ROWS rows of 128 bytes (64 elements); the
// 16-byte chunk j of row r sits at chunk j ^ (r % 8) of its row (the 128-byte
// swizzle), and every panel starts on a 1024-byte boundary. One layout
// serves both operand roles of wgmma:
//   - K-major (the contraction runs along C): an 8-row atom is 1024 bytes
//     (SBO); a k16 step moves 32 bytes along the row, and ROWS*128 bytes at
//     each new panel. LBO is not read.
//   - MN-major (the contraction runs along the rows, the product's N along
//     C), through wgmma's transpose bit, which 16-bit types allow: LBO is the
//     panel stride ROWS*128, SBO the 8-row step of 1024 bytes, and a k16
//     step is 16 rows, 2048 bytes.
// Accumulators of m64nN (float32): thread t of the warpgroup (warp w = t/32,
// lane l) holds d[4j + e] = D[16w + l/4 + 8*(e/2)][8j + 2*(l%4) + e%2]. The
// register A operand of m64nNk16 holds the same rows, and for k-step s the
// pairs (d[8s], d[8s+1]), (d[8s+2], d[8s+3]), (d[8s+4], d[8s+5]),
// (d[8s+6], d[8s+7]) of an accumulator over columns 16s..16s+15: a softmax
// computed on the logits' accumulator feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary of the dynamic shared memory (the swizzle
// atoms must start on one); allocate 1024 bytes more than the tiles take.
__device__ __forceinline__ uint32_t smem_base_1k(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Two consecutive output elements of a row, rounded once.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------- cp.async

// 16 bytes from global src into shared dst; zeros when !full (src-size 0:
// nothing is read, but src stays a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy that
// wgmma reads through; then a barrier makes them everyone's.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------- mbarriers

// A barrier in shared memory whose phase completes after `count` arrivals
// (and, where a copy names it, the bytes it expects). Thread 0 initializes;
// then mbar_fence_init and a block barrier make it everyone's.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival that also announces `bytes` of copies still to land.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the phase of the given parity has completed. A barrier starts
// in phase 0, so waiting on parity 1 returns at once: a producer waits on
// its empty barriers with (round & 1) ^ 1, a consumer on full ones with
// round & 1.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// An arrival on bar once every cp.async this thread has issued has landed;
// the barrier's count includes it (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both ends on 16-byte
// boundaries) from global src to shared dst by the copy engine, counted
// against bar's expected bytes.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Copy rows 0..ROWS-1 of the (., C) bf16 panel at src into the swizzled
// tile at shared address dst, zero-filling rows >= valid. All NT threads of
// the block take part; 16 bytes a thread per copy, neighbouring threads on
// neighbouring addresses of a row.
template <int ROWS, int C, int NT>
__device__ __forceinline__ void stage_tile(uint32_t dst, const bf16* src,
                                           int valid, int tid) {
  constexpr int CHUNKS = C / 8;  // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % NT == 0, "copies must divide evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / CHUNKS, j = e % CHUNKS;
    const bool ok = r < valid;
    const uint32_t at = dst + (j / 8) * (ROWS * 128) + r * 128 +
                        (((j % 8) ^ (r % 8)) << 4);
    cp_async16(at, src + size_t(ok ? r : 0) * C + j * 8, ok);
  }
}

// ---------------------------------------------------------- descriptors

__device__ __forceinline__ uint64_t desc_encode(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return uint64_t((addr & 0x3FFFFu) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}

// K-major operand: k-step s (C elements 16s..16s+15) of a ROWS-row tile.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int s) {
  return desc_encode(tile + (s / 4) * (ROWS * 128) + (s % 4) * 32, 16, 1024);
}

// MN-major operand: k-step s (tile rows 16s..16s+15), N along C.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int s) {
  return desc_encode(tile + s * 2048, ROWS * 128, 1024);
}

// ------------------------------------------------------- wgmma and fences

// Order the warpgroup's register writes before the wgmmas that read them.
__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register traffic across a wgmma fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int T, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[T][N][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        asm volatile("" : "+r"(a[t][i][j])::"memory");
}

// The register A operands of the S/16 k-steps of an m64nS accumulator, as
// TERMS bfloat16 terms each: x rounded once (TERMS = 1), or hi = bf16(x)
// and lo = bf16(x - hi) (TERMS = 2), whose products into one accumulator
// carry x to about 2^-17.
template <int S, int TERMS>
__device__ __forceinline__ void frags(const float (&d)[S / 2],
                                      uint32_t (&a)[TERMS][S / 16][4]) {
#pragma unroll
  for (int s = 0; s < S / 16; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x0 = d[8 * s + 2 * i], x1 = d[8 * s + 2 * i + 1];
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
        __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        a[t][s][i] = *reinterpret_cast<uint32_t*>(&h);
        x0 -= __low2float(h);
        x1 -= __high2float(h);
      }
    }
}

// Set a kernel's dynamic shared-memory limit on each device's first launch.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(bytes));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> float32. PTX names each
// accumulator register, so the operand lists are spelled out.
//   wgmma_ss_n64: D (64 x 64) (+)= A . B, A and B K-major in shared memory;
//     the first k-step passes accumulate = 0.
//   wgmma_rs<N>: D (64 x N) += A . B, A from registers, B MN-major in
//     shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// D (64 x N) += A . B for one 64-row tile at shared address b (MN-major):
// A is KS k-steps of register operands in TERMS bfloat16 terms (frags),
// all into the same accumulator. Waits for the products.
template <int N, int TERMS, int KS>
__device__ __forceinline__ void mma_regs(float (&d)[N / 2],
                                         uint32_t (&a)[TERMS][KS][4],
                                         uint32_t b) {
  fence_regs(d);
  fence_regs(a);
  wg_arrive();
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
      wgmma_rs<N>(d, a[t][s], desc_mn<64>(b, s));
  wg_commit();
  wg_wait<0>();
  fence_regs(d);
}

// wgmma adds into its float32 accumulator without rounding to nearest:
// chaining every key tile of a row into one accumulator (512 k-steps at
// N = 4096 in mode bf16) biases the sums by about 1e-5 relative, enough to
// round a bfloat16 output the other way from the twin several times as
// often as float32 sums do. Where the registers allow (C <= 128), the
// kernels chain one tile's k-steps into a fresh accumulator and add it to
// the running float32 sum with FADDs; at C = 256 the running (64, 256)
// sum alone takes 128 registers a thread, and the model's C = 256 shape has
// 4 tiles a row.
template <int C>
__host__ __device__ constexpr bool promote_tiles() { return C <= 128; }

}  // namespace hopper
