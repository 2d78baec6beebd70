// Hopper (sm_90a) building blocks shared by the flash-attention and fused
// cross-entropy kernels:
// mbarriers, TMA tensor loads, wgmma shared-memory descriptors for the
// 128-byte swizzle, wgmma.mma_async in its SS and RS forms, named barriers
// and setmaxnreg, each as inline PTX; on the host, tensor-map encoding.
//
// Tiles. A tile of `rows` x D bf16 rows (row-major in device memory, D = 64
// or 128) is loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B as D / 64
// "halves": boxes of 64 columns (128 bytes, the swizzle's widest box) by
// `rows`, each half `rows` * 128 bytes, 1024-byte aligned, one after the
// other. In a half, row r sits at r * 128 bytes with its eight 16-byte
// chunks permuted by r % 8; eight rows make one 1024-byte swizzle atom.
//
// Descriptors (`smem_desc`) read such a tile as a wgmma operand:
//  - K-major (the reduction runs along a row: Q and K in S = Q K^T):
//    SBO = 1024 bytes (the next 8 rows), LBO unused; the k16 step j of a
//    half starts 32 * j bytes into it, step j >= 4 in the next half.
//  - MN-major (the reduction runs down the rows: V in O = P V, dO and Q in
//    dV = P^T dO, dK = dS^T Q; both h and dl in the CE's d_head = h^T dl),
//    read with the transpose bit (of B, or of A in the SS form): SBO = 1024
//    bytes (the next 8 rows of the reduction), LBO = the half's size (the
//    next 64 output columns); the k16 step j starts 16 rows, 2048 bytes, on.
//
// Accumulator layout of wgmma m64nN (fp32): thread t of the warpgroup holds
// rows 16 * (t / 32) + (t % 32) / 4 and that + 8; register 4 * j + 2 * i + e
// is row (i) column 8 * j + 2 * (t % 4) + e. The four threads of a quad
// share a row. The RS A fragment (m64k16) of k-step s is, per thread,
// {row i = 0, columns 16 s + 2 (t % 4) + {0, 1}}, {i = 1, same},
// {i = 0, + 8}, {i = 1, + 8}: accumulator registers 8 s .. 8 s + 7 packed in
// pairs, so a score tile becomes the A operand of the next product without
// leaving registers.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#define DEV __device__ __forceinline__

namespace sm90 {

// -- shared memory and mbarriers ---------------------------------------------

DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

DEV void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
DEV void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
DEV void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

DEV void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits until the phase with parity `parity` has completed.
DEV void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// Box at coordinates (c0 innermost, c1, c2) of a 3-D tensor map into shared
// memory; completion is counted in bytes on `bar`. Out-of-range elements
// are filled with zeros.
DEV void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                     int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Box at coordinates (c0 innermost, c1) of a 2-D tensor map; as
// tma_load_3d otherwise.
DEV void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                     int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

DEV void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
DEV uint64_t smem_desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16)
         | (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

DEV void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

DEV void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
DEV void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands across
// the asynchronous product: registers pass through an empty asm.
template <int R>
DEV void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
DEV void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T (A or B transposed in
// storage when TRANS_A or TRANS_B: read MN-major), A and B in shared
// memory; `accumulate` 0 overwrites D.
template <int TRANS_B, int TRANS_A = 0>
DEV void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

// D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T with A from registers: the
// m64k16 fragment, four bf16x2 per thread.
template <int TRANS_B>
DEV void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, as wgmma_ss_n64.
template <int TRANS_B, int TRANS_A = 0>
DEV void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

// D[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T with A from registers: the
// m64k16 fragment, four bf16x2 per thread.
template <int TRANS_B>
DEV void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}
// D[64 x 256] (+)= A[64 x 16] * B[256 x 16]^T, as wgmma_ss_n64.
template <int TRANS_B, int TRANS_A = 0>
DEV void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db,
                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, %132, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

// D[64 x N] (+)= A B for the widths the kernels use.
template <int N, int TRANS_B, int TRANS_A = 0>
DEV void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                  int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64<TRANS_B, TRANS_A>(d, da, db, accumulate);
  } else if constexpr (N == 128) {
    wgmma_ss_n128<TRANS_B, TRANS_A>(d, da, db, accumulate);
  } else {
    static_assert(N == 256, "wgmma_ss: N is 64, 128 or 256");
    wgmma_ss_n256<TRANS_B, TRANS_A>(d, da, db, accumulate);
  }
}

template <int N, int TRANS_B>
DEV void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                  int accumulate) {
  if constexpr (N == 64) {
    wgmma_rs_n64<TRANS_B>(d, a, db, accumulate);
  } else {
    static_assert(N == 128, "wgmma_rs: N is 64 or 128");
    wgmma_rs_n128<TRANS_B>(d, a, db, accumulate);
  }
}

// Two fp32 values as one bf16x2 register (lo in the low half).
DEV uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// -- named barriers ---------------------------------------------------------

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads: bar_sync
// waits for them all, bar_arrive counts this warp without waiting.
DEV void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

DEV void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// -- registers ---------------------------------------------------------------

// Hands registers back (producer) or takes them (consumers); every warp of
// the warpgroup executes it.
template <int N>
DEV void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
DEV void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -- host: tensor maps -------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime's entry
// point query so the library needs no -lcuda; null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// True on success; otherwise says why on stderr (the caller returns
// cudaErrorInvalidValue, which carries no detail).
inline bool check_encode(CUresult res, const char* what) {
  if (res != CUDA_SUCCESS)
    std::fprintf(stderr, "cuTensorMapEncodeTiled (%s): CUresult %d\n", what,
                 int(res));
  return res == CUDA_SUCCESS;
}

// A bf16 tensor [planes, rows, D] (contiguous) read in boxes of 64 columns
// by `box_rows` rows, 128-byte swizzled, zeros past every edge.
inline bool map_tiles(CUtensorMap* map, const void* base, int planes,
                      int rows, int D, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) {
    std::fprintf(stderr, "cuTensorMapEncodeTiled: not found in libcuda\n");
    return false;
  }
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(rows),
                              cuuint64_t(planes)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2,
                                 cuuint64_t(D) * 2 * cuuint64_t(rows)};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return check_encode(
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE),
      "bf16 tiles");
}

// A bf16 matrix of `rows` x `cols` (row-major, `row_stride` elements from
// one row to the next, so a column range of a wider matrix can be mapped)
// read in boxes of 64 columns by `box_rows` rows, 128-byte swizzled, zeros
// past `rows` and `cols`.
inline bool map_2d(CUtensorMap* map, const void* base, int rows, int cols,
                   long long row_stride, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) {
    std::fprintf(stderr, "cuTensorMapEncodeTiled: not found in libcuda\n");
    return false;
  }
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(row_stride) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return check_encode(
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE),
      "bf16 matrix");
}

}  // namespace sm90
