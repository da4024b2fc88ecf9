// The wgmma + TMA GEMM that the port's fused-MLP kernels share (sm_90a):
// K1 (csrc/fused_mlp.cu, C 128-384) and K3 (csrc/fused_mlp_blocked.cu,
// C a multiple of 64) include it and define their own __global__ kernels around gemm<>.
//
// One GEMM, five kinds of product (the fused MLP's F1, F2; B1, B2, B3):
//   UP    out0 = bf16(gelu(A B^T + bias))                  A [M, K], B [N, K]
//   DOWN  out0 = bf16(A B^T + bias)
//   DH    u = A0 B0^T and dp = A1 B1 on one tile: out0 = bf16(gelu(u + bias)),
//         dh = dp * gelu'(u + bias), out1 = bf16(dh), ws = per-row-tile
//         column sums of the f32 dh
//   DX    out0 = bf16(A B)                                 B [K, N]
//   DW    out0 = A0^T B0 and out1 = A1^T B1, K split into f32 partials (ws)
//         when splits > 1                                  A [K, M], B [K, N]
// * A persistent grid of at most one CTA per SM walks the output tiles (BM =
//   128 rows x BN columns, rows fastest) in a fixed order. One thread of the
//   producer warpgroup issues TMA loads (128-byte swizzle; K-major tiles as
//   one box of 64 K x up to 256 rows, MN-major ones as [64 x 64] boxes) into
//   a ring of shared-memory stages of K = 64 guarded by full / empty
//   mbarriers. Two consumer warpgroups run wgmma.mma_async m64nBNk16 on the
//   stages and release each one stage behind (wgmma.wait_group 1).
//   setmaxnreg gives the consumers 232 registers a thread, the producer 40
//   (ptxas allocates the consumers' code for 232; the launch bound alone
//   would hold every thread to 168).
// * Two schedules of the consumers:
//   COOP      both warpgroups take every tile, 64 rows each, and run its
//             epilogue together while the tensor cores wait (K3; K1's F2,
//             B2, B3, whose epilogues are a bias add and a store);
//   PINGPONG  each warpgroup owns every other tile of the CTA's walk, all
//             128 rows (two m64 blocks), and the two take turns at the
//             tensor cores (an mbarrier pair orders their main loops): one
//             tile's GELU epilogue runs while the other warpgroup's
//             products run (K1's F1 and B1). The epilogue goes through
//             shared memory: the accumulators are dumped to a staging tile
//             and a rolled loop applies bias and GELU to 8 columns a thread
//             and stores 16 coalesced bytes (epilogue_staged).
//   On the H100 the GELU epilogues still cost more than their tiles' main
//   loops (PERF.md), most likely because they share the shared-memory
//   and load/store bandwidth that the other warpgroup's wgmma operand reads
//   and the TMA fills take. Storing through TMA from the staging tile, and
//   an erf without erff's branch, measured no faster, so neither is here.
// * Operands stored MN-major reach wgmma through its transpose bits, from
//   TMA boxes taken along the MN dimension: no copy.
// * Ragged edges: TMA zero-fills reads past the tensor, so padded rows or
//   columns add nothing to any product; stores skip them.
// * Every host entry point launches on the caller's stream, allocates
//   nothing, and returns 0, a CUDA error code (cudaGetLastError after each
//   launch), or a negative code for a refusal on the host (kBadArgs,
//   kBadMap).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                  // output rows per tile
constexpr int BK = 64;                   // K per stage: one 128-byte swizzle row of bf16
constexpr int NT = 384;                  // producer warpgroup + two consumer warpgroups
constexpr int BOX_BYTES = 64 * 64 * 2;   // one [64 x 64] bf16 TMA box
constexpr int A_BYTES = BM * BK * 2;     // an A operand tile, 16 KB
constexpr int COLSUM_ROWS = 32;          // rows per db2 partial
constexpr int MAX_SMEM = 232448;         // 227 KB of dynamic shared memory a block

enum Kind { UP, DOWN, DH, DX, DW };
enum Sched { COOP, PINGPONG };

// Operand majors of each product (MN-major operands go through wgmma's
// transpose bits) and whether a tile carries a second product (B1: g W2).
template <int KIND>
struct KindTraits {
  static constexpr bool A_MN = KIND == DW;
  static constexpr bool B_MN = KIND == DX || KIND == DW;
  static constexpr bool DUAL = KIND == DH;
};

// Shared memory of one GEMM: the ring (at most 6 stages: 192 KB of them
// under COOP, what the rest leaves under PINGPONG), full / empty mbarriers
// per stage, the ping-pong turn pair, B1's per-warp column sums and the
// PINGPONG staging.
template <int BN, int KIND, int SCHED>
struct Plan {
  static constexpr int MB = SCHED == PINGPONG ? 2 : 1;  // m64 blocks a warpgroup owns
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = (A_BYTES + B_BYTES) * (KindTraits<KIND>::DUAL ? 2 : 1);
  static constexpr int RED = KIND == DH ? 8 * BN * 4 : 0;
  // PINGPONG epilogues (F1, B1) go through shared memory: per warpgroup a
  // padded f32 tile of one m64 block (two in B1: u and dp) and the bias
  // slices of its current and next tile
  static constexpr bool STAGED = SCHED == PINGPONG;
  static constexpr int LD = BN + 8;  // staging row in floats: conflict-free float2 dumps
  static constexpr int STAGING = STAGED ? 2 * (KindTraits<KIND>::DUAL ? 2 : 1) * 64 * LD * 4 : 0;
  static constexpr int BIAS = STAGED ? 2 * 2 * BN * 4 : 0;
  static constexpr int FIXED = 1024 + 16 + RED + STAGING + BIAS;
  static constexpr int RING = SCHED == PINGPONG ? MAX_SMEM - FIXED - 6 * 16 : 192 * 1024;
  static constexpr int STAGES = RING / STAGE > 6 ? 6 : RING / STAGE;
  static constexpr int SMEM = FIXED + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(SMEM <= MAX_SMEM, "plan exceeds 227 KB");
  static_assert(STAGES >= 2, "ring too short");
};

// Kernel arguments. Product 0 writes out0 [rows0, cols0]; in B3 product 1
// writes out1 [rows1, cols1]; in B1 the second product (a1, b1) shares
// product 0's tile and out1 takes dh.
struct GemmArgs {
  CUtensorMap a0, b0, a1, b1;
  const float* bias;  // b1 (F1, B1) or b2 (F2), [cols0]
  void* out0;         // bf16: h (F1, B1), out (F2), dx (B2), dW1 (B3)
  void* out1;         // bf16: dh (B1), dW2 (B3)
  float* ws;          // B1: db1 partials [row tiles, cols0]; B3 with splits > 1:
                      // [splits][rows0*cols0 + rows1*cols1] f32 partials
  int rows0, cols0, rows1, cols1;
  int k;              // contraction length
  int splits;         // splits of K (B3), else 1
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Tile {
  int prod, split, row0, col0, kb, ke;  // k-steps [kb, ke) of BK
};

__host__ __device__ __forceinline__ int tiles_per_split(const GemmArgs& a, int bn) {
  return cdiv(a.rows0, BM) * cdiv(a.cols0, bn) + cdiv(a.rows1, BM) * cdiv(a.cols1, bn);
}

// Tile t of the persistent walk: split-major, then product 0's tiles before
// product 1's, row tiles fastest (ops/fused_mlp.py:blocked_tiles mirrors it).
__device__ __forceinline__ Tile decode(const GemmArgs& a, int bn, int t) {
  const int per = tiles_per_split(a, bn);
  const int tiles0 = cdiv(a.rows0, BM) * cdiv(a.cols0, bn);
  Tile c;
  c.split = t / per;
  int q = t - c.split * per;
  c.prod = q >= tiles0;
  if (c.prod) q -= tiles0;
  const int mt = cdiv(c.prod ? a.rows1 : a.rows0, BM);
  c.row0 = (q % mt) * BM;
  c.col0 = (q / mt) * bn;
  const int ks = cdiv(a.k, BK);
  c.kb = (int)((int64_t)c.split * ks / a.splits);
  c.ke = (int)((int64_t)(c.split + 1) * ks / a.splits);
  return c;
}

__device__ __forceinline__ float gelu_f(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box at element coordinates (c0 inner, c1 outer) into shared memory,
// completing on mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared without a register round trip (bias slices).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Named barrier of one consumer warpgroup.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads across wgmma.wait_group.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major: 8-row groups
// of 128-byte rows SBO = 1024 bytes apart (LBO unused, 1). MN-major: 8-row K
// groups SBO = 1024 apart, 64-element MN blocks LBO = one box (8 KB) apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, bool mn_major) {
  const uint64_t lbo = mn_major ? (BOX_BYTES >> 4) : 1;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lbo << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Descriptor of k16 step kk (0..3) of a stage's operand tile: K-major tiles
// advance 32 bytes along the swizzled row, MN-major ones two 8-row groups.
__device__ __forceinline__ uint64_t step_desc(uint32_t tile, int kk, bool mn_major) {
  return smem_desc(tile + (mn_major ? kk * 2048 : kk * 32), mn_major);
}

// d[32] (+)= A[64 x 16] * B[16 x 64] (m64n64k16, bf16 in, f32 accumulate);
// TA / TB: the operand is MN-major (1) or K-major (0) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64] (+)= A[64 x 16] * B[16 x 128] (m64n128k16, bf16 in, f32 accumulate);
// TA / TB: the operand is MN-major (1) or K-major (0) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[96] (+)= A[64 x 16] * B[16 x 192] (m64n192k16, bf16 in, f32 accumulate);
// TA / TB: the operand is MN-major (1) or K-major (0) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[128] (+)= A[64 x 16] * B[16 x 256] (m64n256k16, bf16 in, f32 accumulate);
// TA / TB: the operand is MN-major (1) or K-major (0) in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (BN == 64)
    wgmma_n64<TA, TB>(d, da, db, acc);
  else if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db, acc);
  else if constexpr (BN == 192)
    wgmma_n192<TA, TB>(d, da, db, acc);
  else
    wgmma_n256<TA, TB>(d, da, db, acc);
}

// ---------------------------------------------------------------------------
// the GEMM: producer, consumers, epilogues
// ---------------------------------------------------------------------------

// A tile [128 rows x 64 K]: one box along K (K-major) or two [64 K x 64 MN]
// boxes (MN-major), at (row0, k0).
template <bool MN>
__device__ __forceinline__ void load_a(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0,
                                       int k0) {
  if constexpr (MN) {
    tma_load(dst, m, bar, row0, k0);
    tma_load(dst + BOX_BYTES, m, bar, row0 + 64, k0);
  } else {
    tma_load(dst, m, bar, k0, row0);
  }
}

// B tile [BN x 64 K]: one box along K (K-major) or BN / 64 [64 K x 64 MN]
// boxes (MN-major), at (col0, k0).
template <bool MN, int BN>
__device__ __forceinline__ void load_b(uint32_t dst, const CUtensorMap* m, uint32_t bar, int col0,
                                       int k0) {
  if constexpr (MN) {
#pragma unroll
    for (int i = 0; i < BN / 64; ++i) tma_load(dst + i * BOX_BYTES, m, bar, col0 + 64 * i, k0);
  } else {
    tma_load(dst, m, bar, k0, col0);
  }
}

// One thread: walk this CTA's tiles and fill the ring, one stage per k-step,
// in the walk's order (under PINGPONG the two warpgroups' tiles alternate).
template <int BN, int KIND, int SCHED>
__device__ __forceinline__ void producer(const GemmArgs& a, uint32_t ring, uint32_t full,
                                         uint32_t empty) {
  typedef KindTraits<KIND> T;
  typedef Plan<BN, KIND, SCHED> P;
  const int total = tiles_per_split(a, BN) * a.splits;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile c = decode(a, BN, t);
    const CUtensorMap* ma = c.prod ? &a.a1 : &a.a0;
    const CUtensorMap* mb = c.prod ? &a.b1 : &a.b0;
    for (int k = c.kb; k < c.ke; ++k) {
      const uint32_t fb = full + stage * 8;
      mbar_wait(empty + stage * 8, phase ^ 1);  // the first pass finds every stage free
      mbar_expect_tx(fb, P::STAGE);
      const uint32_t s = ring + stage * P::STAGE;
      const int k0 = k * BK;
      load_a<T::A_MN>(s, ma, fb, c.row0, k0);
      load_b<T::B_MN, BN>(s + A_BYTES, mb, fb, c.col0, k0);
      if constexpr (T::DUAL) {
        load_a<false>(s + A_BYTES + P::B_BYTES, &a.a1, fb, c.row0, k0);
        load_b<true, BN>(s + 2 * A_BYTES + P::B_BYTES, &a.b1, fb, c.col0, k0);
      }
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Named barrier of the two consumer warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// COOP epilogue of one tile, from registers; warpgroup wg has rows 64*wg.
// Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
// 16w + lane/4 (+8), columns 8n + 2*(lane%4) (+1) in d[4n + 2i + j] (i: +8
// rows, j: +1 column).
template <int BN, int KIND, int NA2>
__device__ __forceinline__ void epilogue(const GemmArgs& a, const Tile& c, float (&acc)[BN / 2],
                                         float (&acc2)[NA2], float* red, int wg) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r_a = c.row0 + wg * 64 + warp * 16 + (lane >> 2);
  const int c_a = c.col0 + 2 * (lane & 3);
  const int rows = c.prod ? a.rows1 : a.rows0, cols = c.prod ? a.cols1 : a.cols0;
  if constexpr (KIND == DH) {
    bf16* hout = static_cast<bf16*>(a.out0);
    bf16* dhout = static_cast<bf16*>(a.out1);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = c_a + 8 * n;
      float s0 = 0.0f, s1 = 0.0f;
      if (col < cols) {  // uniform over the warp: cols is a multiple of 8
        const float bx = a.bias[col], by = a.bias[col + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = r_a + 8 * i;
          if (row < rows) {
            float hv[2], dv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float z = acc[4 * n + 2 * i + j] + (j ? by : bx);
              const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752f));
              const float pdf = 0.3989422804014327f * expf(-0.5f * z * z);
              hv[j] = z * cdf;
              dv[j] = acc2[4 * n + 2 * i + j] * (cdf + z * pdf);
            }
            const int64_t o = (int64_t)row * cols + col;
            *reinterpret_cast<__nv_bfloat162*>(hout + o) = __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(dhout + o) = __floats2bfloat162_rn(dv[0], dv[1]);
            s0 += dv[0];
            s1 += dv[1];
          }
        }
      }
      // column sums of the unrounded dh over the warp's 16 rows
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (lane < 4) {
        red[(wg * 4 + warp) * BN + 8 * n + 2 * lane] = s0;
        red[(wg * 4 + warp) * BN + 8 * n + 2 * lane + 1] = s1;
      }
    }
    consumers_sync();
    float* part = a.ws + (int64_t)(c.row0 / BM) * a.cols0;
    for (int j = threadIdx.x - 128; j < BN; j += 256) {
      if (c.col0 + j < cols) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += red[w * BN + j];  // fixed order
        part[c.col0 + j] = s;
      }
    }
    consumers_sync();  // red is free for the next tile
  } else {
    float* wsp = nullptr;
    if (KIND == DW && a.splits > 1)
      wsp = a.ws + (int64_t)c.split * ((int64_t)a.rows0 * a.cols0 + (int64_t)a.rows1 * a.cols1) +
            (c.prod ? (int64_t)a.rows0 * a.cols0 : 0);
    bf16* out = static_cast<bf16*>(c.prod ? a.out1 : a.out0);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = c_a + 8 * n;
      if (col >= cols) continue;
      float bx = 0.0f, by = 0.0f;
      if constexpr (KIND == UP || KIND == DOWN) {
        bx = a.bias[col];
        by = a.bias[col + 1];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r_a + 8 * i;
        if (row >= rows) continue;
        float v0 = acc[4 * n + 2 * i] + bx, v1 = acc[4 * n + 2 * i + 1] + by;
        if constexpr (KIND == UP) {
          v0 = gelu_f(v0);
          v1 = gelu_f(v1);
        }
        const int64_t o = (int64_t)row * cols + col;
        if (wsp)
          *reinterpret_cast<float2*>(wsp + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// PINGPONG epilogue (F1, B1) of one tile, which the warpgroup owns whole:
// for each m64 block it dumps its f32 accumulators to its staging tile
// (stage [64][LD]; B1 also dp's [64][LD] after it), then walks the block in
// chunks of 8 columns, consecutive threads along a row. A thread keeps one
// chunk (CH divides 128), so its 8 bias values sit in registers; each
// iteration applies bias and GELU (B1: and GELU', dh) to 8 independent
// elements and makes one coalesced 16-byte store per output, the bounds
// guarding only the stores. Only the dump is straight-line code. B1's db1
// partials: each thread sums the f32 dh of its chunk, then lanes of equal
// chunk, then the four warps, in a fixed order.
template <int BN, int KIND, int NA2>
__device__ __forceinline__ void epilogue_staged(const GemmArgs& a, const Tile& c,
                                                float (&acc)[2][BN / 2], float (&acc2)[2][NA2],
                                                float* stage, float* red, const float* bias,
                                                int wg) {
  constexpr int LD = BN + 8, CH = BN / 8;
  constexpr bool DUAL = KindTraits<KIND>::DUAL;
  static_assert(128 % CH == 0, "a thread keeps one chunk");
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int rows = a.rows0, cols = a.cols0;
  float* sd = stage + 64 * LD;
  float cs[8] = {};
  cp_async_wait_all();  // this thread's part of the bias slice
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int r = warp * 16 + (lane >> 2);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = (r + 8 * i) * LD + 8 * n + 2 * (lane & 3);
        *reinterpret_cast<float2*>(stage + o) =
            make_float2(acc[b][4 * n + 2 * i], acc[b][4 * n + 2 * i + 1]);
        if constexpr (DUAL)
          *reinterpret_cast<float2*>(sd + o) =
              make_float2(acc2[b][4 * n + 2 * i], acc2[b][4 * n + 2 * i + 1]);
      }
    }
    wg_sync(wg);  // the block and the bias are in shared memory
    const int ch = t % CH;
    float bb[8];
    *reinterpret_cast<float4*>(bb) = *reinterpret_cast<const float4*>(bias + 8 * ch);
    *reinterpret_cast<float4*>(bb + 4) = *reinterpret_cast<const float4*>(bias + 8 * ch + 4);
    const int col = c.col0 + 8 * ch;
#pragma unroll 2
    for (int rr = t / CH; rr < 64; rr += 128 / CH) {
      const int row = c.row0 + 64 * b + rr;
      const bool inside = row < rows && col < cols;
      float z[8];
      *reinterpret_cast<float4*>(z) = *reinterpret_cast<const float4*>(stage + rr * LD + 8 * ch);
      *reinterpret_cast<float4*>(z + 4) =
          *reinterpret_cast<const float4*>(stage + rr * LD + 8 * ch + 4);
      const int64_t o = (int64_t)row * cols + col;
      if constexpr (DUAL) {
        float dp[8];
        *reinterpret_cast<float4*>(dp) = *reinterpret_cast<const float4*>(sd + rr * LD + 8 * ch);
        *reinterpret_cast<float4*>(dp + 4) =
            *reinterpret_cast<const float4*>(sd + rr * LD + 8 * ch + 4);
        uint32_t hw[4], dw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float hv[2], dv[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float u = z[2 * q + j] + bb[2 * q + j];
            const float cdf = 0.5f * (1.0f + erff(u * 0.70710678118654752f));
            const float pdf = 0.3989422804014327f * expf(-0.5f * u * u);
            hv[j] = u * cdf;
            dv[j] = dp[2 * q + j] * (cdf + u * pdf);
            cs[2 * q + j] += inside ? dv[j] : 0.0f;
          }
          hw[q] = pack_bf16(hv[0], hv[1]);
          dw[q] = pack_bf16(dv[0], dv[1]);
        }
        if (inside) {
          *reinterpret_cast<uint4*>(static_cast<bf16*>(a.out0) + o) =
              make_uint4(hw[0], hw[1], hw[2], hw[3]);
          *reinterpret_cast<uint4*>(static_cast<bf16*>(a.out1) + o) =
              make_uint4(dw[0], dw[1], dw[2], dw[3]);
        }
      } else {
        uint32_t hw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hw[q] = pack_bf16(gelu_f(z[2 * q] + bb[2 * q]), gelu_f(z[2 * q + 1] + bb[2 * q + 1]));
        if (inside)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(a.out0) + o) =
              make_uint4(hw[0], hw[1], hw[2], hw[3]);
      }
    }
    wg_sync(wg);  // the staging tile is free again
  }
  if constexpr (DUAL) {
#pragma unroll
    for (int off = CH; off < 32; off <<= 1)
#pragma unroll
      for (int q = 0; q < 8; ++q) cs[q] += __shfl_xor_sync(0xffffffffu, cs[q], off);
    if (lane < CH) {
#pragma unroll
      for (int q = 0; q < 8; ++q) red[(wg * 4 + warp) * BN + 8 * lane + q] = cs[q];
    }
    wg_sync(wg);
    float* part = a.ws + (int64_t)(c.row0 / BM) * a.cols0;
    for (int j = t; j < BN; j += 128) {
      if (c.col0 + j < cols) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += red[(wg * 4 + w) * BN + j];  // fixed order
        part[c.col0 + j] = s;
      }
    }
    wg_sync(wg);  // red is free for the next tile
  }
}

// One consumer warpgroup (wg 0 or 1). COOP: rows 64*wg of every tile.
// PINGPONG: every other tile of the walk (wg 0 the even ones), all its rows;
// the warpgroup skips the other's ring stages and waits for its turn
// (turn[wg]) before its main loop, so that its ring positions are never a
// full phase ahead of the barriers, and hands the turn over when its loads
// have all arrived.
template <int BN, int KIND, int SCHED>
__device__ __forceinline__ void consumer(const GemmArgs& a, uint32_t ring, uint32_t full,
                                         uint32_t empty, uint32_t turn, float* red,
                                         float* staging, float* bias_s, int wg) {
  typedef KindTraits<KIND> T;
  typedef Plan<BN, KIND, SCHED> P;
  constexpr int MB = P::MB;
  float acc[MB][BN / 2] = {};
  float acc2[MB][T::DUAL ? BN / 2 : 1] = {};
  const int total = tiles_per_split(a, BN) * a.splits;
  const bool leader = (threadIdx.x & 127) == 0;
  int stage = 0;
  uint32_t phase = 0, turn_phase = 0;
  int j = 0, mine = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x, ++j) {
    const Tile c = decode(a, BN, t);
    float* bias = nullptr;
    if constexpr (SCHED == PINGPONG) {
      if ((j & 1) != wg) {  // the other warpgroup's tile
        stage += c.ke - c.kb;
        while (stage >= P::STAGES) {
          stage -= P::STAGES;
          phase ^= 1;
        }
        continue;
      }
      // this warpgroup's copy of the tile's bias slice, fetched under the
      // main loop; two tiles' buffers apart, so that the next tile's copy
      // never overwrites one still read
      bias = bias_s + (wg * 2 + (mine++ & 1)) * BN;
      for (int q = threadIdx.x & 127; q < BN / 4; q += 128)
        if (c.col0 + 4 * q < a.cols0) cp_async16(bias + 4 * q, a.bias + c.col0 + 4 * q);
      cp_async_commit();
      if (j > 0) {
        mbar_wait(turn + wg * 8, turn_phase);
        turn_phase ^= 1;
      }
    }
    int prev = -1;
    for (int k = c.kb; k < c.ke; ++k) {
      mbar_wait(full + stage * 8, phase);
      const uint32_t s = ring + stage * P::STAGE;
      // 64 rows (K-major) or one box (MN-major) per m64 block
      const uint32_t sa = s + (SCHED == COOP ? wg * (A_BYTES / 2) : 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int on = k > c.kb || kk > 0;  // the first step overwrites the accumulators
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          mma<BN, T::A_MN, T::B_MN>(acc[b], step_desc(sa + b * (A_BYTES / 2), kk, T::A_MN),
                                    step_desc(s + A_BYTES, kk, T::B_MN), on);
          if constexpr (T::DUAL)
            mma<BN, 0, 1>(acc2[b],
                          step_desc(sa + A_BYTES + P::B_BYTES + b * (A_BYTES / 2), kk, false),
                          step_desc(s + 2 * A_BYTES + P::B_BYTES, kk, true), on);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0 && leader) mbar_arrive(empty + prev * 8);
      prev = stage;
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (SCHED == PINGPONG)
      if (leader) mbar_arrive(turn + (wg ^ 1) * 8);
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < MB; ++b) {
      fence_regs(acc[b]);
      fence_regs(acc2[b]);
    }
    if (prev >= 0 && leader) mbar_arrive(empty + prev * 8);
    if constexpr (SCHED == PINGPONG)
      epilogue_staged<BN, KIND>(a, c, acc, acc2, staging + wg * (P::STAGING / 8), red, bias,
                                wg);
    else
      epilogue<BN, KIND>(a, c, acc[0], acc2[0], red, wg);
  }
}

template <int BN, int KIND, int SCHED>
__device__ __forceinline__ void gemm(const GemmArgs& a) {
  typedef Plan<BN, KIND, SCHED> P;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024-byte alignment
  const uint32_t full = ring + P::STAGES * P::STAGE;
  const uint32_t empty = full + P::STAGES * 8;
  const uint32_t turn = empty + P::STAGES * 8;
  float* red = reinterpret_cast<float*>(smem_raw + (turn + 16 - raw));
  float* staging = red + P::RED / 4;
  float* bias_s = staging + P::STAGING / 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + s * 8, 1);  // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty + s * 8, SCHED == COOP ? 2 : 1);  // one arrival per consuming warpgroup
    }
    mbar_init(turn, 1);
    mbar_init(turn + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) producer<BN, KIND, SCHED>(a, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consumer<BN, KIND, SCHED>(a, ring, full, empty, turn, red, staging, bias_s,
                              threadIdx.x / 128 - 1);
  }
}

// db2 partials: block b sums rows [32b, 32b + 32) of g [M, C], two columns a
// thread.
__device__ __forceinline__ void colsum_rows(const bf16* __restrict__ g, float* __restrict__ part,
                                            int M, int C) {
  const int r0 = blockIdx.x * COLSUM_ROWS;
  const int r1 = min(r0 + COLSUM_ROWS, M);
  for (int j = threadIdx.x; j < C / 2; j += blockDim.x) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = r0; r < r1; ++r) {
      const float2 v =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(g + (int64_t)r * C)[j]);
      s0 += v.x;
      s1 += v.y;
    }
    part[(int64_t)blockIdx.x * C + 2 * j] = s0;
    part[(int64_t)blockIdx.x * C + 2 * j + 1] = s1;
  }
}

// Sums the dW split partials (when splits > 1, one element a thread, in the
// first n_dw_blocks blocks) and casts them to bf16; sums the db1 (per 128-row
// tile) and db2 (per 32-row chunk) partials, one element a warp: lane l takes
// partials l, l + 32, ..., then a fixed shuffle tree. Every order is fixed.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ ws_dw, int splits,
                                                int64_t ch, int n_dw_blocks, bf16* __restrict__ dw1,
                                                bf16* __restrict__ dw2,
                                                const float* __restrict__ ws_db1, int n_db1, int H,
                                                float* __restrict__ db1,
                                                const float* __restrict__ ws_db2, int n_db2, int C,
                                                float* __restrict__ db2) {
  if ((int)blockIdx.x < n_dw_blocks) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < 2 * ch;
         i += (int64_t)n_dw_blocks * blockDim.x) {
      float s = 0.0f;
      for (int k = 0; k < splits; ++k) s += ws_dw[k * 2 * ch + i];
      if (i < ch)
        dw1[i] = __float2bfloat16(s);
      else
        dw2[i - ch] = __float2bfloat16(s);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x - n_dw_blocks) * (blockDim.x / 32);
  for (int j = (blockIdx.x - n_dw_blocks) * (blockDim.x / 32) + threadIdx.x / 32; j < H + C;
       j += warps) {
    const bool is_db1 = j < H;
    const float* part = is_db1 ? ws_db1 + j : ws_db2 + (j - H);
    const int n = is_db1 ? n_db1 : n_db2, stride = is_db1 ? H : C;
    float s = 0.0f;
    for (int t = lane; t < n; t += 32) s += part[(int64_t)t * stride];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      if (is_db1)
        db1[j] = s;
      else
        db2[j - H] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda.so.1 that the CUDA
// runtime has loaded (no link against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// TMA map of a row-major bf16 [rows, cols] tensor in boxes of [box_rows x
// 64 columns], 128-byte swizzle; reads past the edges fill zeros.
bool make_map(CUtensorMap* m, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int KIND, int SCHED, typename K>
cudaError_t run(K kernel, const GemmArgs& a, int sms, cudaStream_t stream) {
  constexpr int smem = Plan<BN, KIND, SCHED>::SMEM;
  // the shared-memory limit is set once per kernel and device (a host call
  // per launch costs the host-bound steps that run these kernels)
  static uint64_t ready = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) ready |= uint64_t(1) << dev;
  }
  const int tiles = tiles_per_split(a, BN) * a.splits;
  kernel<<<tiles < sms ? tiles : sms, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled is a driver call and needs a current context on the
// calling thread, which a thread the runtime has not used yet (autograd's
// backward thread) may lack; cudaFree(nullptr) binds the runtime's context
// and does nothing else. Once a thread suffices.
bool bind_context() {
  thread_local bool bound = false;
  if (!bound) bound = cudaFree(nullptr) == cudaSuccess;
  return bound;
}

// Host-side refusals, told apart from CUDA's error codes (all positive).
constexpr int kBadArgs = -1;    // a shape or plan the kernels do not take
constexpr int kBadMap = -2;     // cuTensorMapEncodeTiled missing or refused

// ---------------------------------------------------------------------------
// the fused MLP as a sequence of launches
// ---------------------------------------------------------------------------

// One fused-MLP kernel set (K1 or K3): a launcher per GEMM that picks the
// instantiation of tile width bn, and the two small kernels.
typedef cudaError_t (*GemmLaunch)(const GemmArgs&, int bn, int sms, cudaStream_t);
typedef void (*ColsumKernel)(const bf16*, float*, int, int);
typedef void (*ReduceKernel)(const float*, int, int64_t, int, bf16*, bf16*, const float*, int,
                             int, float*, const float*, int, int, float*);
struct MlpKernels {
  GemmLaunch up, down, dh, dx, dw;
  int bn_dh;  // B1's tile width
  ColsumKernel colsum;
  ReduceKernel reduce;
};

// F1 then F2 on checked arguments (see the entry points of each .cu).
int mlp_fwd(const MlpKernels& K, const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, void* out, void* h, int M, int C, int H, int bn_up, int bn_down,
            int sms, cudaStream_t st) {
  if (!bind_context()) return (int)cudaGetLastError();
  GemmArgs up = {};
  if (!make_map(&up.a0, x, M, C, BM) || !make_map(&up.b0, w1, H, C, bn_up)) return kBadMap;
  up.bias = (const float*)b1;
  up.out0 = h;
  up.rows0 = M;
  up.cols0 = H;
  up.k = C;
  up.splits = 1;
  cudaError_t e = K.up(up, bn_up, sms, st);
  if (e != cudaSuccess) return (int)e;
  GemmArgs down = {};
  if (!make_map(&down.a0, h, M, H, BM) || !make_map(&down.b0, w2, C, H, bn_down)) return kBadMap;
  down.bias = (const float*)b2;
  down.out0 = out;
  down.rows0 = M;
  down.cols0 = C;
  down.k = H;
  down.splits = 1;
  return (int)K.down(down, bn_down, sms, st);
}

// B1, B2, B3, the g column sums and the reduction on checked arguments.
int mlp_bwd(const MlpKernels& K, const void* x, const void* w1, const void* b1, const void* w2,
            const void* g, void* dx, void* dw1, void* dw2, void* db1, void* db2, void* h, void* dh,
            void* ws_dw, void* ws_db1, void* ws_db2, int M, int C, int H, int bn_dx, int bn_dw,
            int splits, int sms, cudaStream_t st) {
  if (!bind_context()) return (int)cudaGetLastError();
  // B1: u = x W1^T, dp = g W2 -> h, dh, db1 partials
  GemmArgs b1a = {};
  if (!make_map(&b1a.a0, x, M, C, BM) || !make_map(&b1a.b0, w1, H, C, K.bn_dh) ||
      !make_map(&b1a.a1, g, M, C, BM) || !make_map(&b1a.b1, w2, C, H, 64))
    return kBadMap;
  b1a.bias = (const float*)b1;
  b1a.out0 = h;
  b1a.out1 = dh;
  b1a.ws = (float*)ws_db1;
  b1a.rows0 = M;
  b1a.cols0 = H;
  b1a.k = C;
  b1a.splits = 1;
  cudaError_t e = K.dh(b1a, K.bn_dh, sms, st);
  if (e != cudaSuccess) return (int)e;
  // B2: dx = dh W1
  GemmArgs b2a = {};
  if (!make_map(&b2a.a0, dh, M, H, BM) || !make_map(&b2a.b0, w1, H, C, 64)) return kBadMap;
  b2a.out0 = dx;
  b2a.rows0 = M;
  b2a.cols0 = C;
  b2a.k = H;
  b2a.splits = 1;
  e = K.dx(b2a, bn_dx, sms, st);
  if (e != cudaSuccess) return (int)e;
  // B3: dW1 = dh^T x, dW2 = g^T h
  GemmArgs b3a = {};
  if (!make_map(&b3a.a0, dh, M, H, 64) || !make_map(&b3a.b0, x, M, C, 64) ||
      !make_map(&b3a.a1, g, M, C, 64) || !make_map(&b3a.b1, h, M, H, 64))
    return kBadMap;
  b3a.out0 = dw1;
  b3a.out1 = dw2;
  b3a.ws = (float*)ws_dw;
  b3a.rows0 = H;
  b3a.cols0 = C;
  b3a.rows1 = C;
  b3a.cols1 = H;
  b3a.k = M;
  b3a.splits = splits;
  e = K.dw(b3a, bn_dw, sms, st);
  if (e != cudaSuccess) return (int)e;
  const int n_db2 = cdiv(M, COLSUM_ROWS);
  const ColsumKernel colsum = K.colsum;
  // two columns a thread; past C 2048 a block's threads loop over the columns
  colsum<<<n_db2, C / 2 < 1024 ? C / 2 : 1024, 0, st>>>((const bf16*)g, (float*)ws_db2, M, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t ch = (int64_t)C * H;
  const int64_t dw_blocks = splits > 1 ? (2 * ch + 255) / 256 : 0;
  const int n_dw_blocks = (int)(dw_blocks < 4 * sms ? dw_blocks : 4 * sms);
  const int db_blocks = (H + C + 7) / 8;  // one warp per db1 / db2 element
  const ReduceKernel reduce = K.reduce;
  reduce<<<n_dw_blocks + db_blocks, 256, 0, st>>>(
      (const float*)ws_dw, splits, ch, n_dw_blocks, (bf16*)dw1, (bf16*)dw2, (const float*)ws_db1,
      cdiv(M, BM), H, (float*)db1, (const float*)ws_db2, n_db2, C, (float*)db2);
  return (int)cudaGetLastError();
}

}  // namespace
