// Hidden-blocked fused transformer MLP for Hopper (sm_90a):
//   out = gelu(x @ W1^T + b1) @ W2^T + b2
// forward and backward at C = 768 (ViT-B, BERT-base, HuBERT-base, wav2vec2-base;
// H = 3072), as GEMMs on wgmma with TMA loads and fused epilogues.
//
// Replaces the hidden-blocked Pallas TPU kernels of the JAX package:
//   semireward_tpu/ops/fused_mlp.py:_fwd_blocked_kernel (launched by _fwd_blocked)
//   semireward_tpu/ops/fused_mlp.py:_bwd_dx_kernel     (first launch of _bwd_blocked)
//   semireward_tpu/ops/fused_mlp.py:_bwd_dw_kernel     (second launch of _bwd_blocked)
//
// Layouts follow torch.nn.Linear: x [M, C], W1 [H, C], b1 [H], W2 [C, H],
// b2 [C]; x/W/out/g/dx/dW bf16, biases and bias grads f32. Products take bf16
// operands and accumulate in f32; bias adds and GELU (exact erf form, erff)
// run in f32 on the accumulators. The hidden is rounded to bf16 before the
// second product and before dW2, dh before dx and dW1; db1 sums the unrounded
// f32 dh: the function of ops/fused_mlp.py:plain_fwd / plain_bwd.
//
// Bound at the HuBERT-base train shape (M = 24*199 = 4776, C = 768, H = 3072),
// H100 SXM: one product is 2*M*C*H = 22.5 GFLOP. The forward needs 2 (45.1
// GFLOP -> 45.6 us at 989 TFLOP/s bf16 dense, against ~24 MB -> 7 us at 3.35
// TB/s), the backward 5 (u again, dp = g W2, dx, dW1, dW2: 112.7 GFLOP -> 114
// us). Both are bound by operations, and these kernels compute exactly 2 and 5.
//
// Why the hidden goes through device memory. The TPU kernel keeps the [M, H]
// hidden in VMEM (~16 MB a core). On Hopper the products accumulate in
// registers: a [64, 768] f32 output accumulator is 192 KB, three quarters of
// an SM's 256 KB register file, so one CTA per SM could own only 64 rows (75
// row tiles at M 4776, 0.57 of a wave). Filling the card would mean splitting
// H across CTAs and reducing [M, 768] f32 partials (14.7 MB per split): bytes
// of the order of writing the bf16 hidden once (29.3 MB at HuBERT, inside the
// 50 MB L2), in a much larger kernel. So the hidden round trip costs at most
// ~59 MB forward (h written, read) and ~147 MB backward (h and dh written, dh
// read twice, h once) at HuBERT: <= 17.5 / 44 us at 3.35 TB/s, less where L2
// holds it.
//
// Design: one GEMM main loop, five products.
//   F1 (k3_fwd_up_kernel)    h   = bf16(gelu(x W1^T + b1))           [M, H], K = C
//   F2 (k3_fwd_down_kernel)  out = bf16(h W2^T + b2)                 [M, C], K = H
//   B1 (k3_bwd_dh_kernel)    u = x W1^T and dp = g W2 on one tile     [M, H], K = C:
//                            h = bf16(gelu(u + b1)), dh = dp * gelu'(u + b1),
//                            bf16(dh), per-row-tile column sums of the f32 dh
//   B2 (k3_bwd_dx_kernel)    dx  = bf16(dh) W1                       [M, C], K = H
//   B3 (k3_bwd_dw_kernel)    dW1 = bf16(dh)^T x [H, C] and dW2 = g^T h [C, H], K = M,
//                            both outputs' tiles in one launch, K split over M
//                            where the waves need it (f32 partials)
//   k3_bwd_colsum_kernel     column sums of g over 32-row chunks (db2)
//   k3_bwd_reduce_kernel     dW splits, db1 and db2 partials summed in a fixed
//                            order: no float atomics, the same bits every launch
// * Main loop: a persistent grid of one CTA per SM walks the output tiles
//   (BM = 128 rows x BN = 128 or 256 columns, rows fastest) in a fixed order.
//   One thread of the producer warpgroup issues TMA loads (128-byte swizzle;
//   K-major tiles as one box of 64 K x up to 256 rows, MN-major ones as [64 x
//   64] boxes) into a ring of 3-6 shared-memory stages of K = 64, guarded by
//   full / empty mbarriers; two consumer warpgroups of 64 rows each
//   run wgmma.mma_async m64nBNk16 on the stages and release them one stage
//   behind (wgmma.wait_group 1). setmaxnreg gives the consumers 232 registers
//   a thread (BN / 2 accumulators, 2 x 64 in B1) and the producer 40.
// * Operands stored MN-major (W2 as g W2's B, W1 as dh W1's B, all four of B3)
//   reach wgmma through its transpose bits, from TMA boxes taken along the MN
//   dimension: no copy.
// * The tile width and the K split of each product come from the host's plan
//   (ops/fused_mlp.py:blocked_plan) so that the last wave is nearly full.
// * The epilogues run on the consumer warpgroups while the tensor cores wait:
//   F1 and B1, whose epilogues evaluate GELU per element, reach about half
//   the rate of the other three GEMMs (PERF.md); overlapping them is open.
// * Ragged M: TMA zero-fills rows past M, so padded rows add nothing to any
//   product (in B3 they are K); stores skip rows past M (h at such a row would
//   be gelu(b1), never stored or read). The same holds for H past a multiple
//   of the tile (H need only be a multiple of 32).
// * Every function launches on the caller's stream, allocates nothing, and
//   returns 0, a CUDA error code (cudaGetLastError after each launch), or a
//   negative code for a refusal on the host (kBadArgs, kBadMap).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                  // output rows per tile: two consumer warpgroups of 64
constexpr int BK = 64;                   // K per stage: one 128-byte swizzle row of bf16
constexpr int NT = 384;                  // producer warpgroup + two consumer warpgroups
constexpr int BOX_BYTES = 64 * 64 * 2;   // one [64 x 64] bf16 TMA box
constexpr int A_BYTES = BM * BK * 2;     // an A operand tile, 16 KB
constexpr int RING_BYTES = 192 * 1024;
constexpr int COLSUM_ROWS = 32;          // rows per db2 partial

enum Kind { UP, DOWN, DH, DX, DW };

// Operand majors of each product (MN-major operands go through wgmma's
// transpose bits) and whether a tile carries a second product (B1: g W2).
template <int KIND>
struct KindTraits {
  static constexpr bool A_MN = KIND == DW;
  static constexpr bool B_MN = KIND == DX || KIND == DW;
  static constexpr bool DUAL = KIND == DH;
};

template <int BN, int KIND>
struct Plan {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = (A_BYTES + B_BYTES) * (KindTraits<KIND>::DUAL ? 2 : 1);
  static constexpr int STAGES = RING_BYTES / STAGE > 6 ? 6 : RING_BYTES / STAGE;
  static constexpr int RED = KIND == DH ? 8 * BN * 4 : 0;  // per-warp column sums
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8 + RED;
};

static_assert(Plan<256, UP>::SMEM <= 232448, "plan exceeds 227 KB");
static_assert(Plan<128, DH>::SMEM <= 232448, "plan exceeds 227 KB");
static_assert(Plan<256, DW>::SMEM <= 232448, "plan exceeds 227 KB");

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
  if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db, acc);
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

// One thread: walk this CTA's tiles and fill the ring, one stage per k-step.
template <int BN, int KIND>
__device__ __forceinline__ void producer(const GemmArgs& a, uint32_t ring, uint32_t full,
                                         uint32_t empty) {
  typedef KindTraits<KIND> T;
  typedef Plan<BN, KIND> P;
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

// Epilogue of one tile. Accumulator layout of m64nNk16: warp w of the
// warpgroup holds rows 16w + lane/4 (+8), columns 8n + 2*(lane%4) (+1) in
// d[4n + 2i + j] (i: +8 rows, j: +1 column).
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

// One consumer warpgroup (wg 0 or 1: rows 64*wg of each tile).
template <int BN, int KIND>
__device__ __forceinline__ void consumer(const GemmArgs& a, uint32_t ring, uint32_t full,
                                         uint32_t empty, float* red, int wg) {
  typedef KindTraits<KIND> T;
  typedef Plan<BN, KIND> P;
  float acc[BN / 2] = {};
  float acc2[T::DUAL ? BN / 2 : 1] = {};
  const int total = tiles_per_split(a, BN) * a.splits;
  const bool leader = (threadIdx.x & 127) == 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile c = decode(a, BN, t);
    int prev = -1;
    for (int k = c.kb; k < c.ke; ++k) {
      mbar_wait(full + stage * 8, phase);
      const uint32_t s = ring + stage * P::STAGE;
      const uint32_t sa = s + wg * (A_BYTES / 2);  // 64 rows (K-major) or one box (MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int on = k > c.kb || kk > 0;  // the first step overwrites the accumulators
        mma<BN, T::A_MN, T::B_MN>(acc, step_desc(sa, kk, T::A_MN),
                                  step_desc(s + A_BYTES, kk, T::B_MN), on);
        if constexpr (T::DUAL)
          mma<BN, 0, 1>(acc2, step_desc(sa + A_BYTES + P::B_BYTES, kk, false),
                        step_desc(s + 2 * A_BYTES + P::B_BYTES, kk, true), on);
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
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(acc2);
    if (prev >= 0 && leader) mbar_arrive(empty + prev * 8);
    epilogue<BN, KIND>(a, c, acc, acc2, red, wg);
  }
}

template <int BN, int KIND>
__device__ __forceinline__ void gemm(const GemmArgs& a) {
  typedef Plan<BN, KIND> P;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // 128-byte swizzle wants 1024-byte alignment
  const uint32_t full = ring + P::STAGES * P::STAGE;
  const uint32_t empty = full + P::STAGES * 8;
  float* red = reinterpret_cast<float*>(smem_raw + (empty + P::STAGES * 8 - raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + s * 8, 1);   // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty + s * 8, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) producer<BN, KIND>(a, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consumer<BN, KIND>(a, ring, full, empty, red, threadIdx.x / 128 - 1);
  }
}

template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_fwd_up_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, UP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_fwd_down_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DOWN>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_bwd_dh_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DH>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_bwd_dx_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DX>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_bwd_dw_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DW>(a);
}

// db2 partials: block b sums rows [32b, 32b + 32) of g [M, C], two columns a
// thread.
__global__ void k3_bwd_colsum_kernel(const bf16* __restrict__ g, float* __restrict__ part, int M,
                                     int C) {
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
__global__ void k3_bwd_reduce_kernel(const float* __restrict__ ws_dw, int splits, int64_t ch,
                                     int n_dw_blocks, bf16* __restrict__ dw1,
                                     bf16* __restrict__ dw2, const float* __restrict__ ws_db1,
                                     int n_db1, int H, float* __restrict__ db1,
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

template <int BN, int KIND, typename K>
cudaError_t run(K kernel, const GemmArgs& a, int sms, cudaStream_t stream) {
  constexpr int smem = Plan<BN, KIND>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int tiles = tiles_per_split(a, BN) * a.splits;
  kernel<<<tiles < sms ? tiles : sms, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

bool bn_ok(int bn) { return bn == 128 || bn == 256; }

// cuTensorMapEncodeTiled is a driver call and needs a current context on the
// calling thread, which a thread the runtime has not used yet (autograd's
// backward thread) may lack; cudaFree(nullptr) binds the runtime's context
// and does nothing else.
bool bind_context() { return cudaFree(nullptr) == cudaSuccess; }

// Host-side refusals, told apart from CUDA's error codes (all positive).
constexpr int kBadArgs = -1;    // a shape or plan the kernels do not take
constexpr int kBadMap = -2;     // cuTensorMapEncodeTiled missing or refused

}  // namespace

extern "C" {

// Shapes the kernels take: C = 768, H a positive multiple of 32, M >= 1.
int srt_fused_mlp_blocked_supported(int C, int H) {
  return C == 768 && H > 0 && H % 32 == 0;
}

// h: [M, H] bf16 scratch for the hidden. bn_up / bn_down: tile widths of F1
// and F2 (128 or 256); sms: CTAs of the persistent grids.
int srt_fused_mlp_blocked_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, void* h, int M, int C, int H, int bn_up,
                              int bn_down, int sms, void* stream) {
  if (M <= 0 || sms <= 0 || !srt_fused_mlp_blocked_supported(C, H) || !bn_ok(bn_up) ||
      !bn_ok(bn_down))
    return kBadArgs;
  if (!bind_context()) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  GemmArgs up = {};
  if (!make_map(&up.a0, x, M, C, BM) || !make_map(&up.b0, w1, H, C, bn_up))
    return kBadMap;
  up.bias = (const float*)b1;
  up.out0 = h;
  up.rows0 = M;
  up.cols0 = H;
  up.k = C;
  up.splits = 1;
  cudaError_t e = bn_up == 256 ? run<256, UP>(k3_fwd_up_kernel<256>, up, sms, st)
                               : run<128, UP>(k3_fwd_up_kernel<128>, up, sms, st);
  if (e != cudaSuccess) return (int)e;
  GemmArgs down = {};
  if (!make_map(&down.a0, h, M, H, BM) || !make_map(&down.b0, w2, C, H, bn_down))
    return kBadMap;
  down.bias = (const float*)b2;
  down.out0 = out;
  down.rows0 = M;
  down.cols0 = C;
  down.k = H;
  down.splits = 1;
  e = bn_down == 256 ? run<256, DOWN>(k3_fwd_down_kernel<256>, down, sms, st)
                     : run<128, DOWN>(k3_fwd_down_kernel<128>, down, sms, st);
  return (int)e;
}

// h, dh: [M, H] bf16 scratch. ws_dw: splits * 2*C*H f32 when splits > 1
// (else unused); ws_db1: ceil(M / 128) * H f32; ws_db2: ceil(M / 32) * C f32.
// bn_dx / bn_dw: tile widths of B2 and B3; splits: K splits of B3 (1 ..
// ceil(M / 64)); sms: CTAs of the persistent grids.
int srt_fused_mlp_blocked_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* g, void* dx, void* dw1, void* dw2, void* db1, void* db2,
                              void* h, void* dh, void* ws_dw, void* ws_db1, void* ws_db2, int M,
                              int C, int H, int bn_dx, int bn_dw, int splits, int sms,
                              void* stream) {
  if (M <= 0 || sms <= 0 || !srt_fused_mlp_blocked_supported(C, H) || !bn_ok(bn_dx) ||
      !bn_ok(bn_dw) || splits < 1 || splits > cdiv(M, BK) || (splits > 1 && !ws_dw))
    return kBadArgs;
  if (!bind_context()) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  // B1: u = x W1^T, dp = g W2 -> h, dh, db1 partials
  GemmArgs b1a = {};
  if (!make_map(&b1a.a0, x, M, C, BM) || !make_map(&b1a.b0, w1, H, C, 128) ||
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
  cudaError_t e = run<128, DH>(k3_bwd_dh_kernel<128>, b1a, sms, st);
  if (e != cudaSuccess) return (int)e;
  // B2: dx = dh W1
  GemmArgs b2a = {};
  if (!make_map(&b2a.a0, dh, M, H, BM) || !make_map(&b2a.b0, w1, H, C, 64))
    return kBadMap;
  b2a.out0 = dx;
  b2a.rows0 = M;
  b2a.cols0 = C;
  b2a.k = H;
  b2a.splits = 1;
  e = bn_dx == 256 ? run<256, DX>(k3_bwd_dx_kernel<256>, b2a, sms, st)
                   : run<128, DX>(k3_bwd_dx_kernel<128>, b2a, sms, st);
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
  e = bn_dw == 256 ? run<256, DW>(k3_bwd_dw_kernel<256>, b3a, sms, st)
                   : run<128, DW>(k3_bwd_dw_kernel<128>, b3a, sms, st);
  if (e != cudaSuccess) return (int)e;
  const int n_db2 = cdiv(M, COLSUM_ROWS);
  k3_bwd_colsum_kernel<<<n_db2, C / 2, 0, st>>>((const bf16*)g, (float*)ws_db2, M, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t ch = (int64_t)C * H;
  const int64_t dw_blocks = splits > 1 ? (2 * ch + 255) / 256 : 0;
  const int n_dw_blocks = (int)(dw_blocks < 4 * sms ? dw_blocks : 4 * sms);
  const int db_blocks = (H + C + 7) / 8;  // one warp per db1 / db2 element
  k3_bwd_reduce_kernel<<<n_dw_blocks + db_blocks, 256, 0, st>>>(
      (const float*)ws_dw, splits, ch, n_dw_blocks, (bf16*)dw1, (bf16*)dw2, (const float*)ws_db1,
      cdiv(M, BM), H, (float*)db1, (const float*)ws_db2, n_db2, C, (float*)db2);
  return (int)cudaGetLastError();
}

}  // extern "C"
