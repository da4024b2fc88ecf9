// Fused transformer MLP for Hopper (sm_90a), K1:
//   out = gelu(x @ W1^T + b1) @ W2^T + b2
// forward and backward at C a multiple of 64 from 128 to 384 (ViT-S C 384,
// ViT-Ti C 192; H any multiple of 32), as GEMMs on wgmma with TMA loads and
// fused epilogues, the GELU ones overlapped with the tensor-core work.
//
// Replaces the full-resident Pallas TPU kernels of the JAX package:
//   semireward_tpu/ops/fused_mlp.py:_fwd_kernel (:71, launched by _fwd)
//   semireward_tpu/ops/fused_mlp.py:_bwd_kernel (:107, launched by _bwd)
//
// Layouts follow torch.nn.Linear: x [M, C], W1 [H, C], b1 [H], W2 [C, H],
// b2 [C]; x/W/out/g/dx/dW bf16, biases and bias grads f32. Products take bf16
// operands and accumulate in f32; bias adds and GELU (exact erf form, erff)
// run in f32 on the accumulators. The hidden is rounded to bf16 before the
// second product and before dW2, dh before dx and dW1; db1 sums the unrounded
// f32 dh: the function of ops/fused_mlp.py:plain_fwd / plain_bwd.
//
// Bound at the headline shape (ViT-S/2-32 train step, M = 24*257 = 6168,
// C = 384, H = 1536), H100 SXM: one product is 2*M*C*H = 7.28 GFLOP. The
// forward needs 2 (14.6 GFLOP -> 14.7 us at 989 TFLOP/s bf16 dense, against
// ~12 MB of inputs and output -> 3.6 us at 3.35 TB/s), the backward 5 (u
// again, dp = g W2, dx, dW1, dW2: 36.4 GFLOP -> 36.8 us). Both are bound by
// operations, and these kernels compute exactly 2 and 5.
//
// Why the hidden goes through device memory at C 384, as in K3. The TPU
// kernel keeps the [M, H] hidden in VMEM. On Hopper the products accumulate
// in registers: a consumer warpgroup owning 64 rows of the output holds a
// [64, 384] f32 accumulator, 192 registers a thread before the hidden
// chunk's own accumulator and its bf16 copy. Two such warpgroups give 128
// rows a CTA, and M 6168 has 49 such tiles: 0.37 of a wave on 132 SMs.
// Splitting H to fill the card would add [M, 384] f32 partials of 9.5 MB per
// split. The bf16 hidden instead is 6168 * 1536 * 2 = 19 MB, which stays in
// the 50 MB L2: the round trip costs ~38 MB forward (h written, read) and
// ~95 MB backward (h and dh written, dh read twice, h once), <= 11 / 28 us
// at 3.35 TB/s, less where L2 holds it.
//
// Design: the GEMM of csrc/hopper_gemm.cuh (shared with K3), five products.
//   F1 (k1_fwd_up_kernel)    h   = bf16(gelu(x W1^T + b1))       [M, H], K = C, PINGPONG
//   F2 (k1_fwd_down_kernel)  out = bf16(h W2^T + b2)             [M, C], K = H, COOP
//   B1 (k1_bwd_dh_kernel)    u = x W1^T and dp = g W2 on one tile [M, H], K = C, PINGPONG:
//                            h = bf16(gelu(u + b1)), dh = dp * gelu'(u + b1),
//                            bf16(dh), per-row-tile column sums of the f32 dh
//   B2 (k1_bwd_dx_kernel)    dx  = bf16(dh) W1                   [M, C], K = H, COOP
//   B3 (k1_bwd_dw_kernel)    dW1 = bf16(dh)^T x [H, C] and dW2 = g^T h [C, H], K = M,
//                            both outputs' tiles in one launch, K split over M
//                            into f32 partials where the plan asks, COOP
//   k1_bwd_colsum_kernel     column sums of g over 32-row chunks (db2)
//   k1_bwd_reduce_kernel     dW splits, db1 and db2 partials summed in a fixed
//                            order: no float atomics, the same bits every launch
// * Epilogue overlap. At C 384 the up-projection's K is only 6 stages of 64,
//   so F1's GELU epilogue (~40 instructions an element: erff, FMAs, the
//   conversion, the store) costs more than its products: about 13 us across
//   the card against 7.4 us of products at peak. B1's (GELU, GELU', two
//   stores, column sums) is heavier still. Under K3's COOP schedule the
//   tensor cores would idle through it, so F1 and B1 run PINGPONG: each
//   consumer warpgroup owns a whole 128-row tile (two m64 blocks) and the
//   two take turns at the tensor cores, one tile's epilogue under the other
//   tile's products. The epilogue goes through shared memory (the f32
//   accumulators to a staging tile, then a rolled loop: bias, GELU and one
//   coalesced 16-byte store per 8 columns), which about halved F1 and B1 on
//   the H100 against storing from registers. A TMA store from the staging
//   tile measured no faster than the plain coalesced stores, so the stores
//   stay plain (PERF.md).
// * Tile widths for C <= 384 (BM 128): F1 128 wide (2 x 64 accumulators a
//   thread), B1 64 (its two products' accumulators, 2 x 2 x 32), F2, B2, B3
//   128, 192 or 256 (m64n192k16 is a legal wgmma). At M 6168 the 192-wide
//   tile gives F2 and B2 98 tiles (0.74 of a wave of 132) where 128 gives
//   1.11 waves. F1 at 192 wide would fill its last wave (392 tiles, 2.97
//   waves) but its epilogue, which bounds it, grew by more than the 1.5x
//   its elements did, and it ran slower. The host's plan
//   (ops/fused_mlp.py:blocked_plan, kernel "full") picks each GEMM's width
//   and B3's K split.
// * Ragged M: TMA zero-fills rows past M, so padded rows add nothing to any
//   product (in B3 they are K); stores skip rows past M. The same holds for
//   H past a multiple of the tile (H need only be a multiple of 32).
#include "hopper_gemm.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(NT, 1) k1_fwd_up_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, UP, PINGPONG>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k1_fwd_down_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DOWN, COOP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k1_bwd_dh_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DH, PINGPONG>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k1_bwd_dx_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DX, COOP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k1_bwd_dw_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DW, COOP>(a);
}

__global__ void k1_bwd_colsum_kernel(const bf16* __restrict__ g, float* __restrict__ part, int M,
                                     int C) {
  colsum_rows(g, part, M, C);
}

__global__ void k1_bwd_reduce_kernel(const float* __restrict__ ws_dw, int splits, int64_t ch,
                                     int n_dw_blocks, bf16* __restrict__ dw1,
                                     bf16* __restrict__ dw2, const float* __restrict__ ws_db1,
                                     int n_db1, int H, float* __restrict__ db1,
                                     const float* __restrict__ ws_db2, int n_db2, int C,
                                     float* __restrict__ db2) {
  reduce_partials(ws_dw, splits, ch, n_dw_blocks, dw1, dw2, ws_db1, n_db1, H, db1, ws_db2, n_db2,
                  C, db2);
}

// The launchers: F1 128 wide, B1 64, the others 128, 192 or 256.
cudaError_t launch_up(const GemmArgs& a, int, int sms, cudaStream_t st) {
  return run<128, UP, PINGPONG>(k1_fwd_up_kernel<128>, a, sms, st);
}
cudaError_t launch_down(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256   ? run<256, DOWN, COOP>(k1_fwd_down_kernel<256>, a, sms, st)
         : bn == 192 ? run<192, DOWN, COOP>(k1_fwd_down_kernel<192>, a, sms, st)
                     : run<128, DOWN, COOP>(k1_fwd_down_kernel<128>, a, sms, st);
}
cudaError_t launch_dh(const GemmArgs& a, int, int sms, cudaStream_t st) {
  return run<64, DH, PINGPONG>(k1_bwd_dh_kernel<64>, a, sms, st);
}
cudaError_t launch_dx(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256   ? run<256, DX, COOP>(k1_bwd_dx_kernel<256>, a, sms, st)
         : bn == 192 ? run<192, DX, COOP>(k1_bwd_dx_kernel<192>, a, sms, st)
                     : run<128, DX, COOP>(k1_bwd_dx_kernel<128>, a, sms, st);
}
cudaError_t launch_dw(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256   ? run<256, DW, COOP>(k1_bwd_dw_kernel<256>, a, sms, st)
         : bn == 192 ? run<192, DW, COOP>(k1_bwd_dw_kernel<192>, a, sms, st)
                     : run<128, DW, COOP>(k1_bwd_dw_kernel<128>, a, sms, st);
}

const MlpKernels kK1 = {launch_up, launch_down,          launch_dh,
                        launch_dx, launch_dw,            64,
                        k1_bwd_colsum_kernel, k1_bwd_reduce_kernel};

bool bn_ok(int bn) { return bn == 128 || bn == 192 || bn == 256; }

}  // namespace

extern "C" {

// Shapes the kernels take: C a multiple of 64 from 128 to 384, H a positive
// multiple of 32, M >= 1.
int srt_fused_mlp_supported(int C, int H) {
  return C >= 128 && C <= 384 && C % 64 == 0 && H > 0 && H % 32 == 0;
}

// h: [M, H] bf16 scratch for the hidden. bn_up: tile width of F1 (128);
// bn_down: of F2 (128, 192 or 256); sms: CTAs of the persistent grids.
int srt_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, void* h, int M, int C, int H, int bn_up,
                      int bn_down, int sms, void* stream) {
  if (M <= 0 || sms <= 0 || !srt_fused_mlp_supported(C, H) || bn_up != 128 || !bn_ok(bn_down))
    return kBadArgs;
  return mlp_fwd(kK1, x, w1, b1, w2, b2, out, h, M, C, H, bn_up, bn_down, sms,
                 (cudaStream_t)stream);
}

// h, dh: [M, H] bf16 scratch. ws_dw: splits * 2*C*H f32 when splits > 1
// (else unused); ws_db1: ceil(M / 128) * H f32; ws_db2: ceil(M / 32) * C f32.
// bn_dx / bn_dw: tile widths of B2 and B3 (128, 192 or 256); splits: K splits
// of B3 (1 .. ceil(M / 64)); sms: CTAs of the persistent grids.
int srt_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* g, void* dx, void* dw1, void* dw2, void* db1, void* db2, void* h,
                      void* dh, void* ws_dw, void* ws_db1, void* ws_db2, int M, int C, int H,
                      int bn_dx, int bn_dw, int splits, int sms, void* stream) {
  if (M <= 0 || sms <= 0 || !srt_fused_mlp_supported(C, H) || !bn_ok(bn_dx) || !bn_ok(bn_dw) ||
      splits < 1 || splits > cdiv(M, BK) || (splits > 1 && !ws_dw))
    return kBadArgs;
  return mlp_bwd(kK1, x, w1, b1, w2, g, dx, dw1, dw2, db1, db2, h, dh, ws_dw, ws_db1, ws_db2, M,
                 C, H, bn_dx, bn_dw, splits, sms, (cudaStream_t)stream);
}

}  // extern "C"
