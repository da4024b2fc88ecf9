// Hidden-blocked fused transformer MLP for Hopper (sm_90a):
//   out = gelu(x @ W1^T + b1) @ W2^T + b2
// forward and backward at any C that is a multiple of 64 (C 768: ViT-B,
// DINOv2 ViT-B/14, BERT-base, HuBERT-base, wav2vec2-base, H 3072; C 1024:
// DINOv2 ViT-L/14, H 4096; ops/fused_mlp.py:route sends K1's widths, C
// 128-384, to K1), as GEMMs on wgmma with TMA loads and fused epilogues.
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
// * The GEMM (csrc/hopper_gemm.cuh, shared with K1) in its COOP schedule:
//   a persistent grid of one CTA per SM walks the output tiles (BM = 128
//   rows x BN = 128 or 256 columns); a producer thread fills a ring of 3-6
//   TMA stages of K = 64; two consumer warpgroups of 64 rows each run
//   wgmma.mma_async m64nBNk16 (BN / 2 accumulators a thread, 2 x 64 in B1).
// * Operands stored MN-major (W2 as g W2's B, W1 as dh W1's B, all four of B3)
//   reach wgmma through its transpose bits: no copy.
// * The tile width and the K split of each product come from the host's plan
//   (ops/fused_mlp.py:blocked_plan) so that the last wave is nearly full.
// * The epilogues run on the consumer warpgroups while the tensor cores wait:
//   F1 and B1, whose epilogues evaluate GELU per element, reach about half
//   the rate of the other three GEMMs (PERF.md). K1 overlaps them (the
//   PINGPONG schedule); K3 keeps the COOP one.
// * Ragged M: TMA zero-fills rows past M, so padded rows add nothing to any
//   product (in B3 they are K); stores skip rows past M (h at such a row would
//   be gelu(b1), never stored or read). The same holds for H past a multiple
//   of the tile (H need only be a multiple of 32).
#include "hopper_gemm.cuh"

namespace {

template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_fwd_up_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, UP, COOP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_fwd_down_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DOWN, COOP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_bwd_dh_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DH, COOP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_bwd_dx_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DX, COOP>(a);
}
template <int BN>
__global__ void __launch_bounds__(NT, 1) k3_bwd_dw_kernel(const __grid_constant__ GemmArgs a) {
  gemm<BN, DW, COOP>(a);
}

__global__ void k3_bwd_colsum_kernel(const bf16* __restrict__ g, float* __restrict__ part, int M,
                                     int C) {
  colsum_rows(g, part, M, C);
}

__global__ void k3_bwd_reduce_kernel(const float* __restrict__ ws_dw, int splits, int64_t ch,
                                     int n_dw_blocks, bf16* __restrict__ dw1,
                                     bf16* __restrict__ dw2, const float* __restrict__ ws_db1,
                                     int n_db1, int H, float* __restrict__ db1,
                                     const float* __restrict__ ws_db2, int n_db2, int C,
                                     float* __restrict__ db2) {
  reduce_partials(ws_dw, splits, ch, n_dw_blocks, dw1, dw2, ws_db1, n_db1, H, db1, ws_db2, n_db2,
                  C, db2);
}

// The launchers: tile width 128 or 256 (B1 128 only).
cudaError_t launch_up(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256 ? run<256, UP, COOP>(k3_fwd_up_kernel<256>, a, sms, st)
                   : run<128, UP, COOP>(k3_fwd_up_kernel<128>, a, sms, st);
}
cudaError_t launch_down(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256 ? run<256, DOWN, COOP>(k3_fwd_down_kernel<256>, a, sms, st)
                   : run<128, DOWN, COOP>(k3_fwd_down_kernel<128>, a, sms, st);
}
cudaError_t launch_dh(const GemmArgs& a, int, int sms, cudaStream_t st) {
  return run<128, DH, COOP>(k3_bwd_dh_kernel<128>, a, sms, st);
}
cudaError_t launch_dx(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256 ? run<256, DX, COOP>(k3_bwd_dx_kernel<256>, a, sms, st)
                   : run<128, DX, COOP>(k3_bwd_dx_kernel<128>, a, sms, st);
}
cudaError_t launch_dw(const GemmArgs& a, int bn, int sms, cudaStream_t st) {
  return bn == 256 ? run<256, DW, COOP>(k3_bwd_dw_kernel<256>, a, sms, st)
                   : run<128, DW, COOP>(k3_bwd_dw_kernel<128>, a, sms, st);
}

const MlpKernels kK3 = {launch_up, launch_down,          launch_dh,
                        launch_dx, launch_dw,            128,
                        k3_bwd_colsum_kernel, k3_bwd_reduce_kernel};

bool bn_ok(int bn) { return bn == 128 || bn == 256; }

}  // namespace

extern "C" {

// Shapes the kernels take: C a positive multiple of 64 (every K step of F1
// and B1 and every 64-column box of B3's C side is whole), H a positive
// multiple of 32, M >= 1. Nothing else depends on C: tiles past C or H are
// guarded, the column-sum kernel loops over C, and the workspaces scale
// with it.
int srt_fused_mlp_blocked_supported(int C, int H) {
  return C > 0 && C % 64 == 0 && H > 0 && H % 32 == 0;
}

// h: [M, H] bf16 scratch for the hidden. bn_up / bn_down: tile widths of F1
// and F2 (128 or 256); sms: CTAs of the persistent grids.
int srt_fused_mlp_blocked_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, void* h, int M, int C, int H, int bn_up,
                              int bn_down, int sms, void* stream) {
  if (M <= 0 || sms <= 0 || !srt_fused_mlp_blocked_supported(C, H) || !bn_ok(bn_up) ||
      !bn_ok(bn_down))
    return kBadArgs;
  return mlp_fwd(kK3, x, w1, b1, w2, b2, out, h, M, C, H, bn_up, bn_down, sms,
                 (cudaStream_t)stream);
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
  return mlp_bwd(kK3, x, w1, b1, w2, g, dx, dw1, dw2, db1, db2, h, dh, ws_dw, ws_db1, ws_db2, M,
                 C, H, bn_dx, bn_dw, splits, sms, (cudaStream_t)stream);
}

}  // extern "C"
