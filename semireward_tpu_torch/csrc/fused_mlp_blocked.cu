// Hidden-blocked fused transformer MLP for Hopper (sm_90a):
//   out = gelu(x @ W1^T + b1) @ W2^T + b2
// forward and backward at C = 768 (ViT-B, BERT-base, HuBERT-base, wav2vec2-base;
// H = 3072), with the [M, H] hidden activation never written to device memory.
//
// Replaces the hidden-blocked Pallas TPU kernels of the JAX package:
//   semireward_tpu/ops/fused_mlp.py:_fwd_blocked_kernel (launched by _fwd_blocked)
//   semireward_tpu/ops/fused_mlp.py:_bwd_dx_kernel     (first launch of _bwd_blocked)
//   semireward_tpu/ops/fused_mlp.py:_bwd_dw_kernel     (second launch of _bwd_blocked)
//
// Layouts follow torch.nn.Linear: x [M, C], W1 [H, C], b1 [H], W2 [C, H],
// b2 [C]; x/W/out/g/dx/dW bf16, biases and bias grads f32. Products run on
// the tensor cores (WMMA bf16 16x16x16, f32 accumulation); bias adds and GELU
// (exact erf form, erff) in f32. The hidden is rounded to bf16 before the
// second product and dh before dx/dW1; db1 sums the unrounded f32 dh.
//
// Bound at the HuBERT-base train shape (M = 24*199 = 4776, C = 768, H = 3072),
// H100 SXM: one product is 2*M*C*H = 22.5 GFLOP. The forward needs 2 (45.1
// GFLOP -> 45.6 us at 989 TFLOP/s bf16 dense, against ~24 MB -> 7 us at
// 3.35 TB/s); the backward needs 5 (u again, dh, dx, dW1, dW2: 112.7 GFLOP ->
// 114 us). All bound by operations. These kernels compute 2 (forward) and
// 3 + 4 (dx, dW) products: the split backward recomputes u and dh twice.
//
// Design. K1's plan (csrc/fused_mlp.cu: 64 rows of x resident, double-
// buffered [32, C] weight chunks, the [64, C] f32 output accumulator in
// registers) does not fit at C = 768: ~330 KB of shared memory per block
// (Hopper allows 227 KB) and 192 accumulator registers per thread.
// * fwd_kernel: one CTA of 8 warps owns BM = 32 rows (x resident in shared
//   memory) and walks hidden chunks of HC = 32. The [32, 768] f32 output
//   accumulator stays in registers (12 WMMA fragments per warp, 96 registers,
//   as K1 at C = 384). u = x @ W1[chunk]^T splits its K = 768 between two
//   warps per 16x16 tile (8 warps, 4 tiles), the halves meet in shared
//   memory, and GELU runs on the sum. Single buffers, staggered: the next
//   W1 chunk streams in (cp.async) while the current W2 chunk is multiplied,
//   the next W2 chunk while the next u is computed. Fewer rows per CTA
//   was chosen over a per-slice partial (an [S, M, C] f32 workspace and a
//   second pass) and over split output columns (x @ W1 recomputed) because
//   it needs neither; the two alternatives were not built and measured.
// * dx_kernel: the same row tiles; per hidden chunk warps 0-3 recompute u
//   and warps 4-7 g @ W2[:, chunk] (full K each), dh = dp * gelu'(u + b1)
//   goes to shared memory as bf16, then dx_tile += dh @ W1[chunk].
// * dw_kernel: grid (H / 16 hidden chunks) x (S row splits). Each CTA keeps
//   its W1/W2 chunk in shared memory and walks 16-row tiles of x and g
//   (double-buffered cp.async); u and g @ W2 split K four ways across the
//   warps; dW1[chunk] = dh^T x and dW2[:, chunk] = g^T h accumulate in
//   registers (12 fragments per warp), db1 and (chunk 0) db2 in f32. Each
//   split writes an f32 partial to a workspace of S * (2*C*H + H + C) f32
//   (18.9 MB per split at the HuBERT shape) and reduce_blocked_kernel sums
//   them in a fixed order and casts dW to bf16: deterministic, no atomics.
//   The wrapper takes S = 2: one split gives H / 16 = 192 CTAs, 1.45 waves
//   of one CTA per SM on 132 SMs, two give 384.
// * dx and dW walk hidden chunks and rows in opposite orders, so they are two
//   kernels, as the TPU's are two launches.
// * Ragged M (4776 = 149*32 + 8): rows past M load as zeros (cp.async zero-
//   fill), so x and g are zero there and add nothing to dW/db (the TPU
//   kernel's row mask, fused_mlp.py:290-295); stores skip those rows.
// * Every function launches on the caller's stream, allocates nothing, and
//   returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;       // threads per CTA (8 warps)
constexpr int BM = 32;        // rows per CTA (forward, dx)
constexpr int HC = 32;        // hidden chunk (forward, dx)
constexpr int BMW = 16;       // rows per tile (dW)
constexpr int HCW = 16;       // hidden chunk (dW)
constexpr int LDH = HC + 8;   // bf16 leading dim of [*, HC] tiles
constexpr int LDF = HC + 4;   // f32 leading dim of the bias tile
constexpr int LDHW = HCW + 8; // bf16 leading dim of [*, HCW] tiles

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float gelu_f(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float dgelu_f(float u) {
  const float cdf = 0.5f * (1.0f + erff(u * 0.70710678118654752f));
  const float pdf = 0.3989422804014327f * expf(-0.5f * u * u);
  return cdf + u * pdf;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a [rows, cols] bf16 tile (cols % 8 == 0) from global to
// shared memory in 16-byte pieces; rows at or past valid_rows become zeros.
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld_dst, const bf16* src,
                                                int64_t ld_src, int rows, int cols,
                                                int valid_rows) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += NT) {
    const int r = i / vpr, v = i - r * vpr;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * ld_dst + v * 8, src + (ok ? r * ld_src + v * 8 : 0), ok);
  }
}

// acc (+)= A[rf*16 : +16, k0 : k0+kn] @ B[cf*16 : +16, k0 : k0+kn]^T, with A
// and B row-major [*][lda] / [*][ldb] bf16 in shared memory (B read as a
// col-major right operand); two accumulators halve the dependent chain.
__device__ __forceinline__ void mm_abt(FragC& acc, const bf16* a, int lda, const bf16* b,
                                       int ldb, int rf, int cf, int k0, int kn) {
  FragC acc2;
  wmma::fill_fragment(acc2, 0.0f);
  FragA fa;
  FragBT fb;
#pragma unroll 4
  for (int k = k0; k < k0 + kn; k += 32) {
    wmma::load_matrix_sync(fa, a + rf * 16 * lda + k, lda);
    wmma::load_matrix_sync(fb, b + cf * 16 * ldb + k, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
    wmma::load_matrix_sync(fa, a + rf * 16 * lda + k + 16, lda);
    wmma::load_matrix_sync(fb, b + cf * 16 * ldb + k + 16, ldb);
    wmma::mma_sync(acc2, fa, fb, acc2);
  }
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc2.x[i];
}

// acc (+)= A[rf*16 : +16, k0 : k0+kn] @ B[k0 : k0+kn, cf*16 : +16] with A
// row-major [*][lda] and B row-major [*][ldb] in shared memory.
__device__ __forceinline__ void mm_ab(FragC& acc, const bf16* a, int lda, const bf16* b,
                                      int ldb, int rf, int cf, int k0, int kn) {
  FragC acc2;
  wmma::fill_fragment(acc2, 0.0f);
  FragA fa;
  FragB fb;
#pragma unroll 4
  for (int k = k0; k < k0 + kn; k += 32) {
    wmma::load_matrix_sync(fa, a + rf * 16 * lda + k, lda);
    wmma::load_matrix_sync(fb, b + k * ldb + cf * 16, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
    wmma::load_matrix_sync(fa, a + rf * 16 * lda + k + 16, lda);
    wmma::load_matrix_sync(fb, b + (k + 16) * ldb + cf * 16, ldb);
    wmma::mma_sync(acc2, fa, fb, acc2);
  }
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc2.x[i];
}

// Store a 16x16 f32 fragment through this warp's staging tile into a bf16
// tile at dst (leading dim ld, shared or global memory).
__device__ __forceinline__ void frag_to_bf16(float* stage, const FragC& f, bf16* dst,
                                             int64_t ld) {
  wmma::store_matrix_sync(stage, f, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = lane; e < 256; e += 32) dst[(e >> 4) * ld + (e & 15)] = __float2bfloat16(stage[e]);
  __syncwarp();
}

// Stage the [BM, C] f32 accumulators (warp w owns column fragments
// w*NCF .. w*NCF+NCF-1 of both row fragments) and write rows < rows_valid as
// bf16, adding bias when given.
template <int C>
__device__ __forceinline__ void store_rows(float* stage, FragC (&acc)[BM / 16][C / 128],
                                           bf16* out, const float* bias, int row0,
                                           int rows_valid) {
  constexpr int NCF = C / 128;
  constexpr int LDS = C + 4;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int rf = 0; rf < BM / 16; ++rf)
#pragma unroll
    for (int t = 0; t < NCF; ++t)
      wmma::store_matrix_sync(stage + rf * 16 * LDS + (warp * NCF + t) * 16, acc[rf][t], LDS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * C / 2; e += NT) {
    const int r = (2 * e) / C, c = 2 * e - r * C;
    if (r < rows_valid) {
      float v0 = stage[r * LDS + c], v1 = stage[r * LDS + c + 1];
      if (bias) {
        v0 += bias[c];
        v1 += bias[c + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(row0 + r) * C + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// acc[r][t] += A[r*16 : +16, 0:HC] @ B where warp w owns output column
// fragments w*NCF + t; A is [BM][LDH] bf16, B element (k, n) at
// b[k * kstride + n * nstride] (read through col- or row-major fragments).
template <int C, bool B_COL_MAJOR>
__device__ __forceinline__ void mm_chunk(FragC (&acc)[BM / 16][C / 128], const bf16* a,
                                         const bf16* b, int ldb) {
  constexpr int NCF = C / 128;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < HC; k += 16) {
    if constexpr (B_COL_MAJOR) {
      FragBT fb[NCF];
#pragma unroll
      for (int t = 0; t < NCF; ++t)
        wmma::load_matrix_sync(fb[t], b + (warp * NCF + t) * 16 * ldb + k, ldb);
#pragma unroll
      for (int r = 0; r < BM / 16; ++r) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + r * 16 * LDH + k, LDH);
#pragma unroll
        for (int t = 0; t < NCF; ++t) wmma::mma_sync(acc[r][t], fa, fb[t], acc[r][t]);
      }
    } else {
      FragB fb[NCF];
#pragma unroll
      for (int t = 0; t < NCF; ++t)
        wmma::load_matrix_sync(fb[t], b + k * ldb + (warp * NCF + t) * 16, ldb);
#pragma unroll
      for (int r = 0; r < BM / 16; ++r) {
        FragA fa;
        wmma::load_matrix_sync(fa, a + r * 16 * LDH + k, LDH);
#pragma unroll
        for (int t = 0; t < NCF; ++t) wmma::mma_sync(acc[r][t], fa, fb[t], acc[r][t]);
      }
    }
  }
}

// shared-memory plans (bytes)
template <int C>
struct FwdSmem {
  static constexpr size_t xs = (size_t)BM * (C + 8) * 2;
  static constexpr size_t w1c = (size_t)HC * (C + 8) * 2;
  static constexpr size_t w2c = (size_t)C * LDH * 2;
  static constexpr size_t stage = 8 * 256 * 4;  // one 16x16 f32 tile per warp
  static constexpr size_t bias = 16 * LDF * 4;
  static constexpr size_t hs = (size_t)BM * LDH * 2;
  static constexpr size_t main = xs + w1c + w2c + stage + bias + hs;
  static constexpr size_t out = (size_t)BM * (C + 4) * 4;
  static constexpr size_t total = main > out ? main : out;
};

template <int C>
struct DxSmem {
  static constexpr size_t tile = FwdSmem<C>::xs;
  static constexpr size_t main = 2 * tile + FwdSmem<C>::w1c + FwdSmem<C>::w2c +
                                 FwdSmem<C>::stage + FwdSmem<C>::hs;
  static constexpr size_t out = FwdSmem<C>::out;
  static constexpr size_t total = main > out ? main : out;
};

template <int C>
struct DwSmem {
  static constexpr size_t tile = (size_t)BMW * (C + 8) * 2;
  static constexpr size_t w1c = (size_t)HCW * (C + 8) * 2;
  static constexpr size_t w2c = (size_t)C * LDHW * 2;
  static constexpr size_t stage = 8 * 256 * 4;
  static constexpr size_t total = 4 * tile + w1c + w2c + stage +
                                  2 * (size_t)BMW * LDHW * 2 +  // h, dh (bf16)
                                  (size_t)BMW * HCW * 4 +       // dh (f32)
                                  (size_t)C * 4;                // db2
};

static_assert(FwdSmem<768>::total <= 232448, "forward plan exceeds 227 KB");
static_assert(DxSmem<768>::total <= 232448, "dx plan exceeds 227 KB");
static_assert(DwSmem<768>::total <= 232448, "dW plan exceeds 227 KB");

template <int C>
__global__ void __launch_bounds__(NT, 1)
fwd_blocked_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, bf16* __restrict__ out, int M, int H) {
  constexpr int LDC = C + 8;
  constexpr int NCF = C / 128;
  typedef FwdSmem<C> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1c = reinterpret_cast<bf16*>(smem + S::xs);
  bf16* w2c = reinterpret_cast<bf16*>(smem + S::xs + S::w1c);
  float* stage = reinterpret_cast<float*>(smem + S::xs + S::w1c + S::w2c);
  float* bias = stage + 8 * 256;
  bf16* hs = reinterpret_cast<bf16*>(bias + 16 * LDF);

  const int warp = threadIdx.x / 32;
  // u tile (rf, cf) of the [32, 32] chunk; warps kh = 0 and 1 take the two
  // halves of K = C
  const int rf = (warp >> 1) & 1, cf = warp & 1, kh = warp >> 2, slot = rf * 2 + cf;
  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, M - row0);
  load_tile_async(xs, LDC, x + (int64_t)row0 * C, C, BM, C, rows_valid);
  load_tile_async(w1c, LDC, w1, C, HC, C, HC);
  cp_async_commit();
  load_tile_async(w2c, LDH, w2, H, C, HC, C);
  cp_async_commit();

  FragC acc[BM / 16][NCF];
#pragma unroll
  for (int r = 0; r < BM / 16; ++r)
#pragma unroll
    for (int t = 0; t < NCF; ++t) wmma::fill_fragment(acc[r][t], 0.0f);

  const int nchunks = H / HC;
  for (int c = 0; c < nchunks; ++c) {
    const int j0 = c * HC;
    cp_async_wait<1>();  // x and W1 chunk c landed (W2 chunk c may be in flight)
    for (int e = threadIdx.x; e < 16 * HC; e += NT) bias[(e / HC) * LDF + e % HC] = b1[j0 + e % HC];
    __syncthreads();
    FragC u;
    if (kh == 0)
      wmma::load_matrix_sync(u, bias + cf * 16, LDF, wmma::mem_row_major);
    else
      wmma::fill_fragment(u, 0.0f);
    mm_abt(u, xs, LDC, w1c, LDC, rf, cf, kh * (C / 2), C / 2);
    if (kh == 1) wmma::store_matrix_sync(stage + slot * 256, u, 16, wmma::mem_row_major);
    __syncthreads();  // W1 chunk c is free; the K halves meet in stage
    if (c + 1 < nchunks) load_tile_async(w1c, LDC, w1 + (int64_t)(j0 + HC) * C, C, HC, C, HC);
    cp_async_commit();
    if (kh == 0) {
      FragC part;
      wmma::load_matrix_sync(part, stage + slot * 256, 16, wmma::mem_row_major);
#pragma unroll
      for (int i = 0; i < u.num_elements; ++i) u.x[i] = gelu_f(u.x[i] + part.x[i]);
      frag_to_bf16(stage + (4 + slot) * 256, u, hs + rf * 16 * LDH + cf * 16, LDH);
    }
    cp_async_wait<1>();  // W2 chunk c landed (W1 chunk c + 1 may be in flight)
    __syncthreads();     // h complete
    mm_chunk<C, true>(acc, hs, w2c, LDH);
    __syncthreads();  // W2 chunk c and h are free
    if (c + 1 < nchunks) load_tile_async(w2c, LDH, w2 + j0 + HC, H, C, HC, C);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  store_rows<C>(reinterpret_cast<float*>(smem), acc, out, b2, row0, rows_valid);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
dx_blocked_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ g, bf16* __restrict__ dx, int M, int H) {
  constexpr int LDC = C + 8;
  constexpr int NCF = C / 128;
  typedef FwdSmem<C> F;
  typedef DxSmem<C> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = reinterpret_cast<bf16*>(smem + S::tile);
  bf16* w1c = reinterpret_cast<bf16*>(smem + 2 * S::tile);
  bf16* w2c = reinterpret_cast<bf16*>(smem + 2 * S::tile + F::w1c);
  float* stage = reinterpret_cast<float*>(smem + 2 * S::tile + F::w1c + F::w2c);
  bf16* dhs = reinterpret_cast<bf16*>(stage + 8 * 256);

  const int warp = threadIdx.x / 32;
  const int q = warp & 3, rf = q >> 1, cf = q & 1;
  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, M - row0);
  load_tile_async(xs, LDC, x + (int64_t)row0 * C, C, BM, C, rows_valid);
  load_tile_async(gs, LDC, g + (int64_t)row0 * C, C, BM, C, rows_valid);
  load_tile_async(w1c, LDC, w1, C, HC, C, HC);
  load_tile_async(w2c, LDH, w2, H, C, HC, C);
  cp_async_commit();

  FragC acc[BM / 16][NCF];
#pragma unroll
  for (int r = 0; r < BM / 16; ++r)
#pragma unroll
    for (int t = 0; t < NCF; ++t) wmma::fill_fragment(acc[r][t], 0.0f);

  const int nchunks = H / HC;
  for (int c = 0; c < nchunks; ++c) {
    const int j0 = c * HC;
    cp_async_wait<0>();
    __syncthreads();  // W1/W2 chunk c landed
    {
      // warps 0-3: u = x @ W1c^T; warps 4-7: dp = g @ W2c ([16 x 16] each)
      FragC f;
      wmma::fill_fragment(f, 0.0f);
      if (warp < 4)
        mm_abt(f, xs, LDC, w1c, LDC, rf, cf, 0, C);
      else
        mm_ab(f, gs, LDC, w2c, LDH, rf, cf, 0, C);
      wmma::store_matrix_sync(stage + warp * 256, f, 16, wmma::mem_row_major);
    }
    __syncthreads();  // W2 chunk c is free
    if (c + 1 < nchunks) load_tile_async(w2c, LDH, w2 + j0 + HC, H, C, HC, C);
    cp_async_commit();
    for (int e = threadIdx.x; e < BM * HC; e += NT) {
      const int r = e / HC, j = e - r * HC;
      const int s = (r >> 4) * 2 + (j >> 4), i = (r & 15) * 16 + (j & 15);
      const float u = stage[s * 256 + i] + b1[j0 + j];
      dhs[r * LDH + j] = __float2bfloat16(stage[(4 + s) * 256 + i] * dgelu_f(u));
    }
    __syncthreads();  // dh complete
    mm_chunk<C, false>(acc, dhs, w1c, LDC);
    __syncthreads();  // W1 chunk c and dh are free
    if (c + 1 < nchunks) load_tile_async(w1c, LDC, w1 + (int64_t)(j0 + HC) * C, C, HC, C, HC);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  store_rows<C>(reinterpret_cast<float*>(smem), acc, dx, nullptr, row0, rows_valid);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
dw_blocked_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ g, float* __restrict__ ws, int M, int H) {
  constexpr int LDC = C + 8;
  constexpr int NCF = C / 128;
  typedef DwSmem<C> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + S::tile)};
  bf16* gs[2] = {reinterpret_cast<bf16*>(smem + 2 * S::tile),
                 reinterpret_cast<bf16*>(smem + 3 * S::tile)};
  bf16* w1c = reinterpret_cast<bf16*>(smem + 4 * S::tile);
  bf16* w2c = reinterpret_cast<bf16*>(smem + 4 * S::tile + S::w1c);
  float* stage = reinterpret_cast<float*>(smem + 4 * S::tile + S::w1c + S::w2c);
  bf16* hs = reinterpret_cast<bf16*>(stage + 8 * 256);
  bf16* dhs = hs + BMW * LDHW;
  float* dhf = reinterpret_cast<float*>(dhs + BMW * LDHW);
  float* db2s = dhf + BMW * HCW;

  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * HCW;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const bool first_chunk = blockIdx.x == 0;
  const int ntiles = (M + BMW - 1) / BMW;

  load_tile_async(w1c, LDC, w1 + (int64_t)j0 * C, C, HCW, C, HCW);
  load_tile_async(w2c, LDHW, w2 + j0, H, C, HCW, C);
  if (split < ntiles) {
    const int rv = min(BMW, M - split * BMW);
    load_tile_async(xs[0], LDC, x + (int64_t)split * BMW * C, C, BMW, C, rv);
    load_tile_async(gs[0], LDC, g + (int64_t)split * BMW * C, C, BMW, C, rv);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < C; c += NT) db2s[c] = 0.0f;

  FragC acc1[NCF];  // dW1[j0 : +16, (warp*NCF + t)*16 : +16]
  FragC acc2[NCF];  // dW2[(warp*NCF + t)*16 : +16, j0 : +16]
#pragma unroll
  for (int t = 0; t < NCF; ++t) {
    wmma::fill_fragment(acc1[t], 0.0f);
    wmma::fill_fragment(acc2[t], 0.0f);
  }
  float db1_acc = 0.0f;

  int buf = 0;
  for (int tile = split; tile < ntiles; tile += nsplit, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // tile landed; every warp is done with the previous one
    const int next = tile + nsplit;
    if (next < ntiles) {
      const int rv = min(BMW, M - next * BMW);
      load_tile_async(xs[buf ^ 1], LDC, x + (int64_t)next * BMW * C, C, BMW, C, rv);
      load_tile_async(gs[buf ^ 1], LDC, g + (int64_t)next * BMW * C, C, BMW, C, rv);
    }
    cp_async_commit();
    {
      // warps 0-3: quarter kq of u = x @ W1c^T; warps 4-7: of dp = g @ W2c
      const int kq = warp & 3;
      FragC f;
      wmma::fill_fragment(f, 0.0f);
      if (warp < 4)
        mm_abt(f, xs[buf], LDC, w1c, LDC, 0, 0, kq * (C / 4), C / 4);
      else
        mm_ab(f, gs[buf], LDC, w2c, LDHW, 0, 0, kq * (C / 4), C / 4);
      wmma::store_matrix_sync(stage + warp * 256, f, 16, wmma::mem_row_major);
    }
    __syncthreads();
    {
      // one (row, hidden) element per thread; the quarters sum in fixed order
      const int e = threadIdx.x, j = e & 15;
      const float u = ((stage[e] + stage[256 + e]) + (stage[512 + e] + stage[768 + e])) +
                      b1[j0 + j];
      const float dp = (stage[1024 + e] + stage[1280 + e]) + (stage[1536 + e] + stage[1792 + e]);
      const float dh = dp * dgelu_f(u);
      const int r = e >> 4;
      hs[r * LDHW + j] = __float2bfloat16(gelu_f(u));
      dhs[r * LDHW + j] = __float2bfloat16(dh);
      dhf[e] = dh;
    }
    __syncthreads();
    if (threadIdx.x < HCW) {
      for (int r = 0; r < BMW; ++r) db1_acc += dhf[r * HCW + threadIdx.x];
    }
    if (first_chunk) {
      for (int c = threadIdx.x; c < C; c += NT) {
        float s = 0.0f;
        for (int r = 0; r < BMW; ++r) s += __bfloat162float(gs[buf][r * LDC + c]);
        db2s[c] += s;
      }
    }
    // dW1[j, c] += sum_m dh[m, j] x[m, c];  dW2[c, j] += sum_m g[m, c] h[m, j]
    FragAT fdh;
    FragB fh;
    wmma::load_matrix_sync(fdh, dhs, LDHW);
    wmma::load_matrix_sync(fh, hs, LDHW);
#pragma unroll
    for (int t = 0; t < NCF; ++t) {
      FragB fx;
      wmma::load_matrix_sync(fx, xs[buf] + (warp * NCF + t) * 16, LDC);
      wmma::mma_sync(acc1[t], fdh, fx, acc1[t]);
      FragAT fg;
      wmma::load_matrix_sync(fg, gs[buf] + (warp * NCF + t) * 16, LDC);
      wmma::mma_sync(acc2[t], fg, fh, acc2[t]);
    }
  }
  cp_async_wait<0>();

  const int64_t per_split = 2 * (int64_t)C * H + H + C;
  float* part = ws + split * per_split;
#pragma unroll
  for (int t = 0; t < NCF; ++t) {
    const int c0 = (warp * NCF + t) * 16;
    wmma::store_matrix_sync(part + (int64_t)j0 * C + c0, acc1[t], C, wmma::mem_row_major);
    wmma::store_matrix_sync(part + (int64_t)C * H + (int64_t)c0 * H + j0, acc2[t], H,
                            wmma::mem_row_major);
  }
  if (threadIdx.x < HCW) part[2 * (int64_t)C * H + j0 + threadIdx.x] = db1_acc;
  if (first_chunk)
    for (int c = threadIdx.x; c < C; c += NT) part[2 * (int64_t)C * H + H + c] = db2s[c];
}

__global__ void reduce_blocked_kernel(const float* __restrict__ ws, int nsplit, int C, int H,
                                      bf16* __restrict__ dw1, bf16* __restrict__ dw2,
                                      float* __restrict__ db1, float* __restrict__ db2) {
  const int64_t ch = (int64_t)C * H;
  const int64_t per_split = 2 * ch + H + C;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < per_split;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < nsplit; ++k) s += ws[k * per_split + i];
    if (i < ch)
      dw1[i] = __float2bfloat16(s);
    else if (i < 2 * ch)
      dw2[i - ch] = __float2bfloat16(s);
    else if (i < 2 * ch + H)
      db1[i - 2 * ch] = s;
    else
      db2[i - 2 * ch - H] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int C>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int M, int H, cudaStream_t stream) {
  constexpr size_t smem = FwdSmem<C>::total;
  cudaError_t e = set_smem(fwd_blocked_kernel<C>, smem);
  if (e != cudaSuccess) return (int)e;
  fwd_blocked_kernel<C><<<(M + BM - 1) / BM, NT, smem, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
      (bf16*)out, M, H);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* g,
               void* dx, void* dw1, void* dw2, void* db1, void* db2, void* ws, int M, int H,
               int nsplit, cudaStream_t stream) {
  constexpr size_t smem_dx = DxSmem<C>::total;
  constexpr size_t smem_dw = DwSmem<C>::total;
  cudaError_t e = set_smem(dx_blocked_kernel<C>, smem_dx);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(dw_blocked_kernel<C>, smem_dw);
  if (e != cudaSuccess) return (int)e;
  dx_blocked_kernel<C><<<(M + BM - 1) / BM, NT, smem_dx, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const bf16*)g,
      (bf16*)dx, M, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dw_blocked_kernel<C><<<dim3(H / HCW, nsplit), NT, smem_dw, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const bf16*)g,
      (float*)ws, M, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t per_split = 2 * (int64_t)C * H + H + C;
  const int blocks = (int)((per_split + 255) / 256);
  reduce_blocked_kernel<<<blocks, 256, 0, stream>>>((const float*)ws, nsplit, C, H, (bf16*)dw1,
                                                    (bf16*)dw2, (float*)db1, (float*)db2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes the kernels take: C = 768, H a positive multiple of 32, M >= 1.
int srt_fused_mlp_blocked_supported(int C, int H) {
  return C == 768 && H > 0 && H % HC == 0;
}

int srt_fused_mlp_blocked_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* out, int M, int C, int H, void* stream) {
  if (M <= 0 || !srt_fused_mlp_blocked_supported(C, H)) return (int)cudaErrorInvalidValue;
  return launch_fwd<768>(x, w1, b1, w2, b2, out, M, H, (cudaStream_t)stream);
}

// ws: nsplit * (2*C*H + H + C) f32, allocated by the caller; nsplit row
// splits of the dW kernel.
int srt_fused_mlp_blocked_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* g, void* dx, void* dw1, void* dw2, void* db1,
                              void* db2, void* ws, int M, int C, int H, int nsplit,
                              void* stream) {
  if (M <= 0 || nsplit <= 0 || !srt_fused_mlp_blocked_supported(C, H))
    return (int)cudaErrorInvalidValue;
  return launch_bwd<768>(x, w1, b1, w2, g, dx, dw1, dw2, db1, db2, ws, M, H, nsplit,
                         (cudaStream_t)stream);
}

}  // extern "C"
