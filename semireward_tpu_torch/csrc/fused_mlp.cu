// Fused transformer MLP for Hopper (sm_90a): out = gelu(x @ W1^T + b1) @ W2^T + b2
// forward and backward, with the [M, H] hidden activation never written to
// device memory.
//
// Replaces the full-resident Pallas TPU kernels of the JAX package:
//   semireward_tpu/ops/fused_mlp.py:_fwd_kernel (launched by _fwd)
//   semireward_tpu/ops/fused_mlp.py:_bwd_kernel (launched by _bwd)
//
// Layouts follow torch.nn.Linear: x [M, C], W1 [H, C], b1 [H], W2 [C, H],
// b2 [C]; x/W/out/g/dx bf16, biases and bias grads f32, dW bf16 (the dtype of
// the weights handed in, as the JAX custom VJP casts dW to the primal dtype).
// Products run on the tensor cores (WMMA bf16 16x16x16, f32 accumulation);
// bias adds and GELU (exact erf form, erff) run in f32.
//
// Bound at the headline shape (ViT-S/2-32 train step, M = 24*257 = 6168,
// C = 384, H = 1536), H100 SXM: forward 4*M*C*H = 14.6 GFLOP -> 14.7 us at
// 989 TFLOP/s bf16 dense, against ~12 MB of bytes -> 3.6 us at 3.35 TB/s;
// backward ~10*M*C*H = 36.4 GFLOP -> 36.8 us. Both are bound by operations.
//
// Design.
// * Forward (fwd_kernel): one CTA of 8 warps owns a BM = 64 row tile of x
//   (held in shared memory) and loops over hidden chunks of HC = 32:
//   u = x_tile @ W1[chunk]^T + b1 in f32, h = bf16(gelu(u)) in shared memory,
//   out_tile += h @ W2[:, chunk]^T with the [64, C] accumulator in registers
//   (12 WMMA fragments per warp at C = 384). The next chunk's W1/W2 slices
//   stream in with cp.async while the current one is multiplied (two
//   buffers), so the loads from L2 hide behind the tensor-core work.
// * The TPU kernel accumulates dW/db across a SEQUENTIAL grid in VMEM. Hopper
//   CTAs run in parallel and in no order, so the backward splits in three
//   launches, all deterministic (no atomics):
//   - dx_kernel: row tiles like the forward (double-buffered weight chunks);
//     per hidden chunk recomputes u and dh = (g @ W2[:, chunk]) * gelu'(u),
//     then dx_tile += bf16(dh) @ W1[chunk].
//   - dw_kernel: grid (H / HC hidden chunks) x (S row splits). Each CTA keeps
//     its W1/W2 chunk in shared memory, walks its 32-row tiles (the next tile
//     of x and g streams in with cp.async), recomputes u, h and dh, and
//     accumulates dW1[chunk] = dh^T x and dW2[:, chunk] = g^T h in registers,
//     db1 and (chunk 0 only) db2 in f32. It writes one partial per split into
//     a workspace of S * (2*C*H + H + C) f32 that the wrapper allocates
//     (9.4 MB at the headline shape with S = 2).
//   - reduce_kernel: sums the S partials in a fixed order and casts dW to bf16.
// * The two-operand elementwise steps (u + b1, dp * gelu'(u)) run on WMMA
//   accumulators directly: u's accumulator starts from a tile of b1, and two
//   accumulators of one type hold the same (row, col) in the same element.
// * The ragged last row tile (6168 = 96*64 + 24 at the headline) loads zero
//   rows past M (cp.async zero-fill), so x and g are zero there and add
//   nothing to dW/db, as the TPU kernel's row mask does
//   (fused_mlp.py:118-125); stores skip those rows.
// * Every function launches on the caller's stream, allocates nothing, and
//   returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;      // rows per tile (forward, dx)
constexpr int BMW = 32;     // rows per tile (dW)
constexpr int HC = 32;      // hidden chunk
constexpr int NT = 256;     // threads per CTA (8 warps)
constexpr int LDH = HC + 8; // bf16 leading dim of [*, HC] tiles
constexpr int LDF = HC + 4; // f32 leading dim of [*, HC] tiles

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
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

// The W1/W2 slices of hidden chunk j0: w1c[j][c] = W1[j0 + j][c] and
// w2c[n][j] = W2[n][j0 + j].
template <int C>
__device__ __forceinline__ void load_chunk_async(bf16* w1c, bf16* w2c, const bf16* w1,
                                                 const bf16* w2, int j0, int H) {
  load_tile_async(w1c, C + 8, w1 + (int64_t)j0 * C, C, HC, C, HC);
  load_tile_async(w2c, LDH, w2 + j0, H, C, HC, C);
}

// A 16 x HC f32 tile whose every row is b1[j0 .. j0 + HC): the start value of
// u's accumulators, so that u comes out with the bias added.
__device__ __forceinline__ void fill_bias_tile(float* bt, const float* b1, int j0) {
  for (int e = threadIdx.x; e < 16 * HC; e += NT) bt[(e / HC) * LDF + e % HC] = b1[j0 + e % HC];
}

// acc (+)= A[rf*16 : +16, 0:C] @ W1c[cf*16 : +16, 0:C]^T with A [*][C+8] and
// W1c [HC][C+8] in shared memory; two accumulators halve the dependent chain.
template <int C>
__device__ __forceinline__ void mm_x_w1t(FragC& acc, const bf16* a, const bf16* w1c,
                                         int rf, int cf) {
  constexpr int LDC = C + 8;
  FragC acc2;
  wmma::fill_fragment(acc2, 0.0f);
  FragA fa;
  FragBT fb;
#pragma unroll 4
  for (int k = 0; k < C; k += 32) {
    wmma::load_matrix_sync(fa, a + rf * 16 * LDC + k, LDC);
    wmma::load_matrix_sync(fb, w1c + cf * 16 * LDC + k, LDC);
    wmma::mma_sync(acc, fa, fb, acc);
    wmma::load_matrix_sync(fa, a + rf * 16 * LDC + k + 16, LDC);
    wmma::load_matrix_sync(fb, w1c + cf * 16 * LDC + k + 16, LDC);
    wmma::mma_sync(acc2, fa, fb, acc2);
  }
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc2.x[i];
}

// acc = G[rf*16 : +16, 0:C] @ W2c[0:C, cf*16 : +16], with G [*][C+8] and
// W2c [C][LDH] in shared memory.
template <int C>
__device__ __forceinline__ void mm_g_w2c(FragC& acc, const bf16* g, const bf16* w2c,
                                         int rf, int cf) {
  constexpr int LDC = C + 8;
  FragC acc2;
  wmma::fill_fragment(acc, 0.0f);
  wmma::fill_fragment(acc2, 0.0f);
  FragA fa;
  FragB fb;
#pragma unroll 4
  for (int k = 0; k < C; k += 32) {
    wmma::load_matrix_sync(fa, g + rf * 16 * LDC + k, LDC);
    wmma::load_matrix_sync(fb, w2c + k * LDH + cf * 16, LDH);
    wmma::mma_sync(acc, fa, fb, acc);
    wmma::load_matrix_sync(fa, g + rf * 16 * LDC + k + 16, LDC);
    wmma::load_matrix_sync(fb, w2c + (k + 16) * LDH + cf * 16, LDH);
    wmma::mma_sync(acc2, fa, fb, acc2);
  }
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc2.x[i];
}

// Store a 16x16 f32 fragment through this warp's staging tile into a bf16
// tile at dst (leading dim ld).
__device__ __forceinline__ void frag_to_bf16(float* stage, const FragC& f, bf16* dst,
                                             int ld) {
  wmma::store_matrix_sync(stage, f, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = lane; e < 256; e += 32) dst[(e >> 4) * ld + (e & 15)] = __float2bfloat16(stage[e]);
  __syncwarp();
}

// Stage the [BM, C] f32 accumulators (warp w owns column fragments
// w*NCF .. w*NCF+NCF-1 of all 4 row fragments) and write rows < rows_valid
// as bf16, adding bias when given.
template <int C>
__device__ __forceinline__ void store_rows(float* stage, FragC (&acc)[4][C / 128],
                                           bf16* out, const float* bias, int row0,
                                           int rows_valid) {
  constexpr int NCF = C / 128;
  constexpr int LDS = C + 4;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int rf = 0; rf < 4; ++rf)
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

// shared-memory plans (bytes)
template <int C>
struct FwdSmem {
  static constexpr size_t xs = (size_t)BM * (C + 8) * 2;
  static constexpr size_t w1c = (size_t)HC * (C + 8) * 2;
  static constexpr size_t w2c = (size_t)C * LDH * 2;
  static constexpr size_t stage = 8 * 256 * 4;  // one 16x16 f32 tile per warp
  static constexpr size_t bias = 16 * LDF * 4;
  static constexpr size_t hs = (size_t)BM * LDH * 2;
  static constexpr size_t main = xs + 2 * (w1c + w2c) + stage + bias + hs;
  static constexpr size_t out = (size_t)BM * (C + 4) * 4;
  static constexpr size_t total = main > out ? main : out;
};

template <int C>
struct DxSmem {
  static constexpr size_t tile = (size_t)BM * (C + 8) * 2;
  static constexpr size_t main = 2 * tile + 2 * (FwdSmem<C>::w1c + FwdSmem<C>::w2c) +
                                 FwdSmem<C>::stage + FwdSmem<C>::bias + FwdSmem<C>::hs;
  static constexpr size_t out = (size_t)BM * (C + 4) * 4;
  static constexpr size_t total = main > out ? main : out;
};

template <int C>
struct DwSmem {
  static constexpr size_t tile = (size_t)BMW * (C + 8) * 2;
  static constexpr size_t total = 4 * tile + FwdSmem<C>::w1c + FwdSmem<C>::w2c +
                                  2 * (size_t)BMW * LDF * 4 + 2 * (size_t)BMW * LDH * 2 +
                                  (size_t)C * 4;
};

template <int C>
__global__ void __launch_bounds__(NT, 1)
fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, bf16* __restrict__ out, int M, int H) {
  constexpr int LDC = C + 8;
  constexpr int NCF = C / 128;
  typedef FwdSmem<C> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1c[2] = {reinterpret_cast<bf16*>(smem + S::xs),
                  reinterpret_cast<bf16*>(smem + S::xs + S::w1c)};
  bf16* w2c[2] = {reinterpret_cast<bf16*>(smem + S::xs + 2 * S::w1c),
                  reinterpret_cast<bf16*>(smem + S::xs + 2 * S::w1c + S::w2c)};
  float* stage = reinterpret_cast<float*>(smem + S::xs + 2 * (S::w1c + S::w2c));
  float* bias = stage + 8 * 256;
  bf16* hs = reinterpret_cast<bf16*>(bias + 16 * LDF);

  const int warp = threadIdx.x / 32;
  const int rf = warp >> 1, cf = warp & 1;
  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, M - row0);
  load_tile_async(xs, LDC, x + (int64_t)row0 * C, C, BM, C, rows_valid);
  load_chunk_async<C>(w1c[0], w2c[0], w1, w2, 0, H);
  cp_async_commit();

  FragC acc[4][NCF];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < NCF; ++t) wmma::fill_fragment(acc[r][t], 0.0f);

  const int nchunks = H / HC;
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1, j0 = c * HC;
    cp_async_wait_all();
    fill_bias_tile(bias, b1, j0);
    __syncthreads();  // chunk c (and x) landed; every warp is done with c - 1
    if (c + 1 < nchunks) load_chunk_async<C>(w1c[buf ^ 1], w2c[buf ^ 1], w1, w2, j0 + HC, H);
    cp_async_commit();
    {
      FragC u;
      wmma::load_matrix_sync(u, bias + cf * 16, LDF, wmma::mem_row_major);
      mm_x_w1t<C>(u, xs, w1c[buf], rf, cf);
#pragma unroll
      for (int i = 0; i < u.num_elements; ++i) u.x[i] = gelu_f(u.x[i]);
      frag_to_bf16(stage + warp * 256, u, hs + rf * 16 * LDH + cf * 16, LDH);
    }
    __syncthreads();  // h complete
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      FragBT fb[NCF];
#pragma unroll
      for (int t = 0; t < NCF; ++t)
        wmma::load_matrix_sync(fb[t], w2c[buf] + (warp * NCF + t) * 16 * LDH + k, LDH);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        FragA fa;
        wmma::load_matrix_sync(fa, hs + r * 16 * LDH + k, LDH);
#pragma unroll
        for (int t = 0; t < NCF; ++t) wmma::mma_sync(acc[r][t], fa, fb[t], acc[r][t]);
      }
    }
  }
  __syncthreads();
  store_rows<C>(reinterpret_cast<float*>(smem), acc, out, b2, row0, rows_valid);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
          const float* __restrict__ b1, const bf16* __restrict__ w2,
          const bf16* __restrict__ g, bf16* __restrict__ dx, int M, int H) {
  constexpr int LDC = C + 8;
  constexpr int NCF = C / 128;
  typedef FwdSmem<C> F;
  typedef DxSmem<C> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gs = reinterpret_cast<bf16*>(smem + S::tile);
  unsigned char* wbase = smem + 2 * S::tile;
  bf16* w1c[2] = {reinterpret_cast<bf16*>(wbase), reinterpret_cast<bf16*>(wbase + F::w1c)};
  bf16* w2c[2] = {reinterpret_cast<bf16*>(wbase + 2 * F::w1c),
                  reinterpret_cast<bf16*>(wbase + 2 * F::w1c + F::w2c)};
  float* stage = reinterpret_cast<float*>(wbase + 2 * (F::w1c + F::w2c));
  float* bias = stage + 8 * 256;
  bf16* dhs = reinterpret_cast<bf16*>(bias + 16 * LDF);

  const int warp = threadIdx.x / 32;
  const int rf = warp >> 1, cf = warp & 1;
  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, M - row0);
  load_tile_async(xs, LDC, x + (int64_t)row0 * C, C, BM, C, rows_valid);
  load_tile_async(gs, LDC, g + (int64_t)row0 * C, C, BM, C, rows_valid);
  load_chunk_async<C>(w1c[0], w2c[0], w1, w2, 0, H);
  cp_async_commit();

  FragC acc[4][NCF];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int t = 0; t < NCF; ++t) wmma::fill_fragment(acc[r][t], 0.0f);

  const int nchunks = H / HC;
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1, j0 = c * HC;
    cp_async_wait_all();
    fill_bias_tile(bias, b1, j0);
    __syncthreads();
    if (c + 1 < nchunks) load_chunk_async<C>(w1c[buf ^ 1], w2c[buf ^ 1], w1, w2, j0 + HC, H);
    cp_async_commit();
    {
      FragC u, dp;
      wmma::load_matrix_sync(u, bias + cf * 16, LDF, wmma::mem_row_major);
      mm_x_w1t<C>(u, xs, w1c[buf], rf, cf);
      mm_g_w2c<C>(dp, gs, w2c[buf], rf, cf);
#pragma unroll
      for (int i = 0; i < u.num_elements; ++i) dp.x[i] *= dgelu_f(u.x[i]);
      frag_to_bf16(stage + warp * 256, dp, dhs + rf * 16 * LDH + cf * 16, LDH);
    }
    __syncthreads();  // dh complete
#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      FragB fb[NCF];
#pragma unroll
      for (int t = 0; t < NCF; ++t)
        wmma::load_matrix_sync(fb[t], w1c[buf] + k * LDC + (warp * NCF + t) * 16, LDC);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        FragA fa;
        wmma::load_matrix_sync(fa, dhs + r * 16 * LDH + k, LDH);
#pragma unroll
        for (int t = 0; t < NCF; ++t) wmma::mma_sync(acc[r][t], fa, fb[t], acc[r][t]);
      }
    }
  }
  __syncthreads();
  store_rows<C>(reinterpret_cast<float*>(smem), acc, dx, nullptr, row0, rows_valid);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
          const float* __restrict__ b1, const bf16* __restrict__ w2,
          const bf16* __restrict__ g, float* __restrict__ ws, int M, int H) {
  constexpr int LDC = C + 8;
  constexpr int NCF = C / 128;
  typedef FwdSmem<C> F;
  typedef DwSmem<C> S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + S::tile)};
  bf16* gs[2] = {reinterpret_cast<bf16*>(smem + 2 * S::tile),
                 reinterpret_cast<bf16*>(smem + 3 * S::tile)};
  bf16* w1c = reinterpret_cast<bf16*>(smem + 4 * S::tile);
  bf16* w2c = reinterpret_cast<bf16*>(smem + 4 * S::tile + F::w1c);
  float* us = reinterpret_cast<float*>(smem + 4 * S::tile + F::w1c + F::w2c);
  float* dps = us + BMW * LDF;
  bf16* hs = reinterpret_cast<bf16*>(dps + BMW * LDF);
  bf16* dhs = hs + BMW * LDH;
  float* db2s = reinterpret_cast<float*>(dhs + BMW * LDH);

  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * HC;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const bool first_chunk = blockIdx.x == 0;
  const int64_t per_split = 2 * (int64_t)C * H + H + C;
  float* part = ws + split * per_split;
  const int ntiles = (M + BMW - 1) / BMW;

  load_chunk_async<C>(w1c, w2c, w1, w2, j0, H);
  if (split < ntiles) {
    const int rv = min(BMW, M - split * BMW);
    load_tile_async(xs[0], LDC, x + (int64_t)split * BMW * C, C, BMW, C, rv);
    load_tile_async(gs[0], LDC, g + (int64_t)split * BMW * C, C, BMW, C, rv);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < C; c += NT) db2s[c] = 0.0f;

  FragC acc1[2][NCF];  // dW1[j0 + i*16, (warp*NCF + t)*16]
  FragC acc2[NCF][2];  // dW2[(warp*NCF + t)*16, j0 + i*16]
#pragma unroll
  for (int t = 0; t < NCF; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::fill_fragment(acc1[i][t], 0.0f);
      wmma::fill_fragment(acc2[t][i], 0.0f);
    }
  float db1_acc = 0.0f;

  int buf = 0;
  for (int tile = split; tile < ntiles; tile += nsplit, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile landed; every warp is done with the previous one
    const int next = tile + nsplit;
    if (next < ntiles) {
      const int rv = min(BMW, M - next * BMW);
      load_tile_async(xs[buf ^ 1], LDC, x + (int64_t)next * BMW * C, C, BMW, C, rv);
      load_tile_async(gs[buf ^ 1], LDC, g + (int64_t)next * BMW * C, C, BMW, C, rv);
    }
    cp_async_commit();
    // phase 1: warps 0-3 compute u, warps 4-7 compute g @ W2c ([32 x 32] each)
    {
      const int q = warp & 3, rf = q >> 1, cf = q & 1;
      FragC f;
      if (warp < 4) {
        wmma::fill_fragment(f, 0.0f);
        mm_x_w1t<C>(f, xs[buf], w1c, rf, cf);
        wmma::store_matrix_sync(us + rf * 16 * LDF + cf * 16, f, LDF, wmma::mem_row_major);
      } else {
        mm_g_w2c<C>(f, gs[buf], w2c, rf, cf);
        wmma::store_matrix_sync(dps + rf * 16 * LDF + cf * 16, f, LDF, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BMW * HC; e += NT) {
      const int r = e / HC, j = e - r * HC;
      const float u = us[r * LDF + j] + b1[j0 + j];
      const float dh = dps[r * LDF + j] * dgelu_f(u);
      dps[r * LDF + j] = dh;
      hs[r * LDH + j] = __float2bfloat16(gelu_f(u));
      dhs[r * LDH + j] = __float2bfloat16(dh);
    }
    __syncthreads();
    if (threadIdx.x < HC) {
      for (int r = 0; r < BMW; ++r) db1_acc += dps[r * LDF + threadIdx.x];
    }
    if (first_chunk) {
      for (int c = threadIdx.x; c < C; c += NT) {
        float s = 0.0f;
        for (int r = 0; r < BMW; ++r) s += __bfloat162float(gs[buf][r * LDC + c]);
        db2s[c] += s;
      }
    }
#pragma unroll 1
    for (int k = 0; k < BMW; k += 16) {
      // dW1[j, c] += sum_m dh[m, j] * x[m, c]
      FragAT fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], dhs + k * LDH + i * 16, LDH);
#pragma unroll
      for (int t = 0; t < NCF; ++t) {
        FragB fb;
        wmma::load_matrix_sync(fb, xs[buf] + k * LDC + (warp * NCF + t) * 16, LDC);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc1[i][t], fa[i], fb, acc1[i][t]);
      }
      // dW2[n, j] += sum_m g[m, n] * h[m, j]
      FragB fh[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fh[i], hs + k * LDH + i * 16, LDH);
#pragma unroll
      for (int t = 0; t < NCF; ++t) {
        FragAT fg;
        wmma::load_matrix_sync(fg, gs[buf] + k * LDC + (warp * NCF + t) * 16, LDC);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc2[t][i], fg, fh[i], acc2[t][i]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int t = 0; t < NCF; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::store_matrix_sync(part + (int64_t)(j0 + i * 16) * C + (warp * NCF + t) * 16,
                              acc1[i][t], C, wmma::mem_row_major);
      wmma::store_matrix_sync(
          part + (int64_t)C * H + (int64_t)((warp * NCF + t) * 16) * H + j0 + i * 16,
          acc2[t][i], H, wmma::mem_row_major);
    }
  if (threadIdx.x < HC) part[2 * (int64_t)C * H + j0 + threadIdx.x] = db1_acc;
  if (first_chunk)
    for (int c = threadIdx.x; c < C; c += NT) part[2 * (int64_t)C * H + H + c] = db2s[c];
}

__global__ void reduce_kernel(const float* __restrict__ ws, int nsplit, int C, int H,
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
  cudaError_t e = set_smem(fwd_kernel<C>, smem);
  if (e != cudaSuccess) return (int)e;
  fwd_kernel<C><<<(M + BM - 1) / BM, NT, smem, stream>>>(
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
  cudaError_t e = set_smem(dx_kernel<C>, smem_dx);
  if (e != cudaSuccess) return (int)e;
  e = set_smem(dw_kernel<C>, smem_dw);
  if (e != cudaSuccess) return (int)e;
  dx_kernel<C><<<(M + BM - 1) / BM, NT, smem_dx, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const bf16*)g,
      (bf16*)dx, M, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dw_kernel<C><<<dim3(H / HC, nsplit), NT, smem_dw, stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const bf16*)g,
      (float*)ws, M, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t per_split = 2 * (int64_t)C * H + H + C;
  const int blocks = (int)((per_split + 255) / 256);
  reduce_kernel<<<blocks, 256, 0, stream>>>((const float*)ws, nsplit, C, H, (bf16*)dw1,
                                            (bf16*)dw2, (float*)db1, (float*)db2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes the kernels take: C in {128, 256, 384}, H a multiple of 32, M >= 1.
int srt_fused_mlp_supported(int C, int H) {
  return (C == 128 || C == 256 || C == 384) && H > 0 && H % HC == 0;
}

int srt_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, int M, int C, int H, void* stream) {
  if (M <= 0 || !srt_fused_mlp_supported(C, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 128: return launch_fwd<128>(x, w1, b1, w2, b2, out, M, H, s);
    case 256: return launch_fwd<256>(x, w1, b1, w2, b2, out, M, H, s);
    default: return launch_fwd<384>(x, w1, b1, w2, b2, out, M, H, s);
  }
}

// ws: nsplit * (2*C*H + H + C) f32, allocated by the caller; nsplit row
// splits of the dW kernel.
int srt_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* g, void* dx, void* dw1, void* dw2, void* db1, void* db2,
                      void* ws, int M, int C, int H, int nsplit, void* stream) {
  if (M <= 0 || nsplit <= 0 || !srt_fused_mlp_supported(C, H))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 128: return launch_bwd<128>(x, w1, b1, w2, g, dx, dw1, dw2, db1, db2, ws, M, H, nsplit, s);
    case 256: return launch_bwd<256>(x, w1, b1, w2, g, dx, dw1, dw2, db1, db2, ws, M, H, nsplit, s);
    default: return launch_bwd<384>(x, w1, b1, w2, g, dx, dw1, dw2, db1, db2, ws, M, H, nsplit, s);
  }
}

}  // extern "C"
