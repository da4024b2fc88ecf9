// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels with an
// in-kernel key-padding bias and counter-hash dropout on the probabilities.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   semireward_tpu/ops/attention.py:_fwd_kernel     (launched by _fwd_call)
//   semireward_tpu/ops/attention.py:_bwd_dq_kernel  (launched by _flash_bwd)
//   semireward_tpu/ops/attention.py:_bwd_dkv_kernel (launched by _flash_bwd)
//
// Layouts: q, k, v, out, dout, dq, dk, dv are [B, N, H, D] bf16 (the layout
// the projections produce, so nothing is transposed); the key bias is
// [B*H, N] f32; lse and delta are [B*H, N] f32; the dropout seed is one int32
// on the device, read through its pointer (no host round trip per layer).
//
// Arithmetic follows the JAX kernels: scores in f32 (s = q.k * scale + bias,
// keys >= N at -1e30), online softmax with the row max m and sum l, lse =
// m + log(l); the backward recomputes p = exp(s - lse), dp = dO.V^T, dropout
// on p (for PV / dV) and on dp, ds = p * (dp - delta). Every tensor-core
// product takes bf16 operands with f32 accumulation, so P, dS and P^T are
// rounded to bf16 before their products; the JAX kernels keep them in f32.
// That is the one deliberate difference, held to one bf16 rounding (1% of
// max|plain|) against the plain version.
//
// Dropout keep bit, identical to attention_keep_mask: with Np = N rounded up
// to 128 (the JAX kernel's padded length, kept as part of the stream although
// nothing is padded here) and bh the batch*head index,
//   ctr  = (bh * Np + q) * Np + k            (uint32, wrapping)
//   keep = lowbias32(lowbias32(ctr) ^ seed) < thresh
// so the three kernels regenerate one mask with no extra memory.
//
// Bound at the BERT-base train shape (BH = 144, N = 512, D = 64), H100 SXM:
// forward 4*BH*N^2*D = 9.7 GFLOP -> 9.8 us at 989 TFLOP/s bf16 dense, against
// ~38 MB of q, k, v, out -> 11.3 us at 3.35 TB/s: bound by bytes. Backward
// with recompute, 7 products = 33.8 GFLOP -> 34 us: bound by operations.
//
// Design (one round of latency work; wgmma/TMA/warp specialisation come
// later).
// * One CTA of 4 warps owns a 64-row tile (queries in fwd/dq, keys in dkv);
//   each warp owns 16 of its rows and runs mma.sync m16n8k16 (bf16 in, f32
//   accumulate) with operands in shared memory ([64][D+8] bf16 tiles, the +8
//   spreads rows over the banks, so ldmatrix reads them without conflicts).
//   The head dim D is 64, that of every net of the port (ViT-Ti/S/B, BERT).
//   Fragments come from shared memory through ldmatrix (.trans for the
//   B operand of PV, dS.K, P^T.dO and dS^T.Q); the warp's own 16-row
//   fragments (Q in fwd, Q and dO in dq, K and V in dkv) stay in registers
//   for the whole loop.
// * The TPU grid runs the key (or query) blocks in order inside one kernel
//   instance; here a loop inside the CTA walks them, two tiles deep: the next
//   tiles stream in with cp.async (zero-filled past N) while the current
//   ones are multiplied. The CTAs over (tile, batch*head) run in parallel. dq
//   and dk/dv are separate kernels, as on the TPU: each output has one
//   writer, so no atomics, deterministic.
// * Online softmax runs in registers, in base 2 (log2(e) folded into the
//   scale and the bias): a row's 64 scores live in the 4 lanes of a quad
//   (mma accumulator layout), so row max and sum take two shuffles. The f32
//   accumulator of S or dS converts to the A operand of the next product in
//   registers (the m16n8 C layout of two n-tiles is the m16k16 A layout).
// * A ragged tail (N not a multiple of 64) loads zero rows and masks keys
//   >= N to -1e30 and queries >= N to p = 0, as the JAX kernels mask their
//   128-padding; stores skip rows >= N.
// * Every function launches on the caller's stream, allocates nothing, and
//   returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 64;           // head dim
constexpr int LD = D + 8;       // shared-memory row stride of a tile
constexpr int BM = 64;          // rows per tile (queries or keys)
constexpr int TILE = BM * LD;   // elements of one [64][D + 8] tile
constexpr int KS = D / 16;      // k-steps of a product over D
constexpr int NT = 128;         // threads per CTA: 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;     // [B*H, N] key bias, or nullptr
  const int* seed;       // one int32 on the device, or nullptr (no dropout)
  const bf16* dout;      // backward only
  const float* lse_in;   // backward only
  const float* delta;    // backward only
  bf16* out;
  float* lse;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int N, H, Np;
  float scale, inv_keep;
  uint32_t thresh;
};

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool keep_bit(uint32_t bh, uint32_t qpos, uint32_t kpos,
                                         uint32_t Np, uint32_t seed, uint32_t thresh) {
  const uint32_t ctr = (bh * Np + qpos) * Np + kpos;
  return lowbias32(lowbias32(ctr) ^ seed) < thresh;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// c[4] += a[4] (16x16 bf16, row) * b[2] (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A operand: the 16x16 tile at s, row-major with leading dim ld.
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int ld, int lane) {
  ldsm_x4(a, s + (lane & 15) * ld + (lane >> 4) * 8);
}

// B operands of n-tiles n0 and n0 + 8 for B[kk][n] = s[n][kk] (s row-major
// [n][k], at row n0 and the k-step's column): a product with X^T.
__device__ __forceinline__ void frag_bt2(uint32_t b[4], const bf16* s, int ld, int lane) {
  ldsm_x4(b, s + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8);
}

// B operands of n-tiles n0 and n0 + 8 for B[kk][n] = s[kk][n] (s row-major
// [k][n], at the k-step's row and column n0).
__device__ __forceinline__ void frag_b2(uint32_t b[4], const bf16* s, int ld, int lane) {
  ldsm_x4_t(b, s + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

// The A operand of k-step kk from the f32 accumulators of n-tiles 2kk, 2kk+1.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Rows [r0, r0 + 64) of one head's [N, D] view (row stride rs elements) into a
// [64][D + 8] shared tile with cp.async, 16 bytes per thread per step; rows
// past N are zero-filled (a source size of 0 reads nothing).
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int r0, int N, int64_t rs) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < BM * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < N;
    const bf16* src = g + (int64_t)(ok ? r0 + r : 0) * rs + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(s + r * LD + c)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// 64 f32 of one row of a [B*H, N] array from index i0 into shared memory,
// times `scale`; 0 where g is null, `fill` past N (plain loads; the barrier
// before their use publishes them).
__device__ __forceinline__ void load_vec(float* s, const float* g, int i0, int N, float scale,
                                         float fill) {
  if (threadIdx.x < BM) {
    const int i = i0 + threadIdx.x;
    s[threadIdx.x] = i >= N ? fill : (g != nullptr ? g[i] * scale : 0.f);
  }
}

// Per-CTA geometry: head offset into [B, N, H, D], row stride.
struct Head {
  int64_t off, rs;
  __device__ Head(const Params& p, int bh) {
    rs = (int64_t)p.H * D;
    off = ((int64_t)(bh / p.H) * p.N * p.H + bh % p.H) * D;
  }
};

// Dynamic shared memory of each kernel, in bytes.
constexpr size_t TILE_BYTES = TILE * sizeof(bf16), VEC_BYTES = BM * sizeof(float);
constexpr size_t SMEM_FWD = 5 * TILE_BYTES + 2 * VEC_BYTES;  // Q, 2 x (K, V, bias)
constexpr size_t SMEM_DQ = 6 * TILE_BYTES + 2 * VEC_BYTES;   // Q, dO, 2 x (K, V, bias)
constexpr size_t SMEM_DKV = 6 * TILE_BYTES + 4 * VEC_BYTES;  // K, V, 2 x (Q, dO, lse, delta)

// ---------------------------------------------------------------------------
// forward: grid (ceil(N/64), B*H); O and lse for 64 queries
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TILE;        // two buffers
  bf16* sV = sK + 2 * TILE;    // two buffers
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE);  // two buffers

  const int bh = blockIdx.y, q0 = blockIdx.x * BM, N = p.N;
  const Head hd(p, bh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);  // tile row of acc elements 0,1 (2,3: +8)
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;
  const float* bias = p.bias != nullptr ? p.bias + (int64_t)bh * N : nullptr;
  const float sl2 = p.scale * LOG2E;
  const int nk = (N + BM - 1) / BM;

  load_tile(sQ, p.q + hd.off, q0, N, hd.rs);
  load_tile(sK, p.k + hd.off, 0, N, hd.rs);
  load_tile(sV, p.v + hd.off, 0, N, hd.rs);
  load_vec(sBias, bias, 0, N, LOG2E, NEG_INF);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KS][4];

  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1, k0 = it * BM;
    if (it + 1 < nk) {  // the next tiles stream in during this one
      const int nb = buf ^ 1, k1 = k0 + BM;
      load_tile(sK + nb * TILE, p.k + hd.off, k1, N, hd.rs);
      load_tile(sV + nb * TILE, p.v + hd.off, k1, N, hd.rs);
      load_vec(sBias + nb * BM, bias, k1, N, LOG2E, NEG_INF);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + buf * TILE;
    const bf16* cV = sV + buf * TILE;
    const float* cB = sBias + buf * BM;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) frag_a(qf[kk], sQ + (warp * 16) * LD + kk * 16, LD, lane);
    }

    float s[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* aq = qf[kk];
#pragma unroll
      for (int j = 0; j < BM / 8; j += 2) {
        uint32_t b[4];
        frag_bt2(b, cK + (j * 8) * LD + kk * 16, LD, lane);
        mma(s[j], aq, b);
        mma(s[j + 1], aq, b + 2);
      }
    }

    // scores in base 2: x = log2(e) * (q.k * scale + bias); keys >= N at -1e30
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float x = (k0 + col < N) ? s[j][e] * sl2 + cB[col] : NEG_INF;
        s[j][e] = x;
        mc[e >> 1] = fmaxf(mc[e >> 1], x);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mc[r]));
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(s[j][e] - m[e >> 1]);
        rsum[e >> 1] += pe;  // l sums p before dropout, as the JAX kernel does
        if (drop) {
          const uint32_t qpos = (uint32_t)(q0 + row0 + 8 * (e >> 1));
          const uint32_t kpos = (uint32_t)(k0 + j * 8 + 2 * t + (e & 1));
          pe = keep_bit((uint32_t)bh, qpos, kpos, (uint32_t)p.Np, seed, p.thresh)
                   ? pe * p.inv_keep : 0.f;
        }
        s[j][e] = pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rsum[r]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        frag_b2(b, cV + (kk * 16) * LD + j * 8, LD, lane);
        mma(acc[j], a, b);
        mma(acc[j + 1], a, b + 2);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's loads
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= N) continue;
    bf16* orow = p.out + hd.off + (int64_t)qi * hd.rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] / l[r], acc[j][2 * r + 1] / l[r]);
    if (t == 0) p.lse[(int64_t)bh * N + qi] = (m[r] + log2f(l[r])) / LOG2E;
  }
}

// ---------------------------------------------------------------------------
// backward dq: grid (ceil(N/64), B*H); dq for 64 queries, recomputing p
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_dq_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + TILE;
  bf16* sK = sDO + TILE;       // two buffers
  bf16* sV = sK + 2 * TILE;    // two buffers
  float* sBias = reinterpret_cast<float*>(sV + 2 * TILE);  // two buffers

  const int bh = blockIdx.y, q0 = blockIdx.x * BM, N = p.N;
  const Head hd(p, bh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;
  const float* bias = p.bias != nullptr ? p.bias + (int64_t)bh * N : nullptr;
  const float sl2 = p.scale * LOG2E;
  const int nk = (N + BM - 1) / BM;

  load_tile(sQ, p.q + hd.off, q0, N, hd.rs);
  load_tile(sDO, p.dout + hd.off, q0, N, hd.rs);
  load_tile(sK, p.k + hd.off, 0, N, hd.rs);
  load_tile(sV, p.v + hd.off, 0, N, hd.rs);
  load_vec(sBias, bias, 0, N, LOG2E, NEG_INF);
  cp_async_commit();
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    lse2[r] = qi < N ? p.lse_in[(int64_t)bh * N + qi] * LOG2E : 0.f;
    del[r] = qi < N ? p.delta[(int64_t)bh * N + qi] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[KS][4], dof[KS][4];

  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1, k0 = it * BM;
    if (it + 1 < nk) {
      const int nb = buf ^ 1, k1 = k0 + BM;
      load_tile(sK + nb * TILE, p.k + hd.off, k1, N, hd.rs);
      load_tile(sV + nb * TILE, p.v + hd.off, k1, N, hd.rs);
      load_vec(sBias + nb * BM, bias, k1, N, LOG2E, NEG_INF);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cK = sK + buf * TILE;
    const bf16* cV = sV + buf * TILE;
    const float* cB = sBias + buf * BM;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        frag_a(qf[kk], sQ + (warp * 16) * LD + kk * 16, LD, lane);
        frag_a(dof[kk], sDO + (warp * 16) * LD + kk * 16, LD, lane);
      }
    }

    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* aq = qf[kk];
      const uint32_t* ado = dof[kk];
#pragma unroll
      for (int j = 0; j < BM / 8; j += 2) {
        uint32_t b[4];
        frag_bt2(b, cK + (j * 8) * LD + kk * 16, LD, lane);
        mma(s[j], aq, b);
        mma(s[j + 1], aq, b + 2);
        frag_bt2(b, cV + (j * 8) * LD + kk * 16, LD, lane);
        mma(dp[j], ado, b);
        mma(dp[j + 1], ado, b + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * t + (e & 1);
        const float x = (k0 + col < N) ? s[j][e] * sl2 + cB[col] : NEG_INF;
        const float pe = exp2f(x - lse2[r]);
        float d = dp[j][e];
        if (drop) {
          const uint32_t qpos = (uint32_t)(q0 + row0 + 8 * r);
          d = keep_bit((uint32_t)bh, qpos, (uint32_t)(k0 + col), (uint32_t)p.Np, seed, p.thresh)
                  ? d * p.inv_keep : 0.f;
        }
        s[j][e] = pe * (d - del[r]);  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        frag_b2(b, cK + (kk * 16) * LD + j * 8, LD, lane);
        mma(acc[j], a, b);
        mma(acc[j + 1], a, b + 2);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= N) continue;
    bf16* row = p.dq + hd.off + (int64_t)qi * hd.rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * p.scale, acc[j][2 * r + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (ceil(N/64), B*H); dk, dv for 64 keys. Each warp holds
// S^T for its 16 keys (S^T = K Q^T), so dV = P^T dO and dK = dS^T Q take the
// transposed probabilities straight from its accumulators.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_dkv_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + TILE;
  bf16* sQ = sV + TILE;        // two buffers
  bf16* sDO = sQ + 2 * TILE;   // two buffers
  float* sLse = reinterpret_cast<float*>(sDO + 2 * TILE);  // two buffers
  float* sDel = sLse + 2 * BM;                              // two buffers

  const int bh = blockIdx.y, k0 = blockIdx.x * BM, N = p.N;
  const Head hd(p, bh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);  // key row (tile-local) of elements 0,1
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)p.seed[0] : 0u;
  const float* lse_row = p.lse_in + (int64_t)bh * N;
  const float* del_row = p.delta + (int64_t)bh * N;
  const float sl2 = p.scale * LOG2E;
  const int nq = (N + BM - 1) / BM;

  load_tile(sK, p.k + hd.off, k0, N, hd.rs);
  load_tile(sV, p.v + hd.off, k0, N, hd.rs);
  load_tile(sQ, p.q + hd.off, 0, N, hd.rs);
  load_tile(sDO, p.dout + hd.off, 0, N, hd.rs);
  load_vec(sLse, lse_row, 0, N, LOG2E, 0.f);
  load_vec(sDel, del_row, 0, N, 1.f, 0.f);
  cp_async_commit();
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    // keys >= N at -1e30 (base 2)
    kbias[r] = key >= N ? NEG_INF
                        : (p.bias != nullptr ? p.bias[(int64_t)bh * N + key] * LOG2E : 0.f);
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  uint32_t kf[KS][4], vf[KS][4];

  for (int it = 0; it < nq; ++it) {
    const int buf = it & 1, q0 = it * BM;
    if (it + 1 < nq) {
      const int nb = buf ^ 1, q1 = q0 + BM;
      load_tile(sQ + nb * TILE, p.q + hd.off, q1, N, hd.rs);
      load_tile(sDO + nb * TILE, p.dout + hd.off, q1, N, hd.rs);
      load_vec(sLse + nb * BM, lse_row, q1, N, LOG2E, 0.f);
      load_vec(sDel + nb * BM, del_row, q1, N, 1.f, 0.f);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cQ = sQ + buf * TILE;
    const bf16* cDO = sDO + buf * TILE;
    const float* cL = sLse + buf * BM;
    const float* cD = sDel + buf * BM;
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        frag_a(kf[kk], sK + (warp * 16) * LD + kk * 16, LD, lane);
        frag_a(vf[kk], sV + (warp * 16) * LD + kk * 16, LD, lane);
      }
    }

    float st[BM / 8][4], dpt[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* ak = kf[kk];
      const uint32_t* av = vf[kk];
#pragma unroll
      for (int j = 0; j < BM / 8; j += 2) {
        uint32_t b[4];
        frag_bt2(b, cQ + (j * 8) * LD + kk * 16, LD, lane);
        mma(st[j], ak, b);
        mma(st[j + 1], ak, b + 2);
        frag_bt2(b, cDO + (j * 8) * LD + kk * 16, LD, lane);
        mma(dpt[j], av, b);
        mma(dpt[j + 1], av, b + 2);
      }
    }
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * 8 + 2 * t + (e & 1), qi = q0 + col;
        const float pe = qi < N ? exp2f(st[j][e] * sl2 + kbias[r] - cL[col]) : 0.f;
        float pv = pe, d = dpt[j][e];
        if (drop) {
          const uint32_t kpos = (uint32_t)(k0 + row0 + 8 * r);
          const bool keep = keep_bit((uint32_t)bh, (uint32_t)qi, kpos, (uint32_t)p.Np, seed,
                                     p.thresh);
          pv = keep ? pe * p.inv_keep : 0.f;
          d = keep ? d * p.inv_keep : 0.f;
        }
        st[j][e] = pv;                    // P^T (dropped)
        dpt[j][e] = pe * (d - cD[col]);   // dS^T
      }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t b[4];
        frag_b2(b, cDO + (kk * 16) * LD + j * 8, LD, lane);
        mma(dv[j], ap, b);
        mma(dv[j + 1], ap, b + 2);
        frag_b2(b, cQ + (kk * 16) * LD + j * 8, LD, lane);
        mma(dk[j], ads, b);
        mma(dk[j + 1], ads, b + 2);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + 8 * r;
    if (key >= N) continue;
    bf16* krow = p.dk + hd.off + (int64_t)key * hd.rs;
    bf16* vrow = p.dv + hd.off + (int64_t)key * hd.rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, size_t smem, const Params& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((p.N + BM - 1) / BM, B * p.H), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* bias,
                   const void* seed, int N, int H, int Np, float scale, uint32_t thresh,
                   float inv_keep) {
  Params p = {};
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.bias = (const float*)bias;
  p.seed = (const int*)seed;
  p.N = N;
  p.H = H;
  p.Np = Np;
  p.scale = scale;
  p.thresh = thresh;
  p.inv_keep = inv_keep;
  return p;
}

}  // namespace

extern "C" {

// The head dim the kernels are built for.
int srt_flash_head_dim() { return D; }

// out [B,N,H,D] bf16, lse [B*H,N] f32. bias / seed may be null.
int srt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, const void* seed,
                  void* out, void* lse, int B, int N, int H, int d, int Np, float scale,
                  unsigned int thresh, float inv_keep, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || d != D) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, bias, seed, N, H, Np, scale, thresh, inv_keep);
  p.out = (bf16*)out;
  p.lse = (float*)lse;
  return (int)launch(flash_fwd_kernel, SMEM_FWD, p, B, (cudaStream_t)stream);
}

// dq, dk, dv [B,N,H,D] bf16 from dout [B,N,H,D], lse and delta [B*H,N] f32.
int srt_flash_bwd(const void* q, const void* k, const void* v, const void* bias, const void* seed,
                  const void* dout, const void* lse, const void* delta, void* dq, void* dk,
                  void* dv, int B, int N, int H, int d, int Np, float scale, unsigned int thresh,
                  float inv_keep, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || d != D) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, bias, seed, N, H, Np, scale, thresh, inv_keep);
  p.dout = (const bf16*)dout;
  p.lse_in = (const float*)lse;
  p.delta = (const float*)delta;
  p.dq = (bf16*)dq;
  p.dk = (bf16*)dk;
  p.dv = (bf16*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch(flash_dq_kernel, SMEM_DQ, p, B, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch(flash_dkv_kernel, SMEM_DKV, p, B, s);
}

}  // extern "C"
