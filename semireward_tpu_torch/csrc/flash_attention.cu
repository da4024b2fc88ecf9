// Flash attention for Hopper (sm_90a), K2: forward, dq and dk/dv kernels on
// wgmma with TMA loads, an in-kernel key-padding bias and counter-hash
// dropout on the probabilities.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   semireward_tpu/ops/attention.py:_fwd_kernel     (:110, launched by _fwd_call)
//   semireward_tpu/ops/attention.py:_bwd_dq_kernel  (:173, launched by _flash_bwd)
//   semireward_tpu/ops/attention.py:_bwd_dkv_kernel (:227, launched by _flash_bwd)
//
// Layouts: q, k, v, out, dout, dq, dk, dv are [B, N, H, D] bf16 (the layout
// the projections produce, so nothing is transposed); the key bias is
// [B*H, N] f32; lse and delta are [B*H, N] f32; the dropout seed is four int32
// on the device, (seed, bh_offset, local_heads, head_stride) as the JAX
// package's seed_arg, read through its pointer (no host round trip per layer);
// the keep bits are [B*H, N, Np/32] uint32 (ops/attention.py:pack_keep_bits):
// bit k%32 of word k/32 of query row q, 0 for keys >= N.
//
// Arithmetic follows the JAX kernels: scores in f32 (s = q.k * scale + bias,
// keys >= N at -1e30), online softmax with the row max m and sum l (l sums p
// before dropout), lse = m + log(l); the backward recomputes p = exp(s -
// lse), dp = dO.V^T, dropout on p (for PV / dV) and on dp, ds = p * (dp -
// delta) with delta = rowsum(dO * O). Every tensor-core product takes bf16
// operands with f32 accumulation, so P, dS and P^T are rounded to bf16 before
// their products; the JAX kernels keep them in f32. That is the one
// deliberate difference, held to one bf16 rounding (1% of max|plain|).
//
// Dropout keep bit, identical to attention_keep_mask: with Np = N rounded up
// to 128 (the JAX kernel's padded length, kept as part of the stream although
// nothing is padded here) and bh the global batch*head index of this block's
// own index L, bh = bh_offset + (L / local_heads) * head_stride + L % local_heads
// (a shard of the batch and heads, JAX's flash_attention_sharded; an unsharded
// call passes (0, H, H) and bh = L),
//   ctr  = (bh * Np + q) * Np + k            (uint32, wrapping)
//   keep = lowbias32(lowbias32(ctr) ^ seed) < thresh
// The forward hashes it; under autograd it also writes the bits it kept, and
// the two backward kernels read them instead of hashing again.
//
// Bound at the BERT-base train shape (BH = 144, N = 512, D = 64), H100 SXM.
// One N x N x D product is 2*BH*N^2*D = 4.83 GFLOP. The forward needs 2 (9.7
// GFLOP -> 9.8 us at 989 TFLOP/s bf16 dense) against ~38 MB of q, k, v, out
// -> 11.3 us at 3.35 TB/s: bound by bytes. The backward needs 5 (S again, dP,
// dQ, dK, dV: 24.2 GFLOP -> 24.4 us): bound by operations; this design
// computes 7 (dq and dk/dv each recompute S and dP: 33.8 GFLOP). The dropout
// hash adds an integer floor the bound does not count: ~19 integer
// instructions a score, 37.7 M scores -> ~0.72 G instructions, ~48 us at 64
// int32 lanes per SM per clock on 132 SMs at ~1.75 GHz. Only the forward
// pays it; under autograd it writes 4.7 MB of keep bits, which the backward
// reads twice instead: bytes of this design, not of the function, so the
// bound leaves them out as it leaves out the hash.
//
// Design (the pieces of csrc/hopper_gemm.cuh: tensor maps from the dlopen'd
// cuTensorMapEncodeTiled, bind_context, the mbarrier ring, wgmma with the
// transpose bits, setmaxnreg):
// * Warp-specialised CTAs over a grid (ceil(N / 128), B*H). Two consumer
//   warpgroups own 64 rows each: 128 queries a CTA in the forward and dq,
//   128 keys in dk/dv. One producer thread issues the TMA loads; the
//   producer warpgroups' other warps are helpers that stage each step's side
//   data in shared memory (the keys' bias and the keep words; in dk/dv lse,
//   delta and the keep words), loading four steps' worth before storing
//   any. The forward has two producer warpgroups (512 threads: 7 helper
//   warps at 56 registers hash the dropout mask, the consumers get 200);
//   the backward kernels one (384 threads: 3 helper warps copy, 224 for the
//   consumers). A consumer whose 64 rows all lie past N exits at once (the
//   ragged last tile of N 257 holds one row), and the ring's empty barriers
//   count only the consumers that run.
// * TMA through 4-D tensor maps over [B, N, H, D] in boxes of 64 rows x 64
//   (one 128-byte swizzled row per head row), so rows >= N of one head come
//   back as zeros, never as the next batch's rows. The owned rows (Q; Q, dO
//   and O in dq; K and V in dk/dv) load once; the streamed tiles (K and V in
//   the forward and dq, Q and dO in dk/dv) go through a ring of stages
//   guarded by full / side / empty mbarriers.
// * Products on wgmma.mma_async: S = Q K^T and dP = dO V^T (dk/dv: S^T = K
//   Q^T, dP^T = V dO^T) from shared memory, both operands K-major; P V, dS K,
//   P^T dO and dS^T Q with the f32 accumulator converted in registers to
//   bf16 as the register A operand (the m64nNk16 accumulator layout of two
//   n8 column blocks is the A fragment of one k16 step), and the streamed
//   tile as an MN-major B operand through the transpose bit: no
//   shared-memory round trip, no copy. A consumer issues step j's output
//   products together with step j + 1's score products: one wait a step.
// * The two consumers run free. Turns enforced by a named-barrier pair (as
//   in K1's ping-pong GEMMs) measured no faster in the forward and 16-33%
//   slower in the backward on the H100 (PERF.md), so there are none.
// * Online softmax in base 2 in registers (log2(e) folded into the scale and
//   the bias): a row's scores live in the 4 lanes of a quad, so its max and
//   sum take two shuffles. The staged bias is -1e30 past N, so masking a
//   ragged tail costs the consumers nothing.
// * The dropout mask as keep words, 32 keys a word: the forward's helpers
//   hash it (off the consumers' path) and, under autograd, write the words
//   out; the backward's helpers copy them in. A consumer tests one bit a
//   score.
// * Backward: dq and dk/dv are separate kernels, each output with one
//   writer: no atomics, the same bits every launch. dq computes delta =
//   rowsum(dO * O) for its rows from the tiles it loads and writes it for
//   dk/dv, which the stream runs after it.
// * Every host function launches on the caller's stream, allocates nothing,
//   and returns 0, a CUDA error code, or kBadArgs / kBadMap (negative). The
//   tensor maps are encoded a call: measured, an encode is a small part of
//   the entry point's host time, and keeping maps saved nothing.
#include "hopper_gemm.cuh"

namespace {

constexpr int HD = 64;                 // head dim
constexpr int ROWS = 64;               // rows a consumer warpgroup owns
constexpr int TILE = ROWS * HD * 2;    // one [64 x 64] bf16 box, 8 KB (BOX_BYTES)
constexpr float NEG_INF = -1e30f;
constexpr float POS_INF = 1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TILE == BOX_BYTES, "one TMA box is one tile of 64 rows");

struct FlashArgs {
  CUtensorMap mq, mk, mv, mo, mdo;  // [B, N, H, D] bf16 in 64-row boxes
  const float* bias;   // [B*H, N] key bias, or nullptr
  const int* seed;     // four int32 on the device, or nullptr (no dropout)
  const float* lse_in; // backward
  float* delta;        // backward: written by dq, read by dk/dv
  uint32_t* bits;      // forward: written when not null; backward: read under dropout
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

// One 64-row box of head bh (rows row0..row0+63 of its [N, D] view).
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int bh, int H) {
  const int b = bh / H, h = bh - b * H;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(h), "r"(row0), "r"(b)
      : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// d[32] += A[64 x 16] * B[16 x 64] with A in registers (the m64nNk16 A
// fragment: a[0] rows g, cols 2t..; a[1] rows g + 8; a[2], a[3] cols + 8)
// and B an MN-major tile in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc = X[64 x 64] * Y^T over D: both operands K-major tiles in shared
// memory (Y has NC rows).
template <int NC>
__device__ __forceinline__ void product_kmajor(float (&acc)[NC / 2], uint32_t x, uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma<NC, 0, 0>(acc, step_desc(x, kk, false), step_desc(y, kk, false), kk > 0);
}

// The register A operands of P[64 x KC] from its f32 accumulator: k-step kk
// takes n8 column blocks 2kk and 2kk + 1. Packed before the products are
// issued, so that no register an issued wgmma reads is written between them.
template <int KC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KC / 16][4], const float (&p)[KC / 2]) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    a[kk][0] = pack_bf16(p[8 * kk], p[8 * kk + 1]);
    a[kk][1] = pack_bf16(p[8 * kk + 2], p[8 * kk + 3]);
    a[kk][2] = pack_bf16(p[8 * kk + 4], p[8 * kk + 5]);
    a[kk][3] = pack_bf16(p[8 * kk + 6], p[8 * kk + 7]);
  }
}

// acc += P[64 x KC] * Y[KC x 64]: P the packed register operand, Y the
// streamed tile in shared memory taken MN-major.
template <int KC>
__device__ __forceinline__ void product_regs(float (&acc)[32], const uint32_t (&a)[KC / 16][4],
                                             uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) wgmma_rs_n64(acc, a[kk], step_desc(y, kk, true));
}

// Thread counts: warp 0 of the first producer warpgroup issues the TMA
// loads, the producer warpgroups' other warps are helpers that stage each
// step's side data, and the last two warpgroups are the consumers. The
// forward hashes the dropout mask in its helpers, so it takes two producer
// warpgroups (7 helper warps; at 56 registers a thread, as fast as at 72 or
// 88 on the H100); the backward kernels only copy side data and take one
// (3 helper warps).
constexpr int FWD_NT = 512, FWD_HELPERS = 224, FWD_HELPER_REGS = 56, FWD_CONSUMER_REGS = 200;
constexpr int BWD_NT = 384, BWD_HELPERS = 96, BWD_HELPER_REGS = 56, BWD_CONSUMER_REGS = 224;
static_assert(2 * 128 * FWD_HELPER_REGS + 2 * 128 * FWD_CONSUMER_REGS <= 65536, "fwd registers");
static_assert(128 * BWD_HELPER_REGS + 2 * 128 * BWD_CONSUMER_REGS <= 65536, "bwd registers");

// Shared memory of a kernel: the owned tiles (OWN boxes per consumer), a ring
// of STAGES stages of two streamed [KT x 64] tiles and, per stage, SIDE bytes
// of side data (bias, keep words, lse and delta of the step), then the
// barriers: the owned boxes', and per stage full (TMA), side (helpers) and
// empty (consumers).
template <int OWN, int KT, int STAGES, int SIDE>
struct Smem {
  static constexpr int OWNED = 2 * OWN * TILE;
  static constexpr int STAGE = 2 * KT * HD * 2;
  static constexpr int BARS = 8 * (1 + 3 * STAGES);
  static constexpr int BYTES = 1024 + OWNED + STAGES * (STAGE + SIDE) + BARS;
  static_assert(BYTES <= MAX_SMEM, "shared memory past 227 KB");
};

struct Layout {
  uint32_t owned, ring, own_bar, full, side_full, empty;
  uint8_t* side;  // generic pointer to stage 0's side data
};

template <int OWN, int KT, int STAGES, int SIDE>
__device__ __forceinline__ Layout layout(uint8_t* smem_raw) {
  typedef Smem<OWN, KT, STAGES, SIDE> S;
  const uint32_t raw = smem_u32(smem_raw);
  Layout l;
  l.owned = (raw + 1023) & ~1023u;  // 128-byte swizzle: 1024-byte aligned
  l.ring = l.owned + S::OWNED;
  const uint32_t side = l.ring + STAGES * S::STAGE;
  l.side = smem_raw + (side - raw);
  l.own_bar = side + STAGES * SIDE;
  l.full = l.own_bar + 8;
  l.side_full = l.full + 8 * STAGES;
  l.empty = l.side_full + 8 * STAGES;
  return l;
}

// The producer thread: the NOWN owned boxes (maps o0, o1, o2) of each
// running consumer on own_bar, then the streamed tiles (maps s0, s1, KT rows
// each) of every step through the ring.
template <int KT, int STAGES, int NOWN>
__device__ __forceinline__ void produce(const Layout& l, const CUtensorMap* o0,
                                        const CUtensorMap* o1, const CUtensorMap* o2, int row0,
                                        int active, const CUtensorMap* s0, const CUtensorMap* s1,
                                        int steps, int bh, int H) {
  mbar_expect_tx(l.own_bar, active * NOWN * TILE);
  for (int c = 0; c < active; ++c)
#pragma unroll
    for (int i = 0; i < NOWN; ++i)
      tma_rows(l.owned + (c * NOWN + i) * TILE, i == 0 ? o0 : (i == 1 ? o1 : o2), l.own_bar,
               row0 + ROWS * c, bh, H);
  constexpr int HALF = KT * HD * 2;
  for (int j = 0; j < steps; ++j) {
    const int stage = j % STAGES;
    mbar_wait(l.empty + 8 * stage, ((j / STAGES) & 1) ^ 1);  // the first pass finds it free
    const uint32_t fb = l.full + 8 * stage, s = l.ring + stage * 2 * HALF;
    mbar_expect_tx(fb, 2 * HALF);
#pragma unroll
    for (int i = 0; i < KT / ROWS; ++i) {
      tma_rows(s + i * TILE, s0, fb, j * KT + ROWS * i, bh, H);
      tma_rows(s + HALF + i * TILE, s1, fb, j * KT + ROWS * i, bh, H);
    }
  }
}

template <int STAGES, int HELPERS>
__device__ __forceinline__ void init_barriers(const Layout& l, int active) {
  if (threadIdx.x == 0) {
    mbar_init(l.own_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(l.full + 8 * s, 1);               // the producer's expect_tx
      mbar_init(l.side_full + 8 * s, HELPERS);    // every helper thread
      mbar_init(l.empty + 8 * s, active);         // every running consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The role split: setmaxnreg must dominate each role's code for ptxas to
// allocate it at the role's count, so each kernel calls these at the head of
// its producer and consumer branches.
template <int REGS>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS) : "memory");
}
template <int REGS>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS) : "memory");
}

// Per-thread geometry of a consumer: warp, quad lane, accumulator row.
struct Lane {
  int t, warp, lane, tq, r0;  // r0: tile row of d[4n + 0, 1]; d[4n + 2, 3] are r0 + 8
  __device__ Lane() {
    t = threadIdx.x & 127;
    warp = t >> 5;
    lane = t & 31;
    tq = lane & 3;
    r0 = warp * 16 + (lane >> 2);
  }
};

// Side data of a step over KT keys (forward, dq): the keys' bias times
// log2(e) (-1e30 past N, so masking a ragged tail costs the consumers
// nothing), then the keep words of the CTA's 128 query rows, [128][KT / 32].
template <int KT>
struct KeySide {
  static constexpr int WPR = KT / 32;  // keep words a row
  static constexpr int BYTES = KT * 4 + 128 * WPR * 4;
};

// The side data's bias of key k: times log2(e), -1e30 past N.
__device__ __forceinline__ float bias_of(const FlashArgs& a, int bh, int k) {
  return k < a.N ? (a.bias != nullptr ? a.bias[(int64_t)bh * a.N + k] * LOG2E : 0.f) : NEG_INF;
}

// Helpers load the global side data of SIDE_BATCH steps before they store
// any, so that the loads' latencies overlap.
constexpr int SIDE_BATCH = 4;

// A consumer's keep words of rows `row` and row + 8 for the step, shifted to
// its quad lane: bit 8(n % 4) + e % 2 of word [e / 2][n / 4] keeps the score
// in d[4n + e].
template <int KT>
__device__ __forceinline__ void keep_words(uint32_t (&kw)[2][KT / 32], const uint32_t* sw, int row,
                                           int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < KT / 32; ++i) kw[r][i] = sw[(row + 8 * r) * (KT / 32) + i] >> (2 * tq);
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(N/128), B*H); O and lse for 128 queries, 128 keys a step
// (measured faster than 64 keys at N 199 and 512, as fast at 257)
// ---------------------------------------------------------------------------
constexpr int FWD_KT = 128;
constexpr int FWD_STAGES = 512 / FWD_KT;  // every key of N <= 512 in flight
typedef Smem<1, FWD_KT, FWD_STAGES, KeySide<FWD_KT>::BYTES> FwdSmem;  // own Q

// The helpers of the forward: per step the bias and the keep words, hashed
// here, 32 keys a word (0 past N); with a.bits also written out for the
// backward. A row's Np / 32 words are exactly the steps' words.
__device__ __forceinline__ void fwd_side(const FlashArgs& a, const Layout& l, int bh, int q0,
                                         int steps, int active, int h) {
  constexpr int KT = FWD_KT, STAGES = FWD_STAGES, WPR = KeySide<KT>::WPR;
  constexpr int HELPERS = FWD_HELPERS, U = SIDE_BATCH;
  static_assert(KT <= HELPERS, "one bias value a helper a step");
  const int N = a.N, W = a.Np / 32, words = ROWS * active * WPR;
  const bool drop = a.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)a.seed[0] : 0u, Np = (uint32_t)a.Np;
  // the counter's global batch*head index (wrapping, as JAX's int32 -> uint32)
  const uint32_t gbh = drop ? (uint32_t)a.seed[1] + (uint32_t)(bh / a.seed[2]) * (uint32_t)a.seed[3] +
                                  (uint32_t)(bh % a.seed[2])
                            : 0u;
  for (int j0 = 0; j0 < steps; j0 += U) {
    float bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      bv[u] = h < KT && j0 + u < steps ? bias_of(a, bh, (j0 + u) * KT + h) : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u, stage = j % STAGES, k0 = j * KT;
      if (j >= steps) break;
      mbar_wait(l.empty + 8 * stage, ((j / STAGES) & 1) ^ 1);
      float* sb = reinterpret_cast<float*>(l.side + stage * KeySide<KT>::BYTES);
      uint32_t* sw = reinterpret_cast<uint32_t*>(sb + KT);
      if (h < KT) sb[h] = bv[u];
      // word j * words + w goes to helper (j * words + w) % HELPERS: the
      // words of all steps dealt out in turn, so no helper takes more than
      // one word beyond any other
      if (drop)
        for (int w = (h + HELPERS - (j * words) % HELPERS) % HELPERS; w < words; w += HELPERS) {
          const int row = w / WPR, kb = k0 + 32 * (w % WPR), q = q0 + row;
          const uint32_t ctr = (gbh * Np + (uint32_t)q) * Np + (uint32_t)kb;
          uint32_t word = 0u;
#pragma unroll
          for (int b = 0; b < 32; ++b)
            word |= (uint32_t)(lowbias32(lowbias32(ctr + b) ^ seed) < a.thresh) << b;
          if (kb + 32 > N) word &= kb >= N ? 0u : (1u << (N - kb)) - 1u;  // keys >= N
          sw[w] = word;
          if (a.bits != nullptr && q < N) a.bits[((int64_t)bh * N + q) * W + kb / 32] = word;
        }
      mbar_arrive(l.side_full + 8 * stage);
    }
  }
}

__global__ void __launch_bounds__(FWD_NT, 1) k2_fwd_kernel(const __grid_constant__ FlashArgs a) {
  constexpr int KT = FWD_KT, STAGES = FWD_STAGES, WPR = KeySide<KT>::WPR;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Layout l = layout<1, KT, STAGES, KeySide<KT>::BYTES>(smem_raw);
  const int bh = blockIdx.y, q0 = blockIdx.x * 128, N = a.N;
  const int steps = cdiv(N, KT);
  const int active = min(2, cdiv(N - q0, ROWS));
  init_barriers<STAGES, FWD_HELPERS>(l, active);
  if (threadIdx.x < FWD_NT - 256) {
    producer_regs<FWD_HELPER_REGS>();
    if (threadIdx.x == 0)
      produce<KT, STAGES, 1>(l, &a.mq, &a.mq, &a.mq, q0, active, &a.mk, &a.mv, steps, bh, a.H);
    else if (threadIdx.x >= 32)
      fwd_side(a, l, bh, q0, steps, active, threadIdx.x - 32);
    return;
  }
  consumer_regs<FWD_CONSUMER_REGS>();
  const int c = (threadIdx.x - (FWD_NT - 256)) / 128;
  if (c >= active) return;

  const Lane L;
  const uint32_t qtile = l.owned + c * TILE;
  const bool drop = a.seed != nullptr;
  const int qrow = q0 + ROWS * c + L.r0;  // query of d[.. 0, 1]; + 8 for d[.. 2, 3]
  const float sl2 = a.scale * LOG2E;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l2[2] = {0.f, 0.f};
  float s[KT / 2];
  mbar_wait(l.own_bar, 0);
  mbar_wait(l.full, 0);
  wgmma_fence();
  product_kmajor<KT>(s, qtile, l.ring);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  // step j: s holds S_j; P_j V_j is issued with S_{j+1}, one wait a step
  for (int j = 0; j < steps; ++j) {
    const int stage = j % STAGES;
    const uint32_t vtile = l.ring + stage * FwdSmem::STAGE + FwdSmem::STAGE / 2;
    const float* bs = reinterpret_cast<const float*>(l.side + stage * KeySide<KT>::BYTES);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(bs + KT);
    mbar_wait(l.side_full + 8 * stage, (j / STAGES) & 1);

    // scores in base 2: x = log2(e) * (q.k * scale + bias); keys >= N at -1e30
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * L.tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[4 * n + e], sl2, (e & 1) ? b.y : b.x);
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const float pe = exp2f(s[i] - m[(i >> 1) & 1]);
      rsum[(i >> 1) & 1] += pe;  // l sums p before dropout, as the JAX kernel does
      s[i] = pe;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l2[r] = l2[r] * alpha[r] + quad_sum(rsum[r]);
    if (drop) {
      uint32_t kw[2][WPR];
      keep_words<KT>(kw, sw, ROWS * c + L.r0, L.tq);
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * n + e] = (kw[e >> 1][n / 4] >> (8 * (n % 4) + (e & 1))) & 1u
                             ? s[4 * n + e] * a.inv_keep : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    uint32_t pa[KT / 16][4];
    pack_a<KT>(pa, s);
    const bool more = j + 1 < steps;
    const int next = (j + 1) % STAGES;
    if (more) mbar_wait(l.full + 8 * next, ((j + 1) / STAGES) & 1);
    wgmma_fence();
    product_regs<KT>(o, pa, vtile);
    if (more) product_kmajor<KT>(s, qtile, l.ring + next * FwdSmem::STAGE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(s);
    if (L.t == 0) mbar_arrive(l.empty + 8 * stage);
  }

  const int b = bh / a.H, h = bh - b * a.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l2[r];
    bf16* orow = a.out + (((int64_t)b * N + row) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * L.tq) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    if (L.tq == 0) a.lse[(int64_t)bh * N + row] = (m[r] + log2f(l2[r])) / LOG2E;
  }
}

// ---------------------------------------------------------------------------
// backward dq: grid (ceil(N/128), B*H); dq and delta for 128 queries
// ---------------------------------------------------------------------------
constexpr int DQ_KT = 64;                // keys a step of dq
constexpr int DQ_STAGES = 512 / DQ_KT;   // every tile of N <= 512 in flight
typedef Smem<3, DQ_KT, DQ_STAGES, KeySide<DQ_KT>::BYTES> DqSmem;  // own Q, dO, O

// The helpers of dq: per step the bias and the forward's keep words.
__device__ __forceinline__ void dq_side(const FlashArgs& a, const Layout& l, int bh, int q0,
                                        int steps, int active, int h) {
  constexpr int KT = DQ_KT, STAGES = DQ_STAGES, WPR = KeySide<KT>::WPR;
  constexpr int HELPERS = BWD_HELPERS, U = SIDE_BATCH;
  static_assert(KT <= 2 * HELPERS && 128 <= 2 * HELPERS, "a helper's share of a step");
  const int N = a.N, W = a.Np / 32, rows = ROWS * active;
  const bool drop = a.seed != nullptr;
  for (int j0 = 0; j0 < steps; j0 += U) {
    float bv[U][2];
    uint32_t kw[U][2][WPR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = h + rr * HELPERS, r = i, q = q0 + r;
        bv[u][rr] = i < KT && j < steps ? bias_of(a, bh, j * KT + i) : 0.f;
        const bool in = drop && j < steps && r < rows && q < N;
        const uint32_t* src = a.bits + ((int64_t)bh * N + q) * W + j * KT / 32;
#pragma unroll
        for (int w = 0; w < WPR; ++w) kw[u][rr][w] = in ? src[w] : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u, stage = j % STAGES;
      if (j >= steps) break;
      mbar_wait(l.empty + 8 * stage, ((j / STAGES) & 1) ^ 1);
      float* sb = reinterpret_cast<float*>(l.side + stage * KeySide<KT>::BYTES);
      uint32_t* sw = reinterpret_cast<uint32_t*>(sb + KT);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = h + rr * HELPERS;
        if (i < KT) sb[i] = bv[u][rr];
        if (drop && i < rows)
#pragma unroll
          for (int w = 0; w < WPR; ++w) sw[i * WPR + w] = kw[u][rr][w];
      }
      mbar_arrive(l.side_full + 8 * stage);
    }
  }
}

__global__ void __launch_bounds__(BWD_NT, 1) k2_bwd_dq_kernel(const __grid_constant__ FlashArgs a) {
  constexpr int KT = DQ_KT, STAGES = DQ_STAGES, WPR = KeySide<KT>::WPR;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Layout l = layout<3, KT, STAGES, KeySide<KT>::BYTES>(smem_raw);
  const int bh = blockIdx.y, q0 = blockIdx.x * 128, N = a.N;
  const int steps = cdiv(N, KT);
  const int active = min(2, cdiv(N - q0, ROWS));
  init_barriers<STAGES, BWD_HELPERS>(l, active);
  if (threadIdx.x < 128) {
    producer_regs<BWD_HELPER_REGS>();
    if (threadIdx.x == 0)
      produce<KT, STAGES, 3>(l, &a.mq, &a.mdo, &a.mo, q0, active, &a.mk, &a.mv, steps, bh, a.H);
    else if (threadIdx.x >= 32)
      dq_side(a, l, bh, q0, steps, active, threadIdx.x - 32);
    return;
  }
  consumer_regs<BWD_CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;
  if (c >= active) return;

  const Lane L;
  const uint32_t qtile = l.owned + 3 * c * TILE, dotile = qtile + TILE, otile = qtile + 2 * TILE;
  const bool drop = a.seed != nullptr;
  const int qrow = q0 + ROWS * c + L.r0;
  const float sl2 = a.scale * LOG2E;
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    lse2[r] = row < N ? a.lse_in[(int64_t)bh * N + row] * LOG2E : 0.f;
  }

  mbar_wait(l.own_bar, 0);
  // delta = rowsum(dO * O) of this thread's two rows: lane tq reads 16-byte
  // chunks 2tq and 2tq + 1 of each (128-byte swizzle: chunk ^ row % 8)
  float del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = L.r0 + 8 * r;
    float acc = 0.f;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int off = tr * 128 + (((2 * L.tq + h2) ^ (tr & 7)) << 4);
      uint4 x, y;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
                   : "r"(dotile + off));
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(y.x), "=r"(y.y), "=r"(y.z), "=r"(y.w)
                   : "r"(otile + off));
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
        const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
        acc = fmaf(fx.x, fy.x, acc);
        acc = fmaf(fx.y, fy.y, acc);
      }
    }
    del[r] = quad_sum(acc);
    const int row = qrow + 8 * r;
    if (L.tq == 0 && row < N) a.delta[(int64_t)bh * N + row] = del[r];
  }

  float dq[32], s[KT / 2], dp[KT / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(l.full, 0);
  wgmma_fence();
  product_kmajor<KT>(s, qtile, l.ring);
  product_kmajor<KT>(dp, dotile, l.ring + DqSmem::STAGE / 2);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);

  // step j: s, dp hold S_j, dP_j; dS_j K_j is issued with S_{j+1}, dP_{j+1}
  for (int j = 0; j < steps; ++j) {
    const int stage = j % STAGES;
    const uint32_t ktile = l.ring + stage * DqSmem::STAGE;
    const float* bs = reinterpret_cast<const float*>(l.side + stage * KeySide<KT>::BYTES);
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(bs + KT);
    mbar_wait(l.side_full + 8 * stage, (j / STAGES) & 1);
    uint32_t kw[2][WPR];
    if (drop) keep_words<KT>(kw, sw, ROWS * c + L.r0, L.tq);
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(bs + 8 * n + 2 * L.tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * n + e;
        const float pe = exp2f(fmaf(s[i], sl2, (e & 1) ? b.y : b.x) - lse2[r]);
        float d = dp[i];
        if (drop) d = (kw[r][n / 4] >> (8 * (n % 4) + (e & 1))) & 1u ? d * a.inv_keep : 0.f;
        s[i] = pe * (d - del[r]);  // ds
      }
    }
    uint32_t pa[KT / 16][4];
    pack_a<KT>(pa, s);
    const bool more = j + 1 < steps;
    const int next = (j + 1) % STAGES;
    if (more) mbar_wait(l.full + 8 * next, ((j + 1) / STAGES) & 1);
    wgmma_fence();
    product_regs<KT>(dq, pa, ktile);
    if (more) {
      const uint32_t nk = l.ring + next * DqSmem::STAGE;
      product_kmajor<KT>(s, qtile, nk);
      product_kmajor<KT>(dp, dotile, nk + DqSmem::STAGE / 2);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(s);
    fence_regs(dp);
    if (L.t == 0) mbar_arrive(l.empty + 8 * stage);
  }

  const int b = bh / a.H, h = bh - b * a.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= N) continue;
    bf16* out = a.dq + (((int64_t)b * N + row) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * L.tq) =
          __floats2bfloat162_rn(dq[4 * n + 2 * r] * a.scale, dq[4 * n + 2 * r + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: grid (ceil(N/128), B*H); dk, dv for 128 keys. Each consumer
// holds S^T for its 64 keys (S^T = K Q^T), so dV = P^T dO and dK = dS^T Q
// take the transposed probabilities straight from its accumulators.
// ---------------------------------------------------------------------------

// Side data of a step over QT queries (dk/dv): lse times log2(e) (+1e30 past
// N, so that p is exactly 0 there), delta, and the keep words of the CTA's
// 128 keys, [4][QT] (word w of query i at [w][i]).
constexpr int DKV_QT = 64;                // queries a step of dk/dv
constexpr int DKV_STAGES = 512 / DKV_QT;  // every tile of N <= 512 in flight
struct QuerySide {
  static constexpr int BYTES = DKV_QT * 4 * 2 + 4 * DKV_QT * 4;
};
typedef Smem<2, DKV_QT, DKV_STAGES, QuerySide::BYTES> DkvSmem;  // own K, V

__device__ __forceinline__ void dkv_side(const FlashArgs& a, const Layout& l, int bh, int k0,
                                         int steps, int h) {
  constexpr int QT = DKV_QT, STAGES = DKV_STAGES, U = SIDE_BATCH;
  static_assert(QT <= BWD_HELPERS, "one query a helper a step");
  const int N = a.N, W = a.Np / 32;
  const bool drop = a.seed != nullptr;
  for (int j0 = 0; j0 < steps; j0 += U) {
    float lv[U], dv[U];
    uint4 kw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = (j0 + u) * QT + h;
      const bool in = j0 + u < steps && h < QT && q < N;
      const int64_t at = (int64_t)bh * N + q;
      lv[u] = in ? a.lse_in[at] * LOG2E : POS_INF;
      dv[u] = in ? a.delta[at] : 0.f;
      kw[u] = in && drop ? *reinterpret_cast<const uint4*>(a.bits + at * W + k0 / 32)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u, stage = j % STAGES;
      if (j >= steps) break;
      mbar_wait(l.empty + 8 * stage, ((j / STAGES) & 1) ^ 1);
      float* ls = reinterpret_cast<float*>(l.side + stage * QuerySide::BYTES);
      float* dl = ls + QT;
      uint32_t* sw = reinterpret_cast<uint32_t*>(dl + QT);
      if (h < QT) {
        ls[h] = lv[u];
        dl[h] = dv[u];
        sw[h] = kw[u].x;
        sw[QT + h] = kw[u].y;
        sw[2 * QT + h] = kw[u].z;
        sw[3 * QT + h] = kw[u].w;
      }
      mbar_arrive(l.side_full + 8 * stage);
    }
  }
}

__global__ void __launch_bounds__(BWD_NT, 1) k2_bwd_dkv_kernel(const __grid_constant__ FlashArgs a) {
  constexpr int QT = DKV_QT, STAGES = DKV_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Layout l = layout<2, QT, STAGES, QuerySide::BYTES>(smem_raw);
  const int bh = blockIdx.y, k0 = blockIdx.x * 128, N = a.N;
  const int steps = cdiv(N, QT);
  const int active = min(2, cdiv(N - k0, ROWS));
  init_barriers<STAGES, BWD_HELPERS>(l, active);
  if (threadIdx.x < 128) {
    producer_regs<BWD_HELPER_REGS>();
    if (threadIdx.x == 0)
      produce<QT, STAGES, 2>(l, &a.mk, &a.mv, &a.mv, k0, active, &a.mq, &a.mdo, steps, bh, a.H);
    else if (threadIdx.x >= 32)
      dkv_side(a, l, bh, k0, steps, threadIdx.x - 32);
    return;
  }
  consumer_regs<BWD_CONSUMER_REGS>();
  const int c = threadIdx.x / 128 - 1;
  if (c >= active) return;

  const Lane L;
  const uint32_t ktile = l.owned + 2 * c * TILE, vtile = ktile + TILE;
  const bool drop = a.seed != nullptr;
  const int krow = k0 + ROWS * c + L.r0;  // key of d[.. 0, 1]; + 8 for d[.. 2, 3]
  const float sl2 = a.scale * LOG2E;
  float kb2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow + 8 * r;  // keys >= N at -1e30 (base 2)
    kb2[r] = key >= N ? NEG_INF : (a.bias != nullptr ? a.bias[(int64_t)bh * N + key] * LOG2E : 0.f);
  }
  // this thread's keys are bits sh and sh + 8 of word 2c + warp / 2
  const int sh = 16 * (L.warp & 1) + (L.lane >> 2), word = 2 * c + (L.warp >> 1);

  float dk[32], dv[32], st[QT / 2], dpt[QT / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(l.own_bar, 0);
  mbar_wait(l.full, 0);
  wgmma_fence();
  product_kmajor<QT>(st, ktile, l.ring);
  product_kmajor<QT>(dpt, vtile, l.ring + DkvSmem::STAGE / 2);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);

  // step j: st, dpt hold S^T_j, dP^T_j; dV_j and dK_j are issued with
  // S^T_{j+1}, dP^T_{j+1}
  for (int j = 0; j < steps; ++j) {
    const int stage = j % STAGES;
    const uint32_t qtile = l.ring + stage * DkvSmem::STAGE, dotile = qtile + DkvSmem::STAGE / 2;
    const float* ls = reinterpret_cast<const float*>(l.side + stage * QuerySide::BYTES);
    const float* dl = ls + QT;
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(dl + QT) + word * QT;
    mbar_wait(l.side_full + 8 * stage, (j / STAGES) & 1);
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      const int col = 8 * n + 2 * L.tq;
      const float2 lq = *reinterpret_cast<const float2*>(ls + col);
      const float2 dq = *reinterpret_cast<const float2*>(dl + col);
      const uint2 wq = *reinterpret_cast<const uint2*>(wrow + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = 4 * n + e;
        const float pe = exp2f(fmaf(st[i], sl2, kb2[r]) - ((e & 1) ? lq.y : lq.x));
        float pv = pe, d = dpt[i];
        if (drop) {
          const bool keep = (((e & 1) ? wq.y : wq.x) >> (sh + 8 * r)) & 1u;
          pv = keep ? pe * a.inv_keep : 0.f;
          d = keep ? d * a.inv_keep : 0.f;
        }
        st[i] = pv;                                   // P^T (dropped)
        dpt[i] = pe * (d - ((e & 1) ? dq.y : dq.x));  // dS^T
      }
    }
    uint32_t pa[QT / 16][4], da[QT / 16][4];
    pack_a<QT>(pa, st);
    pack_a<QT>(da, dpt);
    const bool more = j + 1 < steps;
    const int next = (j + 1) % STAGES;
    if (more) mbar_wait(l.full + 8 * next, ((j + 1) / STAGES) & 1);
    wgmma_fence();
    product_regs<QT>(dv, pa, dotile);
    product_regs<QT>(dk, da, qtile);
    if (more) {
      const uint32_t nq = l.ring + next * DkvSmem::STAGE;
      product_kmajor<QT>(st, ktile, nq);
      product_kmajor<QT>(dpt, vtile, nq + DkvSmem::STAGE / 2);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(st);
    fence_regs(dpt);
    if (L.t == 0) mbar_arrive(l.empty + 8 * stage);
  }

  const int b = bh / a.H, h = bh - b * a.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow + 8 * r;
    if (key >= N) continue;
    const int64_t off = (((int64_t)b * N + key) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(a.dk + off + 8 * n + 2 * L.tq) =
          __floats2bfloat162_rn(dk[4 * n + 2 * r] * a.scale, dk[4 * n + 2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(a.dv + off + 8 * n + 2 * L.tq) =
          __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// TMA map of a [B, N, H, 64] bf16 tensor in boxes of 64 rows of one head,
// 128-byte swizzle; rows past N read as zeros.
bool make_head_map(CUtensorMap* m, const void* ptr, int B, int N, int H) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)H * HD * 2,
                                 (cuuint64_t)N * H * HD * 2};
  const cuuint32_t box[4] = {HD, 1, ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared-memory limit is set once per kernel (slot) and device: a host
// call per launch costs the host-bound steps that run these kernels.
template <int SLOT>
cudaError_t launch(void (*kernel)(FlashArgs), int threads, int smem, int B, const FlashArgs& a,
                   cudaStream_t stream) {
  static uint64_t ready = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) ready |= uint64_t(1) << dev;
  }
  kernel<<<dim3(cdiv(a.N, 128), B * a.H), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool fill_args(FlashArgs* a, const void* q, const void* k, const void* v, const void* bias,
               const void* seed, int B, int N, int H, int Np, float scale, uint32_t thresh,
               float inv_keep) {
  a->bias = (const float*)bias;
  a->seed = (const int*)seed;
  a->N = N;
  a->H = H;
  a->Np = Np;
  a->scale = scale;
  a->thresh = thresh;
  a->inv_keep = inv_keep;
  return make_head_map(&a->mq, q, B, N, H) && make_head_map(&a->mk, k, B, N, H) &&
         make_head_map(&a->mv, v, B, N, H);
}

bool bad_shape(int B, int N, int H, int d, int Np) {
  return B <= 0 || N <= 0 || H <= 0 || d != HD || Np < N || Np % 128 != 0;
}

}  // namespace

extern "C" {

// The head dim the kernels are built for.
int srt_flash_head_dim() { return HD; }

// out [B,N,H,D] bf16, lse [B*H,N] f32. bias / seed may be null; a seed is four
// int32 (seed, bh_offset, local_heads > 0, head_stride); with one, bits
// [B*H, N, Np/32] receives the keep bits when not null.
int srt_flash_fwd(const void* q, const void* k, const void* v, const void* bias, const void* seed,
                  void* out, void* lse, void* bits, int B, int N, int H, int d, int Np,
                  float scale, unsigned int thresh, float inv_keep, void* stream) {
  if (bad_shape(B, N, H, d, Np)) return kBadArgs;
  if (!bind_context()) return (int)cudaGetLastError();
  FlashArgs a = {};
  if (!fill_args(&a, q, k, v, bias, seed, B, N, H, Np, scale, thresh, inv_keep)) return kBadMap;
  a.out = (bf16*)out;
  a.lse = (float*)lse;
  a.bits = seed != nullptr ? (uint32_t*)bits : nullptr;
  return (int)launch<0>(k2_fwd_kernel, FWD_NT, FwdSmem::BYTES, B, a, (cudaStream_t)stream);
}

// dq, dk, dv [B,N,H,D] bf16 from dout, out [B,N,H,D] and lse [B*H,N] f32;
// delta [B*H,N] f32 is scratch (dq writes it, dk/dv reads it). With a seed,
// bits [B*H, N, Np/32] (the forward's) are required.
int srt_flash_bwd(const void* q, const void* k, const void* v, const void* bias, const void* seed,
                  const void* dout, const void* lse, const void* out, const void* bits,
                  void* delta, void* dq, void* dk, void* dv, int B, int N, int H, int d, int Np,
                  float scale, unsigned int thresh, float inv_keep, void* stream) {
  if (bad_shape(B, N, H, d, Np) || (seed != nullptr && bits == nullptr)) return kBadArgs;
  if (!bind_context()) return (int)cudaGetLastError();
  FlashArgs a = {};
  if (!fill_args(&a, q, k, v, bias, seed, B, N, H, Np, scale, thresh, inv_keep) ||
      !make_head_map(&a.mo, out, B, N, H) || !make_head_map(&a.mdo, dout, B, N, H))
    return kBadMap;
  a.lse_in = (const float*)lse;
  a.bits = (uint32_t*)bits;
  a.delta = (float*)delta;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch<1>(k2_bwd_dq_kernel, BWD_NT, DqSmem::BYTES, B, a, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch<2>(k2_bwd_dkv_kernel, BWD_NT, DkvSmem::BYTES, B, a, s);
}

}  // extern "C"
