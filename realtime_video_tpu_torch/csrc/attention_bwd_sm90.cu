// Backward of the decode-window and block-causal attention for Hopper (sm_90a)
// with wgmma, TMA and warp-specialised pipelines: dq, dk, dv of the function
// that csrc/attention_sm90.cu computes forward.
//
// It replaces no TPU kernel. The JAX package cannot differentiate its Pallas
// attention (realtime_video_tpu/ops/pallas_attention.py: no custom_vjp), so
// its trainer runs the dense XLA attention (ops/attention.py::xla_attention)
// and differentiates that, keeping [N, Lq, Lk] probabilities alive. This
// kernel computes the same gradient with memory linear in L, as
// FlashAttention-2's backward does: P is recomputed from the row log-sum-exp
// that the forward kernel leaves (lse, natural log, f32 [B, N, Lq]).
//
// The function differentiated is the one the forward computes: it scores
// Qc K^T in log2 units, Qc = bf16(Q * c) with c = bf16(scale * log2 e)
// (rounded as `prescale` rounds it), so its softmax scale is c / log2 e, not
// `scale` (0.32% apart at head dim 128, which moves P by exp(-0.0032 S) on a
// peaked row). The pre-pass writes Qc by the forward's rounding, so the
// recomputed S is bit-equal to the forward's and P sums to 1 against its lse:
//
//   S = Qc K^T (log2 units),  P = 2^(S - lse * log2 e),  dP = dO V^T,
//   D = rowsum(dO * O), dS = P * (dP - D),
//   dV = P^T dO,  dK = ln 2 * dS^T Qc,  dQ = c ln 2 * dS K.
//
// Masks as the forward's: the window [lo, hi) over the keys (unmasked is lo
// = 0, hi = Lk), or block-causal: key < min(ends[q], kv_len), ends[q] = (q /
// block_tokens + 1) * block_tokens, optionally key >= ends[q] - local_window,
// and the diagonal. A masked (query, key) pair has P = 0; a row with no live
// key (never on the training path) gets zero gradients, and so does a key
// that no query sees.
//
// Three launches on the caller's stream, no atomics, deterministic:
//   1. attn_bwd_prepass: Qc = bf16(q * c), and per (batch, head) two f32 rows
//      of the scratch `stats` [B, N, 2, Lqp]: lse * log2 e and D =
//      rowsum(dO * O). Lqp = Lq rounded up to 4, so each row starts 16 bytes
//      apart, as a TMA tensor map needs (Lq itself may be any length);
//   2. attn_bwd_dq_sm90: one block per 128 query rows of one (batch, head); it
//      walks the live key tiles (the forward's range) and accumulates dQ in
//      registers: 3 products a tile (S, dP, dS K), Qc and dO loaded once;
//   3. attn_bwd_dkdv_sm90: one block per 128 key rows; it walks the query
//      tiles that can see them and accumulates dK and dV in registers: 4
//      products a tile (S^T, dP^T, P^T dO, dS^T Qc), K and V loaded once.
//      Skipped when the caller needs no dK / dV (cross-attention over a
//      constant text cache).
// The second pass for dQ costs 3 products where f32 atomics would cost
// none, 7 in all against FlashAttention's 5; it keeps the result
// bit-reproducible and needs no f32 scratch, memset or conversion pass.
//
// Each pass is the forward kernel's skeleton: three warpgroups, of which
// warpgroup 2 is the producer (one thread issues every TMA load; it hands
// its registers to the consumers with setmaxnreg) and warpgroups 0 and 1 the
// consumers, 64 owned rows each. The owned tiles (BM = 128 rows) come in
// once; the walked tiles (BN = 64 rows) through a ring of NS stages with
// full and empty mbarriers. Global tensors are 4-D tensor maps (D, N, L, B)
// with a box of 64 bf16 columns (128 bytes, the 128-byte swizzle) by 1 head
// by the tile's rows, so a row arrives as two boxes and rows past L fill
// with zeros; the stats rows are a 2-D f32 map whose box (BN columns, both
// rows) rides on the walked query tile's barrier.
//   * dQ pass: S = Qc K^T and dP = dO V^T by wgmma m64n64k16, both operands
//     K-major in shared memory (the forward's QK^T); P and dS on the
//     accumulator fragment, the mask on edge tiles only; dQ += dS K by wgmma
//     m64n128k16 with dS packed to bf16 in registers as the A operand and
//     the K tile read as an MN-major B (the forward's PV). Each iteration
//     issues S of tile j, dP of tile j and dS K of tile j - 1 as three
//     groups, runs tile j's P once S has landed (while dP and dS K (j - 1)
//     are computed) and its dS once dP has (the forward's QK^T(j) /
//     PV(j - 1) overlap).
//   * dK/dV pass: S^T = K Qc^T and dP^T = V dO^T by m64n64k16 (the owned K
//     and V rows are A, the walked Qc and dO tiles B, K-major); the columns
//     are queries here, so each thread reads lse and D by column from the
//     stage's stats box; then dV += P^T dO and dK += dS^T Qc by m64n128k16
//     with P^T and dS^T from registers. The two 64 x 128 f32 accumulators
//     take 128 registers a thread, so a second tile's S^T cannot be in
//     flight beside them (tried: ptxas spills, and the pass runs 2x
//     slower); the overlap is within the tile: P^T's exp2 runs while dP^T is
//     computed, dS^T while P^T dO is, and the two consumer warpgroups fill
//     each other's elementwise work.
//
// What bounds it on an H100: 5 products of 2 * Lq * Lk_live * 128 FLOP per
// head are the work of the gradient (7 here, with the dQ pass), e.g. 0.680 ms
// at the decode window 4680 x 9360 with 12 heads against ~0.1 ms of bytes:
// compute bound on the bf16 tensor cores (989 TFLOP/s dense), which only
// wgmma reaches.

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int D = 128;
constexpr int BM = 128;  // owned rows per block: two consumer warpgroups of 64
constexpr int BN = 64;   // rows of a walked tile
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int ROW_BYTES = 128;              // one swizzled TMA box row: 64 bf16 columns
constexpr int OWN_HALF = BM * ROW_BYTES;    // 16 KB: 64 columns of an owned tile
constexpr int WALK_HALF = BN * ROW_BYTES;   // 8 KB: 64 columns of a walked tile
constexpr int OWN_TILE = 2 * OWN_HALF;
constexpr int WALK_TILE = 2 * WALK_HALF;
constexpr int NS = 4;                       // ring stages
constexpr int STATS = 2 * BN * 4;           // a query tile's lse * log2 e and D (f32)
constexpr int MODE_WINDOW = 0;              // mode 1: block-causal
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// planted fault for the checks that must catch it (kernel argument)
constexpr int FAULT_DROP_D = 1;  // dS = P * dP: the rowsum(dO * O) term dropped

// Shared memory of each pass: the owned tiles (two, 32 KB each), the ring of
// walked stages (two 16 KB tiles each; the dK/dV pass also has each stage's
// stats box), the barriers, and room to align the base to 1 KB.
constexpr int OFF_RING = 2 * OWN_TILE;
constexpr int OFF_STATS = OFF_RING + NS * 2 * WALK_TILE;
constexpr int OFF_BAR = OFF_STATS + NS * STATS;
constexpr int SMEM = OFF_BAR + 256 + 1024;

struct Barriers {
  uint64_t own_full;
  uint64_t full[NS], empty[NS];
};

struct Mask {
  int mode, lo, hi, block_tokens, kv_len, local_window, Lq, Lk;
  __device__ __forceinline__ bool live(int q, int k) const {
    if (q >= Lq || k >= Lk) return false;
    if (mode == MODE_WINDOW) return k >= lo && k < hi;
    const int end = (q / block_tokens + 1) * block_tokens;
    bool v = k < min(end, kv_len);
    if (local_window > 0) v = v && k >= end - local_window;
    return v || k == q;
  }
  // every pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is live, so
  // the tile needs no per-element mask (whose block-causal form divides)
  __device__ __forceinline__ bool full(int q0, int nq, int k0, int nk) const {
    if (q0 + nq > Lq || k0 + nk > Lk) return false;
    if (mode == MODE_WINDOW) return k0 >= lo && k0 + nk <= hi;
    const int end_first = (q0 / block_tokens + 1) * block_tokens;
    const int end_last = ((q0 + nq - 1) / block_tokens + 1) * block_tokens;
    return k0 + nk <= min(end_first, kv_len) &&
           (local_window <= 0 || k0 >= end_last - local_window);
  }
};

struct Params {
  __nv_bfloat16 *out_a, *out_b;  // dQ pass: dq; dK/dV pass: dk, dv
  const float* stats;            // [B, N, 2, Lqp]: lse * log2 e, D
  int N, Lqp;
  float c;  // the forward's bf16(scale * log2 e)
  Mask m;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a [64 x 64] f32 accumulator fragment as the bf16 A fragments of 4 k16 steps
__device__ __forceinline__ void to_a(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[4 * kk + 0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc[64 x 64] = own[64 rows] . walk[64 rows]^T over D = 128: 8 k16 steps of
// wgmma m64n64k16, both tiles K-major (two 64-column halves each)
__device__ __forceinline__ void product_nt(float (&acc)[32], const uint8_t* own,
                                           const uint8_t* walk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int half = kk / 4, off = (kk % 4) * 32;
    sm90::Wgmma<64>::bf16(acc, sm90::desc_b128(own + half * OWN_HALF + off, 16, 1024),
                          sm90::desc_b128(walk + half * WALK_HALF + off, 16, 1024), kk > 0);
  }
}

// acc[64 x 128] += a[64 x 64] . walk[64 x 128]: the reduction over the
// walked tile's rows, 4 k16 steps of wgmma m64n128k16, walk MN-major
__device__ __forceinline__ void product_rows(float (&acc)[64], const uint32_t (&a)[16],
                                             const uint8_t* walk) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    sm90::wgmma_m64n128k16_rs_tb(acc, &a[4 * kk],
                                 sm90::desc_b128(walk + kk * 16 * ROW_BYTES, WALK_HALF, 1024));
}

// rows r and r + 8 of a warpgroup's [64 x 128] f32 accumulator, times `mul`,
// as bf16 into x [B, L, N, D] at (b, h)
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ x, const float (&acc)[64],
                                           float mul, int b, int h, int r, int L, int N, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + half * 8;
    if (row >= L) continue;
    __nv_bfloat16* dst = x + (((size_t)b * L + row) * N + h) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8 + tig * 2) =
          pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// Qc = bf16(q * c), the forward's rounding of its scores' operand, into [B,
// L, N, D]; and per row lse * log2 e and D = rowsum(dO * O) into stats [B, N,
// 2, Lqp]. Rows of D = 128 values, half a warp per row.
__global__ void __launch_bounds__(256)
attn_bwd_prepass(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const __nv_bfloat16* __restrict__ q, const float* __restrict__ lse, float c,
                 float* __restrict__ stats, __nv_bfloat16* __restrict__ qc, int rows, int L, int N,
                 int Lqp, int fault) {
  const int lane = threadIdx.x % 32, half = lane / 16, sub = lane % 16;
  const int row = (blockIdx.x * 8 + threadIdx.x / 32) * 2 + half;
  uint4 a = make_uint4(0u, 0u, 0u, 0u), d = a, x = a;
  if (row < rows) {
    a = __ldg(reinterpret_cast<const uint4*>(o + (size_t)row * D) + sub);
    d = __ldg(reinterpret_cast<const uint4*>(dout + (size_t)row * D) + sub);
    x = __ldg(reinterpret_cast<const uint4*>(q + (size_t)row * D) + sub);
  }
  const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* dv = reinterpret_cast<const __nv_bfloat16*>(&d);
  __nv_bfloat16* xv = reinterpret_cast<__nv_bfloat16*>(&x);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sum = fmaf(__bfloat162float(av[i]), __bfloat162float(dv[i]), sum);
    xv[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(xv[i]), c));
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows) {
    reinterpret_cast<uint4*>(qc + (size_t)row * D)[sub] = x;
    if (sub == 0) {
      const int h = row % N, l = (row / N) % L, b = row / (N * L);
      float* st = stats + ((size_t)b * N + h) * 2 * Lqp + l;
      st[0] = __ldg(lse + ((size_t)b * N + h) * L + l) * LOG2E;
      st[Lqp] = fault == FAULT_DROP_D ? 0.0f : sum;
    }
  }
}

__device__ __forceinline__ void init_barriers(Barriers& bars) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars.own_full, 1);
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&bars.full[s], 1);
      sm90::mbar_init(&bars.empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
}

// both 64-column halves of rows [r0, r0 + box rows) of one head into dst
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int half_bytes, int h, int r0, int b) {
  sm90::tma_load_4d(dst, map, bar, 0, h, r0, b);
  sm90::tma_load_4d(dst + half_bytes, map, bar, 64, h, r0, b);
}

// dQ of 128 query rows: the key tiles of the forward's live range
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_qc, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Barriers& bars = *reinterpret_cast<Barriers*>(smem + OFF_BAR);
  const Mask& m = p.m;
  const int q_base = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;

  int kv_begin, kv_end;
  if (m.mode == MODE_WINDOW) {
    kv_begin = m.lo;
    kv_end = m.hi;
  } else {
    const int q_last = min(q_base + BM, m.Lq) - 1;
    kv_end = max(min((q_last / m.block_tokens + 1) * m.block_tokens, m.kv_len), q_last + 1);
    kv_begin = 0;
    if (m.local_window > 0)
      kv_begin = min(max((q_base / m.block_tokens + 1) * m.block_tokens - m.local_window, 0),
                     q_base);
  }
  kv_end = min(kv_end, m.Lk);
  kv_begin = (max(kv_begin, 0) / BN) * BN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  init_barriers(bars);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ======== producer: Qc and dO once, then the K and V tiles ========
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(&bars.own_full, 2 * OWN_TILE);
      load_rows(smem, &tm_qc, &bars.own_full, OWN_HALF, h, q_base, b);
      load_rows(smem + OWN_TILE, &tm_do, &bars.own_full, OWN_HALF, h, q_base, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS, kv0 = kv_begin + it * BN;
        uint8_t* stage = smem + OFF_RING + s * 2 * WALK_TILE;
        sm90::mbar_wait(&bars.empty[s], ((it / NS) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.full[s], 2 * WALK_TILE);
        load_rows(stage, &tm_k, &bars.full[s], WALK_HALF, h, kv0, b);
        load_rows(stage + WALK_TILE, &tm_v, &bars.full[s], WALK_HALF, h, kv0, b);
      }
    }
    return;
  }
  // ======== consumers: 64 query rows each ========
  sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  const int q0 = q_base + wg * 64;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

  // live keys of row r: [lim_lo, lim_hi), plus the diagonal in block-causal
  // mode, never past Lk; lse * log2 e and D of the row
  int lim_lo[2], lim_hi[2], diag[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (m.mode == MODE_WINDOW) {
      lim_lo[r] = m.lo;
      lim_hi[r] = m.hi;
      diag[r] = -1;
    } else {
      const int end = (row / m.block_tokens + 1) * m.block_tokens;
      lim_lo[r] = m.local_window > 0 ? end - m.local_window : 0;
      lim_hi[r] = min(end, m.kv_len);
      diag[r] = row;
    }
    if (row >= m.Lq) lim_hi[r] = lim_lo[r], diag[r] = -1;  // a pad row: nothing live
    lim_hi[r] = min(lim_hi[r], m.Lk);
    const float* st = p.stats + ((size_t)b * p.N + h) * 2 * p.Lqp + min(row, m.Lq - 1);
    lse2[r] = __ldg(st);
    dl[r] = __ldg(st + p.Lqp);
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float s[32], dp[32];  // S and dP of the current tile, then its P and dS
  uint32_t dsf[16];     // dS of the previous tile, bf16 A fragments
  const uint8_t* q_rows = smem + wg * 64 * ROW_BYTES;
  const uint8_t* o_rows = smem + OWN_TILE + wg * 64 * ROW_BYTES;
  auto stage = [&](int it) { return smem + OFF_RING + (it % NS) * 2 * WALK_TILE; };

  // S, then dP, of tile `it` (two wgmma groups)
  auto issue_sdp = [&](int it) {
    sm90::mbar_wait(&bars.full[it % NS], (it / NS) & 1);
    const uint8_t* ks = stage(it);
    sm90::wgmma_fence();
    product_nt(s, q_rows, ks);
    sm90::wgmma_commit();
    product_nt(dp, o_rows, ks + WALK_TILE);
    sm90::wgmma_commit();
  };
  // dQ += dS K of tile `it` (one wgmma group), dS from dsf
  auto issue_dq = [&](int it) {
    sm90::fence_regs(acc);
    sm90::fence_regs(dsf);
    sm90::wgmma_fence();
    product_rows(acc, dsf, stage(it));
    sm90::wgmma_commit();
  };
  // P of tile `it` on the fragment once S has landed, the mask on edge tiles
  // only
  auto probabilities = [&](int it) {
    sm90::fence_regs(s);
    const int kv0 = kv_begin + it * BN;
    if (m.full(q0, 64, kv0, BN)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = ex2(s[i] - lse2[(i >> 1) & 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1, col = kv0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        const bool live = (col >= lim_lo[r] && col < lim_hi[r]) || (col == diag[r] && col < m.Lk);
        s[i] = live ? ex2(s[i] - lse2[r]) : 0.0f;
      }
    }
  };
  // dS = P (dP - D) once dP has landed
  auto scores_grad = [&]() {
    sm90::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]);
  };
  // after the dS K group of tile `it` has completed: its stage goes back
  auto release = [&](int it) {
    sm90::fence_regs(acc);
    sm90::fence_regs(dsf);
    if (lane == 0) sm90::mbar_arrive(&bars.empty[it % NS]);
  };

  if (n_tiles > 0) {
    sm90::mbar_wait(&bars.own_full, 0);
    issue_sdp(0);
    sm90::wgmma_wait<1>();
    probabilities(0);
    sm90::wgmma_wait<0>();
    scores_grad();
    to_a(dsf, dp);
    // tile it: S and dP, then dS K of tile it - 1, in flight together; P
    // runs while dP and dS K (it - 1) are computed, dS while dS K (it - 1) is
    for (int it = 1; it < n_tiles; ++it) {
      issue_sdp(it);
      issue_dq(it - 1);
      sm90::wgmma_wait<2>();
      probabilities(it);
      sm90::wgmma_wait<1>();
      scores_grad();
      sm90::wgmma_wait<0>();
      release(it - 1);
      to_a(dsf, dp);
    }
    issue_dq(n_tiles - 1);
    sm90::wgmma_wait<0>();
    release(n_tiles - 1);
  }
  store_rows(p.out_a, acc, p.c * LN2, b, h, r0, m.Lq, p.N, tig);
}

// dK and dV of 128 key rows: the query tiles that can see them, each with
// its stats box
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_qc,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_stats, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Barriers& bars = *reinterpret_cast<Barriers*>(smem + OFF_BAR);
  const Mask& m = p.m;
  const int k_base = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int k_end = min(k_base + BM, m.Lk);

  int q_begin, q_end;
  if (m.mode == MODE_WINDOW) {
    q_begin = 0;
    q_end = (k_base < m.hi && k_end > m.lo) ? m.Lq : 0;
  } else {
    // ends[q] > k_base from the block of k_base on; the diagonal from k_base on
    q_begin = k_base < m.kv_len ? (k_base / m.block_tokens) * m.block_tokens : k_base;
    q_end = m.Lq;
    if (m.local_window > 0)  // ends[q] - local_window <= k_end - 1, or the diagonal
      q_end = min(m.Lq,
                  max(((k_end - 1 + m.local_window) / m.block_tokens) * m.block_tokens, k_end));
  }
  q_begin = (q_begin / BN) * BN;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BN - 1) / BN : 0;

  init_barriers(bars);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ======== producer: K and V once, then the Qc and dO tiles ========
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      sm90::prefetch_tensormap(&tm_qc);
      sm90::prefetch_tensormap(&tm_do);
      sm90::prefetch_tensormap(&tm_stats);
      sm90::mbar_arrive_expect_tx(&bars.own_full, 2 * OWN_TILE);
      load_rows(smem, &tm_k, &bars.own_full, OWN_HALF, h, k_base, b);
      load_rows(smem + OWN_TILE, &tm_v, &bars.own_full, OWN_HALF, h, k_base, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS, q0 = q_begin + it * BN;
        uint8_t* stage = smem + OFF_RING + s * 2 * WALK_TILE;
        sm90::mbar_wait(&bars.empty[s], ((it / NS) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.full[s], 2 * WALK_TILE + STATS);
        load_rows(stage, &tm_qc, &bars.full[s], WALK_HALF, h, q0, b);
        load_rows(stage + WALK_TILE, &tm_do, &bars.full[s], WALK_HALF, h, q0, b);
        sm90::tma_load_2d(smem + OFF_STATS + s * STATS, &tm_stats, &bars.full[s], q0,
                          (b * p.N + h) * 2);
      }
    }
    return;
  }
  // ======== consumers: 64 key rows each ========
  sm90::reg_alloc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, g = lane / 4, tig = lane % 4;
  const int k0 = k_base + wg * 64;
  const int r0 = k0 + warp * 16 + g;  // this thread's key rows r0 and r0 + 8

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;
  const uint8_t* k_rows = smem + wg * 64 * ROW_BYTES;
  const uint8_t* v_rows = smem + OWN_TILE + wg * 64 * ROW_BYTES;

  if (n_tiles > 0) sm90::mbar_wait(&bars.own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS, q0 = q_begin + it * BN;
    sm90::mbar_wait(&bars.full[s], (it / NS) & 1);
    const uint8_t* qs = smem + OFF_RING + s * 2 * WALK_TILE;
    const uint8_t* os = qs + WALK_TILE;
    const float* lse2 = reinterpret_cast<const float*>(smem + OFF_STATS + s * STATS);
    const float* dl = lse2 + BN;
    float st[32], dpt[32];  // S^T and dP^T: rows = keys, columns = queries
    uint32_t pf[16], dsf[16];
    sm90::wgmma_fence();
    product_nt(st, k_rows, qs);
    sm90::wgmma_commit();
    product_nt(dpt, v_rows, os);
    sm90::wgmma_commit();
    // P^T while dP^T is in flight
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);
    const bool full = m.full(q0, BN, k0, 64);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + j * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const bool live = full || m.live(q0 + j * 8 + tig * 2 + (e & 1), r0 + 8 * (e >> 1));
        st[i] = live ? ex2(st[i] - ((e & 1) ? l2.y : l2.x)) : 0.0f;
      }
    }
    to_a(pf, st);
    // dV += P^T dO, and dS^T while it is in flight
    sm90::fence_regs(dv);
    sm90::fence_regs(pf);
    sm90::wgmma_fence();
    product_rows(dv, pf, os);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + j * 8 + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dpt[i] = st[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
    to_a(dsf, dpt);
    // dK += dS^T Qc
    sm90::fence_regs(dk);
    sm90::fence_regs(dsf);
    sm90::wgmma_fence();
    product_rows(dk, dsf, qs);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(pf);
    sm90::fence_regs(dsf);
    if (lane == 0) sm90::mbar_arrive(&bars.empty[s]);
  }
  store_rows(p.out_a, dk, LN2, b, h, r0, m.Lk, p.N, tig);
  store_rows(p.out_b, dv, 1.0f, b, h, r0, m.Lk, p.N, tig);
}

// [B, L, N, D] bf16 as a 4-D tensor map with a box of 64 columns (128 bytes)
// x 1 head x `rows` rows.
int rows_map(CUtensorMap* map, const void* ptr, int B, int L, int N, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2,
                                 (cuuint64_t)L * N * D * 2};
  const cuuint32_t box[4] = {ROW_BYTES / 2, 1, (cuuint32_t)rows, 1};
  return sm90::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box);
}

}  // namespace

// Plain C entry point, bound with ctypes; returns a cudaError_t (0 = launched).
// q, o, dout, dq [B, Lq, N, 128] and k, v, dk, dv [B, Lk, N, 128] bf16
// contiguous; lse [B, N, Lq] f32 (natural log, as the forward kernel writes
// it); c = bf16(scale * log2 e), the factor the forward took; stats [B, N, 2,
// Lqp] f32 scratch with Lqp = Lq rounded up to a multiple of 4, and qc [B,
// Lq, N, 128] bf16 scratch. mode 0 = window [lo, hi), mode 1 = block-causal
// (block_tokens, kv_len, local_window <= 0 for none). With need_kv = 0 only
// dq is written. fault plants a fault for the checks (0 in every real call).
extern "C" int rtv_attention_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* stats, void* qc,
                                      void* dq, void* dk, void* dv, int B, int Lq, int Lk, int N,
                                      int D_, float c, int mode, int lo, int hi,
                                      int block_tokens, int kv_len, int local_window,
                                      int need_kv, int fault, void* stream) {
  if (D_ != D || B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0 || block_tokens <= 0 || c <= 0.0f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int Lqp = (Lq + 3) / 4 * 4;
  // the pre-pass first: autograd runs the backward on a thread of its own,
  // where encoding a tensor map failed (cudaError 1) until a launch had made
  // the device's context current there
  const int rows = B * Lq * N;
  attn_bwd_prepass<<<(rows + 15) / 16, 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(o), reinterpret_cast<const __nv_bfloat16*>(dout),
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const float*>(lse), c,
      reinterpret_cast<float*>(stats), reinterpret_cast<__nv_bfloat16*>(qc), rows, Lq, N, Lqp,
      fault);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm_qc_own, tm_do_own, tm_k_walk, tm_v_walk;
  int err = rows_map(&tm_qc_own, qc, B, Lq, N, BM);
  if (err == 0) err = rows_map(&tm_do_own, dout, B, Lq, N, BM);
  if (err == 0) err = rows_map(&tm_k_walk, k, B, Lk, N, BN);
  if (err == 0) err = rows_map(&tm_v_walk, v, B, Lk, N, BN);
  if (err != 0) return err;
  Params prm = {reinterpret_cast<__nv_bfloat16*>(dq), nullptr,
                reinterpret_cast<const float*>(stats), N, Lqp, c,
                {mode, lo, hi, block_tokens, kv_len, local_window, Lq, Lk}};
  e = cudaFuncSetAttribute(attn_bwd_dq_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_sm90<<<dim3((Lq + BM - 1) / BM, N, B), NTHREADS, SMEM, s>>>(
      tm_qc_own, tm_do_own, tm_k_walk, tm_v_walk, prm);
  e = cudaGetLastError();
  if (e != cudaSuccess || !need_kv) return (int)e;

  CUtensorMap tm_k_own, tm_v_own, tm_qc_walk, tm_do_walk, tm_stats;
  err = rows_map(&tm_k_own, k, B, Lk, N, BM);
  if (err == 0) err = rows_map(&tm_v_own, v, B, Lk, N, BM);
  if (err == 0) err = rows_map(&tm_qc_walk, qc, B, Lq, N, BN);
  if (err == 0) err = rows_map(&tm_do_walk, dout, B, Lq, N, BN);
  if (err == 0) {  // stats: [B * N * 2, Lq] f32 rows Lqp apart, a box of BN columns x 2 rows
    const cuuint64_t dims[2] = {(cuuint64_t)Lq, (cuuint64_t)B * N * 2};
    const cuuint64_t strides[1] = {(cuuint64_t)Lqp * 4};
    const cuuint32_t box[2] = {BN, 2};
    err = sm90::make_tensor_map(&tm_stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, stats, dims,
                                strides, box, nullptr, false);
  }
  if (err != 0) return err;
  prm.out_a = reinterpret_cast<__nv_bfloat16*>(dk);
  prm.out_b = reinterpret_cast<__nv_bfloat16*>(dv);
  e = cudaFuncSetAttribute(attn_bwd_dkdv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkdv_sm90<<<dim3((Lk + BM - 1) / BM, N, B), NTHREADS, SMEM, s>>>(
      tm_k_own, tm_v_own, tm_qc_walk, tm_do_walk, tm_stats, prm);
  return (int)cudaGetLastError();
}
