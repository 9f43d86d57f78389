// Backward of the decode-window and block-causal attention for Hopper (sm_90a),
// with mma.sync tensor-core products: dq, dk, dv of the function that
// csrc/attention_sm90.cu computes forward.
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
// key (never on the training path) gets zero gradients.
//
// Three launches on the caller's stream, no atomics, deterministic:
//   1. attn_bwd_prepass: D = rowsum(dO * O), f32 [B, N, Lq], and Qc;
//   2. attn_bwd_dq: one block per 64 query rows of one (batch, head); it walks
//      the live key tiles (the forward's range) and accumulates dQ in
//      registers: 3 products a tile (S, dP, dS K);
//   3. attn_bwd_dkdv: one block per 64 key rows; it walks the query tiles
//      that can see them and accumulates dK and dV in registers: 4 products
//      a tile (S^T, dP^T, P^T dO, dS^T Q). Skipped when the caller needs no
//      dK / dV (cross-attention over a constant text cache).
// The second pass for dQ costs 3 products where f32 atomics would cost
// none, 7 in all against FlashAttention-2's 5; it keeps the result
// bit-reproducible and needs no f32 scratch, memset or conversion pass.
//
// Each block has 4 warps; a warp owns 16 rows of the block's tile and all
// 64 rows of the walked tile. Tiles of 64 x 128 bf16 sit in shared memory
// with rows 272 bytes apart (8 ldmatrix rows land in distinct banks);
// operands come in by ldmatrix (.trans for the B operands whose reduction
// runs over rows: dO and Q in the dK/dV pass, K in the dQ pass); products by
// mma.sync.m16n8k16 bf16 -> f32. P and dS go to bf16 in registers, where
// the accumulator fragment of one product is the A fragment of the next.
// The walked tiles come in by cp.async into two stages: the next tile's
// copy is in flight while this one's products run (105 KB of shared memory
// and at most 255 registers a thread: two blocks an SM).
//
// What bounds it on an H100: 5 products of 2 * Lq * Lk_live * 128 FLOP per
// head are the work of the gradient (7 here, with the dQ pass), e.g. 0.680 ms
// at the decode window 4680 x 9360 with 12 heads against ~0.1 ms of bytes:
// compute bound on the bf16 tensor cores (989 TFLOP/s dense). mma.sync runs
// at a fraction of the wgmma rate; the wgmma/TMA form is later work.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BT = 64;            // rows of every tile (owned and walked)
constexpr int NT = 128;           // 4 warps
constexpr int LD = D + 8;         // shared-memory row pitch in bf16 elements (272 bytes)
constexpr int TILE = BT * LD;     // elements of one tile
// the owned tile(s), two stages of the walked tile(s), two stages of the
// walked rows' lse and D (f32)
constexpr int SMEM = 6 * TILE * 2 + 2 * 2 * BT * 4;
constexpr int MODE_WINDOW = 0;    // mode 1: block-causal
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// planted fault for the checks that must catch it (kernel argument)
constexpr int FAULT_DROP_D = 1;   // dS = P * dP: the rowsum(dO * O) term dropped

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
  // every pair of query rows [q0, q0 + BT) and keys [k0, k0 + BT) is live, so
  // the tile needs no per-element mask (whose block-causal form divides)
  __device__ __forceinline__ bool full(int q0, int k0) const {
    if (q0 + BT > Lq || k0 + BT > Lk) return false;
    if (mode == MODE_WINDOW) return k0 >= lo && k0 + BT <= hi;
    const int end_first = (q0 / block_tokens + 1) * block_tokens;
    const int end_last = ((q0 + BT - 1) / block_tokens + 1) * block_tokens;
    return k0 + BT <= min(end_first, kv_len) &&
           (local_window <= 0 || k0 >= end_last - local_window);
  }
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where lane l points ldmatrix for a 16x16 block at (row, col) of a tile:
//   * as an A operand (rows = M, cols = K): matrices (r, c), (r + 8, c),
//     (r, c + 8), (r + 8, c + 8) give a0..a3;
//   * with .trans, as the B operands of two n8 tiles whose reduction runs
//     over the tile's rows (rows = K, cols = N): b0, b1 of cols [c, c + 8),
//     then b0, b1 of [c + 8, c + 16).
__device__ __forceinline__ const __nv_bfloat16* at_a(const __nv_bfloat16* tile, int row, int col,
                                                     int lane) {
  return tile + (row + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col + (lane >> 4) * 8;
}

// ... and as the B operands of two n8 tiles whose reduction runs over the
// tile's columns (rows = N, cols = K): b0, b1 of rows [r, r + 8), then of
// [r + 8, r + 16).
__device__ __forceinline__ const __nv_bfloat16* at_b(const __nv_bfloat16* tile, int row, int col,
                                                     int lane) {
  return tile + (row + (lane & 7) + (lane >> 4) * 8) * LD + col + ((lane >> 3) & 1) * 8;
}

// cp.async: `bytes` (16: .cg, through L2 only; 4: .ca) from global memory
// into shared memory, zero-filled when `valid` is false (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's newest commit groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// start copying rows [r0, r0 + 64) of x [B, L, N, D] at (b, h) into a tile;
// rows past L become zeros
__device__ __forceinline__ void fetch_tile(__nv_bfloat16* tile, const __nv_bfloat16* __restrict__ x,
                                           int b, int h, int r0, int L, int N) {
  for (int i = threadIdx.x; i < BT * (D / 8); i += NT) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool ok = r0 + r < L;
    cp_async16(tile + r * LD + c * 8, x + (((size_t)b * L + (ok ? r0 + r : 0)) * N + h) * D + c * 8,
               ok);
  }
}

// S (or S^T) and dP (or dP^T) of a warp's 16 owned rows against the 64 walked
// rows: s = own_a . walk_a^T, dp = own_b . walk_b^T, each [16 x 64] as 8 n8
// accumulator fragments.
__device__ __forceinline__ void two_products(float (&s)[8][4], float (&dp)[8][4],
                                             const __nv_bfloat16* own_a,
                                             const __nv_bfloat16* walk_a,
                                             const __nv_bfloat16* own_b,
                                             const __nv_bfloat16* walk_b, int row0, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], c[4];
    ldsm_x4(a, at_a(own_a, row0, kk * 16, lane));
    ldsm_x4(c, at_a(own_b, row0, kk * 16, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t w[4];
      ldsm_x4(w, at_b(walk_a, np * 16, kk * 16, lane));
      mma(s[2 * np], a, w[0], w[1]);
      mma(s[2 * np + 1], a, w[2], w[3]);
      ldsm_x4(w, at_b(walk_b, np * 16, kk * 16, lane));
      mma(dp[2 * np], c, w[0], w[1]);
      mma(dp[2 * np + 1], c, w[2], w[3]);
    }
  }
}

// pack [16 x 64] f32 fragments into the bf16 A fragments of 4 k16 steps
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc[16 x 128] += a[16 x 64] . tile[64 x 128] (the reduction over the tile's rows)
__device__ __forceinline__ void product_rows(float (&acc)[16][4], const uint32_t (&a)[4][4],
                                             const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t w[4];
      ldsm_x4_t(w, at_a(tile, kk * 16, np * 16, lane));
      mma(acc[2 * np], a[kk], w[0], w[1]);
      mma(acc[2 * np + 1], a[kk], w[2], w[3]);
    }
  }
}

// rows r and r + 8 of a warp's [16 x 128] f32 accumulator, times `mul`, as
// bf16 into x [B, L, N, D] at (b, h)
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ x, const float (&acc)[16][4],
                                           float mul, int b, int h, int r, int L, int N, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + half * 8;
    if (row >= L) continue;
    __nv_bfloat16* dst = x + (((size_t)b * L + row) * N + h) * D;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8 + tig * 2) =
          pack_bf16(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

// D = rowsum(dO * O) over rows of D = 128 values, half a warp per row, into
// [B, N, L] f32, and qc = bf16(q * c), the forward's rounding of its scores'
// operand, into [B, L, N, D]
__global__ void __launch_bounds__(256)
attn_bwd_prepass(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const __nv_bfloat16* __restrict__ q, float c, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ qc, int rows, int L, int N) {
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
      delta[((size_t)b * N + h) * L + l] = sum;
    }
  }
}

struct Args {
  const __nv_bfloat16 *qc, *k, *v, *dout;  // qc = bf16(q * c), as the forward scores it
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int N;
  float c;  // the forward's bf16(scale * log2 e)
  Mask m;
  int fault;
};

// dQ of 64 query rows: the key tiles of the forward's live range, each
// fetched by cp.async into one of two stages while the other is used
__global__ void __launch_bounds__(NT, 2) attn_bwd_dq(const Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + TILE;      // dO
  __nv_bfloat16* sK = sO + TILE;      // two stages
  __nv_bfloat16* sV = sK + 2 * TILE;  // two stages
  const Mask& m = a.m;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0 and r0 + 8

  int kv_begin, kv_end;
  if (m.mode == MODE_WINDOW) {
    kv_begin = m.lo;
    kv_end = m.hi;
  } else {
    const int q_last = min(q0 + BT, m.Lq) - 1;
    kv_end = max(min((q_last / m.block_tokens + 1) * m.block_tokens, m.kv_len), q_last + 1);
    kv_begin = 0;
    if (m.local_window > 0)
      kv_begin = min(max((q0 / m.block_tokens + 1) * m.block_tokens - m.local_window, 0), q0);
  }
  kv_end = min(kv_end, m.Lk);
  kv_begin = (max(kv_begin, 0) / BT) * BT;

  fetch_tile(sQ, a.qc, b, h, q0, m.Lq, a.N);
  fetch_tile(sO, a.dout, b, h, q0, m.Lq, a.N);
  if (kv_begin < kv_end) {
    fetch_tile(sK, a.k, b, h, kv_begin, m.Lk, a.N);
    fetch_tile(sV, a.v, b, h, kv_begin, m.Lk, a.N);
  }
  cp_async_commit();
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const size_t i = ((size_t)b * a.N + h) * m.Lq + row;
    lse2[r] = row < m.Lq ? __ldg(a.lse + i) * LOG2E : 0.0f;
    dl[r] = row < m.Lq && a.fault != FAULT_DROP_D ? __ldg(a.delta + i) : 0.0f;
  }

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int k0 = kv_begin, st = 0; k0 < kv_end; k0 += BT, st ^= 1) {
    if (k0 + BT < kv_end) {  // the next tile into the other stage
      fetch_tile(sK + (st ^ 1) * TILE, a.k, b, h, k0 + BT, m.Lk, a.N);
      fetch_tile(sV + (st ^ 1) * TILE, a.v, b, h, k0 + BT, m.Lk, a.N);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and Q, dO) have landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + st * TILE;
    const bool full = m.full(q0, k0);
    float s[8][4], dp[8][4];
    two_products(s, dp, sQ, tK, sO, sV + st * TILE, warp * 16, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = k0 + n * 8 + tig * 2 + (e & 1);
        const bool live = full || m.live(r0 + 8 * r, key);
        const float p = live ? ex2(s[n][e] - lse2[r]) : 0.0f;
        dp[n][e] = p * (dp[n][e] - dl[r]);
      }
    uint32_t ds[4][4];
    to_a(ds, dp);
    product_rows(acc, ds, tK, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows(a.dq, acc, a.c * LN2, b, h, r0, m.Lq, a.N, tig);
}

// dK and dV of 64 key rows: the query tiles that can see them, each (with
// its lse and D) fetched by cp.async into one of two stages while the other
// is used
__global__ void __launch_bounds__(NT, 2) attn_bwd_dkdv(const Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TILE;
  __nv_bfloat16* sQ = sV + TILE;      // two stages
  __nv_bfloat16* sO = sQ + 2 * TILE;  // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);  // the query tile's lse, two stages
  float* sD = sL + 2 * BT;                               // its D, two stages
  const Mask& m = a.m;
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int r0 = k0 + warp * 16 + g;  // this thread's key rows r0 and r0 + 8
  const int k1 = min(k0 + BT, m.Lk);

  int q_begin, q_end;
  if (m.mode == MODE_WINDOW) {
    q_begin = 0;
    q_end = (k0 < m.hi && k1 > m.lo) ? m.Lq : 0;
  } else {
    // ends[q] > k0 from the block of k0 on; the diagonal from k0 on
    q_begin = k0 < m.kv_len ? (k0 / m.block_tokens) * m.block_tokens : k0;
    q_end = m.Lq;
    if (m.local_window > 0)  // ends[q] - local_window <= k1 - 1, or the diagonal
      q_end = min(m.Lq, max(((k1 - 1 + m.local_window) / m.block_tokens) * m.block_tokens, k1));
  }
  q_begin = (q_begin / BT) * BT;

  // the query tile at q0 (rows, then its lse and D) into stage st
  auto fetch_q = [&](int q0, int st) {
    fetch_tile(sQ + st * TILE, a.qc, b, h, q0, m.Lq, a.N);
    fetch_tile(sO + st * TILE, a.dout, b, h, q0, m.Lq, a.N);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < m.Lq;
      const size_t i = ((size_t)b * a.N + h) * m.Lq + (ok ? row : 0);
      cp_async4(sL + st * BT + threadIdx.x, a.lse + i, ok);
      cp_async4(sD + st * BT + threadIdx.x, a.delta + i, ok && a.fault != FAULT_DROP_D);
    }
  };
  fetch_tile(sK, a.k, b, h, k0, m.Lk, a.N);
  fetch_tile(sV, a.v, b, h, k0, m.Lk, a.N);
  if (q_begin < q_end) fetch_q(q_begin, 0);
  cp_async_commit();

  float dk[16][4], dv[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int q0 = q_begin, st = 0; q0 < q_end; q0 += BT, st ^= 1) {
    if (q0 + BT < q_end) fetch_q(q0 + BT, st ^ 1);  // the next tile into the other stage
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (and K, V) have landed
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + st * TILE;
    const __nv_bfloat16* tO = sO + st * TILE;
    const float* tL = sL + st * BT;
    const float* tD = sD + st * BT;
    const bool full = m.full(q0, k0);
    float s[8][4], dp[8][4];  // S^T and dP^T: rows = keys, columns = queries
    two_products(s, dp, sK, tQ, sV, tO, warp * 16, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1);
        const bool live = full || m.live(q0 + col, r0 + 8 * (e >> 1));
        const float p = live ? ex2(s[n][e] - tL[col] * LOG2E) : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - tD[col]);
      }
    uint32_t pa[4][4], da[4][4];
    to_a(pa, s);
    to_a(da, dp);
    product_rows(dv, pa, tO, lane);
    product_rows(dk, da, tQ, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  store_rows(a.dk, dk, LN2, b, h, r0, m.Lk, a.N, tig);
  store_rows(a.dv, dv, 1.0f, b, h, r0, m.Lk, a.N, tig);
}

}  // namespace

// Plain C entry point, bound with ctypes; returns a cudaError_t (0 = launched).
// q, o, dout, dq [B, Lq, N, 128] and k, v, dk, dv [B, Lk, N, 128] bf16
// contiguous; lse [B, N, Lq] f32 (natural log, as the forward kernel writes
// it); c = bf16(scale * log2 e), the factor the forward took; delta [B, N,
// Lq] f32 and qc [B, Lq, N, 128] bf16 scratch. mode 0 = window [lo, hi),
// mode 1 = block-causal (block_tokens, kv_len, local_window <= 0 for none).
// With need_kv = 0 only dq is written. fault plants a fault for the checks
// (0 in every real call).
extern "C" int rtv_attention_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* delta, void* qc,
                                      void* dq, void* dk, void* dv, int B, int Lq, int Lk, int N,
                                      int D_, float c, int mode, int lo, int hi,
                                      int block_tokens, int kv_len, int local_window,
                                      int need_kv, int fault, void* stream) {
  if (D_ != D || B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0 || block_tokens <= 0 || c <= 0.0f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * Lq * N;
  attn_bwd_prepass<<<(rows + 15) / 16, 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(o), reinterpret_cast<const __nv_bfloat16*>(dout),
      reinterpret_cast<const __nv_bfloat16*>(q), c, reinterpret_cast<float*>(delta),
      reinterpret_cast<__nv_bfloat16*>(qc), rows, Lq, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Args a = {reinterpret_cast<const __nv_bfloat16*>(qc),
                  reinterpret_cast<const __nv_bfloat16*>(k),
                  reinterpret_cast<const __nv_bfloat16*>(v),
                  reinterpret_cast<const __nv_bfloat16*>(dout),
                  reinterpret_cast<const float*>(lse),
                  reinterpret_cast<const float*>(delta),
                  reinterpret_cast<__nv_bfloat16*>(dq),
                  reinterpret_cast<__nv_bfloat16*>(dk),
                  reinterpret_cast<__nv_bfloat16*>(dv),
                  N,
                  c,
                  {mode, lo, hi, block_tokens, kv_len, local_window, Lq, Lk},
                  fault};
  e = cudaFuncSetAttribute(attn_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq<<<dim3((Lq + BT - 1) / BT, N, B), NT, SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || !need_kv) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkdv<<<dim3((Lk + BT - 1) / BT, N, B), NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}
