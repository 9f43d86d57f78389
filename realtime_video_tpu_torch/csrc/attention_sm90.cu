// bf16 decode-window and block-causal attention for Hopper (sm_90a) with
// wgmma, TMA and a warp-specialised pipeline; and the logit-bound pre-pass.
//
// Replaces the bf16 routes of the Pallas TPU kernels of
// realtime_video_tpu/ops/pallas_attention.py:
//   * _staticmax_kernel (K1): softmax over KV columns in [lo, hi) with a static
//     logit bound M in place of the running max; when M >= 64 the same launch
//     keeps a running max (the _flash_kernel fallback);
//   * _flash_kernel (K2), bf16: online-softmax attention in `window` mode and
//     in `block_causal` mode (kv < min(ends[q], kv_len), optional local
//     window, plus the diagonal).
// The int8 QK^T mode and the skewed loops (K2-int8, K6a, K6b) stay in
// csrc/attention.cu.
//
// Layout: q/k/v/o [B, L, N, D] bf16, contiguous (the JAX package's public
// layout), D = 128. A thread block owns BM = 128 query rows of one (batch,
// head) and walks the KV tiles of its live range. Its three warpgroups:
//   * warpgroup 2, the producer: one thread issues TMA loads of the Q tile
//     (once) and of K and V tiles (BN = 128 rows) into a two-stage ring, with
//     full and empty mbarriers per stage for K and for V apart, so the next K
//     tile can land while the current V tile is still being read. The
//     warpgroup hands its registers to the consumers (setmaxnreg).
//   * warpgroups 0 and 1, the consumers, 64 query rows each: S = Q K^T by
//     wgmma m64n128k16 with both operands in shared memory (K is [BN, D],
//     K-major for this product), the mask on the accumulator fragment of edge
//     tiles only, the softmax in registers, then O += P V by wgmma with P
//     converted to bf16 in registers as the A operand and V read from shared
//     memory as an MN-major (transposed) B operand.
// Overlap: each iteration issues the QK^T of tile j and the PV of tile j-1 as
// two wgmma groups, waits for the first only, and runs tile j's mask, max and
// exp2 while PV(j-1) is still in flight (the Hopper form of the TPU kernels'
// skew, inside each warpgroup); the two consumer warpgroups are not ordered
// against each other, so the scheduler also fills one's softmax with the
// other's wgmma. No persistent schedule: one thread block per (q tile, head,
// batch), 444 blocks at the 1.3B self-attention shape (3.4 waves on 132 SMs).
//
// Global rows are N * D * 2 bytes apart; each tensor map is 4-D (D, N, L, B)
// with a box of 64 columns (128 bytes, the 128-byte swizzle) by 1 head by BN
// rows, so a row of D = 128 arrives as two boxes, and rows past L fill with
// zeros inside the box (never from the next batch). Columns outside [lo, hi)
// inside a loaded tile are masked on the fragment.
//
// The prescale is folded in: the kernel takes raw q and c = bf16(scale *
// log2(e)) and forms bf16(q * c) in shared memory before the first product,
// which rounds the exact f32 product once, bit-equal to the `prescale` that
// the mma.sync kernel's callers run (pallas_attention.py:620-622). The logit
// bound M = sqrt(max_q |q c|^2) * sqrt(max_k |k|^2) + 1e-3
// (pallas_attention.py:437-442, over the whole buffers) comes from a small
// pre-pass kernel that takes the two maxima across blocks with atomics on the
// f32 bits; the main kernel reads them and forms M itself. No host sync.
//
// What bounds it on an H100: at the 1.3B self-attention shape one call is
// 4 * Lq * (hi - lo) * D * N = 2.2e11 FLOP against ~40 MB of traffic, compute
// bound on the bf16 tensor cores (989 TFLOP/s dense, 0.227 ms).

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int D = 128;
constexpr int BM = 128;  // query rows per thread block: two consumer warpgroups of 64
constexpr int BN = 128;  // KV rows per tile
constexpr int NSTAGES = 2;
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int HALF_ROW_BYTES = 128;               // 64 bf16: one swizzled TMA box row
constexpr int Q_HALF = BM * HALF_ROW_BYTES;       // 16 KB
constexpr int KV_HALF = BN * HALF_ROW_BYTES;      // 16 KB
constexpr int TILE_BYTES = 2 * KV_HALF;           // a K or a V tile, 32 KB
constexpr int OFF_K = 2 * Q_HALF;
constexpr int OFF_V = OFF_K + NSTAGES * TILE_BYTES;
constexpr int OFF_BAR = OFF_V + NSTAGES * TILE_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;  // barriers, and room to align to 1 KB
constexpr float NEG_INF = -1e30f;
constexpr float STATIC_MAX_LIMIT = 64.0f;  // exp2(s - M) is safe while M < 64
constexpr int MODE_WINDOW = 0;             // mode 1: block-causal

// planted fault for the check that must catch it: the producer fills the
// last ring stage with the previous tile's rows (a stage out of step)
constexpr int FAULT_STALE_RING_STAGE = 3;

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[NSTAGES], k_empty[NSTAGES];
  uint64_t v_full[NSTAGES], v_empty[NSTAGES];
};

// 2^x by the SFU alone (results below 2^-126 flush to 0, which a softmax
// weight of that size never changes in bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(NTHREADS, 1)
attention_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      int Lq, int Lk, int N, float qscale, const float* __restrict__ maxima,
                      int mode, int lo, int hi, int block_tokens, int kv_len, int local_window,
                      int fault) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Barriers& bars = *reinterpret_cast<Barriers*>(smem + OFF_BAR);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_base = blockIdx.x * BM;

  // ---- the KV range this block can see (tile-aligned start) ----
  int kv_begin, kv_end;
  if (mode == MODE_WINDOW) {
    kv_begin = lo;
    kv_end = hi;
  } else {
    const int q_last = min(q_base + BM, Lq) - 1;
    const int end_max = (q_last / block_tokens + 1) * block_tokens;
    kv_end = max(min(end_max, kv_len), q_last + 1);  // the diagonal may pass kv_len
    kv_begin = 0;
    if (local_window > 0) {
      const int end_min = (q_base / block_tokens + 1) * block_tokens;
      kv_begin = min(max(end_min - local_window, 0), q_base);
    }
  }
  kv_end = min(kv_end, Lk);
  kv_begin = (max(kv_begin, 0) / BN) * BN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars.q_full, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      sm90::mbar_init(&bars.k_full[s], 1);
      sm90::mbar_init(&bars.v_full[s], 1);
      sm90::mbar_init(&bars.k_empty[s], CONSUMER_WARPS);
      sm90::mbar_init(&bars.v_empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ======== producer ========
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(&bars.q_full, 2 * Q_HALF);
      sm90::tma_load_4d(smem, &tm_q, &bars.q_full, 0, h, q_base, b);
      sm90::tma_load_4d(smem + Q_HALF, &tm_q, &bars.q_full, 64, h, q_base, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NSTAGES;
        const uint32_t ph = (it / NSTAGES) & 1;
        int kv0 = kv_begin + it * BN;
        if (fault == FAULT_STALE_RING_STAGE && s == NSTAGES - 1 && it > 0) kv0 -= BN;
        uint8_t* ks = smem + OFF_K + s * TILE_BYTES;
        uint8_t* vs = smem + OFF_V + s * TILE_BYTES;
        sm90::mbar_wait(&bars.k_empty[s], ph ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.k_full[s], TILE_BYTES);
        sm90::tma_load_4d(ks, &tm_k, &bars.k_full[s], 0, h, kv0, b);
        sm90::tma_load_4d(ks + KV_HALF, &tm_k, &bars.k_full[s], 64, h, kv0, b);
        sm90::mbar_wait(&bars.v_empty[s], ph ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.v_full[s], TILE_BYTES);
        sm90::tma_load_4d(vs, &tm_v, &bars.v_full[s], 0, h, kv0, b);
        sm90::tma_load_4d(vs + KV_HALF, &tm_v, &bars.v_full[s], 64, h, kv0, b);
      }
    }
  } else {
    // ======== consumers: 64 query rows each ========
    sm90::reg_alloc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, tig = lane % 4;
    const int r0 = q_base + wg * 64 + warp * 16 + g;  // rows of this thread's fragments
    const int r1 = r0 + 8;

    // live columns of row r: [lim_lo, lim_hi), plus the diagonal col == r in
    // block-causal mode, and never past Lk
    int lim_lo[2], lim_hi[2], diag[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r ? r1 : r0;
      if (mode == MODE_WINDOW) {
        lim_lo[r] = lo;
        lim_hi[r] = hi;
        diag[r] = -1;
      } else {
        const int end = (qpos / block_tokens + 1) * block_tokens;
        lim_lo[r] = local_window > 0 ? end - local_window : 0;
        lim_hi[r] = min(end, kv_len);
        diag[r] = qpos;
      }
    }

    bool static_max = false;
    float M = 0.0f;
    if (maxima != nullptr && mode == MODE_WINDOW) {
      const float bound = __fadd_rn(__fmul_rn(sqrtf(__ldg(maxima)), sqrtf(__ldg(maxima + 1))),
                                    1e-3f);
      static_max = bound < STATIC_MAX_LIMIT;
      M = bound;
    }

    // ---- Q: wait for the tile, prescale this warpgroup's 64 rows in place ----
    sm90::mbar_wait(&bars.q_full, 0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint8_t* rows = smem + half * Q_HALF + wg * (Q_HALF / 2);
#pragma unroll
      for (int i = 0; i < Q_HALF / 2 / 16 / 128; ++i) {
        uint4* p = reinterpret_cast<uint4*>(rows + (i * 128 + t) * 16);
        uint4 v = *p;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[j]), qscale));
        *p = v;
      }
    }
    sm90::fence_proxy_async();
    sm90::named_bar_sync(1 + wg, 128);

    const uint8_t* q_rows = smem + wg * (Q_HALF / 2);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    float m_run[2] = {NEG_INF, NEG_INF};  // running max (rows r0, r1), log2 domain
    float l_part[2] = {0.0f, 0.0f};       // this thread's share of the row sums
    uint32_t pf[32];                      // P of the previous tile, bf16 A fragments
    float sc[64];                         // S of the current tile, then its p

    // S = Q K^T of tile `it` (one wgmma group)
    auto issue_qk = [&](int it) {
      const int s = it % NSTAGES;
      sm90::mbar_wait(&bars.k_full[s], (it / NSTAGES) & 1);
      const uint8_t* ks = smem + OFF_K + s * TILE_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int half = kk / 4, off = (kk % 4) * 32;
        sm90::wgmma_m64n128k16_ss(sc, sm90::desc_b128(q_rows + half * Q_HALF + off, 16, 1024),
                                  sm90::desc_b128(ks + half * KV_HALF + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // O += P V of tile `it` (one wgmma group), P from pf
    auto issue_pv = [&](int it) {
      const int s = it % NSTAGES;
      sm90::mbar_wait(&bars.v_full[s], (it / NSTAGES) & 1);
      const uint8_t* vs = smem + OFF_V + s * TILE_BYTES;
      sm90::fence_regs(acc);
      sm90::fence_regs(pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::wgmma_m64n128k16_rs_tb(
            acc, &pf[kk * 4], sm90::desc_b128(vs + kk * 16 * HALF_ROW_BYTES, KV_HALF, 1024));
      sm90::wgmma_commit();
    };
    // mask tile `it` on the fragment (edge tiles only), then p = exp2(s - M)
    // or exp2(s - m) with the running max; alpha rescales what came before
    auto softmax = [&](int it, float (&alpha)[2]) {
      const int kv0 = kv_begin + it * BN;
      bool full_tile;
      if (mode == MODE_WINDOW) {
        full_tile = kv0 >= lo && kv0 + BN <= hi;
      } else {
        const int end_first = (q_base / block_tokens + 1) * block_tokens;
        const int q_last = min(q_base + BM, Lq) - 1;
        const int end_last = (q_last / block_tokens + 1) * block_tokens;
        full_tile = kv0 + BN <= min(end_first, kv_len) && kv0 + BN <= Lk &&
                    (local_window <= 0 || kv0 >= end_last - local_window);
      }
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + j * 8 + tig * 2 + (e & 1);
            const int r = e >> 1;
            const bool valid =
                ((col >= lim_lo[r] && col < lim_hi[r]) || col == diag[r]) && col < Lk;
            if (!valid) sc[4 * j + e] = NEG_INF;
          }
        }
      }
      // a masked score (NEG_INF) gives ex2(-1e30 - m) = 0 for any finite m
      alpha[0] = alpha[1] = 1.0f;
      if (static_max) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = ex2(sc[i] - M);
      } else {
        float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          tmax[0] = fmaxf(tmax[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
          tmax[1] = fmaxf(tmax[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
          tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
          const float m_new = fmaxf(m_run[r], tmax[r]);
          alpha[r] = ex2(m_run[r] - m_new);
          m_run[r] = m_new;
        }
        // a row with every column masked so far subtracts 0, so its p stay 0
        const float m_use[2] = {m_run[0] == NEG_INF ? 0.0f : m_run[0],
                                m_run[1] == NEG_INF ? 0.0f : m_run[1]};
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = ex2(sc[i] - m_use[(i >> 1) & 1]);
      }
    };
    // rescale O and l by alpha, add this tile's row sums, pack P to bf16
    auto accumulate = [&](const float (&alpha)[2]) {
      if (!static_max) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
        l_part[0] *= alpha[0];
        l_part[1] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        l_part[0] += sc[4 * j] + sc[4 * j + 1];
        l_part[1] += sc[4 * j + 2] + sc[4 * j + 3];
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pf[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pf[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    if (n_tiles > 0) {
      float alpha[2];
      // tile 0: its QK^T alone
      issue_qk(0);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      if (lane == 0) sm90::mbar_arrive(&bars.k_empty[0]);
      softmax(0, alpha);
      accumulate(alpha);
      // tile it: its QK^T and the PV of tile it-1 in flight together; the
      // softmax of tile it runs while that PV is still being computed
      for (int it = 1; it < n_tiles; ++it) {
        issue_qk(it);
        issue_pv(it - 1);
        sm90::wgmma_wait<1>();
        sm90::fence_regs(sc);
        if (lane == 0) sm90::mbar_arrive(&bars.k_empty[it % NSTAGES]);
        softmax(it, alpha);
        sm90::wgmma_wait<0>();  // O is rescaled and P rewritten after the PV
        sm90::fence_regs(acc);
        sm90::fence_regs(pf);
        if (lane == 0) sm90::mbar_arrive(&bars.v_empty[(it - 1) % NSTAGES]);
        accumulate(alpha);
      }
      // the last tile's PV alone
      issue_pv(n_tiles - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pf);
      if (lane == 0) sm90::mbar_arrive(&bars.v_empty[(n_tiles - 1) % NSTAGES]);
    }

    // ---- finish: reduce the row sums over the quad, normalise, store bf16 ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.0f / fmaxf(l, 1e-30f);
    }
    const size_t row_stride = (size_t)N * D;
    __nv_bfloat16* ob = o + ((size_t)b * Lq * N + h) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = j * 8 + tig * 2;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * row_stride + c) =
            pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      if (r1 < Lq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * row_stride + c) =
            pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
    }
  }
}

// The logit bound's two maxima over rows of D = 128: max |bf16(q c)|^2 into
// maxima[0] and max |k|^2 into maxima[1] (f32, whose bits order as unsigned
// integers for values >= 0, so atomicMax on the bits takes the max). Rows of
// q, then of k; half a warp per row (16 bytes a lane), each warp with 8 rows'
// loads in flight; maxima must hold zeros before the launch.
__global__ void __launch_bounds__(256)
attn_logit_bound_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        long long q_rows, long long k_rows, float qscale,
                        unsigned int* __restrict__ maxima) {
  constexpr int UNROLL = 4;  // row pairs per warp and step
  __shared__ float part[2][8];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int half = lane / 16, sub = lane % 16;
  const long long total = q_rows + k_rows;
  const long long step = (long long)gridDim.x * 8 * 2 * UNROLL;
  float best[2] = {0.0f, 0.0f};
  for (long long base = ((long long)blockIdx.x * 8 + warp) * 2 * UNROLL; base < total;
       base += step) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = base + 2 * u + half;
      const __nv_bfloat16* src = row < q_rows ? q + row * D : k + (row - q_rows) * D;
      raw[u] = row < total ? __ldg(reinterpret_cast<const uint4*>(src) + sub)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = base + 2 * u + half;
      const bool is_q = row < q_rows;
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw[u]);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = __bfloat162float(hv[i]);
        if (is_q) x = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, qscale)));
        sum = __fadd_rn(sum, __fmul_rn(x, x));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      best[is_q ? 0 : 1] = fmaxf(best[is_q ? 0 : 1], sum);  // rows past total sum to 0
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) best[r] = fmaxf(best[r], __shfl_xor_sync(0xffffffffu, best[r], 16));
  if (lane == 0) {
    part[0][warp] = best[0];
    part[1][warp] = best[1];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) m = fmaxf(m, part[threadIdx.x][w]);
    atomicMax(maxima + threadIdx.x, __float_as_uint(m));
  }
}

// [B, L, N, D] bf16 as a 4-D tensor map with a box of 64 columns x 1 head x
// `rows` rows.
int qkv_map(CUtensorMap* map, const void* ptr, int B, int L, int N, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2,
                                 (cuuint64_t)L * N * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return sm90::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Head dim 128 only.

// The logit bound's maxima (see attn_logit_bound_kernel): q [.., D] and k
// [.., D] bf16 contiguous, maxima [2] f32 (zeroed here, on the stream).
extern "C" int rtv_logit_bound(const void* q, const void* k, void* maxima, long long q_rows,
                               long long k_rows, int D_, float qscale, void* stream) {
  if (D_ != D || q_rows < 0 || k_rows < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(maxima, 0, 2 * sizeof(float),
                                  reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  const long long rows = q_rows + k_rows;
  const int blocks = (int)((rows + 63) / 64 < 132 * 8 ? (rows + 63) / 64 : 132 * 8);
  if (blocks == 0) return 0;
  attn_logit_bound_kernel<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      q_rows, k_rows, qscale, reinterpret_cast<unsigned int*>(maxima));
  return (int)cudaGetLastError();
}

// The attention kernel. q raw (the kernel multiplies it by qscale = bf16(scale
// * log2 e)), k, v, o [B, L, N, D] bf16 contiguous. mode 0 = window [lo, hi),
// with the static-max / running-max choice made on the device from maxima
// (null: running max always); mode 1 = block-causal (running max). fault
// plants a fault for the checks (0 in every real call).
extern "C" int rtv_attention_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                  int Lq, int Lk, int N, int D_, float qscale, const float* maxima,
                                  int mode, int lo, int hi, int block_tokens, int kv_len,
                                  int local_window, int fault, void* stream) {
  if (D_ != D || B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0 || block_tokens <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = qkv_map(&tm_q, q, B, Lq, N, BM);
  if (err == 0) err = qkv_map(&tm_k, k, B, Lk, N, BN);
  if (err == 0) err = qkv_map(&tm_v, v, B, Lk, N, BN);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(attention_kernel_sm90,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + BM - 1) / BM, N, B);
  attention_kernel_sm90<<<grid, NTHREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, reinterpret_cast<__nv_bfloat16*>(o), Lq, Lk, N, qscale, maxima, mode,
      lo, hi, block_tokens, kv_len, local_window, fault);
  return (int)cudaGetLastError();
}
