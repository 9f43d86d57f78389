// Decode-window and block-causal attention for Hopper (sm_90a) with wgmma,
// TMA and a warp-specialised pipeline, in bf16 and with int8 QK^T; and the
// two pre-passes (the logit bound, the int8 quanta).
//
// Replaces the Pallas TPU kernels of realtime_video_tpu/ops/pallas_attention.py:
//   * _staticmax_kernel (K1): softmax over KV columns in [lo, hi) with a static
//     logit bound M in place of the running max; when M >= 64 the same launch
//     keeps a running max (the _flash_kernel fallback);
//   * _flash_kernel (K2), bf16: online-softmax attention in `window` mode and
//     in `block_causal` mode (kv < min(ends[q], kv_len), optional local
//     window, plus the diagonal);
//   * and, with no TPU kernel behind it, teacher forcing (mode 2, the
//     template's TF form): the [clean | noisy] mask of
//     ops/attention.py::teacher_forcing_mask, which the JAX package runs
//     through dense XLA. A query tile walks the union of two key ranges
//     (csrc/attention_mask.cuh) with K2's running max and never touches the
//     keys between them; each row's two ranges mask the edge tiles. A
//     separate instantiation, so the other modes' code is unchanged;
//   * _flash_kernel's int8_qk branch (K2-int8, RTV_ATTN_INT8): QK^T on s8
//     quanta of q and of k minus its per-segment mean, the s32 sums scaled to
//     f32 by sq * sk; the softmax (running max) and PV as K2;
//   * _skew_kernel (K6a) and _staticmax_skew_kernel (K6b): K2's and K1's
//     window math with V lagging K by one grid step. Each consumer warpgroup
//     here issues the QK^T of tile j with the PV of tile j-1 and runs tile j's
//     softmax while that PV is in flight, which is the Hopper form of that
//     skew, so the skewed routes launch this kernel in its running-max and
//     static-max forms.
//
// Layout: q/k/v/o [B, L, N, D] bf16, contiguous (the JAX package's public
// layout), D = 128; in the int8 mode q8/k8 [B, L, N, D] s8 with their row
// scales sq [B, N, Lq] and sk [B, N, Lks] f32 (rows Lks >= Lk apart, a
// multiple of 4, for TMA). A thread block owns BM = 128 query rows of one
// (batch, head) and walks the KV tiles of its live range. Its three
// warpgroups:
//   * warpgroup 2, the producers: one thread issues TMA loads of the Q tile
//     (once) and of the K tiles (BN = 128 rows; int8: with their 128 k
//     scales) into a ring of NK stages, another thread those of the V tiles
//     into a ring of two, each stage with full and empty mbarriers, so the
//     K ring runs ahead of the V ring. The warpgroup hands its registers to
//     the consumers (setmaxnreg). An s8 row of D = 128 is one 128-byte box,
//     half a bf16 one, so the int8 mode's K ring has four stages.
//   * warpgroups 0 and 1, the consumers, 64 query rows each: S = Q K^T by
//     wgmma m64n128k16 (bf16, 8 K steps) or m64n128k32 (s8 -> s32, 4 K
//     steps, then s = f32(s32) * (sq * sk) on the accumulator fragment), both
//     operands K-major in shared memory; the mask on the fragment of edge
//     tiles only, the softmax in registers (SFU exp2), then O += P V by wgmma
//     with P converted to bf16 in registers as the A operand and V read from
//     shared memory as an MN-major (transposed) B operand.
// Overlap: each iteration issues the QK^T of tile j and the PV of tile j-1 as
// two wgmma groups, waits for the first only, and runs tile j's scale, mask,
// max and exp2 while PV(j-1) is still in flight; the two consumer warpgroups
// are not ordered against each other, so the scheduler also fills one's
// softmax with the other's wgmma. No persistent schedule: one thread block
// per (q tile, head, batch).
//
// Global rows are N * D * es bytes apart; each tensor map is 4-D (D, N, L, B)
// with a box of 128 bytes (64 bf16 columns or all 128 s8 ones) by 1 head by
// BN rows, so a bf16 row arrives as two boxes and an s8 row as one, and rows
// past L fill with zeros inside the box (never from the next batch). Columns
// outside [lo, hi) inside a loaded tile are masked on the fragment.
//
// The prescale is folded in: the bf16 kernel takes raw q and c = bf16(scale *
// log2(e)) and forms bf16(q * c) in shared memory before the first product,
// which rounds the exact f32 product once, bit-equal to `prescale`
// (pallas_attention.py:620-622); the int8 pre-pass forms the same bf16(q * c)
// before its row max. The logit bound M = sqrt(max_q |q c|^2) *
// sqrt(max_k |k|^2) + 1e-3 (pallas_attention.py:437-442, over the whole
// buffers) comes from a small pre-pass kernel that takes the two maxima
// across blocks with atomics on the f32 bits; the main kernel reads them and
// forms M itself. No host sync.
//
// The int8 mode reproduces the TPU kernel's arithmetic, not SageAttention's
// (pallas_attention.py:155-171): the mean of k is taken over each `seg`-row
// segment of the KV buffer (the TPU kernel's bk-wide compute sub-tile, from
// row 0), zero pad rows included; scales are max|row| / 127 + 1e-8, quanta
// rint(x / s) with an IEEE divide (the build uses no fast-math), and the
// score is float(s32) * (sq * sk) in f32, the product of the scales first.
// It keeps a running max always (the int8 mode has no static max).
//
// For the training path's backward (csrc/attention_bwd_sm90.cu) the bf16
// kernel can also write each row's log-sum-exp, ln 2 * (m + log2 l), from
// the m its p were taken against (the static bound or the running max); a
// null pointer writes nothing, so the serving calls do no more work.
//
// What bounds it on an H100: at the 1.3B self-attention shape one bf16 call
// is 4 * Lq * (hi - lo) * D * N = 2.2e11 FLOP against ~40 MB of traffic,
// compute bound on the bf16 tensor cores (989 TFLOP/s dense, 0.227 ms); the
// int8 mode does its QK^T half at the int8 rate (1979 TOP/s) and its PV half
// in bf16, so at the 14B shape (40 heads) its bound is 0.567 ms against the
// bf16 route's 0.76. Teacher forcing at train.py's shape (2L = 18720, blocks
// of 4680, 12 heads) has 131.4 M live pairs a head of the 350.4 M a dense
// mask visits: 8.1e11 FLOP, 0.816 ms, compute bound.

#include <cuda_bf16.h>

#include "attention_mask.cuh"
#include "sm90.cuh"

namespace {

using rtv_mask::MODE_TEACHER_FORCING;

constexpr int D = 128;
constexpr int BM = 128;  // query rows per thread block: two consumer warpgroups of 64
constexpr int BN = 128;  // KV rows per tile
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int ROW_BYTES = 128;                   // one swizzled TMA box row
constexpr int BOX_HALF = BN * ROW_BYTES;         // 16 KB: 64 bf16 or 128 s8 columns of a tile
constexpr int V_TILE = 2 * BOX_HALF;             // a V tile (bf16), 32 KB
constexpr int NV = 2;                            // V ring stages
constexpr int MAX_NK = 4;
constexpr float NEG_INF = -1e30f;
constexpr float STATIC_MAX_LIMIT = 64.0f;  // exp2(s - M) is safe while M < 64
constexpr int MODE_WINDOW = 0;             // mode 1: block-causal, 2: teacher forcing

// planted faults for the checks that must catch them
constexpr int FAULT_K_SCALE_SHIFT = 2;     // int8: the last segment's columns take the
                                           // next row's k scale
constexpr int FAULT_STALE_RING_STAGE = 3;  // the last K and V ring stages hold the
                                           // previous tile's rows (a stage out of step)

// Shared-memory layout of each mode: the Q tile, the K ring (with the int8
// k scales beside it), the V ring, the barriers.
template <bool INT8>
struct Layout {
  static constexpr int Q_BYTES = INT8 ? BM * ROW_BYTES : 2 * BM * ROW_BYTES;
  static constexpr int K_TILE = INT8 ? BOX_HALF : 2 * BOX_HALF;
  static constexpr int NK = INT8 ? 4 : 2;
  static constexpr int SK = INT8 ? BN * 4 : 0;  // k scales per K stage
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + NK * K_TILE;
  static constexpr int OFF_SK = OFF_V + NV * V_TILE;
  static constexpr int OFF_BAR = OFF_SK + NK * SK;
  static constexpr int SMEM = OFF_BAR + 256 + 1024;  // barriers, and room to align to 1 KB
};

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[MAX_NK], k_empty[MAX_NK];
  uint64_t v_full[NV], v_empty[NV];
};

// 2^x by the SFU alone (results below 2^-126 flush to 0, which a softmax
// weight of that size never changes in bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// f32(x) for |x| < 2^22, exact (the value __int2float_rn gives) by an integer
// add and a float subtract of 1.5 * 2^23: full-rate instructions, where the
// I2F conversion runs at a quarter of the rate. |QK^T| of s8 rows of D = 128
// is at most 128 * 127^2 < 2^21.
__device__ __forceinline__ float s32_to_f32(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The int8 mode's arguments (unused in bf16): sq [B, N, Lq], sk rows ks_stride
// apart, and the k-mean segment width (for the planted k-scale fault).
struct Int8Args {
  const float* q_scale;
  const float* k_scale;
  int ks_stride, seg;
};

template <bool INT8, bool TF>
__global__ void __launch_bounds__(NTHREADS, 1)
attention_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_sk, __nv_bfloat16* __restrict__ o,
                      int Lq, int Lk, int N, float qscale, const float* __restrict__ maxima,
                      float* __restrict__ lse, const Int8Args i8, int mode, int lo, int hi,
                      int block_tokens, int kv_len, int local_window, int fault) {
  using L = Layout<INT8>;
  constexpr int NK = L::NK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Barriers& bars = *reinterpret_cast<Barriers*>(smem + L::OFF_BAR);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_base = blockIdx.x * BM;

  // ---- the KV range this block can see (tile-aligned start); teacher
  // forcing: two ranges (kv_len = L, the length of each half) ----
  int kv_begin, kv_end;
  rtv_mask::Tiles tiles = {};
  if constexpr (TF) {
    tiles = rtv_mask::tf_key_tiles(q_base, min(q_base + BM, Lq) - 1, kv_len, block_tokens,
                                   fault, BN);
    kv_begin = kv_end = 0;
  } else if (mode == MODE_WINDOW) {
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
  const int n_tiles = TF ? tiles.n : kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;
  // the first KV row of tile `it`
  auto tile_row = [&](int it) {
    if constexpr (TF) return tiles.row(it, BN);
    return kv_begin + it * BN;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars.q_full, 1);
    for (int s = 0; s < NK; ++s) {
      sm90::mbar_init(&bars.k_full[s], 1);
      sm90::mbar_init(&bars.k_empty[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < NV; ++s) {
      sm90::mbar_init(&bars.v_full[s], 1);
      sm90::mbar_init(&bars.v_empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ======== producers: the Q tile and the K ring; the V ring ========
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_k);
      if constexpr (INT8) sm90::prefetch_tensormap(&tm_sk);
      sm90::mbar_arrive_expect_tx(&bars.q_full, L::Q_BYTES);
      sm90::tma_load_4d(smem, &tm_q, &bars.q_full, 0, h, q_base, b);
      if constexpr (!INT8)
        sm90::tma_load_4d(smem + BM * ROW_BYTES, &tm_q, &bars.q_full, 64, h, q_base, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NK;
        int kv0 = tile_row(it);
        if (fault == FAULT_STALE_RING_STAGE && s == NK - 1 && it > 0) kv0 -= BN;
        uint8_t* ks = smem + L::OFF_K + s * L::K_TILE;
        sm90::mbar_wait(&bars.k_empty[s], ((it / NK) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.k_full[s], L::K_TILE + L::SK);
        sm90::tma_load_4d(ks, &tm_k, &bars.k_full[s], 0, h, kv0, b);
        if constexpr (INT8) {
          sm90::tma_load_2d(smem + L::OFF_SK + s * L::SK, &tm_sk, &bars.k_full[s], kv0,
                            b * N + h);
        } else {
          sm90::tma_load_4d(ks + BOX_HALF, &tm_k, &bars.k_full[s], 64, h, kv0, b);
        }
      }
    } else if (threadIdx.x == 288) {
      sm90::prefetch_tensormap(&tm_v);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NV;
        int kv0 = tile_row(it);
        if (fault == FAULT_STALE_RING_STAGE && s == NV - 1 && it > 0) kv0 -= BN;
        uint8_t* vs = smem + L::OFF_V + s * V_TILE;
        sm90::mbar_wait(&bars.v_empty[s], ((it / NV) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars.v_full[s], V_TILE);
        sm90::tma_load_4d(vs, &tm_v, &bars.v_full[s], 0, h, kv0, b);
        sm90::tma_load_4d(vs + BOX_HALF, &tm_v, &bars.v_full[s], 64, h, kv0, b);
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
    // block-causal mode, and never past Lk; teacher forcing: [0, lim_hi) and
    // [lim2_lo, lim2_hi)
    int lim_lo[2], lim_hi[2], diag[2];
    int lim2_lo[2] = {0, 0}, lim2_hi[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r ? r1 : r0;
      if constexpr (TF) {
        const rtv_mask::TfRow tr = rtv_mask::tf_row(qpos, kv_len, block_tokens, fault);
        lim_lo[r] = 0;
        lim_hi[r] = tr.a_hi;
        diag[r] = -1;
        lim2_lo[r] = tr.b_lo;
        lim2_hi[r] = tr.b_hi;
      } else if (mode == MODE_WINDOW) {
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
    if (!INT8 && maxima != nullptr && mode == MODE_WINDOW) {
      const float bound = __fadd_rn(__fmul_rn(sqrtf(__ldg(maxima)), sqrtf(__ldg(maxima + 1))),
                                    1e-3f);
      static_max = bound < STATIC_MAX_LIMIT;
      M = bound;
    }

    // int8: this thread's two rows' q scales, and where the planted k-scale
    // fault starts
    float sq[2] = {0.0f, 0.0f};
    const float* ksb = nullptr;
    int shift_from = 0x7fffffff;
    if constexpr (INT8) {
      const float* sqb = i8.q_scale + ((size_t)b * N + h) * Lq;
      sq[0] = r0 < Lq ? __ldg(sqb + r0) : 0.0f;
      sq[1] = r1 < Lq ? __ldg(sqb + r1) : 0.0f;
      ksb = i8.k_scale + ((size_t)b * N + h) * i8.ks_stride;
      if (fault == FAULT_K_SCALE_SHIFT) shift_from = ((Lk - 1) / i8.seg) * i8.seg;
    }

    // ---- Q: wait for the tile; bf16: prescale this warpgroup's 64 rows in place ----
    sm90::mbar_wait(&bars.q_full, 0);
    if constexpr (!INT8) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint8_t* rows = smem + half * BM * ROW_BYTES + wg * (BM * ROW_BYTES / 2);
#pragma unroll
        for (int i = 0; i < BM * ROW_BYTES / 2 / 16 / 128; ++i) {
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
    }

    const uint8_t* q_rows = smem + wg * (BM * ROW_BYTES / 2);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    float m_run[2] = {NEG_INF, NEG_INF};  // running max (rows r0, r1), log2 domain
    float l_part[2] = {0.0f, 0.0f};       // this thread's share of the row sums
    uint32_t pf[32];                      // P of the previous tile, bf16 A fragments
    float sc[64];                         // S of the current tile, then its p
    int si[64];                           // int8: the s32 sums of the current tile

    // S = Q K^T of tile `it` (one wgmma group)
    auto issue_qk = [&](int it) {
      const int s = it % NK;
      sm90::mbar_wait(&bars.k_full[s], (it / NK) & 1);
      const uint8_t* ks = smem + L::OFF_K + s * L::K_TILE;
      sm90::wgmma_fence();
      if constexpr (INT8) {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)
          sm90::Wgmma<128>::s8(si, sm90::desc_b128(q_rows + kk * 32, 16, 1024),
                               sm90::desc_b128(ks + kk * 32, 16, 1024), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int half = kk / 4, off = (kk % 4) * 32;
          sm90::wgmma_m64n128k16_ss(
              sc, sm90::desc_b128(q_rows + half * BM * ROW_BYTES + off, 16, 1024),
              sm90::desc_b128(ks + half * BOX_HALF + off, 16, 1024), kk > 0);
        }
      }
      sm90::wgmma_commit();
    };
    // after tile `it`'s QK^T group has completed: its scores in sc (int8:
    // f32(s32) * (sq * sk), the product of the scales first), then the K
    // stage goes back to the producer
    auto take_scores = [&](int it) {
      const int s = it % NK;
      if constexpr (INT8) {
        sm90::fence_regs(si);
        const float* sks = reinterpret_cast<const float*>(smem + L::OFF_SK + s * L::SK);
        const int kv0 = tile_row(it);
        if (kv0 + BN <= shift_from) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 sk = *reinterpret_cast<const float2*>(sks + j * 8 + tig * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = __fmul_rn(s32_to_f32(si[4 * j + e]),
                                        __fmul_rn(sq[e >> 1], (e & 1) ? sk.y : sk.x));
          }
        } else {  // the planted k-scale fault's tiles
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = j * 8 + tig * 2 + (e & 1);
              float sk = sks[col];
              if (kv0 + col >= shift_from) sk = __ldg(ksb + min(kv0 + col + 1, Lk - 1));
              sc[4 * j + e] = __fmul_rn(s32_to_f32(si[4 * j + e]), __fmul_rn(sq[e >> 1], sk));
            }
          }
        }
        __syncwarp();
      } else {
        sm90::fence_regs(sc);
      }
      if (lane == 0) sm90::mbar_arrive(&bars.k_empty[s]);
    };
    // O += P V of tile `it` (one wgmma group), P from pf
    auto issue_pv = [&](int it) {
      const int s = it % NV;
      sm90::mbar_wait(&bars.v_full[s], (it / NV) & 1);
      const uint8_t* vs = smem + L::OFF_V + s * V_TILE;
      sm90::fence_regs(acc);
      sm90::fence_regs(pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::wgmma_m64n128k16_rs_tb(
            acc, &pf[kk * 4], sm90::desc_b128(vs + kk * 16 * ROW_BYTES, BOX_HALF, 1024));
      sm90::wgmma_commit();
    };
    // mask tile `it` on the fragment (edge tiles only), then p = exp2(s - M)
    // or exp2(s - m) with the running max; alpha rescales what came before
    auto softmax = [&](int it, float (&alpha)[2]) {
      const int kv0 = tile_row(it);
      bool full_tile;
      if constexpr (TF) {
        full_tile = rtv_mask::tf_full(q_base, min(BM, Lq - q_base), kv0, BN, kv_len,
                                      block_tokens, fault);
      } else if (mode == MODE_WINDOW) {
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
            bool valid = ((col >= lim_lo[r] && col < lim_hi[r]) || col == diag[r]) && col < Lk;
            if constexpr (TF) valid = valid || (col >= lim2_lo[r] && col < lim2_hi[r]);
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
      take_scores(0);
      softmax(0, alpha);
      accumulate(alpha);
      // tile it: its QK^T and the PV of tile it-1 in flight together; the
      // scale, mask and softmax of tile it run while that PV is still being
      // computed
      for (int it = 1; it < n_tiles; ++it) {
        issue_qk(it);
        issue_pv(it - 1);
        sm90::wgmma_wait<1>();
        take_scores(it);
        softmax(it, alpha);
        sm90::wgmma_wait<0>();  // O is rescaled and P rewritten after the PV
        sm90::fence_regs(acc);
        sm90::fence_regs(pf);
        if (lane == 0) sm90::mbar_arrive(&bars.v_empty[(it - 1) % NV]);
        accumulate(alpha);
      }
      // the last tile's PV alone
      issue_pv(n_tiles - 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pf);
      if (lane == 0) sm90::mbar_arrive(&bars.v_empty[(n_tiles - 1) % NV]);
    }

    // ---- finish: reduce the row sums over the quad, normalise, store bf16 ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.0f / fmaxf(l, 1e-30f);
      // the row's log-sum-exp for the backward, natural log, from the m the
      // p were taken against (the static bound or the running max); a row
      // with no live column gets +inf, so that its recomputed p are 0
      const int row = r ? r1 : r0;
      if (lse != nullptr && tig == 0 && row < Lq)
        lse[((size_t)b * N + h) * Lq + row] =
            l > 0.0f ? ((static_max ? M : m_run[r]) + log2f(l)) * 0.6931471805599453f
                     : __int_as_float(0x7f800000);
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

// [B, nseg, N, D] f32: the mean of each seg-row segment of k (segment s holds
// rows [s*seg, (s+1)*seg)), rows past Lk counted as zeros and the sum divided
// by seg, as the TPU kernel's jnp.mean over a zero-padded sub-tile.
__global__ void __launch_bounds__(256)
attn_int8_segment_mean(const __nv_bfloat16* __restrict__ k, float* __restrict__ km, int Lk,
                       int N, int seg, int nseg) {
  constexpr int COLS = D / 2;        // bf16 pairs per row
  constexpr int PARTS = 256 / COLS;  // row groups summed side by side
  __shared__ float2 part[PARTS][COLS];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x % COLS, p = threadIdx.x / COLS;
  const int r_end = min(s * seg + seg, Lk);
  const __nv_bfloat16* base = k + ((size_t)b * Lk * N + h) * D + 2 * c;
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll 4
  for (int r = s * seg + p; r < r_end; r += PARTS) {
    float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(base + (size_t)r * N * D));
    acc.x += x.x;
    acc.y += x.y;
  }
  part[p][c] = acc;
  __syncthreads();
  if (p == 0) {
    float2 t = part[0][c];
#pragma unroll
    for (int i = 1; i < PARTS; ++i) {
      t.x += part[i][c].x;
      t.y += part[i][c].y;
    }
    float* dst = km + (((size_t)b * nseg + s) * N + h) * D + 2 * c;
    dst[0] = __fdiv_rn(t.x, (float)seg);
    dst[1] = __fdiv_rn(t.y, (float)seg);
  }
}

// Rows of D = 128 values of x [B, L, N, D], half a warp per row (8 values a
// lane) and QROWS rows a warp, their loads issued together: q rows are first
// prescaled to bf16(x * qscale) (qscale != 0, the rounding of `prescale`), k
// rows taken minus their segment's mean (km given); then s = max|x| / 127 +
// 1e-8 and x8 = rint(x / s), both IEEE-rounded, as the TPU kernel's int8_qk
// branch computes them (its quanta stay within +-127, so no clamp). The scale
// goes to [B, N, L] with rows scale_stride apart.
constexpr int QROWS = 4;
__global__ void __launch_bounds__(256)
attn_int8_quantize_rows(const __nv_bfloat16* __restrict__ x, const float* __restrict__ km,
                        int8_t* __restrict__ x8, float* __restrict__ scale, int rows, int L,
                        int N, int seg, int nseg, float qscale, int scale_stride) {
  const int lane = threadIdx.x % 32, half = lane / 16, sub = lane % 16;
  const int row0 = (blockIdx.x * 8 + threadIdx.x / 32) * QROWS;
  uint4 raw[QROWS / 2];
#pragma unroll
  for (int u = 0; u < QROWS / 2; ++u) {
    const int row = row0 + 2 * u + half;
    raw[u] = row < rows ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * D) + sub)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < QROWS / 2; ++u) {
    const int row = row0 + 2 * u + half;
    const bool live = row < rows;  // every lane takes part in the shuffles
    const int h = row % N, l = (row / N) % L, b = row / (N * L);
    const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw[u]);
    float val[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      val[i] = __bfloat162float(hv[i]);
      if (qscale != 0.0f) val[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(val[i], qscale)));
    }
    if (km != nullptr && live) {
      const float4* m = reinterpret_cast<const float4*>(
          km + (((size_t)b * nseg + l / seg) * N + h) * D + sub * 8);
      const float4 m0 = __ldg(m), m1 = __ldg(m + 1);
      const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) val[i] = __fsub_rn(val[i], mv[i]);
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(val[i]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)  // within the row's half warp
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-8f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      packed[i / 4] |= ((uint32_t)(__float2int_rn(__fdiv_rn(val[i], s)) & 0xff)) << (8 * (i % 4));
    if (!live) continue;
    *reinterpret_cast<uint2*>(x8 + (size_t)row * D + sub * 8) = make_uint2(packed[0], packed[1]);
    if (sub == 0) scale[((size_t)b * N + h) * scale_stride + l] = s;
  }
}

// [B, L, N, D] bf16 or s8 as a 4-D tensor map with a box of 128 bytes x 1
// head x `rows` rows.
int qkv_map(CUtensorMap* map, const void* ptr, int B, int L, int N, int rows, bool s8) {
  const int es = s8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * es, (cuuint64_t)N * D * es,
                                 (cuuint64_t)L * N * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)(ROW_BYTES / es), 1, (cuuint32_t)rows, 1};
  return sm90::make_tensor_map(
      map, s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims,
      strides, box);
}

template <bool INT8, bool TF>
int launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
           const CUtensorMap& tm_sk, void* o, int B, int Lq, int Lk, int N, float qscale,
           const float* maxima, float* lse, const Int8Args& i8, int mode, int lo, int hi,
           int block_tokens, int kv_len, int local_window, int fault, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(attention_kernel_sm90<INT8, TF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Layout<INT8>::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lq + BM - 1) / BM, N, B);
  attention_kernel_sm90<INT8, TF><<<grid, NTHREADS, Layout<INT8>::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_sk, reinterpret_cast<__nv_bfloat16*>(o), Lq, Lk, N, qscale, maxima,
      lse, i8, mode, lo, hi, block_tokens, kv_len, local_window, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Head dim 128 only (every Wan 2.1 DiT: t2v-1.3B and t2v-14B).

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

// The int8 QK^T pre-pass, on raw q: q8 [B, Lq, N, D] s8 with q_scale [B, N,
// Lq] f32 from bf16(q * qscale), and k8 [B, Lk, N, D] s8 with k_scale [B, N,
// Lk] f32 (rows ks_stride apart), k taken minus the mean of its seg-row
// segment (k_mean: [B, ceil(Lk / seg), N, D] f32 scratch).
extern "C" int rtv_int8_qk_quantize(const void* q, const void* k, void* q8, void* q_scale,
                                    void* k8, void* k_scale, void* k_mean, int B, int Lq,
                                    int Lk, int N, int D_, int seg, float qscale, int ks_stride,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D_ != D || seg <= 0 || qscale == 0.0f || ks_stride < Lk) return (int)cudaErrorInvalidValue;
  const int nseg = (Lk + seg - 1) / seg;
  attn_int8_segment_mean<<<dim3(nseg, N, B), 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<float*>(k_mean), Lk, N, seg,
      nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int q_rows = B * Lq * N, k_rows = B * Lk * N;
  constexpr int ROWS_PER_BLOCK = 8 * QROWS;
  attn_int8_quantize_rows<<<(q_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), nullptr, reinterpret_cast<int8_t*>(q8),
      reinterpret_cast<float*>(q_scale), q_rows, Lq, N, 1, 1, qscale, Lq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_int8_quantize_rows<<<(k_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<const float*>(k_mean),
      reinterpret_cast<int8_t*>(k8), reinterpret_cast<float*>(k_scale), k_rows, Lk, N, seg,
      nseg, 0.0f, ks_stride);
  return (int)cudaGetLastError();
}

// The bf16 kernel. q raw (the kernel multiplies it by qscale = bf16(scale *
// log2 e)), k, v, o [B, L, N, D] bf16 contiguous. mode 0 = window [lo, hi),
// with the static-max / running-max choice made on the device from maxima
// (null: running max always); mode 1 = block-causal (running max); mode 2 =
// teacher forcing over [clean | noisy] with kv_len = L, the length of each
// half (Lq = Lk = 2L, L a multiple of block_tokens; running max). lse, when
// not null, receives each row's log-sum-exp [B, N, Lq] f32 (natural log of
// the scaled scores) for the backward kernel; null writes nothing. fault
// plants a fault for the checks (0 in every real call).
extern "C" int rtv_attention_sm90(const void* q, const void* k, const void* v, void* o, int B,
                                  int Lq, int Lk, int N, int D_, float qscale, const float* maxima,
                                  float* lse, int mode, int lo, int hi, int block_tokens,
                                  int kv_len, int local_window, int fault, void* stream) {
  if (D_ != D || B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0 || block_tokens <= 0)
    return (int)cudaErrorInvalidValue;
  const bool tf = mode == MODE_TEACHER_FORCING;
  if (tf && (Lq != Lk || Lk != 2 * kv_len || kv_len % block_tokens != 0))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = qkv_map(&tm_q, q, B, Lq, N, BM, false);
  if (err == 0) err = qkv_map(&tm_k, k, B, Lk, N, BN, false);
  if (err == 0) err = qkv_map(&tm_v, v, B, Lk, N, BN, false);
  if (err != 0) return err;
  const Int8Args none = {nullptr, nullptr, 0, 1};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (tf)
    return launch<false, true>(tm_q, tm_k, tm_v, tm_v, o, B, Lq, Lk, N, qscale, nullptr, lse,
                               none, mode, lo, hi, block_tokens, kv_len, local_window, fault, s);
  return launch<false, false>(tm_q, tm_k, tm_v, tm_v, o, B, Lq, Lk, N, qscale, maxima, lse, none,
                              mode, lo, hi, block_tokens, kv_len, local_window, fault, s);
}

// The int8 QK^T kernel on the pre-pass's quanta: q8, k8 [B, L, N, D] s8,
// q_scale [B, N, Lq] and k_scale [B, N, Lk] f32 (rows ks_stride apart, a
// multiple of 4), v and o bf16; modes 0 and 1 as rtv_attention_sm90's, running
// max always. seg is the k-mean segment width (for the planted k-scale fault).
extern "C" int rtv_attention_sm90_int8(const void* q8, const void* k8, const void* v, void* o,
                                       const void* q_scale, const void* k_scale, int ks_stride,
                                       int B, int Lq, int Lk, int N, int D_, int mode, int lo,
                                       int hi, int block_tokens, int kv_len, int local_window,
                                       int seg, int fault, void* stream) {
  if (D_ != D || B <= 0 || Lq <= 0 || Lk <= 0 || N <= 0 || block_tokens <= 0 || seg <= 0 ||
      ks_stride < Lk || ks_stride % 4 || mode == MODE_TEACHER_FORCING)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_sk;
  int err = qkv_map(&tm_q, q8, B, Lq, N, BM, true);
  if (err == 0) err = qkv_map(&tm_k, k8, B, Lk, N, BN, true);
  if (err == 0) err = qkv_map(&tm_v, v, B, Lk, N, BN, false);
  if (err == 0) {  // the k scales: [B * N, Lk] f32, one BN-column box per K tile
    const cuuint64_t dims[2] = {(cuuint64_t)Lk, (cuuint64_t)B * N};
    const cuuint64_t strides[1] = {(cuuint64_t)ks_stride * 4};
    const cuuint32_t box[2] = {BN, 1};
    err = sm90::make_tensor_map(&tm_sk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, k_scale, dims,
                                strides, box, nullptr, false);
  }
  if (err != 0) return err;
  const Int8Args i8 = {reinterpret_cast<const float*>(q_scale),
                       reinterpret_cast<const float*>(k_scale), ks_stride, seg};
  return launch<true, false>(tm_q, tm_k, tm_v, tm_sk, o, B, Lq, Lk, N, 0.0f, nullptr, nullptr, i8,
                             mode, lo, hi, block_tokens, kv_len, local_window, fault,
                             reinterpret_cast<cudaStream_t>(stream));
}
