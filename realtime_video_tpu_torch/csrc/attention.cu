// Decode-window and block-causal attention for Hopper (sm_90a) with mma.sync:
// the int8 QK^T mode and the skewed KV pipeline. (The plain bf16 window and
// block-causal routes, K1 and K2, run in csrc/attention_sm90.cu, with wgmma
// and TMA; this template still holds their math for the skewed loop.)
//
// Replaces the Pallas TPU kernels of realtime_video_tpu/ops/pallas_attention.py:
//   * _staticmax_kernel (K1): softmax over KV columns in [lo, hi) with a static
//     logit bound M in place of the running max (no rescale chain);
//   * _flash_kernel (K2): online-softmax flash attention, in `window` mode (K1's
//     fallback when M >= 64) and in `block_causal` mode
//     (kv < min(ends[q], kv_len), optional local window, plus the diagonal);
//   * _flash_kernel's int8_qk branch (K2-int8, RTV_ATTN_INT8): QK^T on s8
//     quanta of q and of k minus its per-segment mean, s32 sums scaled to f32
//     by sq * sk; the softmax and PV as K2;
//   * _skew_kernel (K6a, RTV_ATTN_SKEW) and _staticmax_skew_kernel (K6b,
//     RTV_ATTN_SKEW2): K2's and K1's window math with V lagging K by one step.
// One kernel template serves them all; the launches it takes are the int8
// mode and the skewed loop. In window mode the kernel reads M from
// device memory and every thread block chooses static-max (M < 64) or
// running-max itself, so the host never waits on the device to pick a path.
//
// q arrives pre-scaled by softmax_scale * log2(e), so scores are already in
// the log2 domain and the kernel exponentiates with exp2.
//
// Layout: q/o [B, Lq, N, D], k/v [B, Lk, N, D], contiguous (the JAX package's
// public layout). A thread block owns BM query rows of one (batch, head) and
// walks the KV tiles inside its live range; rows and columns past the ragged
// end are masked in the kernel (out-of-range K/V rows load as zeros), so no
// padded copy is ever made.
//
// What bounds it on an H100: at the serving shape (Lq 4680, Lk 9360 with the
// live columns [1560, 9360), 12 heads, D 128) one call is 4*Lq*(hi-lo)*D*N =
// 2.2e11 FLOP against ~40 MB of K/V/Q traffic, over 5000 FLOP per byte, so it
// is compute-bound on the tensor cores. The design keeps S and P in registers
// (the QK^T accumulator fragment is re-packed as the A operand of PV, the
// FlashAttention-2 register layout), uses mma.sync m16n8k16 (bf16) or
// m16n8k32 (s8) for QK^T and bf16 m16n8k16 for PV, and prefetches the K/V
// tiles into shared memory with cp.async so the next tile's copy overlaps this
// tile's math. wgmma, TMA and warp specialisation would raise the tensor-core
// rate further.
//
// The int8 mode: a pre-pass (attn_int8_segment_mean, attn_int8_quantize_rows)
// writes s8 q and k with their f32 row scales, then the main kernel runs on
// them. What it must reproduce is the TPU kernel's arithmetic, not
// SageAttention's: the mean of k is taken over each `seg`-row segment of the
// KV buffer (the TPU kernel's bk-wide compute sub-tile, from row 0), zero pad
// rows included, so the result depends on seg; scales are max|row| / 127 +
// 1e-8, quanta rint(x / s) with an IEEE divide (the build uses no
// fast-math), and the score is float(s32) * (sq * sk) in f32.
//
// The skewed loop: the QK^T of tile j+1 is issued before the exp2, row sum
// and PV of tile j, the two score tiles held in registers, which is the
// Hopper form of the TPU kernels' "V lags K by one grid step" (there the
// scores spill to a double-buffered VMEM scratch). The copy ring then needs
// three stages; the last iteration is the drain step, with no next tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per thread block (4 warps x 16)
constexpr int BN = 64;        // KV columns per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPAD = 8;       // bf16 pad per smem row: conflict-free fragment loads
constexpr int PAD8 = 16;      // byte pad per s8 K row, for the same reason
constexpr float NEG_INF = -1e30f;
constexpr float STATIC_MAX_LIMIT = 64.0f;  // exp2(s - M) is safe while M < 64

constexpr int MODE_WINDOW = 0;  // mode 1: block-causal

// planted faults for the checks that must catch them
constexpr int FAULT_SKIP_DRAIN = 1;     // skewed loop: the last tile's exp2/PV step dropped
constexpr int FAULT_K_SCALE_SHIFT = 2;  // int8: the last segment's columns take the
                                        // next row's k scale

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 smem bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Bytes of one K or V tile in shared memory (bf16 rows of D + SPAD; an s8 K
// tile, D + PAD8 bytes a row plus BN f32 scales, fits in the same room).
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return BN * (D + SPAD) * (int)sizeof(__nv_bfloat16);
}

// Copy bf16 rows [kv0, kv0 + BN) of one head into a [BN][D + SPAD] smem tile.
template <int D>
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int kv0, int Lk, int row_stride) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < BN * CHUNKS; c += NTHREADS) {
    int r = c / CHUNKS;
    int col = (c % CHUNKS) * 8;
    int kv = kv0 + r;
    bool valid = kv < Lk;
    const __nv_bfloat16* g = src + (size_t)(valid ? kv : 0) * row_stride + col;
    cp_async16(dst + r * (D + SPAD) + col, g, valid);
  }
}

// One pipeline stage: the K tile (bf16, or s8 with its row scales) and the V tile.
template <int D, bool INT8>
__device__ __forceinline__ void load_stage(unsigned char* st, const void* kb,
                                           const __nv_bfloat16* vb, const float* ksb,
                                           int kv0, int Lk, int row_stride, int shift_from) {
  if constexpr (INT8) {
    constexpr int CHUNKS = D / 16;
    const int8_t* k8 = reinterpret_cast<const int8_t*>(kb);
    for (int c = threadIdx.x; c < BN * CHUNKS; c += NTHREADS) {
      int r = c / CHUNKS;
      int col = (c % CHUNKS) * 16;
      int kv = kv0 + r;
      bool valid = kv < Lk;
      cp_async16(st + r * (D + PAD8) + col, k8 + (size_t)(valid ? kv : 0) * row_stride + col,
                 valid);
    }
    float* sks = reinterpret_cast<float*>(st + BN * (D + PAD8));
    for (int r = threadIdx.x; r < BN; r += NTHREADS) {
      int kv = kv0 + r;
      int src = kv >= shift_from ? min(kv + 1, Lk - 1) : kv;
      cp_async4(sks + r, ksb + (kv < Lk ? src : 0), kv < Lk);
    }
  } else {
    load_bf16_tile<D>(reinterpret_cast<__nv_bfloat16*>(st),
                      reinterpret_cast<const __nv_bfloat16*>(kb), kv0, Lk, row_stride);
  }
  load_bf16_tile<D>(reinterpret_cast<__nv_bfloat16*>(st + tile_bytes<D>()), vb, kv0, Lk,
                    row_stride);
}

// S = Q K^T for this warp's 16 rows x BN columns of the tile in stage `st`.
template <int D, bool INT8, int QSTEPS>
__device__ __forceinline__ void qk_tile(float (&s)[BN / 8][4], const uint32_t (&qf)[QSTEPS][4],
                                        const float (&sq)[2], const unsigned char* st, int g,
                                        int tig) {
  if constexpr (INT8) {
    const float* sks = reinterpret_cast<const float*>(st + BN * (D + PAD8));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      int c32[4] = {0, 0, 0, 0};
      const unsigned char* krow = st + (j * 8 + g) * (D + PAD8);
#pragma unroll
      for (int kk = 0; kk < QSTEPS; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 32 + tig * 4);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 32 + 16 + tig * 4);
        mma_s8(c32, qf[kk], b0, b1);
      }
      // float(s32) * (sq * sk): the TPU kernel's order; |s32| < 2^24 converts exactly
      const float sk0 = sks[j * 8 + tig * 2], sk1 = sks[j * 8 + tig * 2 + 1];
      s[j][0] = __fmul_rn(__int2float_rn(c32[0]), __fmul_rn(sq[0], sk0));
      s[j][1] = __fmul_rn(__int2float_rn(c32[1]), __fmul_rn(sq[0], sk1));
      s[j][2] = __fmul_rn(__int2float_rn(c32[2]), __fmul_rn(sq[1], sk0));
      s[j][3] = __fmul_rn(__int2float_rn(c32[3]), __fmul_rn(sq[1], sk1));
    }
  } else {
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const __nv_bfloat16* krow = ks + (j * 8 + g) * (D + SPAD);
#pragma unroll
      for (int kk = 0; kk < QSTEPS; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + tig * 2);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8 + tig * 2);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }
  }
}

struct Mask {
  int mode, lo, hi, block_tokens, kv_len, local_window, Lk;
};

// Invalid columns of the tile starting at kv0 become NEG_INF (select, after scaling).
__device__ __forceinline__ void mask_tile(float (&s)[BN / 8][4], const Mask& mk, int kv0,
                                          int r0, int r1, int tig) {
  const bool full_tile = (mk.mode == MODE_WINDOW) && kv0 >= mk.lo && kv0 + BN <= mk.hi;
  if (full_tile) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int col = kv0 + j * 8 + tig * 2 + (e & 1);
      int qpos = (e < 2) ? r0 : r1;
      bool valid;
      if (mk.mode == MODE_WINDOW) {
        valid = col >= mk.lo && col < mk.hi;
      } else {
        int end = (qpos / mk.block_tokens + 1) * mk.block_tokens;
        valid = col < min(end, mk.kv_len);
        if (mk.local_window > 0) valid = valid && col >= end - mk.local_window;
        valid = (valid || qpos == col) && col < mk.Lk;
      }
      if (!valid) s[j][e] = NEG_INF;
    }
  }
}

// p = exp2(s - M) (static) or exp2(s - m) with the running max and its alpha
// corrections; l += rowsum(p); acc += bf16(P) V, S re-packed as the A operand.
template <int D>
__device__ __forceinline__ void softmax_pv(float (&s)[BN / 8][4], float (&acc)[D / 8][4],
                                           float (&m_run)[2], float (&l_part)[2],
                                           bool static_max, float M,
                                           const __nv_bfloat16* vs, int g, int tig) {
  if (static_max) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = s[j][e] > 0.5f * NEG_INF ? exp2f(s[j][e] - M) : 0.0f;
        s[j][e] = p;
        l_part[e >> 1] += p;
      }
    }
  } else {
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[j][0], s[j][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_new = fmaxf(m_run[r], tmax[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_part[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = s[j][e] > 0.5f * NEG_INF ? exp2f(s[j][e] - m_run[e >> 1]) : 0.0f;
        s[j][e] = p;
        l_part[e >> 1] += p;
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < BN / 16; ++jj) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * jj][0], s[2 * jj][1]);
    pa[1] = pack_bf16(s[2 * jj][2], s[2 * jj][3]);
    pa[2] = pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]);
    pa[3] = pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3]);
    const __nv_bfloat16* v0 = vs + (jj * 16 + tig * 2) * (D + SPAD);
    const __nv_bfloat16* v1 = v0 + (D + SPAD);
    const __nv_bfloat16* v8 = v0 + 8 * (D + SPAD);
    const __nv_bfloat16* v9 = v0 + 9 * (D + SPAD);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      int c = dn * 8 + g;
      uint32_t b0 = pack_bf16_raw(v0[c], v1[c]);
      uint32_t b1 = pack_bf16_raw(v8[c], v9[c]);
      mma_bf16(acc[dn], pa, b0, b1);
    }
  }
}

// q/k: bf16, or (INT8) the s8 quanta with q_scale [B, N, Lq] and k_scale
// [B, N, Lk]; v bf16. SKEW runs the skewed three-stage loop.
template <int D, bool INT8, bool SKEW>
__global__ void __launch_bounds__(NTHREADS, 2)
attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                 int Lq, int Lk, int N, const float* __restrict__ m_bound, int mode,
                 int lo, int hi, int block_tokens, int kv_len, int local_window, int seg,
                 int fault) {
  constexpr int QSTEPS = INT8 ? D / 32 : D / 16;
  constexpr int HALF = tile_bytes<D>();
  constexpr int STAGE = 2 * HALF;  // K tile then V tile
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_base = blockIdx.x * BM;
  const int row_stride = N * D;  // elements (bf16) or bytes (s8) per sequence row

  const size_t q_off = ((size_t)b * Lq * N + h) * D;
  const size_t k_off = ((size_t)b * Lk * N + h) * D;
  const void* kb = INT8 ? (const void*)(reinterpret_cast<const int8_t*>(k) + k_off)
                        : (const void*)(reinterpret_cast<const __nv_bfloat16*>(k) + k_off);
  const __nv_bfloat16* vb = v + k_off;
  const float* ksb = INT8 ? k_scale + ((size_t)b * N + h) * Lk : nullptr;
  __nv_bfloat16* ob = o + q_off;
  const int shift_from =
      (INT8 && fault == FAULT_K_SCALE_SHIFT) ? ((Lk - 1) / seg) * seg : 0x7fffffff;

  // ---- the KV range this block can see ----
  int kv_begin, kv_end;
  if (mode == MODE_WINDOW) {
    kv_begin = lo;
    kv_end = hi;
  } else {
    int q_last = min(q_base + BM, Lq) - 1;
    int end_max = (q_last / block_tokens + 1) * block_tokens;
    kv_end = max(min(end_max, kv_len), q_last + 1);  // the diagonal may pass kv_len
    kv_begin = 0;
    if (local_window > 0) {
      int end_min = (q_base / block_tokens + 1) * block_tokens;
      kv_begin = min(max(end_min - local_window, 0), q_base);
    }
  }
  kv_end = min(kv_end, Lk);
  kv_begin = (max(kv_begin, 0) / BN) * BN;
  const Mask mk{mode, lo, hi, block_tokens, kv_len, local_window, Lk};

  const bool static_max =
      m_bound != nullptr && mode == MODE_WINDOW && __ldg(m_bound) < STATIC_MAX_LIMIT;
  const float M = static_max ? __ldg(m_bound) : 0.0f;

  // ---- Q fragments for this warp's 16 rows, kept in registers ----
  const int r0 = q_base + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[QSTEPS][4];
  float sq[2] = {0.0f, 0.0f};
  if constexpr (INT8) {
    const int8_t* qb = reinterpret_cast<const int8_t*>(q) + q_off;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * row_stride);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * row_stride);
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk) {
      int c0 = kk * 32 + tig * 4;
      qf[kk][0] = r0 < Lq ? p0[c0 / 4] : 0u;
      qf[kk][1] = r1 < Lq ? p1[c0 / 4] : 0u;
      qf[kk][2] = r0 < Lq ? p0[(c0 + 16) / 4] : 0u;
      qf[kk][3] = r1 < Lq ? p1[(c0 + 16) / 4] : 0u;
    }
    const float* sqb = q_scale + ((size_t)b * N + h) * Lq;
    sq[0] = r0 < Lq ? sqb[r0] : 0.0f;
    sq[1] = r1 < Lq ? sqb[r1] : 0.0f;
  } else {
    const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(q) + q_off;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * row_stride);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * row_stride);
#pragma unroll
    for (int kk = 0; kk < QSTEPS; ++kk) {
      int c0 = kk * 16 + tig * 2;
      qf[kk][0] = r0 < Lq ? p0[c0 / 2] : 0u;
      qf[kk][1] = r1 < Lq ? p1[c0 / 2] : 0u;
      qf[kk][2] = r0 < Lq ? p0[(c0 + 8) / 2] : 0u;
      qf[kk][3] = r1 < Lq ? p1[(c0 + 8) / 2] : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};  // running max (rows r0, r1), log2 domain
  float l_part[2] = {0.0f, 0.0f};       // this thread's share of the row sums

  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;
  constexpr int NSTAGES = SKEW ? 3 : 2;  // tile t lives in stage t % NSTAGES

  if constexpr (!SKEW) {
    // two stages: tile it+1 copies while tile it computes
    if (n_tiles > 0)
      load_stage<D, INT8>(smem, kb, vb, ksb, kv_begin, Lk, row_stride, shift_from);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int kv0 = kv_begin + it * BN;
      if (it + 1 < n_tiles)
        load_stage<D, INT8>(smem + ((it + 1) % NSTAGES) * STAGE, kb, vb, ksb, kv0 + BN, Lk,
                            row_stride, shift_from);
      cp_async_commit();
      cp_async_wait_1();
      __syncthreads();
      const unsigned char* st = smem + (it % NSTAGES) * STAGE;
      float s[BN / 8][4];
      qk_tile<D, INT8, QSTEPS>(s, qf, sq, st, g, tig);
      mask_tile(s, mk, kv0, r0, r1, tig);
      softmax_pv<D>(s, acc, m_run, l_part, static_max, M,
                    reinterpret_cast<const __nv_bfloat16*>(st + HALF), g, tig);
      __syncthreads();  // this stage is refilled by the next iteration's prefetch
    }
  } else {
    // three stages: tile it+2 copies while tile it+1's QK^T (phase A) and
    // tile it's exp2 / row sum / PV (phase B) compute
    float s_cur[BN / 8][4];
    if (n_tiles > 0)
      load_stage<D, INT8>(smem, kb, vb, ksb, kv_begin, Lk, row_stride, shift_from);
    cp_async_commit();
    if (n_tiles > 1)
      load_stage<D, INT8>(smem + STAGE, kb, vb, ksb, kv_begin + BN, Lk, row_stride,
                          shift_from);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    if (n_tiles > 0) {
      qk_tile<D, INT8, QSTEPS>(s_cur, qf, sq, smem, g, tig);
      mask_tile(s_cur, mk, kv_begin, r0, r1, tig);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int kv0 = kv_begin + it * BN;
      if (it + 2 < n_tiles)  // into the stage that tile it-1 left
        load_stage<D, INT8>(smem + ((it + 2) % NSTAGES) * STAGE, kb, vb, ksb, kv0 + 2 * BN,
                            Lk, row_stride, shift_from);
      cp_async_commit();
      cp_async_wait_1();  // tile it+1 has landed
      __syncthreads();
      const bool drain = it + 1 == n_tiles;  // no next tile: phase B alone
      float s_next[BN / 8][4];
      if (!drain) {
        qk_tile<D, INT8, QSTEPS>(s_next, qf, sq, smem + ((it + 1) % NSTAGES) * STAGE, g,
                                 tig);
        mask_tile(s_next, mk, kv0 + BN, r0, r1, tig);
      }
      if (!(drain && fault == FAULT_SKIP_DRAIN))
        softmax_pv<D>(s_cur, acc, m_run, l_part, static_max, M,
                      reinterpret_cast<const __nv_bfloat16*>(
                          smem + (it % NSTAGES) * STAGE + HALF),
                      g, tig);
      if (!drain) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s_cur[j][e] = s_next[j][e];
        }
      }
      __syncthreads();  // this stage is refilled by the next iteration's prefetch
    }
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
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    int c = dn * 8 + tig * 2;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * row_stride + c) =
          pack_bf16(acc[dn][0] * inv[0], acc[dn][1] * inv[0]);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * row_stride + c) =
          pack_bf16(acc[dn][2] * inv[1], acc[dn][3] * inv[1]);
  }
}

// [B, nseg, N, D] f32: the mean of each seg-row segment of k (segment s holds
// rows [s*seg, (s+1)*seg)), rows past Lk counted as zeros and the sum divided
// by seg, as the TPU kernel's jnp.mean over a zero-padded sub-tile.
template <int D>
__global__ void __launch_bounds__(256)
attn_int8_segment_mean(const __nv_bfloat16* __restrict__ k, float* __restrict__ km, int Lk,
                       int N, int seg, int nseg) {
  constexpr int COLS = D / 2;             // bf16 pairs per row
  constexpr int PARTS = 256 / COLS;       // row groups summed side by side
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

// One warp per row of D = 128 values of x [B, L, N, D] (minus its segment's
// mean when km is given): s = max|x| / 127 + 1e-8 and x8 = rint(x / s), both
// operations IEEE-rounded, as the TPU kernel's int8_qk branch computes them
// (its quanta stay within +-127, so no clamp). The scale goes to [B, N, L].
template <int D>
__global__ void __launch_bounds__(256)
attn_int8_quantize_rows(const __nv_bfloat16* __restrict__ x, const float* __restrict__ km,
                        int8_t* __restrict__ x8, float* __restrict__ scale, int rows, int L,
                        int N, int seg, int nseg) {
  static_assert(D == 128, "one warp holds a row as 32 x 4 values");
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = row % N;
  const int l = (row / N) % L;
  const int b = row / (N * L);
  const uint2 raw = *reinterpret_cast<const uint2*>(x + (size_t)row * D + lane * 4);
  const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&raw);
  float val[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) val[i] = __bfloat162float(hv[i]);
  if (km != nullptr) {
    const float* m = km + (((size_t)b * nseg + l / seg) * N + h) * D + lane * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) val[i] = __fsub_rn(val[i], m[i]);
  }
  float amax = fmaxf(fmaxf(fabsf(val[0]), fabsf(val[1])), fmaxf(fabsf(val[2]), fabsf(val[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fadd_rn(__fdiv_rn(amax, 127.0f), 1e-8f);
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    packed |= ((uint32_t)(__float2int_rn(__fdiv_rn(val[i], s)) & 0xff)) << (8 * i);
  *reinterpret_cast<uint32_t*>(x8 + (size_t)row * D + lane * 4) = packed;
  if (lane == 0) scale[((size_t)b * N + h) * L + l] = s;
}

template <int D, bool INT8, bool SKEW>
int launch(const void* q, const void* k, const void* v, void* o, const float* q_scale,
           const float* k_scale, int B, int Lq, int Lk, int N, const float* m_bound,
           int mode, int lo, int hi, int block_tokens, int kv_len, int local_window, int seg,
           int fault, cudaStream_t stream) {
  const int smem_bytes = (SKEW ? 3 : 2) * 2 * tile_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<D, INT8, SKEW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BM - 1) / BM, N, B);
  attention_kernel<D, INT8, SKEW><<<grid, NTHREADS, smem_bytes, stream>>>(
      q, k, reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o),
      q_scale, k_scale, Lq, Lk, N, m_bound, mode, lo, hi, block_tokens, kv_len,
      local_window, seg, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Head dim 128 only (every Wan 2.1 DiT: t2v-1.3B and t2v-14B).

// The int8 QK^T pre-pass: q8 [B, Lq, N, D] s8 with q_scale [B, N, Lq] f32, and
// k8 [B, Lk, N, D] s8 with k_scale [B, N, Lk] f32, k taken minus the mean of
// its seg-row segment (k_mean: [B, ceil(Lk / seg), N, D] f32 scratch).
extern "C" int rtv_int8_qk_quantize(const void* q, const void* k, void* q8, void* q_scale,
                                    void* k8, void* k_scale, void* k_mean, int B, int Lq,
                                    int Lk, int N, int D, int seg, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D != 128 || seg <= 0) return (int)cudaErrorInvalidValue;
  const int nseg = (Lk + seg - 1) / seg;
  attn_int8_segment_mean<128><<<dim3(nseg, N, B), 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<float*>(k_mean), Lk, N,
      seg, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int q_rows = B * Lq * N, k_rows = B * Lk * N;
  attn_int8_quantize_rows<128><<<(q_rows + 7) / 8, 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), nullptr, reinterpret_cast<int8_t*>(q8),
      reinterpret_cast<float*>(q_scale), q_rows, Lq, N, 1, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_int8_quantize_rows<128><<<(k_rows + 7) / 8, 256, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(k), reinterpret_cast<const float*>(k_mean),
      reinterpret_cast<int8_t*>(k8), reinterpret_cast<float*>(k_scale), k_rows, Lk, N, seg,
      nseg);
  return (int)cudaGetLastError();
}

// The attention kernel. mode 0 = window [lo, hi), with the device-side
// static-max / running-max choice read from m_bound (null: running max
// always); mode 1 = block-causal (running max; m_bound unused). int8 = 1: q
// and k are the pre-pass's s8 quanta with their scales (running max only);
// skew = 1: the skewed loop (bf16 only). One of the two must be set: the
// plain bf16 routes run in csrc/attention_sm90.cu. seg is the int8 mean's
// segment width; fault plants a fault for the checks (0 in every real call).
extern "C" int rtv_attention(const void* q, const void* k, const void* v, void* o,
                             const void* q_scale, const void* k_scale, int B, int Lq, int Lk,
                             int N, int D, const float* m_bound, int mode, int lo, int hi,
                             int block_tokens, int kv_len, int local_window, int int8,
                             int skew, int seg, int fault, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D != 128 || (int8 && (skew || seg <= 0)) || !(int8 || skew))
    return (int)cudaErrorInvalidValue;
  const float* qs = reinterpret_cast<const float*>(q_scale);
  const float* ks = reinterpret_cast<const float*>(k_scale);
  if (int8)
    return launch<128, true, false>(q, k, v, o, qs, ks, B, Lq, Lk, N, nullptr, mode, lo, hi,
                                    block_tokens, kv_len, local_window, seg, fault, s);
  return launch<128, false, true>(q, k, v, o, qs, ks, B, Lq, Lk, N, m_bound, mode, lo, hi,
                                  block_tokens, kv_len, local_window, seg, fault, s);
}
