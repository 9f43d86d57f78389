// Decode-window and block-causal attention for Hopper (sm_90a), bf16 in,
// f32 accumulate, bf16 out.
//
// Replaces two Pallas TPU kernels of realtime_video_tpu/ops/pallas_attention.py:
//   * _staticmax_kernel (K1): softmax over KV columns in [lo, hi) with a static
//     logit bound M in place of the running max (no rescale chain);
//   * _flash_kernel (K2): online-softmax flash attention, in `window` mode (K1's
//     fallback when M >= 64) and in `block_causal` mode
//     (kv < min(ends[q], kv_len), optional local window, plus the diagonal).
// One launch serves both: the kernel reads M from device memory and every
// thread block chooses static-max (M < 64) or running-max itself, so the host
// never waits on the device to pick a path.
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
// is compute-bound on the tensor
// cores. The design keeps S and P in registers (the QK^T accumulator fragment
// is re-packed as the A operand of PV, the FlashAttention-2 register layout),
// uses bf16 mma.sync m16n8k16 for both products, and double-buffers the K/V
// tiles in shared memory with cp.async so the next tile's copy overlaps this
// tile's math. wgmma, TMA and warp specialisation would raise the tensor-core
// rate further.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per thread block (4 warps x 16)
constexpr int BN = 64;        // KV columns per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SPAD = 8;       // bf16 pad per smem row: conflict-free fragment loads
constexpr float NEG_INF = -1e30f;
constexpr float STATIC_MAX_LIMIT = 64.0f;  // exp2(s - M) is safe while M < 64

constexpr int MODE_WINDOW = 0;
constexpr int MODE_BLOCK_CAUSAL = 1;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy KV rows [kv0, kv0 + BN) of head h into a [BN][D + SPAD] smem tile.
template <int D>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
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

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int Lq, int Lk, int N, const float* __restrict__ m_bound, int mode,
                 int lo, int hi, int block_tokens, int kv_len, int local_window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int TILE = BN * (D + SPAD);
  // stage s: K at smem + 2*s*TILE, V at smem + (2*s + 1)*TILE

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // fragment row group
  const int tig = lane % 4;  // thread in group
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_base = blockIdx.x * BM;
  const int row_stride = N * D;

  const __nv_bfloat16* qb = q + ((size_t)b * Lq * N + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Lk * N + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Lk * N + h) * D;
  __nv_bfloat16* ob = o + ((size_t)b * Lq * N + h) * D;

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

  const bool static_max = (mode == MODE_WINDOW) && (__ldg(m_bound) < STATIC_MAX_LIMIT);
  const float M = static_max ? __ldg(m_bound) : 0.0f;

  // ---- Q fragments for this warp's 16 rows, kept in registers ----
  const int r0 = q_base + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    int c0 = kk * 16 + tig * 2;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(qb + (size_t)r0 * row_stride);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(qb + (size_t)r1 * row_stride);
    qf[kk][0] = r0 < Lq ? p0[c0 / 2] : 0u;
    qf[kk][1] = r1 < Lq ? p1[c0 / 2] : 0u;
    qf[kk][2] = r0 < Lq ? p0[(c0 + 8) / 2] : 0u;
    qf[kk][3] = r1 < Lq ? p1[(c0 + 8) / 2] : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};  // running max (rows r0, r1), log2 domain
  float l_part[2] = {0.0f, 0.0f};       // this thread's share of the row sums

  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;
  if (n_tiles > 0) {
    load_kv_tile<D>(smem, kb, kv_begin, Lk, row_stride);
    load_kv_tile<D>(smem + TILE, vb, kv_begin, Lk, row_stride);
  }
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * BN;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      __nv_bfloat16* nxt = smem + 2 * (stage ^ 1) * TILE;
      load_kv_tile<D>(nxt, kb, kv0 + BN, Lk, row_stride);
      load_kv_tile<D>(nxt + TILE, vb, kv0 + BN, Lk, row_stride);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();

    const __nv_bfloat16* ks = smem + 2 * stage * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    // ---- S = Q K^T for this warp's 16 rows x BN columns ----
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const __nv_bfloat16* krow = ks + (j * 8 + g) * (D + SPAD);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + tig * 2);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8 + tig * 2);
        mma_bf16(s[j], qf[kk], b0, b1);
      }
    }

    // ---- mask: column validity per row ----
    const bool full_tile = (mode == MODE_WINDOW) && kv0 >= lo && kv0 + BN <= hi;
    if (!full_tile) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int col = kv0 + j * 8 + tig * 2 + (e & 1);
          int qpos = (e < 2) ? r0 : r1;
          bool valid;
          if (mode == MODE_WINDOW) {
            valid = col >= lo && col < hi;
          } else {
            int end = (qpos / block_tokens + 1) * block_tokens;
            valid = col < min(end, kv_len);
            if (local_window > 0) valid = valid && col >= end - local_window;
            valid = (valid || qpos == col) && col < Lk;
          }
          if (!valid) s[j][e] = NEG_INF;
        }
      }
    }

    // ---- softmax numerator: p = exp2(s - M) (static) or exp2(s - m) (running) ----
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

    // ---- acc += P V: the S accumulator re-packed as the A operand ----
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
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Lq, int Lk,
           int N, const float* m_bound, int mode, int lo, int hi, int block_tokens,
           int kv_len, int local_window, cudaStream_t stream) {
  const int smem_bytes = 4 * BN * (D + SPAD) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + BM - 1) / BM, N, B);
  attention_kernel<D><<<grid, NTHREADS, smem_bytes, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o), Lq,
      Lk, N, m_bound, mode, lo, hi, block_tokens, kv_len, local_window);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// mode 0 = window [lo, hi) with the device-side static-max / running-max
// choice read from m_bound; mode 1 = block-causal (running max; m_bound unused).
// Head dim 128 only (every Wan 2.1 DiT: t2v-1.3B and t2v-14B).
extern "C" int rtv_attention(const void* q, const void* k, const void* v, void* o, int B,
                             int Lq, int Lk, int N, int D, const float* m_bound, int mode,
                             int lo, int hi, int block_tokens, int kv_len,
                             int local_window, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Lq, Lk, N, m_bound, mode, lo, hi, block_tokens,
                       kv_len, local_window, s);
  return (int)cudaErrorInvalidValue;
}
