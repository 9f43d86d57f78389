// kt x 3 x 3 convolution for Hopper (sm_90a) as an implicit GEMM, in two modes:
//   * s8 x s8 -> s32 (mma.sync m16n8k32): the int8 VAE tier; the caller
//     dequantises (models/vae.py::_int8_conv);
//   * bf16 x bf16 -> f32 accumulate, + optional bias, -> bf16 (m16n8k16).
//
// Replaces two Pallas TPU kernels: realtime_video_tpu/ops/pallas_conv2.py
// `_kernel` (K4: a 3x3 stride-1 VALID conv over a pre-padded input whose
// temporal taps the caller concatenated into channels) and
// realtime_video_tpu/ops/pallas_conv.py `_conv_kernel` (K5: the kt x 3 x 3
// form with bias, temporal taps inside the kernel). Here K5 is K4's kt > 1
// form: the kernel reads the kt input frames of each output frame itself, so
// the 3C-wide tap concat of models/vae.py::conv3d is never written, and it
// pads and strides itself, so no padded copy is written either.
//
//   x [T, H, W, C] (channels last), w [kt, 3, 3, C, Co] (the JAX layout),
//   y [T - kt + 1, Ho, Wo, Co], Ho = (H + ph0 + ph1 - 3) / sh + 1 (same for W),
//   y[t, i, j, o] = sum_{dt, dy, dx, c} x[t + dt, i*sh + dy - ph0, j*sw + dx - pw0, c]
//                   * w[dt, dy, dx, c, o], reading zeros outside the frame.
//
// GEMM view: rows are output pixels (BM = 128 per block), columns are output
// channels (BN = 64; 96 when Co is a multiple of 96; 32 when Co <= 32, as for
// the decoder's 3-channel head), and the reduction
// runs over kt*9 taps x C channels in chunks of 32 bytes (32 s8 or 16 bf16
// channels), two chunks per pipeline stage. A chunk's rows are gathered from
// the input by per-row offsets (halo and padding rows load as zeros through
// cp.async's zero-fill); ragged C and Co are zero-filled in shared memory, so
// C = 3 (the encoder's first conv), C = 16 (the decoder's) and Co = 3 (the
// decoder's head) need no padded copy either. In s8 mode the sums are exact
// for every C: no bf16 dot, no C <= 1040 gate, no +-127 caveat
// (pallas_conv2.py:116-120).
//
// Operand layout: A rows are channel-contiguous and go to ldmatrix as they
// are. w is Co-contiguous: in bf16 mode ldmatrix.trans transposes it; in s8
// mode (ldmatrix.trans does not transpose 8-bit elements) a thread loads 4
// rows x 16 bytes of w, transposes them 4 x 4 bytes at a time in registers and
// stores them into a [co][k] tile.
//
// What bounds it on an H100: the decoder's widest convs (C 96 -> 96 at
// 480x832, kt 3, 4 frames) do 2*M*K*N = 0.8 TOP against ~0.9 GB of traffic
// (s8 in, s32 out), about 900 operations per byte, so the int8 tensor cores
// bound them; the low-resolution convs (60x104, C 384) are smaller and bound
// by operations too. This first version uses mma.sync with a double buffer
// (cp.async for the gathered input, registers for the transposed weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;
constexpr int ROW = 80;  // bytes per smem row of the k-contiguous tiles (64 + 16 pad)

constexpr int FAULT_ZERO_HALO_ROW = 1;    // planted faults for the checks
constexpr int FAULT_DROP_LAST_CI_CHUNK = 2;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 smem bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 4x4 byte transpose: byte c of in[j] -> byte j of out[c].
__device__ __forceinline__ void transpose4x4(const uint32_t* in, uint32_t* out) {
  uint32_t lo01 = __byte_perm(in[0], in[1], 0x5140);
  uint32_t hi01 = __byte_perm(in[0], in[1], 0x7362);
  uint32_t lo23 = __byte_perm(in[2], in[3], 0x5140);
  uint32_t hi23 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float load_bias(const void* bias, int kind, int n) {
  if (kind == 1) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(bias)[n]);
  if (kind == 2) return reinterpret_cast<const float*>(bias)[n];
  return 0.0f;
}

template <typename T>
__device__ __forceinline__ T zero_elem();
template <>
__device__ __forceinline__ int8_t zero_elem<int8_t>() { return 0; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// One 32-byte reduction chunk: a tap (dt, dy, dx) and a channel offset.
struct Chunk {
  int tap, dt, dy, dx, c0;
  bool ok;
};

__device__ __forceinline__ Chunk chunk_of(int q, int Q, int nc, int ch, int fault) {
  Chunk k;
  int tap = q / nc, ci = q % nc;
  k.ok = q < Q && !(fault == FAULT_DROP_LAST_CI_CHUNK && ci == nc - 1);
  k.tap = tap;
  k.dt = tap / 9;
  k.dy = (tap / 3) % 3;
  k.dx = tap % 3;
  k.c0 = ci * ch;
  return k;
}

template <bool INT8, int NWN>
__global__ void __launch_bounds__(128 * NWN)
conv_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
            const void* __restrict__ bias, int bias_kind, void* __restrict__ outv, int T,
            int H, int W, int C, int Co, int kt, int Ho, int Wo, int sh, int sw, int ph0,
            int pw0, int fault) {
  using Elem = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int BN = 32 * NWN;
  constexpr int NT = 128 * NWN;        // 4 warps (m) x NWN warps (n), 32 x 32 each
  constexpr int ES = sizeof(Elem);
  constexpr int CH = 32 / ES;          // channels per 32-byte reduction chunk
  constexpr int E16 = 16 / ES;         // elements per 16-byte piece
  constexpr int BROW = INT8 ? ROW : 2 * BN + 16;  // B smem row bytes
  constexpr int BROWS = INT8 ? BN : 32;           // B smem rows: [co][k] or [k][co]

  __shared__ __align__(16) unsigned char As[2][BM * ROW];
  __shared__ __align__(16) unsigned char Bs[2][BROWS * BROW];
  __shared__ int rT[BM], rH[BM], rW[BM];

  const Elem* x = reinterpret_cast<const Elem*>(xv);
  const Elem* w = reinterpret_cast<const Elem*>(wv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp & 3, wn = warp >> 2;
  const int M = (T - kt + 1) * Ho * Wo;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nc = (C + CH - 1) / CH;
  const int Q = kt * 9 * nc;
  const int ns = (Q + 1) / 2;
  const bool avec = C % E16 == 0;                 // input pieces 16-byte aligned
  const bool wvec = INT8 ? Co % 16 == 0 : Co % 8 == 0;  // w row segments 16-byte aligned

  for (int r = tid; r < BM; r += NT) {
    int m = m0 + r;
    if (m < M) {
      int wo = m % Wo, rest = m / Wo;
      rT[r] = rest / Ho;
      rH[r] = (rest % Ho) * sh - ph0;
      rW[r] = wo * sw - pw0;
    } else {
      rT[r] = -1;
      rH[r] = rW[r] = 0;
    }
  }
  __syncthreads();

  // ---- loaders ----
  auto issue_a = [&](int s, int buf) {
    const Chunk k0 = chunk_of(2 * s, Q, nc, CH, fault);
    const Chunk k1 = chunk_of(2 * s + 1, Q, nc, CH, fault);
    for (int i = tid; i < BM * 4; i += NT) {
      const int r = i >> 2, p = i & 3;
      const Chunk& k = (p >> 1) ? k1 : k0;
      const int c = k.c0 + (p & 1) * E16;
      const int t = rT[r], hi = rH[r] + k.dy, wi = rW[r] + k.dx;
      bool pos = k.ok && t >= 0 && hi >= 0 && hi < H && wi >= 0 && wi < W;
      if (fault == FAULT_ZERO_HALO_ROW && hi == H - 1) pos = false;
      unsigned char* dst = &As[buf][r * ROW + p * 16];
      const size_t base = pos ? ((size_t)((t + k.dt) * H + hi) * W + wi) * C : 0;
      if (avec) {
        const bool valid = pos && c < C;
        cp_async16(dst, x + (valid ? base + c : 0), valid);
      } else {
        Elem* d = reinterpret_cast<Elem*>(dst);
        for (int e = 0; e < E16; ++e) d[e] = (pos && c + e < C) ? x[base + c + e] : zero_elem<Elem>();
      }
    }
  };

  // s8 mode: the w tile (64 k-rows x BN columns) is loaded as 16 x BN/16
  // blocks of 4 k-rows x 16 columns, one per thread of the first 16 * BN / 16,
  // as 16-byte row segments (neighbouring lanes on neighbouring rows' whole
  // sectors), then transposed in registers into the [co][k] tile.
  constexpr int WBLOCKS = 16 * (BN / 16);
  uint4 wr[4];
  auto load_b_s8 = [&](int s) {
    if (tid >= WBLOCKS) return;
    const int kb = tid % 16, nb = tid / 16;
    const int i0 = kb * 4;
    const Chunk k = chunk_of(2 * s + (i0 >> 5), Q, nc, CH, fault);
    const int co = n0 + nb * 16;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k.c0 + (i0 & 31) + j;
      const bool ok = k.ok && c < C;
      const int8_t* src = reinterpret_cast<const int8_t*>(w) + ((size_t)k.tap * C + c) * Co + co;
      if (!ok || co >= Co) {
        wr[j] = make_uint4(0u, 0u, 0u, 0u);
      } else if (wvec) {
        wr[j] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        for (int e = 0; e < 16 && co + e < Co; ++e)
          v[e / 4] |= ((uint32_t)(uint8_t)src[e]) << (8 * (e % 4));
        wr[j] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto store_b_s8 = [&](int buf) {
    if (tid >= WBLOCKS) return;
    const int kb = tid % 16, nb = tid / 16;
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // columns nb * 16 + q * 4 + [0, 4)
      const uint32_t rows[4] = {reinterpret_cast<const uint32_t*>(&wr[0])[q],
                                reinterpret_cast<const uint32_t*>(&wr[1])[q],
                                reinterpret_cast<const uint32_t*>(&wr[2])[q],
                                reinterpret_cast<const uint32_t*>(&wr[3])[q]};
      uint32_t t[4];
      transpose4x4(rows, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(&Bs[buf][(nb * 16 + q * 4 + c) * ROW + kb * 4]) = t[c];
    }
  };
  auto issue_b_bf16 = [&](int s, int buf) {
    constexpr int PPR = BN / 8;  // 16-byte pieces per k row
    const int i = tid / PPR, p = tid % PPR;  // 32 rows x PPR pieces: one per thread
    const Chunk k = chunk_of(2 * s + (i >> 4), Q, nc, CH, fault);
    const int c = k.c0 + (i & 15), co = n0 + p * 8;
    const bool ok = k.ok && c < C;
    const Elem* src = w + ((size_t)k.tap * C + (ok ? c : 0)) * Co;
    unsigned char* dst = &Bs[buf][i * BROW + p * 16];
    if (wvec) {
      const bool valid = ok && co < Co;
      cp_async16(dst, src + (valid ? co : 0), valid);
    } else {
      Elem* d = reinterpret_cast<Elem*>(dst);
      for (int e = 0; e < 8; ++e) d[e] = (ok && co + e < Co) ? src[co + e] : zero_elem<Elem>();
    }
  };

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // ---- prologue: stage 0 ----
  if (ns > 0) {
    issue_a(0, 0);
    if constexpr (INT8) {
      load_b_s8(0);
      store_b_s8(0);
    } else {
      issue_b_bf16(0, 0);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < ns; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < ns;
    if (more) {  // the next stage's copies run under this stage's mma
      issue_a(s + 1, buf ^ 1);
      if constexpr (INT8) load_b_s8(s + 1);
      else issue_b_bf16(s + 1, buf ^ 1);
    }
    cp_async_commit();

#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t bf[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        if constexpr (INT8) {
          int n = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(r, &Bs[buf][n * ROW + kk * 32 + ((lane >> 3) & 1) * 16]);
        } else {
          int k = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          int n = wn * 32 + nj * 16 + (lane >> 4) * 8;
          ldmatrix_x4_trans(r, &Bs[buf][k * BROW + n * 2]);
        }
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t af[4];
        ldmatrix_x4(af, &As[buf][(wm * 32 + mi * 16 + (lane & 15)) * ROW + kk * 32 +
                                 (lane >> 4) * 16]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if constexpr (INT8) mma_s8(acc[mi][t], af, bf[t][0], bf[t][1]);
          else mma_bf16(acc[mi][t], af, bf[t][0], bf[t][1]);
        }
      }
    }

    if constexpr (INT8) {
      if (more) store_b_s8(buf ^ 1);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // ---- epilogue ----
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int col = n0 + wn * 32 + t * 8 + tig * 2;
    if (col >= Co) continue;
    const bool pair = col + 1 < Co;
    float b0 = 0.0f, b1 = 0.0f;
    if constexpr (!INT8) {
      b0 = load_bias(bias, bias_kind, col);
      b1 = pair ? load_bias(bias, bias_kind, col + 1) : 0.0f;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + g + h * 8;
        if (row >= M) continue;
        const size_t off = (size_t)row * Co + col;
        if constexpr (INT8) {
          int* out = reinterpret_cast<int*>(outv);
          if (pair && Co % 2 == 0) {
            *reinterpret_cast<int2*>(out + off) = make_int2(acc[mi][t][2 * h], acc[mi][t][2 * h + 1]);
          } else {
            out[off] = acc[mi][t][2 * h];
            if (pair) out[off + 1] = acc[mi][t][2 * h + 1];
          }
        } else {
          __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(outv);
          const float y0 = acc[mi][t][2 * h] + b0, y1 = acc[mi][t][2 * h + 1] + b1;
          if (pair && Co % 2 == 0) {
            *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(y0, y1);
          } else {
            out[off] = __float2bfloat16_rn(y0);
            if (pair) out[off + 1] = __float2bfloat16_rn(y1);
          }
        }
      }
    }
  }
}

template <bool INT8, int NWN>
int launch(const void* x, const void* w, const void* bias, int bias_kind, void* out, int T,
           int H, int W, int C, int Co, int kt, int Ho, int Wo, int sh, int sw, int ph0, int pw0,
           int fault, cudaStream_t stream) {
  const long long M = (long long)(T - kt + 1) * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (Co + 32 * NWN - 1) / (32 * NWN));
  conv_kernel<INT8, NWN><<<grid, 128 * NWN, 0, stream>>>(
      x, w, bias, bias_kind, out, T, H, W, C, Co, kt, Ho, Wo, sh, sw, ph0, pw0, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes; returns a cudaError_t (0 = launched).
// int8 = 1: x, w s8 and out s32 (bias unused); int8 = 0: x, w, out bf16 with an
// optional bias (bias_kind 0 none, 1 bf16, 2 f32). All contiguous, in the
// layouts above; padding (ph0, ph1, pw0, pw1), stride (sh, sw). fault != 0
// plants a fault for the checks that must catch it.
extern "C" int rtv_conv3x3(const void* x, const void* w, const void* bias, int bias_kind,
                           void* out, int int8, int T, int H, int W, int C, int Co, int kt,
                           int sh, int sw, int ph0, int ph1, int pw0, int pw1, int fault,
                           void* stream) {
  const int Ho = (H + ph0 + ph1 - 3) / sh + 1, Wo = (W + pw0 + pw1 - 3) / sw + 1;
  if (T < kt || kt < 1 || Ho < 1 || Wo < 1 || C < 1 || Co < 1 || sh < 1 || sw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nwn = Co % 96 == 0 ? 3 : (Co <= 32 ? 1 : 2);  // warps across Co: BN = 32 * nwn
#define RTV_CONV_LAUNCH(I8, NWN)                                                              \
  launch<I8, NWN>(x, w, bias, I8 ? 0 : bias_kind, out, T, H, W, C, Co, kt, Ho, Wo, sh, sw, ph0, \
                  pw0, fault, s)
  if (int8)
    return nwn == 3 ? RTV_CONV_LAUNCH(true, 3)
                    : (nwn == 2 ? RTV_CONV_LAUNCH(true, 2) : RTV_CONV_LAUNCH(true, 1));
  return nwn == 3 ? RTV_CONV_LAUNCH(false, 3)
                  : (nwn == 2 ? RTV_CONV_LAUNCH(false, 2) : RTV_CONV_LAUNCH(false, 1));
#undef RTV_CONV_LAUNCH
}
