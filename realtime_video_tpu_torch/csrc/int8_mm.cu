// Fused int8 linear for Hopper (sm_90a):
//   y[m, n] = bf16( float(sum_k q(x[m, k]) * w_q[k, n]) * (a * w_scale[n]) + b[n] )
//   q(x) = clip(rint(x / a), -127, 127) as s8, a = the per-tensor activation scale.
//
// Replaces both Pallas TPU kernels of realtime_video_tpu/ops/pallas_int8_mm.py:
// `_mm_kernel_kres` (K3a: K <= 2048, x quantised once per m tile into VMEM
// scratch) and `_mm_kernel` (K3b: K tiled with an s32 VMEM accumulator). The
// K-resident split exists only because of the size of the TPU's VMEM; here a
// K loop with the s32 accumulator in registers is both forms, so one kernel
// serves every DiT block linear (qkv, o, cross q/o, fc1, and fc2 with K 8960).
//
// What it keeps out of device memory: the s8 copy of x. Each bf16 x tile is
// read from global memory into registers, quantised there, and stored as s8
// in shared memory; the dequantising epilogue (a * w_scale[n], + b[n], bf16
// rounding) runs on the s32 accumulators before the only store.
//
// Numerics, chosen so that the kernel and its plain PyTorch version give the
// same quanta and the same s32 sums: the quotient x / a is the correctly
// rounded one that an IEEE division gives (the build uses no fast-math), and
// it is rounded half to even (F2I.RN) as jnp.round and torch.round do
// (roundf would round halves away from zero). A divide per element would cost
// more issue slots than the mma, so the kernel takes r = 1/a once and
// corrects x * r twice with the exact FMA remainder x - q * a; the second
// correction starts within an ulp of x / a, where Markstein's theorem makes
// RN(q + (x - q a) r) the correctly rounded quotient. (The TPU kernel
// multiplies by a reciprocal without correction and can differ by 1 LSB at
// exact halves.) The epilogue takes a * w_scale[n] first, as wan_dit.linear
// does, and uses __fmul_rn / __fadd_rn so that no FMA contraction changes the
// f32 rounding.
//
// Operand layout: the s8 mma (m16n8k32 .row.col) wants both operands
// K-contiguous; x is [M, K] and is, but w_q is [K, N] (the JAX layout, which
// the port keeps). Rather than keep a K-major copy of every weight, each
// thread loads 4 k-rows x 4 bytes of w, transposes the 4x4 byte block in
// registers (__byte_perm) and stores it into a [n][k] shared tile, so both
// fragments then come from ldmatrix.
//
// What bounds it on an H100: at the serving shapes (M 4680, K 1536, N 4608)
// one call is 2*M*K*N = 66 GOP against ~29 MB of traffic (x bf16, w s8, y
// bf16), about 2300 operations per byte, so it is bound by the int8 tensor
// cores (1979 TOP/s dense). This version uses mma.sync with a register-staged
// double buffer and 64 x 256 block tiles (each x element is quantised N / 256
// times). What held the first version back was the w tile's traffic from L2:
// 4-byte loads spread over 16 rows used a quarter of every sector, so w is
// now loaded as 16-byte row segments. wgmma and TMA are the later steps.
//
// Ragged M (4680 = 73.1 x 64) and any ragged K or N tile are zero-filled in
// shared memory and never stored; no padded copy is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of x per thread block
constexpr int BN = 256;  // output columns per thread block
constexpr int BK = 64;   // k bytes per stage (two m16n8k32 steps)
constexpr int NTHREADS = 256;  // 8 warps: 2 (m) x 4 (n), each 32 x 64
constexpr int ROW = BK + 16;   // bytes per smem row: conflict-free ldmatrix
constexpr int MI = 2, NT = 8;  // m16 and n8 tiles per warp
constexpr int X_CHUNKS = BM * BK / 8 / NTHREADS;   // 8-element x chunks per thread
static_assert((BK / 4) * (BN / 16) == NTHREADS, "one 4 x 16 w block per thread");
constexpr int SMEM_BYTES = 2 * (BM + BN) * ROW;    // double-buffered A and B^T tiles

constexpr int FAULT_DROP_LAST_K_TILE = 1;  // planted faults for the checks
constexpr int FAULT_W_SCALE_SHIFT = 2;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

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

// clip(rint(RN(x / a)), -127, 127), with r = RN(1 / a): see "Numerics" above.
__device__ __forceinline__ int quant1(float x, float a, float r) {
  const float q0 = __fmul_rn(x, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q0, a, x), r, q0);
  float q = __fmaf_rn(__fmaf_rn(-q1, a, x), r, q1);  // the correctly rounded x / a
  q = fabsf(q0) < 1e6f ? q : q0;  // past 1e6 only the sign matters (and x * r may be inf)
  return __float2int_rn(fminf(fmaxf(q, -127.0f), 127.0f));
}

// 8 bf16 -> 8 s8 quanta (the low bytes of the clipped integers)
__device__ __forceinline__ uint2 quant8(uint4 v, float a, float r) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint32_t w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t lo = __byte_perm(quant1(__bfloat162float(h[4 * i]), a, r),
                              quant1(__bfloat162float(h[4 * i + 1]), a, r), 0x0040);
    uint32_t hi = __byte_perm(quant1(__bfloat162float(h[4 * i + 2]), a, r),
                              quant1(__bfloat162float(h[4 * i + 3]), a, r), 0x0040);
    w[i] = __byte_perm(lo, hi, 0x5410);
  }
  return make_uint2(w[0], w[1]);
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

__global__ void __launch_bounds__(NTHREADS, 2)
int8_linear_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                   const void* __restrict__ bias, int bias_kind,
                   __nv_bfloat16* __restrict__ out, int M, int K, int N, int fault) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As[2] = {smem, smem + BM * ROW};                  // quantised x tile, [m][k]
  int8_t* Bs[2] = {smem + 2 * BM * ROW, smem + 2 * BM * ROW + BN * ROW};  // w^T, [n][k]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float a = __ldg(a_scale);
  const float r = __fdiv_rn(1.0f, a);
  int nk = (K + BK - 1) / BK;
  if (fault == FAULT_DROP_LAST_K_TILE) nk -= 1;

  int acc[MI][NT][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // x: chunks of 8 bf16; chunk c -> row c / 8, column (c % 8) * 8
  uint4 xr[X_CHUNKS];
  // w: one block of 4 k-rows x 16 columns, loaded as 16-byte row segments:
  // k rows kb * 4 + j, columns nb * 16 + [0, 16). Neighbouring lanes take
  // neighbouring segments of a row, so each request reads whole sectors.
  const int kb = tid % 16, nb = tid / 16;
  uint4 wr[4];

  auto load_tiles = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < X_CHUNKS; ++i) {
      int c = tid + NTHREADS * i;
      int row = m0 + c / 8, col = k0 + (c % 8) * 8;
      xr[i] = (row < M && col < K)
                  ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * K + col))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    const int kr = k0 + kb * 4, nc = n0 + nb * 16;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wr[j] = (kr + j < K && nc < N)
                  ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(kr + j) * N + nc))
                  : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int i = 0; i < X_CHUNKS; ++i) {
      int c = tid + NTHREADS * i;
      *reinterpret_cast<uint2*>(&As[buf][(c / 8) * ROW + (c % 8) * 8]) = quant8(xr[i], a, r);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the 4 x 4 block of columns nb * 16 + q * 4 + [0, 4)
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

  if (nk > 0) {
    load_tiles(0);
    store_tiles(0);
  }
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load_tiles(kt + 1);  // in flight while this tile's mma run

#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        int m = wm * (16 * MI) + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], &As[buf][m * ROW + kk * 32 + (lane >> 4) * 16]);
      }
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {  // two n8 tiles per ldmatrix
        uint32_t bq[4];
        int n = wn * (8 * NT) + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bq, &Bs[buf][n * ROW + kk * 32 + ((lane >> 3) & 1) * 16]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_s8(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
          mma_s8(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
        }
      }
    }

    if (more) store_tiles(buf ^ 1);
    __syncthreads();
  }

  // ---- epilogue: dequantise, add the bias, round to bf16, store ----
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = n0 + wn * (8 * NT) + t * 8 + tig * 2;
    if (col >= N) continue;
    const int sc = (fault == FAULT_W_SCALE_SHIFT) ? min(col + 1, N - 2) : col;
    const float s0 = __fmul_rn(a, __ldg(w_scale + sc));
    const float s1 = __fmul_rn(a, __ldg(w_scale + sc + 1));
    const float b0 = load_bias(bias, bias_kind, col);
    const float b1 = load_bias(bias, bias_kind, col + 1);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (16 * MI) + mi * 16 + g + h * 8;
        if (row >= M) continue;
        float y0 = __fadd_rn(__fmul_rn((float)acc[mi][t][2 * h], s0), b0);
        float y1 = __fadd_rn(__fmul_rn((float)acc[mi][t][2 * h + 1], s1), b1);
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) = pack_bf16(y0, y1);
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes; returns a cudaError_t (0 = launched).
// x bf16 [M, K], w_q s8 [K, N], w_scale f32 [N], a_scale f32 [1] in device
// memory, bias [N] (bias_kind 0 none, 1 bf16, 2 f32), out bf16 [M, N]; all
// contiguous. K % 8 == 0 and N % 16 == 0 (the wrapper checks). fault != 0
// plants a fault for the checks that must catch it.
extern "C" int rtv_int8_linear(const void* x, const void* w_q, const void* w_scale,
                               const void* a_scale, const void* bias, int bias_kind, void* out,
                               int M, int K, int N, int fault, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_linear_kernel<<<grid, NTHREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<const int8_t*>(w_q),
      reinterpret_cast<const float*>(w_scale), reinterpret_cast<const float*>(a_scale), bias,
      bias_kind, reinterpret_cast<__nv_bfloat16*>(out), M, K, N, fault);
  return (int)cudaGetLastError();
}
