// Fused int8 linear for Hopper (sm_90a), with wgmma, TMA and a
// warp-specialised pipeline:
//   y[m, n] = bf16( float(sum_k q(x[m, k]) * w_q[k, n]) * (a * w_scale[n]) + b[n] )
//   q(x) = clip(rint(x / a), -127, 127) as s8, a = the per-tensor activation scale.
//
// Replaces both Pallas TPU kernels of realtime_video_tpu/ops/pallas_int8_mm.py:
// `_mm_kernel_kres` (K3a: K <= 2048, x quantised once per m tile into VMEM
// scratch) and `_mm_kernel` (K3b: K tiled with an s32 VMEM accumulator). The
// K-resident split exists only because of the size of the TPU's VMEM; here a
// K loop with the s32 accumulator in registers is both forms, so one kernel
// serves every DiT block linear (qkv, o, cross q/o, fc1, and fc2).
//
// Two launches a call:
//   1. int8_linear_kernel_quantize_x writes the s8 quanta of x [M, K] once
//      (2 bytes read and 1 written per element: ~6 us at the 1.3B qkv shape
//      against the product's 33 us bound), so every quantum is computed once
//      instead of once per output tile; the s8 copy of x is the one thing this
//      design keeps in device memory that the TPU kernel kept in VMEM.
//   2. int8_linear_kernel_sm90, a pure s8 GEMM with the dequantising
//      epilogue. A thread block owns a 128 x 256 output tile and three
//      warpgroups: warpgroup 2, the producer, whose one thread keeps a
//      four-stage ring of TMA loads of the A (x quanta, 128 x 128 bytes) and B
//      (w_q, 256 x 128 bytes) tiles filled, with full and empty mbarriers;
//      warpgroups 0 and 1, the consumers, 64 rows each, run wgmma m64n256k32
//      s8 -> s32 on each stage (4 K steps), keep one wgmma group in flight and
//      release a stage when its group has completed, then run the epilogue on
//      the s32 accumulators before the only store. The producer hands its
//      registers to the consumers (setmaxnreg: 128 s32 accumulators each).
//      Past two waves of tiles the grid is persistent: one block per SM walks
//      the output tiles (m fastest, so the blocks in flight share w tiles in
//      L2), and the ring runs on across tiles, so the producer loads the
//      next tile's first stages while the consumers run this tile's
//      epilogue, which the long-K shapes gain from; with two waves or fewer,
//      one block per tile, since there a block that walks two tiles leaves
//      others idle (the 1536 x 1536 linears ran slower persistent). The epilogue swaps half of its pairs between
//      neighbouring lanes so that each store writes 8 bytes and each lane
//      quad a whole 32-byte sector of a row.
//
// Weight layout: s8 wgmma reads only K-major A and B from shared memory, and
// TMA cannot transpose bytes, so w_q is stored [N, K] (K contiguous) and the
// port hands it out as its [K, N] view (strides (1, K)): the JAX layout and
// values for every public function, one copy of each weight in memory. The
// wrapper refuses any other stride.
//
// Numerics, chosen so that the kernel and its plain PyTorch version give the
// same quanta and the same s32 sums: the quantiser (csrc/quantize.cuh, shared
// with the VAE convs' pre-pass) gives the correctly rounded quotient x / a,
// rounded half to even as jnp.round and torch.round do. The epilogue takes
// a * w_scale[n] first, as wan_dit.linear does, and uses __fmul_rn /
// __fadd_rn so that no FMA contraction changes the f32 rounding. a is read
// through its pointer: no host sync.
//
// What bounds it on an H100: at the 1.3B qkv shape (M 4680, K 1536, N 4608)
// one call is 2*M*K*N = 66 GOP against ~29 MB of traffic, bound by the int8
// tensor cores (1979 TOP/s dense, 0.034 ms).
//
// Ragged M (4680 = 36.6 x 128) and ragged N or K tiles arrive zero-filled
// from TMA and are never stored; no padded copy is made. K and N must be
// multiples of 16 (TMA's 16-byte row pitch; every DiT linear's are multiples
// of 128).

#include <cuda_bf16.h>

#include "quantize.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 128;  // rows of x per thread block: two consumer warpgroups of 64
constexpr int BN = 256;  // output columns per thread block
constexpr int BK = 128;  // k bytes per stage: one 128-byte swizzled row
constexpr int NSTAGES = 4;
constexpr int NTHREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = BM * BK;  // 16 KB
constexpr int B_BYTES = BN * BK;  // 32 KB
constexpr int OFF_B = NSTAGES * A_BYTES;
constexpr int OFF_BAR = OFF_B + NSTAGES * B_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;  // barriers, and room to align to 1 KB

constexpr int FAULT_DROP_LAST_K_TILE = 1;  // planted faults for the checks
constexpr int FAULT_W_SCALE_SHIFT = 2;
constexpr int FAULT_STALE_RING_STAGE = 3;  // the last ring stage holds the previous K tile

using rtv_quant::quant8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float load_bias(const void* bias, int kind, int n) {
  if (kind == 1) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(bias)[n]);
  if (kind == 2) return reinterpret_cast<const float*>(bias)[n];
  return 0.0f;
}

// xq[i] = q(x[i]) over n16 chunks of 16 elements.
__global__ void __launch_bounds__(256)
int8_linear_kernel_quantize_x(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                              const float* __restrict__ a_scale, long long n16) {
  const float a = __ldg(a_scale);
  const float r = __fdiv_rn(1.0f, a);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(x) + 2 * i;
    const uint2 lo = quant8(__ldg(src), a, r);
    const uint2 hi = quant8(__ldg(src + 1), a, r);
    reinterpret_cast<uint4*>(xq)[i] = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
int8_linear_kernel_sm90(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const float* __restrict__ w_scale, const float* __restrict__ a_scale,
                        const void* __restrict__ bias, int bias_kind,
                        __nv_bfloat16* __restrict__ out, int M, int K, int N, int m_tiles,
                        int n_tiles, int fault) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + NSTAGES;

  const int tiles = m_tiles * n_tiles;
  int nk = (K + BK - 1) / BK;
  if (fault == FAULT_DROP_LAST_K_TILE) nk -= 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ======== producer ========
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_tensormap(&tm_x);
      sm90::prefetch_tensormap(&tm_w);
      int it = 0;  // ring position, running on across tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % NSTAGES;
          const uint32_t ph = (it / NSTAGES) & 1;
          const int kc =
              (fault == FAULT_STALE_RING_STAGE && s == NSTAGES - 1 && kt > 0) ? kt - 1 : kt;
          sm90::mbar_wait(&empty[s], ph ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
          sm90::tma_load_2d(smem + s * A_BYTES, &tm_x, &full[s], kc * BK, m0);
          sm90::tma_load_2d(smem + OFF_B + s * B_BYTES, &tm_w, &full[s], kc * BK, n0);
        }
      }
    }
  } else {
    // ======== consumers: 64 rows x 256 columns each ========
    sm90::reg_alloc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, tig = lane % 4;

    const float a = __ldg(a_scale);
    int acc[128];
    int it = 0;  // ring position, in step with the producer's
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * BN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;

      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % NSTAGES;
        sm90::mbar_wait(&full[s], (it / NSTAGES) & 1);
        const uint8_t* as = smem + s * A_BYTES + wg * (A_BYTES / 2);
        const uint8_t* bs = smem + OFF_B + s * B_BYTES;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          sm90::wgmma_m64n256k32_s8(acc, sm90::desc_b128(as + kk * 32, 16, 1024),
                                    sm90::desc_b128(bs + kk * 32, 16, 1024), 1);
        sm90::wgmma_commit();
        // keep this stage's group in flight; the previous one has completed
        sm90::wgmma_wait<1>();
        sm90::fence_regs(acc);
        if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % NSTAGES]);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (nk > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % NSTAGES]);

      // ---- epilogue: dequantise, add the bias, round to bf16, store ----
      // Lanes tig and tig ^ 1 swap one bf16 pair of each chunk pair (j, j+1):
      // an even lane then holds 4 columns of chunk j, an odd one 4 of chunk
      // j+1, and a lane quad writes the 32 bytes of a row's 16 columns.
      const int row0 = m0 + wg * 64 + warp * 16 + g;
      const bool odd = tig & 1;
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        const int col = n0 + j * 8 + tig * 2;  // this lane's pair in chunk j (+8: chunk j+1)
        if (n0 + j * 8 >= N) continue;         // N % 16 == 0: a chunk pair is whole or past N
        float sc[4], bi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = col + (c >> 1) * 8 + (c & 1);
          const int sidx = (fault == FAULT_W_SCALE_SHIFT) ? min(cc + 1, N - 1) : cc;
          sc[c] = __fmul_rn(a, __ldg(w_scale + sidx));
          bi[c] = load_bias(bias, bias_kind, cc);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t p0 = pack_bf16(
              __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * hh], sc[0]), bi[0]),
              __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * hh + 1], sc[1]), bi[1]));
          const uint32_t p1 = pack_bf16(
              __fadd_rn(__fmul_rn((float)acc[4 * j + 4 + 2 * hh], sc[2]), bi[2]),
              __fadd_rn(__fmul_rn((float)acc[4 * j + 4 + 2 * hh + 1], sc[3]), bi[3]));
          const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? p0 : p1, 1);
          const int row = row0 + hh * 8;
          if (row >= M) continue;
          const int c0 = odd ? n0 + (j + 1) * 8 + (tig - 1) * 2 : col;
          *reinterpret_cast<uint2*>(out + (size_t)row * N + c0) =
              odd ? make_uint2(got, p1) : make_uint2(p0, got);
        }
      }
    }
  }
}

// [rows, K] s8 with K contiguous as a 2-D tensor map, box 128 bytes x box_rows.
int s8_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  return sm90::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, strides, box);
}

}  // namespace

// Plain C entry point, bound with ctypes; returns a cudaError_t (0 = launched).
// x bf16 [M, K], w_q s8 stored [N, K] (the [K, N] view's storage), w_scale
// f32 [N], a_scale f32 [1] in device memory, bias [N] (bias_kind 0 none, 1
// bf16, 2 f32), out bf16 [M, N], xq s8 [M, K] scratch for the quanta of x;
// all contiguous and 16-byte aligned. K % 16 == 0 and N % 16 == 0 (the
// wrapper checks). fault != 0 plants a fault for the checks that must catch it.
extern "C" int rtv_int8_linear(const void* x, const void* w_q, const void* w_scale,
                               const void* a_scale, const void* bias, int bias_kind, void* out,
                               void* xq, int M, int K, int N, int fault, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long n16 = (long long)M * K / 16;
  const int qblocks = (int)((n16 + 255) / 256 < 132 * 16 ? (n16 + 255) / 256 : 132 * 16);
  int8_linear_kernel_quantize_x<<<qblocks, 256, 0, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<int8_t*>(xq),
      reinterpret_cast<const float*>(a_scale), n16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tm_x, tm_w;
  int err = s8_map(&tm_x, xq, M, K, BM);
  if (err == 0) err = s8_map(&tm_w, w_q, N, K, BN);
  if (err != 0) return err;
  e = cudaFuncSetAttribute(int8_linear_kernel_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const int blocks = tiles <= 2 * sms ? tiles : sms;
  int8_linear_kernel_sm90<<<blocks, NTHREADS, SMEM_BYTES, st>>>(
      tm_x, tm_w, reinterpret_cast<const float*>(w_scale),
      reinterpret_cast<const float*>(a_scale), bias, bias_kind,
      reinterpret_cast<__nv_bfloat16*>(out), M, K, N, m_tiles, n_tiles, fault);
  return (int)cudaGetLastError();
}
