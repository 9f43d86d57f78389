// kt x 3 x 3 convolution for Hopper (sm_90a) as a TMA-fed wgmma implicit
// GEMM, with the int8 tier's quantise pre-pass and dequantise epilogue fused
// around it. Modes:
//   * s8 x s8 -> s32 sums (out_mode 0), or -> the dequantised bf16 output
//     (out_mode 1): y = bf16(f32(acc) * s[co] + f32(b[co])), s[co] = a * scale[co];
//   * bf16 x bf16 -> f32 accumulate, + optional bias, -> bf16 (out_mode 2).
//
// Replaces two Pallas TPU kernels: realtime_video_tpu/ops/pallas_conv2.py
// `_kernel` (K4: a 3x3 stride-1 VALID conv over a pre-padded input whose
// temporal taps the caller concatenated into channels) and
// realtime_video_tpu/ops/pallas_conv.py `_conv_kernel` (K5: the kt x 3 x 3
// form with bias, temporal taps inside the kernel). K5 is K4's kt > 1 form:
// the kernel reads the kt input frames of each output frame itself, so no
// tap concat is written, and it pads and strides itself, so no padded copy
// is written either. The int8 path of models/vae.py::_int8_conv2d is the
// quantise pre-pass and one launch of this kernel, nothing between or after.
//
//   x [T, H, W, C] (channels last; pixels Cp elements apart, Cp >= C),
//   w [kt, 3, 3, C, Co] as the view of [Co, kt, 3, 3, Cp] storage (K-major),
//   y [T - kt + 1, Ho, Wo, Co], Ho = (H + ph0 + ph1 - 3) / sh + 1 (same for W),
//   y[t, i, j, o] = sum_{dt, dy, dx, c} x[t + dt, i*sh + dy - ph0, j*sw + dx - pw0, c]
//                   * w[dt, dy, dx, c, o], reading zeros outside the frame.
//
// GEMM view. Rows are output pixels: an m-block is 64 consecutive pixels of
// one output row of one frame, and a thread block's tile is four m-blocks
// (two per consumer warpgroup). Columns are Co: BN = the whole Co up to 96
// (16 for the decoder's 3-channel head, 96 at the decoder's last stage),
// wider Co in column tiles of 96 (192: two, 384: four). A tile of 256 pixels
// x 96 channels reads fewer bytes from L2 per output than one m-block per
// warpgroup at BN 128 or 192 would (one stage of three taps: 2.9 bytes per
// output against 4.0 and 3.7), and L2-to-SM traffic is what bounds the
// kernel (see the end of this comment). The reduction runs over the kt * 9
// taps x C in chunks of 128 bytes of C (128 s8 or 64 bf16 channels), one
// chunk per ring stage, four wgmma K steps of 32 bytes each; in s8 the last
// chunk takes only the K steps that hold channels (C 96: three; the padded C
// 32: one), a template parameter, so no branch sits among the wgmma.
//
// A operand by TMA, no gather. For a fixed tap (dt, dy, dx) an m-block's A
// rows are a contiguous run of one input row, shifted: one box of the 4-D
// tensor map (C, W, H, T) at (c0, j0 * sw + dx - pw0, i * sh + dy - ph0,
// t + dt). TMA fills coordinates outside the tensor with zeros, which are
// the halos: no padded copy and no per-row offsets. Stride 2 (the encoder's
// downsample convs) uses the map's element strides: a step of 2 along W, so
// a box of 128 W positions loads the 64 even ones (the im2col mode is not
// used). Channels past C (a 128-byte chunk wider than C) fill with zeros.
//
// B operand K-major. s8 wgmma reads both operands K-major and TMA does not
// transpose bytes, so w is stored [Co, kt, 3, 3, Cp] and read as the 3-D map
// (C, kt * 9, Co): a stage's B tile is one box (128 bytes of C, 1 tap, BN
// output channels), no register transpose. Columns past Co fill with zeros
// and are never stored.
//
// Ragged shapes. TMA needs 16-byte global strides: the s8 activations of C 3
// (the encoder's first conv) and C 16 (the decoder's first conv) come from
// the quantise pre-pass padded to Cp = 32 channels, and their weights are
// stored with Cp = 32 (zero rows); Co 3 (the decoder's head) is a BN 16
// tile of which 3 columns are stored.
//
// Pipeline. One TMA producer thread (warpgroup 2, whose registers go to the
// consumers) and two consumer warpgroups of 128 rows each, a ring of three to
// six stages with full and empty mbarriers (csrc/sm90.cuh); each consumer
// keeps one wgmma group in flight and releases a stage when its group has
// completed. Past two waves of tiles the grid is persistent (one block per
// SM walks the tiles, m fastest, and the ring runs on across tiles, so the
// next tile's loads overlap this tile's epilogue).
//
// Numerics. The s8 sums are exact for every C. The dequantise epilogue is
// models/vae.py's torch sequence (and _int8_conv2d of the JAX package,
// realtime_video_tpu/models/vae.py:349-364): s = a * scale[co] in f32, then
// f32(acc) * s, then + f32(b), then round to nearest even to bf16, each with
// __int2float_rn / __fmul_rn / __fadd_rn so that no FMA contraction changes
// a rounding; a is read from device memory (a static scale, or the per-call
// amax of hopper_int8_mm.dynamic_scale), so no call waits for the host. The
// quantise pre-pass (conv_quantize_kernel) is the shared csrc/quantize.cuh.
//
// What bounds it on an H100: the decoder's widest convs (C 96 -> 96 at
// 480x832, kt 3, 4 frames) do 2*M*K*N = 0.8 TOP against ~0.5 GB of traffic
// (s8 in, bf16 out), about 1600 operations per byte, so on paper the int8
// tensor cores bound them (0.40 ms at 1979 TOP/s). Each input pixel comes
// from L2 once per (dt, dy) of each tile that reads it, each B tile once
// per tile. On an H100 (700 W) that conv's main loop kept its time when a
// quarter of its K steps went, and each tile adds ~8 us outside the wgmma
// (the epilogue and the ring's drain); clusters of two blocks sharing B by
// multicast were slower.

#include <cuda_bf16.h>

#include <type_traits>

#include "quantize.cuh"
#include "sm90.cuh"

namespace {

constexpr int MB = 64;               // output pixels of one m-block: 64 rows of a wgmma
constexpr int BK = 128;              // bytes of C per ring stage: one 128-byte swizzled row
constexpr int NTHREADS = 384;
constexpr int MAX_DEVICES = 64;  // cards whose SM count is kept
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_RING = 216 * 1024;

constexpr int OUT_S32 = 0;      // s8 mode: the int32 sums
constexpr int OUT_DEQUANT = 1;  // s8 mode: the dequantised bf16 output
constexpr int OUT_BF16 = 2;     // bf16 mode: bf16 (+ bias)

// planted faults for the checks that must catch them (kernel argument)
constexpr int FAULT_ZERO_HALO_ROW = 1;     // the input's last row reads as zeros
constexpr int FAULT_DROP_LAST_C32 = 2;     // the last 32 bytes of C read as zeros (host side)
constexpr int FAULT_STALE_RING_STAGE = 3;  // the last ring stage holds the previous chunk
constexpr int FAULT_TAP_ROWS = 4;          // tap dx = 2 reads the A rows of tap dx = 1

// The ring of one launch form. REUSE (stride 1): a stage holds the A rows of
// one (dt, dy) and one chunk of C, MB + 2 input pixels per m-block, and the
// B tiles of its three taps dx = 0, 1, 2, which read the A rows shifted by dx
// (a descriptor start dx rows into the tile). Else (stride 2): one tap per
// stage. Each consumer warpgroup owns MW = 2 m-blocks of the tile, so a B
// tile feeds 256 output pixels.
template <int BN, bool REUSE>
struct Ring {
  static_assert(BN % 16 == 0 && BN <= 96, "column tiles of 16 to 96");
  static constexpr int MW = 2;
  static constexpr int TAPS = REUSE ? 3 : 1;
  static constexpr int A_ROWS = REUSE ? MB + 2 : MB;
  static constexpr int A_BOX = A_ROWS * BK;                       // bytes one A box fills
  static constexpr int A_SLOT = (A_BOX + 1023) / 1024 * 1024;     // 1 KB aligned
  static constexpr int A_BYTES = 2 * MW * A_SLOT;
  static constexpr int B_BOX = BN * BK;
  static constexpr int STAGE = A_BYTES + TAPS * B_BOX;
  static constexpr int NST = SMEM_RING / STAGE < 6 ? SMEM_RING / STAGE : 6;
  static_assert(NST >= 3, "a ring of three stages or more");
  static constexpr int OFF_B = NST * A_BYTES;
  static constexpr int OFF_BAR = OFF_B + NST * TAPS * B_BOX;
  static constexpr int SMEM = OFF_BAR + 128 + 1024;  // barriers, and room to align to 1 KB
};

// The output geometry and the reduction's shape, as the kernel walks them.
struct Geo {
  int Ho, Wo, nj;           // output rows and columns; m-blocks per output row
  int mblocks, m_tiles, n_tiles;
  int H, Co, kt, nc;        // input rows, output channels, temporal taps, chunks of C
  int sh, sw, ph0, pw0;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float load_bias(const void* bias, int kind, int n) {
  if (kind == 1) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(bias)[n]);
  if (kind == 2) return reinterpret_cast<const float*>(bias)[n];
  return 0.0f;
}

template <bool INT8, int BN, bool REUSE, int KS>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_kernel_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const Geo g, const float* __restrict__ a_scale, const float* __restrict__ scale,
                 const void* __restrict__ bias, int bias_kind, void* __restrict__ out,
                 int out_mode, int fault) {
  using R = Ring<BN, REUSE>;
  constexpr int MW = R::MW;
  using Acc = typename std::conditional<INT8, int, float>::type;
  constexpr int ES = INT8 ? 1 : 2;  // bytes per element
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::OFF_BAR);
  uint64_t* empty = full + R::NST;
  const int tiles = g.m_tiles * g.n_tiles;
  const int nq = g.kt * (REUSE ? 3 : 9) * g.nc;  // ring stages per tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::NST; ++s) {
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
        const int mt = tile % g.m_tiles, n0 = (tile / g.m_tiles) * BN;
        int bt[2 * MW], bi[2 * MW], bj[2 * MW], live = 0;
#pragma unroll
        for (int h = 0; h < 2 * MW; ++h) {  // the tile's m-blocks: frame, row, first column
          const int mb = 2 * MW * mt + h;
          live += mb < g.mblocks;
          const int rest = mb / g.nj;
          bj[h] = (mb % g.nj) * MB * g.sw - g.pw0;
          bi[h] = (rest % g.Ho) * g.sh - g.ph0;
          bt[h] = rest / g.Ho;
        }
        const uint32_t bytes = live * R::A_BOX + R::TAPS * R::B_BOX;
        for (int q = 0; q < nq; ++q, ++it) {
          const int s = it % R::NST;
          const int qc =
              (fault == FAULT_STALE_RING_STAGE && s == R::NST - 1 && q > 0) ? q - 1 : q;
          const int c0 = (qc % g.nc) * (BK / ES);
          const int rest = qc / g.nc;  // REUSE: dt * 3 + dy; else the tap dt * 9 + dy * 3 + dx
          const int dt = REUSE ? rest / 3 : rest / 9;
          const int dy = REUSE ? rest % 3 : (rest / 3) % 3;
          const int dx = REUSE ? 0 : rest % 3;
          const int tap0 = dt * 9 + dy * 3 + dx;
          sm90::mbar_wait(&empty[s], ((it / R::NST) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], bytes);
#pragma unroll
          for (int h = 0; h < 2 * MW; ++h) {
            if (2 * MW * mt + h >= g.mblocks) continue;
            int row = bi[h] + dy;
            if (fault == FAULT_ZERO_HALO_ROW && row == g.H - 1) row = g.H;  // past the end: zeros
            sm90::tma_load_4d(smem + s * R::A_BYTES + h * R::A_SLOT, &tm_x, &full[s], c0,
                              bj[h] + dx, row, bt[h] + dt);
          }
#pragma unroll
          for (int d = 0; d < R::TAPS; ++d)
            sm90::tma_load_3d(smem + R::OFF_B + (s * R::TAPS + d) * R::B_BOX, &tm_w, &full[s],
                              c0, tap0 + d, n0);
        }
      }
    }
  } else {
    // ======== consumers: MW m-blocks of 64 output pixels x BN channels each ========
    sm90::reg_alloc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int gq = lane / 4, tig = lane % 4;
    const float a = out_mode == OUT_DEQUANT ? __ldg(a_scale) : 0.0f;
    const int shift2 = fault == FAULT_TAP_ROWS ? 1 : 2;  // the A rows tap dx = 2 reads

    Acc acc[MW][BN / 2];
    int it = 0;  // ring position, in step with the producer's
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile % g.m_tiles, n0 = (tile / g.m_tiles) * BN;
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0;

      // one ring stage: its taps' wgmma, STEPS K steps of 32 bytes each
      auto stage = [&](auto steps, int q) {
        constexpr int STEPS = decltype(steps)::value;
        const int s = it % R::NST;
        sm90::mbar_wait(&full[s], (it / R::NST) & 1);
        const uint8_t* as = smem + s * R::A_BYTES + wg * MW * R::A_SLOT;
        const uint8_t* bs = smem + R::OFF_B + s * R::TAPS * R::B_BOX;
#pragma unroll
        for (int m = 0; m < MW; ++m) sm90::fence_regs(acc[m]);
        sm90::wgmma_fence();
#pragma unroll
        for (int d = 0; d < R::TAPS; ++d) {
#pragma unroll
          for (int kk = 0; kk < STEPS; ++kk) {
            const uint64_t db = sm90::desc_b128(bs + d * R::B_BOX + kk * 32, 16, 1024);
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              // tap dx = d reads the A rows d pixels on: a start d rows into the
              // swizzle atom, which the address carries (sm90::desc_b128)
              const int rows = d == 2 ? shift2 : d;
              const uint64_t da =
                  sm90::desc_b128(as + m * R::A_SLOT + rows * BK + kk * 32, 16, 1024);
              if constexpr (INT8) sm90::Wgmma<BN>::s8(acc[m], da, db, 1);
              else sm90::Wgmma<BN>::bf16(acc[m], da, db, 1);
            }
          }
        }
        sm90::wgmma_commit();
        // keep this stage's group in flight; the previous one has completed
        sm90::wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MW; ++m) sm90::fence_regs(acc[m]);
        if (q > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % R::NST]);
        ++it;
      };
      // the producer's order: for each tap group, the chunks of C; every chunk
      // but the last is BK bytes wide, the last holds KS K steps of channels
      // (TMA zero-fills the rest of its box, which the K steps skip)
      int q = 0;
      for (int grp = 0; grp < nq / g.nc; ++grp) {
        for (int c = 1; c < g.nc; ++c) stage(std::integral_constant<int, BK / 32>(), q++);
        stage(std::integral_constant<int, KS>(), q++);
      }
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MW; ++m) sm90::fence_regs(acc[m]);
      if (nq > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % R::NST]);

      // ---- epilogue: rows r0 and r0 + 8 of each of this warpgroup's m-blocks,
      // each column's scale and bias read once for both ----
      const bool even = (g.Co & 1) == 0;
      size_t pix0[MW];
      bool ok[MW][2];
#pragma unroll
      for (int m = 0; m < MW; ++m) {
        const int mb = 2 * MW * mt + wg * MW + m;
        const int j0 = (mb % g.nj) * MB + warp * 16 + gq;
        pix0[m] = (size_t)(mb / g.nj) * g.Wo + j0;  // (t * Ho + i) * Wo + j
        ok[m][0] = mb < g.mblocks && j0 < g.Wo;
        ok[m][1] = mb < g.mblocks && j0 + 8 < g.Wo;
      }
#pragma unroll
      for (int j8 = 0; j8 < BN / 8; ++j8) {
        const int col = n0 + j8 * 8 + tig * 2;
        if (col >= g.Co) continue;
        const bool pair = col + 1 < g.Co;
        float s0 = 0.0f, s1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
        if (out_mode != OUT_S32) {
          if (out_mode == OUT_DEQUANT) {
            s0 = __fmul_rn(a, __ldg(scale + col));
            s1 = pair ? __fmul_rn(a, __ldg(scale + col + 1)) : 0.0f;
          }
          b0 = load_bias(bias, bias_kind, col);
          b1 = pair ? load_bias(bias, bias_kind, col + 1) : 0.0f;
        }
#pragma unroll
        for (int m = 0; m < MW; ++m) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (!ok[m][hh]) continue;
            const size_t off = (pix0[m] + 8 * hh) * g.Co + col;
            const Acc v0 = acc[m][4 * j8 + 2 * hh], v1 = acc[m][4 * j8 + 2 * hh + 1];
            if (out_mode == OUT_S32) {
              int* o = reinterpret_cast<int*>(out);
              if (pair && even) {
                *reinterpret_cast<int2*>(o + off) = make_int2((int)v0, (int)v1);
              } else {
                o[off] = (int)v0;
                if (pair) o[off + 1] = (int)v1;
              }
            } else {
              float y0, y1;
              if (out_mode == OUT_DEQUANT) {
                y0 = __fadd_rn(__fmul_rn(__int2float_rn((int)v0), s0), b0);
                y1 = __fadd_rn(__fmul_rn(__int2float_rn((int)v1), s1), b1);
              } else {
                y0 = __fadd_rn((float)v0, b0);
                y1 = __fadd_rn((float)v1, b1);
              }
              __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
              if (pair && even) {
                *reinterpret_cast<uint32_t*>(o + off) = pack_bf16(y0, y1);
              } else {
                o[off] = __float2bfloat16_rn(y0);
                if (pair) o[off + 1] = __float2bfloat16_rn(y1);
              }
            }
          }
        }
      }
    }
  }
}

// bf16 x [pixels, C] (C contiguous) -> s8 xq [pixels, Cp], q(x) per tensor
// with the scale a read from device memory; channels C..Cp-1 are written as
// zeros. Vectorised (16 channels a step) when C == Cp is a multiple of 16,
// else 4 output bytes a step.
__global__ void __launch_bounds__(256)
conv_quantize_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                     const float* __restrict__ a_scale, long long pixels, int C, int Cp) {
  const float a = __ldg(a_scale);
  const float r = __fdiv_rn(1.0f, a);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (C == Cp && C % 16 == 0) {
    const long long n16 = pixels * C / 16;
    for (long long i = first; i < n16; i += step) {
      const uint4* src = reinterpret_cast<const uint4*>(x) + 2 * i;
      const uint2 lo = rtv_quant::quant8(__ldg(src), a, r);
      const uint2 hi = rtv_quant::quant8(__ldg(src + 1), a, r);
      reinterpret_cast<uint4*>(xq)[i] = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  } else {
    const long long n4 = pixels * Cp / 4;
    for (long long i = first; i < n4; i += step) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long o = 4 * i + e;
        const long long pix = o / Cp;
        const int c = (int)(o - pix * Cp);
        const int v = c < C ? rtv_quant::quant1(__bfloat162float(x[pix * C + c]), a, r) : 0;
        packed |= ((uint32_t)v & 0xffu) << (8 * e);
      }
      reinterpret_cast<uint32_t*>(xq)[i] = packed;
    }
  }
}

// The current device's SM count, kept per device: one process may launch on
// several cards (a VAE on a card of its own, or split over cards), and the
// binding makes the tensor's card current around each launch.
int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

template <bool INT8, int BN, bool REUSE, int KS>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w, Geo g, const float* a_scale,
           const float* scale, const void* bias, int bias_kind, void* out, int out_mode, int fault,
           cudaStream_t stream) {
  using R = Ring<BN, REUSE>;
  auto kernel = conv_kernel_sm90<INT8, BN, REUSE, KS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       R::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  g.m_tiles = (g.mblocks + 2 * R::MW - 1) / (2 * R::MW);
  const int tiles = g.m_tiles * g.n_tiles;
  const int blocks = tiles <= 2 * sms ? tiles : sms;
  kernel<<<blocks, NTHREADS, R::SMEM, stream>>>(tm_x, tm_w, g, a_scale, scale, bias, bias_kind,
                                                out, out_mode, fault);
  return (int)cudaGetLastError();
}

template <bool INT8, bool REUSE, int KS>
int launch_bn(int bn, const CUtensorMap& tm_x, const CUtensorMap& tm_w, const Geo& g,
              const float* a_scale, const float* scale, const void* bias, int bias_kind,
              void* out, int out_mode, int fault, cudaStream_t s) {
#define RTV_CONV_LAUNCH(N)                                                                   \
  launch<INT8, N, REUSE, KS>(tm_x, tm_w, g, a_scale, scale, bias, bias_kind, out, out_mode, \
                             fault, s)
  switch (bn) {
    case 16: return RTV_CONV_LAUNCH(16);
    case 32: return RTV_CONV_LAUNCH(32);
    case 64: return RTV_CONV_LAUNCH(64);
    default: return RTV_CONV_LAUNCH(96);
  }
#undef RTV_CONV_LAUNCH
}

// The last chunk's K steps: s8 launches take 1 to 4 (C 32, the padded C 3
// and C 16: 1 of 4; C 96: 3; C 192: 4 then 2), bf16 ones all 4 (their zero
// fill keeps the sums exact; the main path's bf16 convs run in cuDNN).
template <bool INT8, bool REUSE>
int launch_ks(int ks, int bn, const CUtensorMap& tm_x, const CUtensorMap& tm_w, const Geo& g,
              const float* a_scale, const float* scale, const void* bias, int bias_kind,
              void* out, int out_mode, int fault, cudaStream_t s) {
#define RTV_CONV_LAUNCH(K) \
  launch_bn<INT8, REUSE, K>(bn, tm_x, tm_w, g, a_scale, scale, bias, bias_kind, out, out_mode, \
                            fault, s)
  if constexpr (!INT8) {
    return RTV_CONV_LAUNCH(BK / 32);
  } else {
    switch (ks) {
      case 1: return RTV_CONV_LAUNCH(1);
      case 2: return RTV_CONV_LAUNCH(2);
      case 3: return RTV_CONV_LAUNCH(3);
      default: return RTV_CONV_LAUNCH(4);
    }
  }
#undef RTV_CONV_LAUNCH
}

// The column tile: Co up to 96 in one tile of the smallest width that holds
// it; wider Co in tiles of 96.
int pick_bn(int Co, int* n_tiles) {
  static const int widths[] = {16, 32, 64, 96};
  int bn = 96;
  for (int w : widths)
    if (w >= Co) {
      bn = w;
      break;
    }
  *n_tiles = (Co + bn - 1) / bn;
  return bn;
}

}  // namespace

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 =
// launched).

// The quantise pre-pass: x bf16 [pixels, C] contiguous -> xq s8 [pixels, Cp]
// (Cp % 4 == 0, Cp >= C; the pad channels are zeros), a_scale one f32 in
// device memory.
extern "C" int rtv_conv_quantize(const void* x, void* xq, const void* a_scale, long long pixels,
                                 int C, int Cp, void* stream) {
  if (pixels <= 0 || C < 1 || Cp < C || Cp % 4) return (int)cudaErrorInvalidValue;
  const long long work = C == Cp && C % 16 == 0 ? pixels * C / 16 : pixels * Cp / 4;
  const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256 : 132 * 16);
  conv_quantize_kernel<<<blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<int8_t*>(xq),
      reinterpret_cast<const float*>(a_scale), pixels, C, Cp);
  return (int)cudaGetLastError();
}

// The conv. int8 = 1: x, w s8; out_mode 0 writes the int32 sums, 1 the
// dequantised bf16 (a_scale [1], scale [Co] f32 and the bias in device
// memory). int8 = 0: x, w, out bf16 with an optional bias (out_mode 2).
// bias_kind 0 none, 1 bf16, 2 f32. x: pixels x_pix elements apart (rows and
// frames contiguous), w: the [kt, 3, 3, C, Co] view of [Co, kt, 3, 3, Cp]
// storage with taps Cp elements apart and output channels w_co elements
// apart; byte strides multiples of 16, pointers 16-byte aligned. Padding
// (ph0, ph1, pw0, pw1), stride (sh, sw) in {1, 2}. fault != 0 plants a fault
// for the checks that must catch it.
extern "C" int rtv_conv3x3_sm90(const void* x, const void* w, const void* a_scale,
                                const void* scale, const void* bias, int bias_kind, void* out,
                                int int8, int out_mode, int T, int H, int W, int C, int x_pix,
                                int Co, int w_tap, long long w_co, int kt, int sh, int sw,
                                int ph0, int ph1, int pw0, int pw1, int fault, void* stream) {
  const int es = int8 ? 1 : 2;
  const int Ho = (H + ph0 + ph1 - 3) / sh + 1, Wo = (W + pw0 + pw1 - 3) / sw + 1;
  if (T < kt || kt < 1 || Ho < 1 || Wo < 1 || C < 1 || Co < 1 || sh < 1 || sh > 2 || sw < 1 ||
      sw > 2 || x_pix < C || w_tap < C || (long long)x_pix * es % 16 ||
      (long long)w_tap * es % 16 || w_co * es % 16 ||
      (int8 ? out_mode == OUT_BF16 : out_mode != OUT_BF16))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.Ho = Ho;
  g.Wo = Wo;
  g.nj = (Wo + MB - 1) / MB;
  g.mblocks = (T - kt + 1) * Ho * g.nj;
  g.m_tiles = 0;  // set by launch, from the tile's m-blocks
  const int bn = pick_bn(Co, &g.n_tiles);
  g.H = H;
  g.Co = Co;
  g.kt = kt;
  g.nc = (C * es + BK - 1) / BK;
  g.sh = sh;
  g.sw = sw;
  g.ph0 = ph0;
  g.pw0 = pw0;

  const CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int cx = fault == FAULT_DROP_LAST_C32 && C * es > 32 ? C - 32 / es : C;
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[4] = {(cuuint64_t)cx, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T};
  const cuuint64_t xs[3] = {(cuuint64_t)x_pix * es, (cuuint64_t)W * x_pix * es,
                            (cuuint64_t)H * W * x_pix * es};
  // stride 1: MB + 2 pixels a box, read by the three taps dx shifted; stride
  // 2: MB pixels at every other column, one box per tap
  const bool reuse = sw == 1;
  const cuuint32_t xb[4] = {(cuuint32_t)(BK / es), (cuuint32_t)(reuse ? MB + 2 : MB * sw), 1, 1};
  const cuuint32_t xe[4] = {1, (cuuint32_t)sw, 1, 1};
  int err = sm90::make_tensor_map(&tm_x, type, 4, x, xd, xs, xb, xe);
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)kt * 9, (cuuint64_t)Co};
  const cuuint64_t ws[2] = {(cuuint64_t)w_tap * es, (cuuint64_t)w_co * es};
  const cuuint32_t wb[3] = {(cuuint32_t)(BK / es), 1, (cuuint32_t)bn};
  if (err == 0) err = sm90::make_tensor_map(&tm_w, type, 3, w, wd, ws, wb);
  if (err != 0) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* as = reinterpret_cast<const float*>(a_scale);
  const float* sc = reinterpret_cast<const float*>(scale);
  const int ks = (C * es - (g.nc - 1) * BK + 31) / 32;  // K steps of the last chunk
  if (int8)
    return reuse ? launch_ks<true, true>(ks, bn, tm_x, tm_w, g, as, sc, bias, bias_kind, out,
                                         out_mode, fault, s)
                 : launch_ks<true, false>(ks, bn, tm_x, tm_w, g, as, sc, bias, bias_kind, out,
                                          out_mode, fault, s);
  return reuse ? launch_ks<false, true>(ks, bn, tm_x, tm_w, g, as, sc, bias, bias_kind, out,
                                        out_mode, fault, s)
               : launch_ks<false, false>(ks, bn, tm_x, tm_w, g, as, sc, bias, bias_kind, out,
                                         out_mode, fault, s);
}
