// The DiT layer's norm glue as row kernels for Hopper (sm_90a): each norm
// site of a layer is one pass over its rows, where PyTorch ran a chain of
// separate f32 ops that each read or wrote the whole activation.
//
//   dit_add_ln_modulate_kernel: per row of tokens [rows, D]
//     1. optionally the residual, t = bf16(x + bf16(y * bf16(g))) with the
//        per-frame gate g, or bf16(x + y) without it, written as the new tokens;
//     2. LayerNorm statistics in f32 from the row held in registers, two
//        passes (the mean, then the mean of the squared deviations);
//     3. n = bf16((t - mu) * rsqrt(var + eps)), then either the per-frame
//        AdaLN bf16(bf16(n * bf16(1 + bf16(scale))) + bf16(shift)) or the
//        affine bf16(bf16(n * w) + b), written as bf16.
//     The frame of a row is (row % L) / (L / F); gate, shift and scale are
//     read from f32 [B, F, D] views (the layer's modulation, no broadcast
//     copy). With no output it is the residual alone.
//   dit_qk_norm_rope_kernel: per row of q (and k) read with a row stride
//     (the q and k thirds of the fused qkv output, or contiguous rows), the
//     RMSNorm over the whole width D, bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w),
//     then RoPE on the interleaved pairs from the [L, Dh/2] f32 cos / sin
//     tables, r0 = x0 c - x1 s, r1 = x0 s + x1 c in f32, written contiguous
//     ([B, L, N, Dh]); without tables the norm alone (the cross-attention q).
//
// No Pallas TPU kernel stands behind these: the JAX package leaves the ops to
// XLA's fusion. They are the plain chains of models/wan_dit.py (`layer_norm`,
// `modulate`, `gate`, `rms_norm`) and models/rope.py (`rope_apply_fused`),
// which stay as the CPU path and the reference.
//
// Numerics: every rounding of the plain chain is made in registers, in its
// order: f32 statistics; the normalised value rounded to bf16 before any
// scale; each bf16 op of the gate, the residual and the modulation rounded
// as torch rounds a bf16 op (computed in f32, rounded to nearest even);
// RoPE's products and sums in f32. __fmul_rn / __fadd_rn / __fsub_rn keep
// nvcc from contracting any of them into an FMA, and rsqrtf is the function
// torch.rsqrt calls. Only the order of the statistics' sums differs from
// torch's reductions; the mean is the sum times RN(1 / D), as torch's mean
// kernel takes it.
//
// What bounds them on an H100: bytes. At the 14B shape (4680 x 5120) an
// add_ln_modulate with no residual moves 96 MB (29 us at 3.35 TB/s), with
// the residual 192 MB, q + k of the qkv output 192 MB. A row is short work
// between block-wide sums, so what counts is how many rows are in flight on
// an SM, which registers bound. So the row stays in registers as packed
// bf16 (16-byte loads and stores, VEC vectors of 8 a thread, threads chosen
// from D at launch: 160 at D 5120, 64 at D 1536), and the per-column
// operands (gate, 1 + scale, shift, or the norm's weight) sit as packed
// bf16 in shared memory slots that only their own thread touches. A thread
// block takes ROWS rows: add_ln_modulate's of one frame, one after another,
// so that the frame's operands are read from L2 once a block and not once
// a row; qk_norm_rope's together, their sums in one pair of barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;          // rows a thread block takes
constexpr int MAX_THREADS = 256;
constexpr int MAX_VEC = 4;       // 16-byte vectors a thread: D <= 8 * 4 * 256

__device__ __forceinline__ float rnd(float v) {  // to bf16 and back, nearest even
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void load8_f32(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The sums of v[0..N) over the thread block, each in every thread
// (blockDim.x a multiple of 32); `red` is N * 32 floats of shared memory,
// free again on return. One pair of barriers serves all N sums.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = warp_sum(v[i]);
    if (lane == 0) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = warp_sum(lane < (int)(blockDim.x >> 5) ? red[i * 32 + lane] : 0.0f);
  __syncthreads();
}

struct LnArgs {
  const __nv_bfloat16* x;  // [rows, D] tokens
  const __nv_bfloat16* y;  // [rows, D] the residual branch, or null
  const float* gate;       // per-frame gate, or null
  const float* shift;      // per-frame AdaLN shift and scale, or null
  const float* scale;
  long long mod_sb, mod_sf;  // batch and frame strides of gate / shift / scale
  const __nv_bfloat16* weight;  // the affine's weight and bias (either may be null)
  const __nv_bfloat16* bias;
  __nv_bfloat16* x_out;    // [rows, D] new tokens (with y)
  __nv_bfloat16* out;      // [rows, D] normalised rows, or null (the residual alone)
  int F, fsl, D;           // frames a batch, rows a frame, width
  float eps, inv_d;
};

// Loads of one row of x (and y): VEC 16-byte vectors a thread, packed.
template <int VEC>
__device__ __forceinline__ void load_row(const LnArgs& a, long long row, int tid, int nt, int nvec,
                                         uint4 (&xr)[VEC], uint4 (&yr)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int idx = tid + j * nt;
    if (idx >= nvec) continue;
    xr[j] = reinterpret_cast<const uint4*>(a.x + row * a.D)[idx];
    if (a.y) yr[j] = reinterpret_cast<const uint4*>(a.y + row * a.D)[idx];
  }
}

// A thread block walks up to ROWS consecutive rows of one frame, one at a
// time (blockIdx.x = frame index * chunks + chunk), so that one set of the
// frame's operands serves them. (Issuing the next row's loads before this
// row's sums, or taking the rows together, ran slower on an H100: the
// registers it takes cost more blocks an SM than the overlap wins.)
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS) dit_add_ln_modulate_kernel(LnArgs a) {
  // Each thread's per-column operands as packed bf16, in shared memory that
  // only this thread touches (no barrier; registers stay free for the
  // rows): slot 0 the gate, 1 and 2 either 1 + scale and the shift, or the
  // affine's weight and bias.
  extern __shared__ uint4 slots[];
  __shared__ float red[32];
  const int tid = threadIdx.x, nt = blockDim.x, nvec = a.D >> 3;
  const int chunks = (a.fsl + ROWS - 1) / ROWS;
  const int frame = blockIdx.x / chunks, first = blockIdx.x % chunks * ROWS;
  const int count = min(ROWS, a.fsl - first);
  const long long row0 = (long long)frame * a.fsl + first;
  const bool modulated = a.shift != nullptr;
  // the row, packed (x and the residual's sum are bf16 values)
  uint4 xr[VEC], yr[VEC];
  load_row<VEC>(a, row0, tid, nt, nvec, xr, yr);
  const long long off = (long long)(frame / a.F) * a.mod_sb + (long long)(frame % a.F) * a.mod_sf;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int idx = tid + j * nt;
    if (idx >= nvec) continue;
    float f[8];
    if (a.gate) {
      load8_f32(a.gate + off + idx * 8, f);
      slots[j * nt + tid] = pack8(f);  // bf16(g), as gate() casts it
    }
    if (!a.out) continue;
    if (modulated) {
      load8_f32(a.scale + off + idx * 8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fadd_rn(1.0f, rnd(f[e]));  // 1 + bf16(scale)
      slots[(VEC + j) * nt + tid] = pack8(f);
      load8_f32(a.shift + off + idx * 8, f);
      slots[(2 * VEC + j) * nt + tid] = pack8(f);
    } else {
      slots[(VEC + j) * nt + tid] =
          a.weight ? __ldg(reinterpret_cast<const uint4*>(a.weight) + idx) : make_uint4(0, 0, 0, 0);
      slots[(2 * VEC + j) * nt + tid] =
          a.bias ? __ldg(reinterpret_cast<const uint4*>(a.bias) + idx) : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll 1
  for (int r = 0; r < count; ++r) {
    const long long row = row0 + r;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int idx = tid + j * nt;
      if (idx >= nvec || !a.y) continue;
      float v[8], yf[8], gf[8];
      unpack8(xr[j], v);
      unpack8(yr[j], yf);
      if (a.gate) {
        unpack8(slots[j * nt + tid], gf);
#pragma unroll
        for (int e = 0; e < 8; ++e) yf[e] = rnd(__fmul_rn(yf[e], gf[e]));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], yf[e]);
      xr[j] = pack8(v);  // bf16(x + y): the rounding of the residual add
      reinterpret_cast<uint4*>(a.x_out + row * a.D)[idx] = xr[j];
    }
    if (a.out) {
      float st[1] = {0.0f};
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (tid + j * nt >= nvec) continue;
        float v[8];
        unpack8(xr[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) st[0] = __fadd_rn(st[0], v[e]);
      }
      block_sums(st, red);
      const float mu = __fmul_rn(st[0], a.inv_d);
      st[0] = 0.0f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (tid + j * nt >= nvec) continue;
        float v[8];
        unpack8(xr[j], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float dv = __fsub_rn(v[e], mu);
          st[0] = __fadd_rn(st[0], __fmul_rn(dv, dv));
        }
      }
      block_sums(st, red);
      const float rs = rsqrtf(__fadd_rn(__fmul_rn(st[0], a.inv_d), a.eps));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int idx = tid + j * nt;
        if (idx >= nvec) continue;
        float v[8], p1[8], p2[8];
        unpack8(xr[j], v);
        unpack8(slots[(VEC + j) * nt + tid], p1);
        unpack8(slots[(2 * VEC + j) * nt + tid], p2);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float n = rnd(__fmul_rn(__fsub_rn(v[e], mu), rs));
          if (modulated) {
            n = rnd(__fadd_rn(rnd(__fmul_rn(n, p1[e])), p2[e]));
          } else {
            if (a.weight) n = rnd(__fmul_rn(n, p1[e]));
            if (a.bias) n = rnd(__fadd_rn(n, p2[e]));
          }
          v[e] = n;
        }
        reinterpret_cast<uint4*>(a.out + row * a.D)[idx] = pack8(v);
      }
    }
    if (r + 1 < count) load_row<VEC>(a, row + 1, tid, nt, nvec, xr, yr);
  }
}

struct QkArgs {
  const __nv_bfloat16* in[2];  // q and k rows (k may be null)
  long long in_stride;         // elements between rows
  const __nv_bfloat16* w[2];   // the norms' weights [D]
  __nv_bfloat16* out[2];       // [rows, D] contiguous
  const float* cos;            // [L, half] RoPE tables, or null
  const float* sin;
  int half;                    // Dh / 2
  int rows, L, D;
  float eps, inv_d;
};

// A thread block takes ROWS consecutive rows of q (blockIdx.y 0) or k (1)
// together, as above.
template <int VEC>
__global__ void __launch_bounds__(MAX_THREADS) dit_qk_norm_rope_kernel(QkArgs a) {
  extern __shared__ uint4 slots[];  // each thread's columns of the weight, as above
  __shared__ float red[ROWS * 32];
  const int which = blockIdx.y;
  const __nv_bfloat16* in = a.in[which];
  __nv_bfloat16* out = a.out[which];
  const int tid = threadIdx.x, nt = blockDim.x, nvec = a.D >> 3;
  const int row0 = blockIdx.x * ROWS, count = min(ROWS, a.rows - row0);
  uint4 xr[ROWS][VEC];  // the rows, packed
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int idx = tid + j * nt;
      if (r < count && idx < nvec)
        xr[r][j] = reinterpret_cast<const uint4*>(in + (long long)(row0 + r) * a.in_stride)[idx];
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int idx = tid + j * nt;
    if (idx < nvec) slots[j * nt + tid] = __ldg(reinterpret_cast<const uint4*>(a.w[which]) + idx);
  }
  float rs[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rs[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (r >= count || tid + j * nt >= nvec) continue;
      float v[8];
      unpack8(xr[r][j], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) rs[r] = __fadd_rn(rs[r], __fmul_rn(v[e], v[e]));
    }
  }
  block_sums(rs, red);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rs[r] = rsqrtf(__fadd_rn(__fmul_rn(rs[r], a.inv_d), a.eps));
    const int l = (row0 + r) % a.L;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int idx = tid + j * nt;
      if (r >= count || idx >= nvec) continue;
      float wf[8], o[8];
      unpack8(xr[r][j], o);
      unpack8(slots[j * nt + tid], wf);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = rnd(__fmul_rn(rnd(__fmul_rn(o[e], rs[r])), wf[e]));
      if (a.cos) {
        // the vector's four pairs lie in one head: half % 4 == 0
        const int p0 = (idx * 4) % a.half;
        float c[4], sn[4];
        const float4 c4 = __ldg(reinterpret_cast<const float4*>(a.cos + (long long)l * a.half + p0));
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.sin + (long long)l * a.half + p0));
        c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
        sn[0] = s4.x; sn[1] = s4.y; sn[2] = s4.z; sn[3] = s4.w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = o[2 * i], x1 = o[2 * i + 1];
          o[2 * i] = __fsub_rn(__fmul_rn(x0, c[i]), __fmul_rn(x1, sn[i]));
          o[2 * i + 1] = __fadd_rn(__fmul_rn(x0, sn[i]), __fmul_rn(x1, c[i]));
        }
      }
      reinterpret_cast<uint4*>(out + (long long)(row0 + r) * a.D)[idx] = pack8(o);
    }
  }
}

// The launch shape from D: VEC 16-byte vectors a thread. Preferred: the
// largest VEC that splits the row's D / 8 vectors evenly over 64 to 256
// threads (fewer threads a row, more rows in flight on an SM: 4 x 160 at D
// 5120, 3 x 64 at D 1536); else the fewest vectors a thread that fit 256
// threads, the last warp partly idle. 0 where D is not supported.
int pick_vec(int D, int* threads) {
  if (D <= 0 || D % 8 || D > 8 * MAX_VEC * MAX_THREADS) return 0;
  const int nvec = D / 8;
  int vec = 0;
  for (int v = MAX_VEC; v >= 1 && !vec; --v)
    if (nvec % v == 0 && nvec / v >= 64 && nvec / v <= MAX_THREADS) vec = v;
  for (int v = 1; v <= MAX_VEC && !vec; ++v)
    if ((nvec + v - 1) / v <= MAX_THREADS) vec = v;
  *threads = ((nvec + vec - 1) / vec + 31) / 32 * 32;
  return vec;
}

// Launch Launch<vec>'s kernel with `nslots` operand slots of shared memory
// a thread (up to 48 KB, beside the static 128 bytes: past the default
// limit only after raising the kernel's).
template <template <int> class Launch, typename Args>
int launch_vec(int vec, int nslots, dim3 grid, int threads, cudaStream_t st, const Args& a) {
  switch (vec) {
    case 1: return Launch<1>::run(nslots, grid, threads, st, a);
    case 2: return Launch<2>::run(nslots, grid, threads, st, a);
    case 3: return Launch<3>::run(nslots, grid, threads, st, a);
    case 4: return Launch<4>::run(nslots, grid, threads, st, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Kernel, typename Args>
int launch(Kernel kernel, int smem, dim3 grid, int threads, cudaStream_t st, const Args& a) {
  if (smem > 32 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int VEC>
struct LnLaunch {
  static int run(int nslots, dim3 grid, int threads, cudaStream_t st, const LnArgs& a) {
    return launch(dit_add_ln_modulate_kernel<VEC>, nslots * VEC * threads * 16, grid, threads,
                  st, a);
  }
};

template <int VEC>
struct QkLaunch {
  static int run(int nslots, dim3 grid, int threads, cudaStream_t st, const QkArgs& a) {
    return launch(dit_qk_norm_rope_kernel<VEC>, nslots * VEC * threads * 16, grid, threads, st,
                  a);
  }
};

}  // namespace

// Plain C entry points, bound with ctypes; each returns a cudaError_t (0 =
// launched). Pointers are device pointers, 16-byte aligned, bf16 unless
// named f32; strides in elements, multiples of 8 (bf16) or 4 (f32).

// tokens x [rows, D] (rows = B * L, L = F * fsl); y [rows, D] or null, then
// x_out [rows, D]; gate / shift / scale f32 with batch and frame strides
// mod_sb / mod_sf, each or null; weight / bias [D] or null; out [rows, D]
// or null (then y must be given).
extern "C" int rtv_add_ln_modulate(const void* x, const void* y, const void* gate,
                                   const void* shift, const void* scale, long long mod_sb,
                                   long long mod_sf, const void* weight, const void* bias,
                                   void* x_out, void* out, int rows, int L, int fsl, int D,
                                   float eps, void* stream) {
  int threads = 0;
  const int vec = pick_vec(D, &threads);
  if (!vec || rows <= 0 || L <= 0 || fsl <= 0 || L % fsl || rows % L) return (int)cudaErrorInvalidValue;
  if ((y == nullptr) != (x_out == nullptr) || (y == nullptr && out == nullptr) ||
      (shift == nullptr) != (scale == nullptr))
    return (int)cudaErrorInvalidValue;
  LnArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.y = static_cast<const __nv_bfloat16*>(y);
  a.gate = static_cast<const float*>(gate);
  a.shift = static_cast<const float*>(shift);
  a.scale = static_cast<const float*>(scale);
  a.mod_sb = mod_sb;
  a.mod_sf = mod_sf;
  a.weight = static_cast<const __nv_bfloat16*>(weight);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.x_out = static_cast<__nv_bfloat16*>(x_out);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.F = L / fsl;
  a.fsl = fsl;
  a.D = D;
  a.eps = eps;
  a.inv_d = 1.0f / (float)D;
  const long long blocks = (long long)(rows / fsl) * ((fsl + ROWS - 1) / ROWS);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch_vec<LnLaunch>(vec, 3, dim3((unsigned)blocks), threads,
                              reinterpret_cast<cudaStream_t>(stream), a);
}

// q (and k, or null) rows [rows, D] in_stride elements apart; q_w / k_w [D];
// cos / sin f32 [L, half] or null (no RoPE); q_out / k_out [rows, D].
extern "C" int rtv_qk_norm_rope(const void* q, const void* k, long long in_stride,
                                const void* q_w, const void* k_w, const void* cos,
                                const void* sin, int half, void* q_out, void* k_out, int rows,
                                int L, int D, float eps, void* stream) {
  int threads = 0;
  const int vec = pick_vec(D, &threads);
  if (!vec || rows <= 0 || L <= 0 || rows % L || in_stride < D) return (int)cudaErrorInvalidValue;
  if ((k == nullptr) != (k_out == nullptr) || (k != nullptr && k_w == nullptr) ||
      (cos == nullptr) != (sin == nullptr) || (cos != nullptr && (half <= 0 || half % 4 || D % (2 * half))))
    return (int)cudaErrorInvalidValue;
  QkArgs a;
  a.in[0] = static_cast<const __nv_bfloat16*>(q);
  a.in[1] = static_cast<const __nv_bfloat16*>(k);
  a.in_stride = in_stride;
  a.w[0] = static_cast<const __nv_bfloat16*>(q_w);
  a.w[1] = static_cast<const __nv_bfloat16*>(k_w);
  a.out[0] = static_cast<__nv_bfloat16*>(q_out);
  a.out[1] = static_cast<__nv_bfloat16*>(k_out);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.half = half;
  a.rows = rows;
  a.L = L;
  a.D = D;
  a.eps = eps;
  a.inv_d = 1.0f / (float)D;
  return launch_vec<QkLaunch>(vec, 1, dim3((rows + ROWS - 1) / ROWS, k ? 2 : 1), threads,
                              reinterpret_cast<cudaStream_t>(stream), a);
}
