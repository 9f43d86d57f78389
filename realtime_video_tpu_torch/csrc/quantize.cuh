// The per-tensor s8 quantiser shared by the int8 kernels' pre-passes
// (csrc/int8_mm.cu for the DiT linears, csrc/conv_sm90.cu for the VAE convs):
//   q(x) = clip(rint(x / a), -127, 127)
// with the correctly rounded IEEE quotient x / a and round half to even, so
// the quanta equal those of torch.round(x.float() / a) and of the JAX
// package's jnp.round. It takes r = RN(1 / a) once and corrects x * r twice
// with the exact FMA remainder x - q * a; the second correction starts within
// an ulp of x / a, where Markstein's theorem makes RN(q + (x - q a) r) the
// correctly rounded quotient. (The TPU kernels multiply by a reciprocal
// without correction and can differ by 1 LSB at exact halves.) The build
// uses no fast-math.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rtv_quant {

// clip(rint(RN(x / a)), -127, 127), with r = RN(1 / a)
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

}  // namespace rtv_quant
