// Row helpers shared by the kernels that quantize rows to int8 (the dynx
// quantize of quant_matmul.cu, K3b in layernorm_kernel.cu): 16-byte loads
// and stores of bf16 / f16 / f32 values in f32 registers, and the quotient
// x / scale bit for bit as an IEEE divide gives it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// 16 bytes of T at p (16-byte aligned) to or from kElems f32 values (the
// loads that quant_matmul.cu's quantize takes, the stores of
// layernorm_kernel.cu)
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <> struct Vec<__half> {
  static constexpr int kElems = 8;
  __device__ static void store(__half* p, const float* f) {
    uint4 raw;
    __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <> struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    f[0] = t.x; f[1] = t.y; f[2] = t.z; f[3] = t.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// x / scale rounded to nearest even, as an IEEE divide gives it, from inv =
// 1 / scale rounded to nearest (computed once a row), scale > 0: q = x * inv
// is within an ulp of the quotient, the fma gives its remainder
// r = x - scale * q exactly, and one more fma rounds q + r * inv to the
// correctly rounded quotient (Markstein's theorem; |x / scale| <= 127 here,
// far from overflow, and a quotient small enough to underflow rounds to 0
// either way). That fma is taken negated, -(-r * inv - q), so that x = -0
// keeps its sign (-0 + +0 would round to +0). Three instructions where
// __fdiv_rn takes a subroutine call; checked bitwise against the IEEE
// divide on every finite bf16 value, on f32 values next to each rounding
// boundary and on +-0 (tests/test_torch_gpu.py, tools/k4_variants.py).
__device__ __forceinline__ float quotient(float x, float scale, float inv) {
  const float q = __fmul_rn(x, inv);
  return -__fmaf_rn(-__fmaf_rn(-scale, q, x), inv, -q);
}
