// Shared MXINT numerics of the port's CUDA kernels.
//
// These are the device twins of lqer_tpu_torch/parallel/collectives.py:
// exponents come from the float's bits (ceil_log2_exact), powers of two are
// built from bits (exp2_int), and the block_fp quantize-dequantize keeps the
// reference's f32 operation order: sign(v + 1e-9), (|v| + 1e-9) / 2^e * 2^mb,
// round half to even, clamp to [0, 2^mb - 1], |v| <= 1e-8 passes through.
// The intrinsics (__fadd_rn, __fdiv_rn, __fmul_rn) keep nvcc from contracting
// any of it into an FMA, so a kernel quantizes a given f32 value exactly as
// the plain PyTorch versions (and the JAX package) do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LQER_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ int ceil_log2_exact(float x) {
  const int bits = __float_as_int(x);
  const int be = (bits >> 23) & 0xFF;
  const int m = bits & 0x7FFFFF;
  const int e = (be == 0) ? -127 : be - 127 + (m != 0 ? 1 : 0);
  return max(-127, min(128, e));
}

// Exact 2^e for integer e in [-149, 128] (128 gives inf).
__device__ __forceinline__ float exp2_int(int e) {
  if (e >= -126) return __int_as_float(min(e + 127, 255) << 23);
  return __int_as_float(1 << max(e + 149, 0));
}

__device__ __forceinline__ float sign_eps(float v) {
  const float s = __fadd_rn(v, 1e-9f);
  return s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
}

// Integer mantissa of v on the grid 2^e / 2^mb.
__device__ __forceinline__ float mx_mant(float v, int e, int mb) {
  const float shift = (float)(1 << mb);
  const float m = rintf(__fmul_rn(__fdiv_rn(__fadd_rn(fabsf(v), 1e-9f),
                                            exp2_int(e)), shift));
  return fminf(fmaxf(m, 0.f), shift - 1.f);
}

// block_fp quantize-dequantize of v against its group exponent e.
__device__ __forceinline__ float mx_value(float v, int e, int mb) {
  if (fabsf(v) <= 1e-8f) return v;
  const float shift = (float)(1 << mb);
  return __fmul_rn(__fmul_rn(sign_eps(v), exp2_int(e)),
                   __fdiv_rn(mx_mant(v, e, mb), shift));
}

// mx_value with the group's rounding constants computed once (mx_group),
// for a group exponent e <= MX_GROUP_EMAX and mb <= 20 (callers take
// mx_value past them). mx_value rounds x = (|v| + 1e-9) / 2^e * 2^mb; for
// |v| > 1e-8 and such e both scalings are exact, so x = a / s with
// a = |v| + 1e-9 and the grid step s = 2^(e - mb). Adding and subtracting
// big = 1.5 * 2^(e - mb + 23) rounds a to that grid, to nearest with ties
// to even (a + big stays in big's binade, whose ulp is s, and big / s is
// even): rint(x) * s. The clamp to (2^mb - 1) * s and the sign follow, and
// |v| > 1e-8 has the sign of v + 1e-9: so mx_group_value equals
// mx_value(v, e, mb) to the bit, a zero's sign included, in seven
// branch-free instructions.
constexpr int MX_GROUP_EMAX = 99;  // a * 2^-e stays a normal float

struct MxGroup {
  float big;  // 1.5 * 2^(e - mb + 23)
  float top;  // (2^mb - 1) * 2^(e - mb)
};

__device__ __forceinline__ MxGroup mx_group(int e, int mb) {
  return MxGroup{1.5f * exp2_int(e - mb + 23),
                 (float)((1 << mb) - 1) * exp2_int(e - mb)};
}

__device__ __forceinline__ float mx_group_value(float v, const MxGroup& g) {
  const float a = __fadd_rn(fabsf(v), 1e-9f);
  const float q = fminf(__fsub_rn(__fadd_rn(a, g.big), g.big), g.top);
  return fabsf(v) <= 1e-8f ? v : copysignf(q, v);
}

// Group exponent from a group absmax; all-zero groups use 1.0 (their
// values pass through or encode to code 0 either way).
__device__ __forceinline__ int group_exponent(float absmax) {
  return ceil_log2_exact(absmax == 0.f ? 1.f : absmax);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float warp_sum_xor(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max_xor(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
