// Kernel 6: unpack a packed MXINT4/MXINT8 weight to a dense bf16 (K, N).
//
// Replaces lqer_tpu/ops/pallas/dequant_gemm.py::_unpack_kernel (entry
// unpack_tiles_to_bf16), the first step of the large-M route: at 512 rows
// and more the linears and the MLP dequantize each weight once and run one
// dense product, instead of re-dequantizing it in every 8-row tile.
// Computes out[k, n] = code(k, n) · 2^(e(k / 16, n) − mb), which is exact
// in bf16 (codes of at most 8 significant bits), so it is bit-exact with
// its plain version.
//
// What bounds it on an H100: bytes. It reads 0.53 byte per W4 weight
// (1.06 per W8) and writes 2; at 3.35 TB/s one 4096 x 11264 W4 weight takes
// at least 0.035 ms.
//
// Design: a thread owns one word row o (8 W4 codes, or 4 W8 codes, along K)
// of 8 adjacent columns: two 16-byte loads of words and one 8-byte load of
// their exponents, then one 16-byte store of 8 bf16 per K row. Neighbouring
// threads take neighbouring columns, so loads and stores are contiguous
// across a warp. The weight may be one layer's view of a layer-stacked
// array: only the pointers move.
#include "mx_common.cuh"

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <int MB>
__global__ void __launch_bounds__(NTHREADS)
unpack_kernel(const int* __restrict__ words, const int8_t* __restrict__ exps,
              __nv_bfloat16* __restrict__ out, int K, int N) {
  constexpr int BITS = MB + 1;
  constexpr int PER = 32 / BITS;   // codes per word
  const int n8 = N / 8;
  const size_t idx = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= (size_t)(K / PER) * n8) return;
  const int o = (int)(idx / n8), c = (int)(idx % n8) * 8;
  const int4* wp = reinterpret_cast<const int4*>(words + (size_t)o * N + c);
  const int4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
  const int wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int g = o * PER / 16;
  const uint2 e8 = __ldg(reinterpret_cast<const uint2*>(exps + (size_t)g * N + c));
  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t word = j < 4 ? e8.x : e8.y;
    sc[j] = exp2_int((int)(int8_t)(word >> (8 * (j % 4))) - MB);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (float)((int)((unsigned)wv[j] << (32 - BITS * (i + 1))) >> (32 - BITS)) * sc[j];
    const uint4 packed = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                    bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
    *reinterpret_cast<uint4*>(out + (size_t)(o * PER + i) * N + c) = packed;
  }
}

}  // namespace

// words (K/per, N) int32 (16-byte aligned); exps (K/16, N) int8 (8-byte
// aligned); out (K, N) bf16. mb 3 (W4) or 7 (W8); N % 8 == 0.
LQER_API int lqer_unpack(const void* words, const void* exps, void* out,
                         int K, int N, int mb, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (N % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t threads = (size_t)(K / (32 / (mb + 1))) * (N / 8);
  const unsigned blocks = (unsigned)((threads + NTHREADS - 1) / NTHREADS);
  if (blocks == 0) return 0;
#define LQER_UNPACK_ARGS                                                      \
  static_cast<const int*>(words), static_cast<const int8_t*>(exps),            \
      static_cast<__nv_bfloat16*>(out), K, N
  if (mb == 3)
    unpack_kernel<3><<<blocks, NTHREADS, 0, st>>>(LQER_UNPACK_ARGS);
  else if (mb == 7)
    unpack_kernel<7><<<blocks, NTHREADS, 0, st>>>(LQER_UNPACK_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef LQER_UNPACK_ARGS
  return (int)cudaGetLastError();
}
