// Building blocks shared by the decode attention kernels (one query token
// per slot; the split-over-L kernels of decode_split.cuh and
// decode_mx_split.cuh) and the cache writes:
//   - the queries quantized per 16 along d into shared memory;
//   - the MXINT8 or MXINT4 encode of a fresh K/V row into one cache column;
//   - the causal and sliding-window mask, and the first column a kernel
//     reads under a window.
// The MXINT4 layout is d-split: packed row i holds value i in its low
// nibble and value i + d/2 in its high nibble, both sign-extended; a code of
// width w decodes as code * 2^(e - (w - 1)).
#pragma once

#include "mx_common.cuh"

namespace decode {

constexpr int NREP_MAX = 8;

// The mask of every decode kernel: the key at column j counts for the query
// at pos where j <= pos and, under a sliding window (window > 0; -1 for
// none), pos - window < j.
__device__ __forceinline__ bool in_window(int j, int pos, int window) {
  return j <= pos && (window < 0 || j > pos - window);
}

// The first column a kernel reads for the query at pos: the start of the
// 16-token group that holds the window's first key, 0 without a window.
// The groups below hold masked keys only (p = 0 there), so skipping them
// changes nothing; the masked keys inside this group keep p = 0 in its P
// quantizer group, as the TPU kernel's do.
__device__ __forceinline__ int window_start(int pos, int window) {
  return window < 0 ? 0 : max(0, pos - window + 1) / 16 * 16;
}

__device__ __forceinline__ int low_nibble(int byte) {
  return (int)((unsigned)byte << 28) >> 28;
}

__device__ __forceinline__ int high_nibble(int byte) {
  return (int)((unsigned)byte << 24) >> 28;
}

// qs[h * D + d] = q of query head h quantized per 16 along d (block_fp,
// mantissa bits q_mb; q_mb < 0 keeps q); q points at the block's n_rep rows.
template <int D>
__device__ __forceinline__ void quantize_queries(const float* q, float* qs,
                                                 int nrep, int q_mb) {
  constexpr int GD = D / 16;
  for (int idx = threadIdx.x; idx < nrep * GD; idx += blockDim.x) {
    const int h = idx / GD, g = idx % GD;
    const float* qrow = q + (size_t)h * D + g * 16;
    float vals[16];
    float bmax = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      vals[j] = qrow[j];
      bmax = fmaxf(bmax, fabsf(vals[j]));
    }
    const int e = group_exponent(bmax);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      qs[h * D + g * 16 + j] = q_mb >= 0 ? mx_value(vals[j], e, q_mb) : vals[j];
  }
}

// The MXINT8 code of v in a group of exponent e (cache_write._encode_t:
// sign(v + 1e-9) * round((|v| + 1e-9) / 2^e * 128), the rounding clamped to
// [0, 127]); every MXINT8 cache write stores this byte.
__device__ __forceinline__ int8_t mx8_code(float v, int e) {
  return (int8_t)(int)__fmul_rn(sign_eps(v), mx_mant(v, e, 7));
}

// MXINT8 encode of the 16 values src[0..15] (cache_write._encode_t: exact
// exponent, an all-zero group takes exponent 0, codes clamp to ±127) into
// rows g*16 .. g*16+15 of column col of the codes and row g of the exps.
__device__ __forceinline__ void encode_group(const float* src, int8_t* codes,
                                             int8_t* exps, int stride,
                                             int col, int g) {
  float bmax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, fabsf(src[j]));
  const int e = group_exponent(bmax);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    codes[(size_t)(g * 16 + j) * stride + col] = mx8_code(src[j], e);
  exps[(size_t)g * stride + col] = (int8_t)e;
}

// MXINT4 encode (cache_write._encode_t with mb = 3 and the d-split nibble
// pack) of the groups g and g + D/32 of the D values row[0..D-1] into
// column col: packed rows g*16 .. g*16+15 take value i in the low nibble
// and value i + D/2 in the high one, codes clamp to ±7, an all-zero group
// takes exponent 0; exps rows g and g + D/32.
template <int D>
__device__ __forceinline__ void encode_group_packed(const float* row,
                                                    int8_t* codes,
                                                    int8_t* exps, int stride,
                                                    int col, int g) {
  const float* lo = row + g * 16;
  const float* hi = row + D / 2 + g * 16;
  float bl = 0.f, bh = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bl = fmaxf(bl, fabsf(lo[j]));
    bh = fmaxf(bh, fabsf(hi[j]));
  }
  const int el = group_exponent(bl), eh = group_exponent(bh);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int cl = (int)__fmul_rn(sign_eps(lo[j]), mx_mant(lo[j], el, 3));
    const int ch = (int)__fmul_rn(sign_eps(hi[j]), mx_mant(hi[j], eh, 3));
    codes[(size_t)(g * 16 + j) * stride + col] =
        (int8_t)(((ch & 0xF) << 4) | (cl & 0xF));
  }
  exps[(size_t)g * stride + col] = (int8_t)el;
  exps[(size_t)(g + D / 32) * stride + col] = (int8_t)eh;
}

// The fresh K and V rows kh, vh (D values each) of one (slot, kv head)
// encoded at code width CW (encode_group, or encode_group_packed at 4) into
// column col of its codes (D or D/2 rows) and exps (D/16 rows) of token
// stride `stride`, thread-strided over the block.
template <int D, int CW>
__device__ __forceinline__ void encode_kv_column(const float* kh,
                                                 const float* vh, int8_t* kc,
                                                 int8_t* ke, int8_t* vc,
                                                 int8_t* ve, int stride,
                                                 int col) {
  constexpr int NG = CW == 8 ? D / 16 : D / 32;  // encodes per row
  for (int idx = threadIdx.x; idx < 2 * NG; idx += blockDim.x) {
    const int g = idx % NG;
    const bool is_v = idx >= NG;
    if constexpr (CW == 8)
      encode_group((is_v ? vh : kh) + g * 16, is_v ? vc : kc, is_v ? ve : ke,
                   stride, col, g);
    else
      encode_group_packed<D>(is_v ? vh : kh, is_v ? vc : kc, is_v ? ve : ke,
                             stride, col, g);
  }
}

}  // namespace decode
