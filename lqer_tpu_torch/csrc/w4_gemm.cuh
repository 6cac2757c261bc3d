// Device code shared by kernel 1 (dequant_gemm.cu) and the MLP megakernel
// (mlp_fused.cu): the MXINT4/MXINT8 weight-streaming GEMM tile, the X·A
// partial of one K chunk, the in-kernel activation quantizer of one 16-group,
// and the rank-k correction epilogue. The rank R
// (the fused rank of a q|k|v launch, or X·[A_g|A_u]) is a runtime width:
// X·A and the epilogue walk it in chunks of RMAX columns, the width of the
// shared-memory tile, so RMAX is a tile width, not a limit.
//
// A block of NTHREADS = 256 threads owns an 8-row by 32-column output tile.
// Layout (lqer_tpu_torch/ops/storage.py): int32 words (K/per, N), one word =
// 8 W4 codes (or 4 W8 codes) of one column along K; exponents (K/16, N)
// int8. A thread owns 4 adjacent columns and reads 16 contiguous bytes per
// load; eight column threads cover the 32 columns, and 32 K-slices of the
// block take the 16-row groups of K in turn (slice s: groups s, s + 32, ...).
// The slices are summed through shared memory.
//
// Loads of operands that the same launch wrote (the megakernel's H, X·A
// partials and quantized X·A) go through L2 (__ldcg): the read-only path and
// L1 are not coherent with another block's writes inside one launch. Inputs
// written before the launch take the read-only path (__ldg).
#pragma once

#include "mx_common.cuh"

namespace lqer {

constexpr int MT = 8;        // rows per block
constexpr int TN = 32;       // columns per block
constexpr int CT = 8;        // column threads, 4 columns each
constexpr int KSL = 32;      // K slices per block
constexpr int NTHREADS = CT * KSL;
constexpr int XA_KC = 256;   // K chunk of the X·A phase
constexpr int RMAX = 128;    // rank columns per X·A / epilogue chunk

// Shared memory of one block: the X·A phase and the GEMM epilogue use it in
// turn.
struct XaSmem {
  float xs[MT][XA_KC];
  __align__(16) __nv_bfloat16 as[XA_KC / 2 * RMAX];
};
struct GemmSmem {
  float red[KSL][MT][TN];
  float xa[MT][RMAX];
};
union Smem {
  XaSmem chunk;
  GemmSmem gemm;
};

template <bool COH, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (COH) return __ldcg(p);
  else return __ldg(p);
}

// The X·A sums (see xa_chunk_product): the accumulator of one K chunk's
// partial and the type of the partials' scratch and of their cross-chunk
// sum, both f64. tools/bench_xa_precision.py builds f32 variants with -D
// to time them and count the q_xa roundings they move.
#ifndef LQER_XA_CHUNK_T
#define LQER_XA_CHUNK_T double
#endif
#ifndef LQER_XA_SUM_T
#define LQER_XA_SUM_T double
#endif
using xa_chunk_t = LQER_XA_CHUNK_T;
using xa_sum_t = LQER_XA_SUM_T;

// Rank chunks of a width-R X·A row.
__host__ __device__ __forceinline__ int rank_chunks(int R) {
  return (R + RMAX - 1) / RMAX;
}

// Stage rows mt * MT.. of x (M, K) bf16 over K chunk s, [s * XA_KC,
// (s + 1) * XA_KC), into sm.xs as f32 (zeros past M and K).
template <bool COH>
__device__ __forceinline__ void stage_x_chunk(const __nv_bfloat16* x, int M,
                                              int K, int mt, int s,
                                              XaSmem& sm) {
  const int k0 = s * XA_KC, kn = min(XA_KC, K - k0);
  __syncthreads();   // the block's previous use of shared memory is done
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  for (int i = threadIdx.x; i < MT * XA_KC; i += NTHREADS) {
    const int m = i / XA_KC, kk = i % XA_KC, row = mt * MT + m;
    sm.xs[m][kk] = (row < M && kk < kn)
        ? __uint_as_float((uint32_t)ld<COH>(xb + (size_t)row * K + k0 + kk) << 16)
        : 0.f;
  }
}

// X·A over the K chunk s staged in sm.xs (rows of 8-row tile mt):
// part[((mt * KS + s) * MT + m) * R + r] for the rank columns r of chunk
// rc, [rc * RMAX, rc * RMAX + RMAX) ∩ [0, R), summed over k in
// [s * XA_KC, (s + 1) * XA_KC); a (K, R) bf16. Each thread sums whole
// (row, rank) outputs over the chunk, in k order, in f64: the products of
// bf16-exact values are exact in f32, barring underflow, and are converted
// to f64 once each (the conversion is the costly step); the chunk
// partials, summed in f64 too and rounded to f32 once, give the X·A value
// q_xa sees whatever the order (an f32 sum can land an ulp off, on a q_xa
// rounding tie, and move a whole output row).
__device__ __forceinline__ void xa_chunk_product(
    const __nv_bfloat16* __restrict__ a, xa_sum_t* part, int K, int R, int mt,
    int s, int KS, int rc, XaSmem& sm) {
  constexpr int HALF = XA_KC / 2;
  constexpr int OUT = MT * RMAX / NTHREADS;   // outputs per thread
  const int t = threadIdx.x;
  const int k0 = s * XA_KC, kn = min(XA_KC, K - k0);
  const int r0 = rc * RMAX, rn = min(RMAX, R - r0);
  xa_chunk_t acc[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) acc[o] = 0;
  for (int h = 0; h < kn; h += HALF) {
    // rows [k0 + h, k0 + h + kh) of A, columns [r0, r0 + rn), into a
    // (kh, rn) tile: 16-byte loads where R % 8 == 0 (then rn % 8 == 0 and
    // every row segment is 16-byte aligned)
    const int kh = min(HALF, kn - h);
    const __nv_bfloat16* src = a + (size_t)(k0 + h) * R + r0;
    __syncthreads();
    if (R % 8 == 0) {
      const int vr = rn / 8;   // 16-byte vectors per row segment
      for (int i = t; i < kh * vr; i += NTHREADS)
        reinterpret_cast<uint4*>(sm.as)[i] = __ldg(
            reinterpret_cast<const uint4*>(src + (size_t)(i / vr) * R) + i % vr);
    } else {
      for (int i = t; i < kh * rn; i += NTHREADS)
        sm.as[i] = src[(size_t)(i / rn) * R + i % rn];
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      const int idx = o * NTHREADS + t;
      if (idx < MT * rn) {
        const int m = idx / rn, r = idx % rn;
        xa_chunk_t v = acc[o];
#pragma unroll 8
        for (int kk = 0; kk < kh; ++kk)
          v += (xa_chunk_t)(sm.xs[m][h + kk] *
                            __bfloat162float(sm.as[kk * rn + r]));
        acc[o] = v;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int idx = o * NTHREADS + t;
    if (idx < MT * rn)
      part[(((size_t)mt * KS + s) * MT + idx / rn) * R + r0 + idx % rn] = acc[o];
  }
}

// X·A over one K chunk of x (M, K) bf16: stage_x_chunk, then
// xa_chunk_product.
template <bool COH>
__device__ __forceinline__ void xa_partial_tile(const __nv_bfloat16* x,
                                const __nv_bfloat16* __restrict__ a,
                                xa_sum_t* part, int M, int K, int R, int mt,
                                int s, int KS, int rc, XaSmem& sm) {
  stage_x_chunk<COH>(x, M, K, mt, s, sm);
  xa_chunk_product(a, part, K, R, mt, s, KS, rc, sm);
}

// The in-kernel activation quantizer: the 16 raw f32 values v[0..15] of one
// group along K quantized per the group's absmax at x_mb mantissa bits and
// rounded to bf16 (exact on the grid of widths <= 9; a passthrough value
// |v| <= 1e-8 rounds as the separate quantizer's bf16 output does), in
// place.
__device__ __forceinline__ void quantize_x_group(float* v, int x_mb) {
  float bmax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, fabsf(v[j]));
  const int e = group_exponent(bmax);
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = bf16_round(mx_value(v[j], e, x_mb));
}

// Accumulate rows m0..m0+7 of x (M, K) bf16 times the packed weight's
// columns n0..n0+3 over this thread's K slice into acc (MB 3: W4, 7: W8).
template <int MB, bool COH>
__device__ __forceinline__ void w_accumulate(
    const __nv_bfloat16* x, const int* __restrict__ words,
    const int8_t* __restrict__ exps, int M, int N, int K, int m0, int n0,
    int sl, float (&acc)[MT][4]) {
  constexpr int BITS = (MB == 3) ? 4 : 8;
  constexpr int PER = 32 / BITS;   // codes per word
  constexpr int WPG = 16 / PER;    // words per 16-group
  const int G = K / 16;
  for (int g = sl; g < G; g += KSL) {
    const char4 e4 = *reinterpret_cast<const char4*>(exps + (size_t)g * N + n0);
    const float sc[4] = {exp2_int(e4.x - MB), exp2_int(e4.y - MB),
                         exp2_int(e4.z - MB), exp2_int(e4.w - MB)};
#pragma unroll
    for (int wi = 0; wi < WPG; ++wi) {
      const int o = g * WPG + wi;
      const int4 w4 = __ldg(reinterpret_cast<const int4*>(words + (size_t)o * N + n0));
      const int wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const int k0 = g * 16 + wi * PER;
      uint32_t xr[MT][PER / 2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int row = m0 + m;
        if (row < M) {
          const __nv_bfloat16* src = x + (size_t)row * K + k0;
          if constexpr (PER == 8) {
            const uint4 u = ld<COH>(reinterpret_cast<const uint4*>(src));
            xr[m][0] = u.x; xr[m][1] = u.y; xr[m][2] = u.z; xr[m][3] = u.w;
          } else {
            const uint2 u = ld<COH>(reinterpret_cast<const uint2*>(src));
            xr[m][0] = u.x; xr[m][1] = u.y;
          }
        } else {
#pragma unroll
          for (int h = 0; h < PER / 2; ++h) xr[m][h] = 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        float wf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wf[c] = (float)((int)((unsigned)wv[c] << (32 - BITS * (i + 1))) >> (32 - BITS)) * sc[c];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = (i & 1) ? bf16_hi(xr[m][i / 2]) : bf16_lo(xr[m][i / 2]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
        }
      }
    }
  }
}

// Sum the K slices of acc through shared memory; thread t gets the output
// of row t / TN, column t % TN of the block's tile.
__device__ __forceinline__ float slice_sum(const float (&acc)[MT][4],
                                           GemmSmem& sm) {
  const int t = threadIdx.x;
  const int ct = t % CT, sl = t / CT;
  __syncthreads();   // the block's previous use of shared memory is done
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) sm.red[sl][m][ct * 4 + c] = acc[m][c];
  __syncthreads();
  const int m = t / TN, col = t % TN;
  float y = 0.f;
  for (int s = 0; s < KSL; ++s) y += sm.red[s][m][col];
  return y;
}

// Quantize v per 16 columns: the group is this half-warp (every lane of
// the warp must call it). mb < 0: no quantizer.
__device__ __forceinline__ float quantize_half_warp(float v, int mb) {
  if (mb < 0) return v;
  float bmax = fabsf(v);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
  return mx_value(v, group_exponent(bmax), mb);
}

// corr + xa_chunk · B[r0 : r0 + rn, n] for rn values of the quantized,
// bf16-rounded X·A row (rank columns r0..r0+rn-1) and B (R, N) bf16: one
// rank chunk of the correction, summed in rank order. The caller quantizes
// the whole sum per 16 columns (quantize_half_warp) after the last chunk.
__device__ __forceinline__ float correction_chunk(float corr, const float* xa,
                                const __nv_bfloat16* __restrict__ bmat,
                                int r0, int rn, int N, int n) {
  for (int r = 0; r < rn; ++r)
    corr = fmaf(xa[r], __bfloat162float(bmat[(size_t)(r0 + r) * N + n]), corr);
  return corr;
}

}  // namespace lqer
