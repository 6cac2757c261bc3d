// Kernel 1: MXINT4/MXINT8 dequant-GEMM with the rank-k LQER epilogue.
//
// Replaces lqer_tpu/ops/pallas/dequant_gemm.py::_kernel (entry
// qlinear_w4_fused). Computes
//     Y = X_q · deq(W)^T + q_out(bf16(q_xa(X_q · A)) · B) + bias
// with deq(W) = code · 2^(e − mb) (mb 3 for W4, 7 for the W8 lm_head) and
// q_xa / q_out the per-row block_fp quantizers in groups of 16 (one
// whole-row group when the rank is not a multiple of 16).
//
// What bounds it on an H100: at decode (M = 8 rows) it is a weight-streaming
// GEMV, bound by reading the packed weights (0.53 byte per W4 weight,
// 1.06 per W8) at 3.35 TB/s. Every product is exact in f32 (bf16-exact
// activations times codes of at most 8 significant bits), so the kernel
// accumulates with plain f32 FMAs on the CUDA cores (no TF32, no tensor
// cores yet); at M = 8 that puts it near the FMA issue rate as much as the
// memory rate. Prefill (M in the hundreds) runs the same kernel over
// 8-row M tiles, re-reading the weights per tile from L2.
//
// Design:
//  * Layout (lqer_tpu_torch/ops/storage.py): int32 words (K/per, N), one
//    word = 8 W4 codes (or 4 W8 codes) of one column along K; exponents
//    (K/16, N) int8. A thread owns 4 adjacent columns and reads 16
//    contiguous bytes per load; eight column threads cover a 32-column
//    tile, and 32 K-slices of the block take the 16-row groups of K in
//    turn (slice s: groups s, s + 32, ...). The slices are summed through
//    shared memory. The dequantization happens in registers.
//  * X·A cannot use the TPU kernel's "n == 0 sweep" (blocks run in no
//    order), so it runs as a FIRST SMALL PHASE (xa_partial_kernel): each
//    block stages one 256-wide K chunk of X (8 rows) and of A in shared
//    memory with 16-byte loads, and each thread sums whole (row, rank)
//    outputs over the chunk. The GEMM block then adds the chunk partials,
//    quantizes X·A per row, multiplies by its 32 columns of B, quantizes
//    the correction per 16 columns with a half-warp shuffle, and adds the
//    bias.
#include "mx_common.cuh"

namespace {

constexpr int MT = 8;        // rows per block
constexpr int TN = 32;       // columns per block
constexpr int CT = 8;        // column threads, 4 columns each
constexpr int KSL = 32;      // K slices per block
constexpr int NTHREADS = CT * KSL;
constexpr int XA_KC = 256;   // K chunk of the X·A phase
constexpr int RMAX = 128;    // largest (fused) rank

__global__ void __launch_bounds__(NTHREADS)
xa_partial_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ a,
                  float* __restrict__ part, int M, int K, int R) {
  constexpr int HALF = XA_KC / 2;
  constexpr int OUT = MT * RMAX / NTHREADS;   // outputs per thread
  const int mt = blockIdx.x, s = blockIdx.y, KS = gridDim.y;
  const int t = threadIdx.x;
  const int k0 = s * XA_KC, kn = min(XA_KC, K - k0);
  __shared__ float xs[MT][XA_KC];
  __shared__ __align__(16) __nv_bfloat16 as[HALF * RMAX];
  for (int i = t; i < MT * XA_KC; i += NTHREADS) {
    const int m = i / XA_KC, kk = i % XA_KC, row = mt * MT + m;
    xs[m][kk] = (row < M && kk < kn) ? __bfloat162float(x[(size_t)row * K + k0 + kk]) : 0.f;
  }
  float acc[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) acc[o] = 0.f;
  for (int h = 0; h < kn; h += HALF) {
    // rows [k0 + h, k0 + h + HALF) of A are one contiguous span
    const int n = min(HALF, kn - h) * R;
    const __nv_bfloat16* src = a + (size_t)(k0 + h) * R;
    __syncthreads();
    if (R % 8 == 0) {
      for (int i = t; i < n / 8; i += NTHREADS)
        reinterpret_cast<uint4*>(as)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    } else {
      for (int i = t; i < n; i += NTHREADS) as[i] = src[i];
    }
    __syncthreads();
    const int kh = n / R;
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      const int idx = o * NTHREADS + t;
      if (idx < MT * R) {
        const int m = idx / R, r = idx % R;
        float v = acc[o];
#pragma unroll 8
        for (int kk = 0; kk < kh; ++kk)
          v = fmaf(xs[m][h + kk], __bfloat162float(as[kk * R + r]), v);
        acc[o] = v;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int idx = o * NTHREADS + t;
    if (idx < MT * R) part[((size_t)mt * KS + s) * MT * R + idx] = acc[o];
  }
}

template <int MB>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ words,
            const int8_t* __restrict__ exps, const float* __restrict__ xa_part,
            const __nv_bfloat16* __restrict__ bmat,
            const float* __restrict__ bias, float* __restrict__ out, int M,
            int N, int K, int R, int KS, int xa_mb, int out_mb) {
  constexpr int BITS = (MB == 3) ? 4 : 8;
  constexpr int PER = 32 / BITS;   // codes per word
  constexpr int WPG = 16 / PER;    // words per 16-group
  const int t = threadIdx.x;
  const int ct = t % CT, sl = t / CT;
  const int nb = blockIdx.x * TN;
  const int n0 = nb + ct * 4;
  const int m0 = blockIdx.y * MT;
  const int G = K / 16;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

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
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
            xr[m][0] = u.x; xr[m][1] = u.y; xr[m][2] = u.z; xr[m][3] = u.w;
          } else {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
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

  __shared__ float red[KSL][MT][TN];
  __shared__ float xa_s[MT][RMAX];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[sl][m][ct * 4 + c] = acc[m][c];
  __syncthreads();

  const int m = t / TN, col = t % TN;
  const int row = m0 + m, n = nb + col;
  float y = 0.f;
  for (int s = 0; s < KSL; ++s) y += red[s][m][col];

  if (R > 0) {
    for (int idx = t; idx < MT * R; idx += NTHREADS) {
      const int mm = idx / R, r = idx % R;
      float v = 0.f;
#pragma unroll 4
      for (int s = 0; s < KS; ++s)
        v += __ldg(xa_part + (((size_t)blockIdx.y * KS + s) * MT + mm) * R + r);
      xa_s[mm][r] = v;
    }
    __syncthreads();
    const int gsz = (R % 16 == 0) ? 16 : R;
    const int ng = R / gsz;
    for (int idx = t; idx < MT * ng; idx += NTHREADS) {
      const int mm = idx / ng, g0 = (idx % ng) * gsz;
      if (xa_mb >= 0) {
        float bmax = 0.f;
        for (int j = 0; j < gsz; ++j) bmax = fmaxf(bmax, fabsf(xa_s[mm][g0 + j]));
        const int e = group_exponent(bmax);
        for (int j = 0; j < gsz; ++j) xa_s[mm][g0 + j] = mx_value(xa_s[mm][g0 + j], e, xa_mb);
      }
      for (int j = 0; j < gsz; ++j) xa_s[mm][g0 + j] = bf16_round(xa_s[mm][g0 + j]);
    }
    __syncthreads();
    float corr = 0.f;
    for (int r = 0; r < R; ++r)
      corr = fmaf(xa_s[m][r], __bfloat162float(bmat[(size_t)r * N + n]), corr);
    if (out_mb >= 0) {
      // 16-column groups = the two half-warps of this row's warp
      float bmax = fabsf(corr);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      corr = mx_value(corr, group_exponent(bmax), out_mb);
    }
    y += corr;
  }
  if (bias != nullptr) y += bias[n];
  if (row < M) out[(size_t)row * N + n] = y;
}

}  // namespace

// x (M, K) bf16; words (K/per, N) int32; exps (K/16, N) int8; a (K, R) bf16;
// b (R, N) bf16; bias (N) f32 or null; out (M, N) f32; xa_part scratch
// (ceil(M/8), ceil(K/256), 8, R) f32. mb 3 (W4) or 7 (W8); xa_mb / out_mb
// -1 for no partial-product quantizer.
LQER_API int lqer_dequant_gemm(const void* x, const void* words,
                               const void* exps, const void* a, const void* b,
                               const void* bias, void* out, void* xa_part,
                               int M, int N, int K, int R, int mb, int xa_mb,
                               int out_mb, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int Mt = (M + MT - 1) / MT;
  const int KS = (K + XA_KC - 1) / XA_KC;
  if (R > RMAX) return (int)cudaErrorInvalidValue;
  if (R > 0)
    xa_partial_kernel<<<dim3(Mt, KS), NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a),
        static_cast<float*>(xa_part), M, K, R);
  const dim3 grid(N / TN, Mt);
#define LQER_GEMM_ARGS                                                        \
  static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(words),        \
      static_cast<const int8_t*>(exps), static_cast<const float*>(xa_part),    \
      static_cast<const __nv_bfloat16*>(b), static_cast<const float*>(bias),   \
      static_cast<float*>(out), M, N, K, R, KS, xa_mb, out_mb
  if (mb == 3)
    gemm_kernel<3><<<grid, NTHREADS, 0, st>>>(LQER_GEMM_ARGS);
  else if (mb == 7)
    gemm_kernel<7><<<grid, NTHREADS, 0, st>>>(LQER_GEMM_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef LQER_GEMM_ARGS
  return (int)cudaGetLastError();
}
