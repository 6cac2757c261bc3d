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
//  * The GEMM tile (layout, K slices, dequantization in registers), the
//    X·A chunk and the correction epilogue are the device functions of
//    w4_gemm.cuh, shared with the MLP megakernel (mlp_fused.cu).
//  * X·A cannot use the TPU kernel's "n == 0 sweep" (blocks run in no
//    order), so it runs as a FIRST SMALL PHASE (xa_partial_kernel): each
//    block stages one 256-wide K chunk of X (8 rows) and one 128-column
//    rank chunk of A in shared memory with 16-byte loads, and each thread
//    sums whole (row, rank) outputs over the K chunk. The GEMM block then,
//    rank chunk by rank chunk, adds the partials, quantizes X·A per 16
//    columns (a chunk holds whole groups: R % 16 == 0 wherever R > 128)
//    and adds its product with B to the correction of its 32 columns; then
//    it quantizes the correction per 16 columns with a half-warp shuffle
//    and adds the bias. The rank is any multiple of 16 (the fused q|k|v
//    rank is 3R: 384 at the reference's rank 128), or any width up to 128
//    (one whole-row quantizer group). Chunking keeps the rank-order f32
//    sum of one pass over R.
//  * With the in-kernel activation quantizer (x_mb >= 0: the TPU kernel's
//    quant_x_mb, X arriving as raw f32) the first launch is
//    xq_partial_kernel, launched whatever the rank: each block stages its
//    8 rows of raw X over its 256-wide K chunk (whole 16-groups: K % 16 ==
//    0), quantizes them per 16 along K and rounds them to bf16 in shared
//    memory, writes them (the blocks of rank chunk 0) to the bf16 X scratch
//    that the GEMM launch reads, and sums its X·A partial from the same
//    values. The GEMM and the rank epilogue thus see one quantized X, the
//    values the separate quantizer gives (_quantize_rows_mx, exact
//    exponents), and a block quantizes only the groups it reads.
#include "w4_gemm.cuh"

namespace {

using namespace lqer;

// q_xa of one group of n X·A values of a row in place, then the bf16
// rounding the product with B sees (xa_mb < 0: no quantizer).
__device__ __forceinline__ void quantize_xa_group(float* v, int n, int xa_mb) {
  if (xa_mb >= 0) {
    float bmax = 0.f;
    for (int j = 0; j < n; ++j) bmax = fmaxf(bmax, fabsf(v[j]));
    const int e = group_exponent(bmax);
    for (int j = 0; j < n; ++j) v[j] = mx_value(v[j], e, xa_mb);
  }
  for (int j = 0; j < n; ++j) v[j] = bf16_round(v[j]);
}

__global__ void __launch_bounds__(NTHREADS)
xa_partial_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ a,
                  xa_sum_t* __restrict__ part, int M, int K, int R) {
  __shared__ XaSmem sm;
  xa_partial_tile<false>(x, a, part, M, K, R, blockIdx.x, blockIdx.y,
                         gridDim.y, blockIdx.z, sm);
}

// The first launch with the in-kernel activation quantizer: grid (8-row
// tiles, K chunks, rank chunks or 1). xraw (M, K) f32 raw; xq (M, K) bf16,
// written by the blocks of rank chunk 0.
__global__ void __launch_bounds__(NTHREADS)
xq_partial_kernel(const float* __restrict__ xraw,
                  __nv_bfloat16* __restrict__ xq,
                  const __nv_bfloat16* __restrict__ a,
                  xa_sum_t* __restrict__ part, int M, int K, int R,
                  int x_mb) {
  __shared__ XaSmem sm;
  const int mt = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const int k0 = s * XA_KC, kn = min(XA_KC, K - k0);
  for (int i = t; i < MT * XA_KC; i += NTHREADS) {
    const int m = i / XA_KC, kk = i % XA_KC, row = mt * MT + m;
    sm.xs[m][kk] = (row < M && kk < kn)
        ? __ldg(xraw + (size_t)row * K + k0 + kk) : 0.f;
  }
  __syncthreads();
  constexpr int GK = XA_KC / 16;   // 16-groups per row of the chunk
  for (int gi = t; gi < MT * GK; gi += NTHREADS) {
    const int m = gi / GK, g0 = gi % GK * 16, row = mt * MT + m;
    quantize_x_group(&sm.xs[m][g0], x_mb);
    if (blockIdx.z == 0 && row < M && g0 < kn)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xq[(size_t)row * K + k0 + g0 + j] = __float2bfloat16_rn(sm.xs[m][g0 + j]);
  }
  if (R > 0)   // its first barrier orders the quantized values before use
    xa_chunk_product(a, part, K, R, mt, s, gridDim.y, blockIdx.z, sm);
}

template <int MB>
__global__ void __launch_bounds__(NTHREADS)
gemm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ words,
            const int8_t* __restrict__ exps, const xa_sum_t* __restrict__ xa_part,
            const __nv_bfloat16* __restrict__ bmat,
            const float* __restrict__ bias, float* __restrict__ out, int M,
            int N, int K, int R, int KS, int xa_mb, int out_mb) {
  __shared__ GemmSmem sm;
  const int t = threadIdx.x;
  const int nb = blockIdx.x * TN;
  const int m0 = blockIdx.y * MT;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  w_accumulate<MB, false>(x, words, exps, M, N, K, m0, nb + (t % CT) * 4,
                          t / CT, acc);
  float y = slice_sum(acc, sm);

  const int m = t / TN, col = t % TN;
  const int row = m0 + m, n = nb + col;
  if (R > 0) {
    const int gsz = (R % 16 == 0) ? 16 : R;
    float corr = 0.f;
    for (int r0 = 0; r0 < R; r0 += RMAX) {
      const int rn = min(RMAX, R - r0), ng = rn / gsz;
      __syncthreads();   // the previous chunk's X·A is consumed
      for (int idx = t; idx < MT * rn; idx += NTHREADS) {
        const int mm = idx / rn, r = r0 + idx % rn;
        xa_sum_t v = 0;
#pragma unroll 4
        for (int s = 0; s < KS; ++s)
          v += __ldg(xa_part + (((size_t)blockIdx.y * KS + s) * MT + mm) * R + r);
        sm.xa[mm][idx % rn] = (float)v;   // rounded to f32 once
      }
      __syncthreads();
      for (int idx = t; idx < MT * ng; idx += NTHREADS) {
        const int mm = idx / ng, g0 = (idx % ng) * gsz;
        quantize_xa_group(&sm.xa[mm][g0], gsz, xa_mb);
      }
      __syncthreads();
      corr = correction_chunk(corr, sm.xa[m], bmat, r0, rn, N, n);
    }
    y += quantize_half_warp(corr, out_mb);
  }
  if (bias != nullptr) y += bias[n];
  if (row < M) out[(size_t)row * N + n] = y;
}

}  // namespace

// x (M, K) bf16; words (K/per, N) int32; exps (K/16, N) int8; a (K, R) bf16;
// b (R, N) bf16; bias (N) f32 or null; out (M, N) f32; xa_part scratch
// (ceil(M/8), ceil(K/256), 8, R) f64. R is a multiple of 16, or at most 128.
// mb 3 (W4) or 7 (W8); xa_mb / out_mb -1 for no partial-product quantizer.
// x_mb >= 0: x_raw (M, K) f32 is the raw activation, quantized in the
// kernel at x_mb mantissa bits (K % 16 == 0), and x the bf16 scratch the
// first launch fills; x_mb -1: x holds the quantized values, x_raw null.
LQER_API int lqer_dequant_gemm(void* x, const void* x_raw,
                               const void* words, const void* exps,
                               const void* a, const void* b, const void* bias,
                               void* out, void* xa_part, int M, int N, int K,
                               int R, int mb, int xa_mb, int out_mb, int x_mb,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int Mt = (M + MT - 1) / MT;
  const int KS = (K + XA_KC - 1) / XA_KC;
  if (R < 0 || (R > RMAX && R % 16 != 0) ||
      (x_mb >= 0 && (x_raw == nullptr || K % 16 != 0 || x_mb > 8)))
    return (int)cudaErrorInvalidValue;
  if (x_mb >= 0)
    xq_partial_kernel<<<dim3(Mt, KS, R > 0 ? rank_chunks(R) : 1), NTHREADS, 0,
                        st>>>(
        static_cast<const float*>(x_raw),
        static_cast<__nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(a), static_cast<xa_sum_t*>(xa_part),
        M, K, R, x_mb);
  else if (R > 0)
    xa_partial_kernel<<<dim3(Mt, KS, rank_chunks(R)), NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a),
        static_cast<xa_sum_t*>(xa_part), M, K, R);
  const dim3 grid(N / TN, Mt);
#define LQER_GEMM_ARGS                                                        \
  static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(words),        \
      static_cast<const int8_t*>(exps), static_cast<const xa_sum_t*>(xa_part), \
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
