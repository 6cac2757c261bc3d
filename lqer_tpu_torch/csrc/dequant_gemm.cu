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
// 1.06 per W8) at 3.35 TB/s; at M in the hundreds (an admission below the
// 512-row large-M route) by the products.
//
// Design (w4_gemm.cuh has the tile):
//  * Launch 1, xa_kernel, grid (8-row tiles, K ranges, rank chunks of 64):
//    X·A in f64 per K range (sized from the card's SM count by
//    ops/kernels/dequant_gemm.py::xa_plan, so the launch fills the card).
//    The last block of a rank chunk (a ticket) sums its chunks' partials in
//    chunk order, rounds them to f32 once, quantizes them per 16 columns
//    (q_xa) and writes the bf16-rounded values: X·A is summed once per row
//    tile, and a GEMM block reads 8 (or 64) finished rows of it. A rank
//    that is not a multiple of 16 is one whole-row group: the last block of
//    the row tile's chunks finishes the row. With the in-kernel activation
//    quantizer (x_mb >= 0: the TPU kernel's quant_x_mb, X arriving as raw
//    f32) the launch runs whatever the rank: each block quantizes its rows
//    of raw X over its K range per 16 along K, rounds them to bf16 and sums
//    its X·A partial from those values; the blocks of rank chunk 0 also
//    write them to the bf16 X scratch that launch 2 reads, then raise a
//    count.
//  * Launch 2 is a programmatic dependent launch of launch 1: its blocks
//    start beside launch 1 and put their first stages' weights in flight;
//    with the in-kernel quantizer they wait for the count of quantized K
//    ranges before they load X, and they wait for launch 1 to end
//    (griddepcontrol.wait) only before they read xa.
//  * Launch 2, gemm_kernel, grid (column tiles, row tiles, K splits): the
//    tensor-core tile of w4_gemm.cuh (8 x 256 at M <= 8, 64 x 128 above)
//    over its K split (gemm_plan: splits from (M, N, K) and the SM count,
//    about two blocks an SM); the last split of a tile (a ticket) sums the
//    splits' partials in split order, adds q_out(xa · B) (rank order,
//    chunks of 64 rank columns in shared memory, q_out per 16 columns over
//    4 lanes) and the bias, and writes the tile.
#include "w4_gemm.cuh"

namespace {

using namespace lqer;

// Launch 1, grid (8-row tiles, K ranges of KC, rank chunks). x (M, K)
// bf16, or with xraw (M, K) raw f32 the bf16 scratch it fills (the blocks
// of rank chunk 0, then they raise xq_ready); a (K, R); part (Mt, KS, 8,
// R); xa (Mt * 8, R) f32; counters Mt * rank chunks, zero.
__global__ void __launch_bounds__(NTHREADS, 3)
xa_kernel(const __nv_bfloat16* x, const float* __restrict__ xraw,
          __nv_bfloat16* xq, const __nv_bfloat16* __restrict__ a,
          xa_sum_t* __restrict__ part, float* __restrict__ xa,
          int* __restrict__ counters, int* __restrict__ xq_ready, int M,
          int K, int R, int KC, int xa_mb, int x_mb) {
  __shared__ XaSmem sm;
  // launch 2 may start (programmatic dependent launch): it streams its
  // weights, waits for xq_ready before it reads X and for this grid before
  // it reads xa
  asm volatile("griddepcontrol.launch_dependents;");
  const int mt = blockIdx.x, s = blockIdx.y, rc = blockIdx.z, t = threadIdx.x;
  const int KS = gridDim.y, k0 = s * KC, k1 = min(K, k0 + KC);
  // the blocks of rank chunk 0 write the quantized X of their K range as
  // they stage it, then raise xq_ready
  const XaInput in{x, xraw, rc == 0 ? xq : nullptr, x_mb};
  xa_tile<false>(in, a, part, M, K, R, mt, s, KS, k0, k1, rc * XA_RC, sm);
  if (xraw != nullptr && rc == 0) signal_count(xq_ready);
  if (R == 0) return;

  const bool whole = R % 16 != 0;   // one whole-row q_xa group
  if (!last_of_tile(counters + (whole ? mt : mt * gridDim.z + rc),
                    whole ? KS * gridDim.z : KS))
    return;
  if (!whole) {   // 16-column groups: a half-warp each
    xa_finish16(part, xa, R, 0, R, mt, KS, rc * XA_RC,
                min(XA_RC, R - rc * XA_RC), xa_mb);
  } else {        // one group a row: a warp each
    const int m = t / 32, lane = t % 32;
    int e = 0;
    if (xa_mb >= 0) {
      float bmax = 0.f;
      for (int c = lane; c < R; c += 32)
        bmax = fmaxf(bmax, fabsf(xa_value(part, R, mt, KS, m, c)));
      e = group_exponent(warp_max_xor(bmax));
    }
    for (int c = lane; c < R; c += 32) {
      const float v = xa_value(part, R, mt, KS, m, c);
      xa[(size_t)(mt * 8 + m) * R + c] =
          bf16_round(xa_mb >= 0 ? mx_value(v, e, xa_mb) : v);
    }
  }
}

// Launch 2. x: bf16 (M, K) (with xq_target > 0 written by launch 1 beside
// it: the blocks wait for xq_ready to reach xq_target before they load it);
// gpart: splits x (row tiles * MTILE, N) f32 partials (splits > 1);
// counters: row tiles * column tiles, zero.
template <class C, int MB>
__global__ void __launch_bounds__(NTHREADS, 2)
gemm_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ words,
            const int8_t* __restrict__ exps, const float* __restrict__ xa,
            const __nv_bfloat16* __restrict__ bmat,
            const float* __restrict__ bias, float* __restrict__ out,
            float* __restrict__ gpart, int* __restrict__ counters,
            int* __restrict__ xq_ready, int xq_target, int M, int N, int K,
            int R, int gps, int out_mb) {
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * C::TN, m0 = blockIdx.y * C::MTILE;
  const int s = blockIdx.z, S = gridDim.z;
  const int g0 = s * gps, g1 = min(K / 16, g0 + gps);
  Acc<C> y;
  w_mainloop<C, MB>(x, M, K, m0, words, exps, N, n0, g0, g1, smem, y,
                    xq_target > 0 ? xq_ready : nullptr, xq_target);
  if (xq_target > 0 && threadIdx.x == 0) {
    // the last block past its wait leaves xq_ready (and its own count) at
    // zero for the next launch
    const int blocks = gridDim.x * gridDim.y * gridDim.z;
    if (atomicAdd(xq_ready + 1, 1) == blocks - 1) {
      xq_ready[0] = 0;
      xq_ready[1] = 0;
    }
  }
  if (S > 1) {
    const size_t stride = (size_t)gridDim.y * C::MTILE * N;
    store_partial<C>(y, gpart + s * stride, N, m0, n0);
    if (!last_of_tile(counters + blockIdx.y * gridDim.x + blockIdx.x, S))
      return;
    sum_partials<C>(y, gpart, stride, S, N, m0, n0);
  }
  if (R > 0) {
    // launch 1 (X·A) has ended and its writes are visible
    asm volatile("griddepcontrol.wait;" ::: "memory");
    add_correction<C, false>(y, xa, R, 0, R, M, bmat, N, m0, n0, out_mb,
                             smem);
  }
  add_bias<C>(y, bias, N, n0);
  store_out<C>(y, out, M, N, m0, n0);
}

// Launch 2, as a programmatic dependent launch of launch 1 where pdl.
template <class C, int MB>
int launch_gemm(const void* x, const void* words, const void* exps,
                const void* xa, const void* b, const void* bias, void* out,
                void* gpart, int* counters, int* xq_ready, int xq_target,
                int M, int N, int K, int R, int splits, int gps, int out_mb,
                bool pdl, cudaStream_t st) {
  constexpr int SMEM = Ring<C, MB>::BYTES > CorrSmem<C>::BYTES
                           ? Ring<C, MB>::BYTES : CorrSmem<C>::BYTES;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<C, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  cudaLaunchAttribute la[1];
  la[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  la[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + C::TN - 1) / C::TN, (M + C::MTILE - 1) / C::MTILE,
                     splits);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cfg.attrs = la;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, gemm_kernel<C, MB>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(words), static_cast<const int8_t*>(exps),
      static_cast<const float*>(xa), static_cast<const __nv_bfloat16*>(b),
      static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<float*>(gpart), counters, xq_ready, xq_target, M, N, K, R,
      gps, out_mb);
}

}  // namespace

// x (M, K) bf16; words (K/per, N) int32; exps (K/16, N) int8; a (K, R) bf16;
// b (R, N) bf16; bias (N) f32 or null; out (M, N) f32. Scratch (sizes from
// ops/kernels/dequant_gemm.py::plan): xa_part (ceil(M/8), KS, 8, R) f64
// with KS = ceil(K / xa_kc), xa_kc the K range of an X·A block; xa
// (ceil(M/8) * 8, R) f32; gpart (splits, row tiles * tile rows, N) f32
// when splits > 1; counters (2 + row tiles * column tiles + ceil(M/8) *
// ceil(R/64)) int32, zero (the kernels leave them zero). The GEMM splits K's 16-groups into `splits` runs of gps. mb 3
// (W4) or 7 (W8); xa_mb / out_mb -1 for no partial-product quantizer.
// x_mb >= 0: x_raw (M, K) f32 is the raw activation, quantized in the
// kernel at x_mb mantissa bits (K % 16 == 0), and x the bf16 scratch the
// first launch fills; x_mb -1: x holds the quantized values, x_raw null.
LQER_API int lqer_dequant_gemm(void* x, const void* x_raw, const void* words,
                               const void* exps, const void* a, const void* b,
                               const void* bias, void* out, void* xa_part,
                               void* xa, void* gpart, void* counters, int M,
                               int N, int K, int R, int mb, int xa_mb,
                               int out_mb, int x_mb, int splits, int gps,
                               int xa_kc, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int G = K / 16;
  if (M <= 0 || R < 0 || K % 16 || N % 32 || splits < 1 || gps < 1 ||
      (splits - 1) * gps >= G || splits * gps < G || xa_kc < 16 ||
      xa_kc % 16 ||
      (x_mb >= 0 && (x_raw == nullptr || x_mb > 8)) ||
      (splits > 1 && gpart == nullptr) || (R > 0 && (xa_part == nullptr || xa == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int Mt = (M + 7) / 8, KS = (K + xa_kc - 1) / xa_kc;
  const int RC = R > 0 ? (R + XA_RC - 1) / XA_RC : 1;
  const bool decode = M <= TileDecode::MTILE;
  const int gemm_tiles =
      decode ? ((N + TileDecode::TN - 1) / TileDecode::TN)
             : ((M + TilePrefill::MTILE - 1) / TilePrefill::MTILE) *
                   ((N + TilePrefill::TN - 1) / TilePrefill::TN);
  // counters: launch 1's X-ready count and launch 2's count past it, the
  // GEMM tiles' tickets, the X·A chunks' tickets
  int* xq_ready = static_cast<int*>(counters);
  int* cnt = xq_ready + 2;
  const bool run_xa = R > 0 || x_mb >= 0;
  if (run_xa) {
    xa_kernel<<<dim3(Mt, KS, RC), NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(x_raw),
        static_cast<__nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(a),
        static_cast<xa_sum_t*>(xa_part), static_cast<float*>(xa),
        cnt + gemm_tiles, xq_ready, M, K, R, xa_kc, xa_mb, x_mb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // launch 2 beside launch 1: with the in-kernel quantizer its blocks wait
  // for the Mt * KS blocks of rank chunk 0 to write the quantized X
  const int xq_target = x_mb >= 0 ? Mt * KS : 0;
#define LQER_GEMM(C, MB)                                                     \
  launch_gemm<C, MB>(x, words, exps, xa, b, bias, out, gpart, cnt, xq_ready, \
                     xq_target, M, N, K, R, splits, gps, out_mb, run_xa, st)
  if (mb == 3) return decode ? LQER_GEMM(TileDecode, 3) : LQER_GEMM(TilePrefill, 3);
  if (mb == 7) return decode ? LQER_GEMM(TileDecode, 7) : LQER_GEMM(TilePrefill, 7);
#undef LQER_GEMM
  return (int)cudaErrorInvalidValue;
}
