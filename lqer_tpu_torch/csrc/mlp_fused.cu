// Kernel 5: the whole-MLP megakernel, one cooperative launch per MLP.
//
// Replaces lqer_tpu/ops/pallas/mlp_fused.py::_mlp_kernel (entry
// mlp_w4_fused), both of its variants with LQER corrections, for fewer than
// 512 rows. The gated silu variant (Llama) computes
//     y_g = X W_g^T + q_out(bf16(q_xa(X A_g)) B_g) [+ b_g]   (likewise y_u)
//     H   = bf16(q_act(silu(y_g) · y_u))
//     Y   = H W_d^T + q_out(bf16(q_xa(H A_d)) B_d) [+ b_d]
// and the un-gated relu variant (OPT's fc1, fc2 with biases) has no up
// half: H = bf16(q_act(relu(y_g))). Each bias (f32, on the b_quantizer's
// grid) is added after its correction, as the TPU kernel adds it. MXINT4
// weights (code · 2^(e − 3)) and the per-row block_fp quantizers in groups
// of 16; y_g and y_u stay f32 until H is quantized.
//
// What bounds it on an H100: at decode (8 rows) it streams the packed
// weights (about 0.53 byte per weight: 79 MB for Llama-2-7B's three, 75 MB
// for OPT-6.7B's two) at 3.35 TB/s.
//
// Design. The TPU kernel walks a sequential two-phase grid and carries the
// (M, I) intermediate in VMEM. CUDA blocks run in no order, so this is a
// persistent cooperative launch (cudaLaunchCooperativeKernel, a grid no
// larger than the co-resident blocks) whose phases are separated by grid
// barriers (cooperative_groups::this_grid().sync(); CUDA 12 needs no -rdc
// for it):
//   0. with the in-kernel activation quantizer (the TPU kernel's
//      quant_x_mb; X arrives raw f32): the blocks walk X's 16-groups along
//      K, quantize each (w4_gemm.cuh's quantize_x_group, the separate
//      quantizer's values) into the bf16 X scratch that phases A and B
//      read through L2; barrier. Only this first input is raw: H is
//      quantized in the kernel by act_mb already;
//   A. X·A_gu partials per (8-row tile, 256-wide K chunk, 128-column rank
//      chunk), in f64, barrier; then per (row, rank column) the sum of the
//      partials rounded to f32 once, q_xa per 16 columns (half-warps),
//      bf16, into the xa
//      scratch; barrier. A_gu is [A_g | A_u] (2R wide) gated, A_g (R wide)
//      un-gated. R is any multiple of 16: the scratch is global and sized
//      from R at launch, and each correction walks its R columns of the xa
//      scratch in chunks of the 128-column shared-memory tile, summing in
//      rank order, then quantizes the sum per 16 columns.
//   B. blocks walk (8-row tile, 32 columns of I): the gate (and up) W4
//      GEMM tiles of kernel 1 (w4_gemm.cuh), the corrections and biases,
//      silu·mul or relu and the MXINT8 quantizer of H per 16 columns (a
//      half-warp), all in the block; H goes to a global bf16 scratch
//      (M x I: 262 KB at M = 8, I = 16384; it stays in L2); barrier.
//   C. H·A_d like A, into the xa scratch; barriers.
//   D. blocks walk (8-row tile, 32 columns of N): the down W4 GEMM tile, its
//      correction epilogue and bias, written as f32.
// Reads of H, the partials and the quantized X·A go through L2 (__ldcg).
#include <cooperative_groups.h>

#include <algorithm>

#include "w4_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace lqer;

struct MlpArgs {
  const __nv_bfloat16* x;                     // (M, K)
  const float* x_raw;                         // (M, K) raw, or null
  __nv_bfloat16* xq;                          // x, filled by phase 0
  const int* codes_g; const int8_t* exps_g;   // (K/8, I), (K/16, I)
  const int* codes_u; const int8_t* exps_u;
  const int* codes_d; const int8_t* exps_d;   // (I/8, N), (I/16, N)
  const __nv_bfloat16* a_gu;                  // (K, WGU)
  const __nv_bfloat16* b_g;                   // (R, I)
  const __nv_bfloat16* b_u;                   // (R, I)
  const __nv_bfloat16* a_d;                   // (I, R)
  const __nv_bfloat16* b_d;                   // (R, N)
  const float* bias_g;                        // (I) or null
  const float* bias_u;                        // (I) or null
  const float* bias_d;                        // (N) or null
  __nv_bfloat16* h;                           // (Mt * 8, I) scratch
  xa_sum_t* part;                             // X·A chunk partials scratch
  float* xa;                                  // (Mt * 8, XS) scratch
  float* out;                                 // (M, N)
  int M, K, I, N, R, act_mb, xa_mb, out_mb, x_mb;
  bool gated;                                 // the up half exists
  int WGU, XS;   // X·A_gu width (2R gated, R un-gated); xa row: WGU + R
};

// X·A (rows of x times a (K, W)) of every row into xa[:, off:off + W],
// quantized per 16 columns and rounded to bf16. Ends at a grid barrier.
template <bool COH>
__device__ void xa_phase(cg::grid_group& grid, const __nv_bfloat16* x,
                         const __nv_bfloat16* a, int K, int W, int off,
                         const MlpArgs& p, Smem& sm) {
  const int Mt = (p.M + MT - 1) / MT;
  const int KS = (K + XA_KC - 1) / XA_KC;
  const int RC = rank_chunks(W);
  for (int item = blockIdx.x; item < Mt * KS * RC; item += gridDim.x)
    xa_partial_tile<COH>(x, a, p.part, p.M, K, W, item / (KS * RC),
                         item / RC % KS, KS, item % RC, sm.chunk);
  grid.sync();
  // W % 16 == 0, so a 16-column group of a row is one half-warp
  const int total = p.M * W;
  for (int base = blockIdx.x * NTHREADS; base < total;
       base += gridDim.x * NTHREADS) {
    const int idx = base + threadIdx.x;
    const int row = idx / W, col = idx % W;
    xa_sum_t v64 = 0;
    if (idx < total) {
      const xa_sum_t* src = p.part + ((size_t)(row / MT) * KS * MT + row % MT) * W + col;
      for (int s = 0; s < KS; ++s) v64 += __ldcg(src + (size_t)s * MT * W);
    }
    // rounded to f32 once (w4_gemm.cuh's xa_chunk_product)
    const float v = bf16_round(quantize_half_warp((float)v64, p.xa_mb));
    if (idx < total) p.xa[(size_t)row * p.XS + off + col] = v;
  }
  grid.sync();
}

// q_out of the correction of column n for row m0 + threadIdx.x / TN: the
// quantized X·A columns [off, off + R) of rows m0..m0+7, staged in shared
// memory 128 rank columns at a time, times B (R, N). Every thread of the
// block calls it.
__device__ __forceinline__ float correction(GemmSmem& sm, const MlpArgs& p,
                                            int m0, int off,
                                            const __nv_bfloat16* bmat, int N,
                                            int n) {
  const int m = threadIdx.x / TN;
  float corr = 0.f;
  for (int r0 = 0; r0 < p.R; r0 += RMAX) {
    const int rn = min(RMAX, p.R - r0);
    __syncthreads();   // the previous chunk (or the slice sums) is consumed
    for (int i = threadIdx.x; i < MT * rn; i += NTHREADS) {
      const int mm = i / rn, c = i % rn, row = m0 + mm;
      sm.xa[mm][c] = row < p.M
          ? __ldcg(p.xa + (size_t)row * p.XS + off + r0 + c) : 0.f;
    }
    __syncthreads();
    corr = correction_chunk(corr, sm.xa[m], bmat, r0, rn, N, n);
  }
  return quantize_half_warp(corr, p.out_mb);
}

// The W4 GEMM tile of rows m0.. and columns nb.. of x (M, K) times a packed
// (K/8, N) weight, its K slices summed (thread t: row t / TN, column
// t % TN).
template <bool COH>
__device__ __forceinline__ float gemm_tile(const __nv_bfloat16* x,
                                           const int* codes,
                                           const int8_t* exps, int M, int N,
                                           int K, int m0, int nb,
                                           GemmSmem& sm) {
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  w_accumulate<3, COH>(x, codes, exps, M, N, K, m0,
                       nb + (threadIdx.x % CT) * 4, threadIdx.x / CT, acc);
  return slice_sum(acc, sm);
}

__global__ void __launch_bounds__(NTHREADS, 2) mlp_kernel(const MlpArgs p) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int Mt = (p.M + MT - 1) / MT;
  const int R = p.R;
  const int m = t / TN, col = t % TN;

  // 0: raw X quantized per 16 along K into the bf16 scratch
  const bool qx = p.x_raw != nullptr;
  if (qx) {
    const int total = p.M * (p.K / 16);   // rows are whole groups
    for (int gi = blockIdx.x * NTHREADS + t; gi < total;
         gi += gridDim.x * NTHREADS) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = __ldg(p.x_raw + (size_t)gi * 16 + j);
      quantize_x_group(v, p.x_mb);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        p.xq[(size_t)gi * 16 + j] = __float2bfloat16_rn(v[j]);
    }
    grid.sync();
  }
  // X written in this launch is read through L2
  if (R > 0) {
    if (qx) xa_phase<true>(grid, p.x, p.a_gu, p.K, p.WGU, 0, p, sm);
    else xa_phase<false>(grid, p.x, p.a_gu, p.K, p.WGU, 0, p, sm);
  }

  // B: gate (and up) tiles, corrections, biases, activation, act quantizer
  // -> H
  const int nI = p.I / TN;
  for (int item = blockIdx.x; item < Mt * nI; item += gridDim.x) {
    const int m0 = (item / nI) * MT, nb = (item % nI) * TN;
    float yg = qx ? gemm_tile<true>(p.x, p.codes_g, p.exps_g, p.M, p.I, p.K,
                                    m0, nb, sm.gemm)
                  : gemm_tile<false>(p.x, p.codes_g, p.exps_g, p.M, p.I, p.K,
                                     m0, nb, sm.gemm);
    float yu = 0.f;
    if (p.gated)
      yu = qx ? gemm_tile<true>(p.x, p.codes_u, p.exps_u, p.M, p.I, p.K, m0,
                                nb, sm.gemm)
              : gemm_tile<false>(p.x, p.codes_u, p.exps_u, p.M, p.I, p.K, m0,
                                 nb, sm.gemm);
    const int n = nb + col, row = m0 + m;
    if (R > 0) {
      yg += correction(sm.gemm, p, m0, 0, p.b_g, p.I, n);
      if (p.gated) yu += correction(sm.gemm, p, m0, R, p.b_u, p.I, n);
    }
    if (p.bias_g != nullptr) yg += __ldg(p.bias_g + n);
    if (p.bias_u != nullptr) yu += __ldg(p.bias_u + n);
    const float a = p.gated ? yg / (1.f + expf(-yg)) * yu : fmaxf(yg, 0.f);
    const float hv = bf16_round(quantize_half_warp(a, p.act_mb));
    if (row < p.M) p.h[(size_t)row * p.I + n] = __float2bfloat16_rn(hv);
  }
  grid.sync();

  if (R > 0) xa_phase<true>(grid, p.h, p.a_d, p.I, R, p.WGU, p, sm);

  // D: down tiles over H, correction epilogue and bias -> Y
  const int nN = p.N / TN;
  for (int item = blockIdx.x; item < Mt * nN; item += gridDim.x) {
    const int m0 = (item / nN) * MT, nb = (item % nN) * TN;
    float y = gemm_tile<true>(p.h, p.codes_d, p.exps_d, p.M, p.N, p.I, m0, nb,
                              sm.gemm);
    const int n = nb + col, row = m0 + m;
    if (R > 0) y += correction(sm.gemm, p, m0, p.WGU, p.b_d, p.N, n);
    if (p.bias_d != nullptr) y += __ldg(p.bias_d + n);
    if (row < p.M) p.out[(size_t)row * p.N + n] = y;
  }
}

}  // namespace

// x (M, K) bf16 (with x_mb >= 0 a scratch the kernel fills from x_raw
// (M, K) f32, quantized at x_mb mantissa bits; x_raw null otherwise);
// codes/exps of gate, up (K/8, I), (K/16, I) and down
// (I/8, N), (I/16, N), up null for the un-gated relu variant; a_gu (K, WGU)
// with WGU = 2R gated ([A_g | A_u]) or R, b_g and b_u (R, I), a_d (I, R),
// b_d (R, N) bf16 (null when R == 0); biases bias_g, bias_u (I) and bias_d
// (N) f32 or null; scratch h (ceil(M/8) * 8, I) bf16, part (ceil(M/8),
// ceil(max(K, I)/256), 8, WGU) f64, xa (ceil(M/8) * 8, WGU + R) f32; out
// (M, N) f32. R % 16 == 0 (any such rank); K % 16, I % 32 and N % 32 == 0.
// act_mb: mantissa bits of the H quantizer; xa_mb / out_mb -1 for no
// partial-product quantizer.
LQER_API int lqer_mlp_fused(void* x, const void* x_raw, const void* codes_g,
                            const void* exps_g, const void* codes_u,
                            const void* exps_u, const void* codes_d,
                            const void* exps_d, const void* a_gu,
                            const void* b_g, const void* b_u, const void* a_d,
                            const void* b_d, const void* bias_g,
                            const void* bias_u, const void* bias_d, void* h,
                            void* part, void* xa, void* out, int M, int K,
                            int I, int N, int R, int act_mb, int xa_mb,
                            int out_mb, int x_mb, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool gated = codes_u != nullptr;
  const int wgu = gated ? 2 * R : R;
  if (M <= 0 || R < 0 || R % 16 || K % 16 || I % TN || N % TN
      || (!gated && (b_u != nullptr || bias_u != nullptr))
      || (x_mb >= 0 && (x_raw == nullptr || x_mb > 8)))
    return (int)cudaErrorInvalidValue;
  static int resident = 0;   // co-resident blocks on this card
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_kernel,
                                                        NTHREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident = per_sm * sms;
  }
  const int Mt = (M + MT - 1) / MT;
  const int blocks = std::min(resident, Mt * std::max(I, N) / TN);
  MlpArgs p{static_cast<const __nv_bfloat16*>(x),
            x_mb >= 0 ? static_cast<const float*>(x_raw) : nullptr,
            static_cast<__nv_bfloat16*>(x),
            static_cast<const int*>(codes_g), static_cast<const int8_t*>(exps_g),
            static_cast<const int*>(codes_u), static_cast<const int8_t*>(exps_u),
            static_cast<const int*>(codes_d), static_cast<const int8_t*>(exps_d),
            static_cast<const __nv_bfloat16*>(a_gu),
            static_cast<const __nv_bfloat16*>(b_g),
            static_cast<const __nv_bfloat16*>(b_u),
            static_cast<const __nv_bfloat16*>(a_d),
            static_cast<const __nv_bfloat16*>(b_d),
            static_cast<const float*>(bias_g), static_cast<const float*>(bias_u),
            static_cast<const float*>(bias_d),
            static_cast<__nv_bfloat16*>(h), static_cast<xa_sum_t*>(part),
            static_cast<float*>(xa), static_cast<float*>(out),
            M, K, I, N, R, act_mb, xa_mb, out_mb, x_mb, gated, wgu,
            wgu + R};
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_kernel), dim3(blocks), dim3(NTHREADS), args,
      0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
