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
// for OPT-6.7B's two) at 3.35 TB/s; at M in the hundreds, the products.
//
// Design. The TPU kernel walks a sequential two-phase grid and carries the
// (M, I) intermediate in VMEM. CUDA blocks run in no order, so this is a
// persistent cooperative launch (cudaLaunchCooperativeKernel, a grid no
// larger than the co-resident blocks at its dynamic shared memory; CUDA 12
// needs no -rdc for the grid barrier):
//   0. with the in-kernel activation quantizer (the TPU kernel's
//      quant_x_mb; X arrives raw f32): the blocks walk X's 16-groups along
//      K, quantize each (w4_gemm.cuh's quantize_x_group, the separate
//      quantizer's values) into the bf16 X scratch that phases A and B
//      read through L2; grid barrier. Only this first input is raw: H is
//      quantized in the kernel by act_mb already;
//   A + B, one walk of items, the X·A ones first (a block takes its items
//      in order, so every X·A item is done before any block waits on
//      one): A's items are X·A_gu partials per (8-row tile, K range,
//      64-column rank chunk) in f64 (w4_gemm.cuh's xa_tile), the last range
//      of a chunk (a ticket) summing them in range order, rounding to f32
//      once, quantizing per 16 columns (q_xa) and rounding to bf16 into
//      the xa scratch, then raising a count; B's items are (row tile,
//      column tile of I, K split, half): the tensor-core tile of w4_gemm.cuh
//      over the gate (or up) weight and the split's K range; the last block
//      of a column tile (a ticket over its splits and halves) sums the
//      partials in split order, waits for the count of finished X·A
//      chunks, adds the corrections (rank order) and biases, applies
//      silu·mul or relu and the MXINT8 quantizer of H per 16 columns, and
//      writes H (a global bf16 scratch, M x I: it stays in L2). A_gu is
//      [A_g | A_u] (2R wide) gated, A_g (R wide) un-gated; R is any
//      multiple of 16. Grid barrier: H is whole;
//   C + D likewise: H·A_d's items, then (row tile, column tile of N, K
//      split) items of the down weight over H, the last split of a tile
//      adding its correction once H·A_d is finished, and the bias, as f32.
// ops/kernels/mlp_fused.py::plan sizes the splits and ranges from the card's
// SM count. Reads of what this launch wrote (X, H, the partials, the
// quantized X·A) go through L2 (__ldcg or cp.async.cg).
#include <cooperative_groups.h>

#include <algorithm>

#include "w4_gemm.cuh"

namespace cg = cooperative_groups;

// -D LQER_PHASE_CLOCK (tools/bench_w4_parts.py): %globaltimer (ns) of the
// phase boundaries of the last launch in lqer_phase_clock: [0] block 0's
// start, [1] after phase 0, [4] after A and B, [7] the last block's end
// (atomicMax). A slot a launch does not reach keeps 0 (slots 2, 3, 5, 6,
// the X·A phases' own barriers in kernels that had them, are not used).
#ifdef LQER_PHASE_CLOCK
__device__ unsigned long long lqer_phase_clock[8];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define LQER_CLOCK(i)                                                  \
  do {                                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) lqer_phase_clock[i] = global_ns(); \
  } while (0)
#define LQER_CLOCK_END()                                               \
  do {                                                                 \
    if (threadIdx.x == 0) atomicMax(&lqer_phase_clock[7], global_ns()); \
  } while (0)
#else
#define LQER_CLOCK(i) do {} while (0)
#define LQER_CLOCK_END() do {} while (0)
#endif

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
  float* gpart;                               // split-K partials scratch
  int* counters;                              // tickets of B's, D's tiles
  float* out;                                 // (M, N)
  int M, K, I, N, R, act_mb, xa_mb, out_mb, x_mb;
  bool gated;                                 // the up half exists
  int WGU, XS;   // X·A_gu width (2R gated, R un-gated); xa row: WGU + R
  int splits_b, gps_b, splits_d, gps_d;       // K splits of B and D
  int kc_a, kc_c;                             // K chunks of A's, C's X·A
};

// Item `item` of an X·A phase (rows of x times a (K, W), into xa[:, off:off
// + W]): its K range's partial; the last range of a chunk (a ticket at
// chunk) finishes the chunk (w4_gemm.cuh's xa_finish16) and raises ready.
template <bool COH>
__device__ void xa_item(int item, const XaInput& in, const __nv_bfloat16* a,
                        int K, int W, int off, int KC, const MlpArgs& p,
                        int* chunk, int* ready, XaSmem& sm) {
  const int KS = (K + KC - 1) / KC, RC = (W + XA_RC - 1) / XA_RC;
  const int mt = item / (KS * RC), s = item / RC % KS, rc = item % RC;
  xa_tile<COH>(in, a, p.part, p.M, K, W, mt, s, KS, s * KC,
               min(K, s * KC + KC), rc * XA_RC, sm);
  if (!last_of_tile(chunk + mt * RC + rc, KS)) return;
  xa_finish16(p.part, p.xa, p.XS, off, W, mt, KS, rc * XA_RC,
              min(XA_RC, W - rc * XA_RC), p.xa_mb);
  signal_count(ready);
}

// Phase B's epilogue of one column tile: y holds the gate's sum (or the
// gate's partials are at gpart when `summed` is false), the up half's
// partials follow the gate's S slots; the corrections wait for the X·A
// chunks (ready reaching chunks). Writes H rows < M.
template <class C>
__device__ void gate_up_epilogue(Acc<C>& y, bool summed, const MlpArgs& p,
                                 size_t stride, int m0, int n0, int* ready,
                                 int chunks, char* smem) {
  const int S = p.splits_b;
  if (!summed) sum_partials<C>(y, p.gpart, stride, S, p.I, m0, n0);
  if (p.R > 0) {
    wait_count(ready, chunks);   // X·A_gu is finished
    add_correction<C, true>(y, p.xa, p.XS, 0, p.R, p.M, p.b_g, p.I, m0, n0,
                            p.out_mb, smem);
  }
  add_bias<C>(y, p.bias_g, p.I, n0);
  if (p.gated) {
    Acc<C> u;
    sum_partials<C>(u, p.gpart + S * stride, stride, S, p.I, m0, n0);
    if (p.R > 0)
      add_correction<C, true>(u, p.xa, p.XS, p.R, p.R, p.M, p.b_u, p.I, m0,
                              n0, p.out_mb, smem);
    add_bias<C>(u, p.bias_u, p.I, n0);
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float g = y[nt][t][j];
          y[nt][t][j] = g / (1.f + expf(-g)) * u[nt][t][j];
        }
  } else {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) y[nt][t][j] = fmaxf(y[nt][t][j], 0.f);
  }
  const int n = n0 + frag_col4<C>();
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[4];
      frag_get<C>(y, nt, j, v);
      quantize_quad(v, p.act_mb);
      const int row = m0 + frag_row<C>(nt, j);
      if (row < p.M && n < p.I) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 w;
        w.x = *reinterpret_cast<const uint32_t*>(&lo);
        w.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(p.h + (size_t)row * p.I + n) = w;
      }
    }
}

// Phase D's epilogue of one tile: the correction once H·A_d is finished
// (ready reaching chunks), the bias, the output rows < M.
template <class C>
__device__ void down_epilogue(Acc<C>& y, const MlpArgs& p,
                                           int m0, int n0, int* ready,
                                           int chunks, char* smem) {
  if (p.R > 0) {
    wait_count(ready, chunks);
    add_correction<C, true>(y, p.xa, p.XS, p.WGU, p.R, p.M, p.b_d, p.N, m0,
                            n0, p.out_mb, smem);
  }
  add_bias<C>(y, p.bias_d, p.N, n0);
  store_out<C>(y, p.out, p.M, p.N, m0, n0);
}

template <class C>
__global__ void __launch_bounds__(NTHREADS, 2) mlp_kernel(const MlpArgs p) {
  extern __shared__ __align__(16) char smem[];
  XaSmem& xsm = *reinterpret_cast<XaSmem*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x;
  const int R = p.R;
  const int mtiles = (p.M + C::MTILE - 1) / C::MTILE;
  const int Mt = (p.M + 7) / 8;
  const int nI = (p.I + C::TN - 1) / C::TN, nN = (p.N + C::TN - 1) / C::TN;
  const int rc_a = (p.WGU + XA_RC - 1) / XA_RC, rc_c = (R + XA_RC - 1) / XA_RC;
  // the counts of A's and C's finished chunks (at fixed places: a launch
  // of another shape finds them where this one left them), then the
  // tickets of B's tiles, D's tiles, A's chunks and C's chunks
  int* ready_a = p.counters;
  int* ready_c = ready_a + 1;
  int* tick_b = ready_a + 2;
  int* tick_d = tick_b + mtiles * nI;
  int* chunk_a = tick_d + mtiles * nN;
  int* chunk_c = chunk_a + Mt * rc_a;
  LQER_CLOCK(0);
  if (blockIdx.x == 0 && t == 0) *ready_c = 0;   // C's count rises past B

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
    LQER_CLOCK(1);
  }

  // A + B: the X·A_gu items first, then (row tile, column tile of I, K
  // split, half) items: the gate (and up) tiles; the last split of a
  // column tile waits for X·A_gu, adds the corrections and biases,
  // applies the activation and H's quantizer. A block takes its items in
  // order, so every X·A item is done before any block waits for them.
  const int KS_a = (p.K + p.kc_a - 1) / p.kc_a;
  const int n_a = R > 0 ? Mt * KS_a * rc_a : 0;
  const XaInput in_a{p.x, nullptr, nullptr, 0};
  const int halves = p.gated ? 2 : 1;
  const bool direct_b = !p.gated && p.splits_b == 1;
  const size_t stride_b = (size_t)mtiles * C::MTILE * p.I;
  for (int item = blockIdx.x; item < n_a + mtiles * nI * p.splits_b * halves;
       item += gridDim.x) {
    if (item < n_a) {
      if (qx)   // X written in this launch is read through L2
        xa_item<true>(item, in_a, p.a_gu, p.K, p.WGU, 0, p.kc_a, p, chunk_a,
                      ready_a, xsm);
      else
        xa_item<false>(item, in_a, p.a_gu, p.K, p.WGU, 0, p.kc_a, p, chunk_a,
                       ready_a, xsm);
      continue;
    }
    const int ib = item - n_a;
    const int half = ib % halves, s = ib / halves % p.splits_b;
    const int tile = ib / (halves * p.splits_b);
    const int m0 = tile / nI * C::MTILE, n0 = tile % nI * C::TN;
    const int g0 = s * p.gps_b, g1 = min(p.K / 16, g0 + p.gps_b);
    Acc<C> y;
    w_mainloop<C, 3>(p.x, p.M, p.K, m0, half ? p.codes_u : p.codes_g,
                     half ? p.exps_u : p.exps_g, p.I, n0, g0, g1, smem, y);
    if (!direct_b) {
      store_partial<C>(y, p.gpart + (half * p.splits_b + s) * stride_b, p.I,
                       m0, n0);
      if (!last_of_tile(tick_b + tile, p.splits_b * halves)) continue;
    }
    gate_up_epilogue<C>(y, direct_b, p, stride_b, m0, n0, ready_a,
                        Mt * rc_a, smem);
  }
  grid.sync();   // H is whole
  LQER_CLOCK(4);
  if (blockIdx.x == 0 && t == 0) *ready_a = 0;   // its readers are done

  // C + D: the H·A_d items first, then (row tile, column tile of N, K
  // split) items: the down tiles; the last split of a tile waits for H·A_d
  // and adds its correction and bias
  const int KS_c = (p.I + p.kc_c - 1) / p.kc_c;
  const int n_c = R > 0 ? Mt * KS_c * rc_c : 0;
  const XaInput in_c{p.h, nullptr, nullptr, 0};
  const size_t stride_d = (size_t)mtiles * C::MTILE * p.N;
  for (int item = blockIdx.x; item < n_c + mtiles * nN * p.splits_d;
       item += gridDim.x) {
    if (item < n_c) {
      xa_item<true>(item, in_c, p.a_d, p.I, R, p.WGU, p.kc_c, p, chunk_c,
                    ready_c, xsm);
      continue;
    }
    const int id = item - n_c;
    const int s = id % p.splits_d, tile = id / p.splits_d;
    const int m0 = tile / nN * C::MTILE, n0 = tile % nN * C::TN;
    const int g0 = s * p.gps_d, g1 = min(p.I / 16, g0 + p.gps_d);
    Acc<C> y;
    w_mainloop<C, 3>(p.h, p.M, p.I, m0, p.codes_d, p.exps_d, p.N, n0, g0, g1,
                     smem, y);
    if (p.splits_d > 1) {
      store_partial<C>(y, p.gpart + s * stride_d, p.N, m0, n0);
      if (!last_of_tile(tick_d + tile, p.splits_d)) continue;
      sum_partials<C>(y, p.gpart, stride_d, p.splits_d, p.N, m0, n0);
    }
    down_epilogue<C>(y, p, m0, n0, ready_c, Mt * rc_c, smem);
  }
  LQER_CLOCK_END();
}

template <class C>
int launch_mlp(MlpArgs& p, cudaStream_t st) {
  constexpr int SMEM = std::max<int>(
      std::max<int>(Ring<C, 3>::BYTES, sizeof(XaSmem)),
      CorrSmem<C>::BYTES);
  static int resident = 0;   // co-resident blocks on this card
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        mlp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_kernel<C>,
                                                        NTHREADS, SMEM);
    if (e != cudaSuccess) return (int)e;
    resident = per_sm * sms;
  }
  const int mtiles = (p.M + C::MTILE - 1) / C::MTILE;
  const int items = mtiles * std::max(
      ((p.I + C::TN - 1) / C::TN) * p.splits_b * (p.gated ? 2 : 1),
      ((p.N + C::TN - 1) / C::TN) * p.splits_d);
  const int blocks = std::min(resident, std::max(items, 1));
  void* args[] = {&p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mlp_kernel<C>), dim3(blocks), dim3(NTHREADS),
      args, SMEM, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (with x_mb >= 0 a scratch the kernel fills from x_raw
// (M, K) f32, quantized at x_mb mantissa bits; x_raw null otherwise);
// codes/exps of gate, up (K/8, I), (K/16, I) and down
// (I/8, N), (I/16, N), up null for the un-gated relu variant; a_gu (K, WGU)
// with WGU = 2R gated ([A_g | A_u]) or R, b_g and b_u (R, I), a_d (I, R),
// b_d (R, N) bf16 (null when R == 0); biases bias_g, bias_u (I) and bias_d
// (N) f32 or null; out (M, N) f32. Scratch (sizes from
// ops/kernels/mlp_fused.py::plan): h (ceil(M/8) * 8, I) bf16; part
// (ceil(M/8), KS, 8, W) f64 for both X·A phases; xa (ceil(M/8) * 8, WGU +
// R) f32; gpart, the split-K partials of B (halves x splits_b slots) and of
// D (splits_d slots), each (row tiles * tile rows) x its width, f32;
// counters (row tiles * (column tiles of I + of N)) int32, zero (the kernel
// leaves them zero). B splits K's 16-groups into splits_b runs of gps_b, D
// I's into splits_d runs of gps_d; kc_a, kc_c: the K ranges of the X·A
// phases' blocks (multiples of 16). R % 16 == 0 (any such rank); K % 16,
// I % 32 and N % 32 == 0. act_mb: mantissa bits of the H quantizer; xa_mb
// / out_mb -1 for no partial-product quantizer.
LQER_API int lqer_mlp_fused(void* x, const void* x_raw, const void* codes_g,
                            const void* exps_g, const void* codes_u,
                            const void* exps_u, const void* codes_d,
                            const void* exps_d, const void* a_gu,
                            const void* b_g, const void* b_u, const void* a_d,
                            const void* b_d, const void* bias_g,
                            const void* bias_u, const void* bias_d, void* h,
                            void* part, void* xa, void* gpart, void* counters,
                            void* out, int M, int K, int I, int N, int R,
                            int act_mb, int xa_mb, int out_mb, int x_mb,
                            int splits_b, int gps_b, int splits_d, int gps_d,
                            int kc_a, int kc_c, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool gated = codes_u != nullptr;
  const int wgu = gated ? 2 * R : R;
  auto bad_split = [](int s, int g, int groups) {
    return s < 1 || g < 1 || (s - 1) * g >= groups || s * g < groups;
  };
  auto bad_chunk = [](int kc) { return kc < 16 || kc % 16; };
  if (M <= 0 || R < 0 || R % 16 || K % 16 || I % 32 || N % 32
      || (!gated && (b_u != nullptr || bias_u != nullptr))
      || (x_mb >= 0 && (x_raw == nullptr || x_mb > 8))
      || bad_split(splits_b, gps_b, K / 16) || bad_split(splits_d, gps_d, I / 16)
      || bad_chunk(kc_a) || bad_chunk(kc_c) || counters == nullptr)
    return (int)cudaErrorInvalidValue;
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
            static_cast<float*>(xa), static_cast<float*>(gpart),
            static_cast<int*>(counters), static_cast<float*>(out),
            M, K, I, N, R, act_mb, xa_mb, out_mb, x_mb, gated, wgu,
            wgu + R, splits_b, gps_b, splits_d, gps_d, kc_a, kc_c};
  return M <= TileDecode::MTILE ? launch_mlp<TileDecode>(p, st)
                                : launch_mlp<TilePrefill>(p, st);
}

#ifdef LQER_PHASE_CLOCK
// Copy the last launch's phase clocks to out (8 u64) and zero them.
LQER_API int lqer_mlp_phase_clock(void* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out, lqer_phase_clock, sizeof(unsigned long long) * 8);
  const unsigned long long zero[8] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(lqer_phase_clock, zero, sizeof(zero));
  return (int)e;
}
#endif
