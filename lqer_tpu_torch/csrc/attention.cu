// Kernel 2: prefill attention over pre-quantized Q/K/V with the
// probabilities quantized in the kernel.
//
// Replaces lqer_tpu/ops/pallas/attention.py::_attn_kernel (entry
// quantized_attention). Per (head, query row):
//     s = (q · k_j) * scale, causal: masked to j <= row; p = exp(s − max) /
//     sum over the full row; p quantized per 16 keys (block_fp, p_mb
//     mantissa bits, p <= 1e-8 passes through); out = Σ_j p_j · v_j.
// The softmax is exact over the full row: the max and sum are final before
// any p is quantized.
//
// What bounds it on an H100: the two products, 4 x S x L x d operations per
// head (half of that causal), and the per-score work of the softmax and
// the P quantizer. Each product runs here as f32 FMAs in the plain
// version's order: s sums q_d k_d for d = 0, 1, ..., and out sums p_j v_j
// for j = 0, 1, ..., from 0, as the f32 matmuls of
// quantized_attention_plain do on the card, and the softmax sums in
// torch.softmax's order (its warp softmax, rows of up to 1024 keys). That
// keeps P equal to the plain version's: P's 8-bit rounding turns any other
// order into flipped codes, and a flipped P code moves a whole output row,
// which the next layer's quantizers carry into the cache. chip_smoke.py's
// phase 4 holds the admission-written cache to one code step of the plain
// version's: an mma.sync version (both products on the tensor cores,
// accumulated in their order) and an online softmax both failed it. So the
// kernel is bound by the CUDA cores' FMA rate, 33.5 T FMA/s, and it is not
// the tensor-core design this row still needs. Its equality with the plain
// version rests on those library orders: a matmul that splits d, or a
// softmax that changes its order, flips P codes again.
//
// Design: three launches per group of heads (hc heads at a time, so the
// scores of a call fit the f32 scratch sc):
//   A. scores: a block per (head, tile of 64 query rows), 128 threads, the
//      longest causal rows first, three blocks an SM; keys in tiles of 64,
//      none past the block's last causal row. Each thread holds an 8 x 4
//      tile of S (32 FMAs per six shared-memory loads); Q sits in shared
//      memory transposed (float4s of rows per d), the K tile row-major with
//      rows padded to d + 1 floats; the next K tile is loaded into
//      registers while this one computes. s * scale, or -inf, goes to sc.
//   B. softmax and P quantizer: a row per 32 lanes (16 under 32 keys),
//      lane j over keys j, j + 32, ...: the max, the sum of exp(s - max)
//      in that order then a xor butterfly, p = exp(s - max) / sum,
//      quantized per 16 keys (half-warps, xor shuffles), back into sc up
//      to the last key kernel C reads for the row's block.
//   C. P·V: the blocks of A, each thread 4 rows x d/8 columns of the
//      output, tiles of 32 keys, P and V row-major in shared memory,
//      out += p v key by key.
#include "mx_common.cuh"

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BNA = 64;  // keys per tile of kernel A
constexpr int BNC = 32;  // keys per tile of kernel C
constexpr int NTH = 128;

// Shared memory of kernels A and C, in floats.
template <int D>
struct LayoutA {
  static constexpr int KS = D + 1;               // padded K row
  static constexpr int QT = 0;                   // [D][BM]
  static constexpr int KF = QT + D * BM;         // [BNA][KS]
  static constexpr int FLOATS = KF + BNA * KS;
};

template <int D>
struct LayoutC {
  static constexpr int PS = BNC + 1;             // padded P row
  static constexpr int VF = 0;                   // [BNC][D]
  static constexpr int PF = VF + BNC * D;        // [BM][PS]
  static constexpr int FLOATS = PF + BM * PS;
};

// A thread's share of the rows [r0, r0 + N_ROWS) of the (n, D) bf16 rows
// src: two bf16 values a word, lanes along d (coalesced); rows at or past n
// read as zeros.
template <int D, int N_ROWS>
struct TileRegs {
  static constexpr int N = N_ROWS * D / 2 / NTH;  // words per thread
  uint32_t w[N];

  __device__ __forceinline__ void load(const uint16_t* src, int r0, int n) {
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NTH, row = i / (D / 2), c = i % (D / 2);
      w[u] = r0 + row < n ? __ldg(s32 + (size_t)(r0 + row) * (D / 2) + c) : 0u;
    }
  }

  // into the f32 tile dst with row stride ld (floats)
  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int i = threadIdx.x + u * NTH, row = i / (D / 2), c = i % (D / 2);
      dst[row * ld + 2 * c] = bf16_lo(w[u]);
      dst[row * ld + 2 * c + 1] = bf16_hi(w[u]);
    }
  }
};

// Kernel A. s = (q · k) * scale, rounded as the plain version rounds it,
// or -inf where masked, into sc (BH, S, L): the keys a block's rows can see
// (past the block's last causal row nothing is written; the softmax reads
// no key past its row). Thread t: rows 8 (t / 16).., keys t % 16 + 16 j
// (j < 4) of each 64-key tile, so a warp's K loads fall on 16 banks.
template <int D>
__global__ void __launch_bounds__(NTH, 3)
prefill_scores_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k, float* __restrict__ sc,
                      int S, int L, float scale, int causal) {
  using Ly = LayoutA<D>;
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, r0 = t / 16 * 8, kg = t % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int nkeys = causal ? min(L, q0 + BM) : L;
  const uint16_t* kb = k + (size_t)bh * L * D;

  // Q transposed into shared memory; rows past S are zeros
  {
    const uint32_t* q32 =
        reinterpret_cast<const uint32_t*>(q + (size_t)bh * S * D);
    for (int i = t; i < BM * D / 2; i += NTH) {
      const int r = i % BM, c = i / BM;  // lanes along rows: no conflicts
      const uint32_t w =
          q0 + r < S ? __ldg(q32 + (size_t)(q0 + r) * (D / 2) + c) : 0u;
      sm[Ly::QT + 2 * c * BM + r] = bf16_lo(w);
      sm[Ly::QT + (2 * c + 1) * BM + r] = bf16_hi(w);
    }
  }
  TileRegs<D, BNA> kr;
  kr.load(kb, 0, L);
  for (int n0 = 0; n0 < nkeys; n0 += BNA) {
    __syncthreads();  // the previous tile is read
    kr.store(sm + Ly::KF, Ly::KS);
    __syncthreads();
    if (n0 + BNA < nkeys) kr.load(kb, n0 + BNA, L);
    // s[i][j] = q_{r0+i} · k_{kg+16j}, the sum over d in order from 0
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qt = sm + Ly::QT + r0;
    const float* kf = sm + Ly::KF + kg * Ly::KS;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * BM);
      const float4 qb = *reinterpret_cast<const float4*>(qt + d * BM + 4);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kf[16 * j * Ly::KS + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + r0 + i;
      if (row >= S) continue;
      float* dst = sc + ((size_t)bh * S + row) * L + n0 + kg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = n0 + kg + 16 * j;
        if (key < nkeys)
          dst[16 * j] =
              !causal || key <= row ? __fmul_rn(s[i][j], scale) : -INFINITY;
      }
    }
  }
}

// Kernel B, a row per WS lanes: p = exp(s - max) / sum over the row in
// torch.softmax's order for rows of up to 1024 keys (its warp softmax:
// lane j sums keys j, j + WS, ... in turn, then a xor butterfly), then
// quantized per 16 keys (half-warps of an iteration), in place, up to the
// keys kernel C reads for the row's block of BM rows (zeros past the row).
template <int WS>
__global__ void __launch_bounds__(NTH)
prefill_softmax_kernel(float* __restrict__ sc, int rows, int S, int L,
                       int causal, int p_mb) {
  const int lane = threadIdx.x % WS;
  const int g = (blockIdx.x * NTH + threadIdx.x) / WS;  // row of BH x S
  if (g >= rows) return;  // whole groups of WS lanes
  const unsigned mask = WS == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  const int row = g % S;
  float* sr = sc + (size_t)g * L;
  const int klim = causal ? min(L, row + 1) : L;
  const int kend = causal ? min(L, (row / BM + 1) * BM) : L;
  float mx = -INFINITY;
  for (int key = lane; key < klim; key += WS) mx = fmaxf(mx, sr[key]);
#pragma unroll
  for (int off = WS / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off, WS));
  float sum = 0.f;
  for (int key = lane; key < klim; key += WS)
    sum = __fadd_rn(sum, expf(__fsub_rn(sr[key], mx)));
#pragma unroll
  for (int off = WS / 2; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(mask, sum, off, WS));
  for (int k0 = 0; k0 < kend; k0 += WS) {
    const int key = k0 + lane;
    float p = key < klim ? __fdiv_rn(expf(__fsub_rn(sr[key], mx)), sum) : 0.f;
    if (p_mb >= 0) {  // 16 lanes hold a group
      float gmax = p;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        gmax = fmaxf(gmax, __shfl_xor_sync(mask, gmax, off, WS));
      p = mx_value(p, group_exponent(gmax), p_mb);
    }
    if (key < kend) sr[key] = p;
  }
}

// Kernel C. out = P · V, each output summed over the keys in order from 0,
// P read from sc (zero past a row's keys). Thread t: rows 4 (t / 8).., and
// d/8 columns in vectors of VW interleaved with the other seven threads of
// its row group (a warp's V loads then fall on distinct banks); P
// row-major with rows padded (a warp's four row groups on distinct banks),
// V row-major.
template <int D>
__global__ void __launch_bounds__(NTH, 3)
prefill_pv_kernel(const float* __restrict__ sc,
                  const uint16_t* __restrict__ v, float* __restrict__ out,
                  int S, int L, int causal) {
  using Ly = LayoutC<D>;
  constexpr int VW = D % 32 == 0 ? 4 : 2;  // floats per vector
  constexpr int NV = D / 8 / VW;           // vectors per thread
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, r0 = t / 8 * 4, c0 = t % 8 * VW;  // + 8 VW j
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int nkeys = causal ? min(L, q0 + BM) : L;
  const uint16_t* vb = v + (size_t)bh * L * D;
  const float* pb = sc + ((size_t)bh * S + q0) * L;

  float o[4][NV * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) o[i][c] = 0.f;
  TileRegs<D, BNC> vr;
  vr.load(vb, 0, L);
  for (int n0 = 0; n0 < nkeys; n0 += BNC) {
    const int kn = min(BNC, nkeys - n0);
    __syncthreads();  // the previous tile is read
    vr.store(sm + Ly::VF, D);
    for (int i = t; i < BM * BNC; i += NTH) {  // lanes along keys
      const int key = i % BNC, r = i / BNC;
      sm[Ly::PF + r * Ly::PS + key] =
          q0 + r < S && key < kn ? pb[(size_t)r * L + n0 + key] : 0.f;
    }
    __syncthreads();
    if (n0 + BNC < nkeys) vr.load(vb, n0 + BNC, L);
    const float* pr = sm + Ly::PF + r0 * Ly::PS;
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {  // kn: 16 or 32
      const float pa[4] = {pr[kk], pr[Ly::PS + kk], pr[2 * Ly::PS + kk],
                           pr[3 * Ly::PS + kk]};
      const float* vrow = sm + Ly::VF + kk * D + c0;
      float vv[NV * VW];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + 32 * j);
          vv[4 * j] = x.x, vv[4 * j + 1] = x.y, vv[4 * j + 2] = x.z,
          vv[4 * j + 3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 16 * j);
          vv[2 * j] = x.x, vv[2 * j + 1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NV * VW; ++c) o[i][c] = fmaf(pa[i], vv[c], o[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row < S) {
      float* dst = out + ((size_t)bh * S + row) * D + c0;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int c = 0; c < VW; c += 2)
          *reinterpret_cast<float2*>(dst + 8 * VW * j + c) =
              make_float2(o[i][VW * j + c], o[i][VW * j + c + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* scratch, int BH, int S, int L, float scale, int causal,
           int p_mb, int hc, cudaStream_t st) {
  const size_t smem_a = sizeof(float) * LayoutA<D>::FLOATS;
  const size_t smem_c = sizeof(float) * LayoutC<D>::FLOATS;
  const void* fns[2] = {(const void*)prefill_scores_kernel<D>,
                        (const void*)prefill_pv_kernel<D>};
  const size_t bytes[2] = {smem_a, smem_c};
  for (int j = 0; j < 2; ++j) {
    cudaError_t e = cudaFuncSetAttribute(
        fns[j], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes[j]);
    if (e == cudaSuccess)  // the whole of the SM's 228 KB as shared memory
      e = cudaFuncSetAttribute(fns[j],
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  auto* sc = static_cast<float*>(scratch);
  int ws = 16;  // torch's warp softmax: min(32, the next power of two >= L)
  while (ws < 32 && ws < L) ws *= 2;
  for (int h0 = 0; h0 < BH; h0 += hc) {  // heads whose scores fit sc
    const int nh = min(hc, BH - h0);
    const auto* qh = static_cast<const uint16_t*>(q) + (size_t)h0 * S * D;
    const auto* kh = static_cast<const uint16_t*>(k) + (size_t)h0 * L * D;
    const auto* vh = static_cast<const uint16_t*>(v) + (size_t)h0 * L * D;
    auto* oh = static_cast<float*>(out) + (size_t)h0 * S * D;
    const dim3 grid(nh, (S + BM - 1) / BM);
    prefill_scores_kernel<D><<<grid, NTH, smem_a, st>>>(qh, kh, sc, S, L,
                                                        scale, causal);
    const int rows = nh * S;
    const int blocks = (rows * ws + NTH - 1) / NTH;
    if (ws == 32)
      prefill_softmax_kernel<32><<<blocks, NTH, 0, st>>>(sc, rows, S, L,
                                                         causal, p_mb);
    else
      prefill_softmax_kernel<16><<<blocks, NTH, 0, st>>>(sc, rows, S, L,
                                                         causal, p_mb);
    prefill_pv_kernel<D><<<grid, NTH, smem_c, st>>>(sc, vh, oh, S, L, causal);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// q (BH, S, D), k and v (BH, L, D) bf16; out (BH, S, D) f32; scratch
// f32, hc x S x L: the heads are taken hc at a time. p_mb -1 keeps P
// unquantized. D is a multiple of 16 from 64 to 128 (instantiated at 64,
// 80, 96 and 128); L a multiple of 16.
LQER_API int lqer_prefill_attention(const void* q, const void* k, const void* v,
                                    void* out, void* scratch, int BH, int S,
                                    int L, int D, float scale, int causal,
                                    int p_mb, int hc, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (L % 16 != 0 || S < 1 || L < 1 || hc < 1)
    return (int)cudaErrorInvalidValue;
#define LQER_ATTN_ARGS \
  q, k, v, out, scratch, BH, S, L, scale, causal, p_mb, hc, st
  switch (D) {
    case 64: return launch<64>(LQER_ATTN_ARGS);
    case 80: return launch<80>(LQER_ATTN_ARGS);
    case 96: return launch<96>(LQER_ATTN_ARGS);
    case 128: return launch<128>(LQER_ATTN_ARGS);
  }
#undef LQER_ATTN_ARGS
  return (int)cudaErrorInvalidValue;
}
