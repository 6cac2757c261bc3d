// Kernel 2: causal prefill attention over pre-quantized Q/K/V with the
// probabilities quantized in the kernel.
//
// Replaces lqer_tpu/ops/pallas/attention.py::_attn_kernel (entry
// quantized_attention). Per (head, query row):
//     s = (q · k_j) * scale, masked to j <= row; p = exp(s − max) / sum;
//     p quantized per 16 positions along the keys (block_fp, width 8,
//     p <= 1e-8 passes through); out = Σ_j p_j · v_j.
// The softmax is exact and over the full row, with no online rescaling.
//
// What bounds it on an H100: at admission (64 to a few hundred tokens per
// prompt, d = 128) the work is tiny and the kernel is bound by latency and
// by the FMA rate of the CUDA cores; the HBM traffic is Q + K + V + O.
//
// Design: one block per (head, tile of 8 query rows), one warp per row. K
// and V stream through a shared 32-key tile (padded rows, no bank
// conflicts). Up to about 6K keys the 8 score rows stay in shared memory
// and the scores are computed once; beyond that the streaming variant below
// recomputes them in a second pass over K. The row sum runs lane-strided,
// then through a xor butterfly.
#include "mx_common.cuh"

namespace {

constexpr int KCH = 32;  // keys per shared tile

template <int D>
__global__ void prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ k,
                                         const __nv_bfloat16* __restrict__ v,
                                         float* __restrict__ out, int S, int L,
                                         int Lpad, float scale, int causal,
                                         int p_mb) {
  extern __shared__ float smem[];
  const int rows = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int qi = q0 + w;
  const int Lr = causal ? min(L, ((q0 + rows + 15) / 16) * 16) : L;
  float* sc = smem;                    // rows x Lpad
  float* kv = sc + rows * Lpad;        // KCH x (D + 1)
  float* qs = kv + KCH * (D + 1);      // rows x D
  float* srow = sc + w * Lpad;
  const __nv_bfloat16* qb = q + (size_t)bh * S * D;
  const __nv_bfloat16* kb = k + (size_t)bh * L * D;
  const __nv_bfloat16* vb = v + (size_t)bh * L * D;

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int row = q0 + i / D;
    qs[i] = row < S ? __bfloat162float(qb[(size_t)row * D + i % D]) : 0.f;
  }
  for (int c0 = 0; c0 < Lr; c0 += KCH) {
    __syncthreads();
    for (int i = threadIdx.x; i < KCH * D; i += blockDim.x) {
      const int key = c0 + i / D;
      kv[(i / D) * (D + 1) + i % D] =
          key < L ? __bfloat162float(kb[(size_t)key * D + i % D]) : 0.f;
    }
    __syncthreads();
    const int j = c0 + lane;
    if (j < Lr) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[w * D + d], kv[lane * (D + 1) + d], s);
      srow[j] = (causal && j > qi) ? -INFINITY : s * scale;
    }
  }
  __syncwarp();

  float mx = -INFINITY;
  for (int j = lane; j < Lr; j += 32) mx = fmaxf(mx, srow[j]);
  mx = warp_max_xor(mx);
  float part = 0.f;
  for (int j = lane; j < Lr; j += 32) {
    const float p = expf(srow[j] - mx);
    srow[j] = p;
    part += p;
  }
  const float total = warp_sum_xor(part);
  for (int j = lane; j < Lr; j += 32) srow[j] = srow[j] / total;
  __syncwarp();
  if (p_mb >= 0) {
    for (int g = lane; g < Lr / 16; g += 32) {
      float* pg = srow + g * 16;
      float bmax = 0.f;
      for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, pg[j]);
      const int e = group_exponent(bmax);
      for (int j = 0; j < 16; ++j) pg[j] = mx_value(pg[j], e, p_mb);
    }
  }
  __syncwarp();

  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < Lr; c0 += KCH) {
    __syncthreads();
    for (int i = threadIdx.x; i < KCH * D; i += blockDim.x) {
      const int key = c0 + i / D;
      kv[(i / D) * (D + 1) + i % D] =
          key < L ? __bfloat162float(vb[(size_t)key * D + i % D]) : 0.f;
    }
    __syncthreads();
    const int jn = min(KCH, Lr - c0);
    for (int j = 0; j < jn; ++j) {
      const float p = srow[c0 + j];
#pragma unroll
      for (int i = 0; i < D / 32; ++i)
        acc[i] = fmaf(p, kv[j * (D + 1) + lane + 32 * i], acc[i]);
    }
  }
  if (qi < S) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      out[((size_t)bh * S + qi) * D + lane + 32 * i] = acc[i];
  }
}

// Rows whose scores do not fit in shared memory: two passes over the keys.
// The first keeps each lane's running max and its sum rescaled to it, then
// merges them across the warp; the second recomputes every score,
// p = exp(s - max) / sum, quantizes p per 16 keys (the two half-warps of a
// 32-key tile, reduced by shuffles) and accumulates P·V.
template <int D>
__global__ void prefill_attention_stream_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int S,
    int L, float scale, int causal, int p_mb) {
  extern __shared__ float smem[];
  const int rows = blockDim.x / 32;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * rows;
  const int qi = q0 + w;
  const int Lr = causal ? min(L, ((q0 + rows + 15) / 16) * 16) : L;
  float* kt = smem;                    // KCH x (D + 1)
  float* vt = kt + KCH * (D + 1);      // KCH x D
  float* qs = vt + KCH * D;            // rows x D
  const __nv_bfloat16* qb = q + (size_t)bh * S * D;
  const __nv_bfloat16* kb = k + (size_t)bh * L * D;
  const __nv_bfloat16* vb = v + (size_t)bh * L * D;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int row = q0 + i / D;
    qs[i] = row < S ? __bfloat162float(qb[(size_t)row * D + i % D]) : 0.f;
  }
  auto stage = [&](int c0, bool with_v) {
    __syncthreads();
    for (int i = threadIdx.x; i < KCH * D; i += blockDim.x) {
      const int key = c0 + i / D;
      kt[(i / D) * (D + 1) + i % D] =
          key < L ? __bfloat162float(kb[(size_t)key * D + i % D]) : 0.f;
      if (with_v)
        vt[i] = key < L ? __bfloat162float(vb[(size_t)key * D + i % D]) : 0.f;
    }
    __syncthreads();
  };
  auto score = [&](int j) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(qs[w * D + d], kt[lane * (D + 1) + d], s);
    return (causal && j > qi) ? -INFINITY : s * scale;
  };
  // exp(a - m) with exp(-inf - m) = 0, also for m = -inf
  auto rescale = [](float a, float m) { return a == -INFINITY ? 0.f : expf(a - m); };

  float mx = -INFINITY, total = 0.f;
  for (int c0 = 0; c0 < Lr; c0 += KCH) {
    stage(c0, false);
    if (c0 + lane < Lr) {
      const float s = score(c0 + lane);
      const float m = fmaxf(mx, s);
      total = total * rescale(mx, m) + rescale(s, m);
      mx = m;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, mx, off);
    const float t2 = __shfl_xor_sync(0xffffffffu, total, off);
    const float m = fmaxf(mx, m2);
    // no FMA contraction: both lanes of a pair add the same two products
    total = __fmul_rn(total, rescale(mx, m)) + __fmul_rn(t2, rescale(m2, m));
    mx = m;
  }

  float acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < Lr; c0 += KCH) {
    stage(c0, true);
    const int j = c0 + lane;
    float p = j < Lr ? expf(score(j) - mx) / total : 0.f;
    if (p_mb >= 0) {
      float bmax = p;  // 16-key groups are the two half-warps
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      p = mx_value(p, group_exponent(bmax), p_mb);
    }
    const int jn = min(KCH, Lr - c0);
    for (int jj = 0; jj < jn; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
      for (int i = 0; i < D / 32; ++i)
        acc[i] = fmaf(pj, vt[jj * D + lane + 32 * i], acc[i]);
    }
  }
  if (qi < S) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i)
      out[((size_t)bh * S + qi) * D + lane + 32 * i] = acc[i];
  }
}

constexpr int ROWS = 8;  // query rows (warps) per block

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int L, float scale, int causal, int p_mb,
           cudaStream_t st) {
  const int Lpad = ((L + 31) / 32) * 32;
  const size_t one_pass = sizeof(float) *
      ((size_t)ROWS * Lpad + (size_t)KCH * (D + 1) + (size_t)ROWS * D);
  const dim3 grid(BH, (S + ROWS - 1) / ROWS);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  if (one_pass <= 220 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)one_pass);
    if (err != cudaSuccess) return (int)err;
    prefill_attention_kernel<D><<<grid, ROWS * 32, one_pass, st>>>(
        qp, kp, vp, static_cast<float*>(out), S, L, Lpad, scale, causal, p_mb);
  } else {
    const size_t smem = sizeof(float) *
        ((size_t)KCH * (D + 1) + (size_t)KCH * D + (size_t)ROWS * D);
    prefill_attention_stream_kernel<D><<<grid, ROWS * 32, smem, st>>>(
        qp, kp, vp, static_cast<float*>(out), S, L, scale, causal, p_mb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q (BH, S, D), k and v (BH, L, D) bf16; out (BH, S, D) f32. p_mb -1 keeps
// P unquantized. D is 64 or 128; L a multiple of 16.
LQER_API int lqer_prefill_attention(const void* q, const void* k, const void* v,
                                    void* out, int BH, int S, int L, int D,
                                    float scale, int causal, int p_mb,
                                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, out, BH, S, L, scale, causal, p_mb, st);
  if (D == 64) return launch<64>(q, k, v, out, BH, S, L, scale, causal, p_mb, st);
  return (int)cudaErrorInvalidValue;
}
