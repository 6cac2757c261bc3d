// Decode attention over the bf16 (fp) KV cache, one query token per slot,
// with every operand quantized in the kernel.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel (entry
// decode_attention). Per (slot, kv head) of one layer, at position pos:
//   1. q quantized per 16 along d (block_fp, mantissa bits q_mb);
//   2. K^T quantized at use time in groups of 16 TOKENS of each d column
//      (k_mb), so a group's exponent depends on all 16 cached rows: the
//      kernel quantizes whole groups, the one holding pos included, reading
//      its rows past pos as they are;
//   3. scores q · K^T times scaling (scale after the dot), columns past pos
//      masked, and under a sliding window (window > 0; -1 for none) the
//      columns at or below pos - window too; one exact f32 softmax; p
//      quantized per 16 tokens (p_mb);
//   4. V quantized per token in 16-wide d groups (v_mb); out = Σ p · v.
// A negative mantissa width leaves that operand unquantized.
//
// What bounds it on an H100: the bf16 cache stream, 2 x 2 x d bytes per
// token and kv head (K and V) over the tokens read: the 16-token groups from
// the one holding the window's first key (decode_common.cuh's window_start;
// column 0 without a window) to the one holding pos. A K quantizer group is
// 16 whole tokens, so its exponent never depends on a skipped group.
//
// Design: the cache is token-major (L, d) bf16, so coalesced reads run
// along d. K goes through shared memory in tiles of 128 tokens (eight
// quantization groups): the block loads the tile (8-byte loads, a warp
// reading one 256-byte row), takes each group's column maxima there (a
// thread per d column) and quantizes in place; then a thread per token walks
// d for its score (the tile's rows are padded to D + 1 floats, so a warp's
// 32 tokens fall on 32 banks). V goes through the same tile: each token's
// 16-wide d groups quantized in place, then a thread per d column walks the
// tile's tokens. The softmax and the p quantizer are decode_common.cuh's,
// shared with the MXINT decode kernels.
#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int TT = 128;  // K and V tile: tokens (eight 16-token groups)

// tile[row * (D + 1) + c] = the bf16 rows src[0 .. nt) as f32, 8-byte loads
// (a warp reads 256 consecutive bytes of a row).
template <int D>
__device__ __forceinline__ void load_tile(const uint16_t* src, float* tile,
                                          int nt) {
  for (int i = threadIdx.x; i < nt * (D / 4); i += NT) {
    const int row = i / (D / 4), c4 = i % (D / 4) * 4;
    const uint2 w = *reinterpret_cast<const uint2*>(src + (size_t)row * D + c4);
    float* dst = tile + row * (D + 1) + c4;
    dst[0] = bf16_lo(w.x);
    dst[1] = bf16_hi(w.x);
    dst[2] = bf16_lo(w.y);
    dst[3] = bf16_hi(w.y);
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
fp_decode_kernel(const float* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int* __restrict__ pos_p,
                 float* __restrict__ out, int KVH, int nrep, int L,
                 float scaling, int q_mb, int k_mb, int p_mb, int v_mb,
                 int window) {
  constexpr int TS = D + 1;  // padded tile row
  extern __shared__ float smem[];
  const int b = blockIdx.x, kv = blockIdx.y, t = threadIdx.x;
  const int H = KVH * nrep;
  float* qs = smem;              // nrep x D
  float* sc = qs + nrep * D;     // nrep x L
  float* tile = sc + nrep * L;   // TT x TS
  const int pos = pos_p[b];
  const int ntok = max(0, min((pos + 16) / 16 * 16, L));
  const int j0 = min(window_start(pos, window), ntok);
  const size_t bk = (size_t)b * KVH + kv;
  const uint16_t* kb = k + bk * L * D;
  const uint16_t* vb = v + bk * L * D;

  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  for (int t0 = j0; t0 < ntok; t0 += TT) {
    const int nt = min(TT, ntok - t0);  // a multiple of 16
    __syncthreads();  // the queries are in; the previous tile is consumed
    load_tile<D>(kb + (size_t)t0 * D, tile, nt);
    __syncthreads();
    if (k_mb >= 0) {
      for (int i = t; i < nt / 16 * D; i += NT) {
        float* col = tile + (i / D) * 16 * TS + i % D;
        float bmax = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, fabsf(col[j * TS]));
        const int e = group_exponent(bmax);
#pragma unroll
        for (int j = 0; j < 16; ++j) col[j * TS] = mx_value(col[j * TS], e, k_mb);
      }
      __syncthreads();
    }
    for (int tok = t; tok < nt; tok += NT) {
      float s[NREP_MAX];
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h) s[h] = 0.f;
      const float* krow = tile + tok * TS;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kval = krow[d];
#pragma unroll
        for (int h = 0; h < NREP_MAX; ++h)
          if (h < nrep) s[h] = fmaf(qs[h * D + d], kval, s[h]);
      }
      const int j = t0 + tok;
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep)
          sc[h * L + j] = in_window(j, pos, window) ? s[h] * scaling : -INFINITY;
    }
  }
  __syncthreads();
  softmax_quantize_p(sc, L, 0, j0, ntok - j0, nrep, p_mb);

  // P·V: V goes through the same tile, its 16-wide d groups of each token
  // quantized in place (a thread per (token, group)); a thread per d
  // column then walks the tile's tokens (D <= NT)
  float acc[NREP_MAX];
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) acc[h] = 0.f;
  for (int t0 = j0; t0 < ntok; t0 += TT) {
    const int nt = min(TT, ntok - t0);
    __syncthreads();  // the p rows are in; the previous tile is consumed
    load_tile<D>(vb + (size_t)t0 * D, tile, nt);
    __syncthreads();
    if (v_mb >= 0) {
      for (int i = t; i < nt * (D / 16); i += NT) {
        float* grp = tile + (i / (D / 16)) * TS + i % (D / 16) * 16;
        float bmax = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, fabsf(grp[j]));
        const int e = group_exponent(bmax);
#pragma unroll
        for (int j = 0; j < 16; ++j) grp[j] = mx_value(grp[j], e, v_mb);
      }
      __syncthreads();
    }
    if (t < D)
      for (int tok = 0; tok < nt; ++tok) {
        const float val = tile[tok * TS + t];
#pragma unroll
        for (int h = 0; h < NREP_MAX; ++h)
          if (h < nrep) acc[h] = fmaf(sc[h * L + t0 + tok], val, acc[h]);
      }
  }
  if (t < D)
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep) out[((size_t)b * H + kv * nrep + h) * D + t] = acc[h];
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int KVH, int nrep, int L, float scaling,
           int q_mb, int k_mb, int p_mb, int v_mb, int window,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)nrep * (D + L) + TT * (D + 1));
  if (nrep < 1 || nrep > NREP_MAX || L % 16 != 0 || smem > 220 * 1024 ||
      window == 0 || window < -1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fp_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fp_decode_kernel<D><<<dim3(B, KVH), NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(pos),
      static_cast<float*>(out), KVH, nrep, L, scaling, q_mb, k_mb, p_mb, v_mb,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer: q (B, H, D) f32; k, v (B, KVH, L, D) bf16, the layer's slice
// of the layer-stacked cache; positions (B) int32; out (B, H, D) f32;
// window the sliding window in tokens, -1 for none.
LQER_API int lqer_decode_attention_fp(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, int B, int KVH, int nrep,
                                      int D, int L, float scaling, int q_mb,
                                      int k_mb, int p_mb, int v_mb,
                                      int window, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, pos, out, B, KVH, nrep, L, scaling, q_mb,
                       k_mb, p_mb, v_mb, window, st);
  if (D == 64)
    return launch<64>(q, k, v, pos, out, B, KVH, nrep, L, scaling, q_mb, k_mb,
                      p_mb, v_mb, window, st);
  return (int)cudaErrorInvalidValue;
}
