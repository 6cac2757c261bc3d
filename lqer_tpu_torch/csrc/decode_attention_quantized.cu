// Decode attention over the direct-write MXINT cache, one query token per
// slot, and the same with the fresh token's cache write in the launch.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel_quantized (entry
// decode_attention_quantized, codes of width 8 or 4) and, with WRITE,
// ::_kernel_quantized_write (entry decode_attention_quantized_write, width
// 8). Per (slot, kv head) of one layer, at position pos:
//   0. (WRITE) the fresh K/V rows MXINT8-encoded (cache_write._encode_t:
//      exact exponent, zero groups take exponent 0, codes clamp to ±127)
//      and stored into column pos of the layer's codes and exponents, in
//      place; the scores and P·V below then read the fresh column, as the
//      JAX kernel's blend of the fresh values into column pos does;
//   1. q quantized per 16 along d (block_fp, width q_mb + 1);
//   2. scores over columns [0, pos] of the cache as stored: the cache's
//      MXINT values are the operands (quantize once at write), times
//      scaling, columns past pos masked, and under a sliding window
//      (window > 0; -1 for none) the columns at or below pos - window too;
//   3. one exact f32 softmax; p quantized per 16 tokens;
//   4. out = Σ p · v.
//
// What bounds it on an H100: the cache stream, (code bytes + d/16 exponent
// bytes) x 2 per token and kv head over [0, pos] (136 x 2 bytes at d = 128
// and width 8, 72 x 2 at width 4), plus the column written. Only whole
// 16-token groups up to the one holding pos are read, and under a window
// only from the one holding its first key on (decode_common.cuh's
// window_start): the TPU block read all L because VMEM residency made that
// free.
//
// Design: one block per (slot, kv head) owns that column of the cache, so
// the in-place write has no race, and one __syncthreads orders it before the
// reads (plain loads: the cache pointers are not __restrict__, so no
// non-coherent read path is used). The score and P·V loops, the query
// quantizer, the row encode and the softmax are decode_common.cuh's, shared
// with the staged kernel. Columns run [0, pos] and pos + 1 is rarely a
// multiple of 4 or 16: the loops cover the whole 16-token groups up to the
// one holding pos (in bounds, since L % 16 == 0) and the scores past pos are
// masked to -inf, so their p is 0. The MXINT4 layout (d-split nibbles)
// differs only inside score_4_columns and pv_row.
#include "decode_common.cuh"

namespace {

using namespace decode;

template <int D, int CW, bool WRITE>
__global__ void __launch_bounds__(NT)
quantized_decode_kernel(const float* __restrict__ q, int8_t* kc, int8_t* ke,
                        int8_t* vc, int8_t* ve, const float* __restrict__ kh,
                        const float* __restrict__ vh,
                        const int* __restrict__ pos_p, float* __restrict__ out,
                        int KVH, int nrep, int L, float scaling, int q_mb,
                        int p_mb, int window) {
  constexpr int GD = D / 16;
  constexpr int CR = CW == 8 ? D : D / 2;  // code rows
  extern __shared__ float smem[];
  const int b = blockIdx.x, kv = blockIdx.y, t = threadIdx.x;
  const int H = KVH * nrep;
  float* qs = smem;            // nrep x D
  float* sc = qs + nrep * D;   // nrep x L
  const int pos = pos_p[b];
  const int ntok = max(0, min((pos + 16) / 16 * 16, L));
  const int j0 = min(window_start(pos, window), ntok);
  const size_t bk = (size_t)b * KVH + kv;
  const Cache c{kc + bk * CR * L, ke + bk * GD * L, vc + bk * CR * L,
                ve + bk * GD * L, L};

  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  if constexpr (WRITE) {
    if (pos >= 0 && pos < L)
      for (int idx = t; idx < 2 * GD; idx += NT) {
        const int g = idx % GD;
        const bool is_v = idx >= GD;
        encode_group((is_v ? vh : kh) + bk * D + g * 16,
                     (is_v ? vc : kc) + bk * D * L,
                     (is_v ? ve : ke) + bk * GD * L, L, pos, g);
      }
  }
  __syncthreads();

  for (int j = j0 + 4 * t; j < ntok; j += 4 * NT) {
    float s4[4][NREP_MAX];
    score_4_columns<D, CW>(c, j, qs, nrep, s4);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep)
          sc[h * L + j + u] =
              in_window(j + u, pos, window) ? s4[u][h] * scaling : -INFINITY;
  }
  __syncthreads();
  softmax_quantize_p(sc, L, 0, j0, ntok - j0, nrep, p_mb);

  for (int dd = t; dd < D; dd += NT) {
    float acc[NREP_MAX];
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h) acc[h] = 0.f;
    pv_row<D, CW>(shifted(c, j0), dd, ntok - j0, sc + j0, L, nrep, acc);
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep) out[((size_t)b * H + kv * nrep + h) * D + dd] = acc[h];
  }
}

template <int D, int CW, bool WRITE>
int launch(const void* q, void* kc, void* ke, void* vc, void* ve,
           const void* kh, const void* vh, const void* pos, void* out, int B,
           int KVH, int nrep, int L, float scaling, int q_mb, int p_mb,
           int window, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)nrep * (D + L);
  if (nrep < 1 || nrep > NREP_MAX || L % 16 != 0 || smem > 220 * 1024 ||
      window == 0 || window < -1)
    return (int)cudaErrorInvalidValue;
  auto* kernel = quantized_decode_kernel<D, CW, WRITE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, KVH), NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<int8_t*>(kc),
      static_cast<int8_t*>(ke), static_cast<int8_t*>(vc),
      static_cast<int8_t*>(ve), static_cast<const float*>(kh),
      static_cast<const float*>(vh), static_cast<const int*>(pos),
      static_cast<float*>(out), KVH, nrep, L, scaling, q_mb, p_mb, window);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(const void* q, void* kc, void* ke, void* vc, void* ve,
             const void* kh, const void* vh, const void* pos, void* out,
             int B, int KVH, int nrep, int L, int code_width, float scaling,
             int q_mb, int p_mb, int window, cudaStream_t st) {
#define LQER_QDEC_ARGS                                                        \
  q, kc, ke, vc, ve, kh, vh, pos, out, B, KVH, nrep, L, scaling, q_mb, p_mb, \
      window, st
  if (code_width == 8 && kh != nullptr)
    return launch<D, 8, true>(LQER_QDEC_ARGS);
  if (code_width == 8) return launch<D, 8, false>(LQER_QDEC_ARGS);
  if (code_width == 4 && kh == nullptr)
    return launch<D, 4, false>(LQER_QDEC_ARGS);
#undef LQER_QDEC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One layer: q (B, H, D) f32; codes (B, KVH, D, L) (width 8) or
// (B, KVH, D/2, L) (width 4, d-split nibbles) and exps (B, KVH, D/16, L)
// int8, the layer's slice of the layer-stacked cache; positions (B) int32;
// out (B, H, D) f32. With kh and vh ((B, KVH, D) f32, width 8 only) the
// fresh rows are encoded into column positions[b] in place first; pass
// null pointers for the read-only kernel. window: the sliding window in
// tokens, -1 for none.
LQER_API int lqer_decode_attention_quantized(
    const void* q, void* kc, void* ke, void* vc, void* ve, const void* kh,
    const void* vh, const void* pos, void* out, int B, int KVH, int nrep,
    int D, int L, int code_width, float scaling, int q_mb, int p_mb,
    int window, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D == 128)
    return dispatch<128>(q, kc, ke, vc, ve, kh, vh, pos, out, B, KVH, nrep, L,
                         code_width, scaling, q_mb, p_mb, window, st);
  if (D == 64)
    return dispatch<64>(q, kc, ke, vc, ve, kh, vh, pos, out, B, KVH, nrep, L,
                        code_width, scaling, q_mb, p_mb, window, st);
  return (int)cudaErrorInvalidValue;
}
