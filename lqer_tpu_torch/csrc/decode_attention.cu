// Kernel 3: staged decode attention over the MXINT8 or MXINT4 KV cache, one
// query token per slot, with the fresh token's K/V rows encoded into the
// staging ring in the same launch.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel_quantized_staged
// (entry decode_attention_quantized_staged, code width 8 or 4: the JAX
// kernel reads the width off the code rows, d or d/2). Per (slot, kv head):
//   1. q quantized per 16 along d (block_fp, width 8);
//   2. the new K/V rows encoded at the cache's width (cache_write._encode_t
//      semantics: exact exponent, zero groups take exponent 0, codes clamp
//      to ±127, or at width 4 to ±7 and nibble-packed d-split) into ring
//      lane pos % 64, IN PLACE (the JAX kernel aliases the ring arrays to
//      its outputs instead);
//   3. scores over main columns [0, flushed) and the ring lanes holding
//      positions [flushed, pos], one exact f32 softmax over both;
//   4. p quantized per 16 along the concatenated [main L | ring 64] axis
//      (flushed is 16-aligned, so ring groups map onto position groups);
//   5. out = Σ p · v over main and ring.
//
// What bounds it on an H100: the main cache stream, 2 x 136 bytes per
// token and kv head at width 8 (K and V codes plus exponents), 2 x 72 at
// width 4, of the flushed prefix. Only [0, flushed) is read: the TPU block
// read all L only because VMEM residency made that free.
//
// Design: one block per (slot, kv head) owns that ring slice, so the
// in-place ring write has no race; its GQA query heads (n_rep) share each
// decoded K/V value. The cache keeps the token-axis-last layout of the JAX
// package ((d, L) or packed (d/2, L) codes, (d/16, L) exponents): for the
// scores a thread owns 4 consecutive tokens (char4 loads, a warp reads 128
// consecutive bytes of a code row) and walks d, the ring's 64 lanes as the
// main columns; for P·V a thread owns a d row and walks its tokens, 16 per
// 16-byte load. The softmax sum runs thread-strided, then through a xor
// butterfly, then over warps. Those loops, the query quantizer and the row
// encodes live in decode_common.cuh, shared with the direct-write decode
// kernels (decode_attention_quantized.cu) and the streaming ones.
#include "decode_common.cuh"

namespace {

using namespace decode;

template <int D, int CW>
__global__ void __launch_bounds__(NT)
staged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                     const int8_t* __restrict__ ke, const int8_t* __restrict__ vc,
                     const int8_t* __restrict__ ve, int8_t* ksc, int8_t* kse,
                     int8_t* vsc, int8_t* vse, const float* __restrict__ kh,
                     const float* __restrict__ vh, const int* __restrict__ pos_p,
                     const int* __restrict__ fl_p, float* __restrict__ out,
                     int KVH, int nrep, int L, int SW, float scaling,
                     int q_mb, int p_mb) {
  constexpr int GD = D / 16;
  constexpr int CR = CW == 8 ? D : D / 2;  // code rows
  extern __shared__ float smem[];
  const int b = blockIdx.x, kv = blockIdx.y, t = threadIdx.x;
  const int H = KVH * nrep, LS = L + SW;
  float* qs = smem;            // nrep x D
  float* sc = qs + nrep * D;   // nrep x (L + SW)
  const int pos = pos_p[b], fl = fl_p[b];
  const int r = pos % SW;
  const size_t bk = (size_t)b * KVH + kv;
  const Cache main_c{kc + bk * CR * L, ke + bk * GD * L, vc + bk * CR * L,
                     ve + bk * GD * L, L};
  const Cache ring_c{ksc + bk * CR * SW, kse + bk * GD * SW,
                     vsc + bk * CR * SW, vse + bk * GD * SW, SW};

  // 1. quantized queries
  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  // 2. encode the fresh K/V rows into ring lane r, in place
  encode_kv_column<D, CW>(kh + bk * D, vh + bk * D, ksc + bk * CR * SW,
                          kse + bk * GD * SW, vsc + bk * CR * SW,
                          vse + bk * GD * SW, SW, r);
  __syncthreads();

  // 3. scores: main columns [0, fl) and ring lanes (index L + lane)
  for (int j = 4 * t; j < fl; j += 4 * NT) {   // fl is a multiple of 32
    float s4[4][NREP_MAX];
    score_4_columns<D, CW>(main_c, j, qs, nrep, s4);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep)
          sc[h * LS + j + u] = s4[u][h] * scaling;
  }
  for (int j = 4 * t; j < SW; j += 4 * NT) {  // SW % 16 == 0
    float s4[4][NREP_MAX];
    score_4_columns<D, CW>(ring_c, j, qs, nrep, s4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jr = j + u;
      const int tl = pos - ((pos - jr) % SW + SW) % SW;  // position in lane jr
      const bool valid = tl >= fl;
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep)
          sc[h * LS + L + jr] = valid ? s4[u][h] * scaling : -INFINITY;
    }
  }
  __syncthreads();

  // 4.-6. the softmax over main [0, fl) and the ring lanes, p per 16
  //    (main groups below fl, ring groups)
  softmax_quantize_p(sc, LS, fl, L, SW, nrep, p_mb);

  // 7. P·V: thread dd owns d row dd and walks the tokens, main [0, fl)
  //    then the 64 ring lanes, 16 tokens per 16-byte load
  for (int dd = t; dd < D; dd += NT) {
    float acc[NREP_MAX];
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h) acc[h] = 0.f;
    pv_row<D, CW>(main_c, dd, fl, sc, LS, nrep, acc);
    pv_row<D, CW>(ring_c, dd, SW, sc + L, LS, nrep, acc);
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep) out[((size_t)b * H + kv * nrep + h) * D + dd] = acc[h];
  }
}

template <int D, int CW>
int launch(const void* q, const void* kc, const void* ke, const void* vc,
           const void* ve, void* ksc, void* kse, void* vsc, void* vse,
           const void* kh, const void* vh, const void* pos, const void* fl,
           void* out, int B, int KVH, int nrep, int L, int SW, float scaling,
           int q_mb, int p_mb, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)nrep * (D + L + SW);
  if (nrep < 1 || nrep > NREP_MAX || L % NT != 0 || SW > NT || SW % 16 != 0 ||
      smem > 220 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(staged_decode_kernel<D, CW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  staged_decode_kernel<D, CW><<<dim3(B, KVH), NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kc),
      static_cast<const int8_t*>(ke), static_cast<const int8_t*>(vc),
      static_cast<const int8_t*>(ve), static_cast<int8_t*>(ksc),
      static_cast<int8_t*>(kse), static_cast<int8_t*>(vsc),
      static_cast<int8_t*>(vse), static_cast<const float*>(kh),
      static_cast<const float*>(vh), static_cast<const int*>(pos),
      static_cast<const int*>(fl), static_cast<float*>(out), KVH, nrep, L, SW,
      scaling, q_mb, p_mb);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int code_width, const void* q, const void* kc, const void* ke,
             const void* vc, const void* ve, void* ksc, void* kse, void* vsc,
             void* vse, const void* kh, const void* vh, const void* pos,
             const void* fl, void* out, int B, int KVH, int nrep, int L,
             int SW, float scaling, int q_mb, int p_mb, cudaStream_t st) {
#define LQER_DEC_ARGS                                                          \
  q, kc, ke, vc, ve, ksc, kse, vsc, vse, kh, vh, pos, fl, out, B, KVH, nrep, L, \
      SW, scaling, q_mb, p_mb, st
  if (code_width == 8) return launch<D, 8>(LQER_DEC_ARGS);
  if constexpr (D % 32 == 0)
    if (code_width == 4) return launch<D, 4>(LQER_DEC_ARGS);
#undef LQER_DEC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One layer: q (B, H, D) f32; main codes (B, KVH, CR, L) and exps
// (B, KVH, D/16, L) int8, CR = D at code width 8, D/2 at width 4 (d-split
// nibbles); ring codes (B, KVH, CR, SW) and exps (B, KVH, D/16, SW) int8,
// updated in place at lane pos % SW; kh, vh (B, KVH, D) f32; positions,
// flushed (B) int32; out (B, H, D) f32. D is 64, 80, 96 or 128 (width 4:
// D % 32 == 0).
LQER_API int lqer_staged_decode_attention(
    const void* q, const void* kc, const void* ke, const void* vc,
    const void* ve, void* ksc, void* kse, void* vsc, void* vse, const void* kh,
    const void* vh, const void* pos, const void* fl, void* out, int B, int KVH,
    int nrep, int D, int L, int SW, int code_width, float scaling, int q_mb,
    int p_mb, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LQER_DEC_ARGS                                                          \
  code_width, q, kc, ke, vc, ve, ksc, kse, vsc, vse, kh, vh, pos, fl, out, B,  \
      KVH, nrep, L, SW, scaling, q_mb, p_mb, st
  switch (D) {
    case 64: return dispatch<64>(LQER_DEC_ARGS);
    case 80: return dispatch<80>(LQER_DEC_ARGS);
    case 96: return dispatch<96>(LQER_DEC_ARGS);
    case 128: return dispatch<128>(LQER_DEC_ARGS);
  }
#undef LQER_DEC_ARGS
  return (int)cudaErrorInvalidValue;
}
