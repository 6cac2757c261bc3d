// Kernel 3: staged decode attention over the MXINT8 KV cache, one query
// token per slot, with the fresh token's K/V rows encoded into the staging
// ring in the same launch.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel_quantized_staged
// (entry decode_attention_quantized_staged). Per (slot, kv head):
//   1. q quantized per 16 along d (block_fp, width 8);
//   2. the new K/V rows MXINT8-encoded (cache_write._encode_t semantics:
//      exact exponent, zero groups take exponent 0, codes clamp to ±127)
//      into ring lane pos % 64, IN PLACE (the JAX kernel aliases the ring
//      arrays to its outputs instead);
//   3. scores over main columns [0, flushed) and the ring lanes holding
//      positions [flushed, pos], one exact f32 softmax over both;
//   4. p quantized per 16 along the concatenated [main L | ring 64] axis
//      (flushed is 16-aligned, so ring groups map onto position groups);
//   5. out = Σ p · v over main and ring.
//
// What bounds it on an H100: the main cache stream, 2 x 136 bytes per
// token and kv head (K and V codes plus exponents) of the flushed prefix.
// Only [0, flushed) is read: the TPU block read all L only because VMEM
// residency made that free.
//
// Design: one block per (slot, kv head) owns that ring slice, so the
// in-place ring write has no race; its GQA query heads (n_rep) share each
// decoded K/V value. The cache keeps the token-axis-last layout of the JAX
// package ((d, L) codes, (d/16, L) exponents): for the scores a thread owns
// 4 consecutive tokens (char4 loads, a warp reads 128 consecutive bytes of
// a d row) and walks d; for P·V a thread owns a d row and walks its tokens,
// 16 per 16-byte load. The softmax sum runs thread-strided, then through a
// xor butterfly, then over warps. Those loops, the query quantizer and the
// row encode live in decode_common.cuh, shared with the direct-write
// decode kernels (decode_attention_quantized.cu).
#include "decode_common.cuh"

namespace {

using namespace decode;

template <int D>
__device__ __forceinline__ void score_column(const Cache& c, int col,
                                             const float* qs, int nrep,
                                             float (&s)[NREP_MAX]) {
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) s[h] = 0.f;
  for (int g = 0; g < D / 16; ++g) {
    const float scl = exp2_int((int)c.ke[(size_t)g * c.stride + col] - 7);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int d = g * 16 + jj;
      const float kval = (float)c.kc[(size_t)d * c.stride + col] * scl;
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep) s[h] = fmaf(qs[h * D + d], kval, s[h]);
    }
  }
}

template <int D>
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
  extern __shared__ float smem[];
  const int b = blockIdx.x, kv = blockIdx.y, t = threadIdx.x;
  const int H = KVH * nrep, LS = L + SW;
  float* qs = smem;            // nrep x D
  float* sc = qs + nrep * D;   // nrep x (L + SW)
  const int pos = pos_p[b], fl = fl_p[b];
  const int r = pos % SW;
  const size_t bk = (size_t)b * KVH + kv;
  const Cache main_c{kc + bk * D * L, ke + bk * GD * L, vc + bk * D * L,
                     ve + bk * GD * L, L};
  const Cache ring_c{ksc + bk * D * SW, kse + bk * GD * SW, vsc + bk * D * SW,
                     vse + bk * GD * SW, SW};

  // 1. quantized queries
  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  // 2. encode the fresh K/V rows into ring lane r, in place
  for (int idx = t; idx < 2 * GD; idx += NT) {
    const int g = idx % GD;
    const bool is_v = idx >= GD;
    encode_group((is_v ? vh : kh) + bk * D + g * 16,
                 (is_v ? vsc : ksc) + bk * D * SW,
                 (is_v ? vse : kse) + bk * GD * SW, SW, r, g);
  }
  __syncthreads();

  // 3. scores: main columns [0, fl) and ring lanes (index L + lane)
  for (int j = 4 * t; j < fl; j += 4 * NT) {   // fl is a multiple of 32
    float s4[4][NREP_MAX];
    score_4_columns<D, 8>(main_c, j, qs, nrep, s4);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep)
          sc[h * LS + j + u] = s4[u][h] * scaling;
  }
  float s[NREP_MAX];
  for (int jr = t; jr < SW; jr += NT) {
    const int tl = pos - ((pos - jr) % SW + SW) % SW;  // position in lane jr
    const bool valid = tl >= fl;
    if (valid) score_column<D>(ring_c, jr, qs, nrep, s);
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep)
        sc[h * LS + L + jr] =
            valid ? s[h] * scaling : -INFINITY;
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
    pv_row<D, 8>(main_c, dd, fl, sc, LS, nrep, acc);
    pv_row<D, 8>(ring_c, dd, SW, sc + L, LS, nrep, acc);
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep) out[((size_t)b * H + kv * nrep + h) * D + dd] = acc[h];
  }
}

template <int D>
int launch(const void* q, const void* kc, const void* ke, const void* vc,
           const void* ve, void* ksc, void* kse, void* vsc, void* vse,
           const void* kh, const void* vh, const void* pos, const void* fl,
           void* out, int B, int KVH, int nrep, int L, int SW, float scaling,
           int q_mb, int p_mb, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)nrep * (D + L + SW);
  if (nrep < 1 || nrep > NREP_MAX || L % NT != 0 || SW > NT || smem > 220 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(staged_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  staged_decode_kernel<D><<<dim3(B, KVH), NT, smem, st>>>(
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

}  // namespace

// One layer: q (B, H, D) f32; main codes (B, KVH, D, L) and exps
// (B, KVH, D/16, L) int8; ring codes (B, KVH, D, SW) and exps
// (B, KVH, D/16, SW) int8, updated in place at lane pos % SW; kh, vh
// (B, KVH, D) f32; positions, flushed (B) int32; out (B, H, D) f32.
LQER_API int lqer_staged_decode_attention(
    const void* q, const void* kc, const void* ke, const void* vc,
    const void* ve, void* ksc, void* kse, void* vsc, void* vse, const void* kh,
    const void* vh, const void* pos, const void* fl, void* out, int B, int KVH,
    int nrep, int D, int L, int SW, float scaling, int q_mb, int p_mb,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LQER_DEC_ARGS                                                          \
  q, kc, ke, vc, ve, ksc, kse, vsc, vse, kh, vh, pos, fl, out, B, KVH, nrep, L, \
      SW, scaling, q_mb, p_mb, st
  if (D == 128) return launch<128>(LQER_DEC_ARGS);
  if (D == 64) return launch<64>(LQER_DEC_ARGS);
#undef LQER_DEC_ARGS
  return (int)cudaErrorInvalidValue;
}
