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
//   3. one exact f32 softmax; p quantized per 16 tokens with the final max
//      and denominator;
//   4. out = Σ p · v.
//
// What bounds it on an H100: the cache stream, (code bytes + d/16 exponent
// bytes) x 2 per token and kv head over the 16-token groups from the one
// holding the window's first key (decode_common.cuh's window_start; column
// 0 without a window) to the one holding pos: 136 x 2 bytes at d = 128 and
// width 8, 72 x 2 at width 4 (at 8 slots x 32 kv heads x about 1000 tokens,
// 0.021 and 0.011 ms at 3.35 TB/s). The TPU block read all L because VMEM
// residency made that free.
//
// Design: decode_mx_split.cuh (modes READ and WRITE, one chunk of 256
// tokens a block), shared with rows 7 and 8.
#include "decode_mx_split.cuh"

// One layer: q (B, H, D) f32; codes (B, KVH, D, L) (width 8) or
// (B, KVH, D/2, L) (width 4, d-split nibbles) and exps (B, KVH, D/16, L)
// int8, the layer's slice of the layer-stacked cache; positions (B) int32;
// out (B, H, D) f32. With kh and vh ((B, KVH, D) f32, width 8 only) the
// fresh rows are encoded into column positions[b] in place first; pass
// null pointers for the read-only kernel. window: the sliding window in
// tokens, -1 for none. scratch: decode_split.cuh's carve, NZ = ceil(L /
// 256). D is a multiple of 16 from 64 to 128 (instantiated at 64, 80, 96
// and 128; width 4 needs D % 32 == 0).
LQER_API int lqer_decode_attention_quantized(
    const void* q, void* kc, void* ke, void* vc, void* ve, const void* kh,
    const void* vh, const void* pos, void* scratch, void* out, int B, int KVH,
    int nrep, int D, int L, int code_width, float scaling, int q_mb, int p_mb,
    int window, void* stream) {
  using namespace decode;
  auto i8 = [](void* p) { return static_cast<int8_t*>(p); };
  SplitArgs a = {};
  a.q = static_cast<const float*>(q);
  a.kc = i8(kc), a.ke = i8(ke), a.vc = i8(vc), a.ve = i8(ve);
  a.kh = static_cast<const float*>(kh), a.vh = static_cast<const float*>(vh);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.KVH = KVH, a.nrep = nrep, a.L = L, a.cpb = 1;
  a.scaling = scaling, a.q_mb = q_mb, a.p_mb = p_mb, a.window = window;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (kh != nullptr)
    return split_attend<WRITE>(a, B, D, code_width, scratch, st);
  return split_attend<READ>(a, B, D, code_width, scratch, st);
}
