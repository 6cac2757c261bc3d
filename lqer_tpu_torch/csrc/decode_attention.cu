// Kernels 3 and 9: staged decode attention over the MXINT8 or MXINT4 KV
// cache, one query token per slot, with the fresh token's K/V rows encoded
// into the staging ring in the same call; the one-pass kernel (row 7) and
// the streaming one past the one-pass length (row 9) are one design.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel_quantized_staged
// (entry decode_attention_quantized_staged, code width 8 or 4: the JAX
// kernel reads the width off the code rows, d or d/2; row 7) and
// ::_stats_kernel_staged + ::_out_kernel_staged (entry
// decode_attention_quantized_streaming_staged, two passes over chunks of L
// because the TPU kernel's VMEM cannot hold a long context; row 9). The
// function is the same. Per (slot, kv head):
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
// width 4, of the flushed prefix and the ring's valid lanes. Only
// [0, flushed) is read: the TPU block read all L only because VMEM
// residency made that free.
//
// Design: decode_mx_split.cuh in mode STAGED, shared with rows 6, 8 and 10.
// A block of 256 threads per (slot, kv head, span of cpb chunks of 256
// tokens of [0, flushed)), plus one block per (slot, kv head) for the ring,
// the last chunk in every combine: row 7 takes cpb = 1, row 9 the span of
// split_plan.chunks_per_block, its blocks walking their chunks through two
// shared-memory tiles as row 8's do. Only the ring's block touches the
// ring: in launch 1 it encodes the fresh rows into lane pos % 64, passes a
// barrier, then copies and scores its 64 lanes; in launch 2 (a programmatic
// dependent launch) it copies its V lanes after griddepcontrol.wait, where
// the main blocks copy their first V chunk before it. Nothing in shared
// memory grows with L: the scores and the span stats go through a global
// scratch of (B, H, L + 64). With flushed = 0 the ring is the only chunk.
#include "decode_mx_split.cuh"

// One layer: q (B, H, D) f32; main codes (B, KVH, CR, L) and exps
// (B, KVH, D/16, L) int8, CR = D at code width 8, D/2 at width 4 (d-split
// nibbles); ring codes (B, KVH, CR, 64) and exps (B, KVH, D/16, 64) int8,
// updated in place at lane pos % 64; kh, vh (B, KVH, D) f32; positions,
// flushed (B) int32 (flushed a multiple of 16, at most pos); out (B, H, D)
// f32; cpb: the chunks of 256 tokens a block walks; scratch:
// decode_split.cuh's carve with scores (B, H, L + 64) and NZ =
// ceil(ceil(L / 256) / cpb) + 1. D is 64, 80, 96 or 128 (width 4:
// D % 32 == 0), L a multiple of 16.
LQER_API int lqer_staged_decode_attention(
    const void* q, const void* kc, const void* ke, const void* vc,
    const void* ve, void* ksc, void* kse, void* vsc, void* vse, const void* kh,
    const void* vh, const void* pos, const void* fl, void* scratch, void* out,
    int B, int KVH, int nrep, int D, int L, int code_width, int cpb,
    float scaling, int q_mb, int p_mb, void* stream) {
  using namespace decode;
  auto i8 = [](const void* p) {
    return static_cast<int8_t*>(const_cast<void*>(p));
  };
  SplitArgs a = {};
  a.q = static_cast<const float*>(q);
  a.kc = i8(kc), a.ke = i8(ke), a.vc = i8(vc), a.ve = i8(ve);
  a.ksc = i8(ksc), a.kse = i8(kse), a.vsc = i8(vsc), a.vse = i8(vse);
  a.kh = static_cast<const float*>(kh), a.vh = static_cast<const float*>(vh);
  a.pos = static_cast<const int*>(pos), a.fl = static_cast<const int*>(fl);
  a.out = static_cast<float*>(out);
  a.KVH = KVH, a.nrep = nrep, a.L = L, a.cpb = cpb;
  a.scaling = scaling, a.q_mb = q_mb, a.p_mb = p_mb, a.window = -1;
  return split_attend<STAGED>(a, B, D, code_width, scratch,
                              reinterpret_cast<cudaStream_t>(stream));
}
