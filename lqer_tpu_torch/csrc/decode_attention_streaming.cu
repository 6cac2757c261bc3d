// Streaming decode attention over the direct-write MXINT cache (codes of
// width 8 or 4), one query token per slot, past the JAX package's one-pass
// length: row 8. The staged cache's streaming kernel (row 9) is row 7's
// launch with longer spans (decode_attention.cu).
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_stats_kernel and
// ::_out_kernel (entry decode_attention_quantized_streaming). The function
// is the one-pass kernel's (row 6): scores over the columns a slot holds,
// one exact f32 softmax, P quantized per 16 tokens with the FINAL max and
// denominator, then P·V. That quantizer is what forces two passes: a
// 16-token group's exponent depends on exp(s - m) / denom with the final m
// and denom, so no one-pass online rescaling reproduces it.
//
// What bounds it on an H100: the cache stream, (code bytes + d/16 exponent
// bytes) x 2 per token and kv head over the columns a slot holds (136 x 2
// bytes at d = 128 and width 8, 72 x 2 at width 4): at 4 slots x 32 kv
// heads x 32K tokens, 1.1 GB per layer at width 8, 0.33 ms at 3.35 TB/s.
// The TPU kernel streams every chunk of L, masked past pos, and reads K
// twice (2K + V); here spans wholly past pos contribute exactly zero in
// both passes and are not read, and K is read once: pass 1 keeps the
// scores, 4 bytes per token and query head, against K's 136 per kv head.
//
// Design: decode_mx_split.cuh in mode READ, row 6's kernels, with a block
// walking cpb chunks of 256 tokens through two shared-memory tiles (the
// next chunk's cp.async copy in flight while the current one is scored or
// multiplied), in two launches, the second a programmatic dependent launch
// whose last block of each (slot, kv head) sums the partials in chunk
// order. Under a sliding window (window > 0; -1 for none) the columns at or
// below pos - window are masked too, and spans wholly below the group
// holding the window's first key are skipped in both passes.
#include "decode_mx_split.cuh"

// Row 8, one layer: q (B, H, D) f32; codes (B, KVH, D, L) (width 8) or
// (B, KVH, D/2, L) (width 4, d-split nibbles) and exps (B, KVH, D/16, L)
// int8, the layer's slice of the layer-stacked cache; positions (B) int32;
// out (B, H, D) f32; window: the sliding window in tokens, -1 for none;
// cpb: the chunks of 256 tokens a block walks; scratch: decode_split.cuh's
// carve with scores (B, H, L) and NZ = ceil(ceil(L / 256) / cpb). D is 64,
// 80, 96 or 128 (width 4: D % 32 == 0).
LQER_API int lqer_decode_attention_streaming(
    const void* q, void* kc, void* ke, void* vc, void* ve, const void* pos,
    void* scratch, void* out, int B, int KVH, int nrep, int D, int L,
    int code_width, int cpb, float scaling, int q_mb, int p_mb, int window,
    void* stream) {
  using namespace decode;
  auto i8 = [](void* p) { return static_cast<int8_t*>(p); };
  SplitArgs a = {};
  a.q = static_cast<const float*>(q);
  a.kc = i8(kc), a.ke = i8(ke), a.vc = i8(vc), a.ve = i8(ve);
  a.pos = static_cast<const int*>(pos);
  a.out = static_cast<float*>(out);
  a.KVH = KVH, a.nrep = nrep, a.L = L, a.cpb = cpb;
  a.scaling = scaling, a.q_mb = q_mb, a.p_mb = p_mb, a.window = window;
  return split_attend<READ>(a, B, D, code_width, scratch,
                            reinterpret_cast<cudaStream_t>(stream));
}
