// Kernel 4: flush of the staging ring into the main KV cache.
//
// Replaces lqer_tpu/ops/pallas/cache_write.py::_kernel_flush (entry
// flush_stage_to_main). For every layer, slot, kv head and row of the four
// cache arrays (K codes, K exponents, V codes, V exponents):
//     main[..., t] = ring[..., t % SW]   for t in [flushed[b], new_flushed[b])
// A bit-exact masked indexed copy; one launch covers all layers.
//
// What bounds it on an H100: bytes, a read and a write of at most 63
// tokens x 136 bytes per (layer, slot, kv head, K/V); about 70 MB at the
// 7B shape with 8 slots and 32 tokens each. It runs once per >= 17 decode
// steps.
//
// Design: the TPU kernel read-modify-wrote whole 128-lane main windows in
// two aliased passes (Mosaic tiling and one alias per buffer); here a
// block per (layer x slot, array) writes just the span, in place, with
// consecutive threads on consecutive tokens of a row.
#include "mx_common.cuh"

namespace {

struct FlushArrays {
  int8_t* main[4];         // (NL, B, KVH, rows, L)
  const int8_t* ring[4];   // (NL, B, KVH, rows, SW)
  int rows[4];
};

__global__ void flush_kernel(FlushArrays a, const int* __restrict__ fl_p,
                             const int* __restrict__ nf_p, int B, int KVH,
                             int L, int SW) {
  const int lb = blockIdx.x;  // layer * B + slot
  const int arr = blockIdx.y;
  const int b = lb % B;
  const int f = fl_p[b];
  const int span = nf_p[b] - f;
  if (span <= 0) return;
  const size_t nrow = (size_t)KVH * a.rows[arr];
  int8_t* main = a.main[arr] + (size_t)lb * nrow * L;
  const int8_t* ring = a.ring[arr] + (size_t)lb * nrow * SW;
  for (size_t i = threadIdx.x; i < nrow * span; i += blockDim.x) {
    const size_t row = i / span;
    const int tok = f + (int)(i % span);
    main[row * L + tok] = ring[row * SW + tok % SW];
  }
}

}  // namespace

// main_*: (NL, B, KVH, rows, L) int8, updated in place; ring_*: the
// (NL, B, KVH, rows, SW) rings; rows_* is d for codes, d/16 for exponents;
// flushed, new_flushed (B) int32.
LQER_API int lqer_flush_stage(void* main0, void* main1, void* main2,
                              void* main3, const void* ring0,
                              const void* ring1, const void* ring2,
                              const void* ring3, int rows0, int rows1,
                              int rows2, int rows3, const void* flushed,
                              const void* new_flushed, int NL, int B, int KVH,
                              int L, int SW, void* stream) {
  FlushArrays a;
  a.main[0] = static_cast<int8_t*>(main0);
  a.main[1] = static_cast<int8_t*>(main1);
  a.main[2] = static_cast<int8_t*>(main2);
  a.main[3] = static_cast<int8_t*>(main3);
  a.ring[0] = static_cast<const int8_t*>(ring0);
  a.ring[1] = static_cast<const int8_t*>(ring1);
  a.ring[2] = static_cast<const int8_t*>(ring2);
  a.ring[3] = static_cast<const int8_t*>(ring3);
  a.rows[0] = rows0;
  a.rows[1] = rows1;
  a.rows[2] = rows2;
  a.rows[3] = rows3;
  flush_kernel<<<dim3(NL * B, 4), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(flushed), static_cast<const int*>(new_flushed),
      B, KVH, L, SW);
  return (int)cudaGetLastError();
}
