// Streaming decode attention over the MXINT cache, one query token per slot,
// past the JAX package's one-pass length: the direct-write cache (codes of
// width 8 or 4; row 8) and the ring-staged cache (width 8 or 4, with the
// fresh token's ring write; row 9).
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_stats_kernel and
// ::_out_kernel (entry decode_attention_quantized_streaming: row 8) and
// ::_stats_kernel_staged and ::_out_kernel_staged (entry
// decode_attention_quantized_streaming_staged: row 9). The function is the
// one-pass kernels' (rows 6 and 7): scores over the columns a slot holds,
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
// twice (2K + V); here chunks wholly past pos (past flushed for the staged
// main cache) contribute exactly zero in both passes and are not read, and
// K is read once: pass 1 keeps the scores, 4 bytes per token and query
// head, against K's 136 per kv head.
//
// Row 8's design: decode_mx_split.cuh in mode READ, row 6's kernels, with
// a block walking cpb chunks of 256 tokens through two shared-memory tiles
// (the next chunk's cp.async copy in flight while the current one is
// scored or multiplied), in two launches, the second a programmatic
// dependent launch whose last block of each (slot, kv head) sums the
// partials in chunk order. Under a sliding window (window > 0; -1 for
// none) the columns at or below pos - window are masked too, and spans
// wholly below the group holding the window's first key are skipped in
// both passes.
//
// Row 9's design (kept as first built, its direct-cache branches too, so
// that its time stays where it was until its own redesign): a
// block per (slot, kv head, CHUNK tokens), its n_rep query heads sharing
// each K/V value read, in three launches:
//   1. scores of the chunk (decode_common.cuh's score_4_columns, the query
//      quantizer, scaling) into the scores scratch, and the chunk's max m_c
//      and sum l_c = Σ exp(s - m_c) per head;
//   2. every block combines the chunk stats of its (slot, kv head) in chunk
//      order (m = max m_c, denom = Σ l_c exp(m_c - m); a chunk of max -inf
//      adds 0, not NaN, and a zero denominator becomes 1, the TPU kernel's
//      guards), p = exp(s - m) / denom of its chunk, quantized per 16 tokens
//      (CHUNK % 16 == 0, so the groups stay inside a chunk), and its
//      partial P·V (pv_row);
//   3. a block per (slot, kv head) sums the partials in chunk order.
// No float atomics: a run repeats itself to the bit. The ring is one more
// chunk after the main chunks [0, flushed): its block of pass 1 first
// encodes the fresh K/V rows into lane pos % SW (decode_common.cuh's
// encode_kv_column, row 7's encode at either width), synchronises and
// scores the lanes whose token pos - ((pos - j) mod SW) is at least
// flushed; pass 2 reads the ring after the kernel boundary, so the write is
// visible to it.
#include "decode_mx_split.cuh"

namespace {

using namespace decode;

constexpr int CHUNK = 512;  // tokens per block

// Main columns a slot holds: whole 16-token groups up to the one holding pos
// (direct), or [0, flushed) (staged).
__device__ __forceinline__ int main_columns(const int* pos_p, const int* fl_p,
                                            int b, int L) {
  if (fl_p != nullptr) return fl_p[b];
  return max(0, min((pos_p[b] + 16) / 16 * 16, L));
}

struct Slab {
  Cache main;  // this (slot, kv head)'s main cache, token stride L
  Cache ring;  // its ring (STAGED), token stride SW
};

template <int D, int CW>
__device__ __forceinline__ Slab slab(int8_t* kc, int8_t* ke, int8_t* vc,
                                     int8_t* ve, int8_t* ksc, int8_t* kse,
                                     int8_t* vsc, int8_t* vse, size_t bk,
                                     int L, int SW) {
  constexpr int GD = D / 16;
  constexpr int CR = CW == 8 ? D : D / 2;  // code rows
  Slab s{{kc + bk * CR * L, ke + bk * GD * L, vc + bk * CR * L,
          ve + bk * GD * L, L},
         {nullptr, nullptr, nullptr, nullptr, SW}};
  if (ksc != nullptr)
    s.ring = Cache{ksc + bk * CR * SW, kse + bk * GD * SW, vsc + bk * CR * SW,
                   vse + bk * GD * SW, SW};
  return s;
}

// The chunk of block z: its cache columns from c; n columns (a multiple of
// 16); off, its first column in a score row of LS; j0, the first column of
// it the kernel reads (a multiple of 16: above 0 only in the chunk holding
// the window's first column, first). False where the chunk lies wholly past
// the columns the slot holds, or wholly below first.
__device__ __forceinline__ bool chunk_of(const Slab& s, int z, int NZ,
                                         int nmain, int first, int L, Cache& c,
                                         int& n, int& off, int& j0) {
  j0 = 0;
  if (s.ring.kc != nullptr && z == NZ - 1) {
    c = s.ring;
    n = s.ring.stride;
    off = L;
    return true;
  }
  off = z * CHUNK;
  if (off >= nmain) return false;
  n = min(CHUNK, nmain - off);
  if (off + n <= first) return false;
  j0 = max(0, first - off);
  c = shifted(s.main, off);
  return true;
}

// Pass 1. Grid (B, KVH, NZ); NZ = ceil(L / CHUNK) (+1 for the ring).
template <int D, int CW>
__global__ void __launch_bounds__(NT)
stream_scores_kernel(const float* __restrict__ q, int8_t* kc, int8_t* ke,
                     int8_t* vc, int8_t* ve, int8_t* ksc, int8_t* kse,
                     int8_t* vsc, int8_t* vse, const float* __restrict__ kh,
                     const float* __restrict__ vh,
                     const int* __restrict__ pos_p, const int* fl_p,
                     float* __restrict__ scores, float* __restrict__ st_m,
                     float* __restrict__ st_l, int KVH, int nrep, int L,
                     int SW, float scaling, int q_mb, int window) {
  constexpr int GD = D / 16;
  constexpr int CR = CW == 8 ? D : D / 2;  // code rows
  extern __shared__ float smem[];
  __shared__ float m_s[NREP_MAX];
  __shared__ float l_s[NREP_MAX];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, H = KVH * nrep;
  const int LS = L + (ksc != nullptr ? SW : 0);
  const size_t bk = (size_t)b * KVH + kv;
  const Slab s = slab<D, CW>(kc, ke, vc, ve, ksc, kse, vsc, vse, bk, L, SW);
  const int pos = pos_p[b];
  const int nmain = main_columns(pos_p, fl_p, b, L);
  Cache c;
  int n, off, j0;
  if (!chunk_of(s, z, NZ, nmain, window_start(pos, window), L, c, n, off, j0))
    return;
  const bool ring = off == L;
  float* qs = smem;            // nrep x D
  float* sc = qs + nrep * D;   // nrep x CHUNK

  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  if (ring)  // the fresh K/V rows into lane pos % SW, in place
    encode_kv_column<D, CW>(kh + bk * D, vh + bk * D, ksc + bk * CR * SW,
                            kse + bk * GD * SW, vsc + bk * CR * SW,
                            vse + bk * GD * SW, SW, pos % SW);
  __syncthreads();

  float acc[NREP_MAX];
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) acc[h] = -INFINITY;
  float* srow = scores + ((size_t)b * H + kv * nrep) * LS + off;
  for (int j = j0 + 4 * t; j < n; j += 4 * NT) {
    float s4[4][NREP_MAX];
    score_4_columns<D, CW>(c, j, qs, nrep, s4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = j + u;
      // a ring lane counts where the token it holds is at least flushed;
      // a main column past pos or outside the window (direct) is masked;
      // the staged main is not
      const bool ok =
          ring ? pos - ((pos - col) % SW + SW) % SW >= nmain
               : (fl_p != nullptr || in_window(off + col, pos, window));
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep) {
          const float v = ok ? s4[u][h] * scaling : -INFINITY;
          sc[h * CHUNK + col] = v;
          srow[(size_t)h * LS + col] = v;
          acc[h] = fmaxf(acc[h], v);
        }
    }
  }
  block_reduce<true>(acc, nrep, m_s);
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) acc[h] = 0.f;
  for (int j = j0 + t; j < n; j += NT)
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep && m_s[h] != -INFINITY)
        acc[h] += expf(sc[h * CHUNK + j] - m_s[h]);
  block_reduce<false>(acc, nrep, l_s);
  if (t < nrep) {
    st_m[(bk * NZ + z) * nrep + t] = m_s[t];
    st_l[(bk * NZ + z) * nrep + t] = l_s[t];
  }
}

// The chunks a slot holds, in the order every pass combines them: the main
// chunks from the first read (i from first / CHUNK), then the ring.
__device__ __forceinline__ int chunk_index(int i, int ncm, int NZ) {
  return i < ncm ? i : NZ - 1;
}

// Pass 2. Same grid as pass 1.
template <int D, int CW>
__global__ void __launch_bounds__(NT)
stream_pv_kernel(int8_t* kc, int8_t* ke, int8_t* vc, int8_t* ve, int8_t* ksc,
                 int8_t* kse, int8_t* vsc, int8_t* vse,
                 const int* __restrict__ pos_p, const int* fl_p,
                 const float* __restrict__ scores,
                 const float* __restrict__ st_m,
                 const float* __restrict__ st_l, float* __restrict__ part,
                 int KVH, int nrep, int L, int SW, int p_mb, int window) {
  extern __shared__ float smem[];
  __shared__ float m_s[NREP_MAX];
  __shared__ float d_s[NREP_MAX];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, H = KVH * nrep;
  const bool staged = ksc != nullptr;
  const int LS = L + (staged ? SW : 0);
  const size_t bk = (size_t)b * KVH + kv;
  const Slab s = slab<D, CW>(kc, ke, vc, ve, ksc, kse, vsc, vse, bk, L, SW);
  const int nmain = main_columns(pos_p, fl_p, b, L);
  const int first = window_start(pos_p[b], window);
  Cache c;
  int n, off, j0;
  if (!chunk_of(s, z, NZ, nmain, first, L, c, n, off, j0)) return;
  float* sc = smem;            // nrep x CHUNK

  if (t < nrep) {  // the final stats, chunk by chunk in order
    const int ncm = (nmain + CHUNK - 1) / CHUNK, nz = ncm + (staged ? 1 : 0);
    const int c0 = first / CHUNK;
    const float* sm = st_m + bk * NZ * nrep + t;
    const float* sl = st_l + bk * NZ * nrep + t;
    float m = -INFINITY;
    for (int i = c0; i < nz; ++i)
      m = fmaxf(m, sm[(size_t)chunk_index(i, ncm, NZ) * nrep]);
    float den = 0.f;
    for (int i = c0; i < nz; ++i) {
      const size_t zi = (size_t)chunk_index(i, ncm, NZ) * nrep;
      if (sm[zi] != -INFINITY) den += sl[zi] * expf(sm[zi] - m);
    }
    m_s[t] = m;
    d_s[t] = den == 0.f ? 1.f : den;
  }
  __syncthreads();
  const float* srow = scores + ((size_t)b * H + kv * nrep) * LS + off;
  for (int j = j0 + t; j < n; j += NT)
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep) sc[h * CHUNK + j] = expf(srow[(size_t)h * LS + j] - m_s[h]);
  __syncthreads();
  normalize_quantize_p(sc, CHUNK, 0, j0, n - j0, nrep, d_s, p_mb);

  for (int dd = t; dd < D; dd += NT) {
    float acc[NREP_MAX];
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h) acc[h] = 0.f;
    pv_row<D, CW>(shifted(c, j0), dd, n - j0, sc + j0, CHUNK, nrep, acc);
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      if (h < nrep) part[((bk * NZ + z) * nrep + h) * D + dd] = acc[h];
  }
}

// Pass 3. Grid (B, KVH): out = Σ of the partials in chunk order.
__global__ void __launch_bounds__(NT)
stream_sum_kernel(const float* __restrict__ part,
                  const int* __restrict__ pos_p, const int* fl_p,
                  float* __restrict__ out, int KVH, int nrep, int D, int L,
                  int NZ, int window) {
  const int b = blockIdx.x, kv = blockIdx.y, H = KVH * nrep;
  const size_t bk = (size_t)b * KVH + kv;
  const int ncm = (main_columns(pos_p, fl_p, b, L) + CHUNK - 1) / CHUNK;
  const int nz = ncm + (fl_p != nullptr ? 1 : 0);
  const int c0 = window_start(pos_p[b], window) / CHUNK;
  for (int idx = threadIdx.x; idx < nrep * D; idx += NT) {
    float acc = 0.f;
    for (int i = c0; i < nz; ++i)
      acc += part[(bk * NZ + chunk_index(i, ncm, NZ)) * nrep * D + idx];
    out[((size_t)b * H + kv * nrep) * D + idx] = acc;
  }
}

template <int D, int CW>
int launch(const void* q, void* kc, void* ke, void* vc, void* ve, void* ksc,
           void* kse, void* vsc, void* vse, const void* kh, const void* vh,
           const void* pos, const void* fl, void* scores, void* st_m,
           void* st_l, void* part, void* out, int B, int KVH, int nrep, int L,
           int SW, float scaling, int q_mb, int p_mb, int window,
           cudaStream_t st) {
  const bool staged = ksc != nullptr;
  if (nrep < 1 || nrep > NREP_MAX || L % 16 != 0 || window == 0 ||
      window < -1 || (staged && window != -1) ||
      (staged && (SW % 16 != 0 || SW > CHUNK || fl == nullptr ||
                  kh == nullptr || vh == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int NZ = (L + CHUNK - 1) / CHUNK + (staged ? 1 : 0);
  const dim3 grid(B, KVH, NZ);
  const size_t smem1 = sizeof(float) * (size_t)nrep * (D + CHUNK);
  const size_t smem2 = sizeof(float) * (size_t)nrep * CHUNK;
  auto i8 = [](void* p) { return static_cast<int8_t*>(p); };
  stream_scores_kernel<D, CW><<<grid, NT, smem1, st>>>(
      static_cast<const float*>(q), i8(kc), i8(ke), i8(vc), i8(ve), i8(ksc),
      i8(kse), i8(vsc), i8(vse), static_cast<const float*>(kh),
      static_cast<const float*>(vh), static_cast<const int*>(pos),
      static_cast<const int*>(fl), static_cast<float*>(scores),
      static_cast<float*>(st_m), static_cast<float*>(st_l), KVH, nrep, L, SW,
      scaling, q_mb, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_pv_kernel<D, CW><<<grid, NT, smem2, st>>>(
      i8(kc), i8(ke), i8(vc), i8(ve), i8(ksc), i8(kse), i8(vsc), i8(vse),
      static_cast<const int*>(pos), static_cast<const int*>(fl),
      static_cast<const float*>(scores), static_cast<const float*>(st_m),
      static_cast<const float*>(st_l), static_cast<float*>(part), KVH, nrep,
      L, SW, p_mb, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_sum_kernel<<<dim3(B, KVH), NT, 0, st>>>(
      static_cast<const float*>(part), static_cast<const int*>(pos),
      static_cast<const int*>(fl), static_cast<float*>(out), KVH, nrep, D, L,
      NZ, window);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch(int code_width, const void* q, void* kc, void* ke, void* vc,
             void* ve, void* ksc, void* kse, void* vsc, void* vse,
             const void* kh, const void* vh, const void* pos, const void* fl,
             void* scores, void* st_m, void* st_l, void* part, void* out,
             int B, int KVH, int nrep, int L, int SW, float scaling, int q_mb,
             int p_mb, int window, cudaStream_t st) {
#define LQER_STREAM_ARGS                                                    \
  q, kc, ke, vc, ve, ksc, kse, vsc, vse, kh, vh, pos, fl, scores, st_m, st_l, \
      part, out, B, KVH, nrep, L, SW, scaling, q_mb, p_mb, window, st
  if (code_width == 8) return launch<D, 8>(LQER_STREAM_ARGS);
  if constexpr (D % 32 == 0)
    if (code_width == 4) return launch<D, 4>(LQER_STREAM_ARGS);
#undef LQER_STREAM_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

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

// Row 9, one layer: q (B, H, D) f32; main codes (B, KVH, D, L) (width 8)
// or (B, KVH, D/2, L) (width 4) and exps (B, KVH, D/16, L) int8; ring codes
// (B, KVH, D, SW) (width 8) or (B, KVH, D/2, SW) (width 4) and exps
// (B, KVH, D/16, SW) int8, updated in place at lane pos % SW; the fresh
// rows kh, vh (B, KVH, D) f32; positions and flushed (B) int32. Scratch:
// scores (B, H, L + SW), st_m and st_l (B, KVH, NZ, nrep), part (B, KVH,
// NZ, nrep, D) f32, with NZ = ceil(L / 512) + 1. D is 64, 80, 96 or 128
// (width 4: D % 32 == 0).
LQER_API int lqer_decode_attention_streaming_staged(
    const void* q, void* kc, void* ke, void* vc, void* ve, void* ksc,
    void* kse, void* vsc, void* vse, const void* kh, const void* vh,
    const void* pos, const void* fl, void* scores, void* st_m, void* st_l,
    void* part, void* out, int B, int KVH, int nrep, int D, int L, int SW,
    int code_width, float scaling, int q_mb, int p_mb, void* stream) {
  if (ksc == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LQER_STREAM_ARGS                                                    \
  code_width, q, kc, ke, vc, ve, ksc, kse, vsc, vse, kh, vh, pos, fl, scores, \
      st_m, st_l, part, out, B, KVH, nrep, L, SW, scaling, q_mb, p_mb, -1, st
  switch (D) {
    case 64: return dispatch<64>(LQER_STREAM_ARGS);
    case 80: return dispatch<80>(LQER_STREAM_ARGS);
    case 96: return dispatch<96>(LQER_STREAM_ARGS);
    case 128: return dispatch<128>(LQER_STREAM_ARGS);
  }
#undef LQER_STREAM_ARGS
  return (int)cudaErrorInvalidValue;
}
