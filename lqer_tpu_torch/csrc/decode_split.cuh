// The split-over-L scheme of the one-pass decode attention kernels (rows 5,
// 6, 7 and 10: decode_attention_fp.cu, decode_mx_split.cuh) and of the
// streaming ones (rows 8 and 9): a block per (slot, kv head, span of cpb
// chunks of CH tokens), its n_rep query heads sharing each K/V value it
// reads, in two launches with nothing in shared memory that grows with L:
//   1. the span's scores (masked past pos and below the window) into a
//      global f32 scratch (B x H x L, or L + 64 with the staged cache's
//      ring), and per head the span's max m_c and l_c = Σ exp(s - m_c)
//      (store_scores_and_stats, span_stats);
//   2. the final stats of the (slot, kv head) combined in chunk order, a
//      thread per token forming its p = exp(s - m) / den quantized per 16
//      tokens with them (final_stats, token_p); the span's partial P·V, the
//      warps' partials summed in order, and the last block of the (slot, kv
//      head) summing the partials in chunk order (finish_chunk).
// The staged cache (rows 7 and 9) has its main columns [0, flushed) in such
// spans and its 64-lane ring as one more chunk, the last in every order
// (chunk_of). No float atomics: a run repeats itself to the bit. Blocks
// whose span lies wholly outside [the window's first group, the group
// holding pos] (or past flushed) exit at once.
#pragma once

#include "decode_common.cuh"

namespace decode {

constexpr int FT = 256;      // threads per block
constexpr int FW = FT / 32;  // warps per block
constexpr int CH = FT;       // tokens per chunk: one per thread

// 16-byte asynchronous copies to shared memory (cp.async; .cg bypasses
// L1): a thread's copies are committed as groups and waited for, all but
// the newest N, before a barrier makes the rows visible to other threads.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int RING = 64;     // lanes of the staged cache's ring

// The chunk (span) of block z for the query at pos, in a grid of NZ blocks
// along z whose blocks span SPAN tokens (a multiple of CH): tokens
// [c0 + j0, c0 + n) of the slot's context (j0 and n multiples of 16); zi,
// its index among the (slot, kv head)'s stats and partials, which the
// combine takes over [z0, z1) in order. Direct cache (fl_p null): the
// columns up to the group holding pos, from the window's first group.
// Staged cache: the main columns [0, flushed), then the ring as block NZ -
// 1, its lanes at score columns [L, L + 64) and its index the last, z1 - 1
// (ring set). False where the span lies wholly past the group holding pos
// (past flushed) or wholly below the window's first group.
struct Chunk {
  int pos, ntok, first, c0, j0, n;
  int zi, z0, z1;
  bool ring;
};

__device__ __forceinline__ bool chunk_of(const int* pos_p, const int* fl_p,
                                         int b, int z, int NZ, int L,
                                         int window, int span, Chunk& c) {
  c.pos = pos_p[b];
  c.ring = false;
  if (fl_p == nullptr) {
    c.ntok = max(0, min((c.pos + 16) / 16 * 16, L));
    c.first = min(window_start(c.pos, window), c.ntok);
    c.z0 = c.first / span;
    c.z1 = (c.ntok + span - 1) / span;
  } else {
    c.ntok = fl_p[b];
    c.first = 0;
    c.z0 = 0;
    c.z1 = (c.ntok + span - 1) / span + 1;
    if (z == NZ - 1) {
      c.ring = true;
      c.c0 = L;
      c.j0 = 0;
      c.n = RING;
      c.zi = c.z1 - 1;
      return true;
    }
  }
  c.zi = z;
  c.c0 = z * span;
  if (c.c0 >= c.ntok || c.c0 + span <= c.first) return false;
  c.j0 = max(0, c.first - c.c0);
  c.n = min(span, c.ntok - c.c0);
  return true;
}

// Sub-chunk k (CH tokens) of a span: its tokens [c0 + j0, c0 + n) with c0
// advanced by k CH.
__device__ __forceinline__ Chunk sub_chunk(const Chunk& c, int k) {
  Chunk s = c;
  s.c0 = c.c0 + k * CH;
  s.j0 = max(0, c.j0 - k * CH);
  s.n = min(CH, c.n - k * CH);
  return s;
}

// Whether ring lane j holds a token the query at pos reads: the token
// pos - ((pos - j) mod 64) at or past flushed.
__device__ __forceinline__ bool ring_lane_valid(int pos, int j, int fl) {
  return pos - ((pos - j) % RING + RING) % RING >= fl;
}

// Whether the 16-row group at chunk row r lies in [j0, n).
__device__ __forceinline__ bool group_in(const Chunk& c, int r) {
  return r >= c.j0 && r < c.n;
}

// acc[h] (h < nrep <= N) reduced over the block, the max (MAX) or the sum:
// each warp through a xor butterfly, then the warps in order; out[h]
// (shared memory) takes the result. Ends synchronised. The kernels keep
// their heads in arrays of N = NREP_MAX or of the n_rep they are
// instantiated for: loops over N heads guarded by h < nrep still execute
// every instruction, so a kernel built for fewer heads runs fewer.
template <bool MAX, int N>
__device__ __forceinline__ void chunk_reduce(float (&acc)[N], int nrep,
                                             float* out) {
  __shared__ float red[FW][NREP_MAX];
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
#pragma unroll
  for (int h = 0; h < N; ++h) {
    acc[h] = MAX ? warp_max_xor(acc[h]) : warp_sum_xor(acc[h]);
    if (lane == 0) red[w][h] = acc[h];
  }
  __syncthreads();
  if (t < nrep) {
    float r = red[0][t];
    for (int i = 1; i < FW; ++i) r = MAX ? fmaxf(r, red[i][t]) : r + red[i][t];
    out[t] = r;
  }
  __syncthreads();
}

// Pass 1's end, for the thread's token (in: it lies in [j0, n); ok: it
// also lies in the window and at or below pos): its unscaled scores s[h]
// scaled (masked to -inf where not ok) and stored at srow[h * L]; the
// chunk's m_c and l_c of each head at st_m[stat + h], st_l[stat + h].
template <int N>
__device__ __forceinline__ void store_scores_and_stats(
    float (&s)[N], bool in, bool ok, float scaling, float* srow, int L,
    int nrep, float* st_m, float* st_l, size_t stat) {
  __shared__ float m_s[NREP_MAX];
  __shared__ float l_s[NREP_MAX];
  const int t = threadIdx.x;
  float acc[N];
#pragma unroll
  for (int h = 0; h < N; ++h) {
    s[h] = ok ? s[h] * scaling : -INFINITY;
    if (in && h < nrep) srow[(size_t)h * L] = s[h];
    acc[h] = s[h];
  }
  chunk_reduce<true>(acc, nrep, m_s);
#pragma unroll
  for (int h = 0; h < N; ++h)
    acc[h] = (h < nrep && s[h] != -INFINITY) ? expf(s[h] - m_s[h]) : 0.f;
  chunk_reduce<false>(acc, nrep, l_s);
  if (t < nrep) {
    st_m[stat + t] = m_s[t];
    st_l[stat + t] = l_s[t];
  }
}

// Pass 2's start: the final stats of the (slot, kv head) into m_s, d_s
// (shared memory; stats at st_m[bz + i * nrep + h] for chunk i, bz = bk *
// NZ * nrep), combined a warp per head, its lanes over the chunks [z0, z1)
// in the same order at every launch (m = max m_c, den = Σ l_c exp(m_c -
// m); a chunk of max -inf adds 0, a zero den becomes 1). Ends synchronised.
__device__ __forceinline__ void final_stats(const Chunk& c, const float* st_m,
                                            const float* st_l, size_t bz,
                                            int nrep, float* m_s, float* d_s) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int h = w; h < nrep; h += FW) {
    const float* sm = st_m + bz + h;
    const float* sl = st_l + bz + h;
    float m = -INFINITY;
    for (int i = c.z0 + lane; i < c.z1; i += 32)
      m = fmaxf(m, sm[(size_t)i * nrep]);
    m = warp_max_xor(m);
    float den = 0.f;
    for (int i = c.z0 + lane; i < c.z1; i += 32) {
      const float mi = sm[(size_t)i * nrep];
      if (mi != -INFINITY) den += sl[(size_t)i * nrep] * expf(mi - m);
    }
    den = warp_sum_xor(den);
    if (lane == 0) {
      m_s[h] = m;
      d_s[h] = den == 0.f ? 1.f : den;
    }
  }
  __syncthreads();
}

// The raw scores s[h] of the thread's token (-inf where not in) at
// srow[h * LS]: loaded ahead of the stats they are combined with.
template <int N>
__device__ __forceinline__ void load_scores(bool in, const float* srow,
                                            int LS, int nrep, float (&s)[N]) {
#pragma unroll
  for (int h = 0; h < N; ++h)
    s[h] = (in && h < nrep) ? srow[(size_t)h * LS] : -INFINITY;
}

// The p of each head from the thread's raw scores s (0 for -inf) with the
// final stats m_s, d_s; with p_mb >= 0 quantized per 16 tokens (16 lanes,
// xor shuffles: every thread calls it).
template <int N>
__device__ __forceinline__ void token_p(const float (&s)[N], const float* m_s,
                                        const float* d_s, int nrep, int p_mb,
                                        float (&p)[N]) {
#pragma unroll
  for (int h = 0; h < N; ++h) p[h] = 0.f;
#pragma unroll
  for (int h = 0; h < N; ++h) {
    if (h >= nrep) break;
    float x = s[h] == -INFINITY ? 0.f : expf(s[h] - m_s[h]) / d_s[h];
    if (p_mb >= 0) {  // the 16-token group: 16 lanes
      float gmax = x;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
      x = mx_value(x, group_exponent(gmax), p_mb);
    }
    p[h] = x;
  }
}

// The thread's scores of chunk c (in [j0, n)) at srow[h * L], then
// final_stats, then token_p.
template <int N>
__device__ __forceinline__ void chunk_p(const Chunk& c, const float* srow,
                                        int L, const float* st_m,
                                        const float* st_l, size_t bz,
                                        int nrep, int p_mb, float (&p)[N]) {
  __shared__ float m_s[NREP_MAX];
  __shared__ float d_s[NREP_MAX];
  const int t = threadIdx.x;
  float s[N];
  load_scores(t >= c.j0 && t < c.n, srow, L, nrep, s);
  final_stats(c, st_m, st_l, bz, nrep, m_s, d_s);
  token_p(s, m_s, d_s, nrep, p_mb, p);
}

// Pass 2's end. red (shared memory) holds the warps' partial P·V, (FW,
// nrep, D), written before a barrier: their sum in warp order is the
// chunk's partial, stored at part[(bk * NZ + zi) * nrep * D]; the last
// block of the (slot, kv head) to finish (the counter: pass 1 zeroes it)
// sums the partials of [z0, z1) in order into out (the (slot, kv head)'s
// nrep x D rows). The barrier, then one thread's fence and atomic, publish
// the block's partials (the grid barrier's pattern). N bounds nrep.
template <int D, int N = NREP_MAX>
__device__ __forceinline__ void finish_chunk(const float* red, float* part,
                                             int* count, float* out,
                                             const Chunk& c, size_t bk,
                                             int NZ, int nrep) {
  const int t = threadIdx.x;
  float* dst = part + (bk * NZ + c.zi) * nrep * D;
  for (int idx = t; idx < nrep * D; idx += FT) {
    float r = red[idx];
#pragma unroll
    for (int i = 1; i < FW; ++i) r += red[(size_t)i * nrep * D + idx];
    dst[idx] = r;
  }
  __shared__ bool last;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(count + bk, 1) == c.z1 - c.z0 - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  constexpr int PER = (N * D + FT - 1) / FT;  // outputs per thread
  const float* pb = part + bk * NZ * nrep * D + t;
  float r[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) r[u] = 0.f;
#pragma unroll 4
  for (int i = c.z0; i < c.z1; ++i)
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (t + u * FT < nrep * D)
        r[u] += __ldcg(pb + (size_t)i * nrep * D + u * FT);
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (t + u * FT < nrep * D) out[t + u * FT] = r[u];
}

// The scratch of one call, carved from one f32 buffer: the scores (B, H,
// LS), the chunk stats m and l (B, KVH, NZ, nrep) each, the partials (B,
// KVH, NZ, nrep, D), then one int32 counter per (slot, kv head).
struct Scratch {
  float *scores, *st_m, *st_l, *part;
  int* count;
};

__host__ __forceinline__ Scratch carve(void* scratch, int B, int KVH,
                                       int nrep, int D, int LS, int NZ) {
  Scratch s;
  s.scores = static_cast<float*>(scratch);
  s.st_m = s.scores + (size_t)B * KVH * nrep * LS;
  s.st_l = s.st_m + (size_t)B * KVH * NZ * nrep;
  s.part = s.st_l + (size_t)B * KVH * NZ * nrep;
  s.count = reinterpret_cast<int*>(s.part + (size_t)B * KVH * NZ * nrep * D);
  return s;
}

// The whole of the SM's 228 KB as shared memory for each kernel, up to
// smem bytes dynamic.
__host__ inline cudaError_t allow_smem(const void* const* fns, int n,
                                       size_t smem) {
  for (int i = 0; i < n; ++i) {
    cudaError_t e = cudaFuncSetAttribute(
        fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fns[i],
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace decode
