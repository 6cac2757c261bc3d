// The split-over-L scheme of the one-pass decode attention kernels (rows 5,
// 6 and 10: decode_attention_fp.cu, decode_attention_quantized.cu): a block
// per (slot, kv head, chunk of CH tokens), its n_rep query heads sharing
// each K/V value it reads, in two launches with nothing in shared memory
// that grows with L:
//   1. the chunk's scores (masked past pos and below the window) into a
//      global f32 scratch (B x H x L), and per head the chunk's max m_c and
//      l_c = Σ exp(s - m_c) (store_scores_and_stats);
//   2. the final stats of the (slot, kv head) combined in chunk order, a
//      thread per token forming its p = exp(s - m) / den quantized per 16
//      tokens with them (chunk_p); the chunk's partial P·V, the warps'
//      partials summed in order, and the last block of the (slot, kv head)
//      summing the partials in chunk order (finish_chunk).
// No float atomics: a run repeats itself to the bit. Blocks whose chunk
// lies wholly outside [the window's first group, the group holding pos]
// exit at once (chunk_of).
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

// The chunk of block z for the query at pos: tokens [c0 + j0, c0 + n) of
// the slot's context (j0 and n multiples of 16). False where the chunk lies
// wholly past the group holding pos or wholly below the window's first
// group.
struct Chunk {
  int pos, ntok, first, c0, j0, n;
};

__device__ __forceinline__ bool chunk_of(const int* pos_p, int b, int z,
                                         int L, int window, Chunk& c) {
  c.pos = pos_p[b];
  c.ntok = max(0, min((c.pos + 16) / 16 * 16, L));
  c.first = min(window_start(c.pos, window), c.ntok);
  c.c0 = z * CH;
  if (c.c0 >= c.ntok || c.c0 + CH <= c.first) return false;
  c.j0 = max(0, c.first - c.c0);
  c.n = min(CH, c.ntok - c.c0);
  return true;
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

// Pass 2's start: the p of the thread's token (0 outside [j0, n)) for each
// head from its score at srow[h * L], with the final stats of the (slot,
// kv head) (stats at st_m[bz + i * nrep + h] for chunk i, bz = bk * NZ *
// nrep), combined a warp per head, its lanes over the chunks in the same
// order at every launch (m = max m_c, den = Σ l_c exp(m_c - m); a chunk of
// max -inf adds 0, a zero den becomes 1); with p_mb >= 0 quantized per 16
// tokens (16 lanes, xor shuffles).
template <int N>
__device__ __forceinline__ void chunk_p(const Chunk& c, const float* srow,
                                        int L, const float* st_m,
                                        const float* st_l, size_t bz,
                                        int nrep, int p_mb, float (&p)[N]) {
  __shared__ float m_s[NREP_MAX];
  __shared__ float d_s[NREP_MAX];
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const bool in = t >= c.j0 && t < c.n;
#pragma unroll
  for (int h = 0; h < N; ++h)
    p[h] = (in && h < nrep) ? srow[(size_t)h * L] : -INFINITY;
  const int z0 = c.first / CH, z1 = (c.ntok + CH - 1) / CH;
  for (int h = w; h < nrep; h += FW) {
    const float* sm = st_m + bz + h;
    const float* sl = st_l + bz + h;
    float m = -INFINITY;
    for (int i = z0 + lane; i < z1; i += 32) m = fmaxf(m, sm[(size_t)i * nrep]);
    m = warp_max_xor(m);
    float den = 0.f;
    for (int i = z0 + lane; i < z1; i += 32) {
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
#pragma unroll
  for (int h = 0; h < N; ++h) {
    if (h >= nrep) break;
    float x = p[h] == -INFINITY ? 0.f : expf(p[h] - m_s[h]) / d_s[h];
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

// Pass 2's end. red (shared memory) holds the warps' partial P·V, (FW,
// nrep, D), written before a barrier: their sum in warp order is the
// chunk's partial, stored at part[(bk * NZ + z) * nrep * D]; the last block
// of the (slot, kv head) to finish (the counter: pass 1 zeroes it) sums the
// partials in chunk order into out (the (slot, kv head)'s nrep x D rows).
// The barrier, then one thread's fence and atomic, publish the block's
// partials (the grid barrier's pattern). N bounds nrep.
template <int D, int N = NREP_MAX>
__device__ __forceinline__ void finish_chunk(const float* red, float* part,
                                             int* count, float* out,
                                             const Chunk& c, size_t bk,
                                             int z, int NZ, int nrep) {
  const int t = threadIdx.x;
  float* dst = part + (bk * NZ + z) * nrep * D;
  for (int idx = t; idx < nrep * D; idx += FT) {
    float r = red[idx];
#pragma unroll
    for (int i = 1; i < FW; ++i) r += red[(size_t)i * nrep * D + idx];
    dst[idx] = r;
  }
  const int z0 = c.first / CH, z1 = (c.ntok + CH - 1) / CH;
  __shared__ bool last;
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(count + bk, 1) == z1 - z0 - 1;
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
  for (int i = z0; i < z1; ++i)
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (t + u * FT < nrep * D)
        r[u] += __ldcg(pb + (size_t)i * nrep * D + u * FT);
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (t + u * FT < nrep * D) out[t + u * FT] = r[u];
}

// The scratch of one call, carved from one f32 buffer: the scores (B, H,
// L), the chunk stats m and l (B, KVH, NZ, nrep) each, the partials (B,
// KVH, NZ, nrep, D), then one int32 counter per (slot, kv head).
struct Scratch {
  float *scores, *st_m, *st_l, *part;
  int* count;
};

__host__ __forceinline__ Scratch carve(void* scratch, int B, int KVH,
                                       int nrep, int D, int L, int NZ) {
  Scratch s;
  s.scores = static_cast<float*>(scratch);
  s.st_m = s.scores + (size_t)B * KVH * nrep * L;
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
