// Decode attention over an MXINT cache (codes of width 8 or 4, token axis
// last), split over L: the kernels of rows 6 and 10
// (decode_attention_quantized.cu), 7 and 9 (decode_attention.cu) and 8
// (decode_attention_streaming.cu), one design in three modes:
//   READ   the direct-write cache as stored (rows 6 and 8);
//   WRITE  the same, the fresh K/V rows first MXINT8-encoded into column
//          pos in place (row 10, width 8);
//   STAGED the ring-staged cache: main columns [0, flushed), then the
//          64-lane ring as one more chunk, the last, whose block first
//          encodes the fresh rows at the cache's width into lane pos % 64
//          in place (rows 7 and 9).
// Per (slot, kv head) of one layer, at position pos:
//   1. q quantized per 16 along d (block_fp, width q_mb + 1);
//   2. scores over the columns the slot holds, the cache's MXINT values as
//      the operands (quantize once at write), times scaling; direct: masked
//      past pos and, under a sliding window (window > 0; -1 for none), at
//      or below pos - window; staged: main columns below flushed, ring
//      lanes whose token pos - ((pos - j) mod 64) is at least flushed;
//   3. one exact f32 softmax; p quantized per 16 tokens with the final max
//      and denominator (along [main L | ring 64] when staged: flushed is a
//      multiple of 32, so the ring's groups are its own);
//   4. out = Σ p · v.
//
// What bounds it on an H100: the cache stream, (code bytes + d/16 exponent
// bytes) x 2 per token and kv head over the columns the slot holds (from
// the group holding the window's first key; [0, flushed) and the ring when
// staged): 136 x 2 bytes at d = 128 and width 8, 72 x 2 at width 4. The
// TPU block read all L because VMEM residency made that free.
//
// Design: decode_split.cuh's scheme. A block of 256 threads per (slot, kv
// head, span of cpb chunks of 256 tokens) in two launches, each block
// reading its span once (K in the first, V in the second): every code row
// (d rows at width 8, d/2 at width 4 with the nibbles split along d) and
// exponent row (d/16) of a chunk's tokens copied to shared memory by
// 16-byte cp.async (16 tokens of one row per copy), rows padded by 16
// bytes; codes decode in registers as code * 2^(e - (w - 1)), exact in f32.
// With cpb > 1 (rows 8 and 9, long contexts) a block walks its chunks
// through two tiles, the next chunk's copy in flight while the current one
// is scored or multiplied, and the count of partials the last block sums
// falls by cpb. The kernels are built per n_rep bound (1, 4 or 8): a head loop
// guarded at run time still executes every instruction of its unrolled
// body.
//   1. A thread per token sums its n_rep scores over d (the byte of each
//      code row at its column: a warp reads 32 consecutive bytes of a row,
//      no bank conflict), in d order. The span's max is the block's max of
//      its threads' running maxima; l_c sums each thread's tokens in order
//      (the last chunk's from registers, the others read back from the
//      scores it stored). WRITE: the block whose span
//      holds pos first encodes the fresh column into the cache; STAGED: the
//      ring's block first encodes the fresh rows into the ring; a barrier
//      orders those stores before the block's cp.async reads. Only that
//      block touches the ring or the column in launch 1.
//   2. Launched as a programmatic dependent launch: its blocks copy their
//      first V chunk while launch 1 ends and wait for it (griddepcontrol)
//      before reading the scores and stats; what launch 1 wrote (row 10's
//      segment holding pos, the whole ring) is copied after the wait. P·V
//      with lanes along d: warp w takes the 16-token groups w and w + 8 of
//      a chunk, a lane owns code rows lane, lane + 32, ... and reads 16
//      tokens of a row per 16-byte load (the 16-byte padding puts 8
//      consecutive rows on distinct banks); at width 4 one byte feeds d
//      rows r and r + d/2. The p of each head and each exponent's scale
//      2^(e - (w - 1)) come from shared memory, written there by the thread
//      of their token (each exponent decoded once, not once per value). The
//      span's partial P·V stays in registers across its chunks.
#pragma once

#include "decode_split.cuh"

namespace decode {

enum Mode { READ = 0, WRITE = 1, STAGED = 2 };

// The chunk tile of one side (K or V): CR code rows, then GD exponent rows,
// TS bytes each (CH tokens plus 16 bytes of padding).
template <int D, int CW>
struct Tile {
  static constexpr int CR = CW == 8 ? D : D / 2;
  static constexpr int GD = D / 16;
  static constexpr int TS = CH + 16;
  static constexpr int BYTES = (CR + GD) * TS;
};

// The block's copy of the 16-token segments [s0, s1) from column c0, but
// the segment `skip`, of every code and exponent row of one (slot, kv head)
// (codes (CR, stride), exps (GD, stride)) into the tile: 16-byte cp.async,
// consecutive threads along a row; one commit group.
template <int D, int CW>
__device__ __forceinline__ void copy_segments(const int8_t* codes,
                                              const int8_t* exps, int stride,
                                              int8_t* tile, int c0, int s0,
                                              int s1, int skip = -1) {
  using T = Tile<D, CW>;
  const int ns = s1 - s0;
  for (int i = threadIdx.x; i < (T::CR + T::GD) * ns; i += FT) {
    const int r = i / ns, seg = s0 + i % ns, col = seg * 16;
    if (seg == skip) continue;
    const int8_t* src = r < T::CR ? codes + (size_t)r * stride
                                  : exps + (size_t)(r - T::CR) * stride;
    cp_async16(tile + r * T::TS + col, src + c0 + col);
  }
  cp_async_commit();
}

// The unscaled scores s[h] (h < nrep <= NR) of the token at tile column t:
// Σ_d q · k, k decoded from the tile's codes of width CW.
template <int D, int CW, int NR>
__device__ __forceinline__ void score_column(const int8_t* tile, int t,
                                             const float* qs, int nrep,
                                             float (&s)[NR]) {
  using T = Tile<D, CW>;
  const int8_t* col = tile + t;
  const int8_t* ecol = col + T::CR * T::TS;
  if constexpr (CW == 8) {
#pragma unroll 1
    for (int g = 0; g < T::GD; ++g) {
      const float scl = exp2_int(ecol[g * T::TS] - 7);
#pragma unroll
      for (int jj = 0; jj < 16; jj += 4) {
        const int d = g * 16 + jj;
        const float k4[4] = {(float)col[d * T::TS] * scl,
                             (float)col[(d + 1) * T::TS] * scl,
                             (float)col[(d + 2) * T::TS] * scl,
                             (float)col[(d + 3) * T::TS] * scl};
#pragma unroll
        for (int h = 0; h < NR; ++h)
          if (h < nrep) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + h * D + d);
            s[h] = fmaf(qv.x, k4[0], s[h]);
            s[h] = fmaf(qv.y, k4[1], s[h]);
            s[h] = fmaf(qv.z, k4[2], s[h]);
            s[h] = fmaf(qv.w, k4[3], s[h]);
          }
      }
    }
  } else {
    constexpr int HG = D / 32;  // exponent groups per half of d
#pragma unroll 1
    for (int g = 0; g < HG; ++g) {
      const float sl = exp2_int(ecol[g * T::TS] - 3);
      const float sh = exp2_int(ecol[(g + HG) * T::TS] - 3);
#pragma unroll 4
      for (int jj = 0; jj < 16; ++jj) {
        const int r = g * 16 + jj;  // values r and r + D/2
        const int by = col[r * T::TS];
        const float kl = (float)low_nibble(by) * sl;
        const float kh = (float)high_nibble(by) * sh;
#pragma unroll
        for (int h = 0; h < NR; ++h)
          if (h < nrep) {
            s[h] = fmaf(qs[h * D + r], kl, s[h]);
            s[h] = fmaf(qs[h * D + r + D / 2], kh, s[h]);
          }
      }
    }
  }
}

// acc[h][i][x] += Σ over the 16 tokens from chunk column j of p[h] · v of
// the lane's code rows r = lane + 32 i (d rows r and, at width 4, r + D/2),
// p of head h at ps[h * CH + j + u] and the scale 2^(e - (CW - 1)) of
// exponent row g at scl[g * CH + j + u] in shared memory.
template <int D, int CW, int NR>
__device__ __forceinline__ void pv_group(
    const int8_t* tile, const float* ps, const float* scl, int j, int nrep,
    float (&acc)[NR][(Tile<D, CW>::CR + 31) / 32][CW == 8 ? 1 : 2]) {
  using T = Tile<D, CW>;
  constexpr int RPL = (T::CR + 31) / 32;  // code rows per lane
  constexpr int NV = CW == 8 ? 1 : 2;     // d rows per code row
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = lane + 32 * i;
    if (r >= T::CR) break;
    const int4 cw = *reinterpret_cast<const int4*>(tile + r * T::TS + j);
    const int cv[4] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
    for (int u4 = 0; u4 < 4; ++u4) {
      float pv[NR][4], sv[NV][4];
#pragma unroll
      for (int h = 0; h < NR; ++h)
        if (h < nrep) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(ps + h * CH + j + 4 * u4);
          pv[h][0] = p4.x, pv[h][1] = p4.y, pv[h][2] = p4.z, pv[h][3] = p4.w;
        }
#pragma unroll
      for (int x = 0; x < NV; ++x) {
        const int er = r / 16 + x * (D / 32);  // exponent row
        const float4 s4 =
            *reinterpret_cast<const float4*>(scl + er * CH + j + 4 * u4);
        sv[x][0] = s4.x, sv[x][1] = s4.y, sv[x][2] = s4.z, sv[x][3] = s4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int byte = cv[u4] >> (u * 8);
#pragma unroll
        for (int x = 0; x < NV; ++x) {
          const int code = CW == 8 ? (int)(int8_t)byte
                           : (x ? high_nibble(byte) : low_nibble(byte));
          const float v = (float)code * sv[x][u];
#pragma unroll
          for (int h = 0; h < NR; ++h)
            if (h < nrep) acc[h][i][x] = fmaf(pv[h][u], v, acc[h][i][x]);
        }
      }
    }
  }
}

// The arguments of one call: q (B, H, D) f32; the layer's codes (B, KVH,
// CR, L) and exps (B, KVH, D/16, L) int8; STAGED: the rings (B, KVH, CR,
// 64) and (B, KVH, D/16, 64) and flushed (B); WRITE and STAGED: the fresh
// rows kh, vh (B, KVH, D) f32; positions (B) int32; out (B, H, D) f32;
// scratch: carve's, over NZ = grid_z blocks along z.
struct SplitArgs {
  const float* q;
  int8_t *kc, *ke, *vc, *ve;
  int8_t *ksc, *kse, *vsc, *vse;
  const float *kh, *vh;
  const int *pos, *fl;
  Scratch sc;
  float* out;
  int KVH, nrep, L, cpb;
  float scaling;
  int q_mb, p_mb, window;
};

// The cache one chunk reads, from its first column: main (stride L) or the
// ring (stride 64).
struct Side {
  const int8_t *codes, *exps;
  int stride, col0;
};

template <int D, int CW>
__device__ __forceinline__ Side side_of(const int8_t* mc, const int8_t* me,
                                        const int8_t* rc, const int8_t* re,
                                        const Chunk& c, size_t bk, int L) {
  using T = Tile<D, CW>;
  if (c.ring)
    return Side{rc + bk * T::CR * RING, re + bk * T::GD * RING, RING, 0};
  return Side{mc + bk * T::CR * L, me + bk * T::GD * L, L, c.c0};
}

// Sub-chunk k of chunk c into tile: the segments it holds but `skip`.
template <int D, int CW>
__device__ __forceinline__ void copy_sub(const Side& sd, const Chunk& c,
                                         int k, int8_t* tile, int skip = -1) {
  const Chunk s = sub_chunk(c, k);
  copy_segments<D, CW>(sd.codes, sd.exps, sd.stride, tile, sd.col0 + k * CH,
                       s.j0 / 16, s.n / 16, skip);
}

// Pass 1. Grid (B, KVH, NZ); nrep <= NR.
template <int D, int CW, int MODE, int NR>
__global__ void __launch_bounds__(FT) mx_scores_kernel(SplitArgs a) {
  using T = Tile<D, CW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, H = a.KVH * a.nrep, nrep = a.nrep, L = a.L;
  const int LS = MODE == STAGED ? L + RING : L;
  // launch 2 may start (programmatic dependent launch): its blocks copy
  // their first V chunk, then wait for this grid to end
  asm volatile("griddepcontrol.launch_dependents;");
  Chunk c;
  if (!chunk_of(a.pos, MODE == STAGED ? a.fl : nullptr, b, z, NZ, L,
                a.window, a.cpb * CH, c)) {
    if (MODE != STAGED && z == 0 && c.ntok == 0)  // no column: out = 0
      for (int idx = t; idx < nrep * D; idx += FT)
        a.out[((size_t)b * H + kv * nrep) * D + idx] = 0.f;
    return;
  }
  const size_t bk = (size_t)b * a.KVH + kv;
  if (c.zi == c.z0 && t == 0) a.sc.count[bk] = 0;
  const int nbuf = a.cpb > 1 ? 2 : 1;
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + nbuf * T::BYTES);  // nrep x D

  if constexpr (MODE == WRITE) {
    if (c.pos < L && c.pos >= c.c0 && c.pos < c.c0 + a.cpb * CH) {
      for (int idx = t; idx < 2 * T::GD; idx += FT) {  // block-uniform
        const int g = idx % T::GD;
        const bool is_v = idx >= T::GD;
        encode_group((is_v ? a.vh : a.kh) + bk * D + g * 16,
                     (is_v ? a.vc : a.kc) + bk * D * L,
                     (is_v ? a.ve : a.ke) + bk * T::GD * L, L, c.pos, g);
      }
      __syncthreads();  // the fresh column before the chunk's reads
    }
  }
  if constexpr (MODE == STAGED) {
    if (c.ring) {  // the fresh rows into lane pos % 64, in place
      encode_kv_column<D, CW>(a.kh + bk * D, a.vh + bk * D,
                              a.ksc + bk * T::CR * RING,
                              a.kse + bk * T::GD * RING,
                              a.vsc + bk * T::CR * RING,
                              a.vse + bk * T::GD * RING, RING, c.pos % RING);
      __syncthreads();  // the fresh lane before the ring's reads
    }
  }
  const Side sd = side_of<D, CW>(a.kc, a.ke, a.ksc, a.kse, c, bk, L);
  const int k0 = c.j0 / CH, k1 = (c.n + CH - 1) / CH;
  copy_sub<D, CW>(sd, c, k0, tiles);
  quantize_queries<D>(a.q + ((size_t)b * H + kv * nrep) * D, qs, nrep,
                      a.q_mb);
  float* srow = a.sc.scores + ((size_t)b * H + kv * nrep) * LS + t;
  float mx[NR], last[NR];  // running max; the last chunk's scores
#pragma unroll
  for (int h = 0; h < NR; ++h) mx[h] = -INFINITY;
  for (int k = k0; k < k1; ++k) {
    if (k + 1 < k1) {
      copy_sub<D, CW>(sd, c, k + 1, tiles + ((k + 1 - k0) & 1) * T::BYTES);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Chunk s = sub_chunk(c, k);
    const bool in = t >= s.j0 && t < s.n;
    float sc[NR];
#pragma unroll
    for (int h = 0; h < NR; ++h) sc[h] = 0.f;
    if (in)
      score_column<D, CW, NR>(tiles + ((k - k0) & 1) * T::BYTES, t, qs, nrep,
                              sc);
    bool ok = in;
    if constexpr (MODE == STAGED)
      ok = in && (!c.ring || ring_lane_valid(c.pos, t, c.ntok));
    else
      ok = in && in_window(s.c0 + t, c.pos, a.window);
#pragma unroll
    for (int h = 0; h < NR; ++h) {
      sc[h] = ok ? sc[h] * a.scaling : -INFINITY;
      if (in && h < nrep) srow[(size_t)h * LS + s.c0] = sc[h];
      mx[h] = fmaxf(mx[h], sc[h]);
      last[h] = sc[h];
    }
    if (k + 2 < k1) __syncthreads();  // the tile is read before its refill
  }
  // the span's m_c, then l_c = Σ exp(s - m_c) over the thread's tokens in
  // order (the last chunk's from registers, the others read back from the
  // scores it stored), each reduced over the block
  __shared__ float m_s[NREP_MAX];
  __shared__ float l_s[NREP_MAX];
  chunk_reduce<true>(mx, nrep, m_s);
  float l[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) l[h] = 0.f;
  for (int k = k0; k < k1; ++k) {
    const Chunk s = sub_chunk(c, k);
    if (t >= s.j0 && t < s.n)
#pragma unroll
      for (int h = 0; h < NR; ++h)
        if (h < nrep) {
          const float v = k + 1 == k1 ? last[h] : srow[(size_t)h * LS + s.c0];
          if (v != -INFINITY) l[h] += expf(v - m_s[h]);
        }
  }
  chunk_reduce<false>(l, nrep, l_s);
  if (t < nrep) {
    const size_t stat = (bk * NZ + c.zi) * nrep + t;
    a.sc.st_m[stat] = m_s[t];
    a.sc.st_l[stat] = l_s[t];
  }
}

// Pass 2's shared memory before the p of each head: the tiles, which then
// hold the warps' partials (FW x nrep x D f32).
template <int D, int CW>
__host__ __device__ __forceinline__ size_t pv_tile_bytes(int nrep, int nbuf) {
  const size_t red = sizeof(float) * FW * nrep * D;
  const size_t tiles = (size_t)nbuf * Tile<D, CW>::BYTES;
  return tiles > red ? tiles : red;
}

// Pass 2. Same grid as pass 1.
template <int D, int CW, int MODE, int NR>
__global__ void __launch_bounds__(FT) mx_pv_kernel(SplitArgs a) {
  using T = Tile<D, CW>;
  constexpr int RPL = (T::CR + 31) / 32;  // code rows per lane
  constexpr int NV = CW == 8 ? 1 : 2;     // d rows per code row
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const int H = a.KVH * a.nrep, nrep = a.nrep, L = a.L;
  const int LS = MODE == STAGED ? L + RING : L;
  Chunk c;
  if (!chunk_of(a.pos, MODE == STAGED ? a.fl : nullptr, b, z, NZ, L,
                a.window, a.cpb * CH, c))
    return;
  const size_t bk = (size_t)b * a.KVH + kv;
  const int nbuf = a.cpb > 1 ? 2 : 1;
  int8_t* tiles = reinterpret_cast<int8_t*>(smem);
  // the p of each head, nrep x CH, past the tiles and the warps' partials,
  // then the chunk's V scales 2^(e - (CW - 1)), GD x CH
  float* ps =
      reinterpret_cast<float*>(smem + pv_tile_bytes<D, CW>(nrep, nbuf));
  float* scl = ps + nrep * CH;
  __shared__ float m_s[NREP_MAX];
  __shared__ float d_s[NREP_MAX];

  const Side sd = side_of<D, CW>(a.vc, a.ve, a.vsc, a.vse, c, bk, L);
  const int k0 = c.j0 / CH, k1 = (c.n + CH - 1) / CH;
  // the first V chunk lands while launch 1 ends, but what launch 1 wrote:
  // row 10's segment holding pos (cpb = 1) and the staged ring, after
  // launch 1's end
  const int own = MODE == WRITE && c.pos < L && c.pos / CH == c.c0 / CH
                      ? (c.pos - c.c0) / 16 : -1;
  if (!c.ring) copy_sub<D, CW>(sd, c, k0, tiles, own);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (c.ring) copy_sub<D, CW>(sd, c, k0, tiles);
  if (own >= 0)
    copy_segments<D, CW>(sd.codes, sd.exps, L, tiles, c.c0, own, own + 1);
  // the first chunk's scores load while the stats combine; each later
  // chunk's while the chunk before it is multiplied
  const float* srow = a.sc.scores + ((size_t)b * H + kv * nrep) * LS + t;
  float sn[NR];
  {
    const Chunk s = sub_chunk(c, k0);
    load_scores(t >= s.j0 && t < s.n, srow + s.c0, LS, nrep, sn);
  }
  final_stats(c, a.sc.st_m, a.sc.st_l, bk * NZ * nrep, nrep, m_s, d_s);

  float acc[NR][RPL][NV];
#pragma unroll
  for (int h = 0; h < NR; ++h)
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int x = 0; x < NV; ++x) acc[h][i][x] = 0.f;
  for (int k = k0; k < k1; ++k) {
    const Chunk s = sub_chunk(c, k);
    float cur[NR], p[NR];
#pragma unroll
    for (int h = 0; h < NR; ++h) cur[h] = sn[h];
    if (k + 1 < k1) {
      const Chunk s1 = sub_chunk(c, k + 1);
      load_scores(t >= s1.j0 && t < s1.n, srow + s1.c0, LS, nrep, sn);
    }
    token_p(cur, m_s, d_s, nrep, a.p_mb, p);
#pragma unroll
    for (int h = 0; h < NR; ++h)
      if (h < nrep) ps[h * CH + t] = p[h];
    if (k + 1 < k1) {
      copy_sub<D, CW>(sd, c, k + 1, tiles + ((k + 1 - k0) & 1) * T::BYTES);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* tile = tiles + ((k - k0) & 1) * T::BYTES;
    // each exponent once to its scale, the thread's token in every row
#pragma unroll
    for (int g = 0; g < T::GD; ++g)
      scl[g * CH + t] = exp2_int(tile[(T::CR + g) * T::TS + t] - (CW - 1));
    __syncthreads();
    for (int j = w * 16; j < CH; j += FW * 16)
      if (group_in(s, j)) pv_group<D, CW, NR>(tile, ps, scl, j, nrep, acc);
    __syncthreads();  // the tile and p are read before they are refilled
  }
  float* red = reinterpret_cast<float*>(smem);  // FW x nrep x D
#pragma unroll
  for (int h = 0; h < NR; ++h)
    if (h < nrep)
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const int r = lane + 32 * i;
        if (r < T::CR)
#pragma unroll
          for (int x = 0; x < NV; ++x)
            red[((size_t)w * nrep + h) * D + r + x * (D / 2)] = acc[h][i][x];
      }
  __syncthreads();
  finish_chunk<D, NR>(red, a.sc.part, a.sc.count,
                      a.out + ((size_t)b * H + kv * nrep) * D, c, bk, NZ,
                      nrep);
}

// Blocks along z: spans of cpb chunks over L, and the ring's when staged.
__host__ __forceinline__ int grid_z(int L, int cpb, bool staged) {
  const int nch = (L + CH - 1) / CH;
  return (nch + cpb - 1) / cpb + (staged ? 1 : 0);
}

template <int D, int CW, int MODE, int NR>
int launch_split(SplitArgs a, int B, void* scratch, cudaStream_t st) {
  using T = Tile<D, CW>;
  if (a.nrep < 1 || a.nrep > NR || a.L % 16 != 0 || a.cpb < 1 ||
      a.window == 0 || a.window < -1 || (MODE == WRITE && a.cpb != 1) ||
      (MODE == STAGED && a.window != -1))
    return (int)cudaErrorInvalidValue;
  const int NZ = grid_z(a.L, a.cpb, MODE == STAGED);
  a.sc = carve(scratch, B, a.KVH, a.nrep, D,
               MODE == STAGED ? a.L + RING : a.L, NZ);
  const int nbuf = a.cpb > 1 ? 2 : 1;
  const size_t smem1 = nbuf * T::BYTES + sizeof(float) * a.nrep * D;
  const size_t smem2 = pv_tile_bytes<D, CW>(a.nrep, nbuf) +
                       sizeof(float) * (a.nrep + T::GD) * CH;
  const void* fns[] = {(const void*)mx_scores_kernel<D, CW, MODE, NR>,
                       (const void*)mx_pv_kernel<D, CW, MODE, NR>};
  cudaError_t err = allow_smem(fns, 2, smem1 > smem2 ? smem1 : smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, a.KVH, NZ);
  mx_scores_kernel<D, CW, MODE, NR><<<grid, FT, smem1, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // launch 2 as a programmatic dependent launch (griddepcontrol above)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FT);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, mx_pv_kernel<D, CW, MODE, NR>, a);
}

// The kernels of one mode at the call's head dim, code width and n_rep
// bound (1, 4 or 8); WRITE takes width 8 only, width 4 needs D % 32 == 0.
template <int MODE, int D>
int dispatch_width(const SplitArgs& a, int B, int code_width, void* scratch,
                   cudaStream_t st) {
  if (code_width == 8) {
    if (a.nrep == 1) return launch_split<D, 8, MODE, 1>(a, B, scratch, st);
    if (a.nrep <= 4) return launch_split<D, 8, MODE, 4>(a, B, scratch, st);
    return launch_split<D, 8, MODE, NREP_MAX>(a, B, scratch, st);
  }
  if constexpr (D % 32 == 0 && MODE != WRITE)
    if (code_width == 4) {
      if (a.nrep == 1) return launch_split<D, 4, MODE, 1>(a, B, scratch, st);
      if (a.nrep <= 4) return launch_split<D, 4, MODE, 4>(a, B, scratch, st);
      return launch_split<D, 4, MODE, NREP_MAX>(a, B, scratch, st);
    }
  return (int)cudaErrorInvalidValue;
}

// D is a multiple of 16 from 64 to 128 (instantiated at 64, 80, 96, 128).
template <int MODE>
int split_attend(const SplitArgs& a, int B, int D, int code_width,
                 void* scratch, cudaStream_t st) {
  switch (D) {
    case 64: return dispatch_width<MODE, 64>(a, B, code_width, scratch, st);
    case 80: return dispatch_width<MODE, 80>(a, B, code_width, scratch, st);
    case 96: return dispatch_width<MODE, 96>(a, B, code_width, scratch, st);
    case 128: return dispatch_width<MODE, 128>(a, B, code_width, scratch, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
