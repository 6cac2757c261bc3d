// Building blocks shared by the decode attention kernels (one query token
// per slot; one block of NT threads per (slot, kv head), its n_rep GQA query
// heads sharing each K/V value read):
//   - the queries quantized per 16 along d into shared memory;
//   - the MXINT8 or MXINT4 encode of a fresh K/V row into one cache column;
//   - scores of 4 consecutive tokens of a token-axis-last MXINT8 or MXINT4
//     cache (one char4 load per code row) and P·V along one d row (16 tokens
//     per 16-byte load);
//   - the block-wide max and sum of the n_rep rows, and the quantization
//     of p per 16 tokens;
//   - the causal and sliding-window mask, and the first column a kernel
//     reads under a window.
// The MXINT4 layout is d-split: packed row i holds value i in its low
// nibble and value i + d/2 in its high nibble, both sign-extended; a code of
// width w decodes as code * 2^(e - (w - 1)).
#pragma once

#include "mx_common.cuh"

namespace decode {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int NREP_MAX = 8;

struct Cache {
  const int8_t* kc;  // (rows, stride) codes of this (slot, kv head)
  const int8_t* ke;  // (d/16, stride) exponents
  const int8_t* vc;
  const int8_t* ve;
  int stride;        // L for a main cache, SW for a ring
};

// The mask of every decode kernel: the key at column j counts for the query
// at pos where j <= pos and, under a sliding window (window > 0; -1 for
// none), pos - window < j.
__device__ __forceinline__ bool in_window(int j, int pos, int window) {
  return j <= pos && (window < 0 || j > pos - window);
}

// The first column a kernel reads for the query at pos: the start of the
// 16-token group that holds the window's first key, 0 without a window.
// The groups below hold masked keys only (p = 0 there), so skipping them
// changes nothing; the masked keys inside this group keep p = 0 in its P
// quantizer group, as the TPU kernel's do.
__device__ __forceinline__ int window_start(int pos, int window) {
  return window < 0 ? 0 : max(0, pos - window + 1) / 16 * 16;
}

// The same cache from column off on (off % 16 == 0 keeps the vector loads
// aligned).
__device__ __forceinline__ Cache shifted(const Cache& c, int off) {
  return Cache{c.kc + off, c.ke + off, c.vc + off, c.ve + off, c.stride};
}

__device__ __forceinline__ int low_nibble(int byte) {
  return (int)((unsigned)byte << 28) >> 28;
}

__device__ __forceinline__ int high_nibble(int byte) {
  return (int)((unsigned)byte << 24) >> 28;
}

// qs[h * D + d] = q of query head h quantized per 16 along d (block_fp,
// mantissa bits q_mb; q_mb < 0 keeps q); q points at the block's n_rep rows.
template <int D>
__device__ __forceinline__ void quantize_queries(const float* q, float* qs,
                                                 int nrep, int q_mb) {
  constexpr int GD = D / 16;
  for (int idx = threadIdx.x; idx < nrep * GD; idx += NT) {
    const int h = idx / GD, g = idx % GD;
    const float* qrow = q + (size_t)h * D + g * 16;
    float vals[16];
    float bmax = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      vals[j] = qrow[j];
      bmax = fmaxf(bmax, fabsf(vals[j]));
    }
    const int e = group_exponent(bmax);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      qs[h * D + g * 16 + j] = q_mb >= 0 ? mx_value(vals[j], e, q_mb) : vals[j];
  }
}

// MXINT8 encode of the 16 values src[0..15] (cache_write._encode_t: exact
// exponent, an all-zero group takes exponent 0, codes clamp to ±127) into
// rows g*16 .. g*16+15 of column col of the codes and row g of the exps.
__device__ __forceinline__ void encode_group(const float* src, int8_t* codes,
                                             int8_t* exps, int stride,
                                             int col, int g) {
  float bmax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, fabsf(src[j]));
  const int e = group_exponent(bmax);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    codes[(size_t)(g * 16 + j) * stride + col] =
        (int8_t)(int)__fmul_rn(sign_eps(src[j]), mx_mant(src[j], e, 7));
  exps[(size_t)g * stride + col] = (int8_t)e;
}

// MXINT4 encode (cache_write._encode_t with mb = 3 and the d-split nibble
// pack) of the groups g and g + D/32 of the D values row[0..D-1] into
// column col: packed rows g*16 .. g*16+15 take value i in the low nibble
// and value i + D/2 in the high one, codes clamp to ±7, an all-zero group
// takes exponent 0; exps rows g and g + D/32.
template <int D>
__device__ __forceinline__ void encode_group_packed(const float* row,
                                                    int8_t* codes,
                                                    int8_t* exps, int stride,
                                                    int col, int g) {
  const float* lo = row + g * 16;
  const float* hi = row + D / 2 + g * 16;
  float bl = 0.f, bh = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    bl = fmaxf(bl, fabsf(lo[j]));
    bh = fmaxf(bh, fabsf(hi[j]));
  }
  const int el = group_exponent(bl), eh = group_exponent(bh);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int cl = (int)__fmul_rn(sign_eps(lo[j]), mx_mant(lo[j], el, 3));
    const int ch = (int)__fmul_rn(sign_eps(hi[j]), mx_mant(hi[j], eh, 3));
    codes[(size_t)(g * 16 + j) * stride + col] =
        (int8_t)(((ch & 0xF) << 4) | (cl & 0xF));
  }
  exps[(size_t)g * stride + col] = (int8_t)el;
  exps[(size_t)(g + D / 32) * stride + col] = (int8_t)eh;
}

// The fresh K and V rows kh, vh (D values each) of one (slot, kv head)
// encoded at code width CW (encode_group, or encode_group_packed at 4) into
// column col of its codes (D or D/2 rows) and exps (D/16 rows) of token
// stride `stride`, thread-strided over the block.
template <int D, int CW>
__device__ __forceinline__ void encode_kv_column(const float* kh,
                                                 const float* vh, int8_t* kc,
                                                 int8_t* ke, int8_t* vc,
                                                 int8_t* ve, int stride,
                                                 int col) {
  constexpr int NG = CW == 8 ? D / 16 : D / 32;  // encodes per row
  for (int idx = threadIdx.x; idx < 2 * NG; idx += NT) {
    const int g = idx % NG;
    const bool is_v = idx >= NG;
    if constexpr (CW == 8)
      encode_group((is_v ? vh : kh) + g * 16, is_v ? vc : kc, is_v ? ve : ke,
                   stride, col, g);
    else
      encode_group_packed<D>(is_v ? vh : kh, is_v ? vc : kc, is_v ? ve : ke,
                             stride, col, g);
  }
}

// Scores (unscaled) of the 4 consecutive columns col..col+3 (col % 4 == 0):
// each column sums q · k over d, k decoded from codes of width CW.
template <int D, int CW>
__device__ __forceinline__ void score_4_columns(const Cache& c, int col,
                                                const float* qs, int nrep,
                                                float (&s)[4][NREP_MAX]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h) s[u][h] = 0.f;
  if constexpr (CW == 8) {
    for (int g = 0; g < D / 16; ++g) {
      const char4 e4 = *reinterpret_cast<const char4*>(c.ke + (size_t)g * c.stride + col);
      const float scl[4] = {exp2_int(e4.x - 7), exp2_int(e4.y - 7),
                            exp2_int(e4.z - 7), exp2_int(e4.w - 7)};
#pragma unroll 4
      for (int jj = 0; jj < 16; ++jj) {
        const int d = g * 16 + jj;
        const char4 c4 = *reinterpret_cast<const char4*>(c.kc + (size_t)d * c.stride + col);
        const float kv[4] = {(float)c4.x * scl[0], (float)c4.y * scl[1],
                             (float)c4.z * scl[2], (float)c4.w * scl[3]};
#pragma unroll
        for (int h = 0; h < NREP_MAX; ++h)
          if (h < nrep) {
            const float qv = qs[h * D + d];
#pragma unroll
            for (int u = 0; u < 4; ++u) s[u][h] = fmaf(qv, kv[u], s[u][h]);
          }
      }
    }
  } else {
    constexpr int HG = D / 32;  // exponent groups per half of d
    for (int g = 0; g < HG; ++g) {
      const char4 el = *reinterpret_cast<const char4*>(c.ke + (size_t)g * c.stride + col);
      const char4 eh = *reinterpret_cast<const char4*>(c.ke + (size_t)(g + HG) * c.stride + col);
      const float sl[4] = {exp2_int(el.x - 3), exp2_int(el.y - 3),
                           exp2_int(el.z - 3), exp2_int(el.w - 3)};
      const float sh[4] = {exp2_int(eh.x - 3), exp2_int(eh.y - 3),
                           exp2_int(eh.z - 3), exp2_int(eh.w - 3)};
#pragma unroll 4
      for (int jj = 0; jj < 16; ++jj) {
        const int r = g * 16 + jj;  // values r and r + D/2
        const char4 c4 = *reinterpret_cast<const char4*>(c.kc + (size_t)r * c.stride + col);
        const int by[4] = {c4.x, c4.y, c4.z, c4.w};
        float kl[4], kh[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          kl[u] = (float)low_nibble(by[u]) * sl[u];
          kh[u] = (float)high_nibble(by[u]) * sh[u];
        }
#pragma unroll
        for (int h = 0; h < NREP_MAX; ++h)
          if (h < nrep) {
            const float ql = qs[h * D + r], qh = qs[h * D + r + D / 2];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              s[u][h] = fmaf(ql, kl[u], s[u][h]);
              s[u][h] = fmaf(qh, kh[u], s[u][h]);
            }
          }
      }
    }
  }
}

// acc[h] += Σ_j p[h * LS + j] · v[dd][j] over j in [0, ntok) (ntok % 16 ==
// 0), 16 tokens per 16-byte load of d row dd's codes and exponents.
template <int D, int CW>
__device__ __forceinline__ void pv_row(const Cache& c, int dd, int ntok,
                                       const float* p, int LS, int nrep,
                                       float (&acc)[NREP_MAX]) {
  const bool high = CW == 4 && dd >= D / 2;
  const int row = CW == 4 ? dd % (D / 2) : dd;
  const int8_t* crow = c.vc + (size_t)row * c.stride;
  const int8_t* erow = c.ve + (size_t)(dd / 16) * c.stride;
  for (int j0 = 0; j0 < ntok; j0 += 16) {
    const int4 cw = *reinterpret_cast<const int4*>(crow + j0);
    const int4 ew = *reinterpret_cast<const int4*>(erow + j0);
    const int cv[4] = {cw.x, cw.y, cw.z, cw.w};
    const int ev[4] = {ew.x, ew.y, ew.z, ew.w};
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int byte = cv[u >> 2] >> ((u & 3) * 8);
      const int code = CW == 8 ? (int)(int8_t)byte
                               : (high ? high_nibble(byte) : low_nibble(byte));
      const int e = (int)(int8_t)(ev[u >> 2] >> ((u & 3) * 8));
      const float vval = (float)code * exp2_int(e - (CW - 1));
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep) acc[h] = fmaf(p[h * LS + j0 + u], vval, acc[h]);
    }
  }
}

// Reduces acc[h] (h < nrep) over the block, the max (MAX) or the sum: each
// warp through a xor butterfly, then the warps in order; out[h] (shared
// memory) takes the result. Ends synchronised.
template <bool MAX>
__device__ __forceinline__ void block_reduce(float (&acc)[NREP_MAX], int nrep,
                                             float* out) {
  __shared__ float red[NW][NREP_MAX];
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) {
    acc[h] = MAX ? warp_max_xor(acc[h]) : warp_sum_xor(acc[h]);
    if (lane == 0) red[w][h] = acc[h];
  }
  __syncthreads();
  if (t < nrep) {
    float r = MAX ? -INFINITY : 0.f;
    for (int i = 0; i < NW; ++i) r = MAX ? fmaxf(r, red[i][t]) : r + red[i][t];
    out[t] = r;
  }
  __syncthreads();
}

// Over the 16-token groups of the nrep score rows sc[h * LS + j] in
// [0, n0) and [off1, off1 + n1) that hold p = exp(s - max): p divided by
// den[h] and, with p_mb >= 0, quantized per 16 (unsigned block_fp). Ends
// synchronised.
__device__ __forceinline__ void normalize_quantize_p(float* sc, int LS, int n0,
                                                     int off1, int n1,
                                                     int nrep, const float* den,
                                                     int p_mb) {
  const int g0 = n0 / 16, ngr = g0 + n1 / 16;
  for (int idx = threadIdx.x; idx < nrep * ngr; idx += NT) {
    const int h = idx / ngr, gi = idx % ngr;
    float* pg = sc + h * LS + (gi < g0 ? gi * 16 : off1 + (gi - g0) * 16);
    float bmax = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pg[j] = pg[j] / den[h];
      bmax = fmaxf(bmax, pg[j]);
    }
    if (p_mb >= 0) {
      const int e = group_exponent(bmax);
#pragma unroll
      for (int j = 0; j < 16; ++j) pg[j] = mx_value(pg[j], e, p_mb);
    }
  }
  __syncthreads();
}

}  // namespace decode
