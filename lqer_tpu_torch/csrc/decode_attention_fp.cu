// Decode attention over the bf16 (fp) KV cache, one query token per slot,
// with every operand quantized in the kernel.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel (entry
// decode_attention). Per (slot, kv head) of one layer, at position pos:
//   1. q quantized per 16 along d (block_fp, mantissa bits q_mb);
//   2. K^T quantized at use time in groups of 16 TOKENS of each d column
//      (k_mb), so a group's exponent depends on all 16 cached rows: the
//      kernel quantizes whole groups, the one holding pos included, reading
//      its rows past pos as they are;
//   3. scores q · K^T times scaling (scale after the dot), columns past pos
//      masked, and under a sliding window (window > 0; -1 for none) the
//      columns at or below pos - window too; one exact f32 softmax; p
//      quantized per 16 tokens (p_mb) with the final max and denominator;
//   4. V quantized per token in 16-wide d groups (v_mb); out = Σ p · v.
// A negative mantissa width leaves that operand unquantized.
//
// What bounds it on an H100: the bf16 cache stream, 2 x 2 x d bytes per
// token and kv head (K and V) over the tokens read: the 16-token groups from
// the one holding the window's first key (decode_common.cuh's window_start;
// column 0 without a window) to the one holding pos (at 8 slots x 32 kv
// heads x about 1000 tokens, 0.038 ms at 3.35 TB/s). The K and V quantizers
// take about ten instructions a value, so the stream and the quantizers
// must overlap, and the context must spread over every SM.
//
// Design: the context splits into chunks of CH = 256 tokens, a block per
// (slot, kv head, chunk), its n_rep query heads sharing each K/V value it
// reads; blocks whose chunk lies wholly outside [window start, the group
// holding pos] exit at once. Each warp owns 32 tokens of the chunk: it
// copies their rows into shared memory with 16-byte cp.async as two commit
// groups of 16 tokens (one quantizer group each) and quantizes the first
// group while the second is in flight, with no barrier between warps (rows
// padded by 16 bytes, so 8 consecutive rows fall on distinct banks). Two
// launches (the scheme of decode_attention_streaming.cu, its third pass
// folded into the second; decode_split.cuh, shared with rows 6 and 10),
// with nothing in shared memory that grows with L:
//   1. K: a lane per pair of d columns holds a group's 16 rows in
//      registers, so the group max is a loop over registers; then a thread
//      per token takes its n_rep scores (16-byte loads of its row), writes
//      them to a global f32 scratch (B x H x L: 4 bytes per token and query
//      head against K's 2d, so it stays in L2), and the block writes the
//      chunk's max m_c and l_c = Σ exp(s - m_c) per head;
//   2. V: while its rows land, a warp per head combines the chunk stats of
//      its (slot, kv head), lanes over the chunks (m = max m_c, den = Σ l_c
//      exp(m_c - m); a chunk of max -inf adds 0, a zero den becomes 1);
//      a thread per token forms its p = exp(s - m) / den, quantized per 16
//      tokens (16 lanes, xor shuffles); V is quantized per token and 16-wide
//      d group as it lands; then each warp accumulates the partial P·V of
//      its tokens, lanes along d and each token's p shuffled from its lane,
//      and the eight warps' partials are summed in shared memory in order;
//      the last block of a (slot, kv head) to finish (an atomic counter,
//      zeroed in pass 1) sums its partials in chunk order.
// No float atomics: a run repeats itself to the bit. K and V are staged in
// bf16: the raw cache values, and values quantized with at most 8 mantissa
// bits (width <= 9), are exact in bf16.
#include "decode_split.cuh"

namespace {

using namespace decode;

// The warp's copy of the 16 rows from chunk row r (a group in range) of
// the (L, D) bf16 rows src into the padded tile (row stride D + 8): 16-byte
// cp.async, lane-strided.
template <int D>
__device__ __forceinline__ void copy_group(const uint16_t* src,
                                           uint16_t* tile, int r) {
  constexpr int P = D / 8;
  for (int i = threadIdx.x % 32; i < 16 * P; i += 32) {
    const int row = r + i / P, col = i % P * 8;
    cp_async16(tile + row * (D + 8) + col, src + (size_t)row * D + col);
  }
}

// Each warp's two groups, rows 32w.. and 32w + 16.., as two commit groups
// (empty where the group is out of range).
template <int D>
__device__ __forceinline__ void copy_warp_rows(const uint16_t* src,
                                               uint16_t* tile,
                                               const Chunk& c) {
  const int r = threadIdx.x / 32 * 32;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (group_in(c, r + 16 * g)) copy_group<D>(src, tile, r + 16 * g);
    cp_async_commit();
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  // exact: both values are bf16 values
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

// max(m, |x|) of two bf16 pairs, lane by lane (exact)
__device__ __forceinline__ uint32_t bf16_pair_absmax(uint32_t m, uint32_t x) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&m),
                             __habs2(*reinterpret_cast<__nv_bfloat162*>(&x)));
  return *reinterpret_cast<uint32_t*>(&r);
}

// K^T quantizer of the 16-row group at row r: a lane per pair of d columns
// holds the group's 16 words in registers.
template <int D>
__device__ __forceinline__ void quantize_k(uint16_t* tile, int r, int k_mb) {
  constexpr int RW = (D + 8) / 2;  // words per padded row
  uint32_t* words = reinterpret_cast<uint32_t*>(tile) + r * RW;
  for (int wd = threadIdx.x % 32; wd < D / 2; wd += 32) {
    uint32_t* col = words + wd;
    uint32_t x[16];
    uint32_t m2 = 0;  // the two columns' |max|, as bf16 pairs
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x[j] = col[j * RW];
      m2 = bf16_pair_absmax(m2, x[j]);
    }
    const int el = group_exponent(bf16_lo(m2));
    const int eh = group_exponent(bf16_hi(m2));
    const MxGroup gl = mx_group(el, k_mb), gh = mx_group(eh, k_mb);
    if (max(el, eh) <= MX_GROUP_EMAX) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        col[j * RW] = bf16_pair(mx_group_value(bf16_lo(x[j]), gl),
                                mx_group_value(bf16_hi(x[j]), gh));
    } else {
      for (int j = 0; j < 16; ++j)
        col[j * RW] = bf16_pair(mx_value(bf16_lo(x[j]), el, k_mb),
                                mx_value(bf16_hi(x[j]), eh, k_mb));
    }
  }
}

// V quantizer of the 16 rows from row r: a lane per (token, 16-wide d
// group).
template <int D>
__device__ __forceinline__ void quantize_v(uint16_t* tile, int r, int v_mb) {
  constexpr int G = D / 16;
  for (int i = threadIdx.x % 32; i < 16 * G; i += 32) {
    uint4* grp = reinterpret_cast<uint4*>(tile + (r + i / G) * (D + 8) +
                                          i % G * 16);
    uint4 w[2] = {grp[0], grp[1]};
    uint32_t* x = reinterpret_cast<uint32_t*>(w);
    uint32_t m2 = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) m2 = bf16_pair_absmax(m2, x[j]);
    const int e = group_exponent(fmaxf(bf16_lo(m2), bf16_hi(m2)));
    const MxGroup g = mx_group(e, v_mb);
    if (e <= MX_GROUP_EMAX) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = bf16_pair(mx_group_value(bf16_lo(x[j]), g),
                         mx_group_value(bf16_hi(x[j]), g));
    } else {
      for (int j = 0; j < 8; ++j)
        x[j] = bf16_pair(mx_value(bf16_lo(x[j]), e, v_mb),
                         mx_value(bf16_hi(x[j]), e, v_mb));
    }
    grp[0] = w[0];
    grp[1] = w[1];
  }
}

// Waits for the warp's two groups in turn and quantizes each as it lands
// (K: per d column, V: per token; mb < 0 leaves them as they are).
template <int D, bool IS_K>
__device__ __forceinline__ void land_and_quantize(uint16_t* tile,
                                                  const Chunk& c, int mb) {
  const int r = threadIdx.x / 32 * 32;
  cp_async_wait<1>();
  __syncwarp();
  if (mb >= 0 && group_in(c, r)) {
    if (IS_K) quantize_k<D>(tile, r, mb);
    else quantize_v<D>(tile, r, mb);
  }
  cp_async_wait<0>();
  __syncwarp();
  if (mb >= 0 && group_in(c, r + 16)) {
    if (IS_K) quantize_k<D>(tile, r + 16, mb);
    else quantize_v<D>(tile, r + 16, mb);
  }
  __syncwarp();
}

// Pass 1. Grid (B, KVH, NZ), NZ = ceil(L / CH).
template <int D>
__global__ void __launch_bounds__(FT)
fp_scores_kernel(const float* __restrict__ q, const uint16_t* __restrict__ k,
                 const int* __restrict__ pos_p, float* __restrict__ scores,
                 float* __restrict__ st_m, float* __restrict__ st_l,
                 int* __restrict__ count, float* __restrict__ out, int KVH,
                 int nrep, int L, float scaling, int q_mb, int k_mb,
                 int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, H = KVH * nrep;
  Chunk c;
  if (!chunk_of(pos_p, nullptr, b, z, NZ, L, window, CH, c)) {
    if (z == 0 && c.ntok == 0)  // no column (pos < 0): out = 0
      for (int idx = t; idx < nrep * D; idx += FT)
        out[((size_t)b * H + kv * nrep) * D + idx] = 0.f;
    return;
  }
  if (z == c.z0 && t == 0) count[(size_t)b * KVH + kv] = 0;

  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);           // CH x (D+8)
  float* qs = reinterpret_cast<float*>(tile + CH * (D + 8));   // nrep x D
  const size_t bk = (size_t)b * KVH + kv;

  copy_warp_rows<D>(k + (bk * L + c.c0) * D, tile, c);
  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  __syncthreads();  // the queries are in
  land_and_quantize<D, true>(tile, c, k_mb);

  const bool in = t >= c.j0 && t < c.n;
  float s[NREP_MAX];
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) s[h] = 0.f;
  if (in) {
    const uint16_t* row = tile + t * (D + 8);
#pragma unroll 4
    for (int d8 = 0; d8 < D / 8; ++d8) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + d8 * 8);
      const float kv8[8] = {bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y),
                            bf16_hi(w.y), bf16_lo(w.z), bf16_hi(w.z),
                            bf16_lo(w.w), bf16_hi(w.w)};
#pragma unroll
      for (int h = 0; h < NREP_MAX; ++h)
        if (h < nrep) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + h * D + d8 * 8);
          const float4 qb = *reinterpret_cast<const float4*>(qs + h * D + d8 * 8 + 4);
          s[h] = fmaf(qa.x, kv8[0], s[h]);
          s[h] = fmaf(qa.y, kv8[1], s[h]);
          s[h] = fmaf(qa.z, kv8[2], s[h]);
          s[h] = fmaf(qa.w, kv8[3], s[h]);
          s[h] = fmaf(qb.x, kv8[4], s[h]);
          s[h] = fmaf(qb.y, kv8[5], s[h]);
          s[h] = fmaf(qb.z, kv8[6], s[h]);
          s[h] = fmaf(qb.w, kv8[7], s[h]);
        }
    }
  }
  const bool ok = in && in_window(c.c0 + t, c.pos, window);
  store_scores_and_stats(
      s, in, ok, scaling, scores + ((size_t)b * H + kv * nrep) * L + c.c0 + t,
      L, nrep, st_m, st_l, (bk * NZ + z) * nrep);
}

// Pass 2. Same grid as pass 1.
template <int D>
__global__ void __launch_bounds__(FT)
fp_pv_kernel(const uint16_t* __restrict__ v, const int* __restrict__ pos_p,
             const float* __restrict__ scores,
             const float* __restrict__ st_m, const float* __restrict__ st_l,
             float* part, int* __restrict__ count, float* __restrict__ out,
             int KVH, int nrep, int L, int p_mb, int v_mb, int window) {
  constexpr int NWD = (D / 2 + 31) / 32;  // words of a row per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, lane = t % 32, w = t / 32, H = KVH * nrep;
  Chunk c;
  if (!chunk_of(pos_p, nullptr, b, z, NZ, L, window, CH, c)) return;
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);  // CH x (D + 8)
  const size_t bk = (size_t)b * KVH + kv;

  copy_warp_rows<D>(v + (bk * L + c.c0) * D, tile, c);
  float p[NREP_MAX];
  chunk_p(c, scores + ((size_t)b * H + kv * nrep) * L + c.c0 + t, L, st_m,
          st_l, bk * NZ * nrep, nrep, p_mb, p);
  land_and_quantize<D, false>(tile, c, v_mb);

  // partial P·V over the warp's tokens, lanes along d (a word of two
  // columns each), each token's p from its lane
  float acc[NREP_MAX][NWD][2];
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h)
#pragma unroll
    for (int i = 0; i < NWD; ++i) acc[h][i][0] = acc[h][i][1] = 0.f;
  const int lo = max(w * 32, c.j0), hi = min(w * 32 + 32, c.n);
  for (int tok = lo; tok < hi; ++tok) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(tile + tok * (D + 8));
    float pv[NREP_MAX];
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      pv[h] = h < nrep ? __shfl_sync(0xffffffffu, p[h], tok % 32) : 0.f;
#pragma unroll
    for (int i = 0; i < NWD; ++i) {
      const int wd = lane + 32 * i;
      if (wd < D / 2) {
        const uint32_t x = row[wd];
        const float a = bf16_lo(x), bb = bf16_hi(x);
#pragma unroll
        for (int h = 0; h < NREP_MAX; ++h)
          if (h < nrep) {
            acc[h][i][0] = fmaf(pv[h], a, acc[h][i][0]);
            acc[h][i][1] = fmaf(pv[h], bb, acc[h][i][1]);
          }
      }
    }
  }
  __syncthreads();  // the tile is read: it now holds the warps' partials
  float* red = reinterpret_cast<float*>(smem);  // FW x nrep x D
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h)
    if (h < nrep)
#pragma unroll
      for (int i = 0; i < NWD; ++i) {
        const int wd = lane + 32 * i;
        if (wd < D / 2)
          *reinterpret_cast<float2*>(red + ((size_t)w * nrep + h) * D + 2 * wd) =
              make_float2(acc[h][i][0], acc[h][i][1]);
      }
  __syncthreads();
  finish_chunk<D>(red, part, count, out + ((size_t)b * H + kv * nrep) * D, c,
                  bk, NZ, nrep);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* scratch, void* out, int B, int KVH, int nrep, int L,
           float scaling, int q_mb, int k_mb, int p_mb, int v_mb, int window,
           cudaStream_t st) {
  if (nrep < 1 || nrep > NREP_MAX || L % 16 != 0 || window == 0 ||
      window < -1 || k_mb > 8 || v_mb > 8)
    return (int)cudaErrorInvalidValue;
  const int NZ = (L + CH - 1) / CH;
  const Scratch sc = carve(scratch, B, KVH, nrep, D, L, NZ);
  const auto* pp = static_cast<const int*>(pos);
  auto* o = static_cast<float*>(out);
  const dim3 grid(B, KVH, NZ);
  const size_t tile = sizeof(uint16_t) * CH * (D + 8);
  const size_t smem1 = tile + sizeof(float) * nrep * D;
  // three blocks an SM
  const void* fns[] = {(const void*)fp_scores_kernel<D>,
                       (const void*)fp_pv_kernel<D>};
  cudaError_t err = allow_smem(fns, 2, smem1);
  if (err != cudaSuccess) return (int)err;
  fp_scores_kernel<D><<<grid, FT, smem1, st>>>(
      static_cast<const float*>(q), static_cast<const uint16_t*>(k), pp,
      sc.scores, sc.st_m, sc.st_l, sc.count, o, KVH, nrep, L, scaling, q_mb,
      k_mb, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fp_pv_kernel<D><<<grid, FT, tile, st>>>(
      static_cast<const uint16_t*>(v), pp, sc.scores, sc.st_m, sc.st_l,
      sc.part, sc.count, o, KVH, nrep, L, p_mb, v_mb, window);
  return (int)cudaGetLastError();
}

}  // namespace

// One layer: q (B, H, D) f32; k, v (B, KVH, L, D) bf16, the layer's slice
// of the layer-stacked cache; positions (B) int32; out (B, H, D) f32;
// window the sliding window in tokens, -1 for none. scratch: f32, the
// scores (B, H, L), then the chunk stats m and l (B, KVH, NZ, nrep) each
// and the partials (B, KVH, NZ, nrep, D), NZ = ceil(L / 256), then one
// int32 counter per (slot, kv head). D is a
// multiple of 16 from 64 to 128 (instantiated at 64, 80, 96 and 128);
// k_mb and v_mb at most 8.
LQER_API int lqer_decode_attention_fp(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* scratch, void* out, int B,
                                      int KVH, int nrep, int D, int L,
                                      float scaling, int q_mb, int k_mb,
                                      int p_mb, int v_mb, int window,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LQER_FP_ARGS                                                       \
  q, k, v, pos, scratch, out, B, KVH, nrep, L, scaling, q_mb, k_mb, p_mb, \
      v_mb, window, st
  switch (D) {
    case 64: return launch<64>(LQER_FP_ARGS);
    case 80: return launch<80>(LQER_FP_ARGS);
    case 96: return launch<96>(LQER_FP_ARGS);
    case 128: return launch<128>(LQER_FP_ARGS);
  }
#undef LQER_FP_ARGS
  return (int)cudaErrorInvalidValue;
}
