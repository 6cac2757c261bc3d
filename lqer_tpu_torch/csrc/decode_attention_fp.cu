// Decode attention over the bf16 or f32 (fp) KV cache, one query token per
// slot, with every operand quantized in the kernel.
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
// the cache's own type T (uint16_t for bf16 bits, or float), rows padded by
// 16 bytes: the bf16 cache's raw values, and its values quantized with at
// most 8 mantissa bits (width <= 9), are exact in bf16. The f32 cache (entry
// lqer_decode_attention_fp32) stages f32 rows, twice the bytes, so one block
// fits an SM: a value at |v| <= 1e-8 passes the quantizer unrounded, and
// raw f32 values are not bf16 values.
#include "decode_split.cuh"

namespace {

using namespace decode;

// Values of T in a 16-byte piece, and the tile's row stride in values (a
// row of D values padded by 16 bytes, so 8 consecutive rows fall on
// distinct banks).
template <typename T>
constexpr int PIECE = 16 / (int)sizeof(T);
template <int D, typename T>
constexpr int RS = D + PIECE<T>;

// The warp's copy of the 16 rows from chunk row r (a group in range) of
// the (L, D) rows src into the padded tile: 16-byte cp.async,
// lane-strided.
template <int D, typename T>
__device__ __forceinline__ void copy_group(const T* src, T* tile, int r) {
  constexpr int V = PIECE<T>, P = D / V;
  for (int i = threadIdx.x % 32; i < 16 * P; i += 32) {
    const int row = r + i / P, col = i % P * V;
    cp_async16(tile + row * RS<D, T> + col, src + (size_t)row * D + col);
  }
}

// Each warp's two groups, rows 32w.. and 32w + 16.., as two commit groups
// (empty where the group is out of range).
template <int D, typename T>
__device__ __forceinline__ void copy_warp_rows(const T* src, T* tile,
                                               const Chunk& c) {
  const int r = threadIdx.x / 32 * 32;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    if (group_in(c, r + 16 * g)) copy_group<D, T>(src, tile, r + 16 * g);
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
  constexpr int RW = RS<D, uint16_t> / 2;  // words per padded row
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
    uint4* grp = reinterpret_cast<uint4*>(tile + (r + i / G) *
                                          RS<D, uint16_t> + i % G * 16);
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

// The f32 tile's K^T quantizer: a lane per d column holds the group's 16
// values in registers.
template <int D>
__device__ __forceinline__ void quantize_k(float* tile, int r, int k_mb) {
  constexpr int R = RS<D, float>;
  float* rows = tile + r * R;
  for (int col = threadIdx.x % 32; col < D; col += 32) {
    float x[16];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      x[j] = rows[j * R + col];
      m = fmaxf(m, fabsf(x[j]));
    }
    const int e = group_exponent(m);
    if (e <= MX_GROUP_EMAX) {
      const MxGroup g = mx_group(e, k_mb);
#pragma unroll
      for (int j = 0; j < 16; ++j) rows[j * R + col] = mx_group_value(x[j], g);
    } else {
      for (int j = 0; j < 16; ++j) rows[j * R + col] = mx_value(x[j], e, k_mb);
    }
  }
}

// The f32 tile's V quantizer: a lane per (token, 16-wide d group), four
// 16-byte words.
template <int D>
__device__ __forceinline__ void quantize_v(float* tile, int r, int v_mb) {
  constexpr int G = D / 16;
  for (int i = threadIdx.x % 32; i < 16 * G; i += 32) {
    float4* grp = reinterpret_cast<float4*>(tile + (r + i / G) *
                                            RS<D, float> + i % G * 16);
    float4 w[4] = {grp[0], grp[1], grp[2], grp[3]};
    float* x = reinterpret_cast<float*>(w);
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) m = fmaxf(m, fabsf(x[j]));
    const int e = group_exponent(m);
    if (e <= MX_GROUP_EMAX) {
      const MxGroup g = mx_group(e, v_mb);
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = mx_group_value(x[j], g);
    } else {
      for (int j = 0; j < 16; ++j) x[j] = mx_value(x[j], e, v_mb);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) grp[k] = w[k];
  }
}

// The 8 values of a row from column 8 * d8 on, as f32.
__device__ __forceinline__ void load8(const uint16_t* row, int d8,
                                      float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(row + d8 * 8);
  x[0] = bf16_lo(w.x); x[1] = bf16_hi(w.x);
  x[2] = bf16_lo(w.y); x[3] = bf16_hi(w.y);
  x[4] = bf16_lo(w.z); x[5] = bf16_hi(w.z);
  x[6] = bf16_lo(w.w); x[7] = bf16_hi(w.w);
}

__device__ __forceinline__ void load8(const float* row, int d8,
                                      float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + d8 * 8);
  const float4 b = *reinterpret_cast<const float4*>(row + d8 * 8 + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Columns 2 wd and 2 wd + 1 of a row, as f32.
__device__ __forceinline__ float2 load2(const uint16_t* row, int wd) {
  const uint32_t x = reinterpret_cast<const uint32_t*>(row)[wd];
  return make_float2(bf16_lo(x), bf16_hi(x));
}

__device__ __forceinline__ float2 load2(const float* row, int wd) {
  return reinterpret_cast<const float2*>(row)[wd];
}

// Waits for the warp's two groups in turn and quantizes each as it lands
// (K: per d column, V: per token; mb < 0 leaves them as they are).
template <int D, bool IS_K, typename T>
__device__ __forceinline__ void land_and_quantize(T* tile,
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
template <int D, typename T>
__global__ void __launch_bounds__(FT)
fp_scores_kernel(const float* __restrict__ q, const T* __restrict__ k,
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

  T* tile = reinterpret_cast<T*>(smem);                      // CH x RS
  float* qs = reinterpret_cast<float*>(tile + CH * RS<D, T>);  // nrep x D
  const size_t bk = (size_t)b * KVH + kv;

  copy_warp_rows<D, T>(k + (bk * L + c.c0) * D, tile, c);
  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  __syncthreads();  // the queries are in
  land_and_quantize<D, true, T>(tile, c, k_mb);

  const bool in = t >= c.j0 && t < c.n;
  float s[NREP_MAX];
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h) s[h] = 0.f;
  if (in) {
    const T* row = tile + t * RS<D, T>;
#pragma unroll 4
    for (int d8 = 0; d8 < D / 8; ++d8) {
      float kv8[8];
      load8(row, d8, kv8);
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
template <int D, typename T>
__global__ void __launch_bounds__(FT)
fp_pv_kernel(const T* __restrict__ v, const int* __restrict__ pos_p,
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
  T* tile = reinterpret_cast<T*>(smem);  // CH x RS
  const size_t bk = (size_t)b * KVH + kv;

  copy_warp_rows<D, T>(v + (bk * L + c.c0) * D, tile, c);
  float p[NREP_MAX];
  chunk_p(c, scores + ((size_t)b * H + kv * nrep) * L + c.c0 + t, L, st_m,
          st_l, bk * NZ * nrep, nrep, p_mb, p);
  land_and_quantize<D, false, T>(tile, c, v_mb);

  // partial P·V over the warp's tokens, lanes along d (a word of two
  // columns each), each token's p from its lane
  float acc[NREP_MAX][NWD][2];
#pragma unroll
  for (int h = 0; h < NREP_MAX; ++h)
#pragma unroll
    for (int i = 0; i < NWD; ++i) acc[h][i][0] = acc[h][i][1] = 0.f;
  const int lo = max(w * 32, c.j0), hi = min(w * 32 + 32, c.n);
  for (int tok = lo; tok < hi; ++tok) {
    const T* row = tile + tok * RS<D, T>;
    float pv[NREP_MAX];
#pragma unroll
    for (int h = 0; h < NREP_MAX; ++h)
      pv[h] = h < nrep ? __shfl_sync(0xffffffffu, p[h], tok % 32) : 0.f;
#pragma unroll
    for (int i = 0; i < NWD; ++i) {
      const int wd = lane + 32 * i;
      if (wd < D / 2) {
        const float2 x = load2(row, wd);
        const float a = x.x, bb = x.y;
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

template <int D, typename T>
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
  const size_t tile = sizeof(T) * CH * RS<D, T>;
  const size_t smem1 = tile + sizeof(float) * nrep * D;
  // three blocks an SM over bf16, one over f32
  const void* fns[] = {(const void*)fp_scores_kernel<D, T>,
                       (const void*)fp_pv_kernel<D, T>};
  cudaError_t err = allow_smem(fns, 2, smem1);
  if (err != cudaSuccess) return (int)err;
  fp_scores_kernel<D, T><<<grid, FT, smem1, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), pp,
      sc.scores, sc.st_m, sc.st_l, sc.count, o, KVH, nrep, L, scaling, q_mb,
      k_mb, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fp_pv_kernel<D, T><<<grid, FT, tile, st>>>(
      static_cast<const T*>(v), pp, sc.scores, sc.st_m, sc.st_l,
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
#define LQER_FP_PARAMS                                                     \
  const void *q, const void *k, const void *v, const void *pos,           \
      void *scratch, void *out, int B, int KVH, int nrep, int D, int L,   \
      float scaling, int q_mb, int k_mb, int p_mb, int v_mb, int window,  \
      void *stream
#define LQER_FP_ARGS                                                       \
  q, k, v, pos, scratch, out, B, KVH, nrep, L, scaling, q_mb, k_mb, p_mb, \
      v_mb, window, reinterpret_cast<cudaStream_t>(stream)

namespace {

template <typename T>
int launch_d(LQER_FP_PARAMS) {
  switch (D) {
    case 64: return launch<64, T>(LQER_FP_ARGS);
    case 80: return launch<80, T>(LQER_FP_ARGS);
    case 96: return launch<96, T>(LQER_FP_ARGS);
    case 128: return launch<128, T>(LQER_FP_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

LQER_API int lqer_decode_attention_fp(LQER_FP_PARAMS) {
  return launch_d<uint16_t>(q, k, v, pos, scratch, out, B, KVH, nrep, D, L,
                            scaling, q_mb, k_mb, p_mb, v_mb, window, stream);
}

// The same over the f32 cache: k, v (B, KVH, L, D) f32.
LQER_API int lqer_decode_attention_fp32(LQER_FP_PARAMS) {
  return launch_d<float>(q, k, v, pos, scratch, out, B, KVH, nrep, D, L,
                         scaling, q_mb, k_mb, p_mb, v_mb, window, stream);
}

#undef LQER_FP_PARAMS
#undef LQER_FP_ARGS
