// Decode attention over the direct-write MXINT cache, one query token per
// slot, and the same with the fresh token's cache write in the launch.
//
// Replaces lqer_tpu/ops/pallas/decode_attention.py::_kernel_quantized (entry
// decode_attention_quantized, codes of width 8 or 4) and, with WRITE,
// ::_kernel_quantized_write (entry decode_attention_quantized_write, width
// 8). Per (slot, kv head) of one layer, at position pos:
//   0. (WRITE) the fresh K/V rows MXINT8-encoded (cache_write._encode_t:
//      exact exponent, zero groups take exponent 0, codes clamp to ±127)
//      and stored into column pos of the layer's codes and exponents, in
//      place; the scores and P·V below then read the fresh column, as the
//      JAX kernel's blend of the fresh values into column pos does;
//   1. q quantized per 16 along d (block_fp, width q_mb + 1);
//   2. scores over columns [0, pos] of the cache as stored: the cache's
//      MXINT values are the operands (quantize once at write), times
//      scaling, columns past pos masked, and under a sliding window
//      (window > 0; -1 for none) the columns at or below pos - window too;
//   3. one exact f32 softmax; p quantized per 16 tokens with the final max
//      and denominator;
//   4. out = Σ p · v.
//
// What bounds it on an H100: the cache stream, (code bytes + d/16 exponent
// bytes) x 2 per token and kv head over the 16-token groups from the one
// holding the window's first key (decode_common.cuh's window_start; column
// 0 without a window) to the one holding pos: 136 x 2 bytes at d = 128 and
// width 8, 72 x 2 at width 4 (at 8 slots x 32 kv heads x about 1000 tokens,
// 0.021 and 0.011 ms at 3.35 TB/s). The TPU block read all L because VMEM
// residency made that free.
//
// Design: decode_split.cuh's scheme, a block of 256 threads per (slot, kv
// head, chunk of 256 tokens) in two launches, each block reading its chunk
// once (K in the first, V in the second): every code row (d rows at width
// 8, d/2 at width 4 with the nibbles split along d) and exponent row (d/16)
// of the chunk's tokens copied to shared memory by 16-byte cp.async (16
// tokens of one row per copy), rows padded by 16 bytes; codes decode in
// registers as code * 2^(e - (w - 1)), exact in f32. The kernels are built
// per n_rep bound (1, 4 or 8): a head loop guarded at run time still executes
// every instruction of its unrolled body.
//   1. A thread per token sums its n_rep scores over d (the byte of each
//      code row at its column: a warp reads 32 consecutive bytes of a row,
//      no bank conflict), in d order as the one-pass kernel did. With WRITE
//      the block whose chunk holds pos (pos < L) first encodes the fresh
//      column into the cache; a barrier orders those stores before its
//      cp.async reads of the chunk.
//   2. Launched as a programmatic dependent launch: its blocks copy their V
//      chunk while launch 1 ends and wait for it (griddepcontrol) before
//      reading the scores and stats; row 10's block that holds pos copies
//      the fresh column's segment after the wait. P·V with lanes along d:
//      warp w takes the 16-token groups w and w + 8, a lane owns code rows
//      lane, lane + 32, ... and reads 16 tokens of a row per 16-byte load
//      (the 16-byte padding puts 8 consecutive rows on distinct banks); at
//      width 4 one byte feeds d rows r and r + d/2. The p of each head
//      comes from shared memory, written there by the thread of its token.
#include "decode_split.cuh"

namespace {

using namespace decode;

// The chunk tile of one side (K or V): CR code rows, then GD exponent rows,
// TS bytes each (CH tokens plus 16 bytes of padding).
template <int D, int CW>
struct Tile {
  static constexpr int CR = CW == 8 ? D : D / 2;
  static constexpr int GD = D / 16;
  static constexpr int TS = CH + 16;
  static constexpr int BYTES = (CR + GD) * TS;
};

// The block's copy of the 16-token segments [s0, s1) of the chunk, but the
// segment `skip`, of every code and exponent row of one (slot, kv head)
// (codes (CR, L), exps (GD, L)) into the tile: 16-byte cp.async,
// consecutive threads along a row; one commit group.
template <int D, int CW>
__device__ __forceinline__ void copy_segments(const int8_t* codes,
                                              const int8_t* exps, int L,
                                              int8_t* tile, int c0, int s0,
                                              int s1, int skip = -1) {
  using T = Tile<D, CW>;
  const int ns = s1 - s0;
  for (int i = threadIdx.x; i < (T::CR + T::GD) * ns; i += FT) {
    const int r = i / ns, seg = s0 + i % ns, col = seg * 16;
    if (seg == skip) continue;
    const int8_t* src = r < T::CR ? codes + (size_t)r * L
                                  : exps + (size_t)(r - T::CR) * L;
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

// Pass 1. Grid (B, KVH, NZ), NZ = ceil(L / CH); nrep <= NR.
template <int D, int CW, bool WRITE, int NR>
__global__ void __launch_bounds__(FT)
q_scores_kernel(const float* __restrict__ q, int8_t* kc, int8_t* ke,
                int8_t* vc, int8_t* ve, const float* __restrict__ kh,
                const float* __restrict__ vh, const int* __restrict__ pos_p,
                float* __restrict__ scores, float* __restrict__ st_m,
                float* __restrict__ st_l, int* __restrict__ count,
                float* __restrict__ out, int KVH, int nrep, int L,
                float scaling, int q_mb, int window) {
  using T = Tile<D, CW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, H = KVH * nrep;
  // launch 2 may start (programmatic dependent launch): its blocks copy
  // their V chunk, then wait for this grid to end
  asm volatile("griddepcontrol.launch_dependents;");
  Chunk c;
  if (!chunk_of(pos_p, b, z, L, window, c)) {
    if (z == 0 && c.ntok == 0)  // no column (pos < 0): out = 0
      for (int idx = t; idx < nrep * D; idx += FT)
        out[((size_t)b * H + kv * nrep) * D + idx] = 0.f;
    return;
  }
  const size_t bk = (size_t)b * KVH + kv;
  if (z == c.first / CH && t == 0) count[bk] = 0;
  int8_t* tile = reinterpret_cast<int8_t*>(smem);
  float* qs = reinterpret_cast<float*>(smem + T::BYTES);  // nrep x D

  if (WRITE && c.pos < L && c.pos / CH == z) {  // block-uniform
    for (int idx = t; idx < 2 * T::GD; idx += FT) {
      const int g = idx % T::GD;
      const bool is_v = idx >= T::GD;
      encode_group((is_v ? vh : kh) + bk * D + g * 16,
                   (is_v ? vc : kc) + bk * D * L,
                   (is_v ? ve : ke) + bk * T::GD * L, L, c.pos, g);
    }
    __syncthreads();  // the fresh column before the chunk's reads
  }
  copy_segments<D, CW>(kc + bk * T::CR * L, ke + bk * T::GD * L, L, tile,
                       c.c0, c.j0 / 16, c.n / 16);
  quantize_queries<D>(q + ((size_t)b * H + kv * nrep) * D, qs, nrep, q_mb);
  cp_async_wait<0>();
  __syncthreads();

  const bool in = t >= c.j0 && t < c.n;
  float s[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) s[h] = 0.f;
  if (in) score_column<D, CW, NR>(tile, t, qs, nrep, s);
  store_scores_and_stats(
      s, in, in && in_window(c.c0 + t, c.pos, window), scaling,
      scores + ((size_t)b * H + kv * nrep) * L + c.c0 + t, L, nrep, st_m,
      st_l, (bk * NZ + z) * nrep);
}

// acc[h][i][x] += Σ over the 16 tokens from chunk column j of p[h] · v of
// the lane's code rows r = lane + 32 i (d rows r and, at width 4, r + D/2),
// p of head h at ps[h * CH + j + u] in shared memory.
template <int D, int CW, int NR>
__device__ __forceinline__ void pv_group(
    const int8_t* tile, const float* ps, int j, int nrep,
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
    int ev[NV][4];
#pragma unroll
    for (int x = 0; x < NV; ++x) {
      const int er = T::CR + r / 16 + x * (D / 32);  // exponent row
      const int4 e4 = *reinterpret_cast<const int4*>(tile + er * T::TS + j);
      ev[x][0] = e4.x, ev[x][1] = e4.y, ev[x][2] = e4.z, ev[x][3] = e4.w;
    }
#pragma unroll
    for (int u4 = 0; u4 < 4; ++u4) {
      float pv[NR][4];
#pragma unroll
      for (int h = 0; h < NR; ++h)
        if (h < nrep) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(ps + h * CH + j + 4 * u4);
          pv[h][0] = p4.x, pv[h][1] = p4.y, pv[h][2] = p4.z, pv[h][3] = p4.w;
        }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int byte = cv[u4] >> (u * 8);
#pragma unroll
        for (int x = 0; x < NV; ++x) {
          const int code = CW == 8 ? (int)(int8_t)byte
                           : (x ? high_nibble(byte) : low_nibble(byte));
          const int e = (int)(int8_t)(ev[x][u4] >> (u * 8));
          const float v = (float)code * exp2_int(e - (CW - 1));
#pragma unroll
          for (int h = 0; h < NR; ++h)
            if (h < nrep) acc[h][i][x] = fmaf(pv[h][u], v, acc[h][i][x]);
        }
      }
    }
  }
}

// Pass 2's shared memory before the p of each head: the tile, which then
// holds the warps' partials (FW x nrep x D f32).
template <int D, int CW>
__host__ __device__ __forceinline__ size_t pv_tile_bytes(int nrep) {
  const size_t red = sizeof(float) * FW * nrep * D;
  return (size_t)Tile<D, CW>::BYTES > red ? (size_t)Tile<D, CW>::BYTES : red;
}

// Pass 2. Same grid as pass 1.
template <int D, int CW, int NR>
__global__ void __launch_bounds__(FT)
q_pv_kernel(const int8_t* __restrict__ vc, const int8_t* __restrict__ ve,
            const int* __restrict__ pos_p, const float* __restrict__ scores,
            const float* __restrict__ st_m, const float* __restrict__ st_l,
            float* part, int* __restrict__ count, float* __restrict__ out,
            int KVH, int nrep, int L, int p_mb, int window, bool fresh) {
  using T = Tile<D, CW>;
  constexpr int RPL = (T::CR + 31) / 32;  // code rows per lane
  constexpr int NV = CW == 8 ? 1 : 2;     // d rows per code row
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kv = blockIdx.y, z = blockIdx.z, NZ = gridDim.z;
  const int t = threadIdx.x, lane = t % 32, w = t / 32, H = KVH * nrep;
  Chunk c;
  if (!chunk_of(pos_p, b, z, L, window, c)) return;
  const size_t bk = (size_t)b * KVH + kv;
  int8_t* tile = reinterpret_cast<int8_t*>(smem);
  // the p of each head, nrep x CH, past the tile and the warps' partials
  float* ps = reinterpret_cast<float*>(smem + pv_tile_bytes<D, CW>(nrep));

  const int8_t *vcb = vc + bk * T::CR * L, *veb = ve + bk * T::GD * L;
  // V's chunk lands while launch 1 ends, but for the segment holding pos
  // where launch 1 wrote the fresh column (row 10): after launch 1's end
  const int own = fresh && c.pos < L && c.pos / CH == z
                      ? (c.pos - c.c0) / 16 : -1;
  copy_segments<D, CW>(vcb, veb, L, tile, c.c0, c.j0 / 16, c.n / 16, own);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (own >= 0) copy_segments<D, CW>(vcb, veb, L, tile, c.c0, own, own + 1);
  float p[NR];
  chunk_p(c, scores + ((size_t)b * H + kv * nrep) * L + c.c0 + t, L, st_m,
          st_l, bk * NZ * nrep, nrep, p_mb, p);
#pragma unroll
  for (int h = 0; h < NR; ++h)
    if (h < nrep) ps[h * CH + t] = p[h];

  float acc[NR][RPL][NV];
#pragma unroll
  for (int h = 0; h < NR; ++h)
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int x = 0; x < NV; ++x) acc[h][i][x] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  for (int j = w * 16; j < CH; j += FW * 16)
    if (group_in(c, j)) pv_group<D, CW, NR>(tile, ps, j, nrep, acc);
  __syncthreads();  // the tile is read: it now holds the warps' partials
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
  finish_chunk<D, NR>(red, part, count,
                      out + ((size_t)b * H + kv * nrep) * D, c, bk, z, NZ,
                      nrep);
}

template <int D, int CW, bool WRITE, int NR>
int launch(const void* q, void* kc, void* ke, void* vc, void* ve,
           const void* kh, const void* vh, const void* pos, void* scratch,
           void* out, int B, int KVH, int nrep, int L, float scaling,
           int q_mb, int p_mb, int window, cudaStream_t st) {
  using T = Tile<D, CW>;
  if (nrep < 1 || nrep > NR || L % 16 != 0 || window == 0 || window < -1)
    return (int)cudaErrorInvalidValue;
  const int NZ = (L + CH - 1) / CH;
  const Scratch sc = carve(scratch, B, KVH, nrep, D, L, NZ);
  const size_t smem1 = T::BYTES + sizeof(float) * nrep * D;
  const size_t smem2 = pv_tile_bytes<D, CW>(nrep) + sizeof(float) * nrep * CH;
  const void* fns[] = {(const void*)q_scores_kernel<D, CW, WRITE, NR>,
                       (const void*)q_pv_kernel<D, CW, NR>};
  cudaError_t err = allow_smem(fns, 2, smem1 > smem2 ? smem1 : smem2);
  if (err != cudaSuccess) return (int)err;
  const auto* pp = static_cast<const int*>(pos);
  auto* o = static_cast<float*>(out);
  auto i8 = [](void* p) { return static_cast<int8_t*>(p); };
  const dim3 grid(B, KVH, NZ);
  q_scores_kernel<D, CW, WRITE, NR><<<grid, FT, smem1, st>>>(
      static_cast<const float*>(q), i8(kc), i8(ke), i8(vc), i8(ve),
      static_cast<const float*>(kh), static_cast<const float*>(vh), pp,
      sc.scores, sc.st_m, sc.st_l, sc.count, o, KVH, nrep, L, scaling, q_mb,
      window);
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
  return (int)cudaLaunchKernelEx(
      &cfg, q_pv_kernel<D, CW, NR>, static_cast<const int8_t*>(vc),
      static_cast<const int8_t*>(ve), pp, (const float*)sc.scores,
      (const float*)sc.st_m, (const float*)sc.st_l, sc.part, sc.count, o,
      KVH, nrep, L, p_mb, window, WRITE);
}

// The kernels' head count NR: the query heads per kv head, rounded up to
// 1, 4 or 8.
template <int D, int NR>
int dispatch_heads(const void* q, void* kc, void* ke, void* vc, void* ve,
                   const void* kh, const void* vh, const void* pos,
                   void* scratch, void* out, int B, int KVH, int nrep, int L,
                   int code_width, float scaling, int q_mb, int p_mb,
                   int window, cudaStream_t st) {
#define LQER_QDEC_ARGS                                                      \
  q, kc, ke, vc, ve, kh, vh, pos, scratch, out, B, KVH, nrep, L, scaling,  \
      q_mb, p_mb, window, st
  if (code_width == 8 && kh != nullptr)
    return launch<D, 8, true, NR>(LQER_QDEC_ARGS);
  if (code_width == 8) return launch<D, 8, false, NR>(LQER_QDEC_ARGS);
  if constexpr (D % 32 == 0)
    if (code_width == 4 && kh == nullptr)
      return launch<D, 4, false, NR>(LQER_QDEC_ARGS);
#undef LQER_QDEC_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int D>
int dispatch(const void* q, void* kc, void* ke, void* vc, void* ve,
             const void* kh, const void* vh, const void* pos, void* scratch,
             void* out, int B, int KVH, int nrep, int L, int code_width,
             float scaling, int q_mb, int p_mb, int window, cudaStream_t st) {
#define LQER_QDEC_ARGS                                                      \
  q, kc, ke, vc, ve, kh, vh, pos, scratch, out, B, KVH, nrep, L,           \
      code_width, scaling, q_mb, p_mb, window, st
  if (nrep == 1) return dispatch_heads<D, 1>(LQER_QDEC_ARGS);
  if (nrep <= 4) return dispatch_heads<D, 4>(LQER_QDEC_ARGS);
  return dispatch_heads<D, NREP_MAX>(LQER_QDEC_ARGS);
#undef LQER_QDEC_ARGS
}

}  // namespace

// One layer: q (B, H, D) f32; codes (B, KVH, D, L) (width 8) or
// (B, KVH, D/2, L) (width 4, d-split nibbles) and exps (B, KVH, D/16, L)
// int8, the layer's slice of the layer-stacked cache; positions (B) int32;
// out (B, H, D) f32. With kh and vh ((B, KVH, D) f32, width 8 only) the
// fresh rows are encoded into column positions[b] in place first; pass
// null pointers for the read-only kernel. window: the sliding window in
// tokens, -1 for none. scratch: decode_split.cuh's carve, NZ = ceil(L /
// 256). D is a multiple of 16 from 64 to 128 (instantiated at 64, 80, 96
// and 128; width 4 needs D % 32 == 0).
LQER_API int lqer_decode_attention_quantized(
    const void* q, void* kc, void* ke, void* vc, void* ve, const void* kh,
    const void* vh, const void* pos, void* scratch, void* out, int B, int KVH,
    int nrep, int D, int L, int code_width, float scaling, int q_mb, int p_mb,
    int window, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define LQER_QDEC_ARGS                                                       \
  q, kc, ke, vc, ve, kh, vh, pos, scratch, out, B, KVH, nrep, L, code_width, \
      scaling, q_mb, p_mb, window, st
  switch (D) {
    case 64: return dispatch<64>(LQER_QDEC_ARGS);
    case 80: return dispatch<80>(LQER_QDEC_ARGS);
    case 96: return dispatch<96>(LQER_QDEC_ARGS);
    case 128: return dispatch<128>(LQER_QDEC_ARGS);
  }
#undef LQER_QDEC_ARGS
  return (int)cudaErrorInvalidValue;
}
