// Four in-place cache writes: the flush of the staging ring into the main
// MXINT cache, the one-row-per-slot write of a decode token into one layer
// or into every layer at once, and the same for the MXINT8 cache with the
// token's encode in the launch.
//
// The flush.
//
// Replaces lqer_tpu/ops/pallas/cache_write.py::_kernel_flush (entry
// flush_stage_to_main). For every layer, slot, kv head and row of the four
// cache arrays (K codes, K exponents, V codes, V exponents):
//     main[..., t] = ring[..., t % SW]   for t in [flushed[b], new_flushed[b])
// A bit-exact masked indexed copy; one launch covers all layers.
//
// What bounds it on an H100: bytes, each staged byte read once from the
// ring and written once into the main cache: at the 7B shape (32 layers x
// 8 slots x 32 kv heads x 272 rows) a 32-token span of every slot reads
// 71 MB and writes 71 MB, 142 MB against 3.35 TB/s, 0.0426 ms. Measured
// (H100 80GB HBM3, 700 W) the copy costs about 70 ps per main row
// whatever its bytes, 0.158 ms there and about as much for 64 tokens:
// each row's span is its own 2 KB-strided piece of the token-axis-last
// main cache (PyTorch's copy_ of the same bytes takes 0.215 ms). It runs
// once per >= 17 decode steps.
//
// Design: the TPU kernel read-modify-wrote whole 128-lane main windows in
// two aliased passes (Mosaic tiling and one alias per buffer). Here a flat
// grid of 16-byte pieces: a thread copies one uint4 of each of RPT rows,
// main offset t (a multiple of 16) from ring offset t % SW (contiguous
// within the piece since SW % 16 == 0), consecutive threads on consecutive
// pieces of a row and then the next row, so a 32-token span stores whole
// 32-byte sectors. The RPT = 4 rows of a thread (ceil(rows / 4) apart)
// keep 4 loads in flight at once, which takes a flush of few slots 1.4x
// faster than one row a thread. A piece's row and array come from per-array
// constants, with no division per byte, and by constant indices into the
// argument struct (a runtime index gave the kernel a stack frame that
// every thread filled: 2.2x slower). The host sizes the grid without a
// sync from span <= SW: SW / 16 pieces a row, pieces past a slot's span
// exit at once (a slot with span 0 costs only exits); a longer span walks
// on by SW. A slot whose flushed or new_flushed is not a multiple of 16
// (the serving path makes none: both are multiples of 32) is copied byte
// by byte in the same pieces.
//
// The row write.
//
// Replaces lqer_tpu/ops/pallas/cache_write.py::_kernel (entry
// write_kv_rows_stacked). For each of up to four layer-stacked arrays
// (NL, B, KVH, R, C) and each slot b, the new row of that slot lands at
// token positions[b] of layer li, in place: on dim 3 (a row of C values:
// the bf16 K/V of the fp cache) or on dim 4 (a column of R values: the
// token-axis-last MXINT codes and exponents). f32 rows stored into a bf16
// array round to nearest even, as astype does; f32 rows stored into an f32
// array (the float32 cache) and int8 rows are copied. A
// position outside [0, L) writes nothing (checked on the device, no host
// sync); the JAX kernel states in-range positions as its precondition.
//
// What bounds it on an H100: the bytes, a read of the new rows and a write
// of the stored values (the bf16 K and V rows of 8 slots at 32 kv heads,
// d = 128: 256 KB of f32 read, 128 KB written): far below a launch's own
// cost, so it is launch- and latency-bound: what counts is that every load
// is in flight at once.
//
// Design: the TPU kernel read-modify-wrote aligned (32-row or 128-lane)
// windows because Mosaic cannot store one dynamic row; here one launch for
// all arrays of a call runs a flat grid of independent items, one a thread,
// so no thread waits for more than one round trip to memory: 8 values of a
// bf16 row (two float4 loads of the f32 row, one 16-byte store of packed
// bf16), or 4 of an f32 row (one float4 load and store), where the row and
// both pointers allow, else one value (each code
// or exponent byte of a column from its own thread). A thread loads its
// value before its slot's position, so the two loads overlap.
//
// The row write of every layer.
//
// Replaces lqer_tpu/ops/pallas/cache_write.py::_kernel_all (entry
// write_kv_rows_all_layers): the row write above for every layer of the
// stacked arrays in one launch, the new rows carrying a leading layer axis
// ((NL, B, KVH, C) rows or (NL, B, KVH, R) columns); bitwise the row write
// applied layer by layer.
//
// What bounds it on an H100: the bytes again, NL times the row write's
// (the MXINT8 columns of 32 layers x 8 slots x 32 kv heads at d = 128:
// 2.2 MB read and 2.2 MB written), about 1.3 us at 3.35 TB/s, still below
// a launch's own cost; one launch for all layers takes NL - 1 launches off
// a decode step.
//
// Design: the same kernel, its grid grown by a layer axis (blockIdx.y).
//
// The fused MXINT8 encode + write.
//
// Replaces lqer_tpu/ops/pallas/cache_write.py::_kernel_fused (entry
// write_kv_tokens_fused). The fresh K and V rows (B, KVH, d) f32 of one
// decode step are MXINT8-encoded as _encode_t encodes them (per-16 absmax,
// an all-zero group takes exponent 0, the exponent from the float's bits,
// sign(v + 1e-9) and round((|v| + 1e-9) / 2^e * 128) clamped to 127) and
// stored into column positions[b] of layer li of the four token-axis-last
// arrays (K codes, K exponents, V codes, V exponents), in place; bitwise
// mx8_encode(zero_fill=1.0) followed by the row write. A position outside
// [0, L) writes nothing (checked on the device, no host sync).
//
// What bounds it on an H100: the launch. Its bytes, 2 x 4 x d f32 read and
// 2 x (d + d/16) int8 written per slot and kv head (at 8 slots x 32 kv
// heads, d = 128: 256 KB read, 68 KB written), take 0.0001 ms at 3.35
// TB/s, far below the 0.0050 ms an empty launch costs.
//
// Design: the TPU kernel read-modify-wrote the 128-lane window holding pos
// (a Mosaic store needs an aligned window). Here a flat grid of one thread
// per code byte (B x KVH x 2 x d threads), so every load is in flight at
// once over the whole card: consecutive threads load consecutive values of
// a row (coalesced; the rows may be strided views, as the fused q|k|v
// output's V is), a 16-lane group's absmax comes from four
// __shfl_xor_sync steps (a max is exact in any order), each thread stores
// its code (decode_common.cuh's mx8_code, the decode kernels' own) and the
// group's first lane the exponent byte. A thread loads its slot's position
// beside its value, so the two loads overlap. Each byte lands in its own
// 32-byte sector of the token-axis-last arrays: 2 x B x KVH x (d + d/16)
// stores, all in flight at once.
#include <climits>

#include "decode_common.cuh"

namespace {

struct FlushArrays {
  int8_t* main[4];        // (NL, B, KVH, rows, L)
  const int8_t* ring[4];  // (NL, B, KVH, rows, SW)
  int rows[4];            // KVH x rows: each array's rows of one (layer, slot)
  int start[5];           // first row of each array; start[4]: all rows
};

// v[k] for k in 0..3 by constant indices
template <class T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

// Grid (ceil(rows / RPT) x pieces / 256, NL x B): thread i of (layer, slot)
// blockIdx.y copies piece p = i % P of the RPT rows q + k ceil(rows / RPT),
// q = i / P, P = ceil(SW / 16) pieces a row, its RPT loads in flight
// together, and again every 16 P tokens while the span lasts. vec: L, SW
// and every array allow 16-byte pieces.
constexpr int RPT = 4;

__global__ void __launch_bounds__(256)
flush_pieces_kernel(FlushArrays a, const int* __restrict__ fl_p,
                    const int* __restrict__ nf_p, int B, int L, int SW,
                    int vec) {
  const int P = (SW + 15) / 16;
  const int nrow = a.start[4], rq = (nrow + RPT - 1) / RPT;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lb = blockIdx.y;  // layer * B + slot
  const int b = lb % B;
  const int lo = max(fl_p[b], 0), hi = min(nf_p[b], L);
  const int q = i / P;
  const int first = lo + (i - q * P) * 16;
  if (q >= rq || first >= hi) return;
  int8_t* main[RPT];
  const int8_t* ring[RPT];
  bool ok[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int row = q + k * rq;
    ok[k] = row < nrow;
    // the array by constant indices: a runtime index into the argument
    // struct would copy it into every thread's local memory
    const int arr = (row >= a.start[1]) + (row >= a.start[2]) +
                    (row >= a.start[3]);
    const size_t r =
        (size_t)lb * pick(a.rows, arr) + (row - pick(a.start, arr));
    main[k] = pick(a.main, arr) + r * L;
    ring[k] = pick(a.ring, arr) + r * SW;
  }
  if (vec && lo % 16 == 0 && hi % 16 == 0) {  // SW == 16 P
    for (int t = first; t < hi; t += SW) {
      uint4 v[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (ok[k])
          v[k] = __ldg(reinterpret_cast<const uint4*>(ring[k] + t % SW));
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (ok[k]) *reinterpret_cast<uint4*>(main[k] + t) = v[k];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (ok[k])
      for (int t0 = first; t0 < hi; t0 += 16 * P)
        for (int t = t0; t < min(t0 + 16, hi); ++t)
          main[k][t] = ring[k][t % SW];
}

struct RowArrays {
  void* dst[4];        // (NL, B, KVH, R, C)
  const void* src[4];  // (B, KVH, C) rows or (B, KVH, R) columns
  int lane[4];         // 1: token axis on dim 4 (C = L); 0: on dim 3 (R = L)
  int rows[4];         // R
  int cols[4];         // C
  int kind[4];         // 0: int8 copy; 1: f32 -> bf16; 2: f32 copy
  int vec[4];          // values an item: 8 (a bf16 row's 16 bytes), 4 (an
                       // f32 row's) or 1
  int start[5];        // first item of each array; start[4]: all items
};

// The bits of two values rounded to bf16 (nearest even), x at the lower
// address.
__device__ __forceinline__ unsigned bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Grid (items / 256, layers): layer li0 + blockIdx.y takes the rows of layer
// blockIdx.y of src (one layer of rows when gridDim.y == 1). An item is
// vec values of one (slot, kv head) of one array.
__global__ void __launch_bounds__(256)
row_write_kernel(RowArrays a, const int* __restrict__ pos_p, int li0, int B,
                 int KVH) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.start[4]) return;
  int arr = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) arr += i >= a.start[k];
  const int z = blockIdx.y, li = li0 + z;
  const int R = a.rows[arr], C = a.cols[arr], vec = a.vec[arr];
  const bool lane = a.lane[arr] != 0;
  const int n = lane ? R : C;  // values per (slot, kv head)
  const int per = n / vec;     // items per (slot, kv head)
  const int j = i - a.start[arr];
  const int bk = j / per, k = (j % per) * vec;  // slot * KVH + kv head
  const size_t so = ((size_t)z * B * KVH + bk) * n + k;
  const size_t base = ((size_t)li * B * KVH + bk) * R * C;
  if (vec == 8) {  // f32 -> bf16, 8 values of a row
    const float4* src = reinterpret_cast<const float4*>(
        static_cast<const float*>(a.src[arr]) + so);
    const float4 lo = __ldg(src), hi = __ldg(src + 1);
    const int pos = pos_p[bk / KVH];
    if (pos < 0 || pos >= R) return;
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.dst[arr]) +
                              base + (size_t)pos * C + k) =
        make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w),
                   bf16x2(hi.x, hi.y), bf16x2(hi.z, hi.w));
    return;
  }
  if (vec == 4) {  // f32 -> f32, 4 values of a row
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(a.src[arr]) + so));
    const int pos = pos_p[bk / KVH];
    if (pos < 0 || pos >= R) return;
    *reinterpret_cast<float4*>(static_cast<float*>(a.dst[arr]) + base +
                               (size_t)pos * C + k) = x;
    return;
  }
  float f = 0.f;
  int8_t c = 0;
  if (a.kind[arr] != 0)
    f = __ldg(static_cast<const float*>(a.src[arr]) + so);
  else
    c = __ldg(static_cast<const int8_t*>(a.src[arr]) + so);
  const int pos = pos_p[bk / KVH];
  if (pos < 0 || pos >= (lane ? C : R)) return;
  const size_t off =
      base + (lane ? (size_t)k * C + pos : (size_t)pos * C + k);
  if (a.kind[arr] == 1)
    static_cast<__nv_bfloat16*>(a.dst[arr])[off] = __float2bfloat16_rn(f);
  else if (a.kind[arr] == 2)
    static_cast<float*>(a.dst[arr])[off] = f;
  else
    static_cast<int8_t*>(a.dst[arr])[off] = c;
}

// Grid (2 B KVH D / 256): thread i encodes value j = i % D of row i / D,
// the K rows (slot, kv head) first, then the V rows; kh and vh rows of
// slot b and kv head h start at b * sb + h * skv. 2 B KVH D is a multiple
// of 32, so a warp runs whole or not at all, and a 16-value group is 16
// aligned lanes of one warp.
__global__ void __launch_bounds__(256)
encode_columns_kernel(const float* __restrict__ kh,
                      const float* __restrict__ vh, int k_sb, int k_skv,
                      int v_sb, int v_skv, int8_t* kc, int8_t* ke,
                      int8_t* vc, int8_t* ve, const int* __restrict__ pos_p,
                      int li, int B, int KVH, int D, int L) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nr = B * KVH;  // rows of K, and of V
  if (i >= 2 * nr * D) return;
  const int r = i / D, j = i - r * D;
  const bool is_v = r >= nr;
  const int bk = is_v ? r - nr : r;  // slot * KVH + kv head
  const int b = bk / KVH, h = bk - b * KVH;
  const float v = __ldg(is_v ? vh + (size_t)b * v_sb + (size_t)h * v_skv + j
                             : kh + (size_t)b * k_sb + (size_t)h * k_skv + j);
  const int pos = pos_p[b];
  float m = fabsf(v);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int e = group_exponent(m);
  if (pos < 0 || pos >= L) return;
  const size_t col = (size_t)li * nr + bk;  // (layer, slot, kv head)
  (is_v ? vc : kc)[(col * D + j) * L + pos] = decode::mx8_code(v, e);
  if (j % 16 == 0)
    (is_v ? ve : ke)[(col * (D / 16) + j / 16) * L + pos] = (int8_t)e;
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
  if (NL < 1 || B < 1 || SW < 1 || (long long)NL * B > 65535)
    return (int)cudaErrorInvalidValue;
  FlushArrays a{{static_cast<int8_t*>(main0), static_cast<int8_t*>(main1),
                 static_cast<int8_t*>(main2), static_cast<int8_t*>(main3)},
                {static_cast<const int8_t*>(ring0),
                 static_cast<const int8_t*>(ring1),
                 static_cast<const int8_t*>(ring2),
                 static_cast<const int8_t*>(ring3)}};
  const int rows[4] = {rows0, rows1, rows2, rows3};
  bool vec = L % 16 == 0 && SW % 16 == 0;
  long long total = 0;
  for (int k = 0; k < 4; ++k) {
    a.rows[k] = KVH * rows[k];
    a.start[k] = (int)total;
    total += a.rows[k];
    vec = vec && reinterpret_cast<uintptr_t>(a.main[k]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.ring[k]) % 16 == 0;
  }
  const long long threads = (total + RPT - 1) / RPT * ((SW + 15) / 16);
  if (threads > INT_MAX - 255) return (int)cudaErrorInvalidValue;
  a.start[4] = (int)total;
  if (threads == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((threads + 255) / 256), NL * B);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int* fl = static_cast<const int*>(flushed);
  const int* nf = static_cast<const int*>(new_flushed);
  flush_pieces_kernel<<<grid, 256, 0, st>>>(a, fl, nf, B, L, SW, vec);
  return (int)cudaGetLastError();
}

namespace {

int launch_rows(void* dst0, void* dst1, void* dst2, void* dst3,
                const void* src0, const void* src1, const void* src2,
                const void* src3, int lane0, int lane1, int lane2, int lane3,
                int rows0, int rows1, int rows2, int rows3, int cols0,
                int cols1, int cols2, int cols3, int kind0, int kind1,
                int kind2, int kind3, const void* positions, int n, int li0,
                int NL, int B, int KVH, void* stream) {
  if (n < 1 || n > 4 || NL < 1 || NL > 65535)
    return (int)cudaErrorInvalidValue;
  RowArrays a{{dst0, dst1, dst2, dst3}, {src0, src1, src2, src3},
              {lane0, lane1, lane2, lane3}, {rows0, rows1, rows2, rows3},
              {cols0, cols1, cols2, cols3}, {kind0, kind1, kind2, kind3}};
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  long long items = 0;
  for (int k = 0; k < 4; ++k) {
    a.start[k] = (int)items;
    if (k >= n) {
      a.vec[k] = 1;
      continue;
    }
    const bool rows = !a.lane[k] && aligned(a.dst[k]) && aligned(a.src[k]);
    a.vec[k] = (rows && a.kind[k] == 1 && a.cols[k] % 8 == 0)   ? 8
               : (rows && a.kind[k] == 2 && a.cols[k] % 4 == 0) ? 4
                                                                 : 1;
    items += (long long)B * KVH * (a.lane[k] ? a.rows[k] : a.cols[k]) /
             a.vec[k];
  }
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  a.start[4] = (int)items;
  if (items == 0) return (int)cudaSuccess;
  row_write_kernel<<<dim3((unsigned)((items + 255) / 256), NL), 256, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(positions), li0, B, KVH);
  return (int)cudaGetLastError();
}

}  // namespace

#define LQER_ROW_PARAMS                                                       \
  void *dst0, void *dst1, void *dst2, void *dst3, const void *src0,           \
      const void *src1, const void *src2, const void *src3, int lane0,        \
      int lane1, int lane2, int lane3, int rows0, int rows1, int rows2,       \
      int rows3, int cols0, int cols1, int cols2, int cols3, int kind0,       \
      int kind1, int kind2, int kind3, const void *positions, int n
#define LQER_ROW_ARGS                                                         \
  dst0, dst1, dst2, dst3, src0, src1, src2, src3, lane0, lane1, lane2, lane3, \
      rows0, rows1, rows2, rows3, cols0, cols1, cols2, cols3, kind0, kind1,   \
      kind2, kind3, positions, n

// dst_i: n layer-stacked arrays (NL, B, KVH, rows_i, cols_i), updated in
// place at layer li; src_i: the new (B, KVH, ·) rows, f32 for kind 1
// (stored as bf16) and kind 2 (stored as f32) or int8 for kind 0; lane_i
// says which dim is the token
// axis; positions (B) int32.
LQER_API int lqer_write_rows(LQER_ROW_PARAMS, int li, int B, int KVH,
                             void* stream) {
  return launch_rows(LQER_ROW_ARGS, li, 1, B, KVH, stream);
}

// The same for every layer: src_i holds the new (NL, B, KVH, ·) rows.
LQER_API int lqer_write_rows_all_layers(LQER_ROW_PARAMS, int NL, int B,
                                        int KVH, void* stream) {
  return launch_rows(LQER_ROW_ARGS, 0, NL, B, KVH, stream);
}

#undef LQER_ROW_PARAMS
#undef LQER_ROW_ARGS

// kh, vh: the fresh (B, KVH, D) f32 rows, row (b, h) at b * sb + h * skv
// (values contiguous); kc, vc (NL, B, KVH, D, L) and ke, ve (NL, B, KVH,
// D/16, L) int8, written in place at column positions[b] of layer li;
// positions (B) int32.
LQER_API int lqer_encode_write_tokens(const void* kh, const void* vh, void* kc,
                                      void* ke, void* vc, void* ve,
                                      const void* positions, int k_sb,
                                      int k_skv, int v_sb, int v_skv, int li,
                                      int B, int KVH, int D, int L,
                                      void* stream) {
  const long long threads = 2LL * B * KVH * D;
  if (D % 16 != 0 || threads > INT_MAX - 255)
    return (int)cudaErrorInvalidValue;
  if (threads == 0) return (int)cudaSuccess;
  encode_columns_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(kh), static_cast<const float*>(vh), k_sb,
      k_skv, v_sb, v_skv, static_cast<int8_t*>(kc), static_cast<int8_t*>(ke),
      static_cast<int8_t*>(vc), static_cast<int8_t*>(ve),
      static_cast<const int*>(positions), li, B, KVH, D, L);
  return (int)cudaGetLastError();
}
