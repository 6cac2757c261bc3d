// Device code shared by kernel 1 (dequant_gemm.cu) and the MLP megakernel
// (mlp_fused.cu): the MXINT4/MXINT8 weight-streaming GEMM tile on the
// tensor cores, its split-K partials and epilogue (the rank-k correction,
// the per-16-column quantizers), the f64 X·A tile and the in-kernel
// activation quantizer of one 16-group.
//
// Layout (lqer_tpu_torch/ops/storage.py): int32 words (K/per, N), one word =
// 8 W4 codes (or 4 W8 codes) of one column along K, two's complement;
// exponents (K/16, N) int8, one per column and 16-group of K.
//
// The GEMM tile. A block of NTHREADS = 256 threads (8 warps) owns MTILE rows
// of X by TN columns of the weight over a range of K's 16-groups (the
// launch splits K over blocks; ops/kernels/dequant_gemm.py::gemm_plan):
//   TileDecode:  8 rows x 256 columns, 8 warps along N (M <= 8);
//   TilePrefill: 64 rows x 128 columns, 4 warps along N x 2 along M.
// A warp owns 32 columns as two m16n8k16 tiles (mma.sync, bf16 in, f32
// out) with W as the A operand (16 output columns x one 16-group of K) and
// X as the B operand (8 rows of X per n-tile), the columns in the mma row
// order frag_col4 names (thread (gid = lane / 4, q = lane % 4) holds the
// outputs of its warp's columns 4 gid .. 4 gid + 3).
//   8-row tile: each thread decodes its columns' codes from one 16-byte
//   shared-memory load per group into A fragments directly, the k slots
//   of the mma a permutation of the group's 16 k that its X fragments
//   share (the sum over a group is exact in any order, see below); W4
//   codes become bf16 by a magic-number OR and one subtraction per two
//   codes, W8 codes by integer conversion: raw codes, small integers exact
//   in bf16.
//   64-row tile: the block dequantizes each stage once to bf16 code · 2^e
//   in shared memory (stage_dequant_mma), where ldmatrix feeds the
//   fragments of the warps' four n-tiles.
//
// Exactness. X holds bf16-exact values; with MXINT X (the serving route)
// the 16 values of a row's group share one exponent, so the 16 products of
// a group are integers (at most 127 x 127) times one power of two and
// their sum (< 2^18 of that power) is exact in the mma's f32 result. In
// the 8-row tile each group's mma starts from a zero accumulator; its
// result times the column's 2^e (exact) is added to the running f32 sum in
// group order. The 64-row tile puts code · 2^e (exact in bf16: at most 8
// significant bits, 2^-127 a subnormal, for e <= 120) in the A operand, so
// its group sums come out scaled and are added as they are, in the same
// order. (Letting the mma accumulate across groups rounds a sum that is
// not exact in f32 unlike an f32 add: it moved outputs of the 256-row
// megakernel by an ulp against its plain version.) Either sum times 2^-mb
// at the end (exact) is the sum of the groups' code · 2^(e - mb)
// products. The K splits are summed in split order by the block that
// completes a column tile (a ticket): outputs are bit-repeatable.
//
// The weight stream: a ring of STAGES stages of 4 groups (64 K) of the
// block's words, exponents and X rows in dynamic shared memory, filled by
// 16-byte cp.async.cg (L2 only: also coherent with X written earlier in the
// same launch, the megakernel's H), padded so that the fragment loads hit
// distinct banks.
//
// Loads of operands that the same launch wrote (the megakernel's H, X·A
// partials and quantized X·A, the split-K partials) go through L2
// (__ldcg): the read-only path and L1 are not coherent with another
// block's writes inside one launch.
#pragma once

#include "mx_common.cuh"

namespace lqer {

constexpr int NTHREADS = 256;
constexpr int STAGES = 4;          // ring depth
constexpr int KST = 64;            // K per stage: 4 groups
constexpr int X_STRIDE = 80;       // bf16 per staged X row (64 + pad)
constexpr int XA_RC = 64;          // rank columns per X·A block
constexpr int XA_KCMAX = 128;      // largest K chunk of an X·A block
constexpr int RCH = 64;            // rank columns per correction chunk

template <int MTILE_, int WN_, int WM_>
struct TileCfg {
  static constexpr int MTILE = MTILE_;            // rows of X per block
  static constexpr int WN = WN_, WM = WM_;        // warps along N and M
  static constexpr int TN = 32 * WN_;             // columns per block
  static constexpr int NT = MTILE_ / (8 * WM_);   // 8-row n-tiles per warp
  static_assert(WN_ * WM_ * 32 == NTHREADS, "8 warps");
};
using TileDecode = TileCfg<8, 8, 1>;
using TilePrefill = TileCfg<64, 4, 2>;

// Shared memory of one ring stage and of the ring (bytes), per tile and
// code width (MB 3: W4, 7: W8).
template <class C, int MB>
struct Ring {
  static constexpr int PER = MB == 3 ? 8 : 4;      // codes per word
  static constexpr int WPG = 16 / PER;              // words per group
  static constexpr int WROWS = 4 * WPG;             // word rows per stage
  static constexpr int W_STRIDE = C::TN + 8;        // words per row
  static constexpr int W_BYTES = WROWS * W_STRIDE * 4;
  static constexpr int E_BYTES = 4 * C::TN;
  // bf16 per staged X row: 64 + pad, so that the fragment loads (8-row
  // tile) or ldmatrix rows (64-row tile) hit distinct banks
  static constexpr int X_LD = C::NT == 1 ? X_STRIDE : KST + 8;
  static constexpr int X_BYTES = C::MTILE * X_LD * 2;
  static constexpr int STAGE = W_BYTES + E_BYTES + X_BYTES;
  // the 64-row tile's stage dequantized to bf16, (TN, KST + 8) in the
  // mma row order of its columns (one buffer, after the ring)
  static constexpr int WD_LD = KST + 8;
  static constexpr int WD_BYTES = C::NT == 1 ? 0 : C::TN * WD_LD * 2;
  static constexpr int BYTES = STAGES * STAGE + WD_BYTES;
};

template <bool COH, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (COH) return __ldcg(p);
  else return __ldg(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A count another block raises (after its writes, __threadfence) reaching
// target; then this block may read those writes through L2.
__device__ __forceinline__ void wait_count(int* flag, int target) {
  if (threadIdx.x == 0) {
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    while (atomicAdd(flag, 0) < target) {
      __nanosleep(64);
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t - t0 > 2000000000ull) __trap();   // 2 s: a count that never
    }                                           // comes ends the launch
    __threadfence();
  }
  __syncthreads();
}

// Raise the count at flag by one after every thread's writes are visible.
__device__ __forceinline__ void signal_count(int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(flag, 1);
}

// D = A·B over one k16 step, from a zero accumulator.
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// ldmatrix .x4: four 8x8 bf16 matrices, lane l giving the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 h = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two W4 codes (nibbles at bits 0..3 and 16..19 of v, two's complement) as
// a bf16x2 of their values: 0x4300 | (nibble ^ 8) is 128 + code + 8, exact;
// the mask and the xor are one lop3.
__device__ __forceinline__ uint32_t w4_pair(uint32_t v) {
  uint32_t t;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;"   // (v & mask) ^ magic
      : "=r"(t) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  const uint32_t b136 = 0x43084308u;     // bf16x2 (136, 136)
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                             *reinterpret_cast<const __nv_bfloat162*>(&b136));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two W4 codes as bf16x2 from b, whose bytes 0 and 2 hold (nibble ^ 8) in
// their low 4 bits (the other bits of those bytes zero; bytes 1 and 3
// anything): 0x4300 | (nibble ^ 8) is 128 + code + 8, exact.
__device__ __forceinline__ uint32_t w4_magic_sub(uint32_t b) {
  uint32_t t;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;"   // (b & mask) | magic
      : "=r"(t) : "r"(b), "r"(0x000F000Fu), "r"(0x43004300u));
  const uint32_t b136 = 0x43084308u;     // bf16x2 (136, 136)
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                             *reinterpret_cast<const __nv_bfloat162*>(&b136));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two W8 codes (the bytes of w at bit offsets lo and hi, two's
// complement) as a bf16x2.
__device__ __forceinline__ uint32_t w8_pair(uint32_t w, int lo, int hi) {
  const float a = (float)((int)(w << (24 - lo)) >> 24);
  const float b = (float)((int)(w << (24 - hi)) >> 24);
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^e of the 4 columns whose int8 exponents e are the bytes of ev, from
// the bits: (e + 127) << 23, or 2^-127's subnormal bits at e = -127 (the
// quantizer's clamp). The mainloop leaves out each group's common 2^-mb
// and multiplies its sums by it at the end: a power of two, so the f32
// sums round alike (both scalings exact in f32's normal range).
__device__ __forceinline__ void col_scales(uint32_t ev, float (&sc)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    sc[c] = __int_as_float(
        max(((int)(int8_t)(ev >> (8 * c)) + 127) << 23, 0x00400000));
}

// Accumulator of one thread: acc[nt][t][j] for n-tile nt, mma tile t:
// j 0, 1: column 4 gid + 2 t, rows 2 q, 2 q + 1 of the n-tile;
// j 2, 3: column 4 gid + 2 t + 1, the same rows.
template <class C>
using Acc = float[C::NT][2][4];

template <class C>
__device__ __forceinline__ void acc_zero(Acc<C>& acc) {
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][t][j] = 0.f;
}

// Row of the block tile (0..MTILE-1) of acc[nt][.][j], and column of the
// block tile (0..TN-1) of acc[.][t][j].
template <class C>
__device__ __forceinline__ int frag_row(int nt, int j) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / C::WN) * C::NT * 8 + nt * 8 + 2 * (lane % 4) + (j & 1);
}
template <class C>
__device__ __forceinline__ int frag_col4() {   // first of the 4 columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % C::WN) * 32 + 4 * (lane / 4);
}

// The 64-row tile's work on one landed stage of ng (<= 4) groups: the
// block dequantizes the stage's words to bf16 code · 2^e (exact: at most 8
// significant bits, 2^e >= 2^-127 a bf16 subnormal at the quantizer's
// clamp; e <= 120) into wd, its rows in the mma row order of the columns
// (frag_col4: a warp's column 4 a + 2 t + b is row 16 t + a + 8 b of its
// 32), then each warp runs its 32 columns x 32 rows as ldmatrix-fed
// m16n8k16 mmas, one zero-started mma a group whose sum is added to acc.
// The group's common 2^-mb is left to the end of the mainloop.
template <class C, int MB>
__device__ __forceinline__ void stage_dequant_mma(
    const uint32_t* ws, const int8_t* es, const __nv_bfloat16* xs, char* wdb,
    int ng, Acc<C>& acc) {
  using Rg = Ring<C, MB>;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  __nv_bfloat16* wd = reinterpret_cast<__nv_bfloat16*>(wdb);
  // dequantize: thread t takes words t, t + 256, ... of the stage's rows
  for (int i = t; i < ng * Rg::WPG * C::TN; i += NTHREADS) {
    const int r = i / C::TN, col = i % C::TN;
    const int g = r / Rg::WPG;                      // group in the stage
    const int k0 = 16 * g + Rg::PER * (r % Rg::WPG);   // its first k
    const uint32_t w = ws[r * Rg::W_STRIDE + col];
    const int e = (int)es[g * C::TN + col];
    const uint32_t s2 = (uint32_t)max((e + 127) << 7, 0x0040) * 0x00010001u;
    uint32_t v[Rg::PER / 2];   // bf16x2 of codes (k, k + 1)
    if constexpr (MB == 3) {
      const uint32_t f = w ^ 0x88888888u;           // nibble + 8
      const uint32_t lo = f & 0x0F0F0F0Fu, hi = (f >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j of lo (code 2j) into bytes 0 and 1, of hi (code 2j + 1)
        // into bytes 2 and 3
        const uint32_t b = __byte_perm(lo, hi, j | (j << 4) | ((4 + j) << 8) |
                                                   ((4 + j) << 12));
        v[j] = bf16x2_mul(w4_magic_sub(b), s2);
      }
    } else {
      v[0] = bf16x2_mul(w8_pair(w, 0, 8), s2);
      v[1] = bf16x2_mul(w8_pair(w, 16, 24), s2);
    }
    // the column's mma row within its warp's 32
    const int wc = col % 32;
    const int row = col - wc + 16 * ((wc % 4) / 2) + wc / 4 + 8 * (wc % 2);
    __nv_bfloat16* dst = wd + row * Rg::WD_LD + k0;
    if constexpr (MB == 3)
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  }
  __syncthreads();
  const int wn = warp % C::WN, wm = warp / C::WN;
  for (int gi = 0; gi < ng; ++gi) {
    uint32_t a[2][4];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
      ldmatrix_x4(a[tt], wd + (wn * 32 + 16 * tt + (lane & 7) + 8 * ((lane >> 3) & 1))
                                 * Rg::WD_LD + 16 * gi + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, xs + (wm * C::NT * 8 + 16 * np + (lane & 7) + 8 * (lane >> 4))
                          * Rg::X_LD + 16 * gi + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the group's exact sum, added to the running f32 sum with the
          // IEEE rounding of the 8-row tile's (the mma's own accumulation
          // rounds otherwise where a sum is not exact in f32)
          float d[4];
          mma_bf16_zero(d, a[tt], b[2 * h], b[2 * h + 1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[2 * np + h][tt][j] += d[j];
        }
    }
  }
}

// The block's part of X times the packed weight (K/per, N) over groups
// [g_begin, g_end): rows m0.. (M rows valid) of x (row stride K), columns
// n0.. (N valid) into acc (zeroed here). smem: Ring<C, MB>::BYTES, free on
// return.
template <class C, int MB>
__device__ void w_mainloop(const __nv_bfloat16* x, int M, int K, int m0,
                           const int* __restrict__ words,
                           const int8_t* __restrict__ exps, int N, int n0,
                           int g_begin, int g_end, char* smem, Acc<C>& acc,
                           int* x_ready = nullptr, int x_target = 0) {
  using Rg = Ring<C, MB>;
  const int t = threadIdx.x, lane = t % 32, gid = lane / 4, q = lane % 4;
  const int wcol = frag_col4<C>();
  const int xrow0 = (t / 32 / C::WN) * C::NT * 8 + gid;
  const int nst = (g_end - g_begin + 3) / 4;
  acc_zero<C>(acc);
  __syncthreads();   // the block's previous use of shared memory is done

  auto load_w = [&](int st) {   // the stage's words and exponents
    char* base = smem + (st % STAGES) * Rg::STAGE;
    const int g0 = g_begin + 4 * st, ng = min(4, g_end - g0);
    uint32_t* ws = reinterpret_cast<uint32_t*>(base);
    constexpr int WCH = C::TN / 4;                  // 16-byte chunks a row
    for (int c = t; c < ng * Rg::WPG * WCH; c += NTHREADS) {
      const int r = c / WCH, n = n0 + 4 * (c % WCH);
      cp_async16(ws + r * Rg::W_STRIDE + 4 * (c % WCH),
                 words + (size_t)(g0 * Rg::WPG + r) * N + min(n, N - 4),
                 n < N);
    }
    int8_t* es = reinterpret_cast<int8_t*>(base + Rg::W_BYTES);
    constexpr int ECH = C::TN / 16;
    for (int c = t; c < ng * ECH; c += NTHREADS) {
      const int r = c / ECH, n = n0 + 16 * (c % ECH);
      cp_async16(es + r * C::TN + 16 * (c % ECH),
                 exps + (size_t)(g0 + r) * N + min(n, N - 16), n < N);
    }
  };
  auto load_x = [&](int st) {   // the stage's rows of X
    char* base = smem + (st % STAGES) * Rg::STAGE;
    const int g0 = g_begin + 4 * st, ng = min(4, g_end - g0);
    __nv_bfloat16* xs =
        reinterpret_cast<__nv_bfloat16*>(base + Rg::W_BYTES + Rg::E_BYTES);
    const int xch = 2 * ng;                         // 16-byte chunks a row
    for (int c = t; c < C::MTILE * xch; c += NTHREADS) {
      const int r = c / xch, row = m0 + r;
      cp_async16(xs + r * Rg::X_LD + 8 * (c % xch),
                 x + (size_t)min(row, M - 1) * K + 16 * g0 + 8 * (c % xch),
                 row < M);
    }
  };

  // the first stages' weights are in flight before X is waited for (X
  // written by a launch that runs beside this one: x_ready reaching
  // x_target); commit group st holds stage st's X (group 0 also the
  // weights of the first stages)
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < nst) load_w(st);
  if (x_ready != nullptr) wait_count(x_ready, x_target);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_x(st);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage st landed; stage st - 1's slot is free
    if (st + STAGES - 1 < nst) {
      load_w(st + STAGES - 1);
      load_x(st + STAGES - 1);
    }
    cp_async_commit();
    const char* base = smem + (st % STAGES) * Rg::STAGE;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(base);
    const int8_t* es = reinterpret_cast<const int8_t*>(base + Rg::W_BYTES);
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        base + Rg::W_BYTES + Rg::E_BYTES);
    const int ng = min(4, g_end - g_begin - 4 * st);
    if constexpr (C::NT > 1) {
      stage_dequant_mma<C, MB>(ws, es, xs, smem + STAGES * Rg::STAGE, ng, acc);
      continue;
    }
    // one 16-group: its words, scales, codes, X fragments and mmas
    auto group = [&](int gi) {
      // the words of columns wcol..wcol+3: W4 word 2 gi + q / 2 (k 8 (q / 2)
      // .. + 7 of the group), W8 word 4 gi + q (k 4 q .. 4 q + 3)
      const int wr = MB == 3 ? 2 * gi + q / 2 : 4 * gi + q;
      const uint4 wv = *reinterpret_cast<const uint4*>(ws + wr * Rg::W_STRIDE + wcol);
      const uint32_t ev = *reinterpret_cast<const uint32_t*>(es + gi * C::TN + wcol);
      const uint32_t w[4] = {wv.x, wv.y, wv.z, wv.w};
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (MB == 3) {
          // slots (2q, 2q+1) <- k (k0, k0 + 4), slots (2q+8, 2q+9) <-
          // (k0 + 1, k0 + 5), k0 = 8 (q / 2) + 2 (q % 2)
          const uint32_t wq = w[c] >> (8 * (q & 1));
          lo[c] = w4_pair(wq);
          hi[c] = w4_pair(wq >> 4);
        } else {
          // slots (2q, 2q+1) <- k (4q, 4q + 2), (2q+8, 2q+9) <- (4q+1, 4q+3)
          lo[c] = w8_pair(w[c], 0, 16);
          hi[c] = w8_pair(w[c], 8, 24);
        }
      }
      // the B fragments of n-tile nt: X's k slots as the codes'
      auto x_frag = [&](int nt, uint32_t& b0, uint32_t& b1) {
        const __nv_bfloat16* xr = xs + (xrow0 + nt * 8) * Rg::X_LD + 16 * gi;
        if constexpr (MB == 3) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xr + 8 * (q / 2));
          const uint32_t p = (q & 1) ? xv.y : xv.x, p4 = (q & 1) ? xv.w : xv.z;
          b0 = __byte_perm(p, p4, 0x5410);
          b1 = __byte_perm(p, p4, 0x7632);
        } else {
          const uint2 xv = *reinterpret_cast<const uint2*>(xr + 4 * q);
          b0 = __byte_perm(xv.x, xv.y, 0x5410);
          b1 = __byte_perm(xv.x, xv.y, 0x7632);
        }
      };
      float sc[4];
      col_scales(ev, sc);
      const uint32_t a0[4] = {lo[0], lo[1], hi[0], hi[1]};
      const uint32_t a1[4] = {lo[2], lo[3], hi[2], hi[3]};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        uint32_t b0, b1;
        x_frag(nt, b0, b1);
        float d[4];
        mma_bf16_zero(d, a0, b0, b1);
        acc[nt][0][0] = fmaf(d[0], sc[0], acc[nt][0][0]);
        acc[nt][0][1] = fmaf(d[1], sc[0], acc[nt][0][1]);
        acc[nt][0][2] = fmaf(d[2], sc[1], acc[nt][0][2]);
        acc[nt][0][3] = fmaf(d[3], sc[1], acc[nt][0][3]);
        mma_bf16_zero(d, a1, b0, b1);
        acc[nt][1][0] = fmaf(d[0], sc[2], acc[nt][1][0]);
        acc[nt][1][1] = fmaf(d[1], sc[2], acc[nt][1][1]);
        acc[nt][1][2] = fmaf(d[2], sc[3], acc[nt][1][2]);
        acc[nt][1][3] = fmaf(d[3], sc[3], acc[nt][1][3]);
      }
    };
    if (ng == 4) {   // a whole stage: the four groups' loads and
#pragma unroll       // conversions interleave
      for (int gi = 0; gi < 4; ++gi) group(gi);
    } else {
      for (int gi = 0; gi < ng; ++gi) group(gi);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free
  const float unit = exp2_int(-MB);   // the groups' common 2^-mb
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][t2][j] *= unit;
}

// Store acc as one split's partial of the tile at rows m0.., columns n0..
// of part (rows x N f32, rows >= the tile's).
template <class C>
__device__ __forceinline__ void store_partial(const Acc<C>& acc, float* part,
                                              int N, int m0, int n0) {
  const int n = n0 + frag_col4<C>();
  if (n >= N) return;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = m0 + frag_row<C>(nt, j);
      __stcg(reinterpret_cast<float4*>(part + (size_t)row * N + n),
             make_float4(acc[nt][0][j], acc[nt][0][j + 2], acc[nt][1][j],
                         acc[nt][1][j + 2]));
    }
}

// acc = the sum, in split order, of `splits` partials at part, part +
// stride, ... (the same tile).
template <class C>
__device__ __forceinline__ void sum_partials(Acc<C>& acc, const float* part,
                                             size_t stride, int splits, int N,
                                             int m0, int n0) {
  const int n = n0 + frag_col4<C>();
  acc_zero<C>(acc);
  if (n >= N) return;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* p = part + (size_t)(m0 + frag_row<C>(nt, j)) * N + n;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      // four splits' loads in flight, then their sums in split order
      for (int s = 0; s < splits; s += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (s + u < splits)
            v[u] = __ldcg(reinterpret_cast<const float4*>(p + (s + u) * stride));
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (s + u < splits) {
            a.x += v[u].x; a.y += v[u].y; a.z += v[u].z; a.w += v[u].w;
          }
      }
      acc[nt][0][j] = a.x;
      acc[nt][0][j + 2] = a.y;
      acc[nt][1][j] = a.z;
      acc[nt][1][j + 2] = a.w;
    }
}

// The split-K ticket: every block of a tile calls it once after storing
// its partial (all threads); true in the last of `count` blocks, which
// then sees every partial and resets the counter for the next launch.
__device__ __forceinline__ bool last_of_tile(int* counter, int count) {
  __shared__ int ticket;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    ticket = atomicAdd(counter, 1);
    if (ticket == count - 1) *counter = 0;
  }
  __syncthreads();
  const bool last = ticket == count - 1;
  if (last) __threadfence();
  return last;
}

// Quantize v per 16 columns: the group is this half-warp (every lane of
// the warp must call it). mb < 0: no quantizer.
__device__ __forceinline__ float quantize_half_warp(float v, int mb) {
  if (mb < 0) return v;
  float bmax = fabsf(v);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
  return mx_value(v, group_exponent(bmax), mb);
}

// The thread's 4 values of one row (columns 4 gid .. + 3 of a warp's 32)
// quantized per 16 columns: the group is 4 lanes (lane bits 2, 3; every
// lane of the warp calls it). mb < 0: no quantizer.
__device__ __forceinline__ void quantize_quad(float (&v)[4], int mb) {
  if (mb < 0) return;
  float bmax = fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                     fmaxf(fabsf(v[2]), fabsf(v[3])));
  bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 4));
  bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 8));
  const int e = group_exponent(bmax);
  if (e <= MX_GROUP_EMAX) {
    const MxGroup g = mx_group(e, mb);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = mx_group_value(v[c], g);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = mx_value(v[c], e, mb);
  }
}

// The thread's fragment values of row j (0, 1 within the n-tile) of
// n-tile nt, in column order.
template <class C>
__device__ __forceinline__ void frag_get(const Acc<C>& a, int nt, int j,
                                         float (&v)[4]) {
  v[0] = a[nt][0][j];
  v[1] = a[nt][0][j + 2];
  v[2] = a[nt][1][j];
  v[3] = a[nt][1][j + 2];
}
template <class C>
__device__ __forceinline__ void frag_set(Acc<C>& a, int nt, int j,
                                         const float (&v)[4]) {
  a[nt][0][j] = v[0];
  a[nt][0][j + 2] = v[1];
  a[nt][1][j] = v[2];
  a[nt][1][j + 2] = v[3];
}

// y += q_out(xa · B) for the tile's fragments: xa (rows x xs_ld) f32 holds
// the quantized, bf16-rounded X·A rows (columns [off, off + R)); B (R, N)
// bf16. Each output sums in rank order; the rank walks in chunks of RCH
// columns whose X·A rows and B rows are staged in shared memory, the next
// chunk's B (cp.async, two buffers) and X·A values (registers) in flight
// while one is summed; then q_out per 16 columns. Every thread of the
// block calls it.
template <class C>
struct CorrSmem {
  static constexpr int LD = RCH + 4;               // floats per X·A row
  static constexpr int XA_BYTES = C::MTILE * LD * 4;
  static constexpr int B_BYTES = RCH * C::TN * 2;  // one chunk of B
  static constexpr int BYTES = XA_BYTES + 2 * B_BYTES;
  static constexpr int XPT = (C::MTILE * RCH + NTHREADS - 1) / NTHREADS;
};

template <class C, bool COH>
__device__ void add_correction(Acc<C>& y, const float* xa, int xs_ld,
                               int off, int R, int M,
                               const __nv_bfloat16* __restrict__ bmat, int N,
                               int m0, int n0, int out_mb, char* smem) {
  using CS = CorrSmem<C>;
  constexpr int LD = CS::LD;
  float* xs = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x, col4 = frag_col4<C>();
  float xv[CS::XPT];
  auto fetch = [&](int r0, int buf) {   // chunk r0's B and X·A in flight
    const int rn = min(RCH, R - r0);
    __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(
        smem + CS::XA_BYTES + buf * CS::B_BYTES);
    constexpr int BCH = C::TN / 8;                 // 16-byte chunks a row
    for (int i = t; i < rn * BCH; i += NTHREADS) {
      const int r = i / BCH, nn = n0 + 8 * (i % BCH);
      cp_async16(bs + r * C::TN + 8 * (i % BCH),
                 bmat + (size_t)(r0 + r) * N + min(nn, N - 8), nn < N);
    }
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < CS::XPT; ++u) {
      const int i = t + u * NTHREADS, m = i / rn, row = m0 + m;
      xv[u] = (i < C::MTILE * rn && row < M)
          ? ld<COH>(xa + (size_t)row * xs_ld + off + r0 + i % rn) : 0.f;
    }
  };
  Acc<C> corr;
  acc_zero<C>(corr);
  fetch(0, 0);
  for (int r0 = 0, buf = 0; r0 < R; r0 += RCH, buf ^= 1) {
    const int rn = min(RCH, R - r0);
    __syncthreads();   // the previous chunk (or the ring) is consumed
#pragma unroll
    for (int u = 0; u < CS::XPT; ++u) {
      const int i = t + u * NTHREADS;
      if (i < C::MTILE * rn) xs[i / rn * LD + i % rn] = xv[u];
    }
    if (r0 + RCH < R) {
      fetch(r0 + RCH, buf ^ 1);
      cp_async_wait<1>();   // this chunk's B landed, the next in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(
        smem + CS::XA_BYTES + buf * CS::B_BYTES);
#pragma unroll 4
    for (int r = 0; r < rn; ++r) {
      const uint2 bv = *reinterpret_cast<const uint2*>(bs + r * C::TN + col4);
      const float b[4] = {bf16_lo(bv.x), bf16_hi(bv.x), bf16_lo(bv.y),
                          bf16_hi(bv.y)};
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float a = xs[frag_row<C>(nt, j) * LD + r];
          corr[nt][0][j] = fmaf(a, b[0], corr[nt][0][j]);
          corr[nt][0][j + 2] = fmaf(a, b[1], corr[nt][0][j + 2]);
          corr[nt][1][j] = fmaf(a, b[2], corr[nt][1][j]);
          corr[nt][1][j + 2] = fmaf(a, b[3], corr[nt][1][j + 2]);
        }
    }
  }
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[4], u[4];
      frag_get<C>(corr, nt, j, v);
      quantize_quad(v, out_mb);
      frag_get<C>(y, nt, j, u);
#pragma unroll
      for (int c = 0; c < 4; ++c) u[c] += v[c];
      frag_set<C>(y, nt, j, u);
    }
}

// y += bias (N f32) per column.
template <class C>
__device__ __forceinline__ void add_bias(Acc<C>& y, const float* bias, int N,
                                         int n0) {
  const int n = n0 + frag_col4<C>();
  if (bias == nullptr || n >= N) return;
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      y[nt][0][j] += b.x;
      y[nt][0][j + 2] += b.y;
      y[nt][1][j] += b.z;
      y[nt][1][j + 2] += b.w;
    }
}

// out (M, N) f32 = y, rows < M.
template <class C>
__device__ __forceinline__ void store_out(const Acc<C>& y, float* out, int M,
                                          int N, int m0, int n0) {
  const int n = n0 + frag_col4<C>();
  if (n >= N) return;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = m0 + frag_row<C>(nt, j);
      if (row < M)
        *reinterpret_cast<float4*>(out + (size_t)row * N + n) =
            make_float4(y[nt][0][j], y[nt][0][j + 2], y[nt][1][j],
                        y[nt][1][j + 2]);
    }
}

// ---- X·A in f64 ----------------------------------------------------------

// The X·A sums: the accumulator of one K chunk's partial and the type of
// the partials' scratch and of their cross-chunk sum, both f64.
// tools/bench_xa_precision.py builds f32 variants with -D to time them and
// count the q_xa roundings they move.
#ifndef LQER_XA_CHUNK_T
#define LQER_XA_CHUNK_T double
#endif
#ifndef LQER_XA_SUM_T
#define LQER_XA_SUM_T double
#endif
using xa_chunk_t = LQER_XA_CHUNK_T;
using xa_sum_t = LQER_XA_SUM_T;

struct XaSmem {
  float xr[8][XA_KCMAX];                 // X rows of the chunk, f32
  union {
    struct {
      xa_chunk_t xs[XA_KCMAX][8];        // the same, as the sum's type
      __align__(16) __nv_bfloat16 as[XA_KCMAX * XA_RC];   // A's rows
    } op;
    xa_chunk_t red[8][NTHREADS];         // per-thread partials, at the end
  } u;
};

// The in-kernel activation quantizer: the 16 raw f32 values v[0..15] of one
// group along K quantized per the group's absmax at x_mb mantissa bits and
// rounded to bf16 (exact on the grid of widths <= 9; a passthrough value
// |v| <= 1e-8 rounds as the separate quantizer's bf16 output does), in
// place.
__device__ __forceinline__ void quantize_x_group(float* v, int x_mb) {
  float bmax = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) bmax = fmaxf(bmax, fabsf(v[j]));
  const int e = group_exponent(bmax);
  if (e <= MX_GROUP_EMAX) {   // mx_value's bits in seven operations
    const MxGroup g = mx_group(e, x_mb);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = bf16_round(mx_group_value(v[j], g));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = bf16_round(mx_value(v[j], e, x_mb));
  }
}

// The X of an X·A block: rows mt * 8.. (M valid) of x (M, K) bf16, or,
// with xraw, of the raw f32 activation, quantized here per 16 along K at
// x_mb mantissa bits and, where xq is not null, written to xq (M, K) bf16.
struct XaInput {
  const __nv_bfloat16* x;
  const float* xraw;
  __nv_bfloat16* xq;
  int x_mb;
};

// One X·A chunk [kb, kb + kn) (kn <= XA_KCMAX, a multiple of 16) in flight
// in registers: thread t holds X row t / 32, k 4 (t % 32) .. + 3 (raw f32
// or bf16) and up to four 16-byte pieces of A's rows (W % 8 == 0 and the
// chunk's width a multiple of 8; otherwise A is loaded when it is stored).
struct XaRegs {
  float4 xf;
  uint2 xb;
  uint4 a[XA_KCMAX * XA_RC / 8 / NTHREADS];
};

template <bool COH>
__device__ __forceinline__ void xa_fetch(const XaInput& in,
                                         const __nv_bfloat16* __restrict__ a,
                                         int M, int K, int W, int mt, int kb,
                                         int kn, int c0, int cw, XaRegs& r) {
  const int t = threadIdx.x, row = mt * 8 + t / 32, kk = 4 * (t % 32);
  const bool ok = row < M && kk < kn;
  const size_t at = (size_t)row * K + kb + kk;
  if (in.xraw != nullptr)
    r.xf = ok ? __ldg(reinterpret_cast<const float4*>(in.xraw + at))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  else
    r.xb = ok ? ld<COH>(reinterpret_cast<const uint2*>(in.x + at))
              : make_uint2(0u, 0u);
  if (W > 0 && W % 8 == 0 && cw % 8 == 0) {
    const int vr = cw / 8;
#pragma unroll
    for (int u = 0; u < XA_KCMAX * XA_RC / 8 / NTHREADS; ++u) {
      const int i = t + u * NTHREADS;
      if (i < kn * vr)
        r.a[u] = __ldg(reinterpret_cast<const uint4*>(
            a + (size_t)(kb + i / vr) * W + c0) + i % vr);
    }
  }
}

// Store the fetched chunk into sm.xr (f32; with raw X quantized per 16
// along K at x_mb mantissa bits and, where in.xq is not null, written to
// it as bf16) and sm.u.op.as (row stride cp). Ends at a barrier.
__device__ __forceinline__ void xa_store(const XaInput& in,
                                         const __nv_bfloat16* __restrict__ a,
                                         int M, int K, int W, int mt, int kb,
                                         int kn, int c0, int cw, int cp,
                                         const XaRegs& r, XaSmem& sm) {
  const int t = threadIdx.x, m = t / 32, kk = 4 * (t % 32);
  if (in.xraw != nullptr) {
    *reinterpret_cast<float4*>(&sm.xr[m][kk]) = r.xf;
  } else {
    sm.xr[m][kk] = bf16_lo(r.xb.x);
    sm.xr[m][kk + 1] = bf16_hi(r.xb.x);
    sm.xr[m][kk + 2] = bf16_lo(r.xb.y);
    sm.xr[m][kk + 3] = bf16_hi(r.xb.y);
  }
  if (W > 0) {
    if (W % 8 == 0 && cw % 8 == 0) {
      const int vr = cw / 8;
#pragma unroll
      for (int u = 0; u < XA_KCMAX * XA_RC / 8 / NTHREADS; ++u) {
        const int i = t + u * NTHREADS;
        if (i < kn * vr)
          *reinterpret_cast<uint4*>(sm.u.op.as + (i / vr) * cp + 8 * (i % vr)) = r.a[u];
      }
    } else {
      const __nv_bfloat16* src = a + (size_t)kb * W + c0;
      for (int i = t; i < kn * cw; i += NTHREADS)
        sm.u.op.as[(i / cw) * cp + i % cw] = src[(size_t)(i / cw) * W + i % cw];
    }
  }
  __syncthreads();
  if (in.xraw == nullptr) return;
  constexpr int GK = XA_KCMAX / 16;   // 16-groups per staged row
  for (int gi = t; gi < 8 * GK; gi += NTHREADS) {
    const int mm = gi / GK, g0 = gi % GK * 16, row = mt * 8 + mm;
    quantize_x_group(&sm.xr[mm][g0], in.x_mb);
    if (in.xq != nullptr && row < M && g0 < kn)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        in.xq[(size_t)row * K + kb + g0 + j] = __float2bfloat16_rn(sm.xr[mm][g0 + j]);
  }
  __syncthreads();
}

// X·A of the 8 rows of X over [k0, k1) and rank columns [c0, c0 + cw) of
// a (K, W) bf16 (W == 0: X is only staged, quantized and written):
// part[((mt * KS + s) * 8 + m) * W + c] in xa_sum_t. The range walks in
// chunks of XA_KCMAX, the next chunk's loads in flight while one is
// summed; each thread sums (8 rows, one column) over every nj-th k in the
// sum's type (the products of bf16-exact values are exact; an f64 sum of
// them, rounded to f32 once after the ranges, gives the X·A value q_xa
// sees whatever the order: an f32 sum can land an ulp off, on a q_xa
// rounding tie, and move a whole output row); the nj partials of a column
// are added in a fixed order.
template <bool COH>
__device__ void xa_tile(const XaInput& in, const __nv_bfloat16* __restrict__ a,
                        xa_sum_t* part, int M, int K, int W, int mt, int s,
                        int KS, int k0, int k1, int c0, XaSmem& sm) {
  const int t = threadIdx.x;
  const int cw = W > 0 ? min(XA_RC, W - c0) : 0;
  int cp = 1;
  while (cp < cw) cp *= 2;                 // columns, a power of two
  const int nj = NTHREADS / cp;            // k lanes
  const int c = t % cp, j = t / cp;
  xa_chunk_t acc[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m] = 0;
  XaRegs r;
  xa_fetch<COH>(in, a, M, K, W, mt, k0, min(XA_KCMAX, k1 - k0), c0, cw, r);
  for (int kb = k0; kb < k1; kb += XA_KCMAX) {
    const int kn = min(XA_KCMAX, k1 - kb);
    __syncthreads();   // the previous chunk is consumed
    xa_store(in, a, M, K, W, mt, kb, kn, c0, cw, cp, r, sm);
    if (kb + XA_KCMAX < k1)
      xa_fetch<COH>(in, a, M, K, W, mt, kb + XA_KCMAX,
                    min(XA_KCMAX, k1 - kb - XA_KCMAX), c0, cw, r);
    if (W == 0) continue;
    for (int i = t; i < 8 * kn; i += NTHREADS)
      sm.u.op.xs[i % kn][i / kn] = (xa_chunk_t)sm.xr[i / kn][i % kn];
    __syncthreads();
    if (c < cw)
      for (int kk = j; kk < kn; kk += nj) {
        const xa_chunk_t av = (xa_chunk_t)__bfloat162float(sm.u.op.as[kk * cp + c]);
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m] += sm.u.op.xs[kk][m] * av;
      }
  }
  if (W == 0) return;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 8; ++m) sm.u.red[m][t] = acc[m];
  __syncthreads();
  for (int i = t; i < 8 * cw; i += NTHREADS) {
    const int m = i / cw, cc = i % cw;
    xa_chunk_t v = 0;
    for (int jj = 0; jj < nj; ++jj) v += sm.u.red[m][jj * cp + cc];
    part[(((size_t)mt * KS + s) * 8 + m) * W + c0 + cc] = (xa_sum_t)v;
  }
}

// The f32 value of X·A at (row mt * 8 + m, column c): the partials of the
// KS chunks summed in chunk order, rounded to f32 once.
__device__ __forceinline__ float xa_value(const xa_sum_t* part, int W,
                                          int mt, int KS, int m, int c) {
  const xa_sum_t* p = part + ((size_t)mt * KS * 8 + m) * W + c;
  xa_sum_t v = 0;
  for (int s = 0; s < KS; s += 8) {   // eight loads in flight, summed in order
    xa_sum_t u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s + j < KS) u[j] = __ldcg(p + (size_t)(s + j) * 8 * W);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (s + j < KS) v += u[j];
  }
  return (float)v;
}

// The finishing block of an X·A chunk (its KS ranges' partials done): the
// 8 rows x cw columns [c0, c0 + cw) of X·A summed over the ranges in
// order, rounded to f32 once, quantized per 16 columns (a half-warp each;
// cw % 16 == 0; xa_mb < 0: no quantizer) and rounded to bf16, into xa at
// row stride ld, column off + c. Every thread of the block calls it.
__device__ __forceinline__ void xa_finish16(const xa_sum_t* part, float* xa,
                                            int ld, int off, int W, int mt,
                                            int KS, int c0, int cw,
                                            int xa_mb) {
  for (int base = 0; base < 8 * cw; base += NTHREADS) {
    const int i = base + threadIdx.x, m = min(i / cw, 7), c = c0 + i % cw;
    const float v = i < 8 * cw ? xa_value(part, W, mt, KS, m, c) : 0.f;
    const float q = bf16_round(quantize_half_warp(v, xa_mb));
    if (i < 8 * cw) xa[(size_t)(mt * 8 + m) * ld + off + c] = q;
  }
}

}  // namespace lqer
