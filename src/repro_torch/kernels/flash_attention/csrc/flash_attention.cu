// Flash attention for sm_90a: the forward, dQ and dK/dV kernels, in CUDA
// C++ with f32 accumulation, bound to Python through ctypes
// (src/repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_fwd_pallas     (_flash_fwd_kernel)     -> flash_fwd_kernel,
//                                                             flash_fwd_bf16_kernel
//   flash_attention_bwd_dq_pallas  (_flash_bwd_dq_kernel)  -> flash_dq_kernel,
//                                                             flash_dq_bf16_kernel
//   flash_attention_bwd_dkv_pallas (_flash_bwd_dkv_kernel) -> flash_dkv_kernel
//
// What they compute is the Pallas kernels' contract: GQA (query head h reads
// kv head h / G), an optional causal mask, a per-row valid key length kvlen,
// masked scores floored at NEG_INF, P recomputed in the backward from the
// forward's f32 logsumexp as keep ? exp(s - lse) : 0, dS = P (dP - delta)
// with delta = rowsum(dO O) computed outside, and the scale applied where the
// Pallas kernels apply it (on Q before Q K^T in the forward, on Q K^T and on
// the final dQ/dK sums in the backward; the bf16 forward applies it to
// Q K^T, below). Rows with no valid key give O = 0 and zero gradients.
// Nothing is summed across blocks and no atomics are used, so every output
// is the same bits on every run.
//
// Two designs share the file. The bf16 forward and dQ up to D = 128 (the
// LMs' attention) have their own, next; the f32 kernels, bf16 dK/dV and the
// bf16 forward and dQ above D = 128 run the f32 design after it.
//
// The bf16 design (flash_fwd_bf16_kernel, flash_dq_bf16_kernel).
// Bound on the H100: bytes at short sequences, operations at long ones. At
// the LM engine's attention (256 rows of S = 128, 32 query heads on 8, D =
// 128, causal) the forward does 2 S^2 D flops a query head (both products,
// half the square) against about 5 S D bytes (Q read, O written, K and V
// read once for a group of 4 heads): about 50 flops a byte, far below the
// 295 at which bf16 products stop being bound by bytes, so there the bound
// is the 670 MB the forward moves (0.2 ms). At S = 4096 (gemma3's prefill)
// the same ratio is 32 times larger and the products bound it. The choices:
// - Products: mma.sync m16n8k16 bf16, f32 accumulation. Q K^T and dO V^T
//   take their bf16 inputs as they are, one product each, exact. P (the
//   forward) and dS (dQ) are f32 and enter as a bf16 pair, hi = bf16(x) and
//   lo = bf16(x - hi), two products (lo first): about 16 bits of P, where
//   one bf16 P keeps 8 and repro's Pallas kernel and the plain version take
//   P V in f32. The scale is applied to S in f32 after the product, as
//   s scale log2(e) in the exponent (fmaf, exp2f): repro's forward scales Q
//   first, so the two differ by f32 rounding only, and Q keeps no rounded
//   scaled copy (which would take a second product, for its low part).
//   Fragments come through ldmatrix from the bf16 tiles, with .trans where
//   an operand is read along the sequence (V in P V, K in dS K); the
//   accumulator of S over keys 16 j .. + 15 is P's (dS's) A fragment as it
//   stands, with no shuffle.
// - Tiling: 4 warps, 64 query rows a block; each warp owns a 16-row strip
//   and all D output columns (O or dQ in registers, 64 floats a thread at
//   D = 128), so no strip is shared and S is computed once. K/V are swept
//   in 32-key tiles, once per 64 query rows and per query head; small
//   tiles keep registers (168) and shared memory (51 KB forward, 69 KB dQ
//   at D = 128) low enough for three blocks an SM, whose 12 warps hide the
//   latency of the short sweeps that bound the LM engine's shape. dQ takes
//   S, then dP, so only one product's fragments are live at a time, reads
//   its rows' lse and delta from shared memory each tile, and unrolls the
//   products' depth loop by 2, not whole: that fits 168 registers without
//   a spill, and ran faster than the whole unroll did with one.
// - Copies: 16-byte cp.async in a ring of two stages (the next tile in
//   flight while this one is used), bf16 kept as bf16 (half the f32
//   design's shared memory); rows that are not 16-byte aligned are copied
//   element by element through registers. Ragged edges are zero-filled.
//   The output strip goes out through the warp's own rows of the Q tile as
//   16-byte stores, each row's chunks on neighbouring lanes.
// - Dead work is cut at 16-key granularity: a warp whose rows lie past Sq
//   or see no key of a tile does no product, and a 16-key step wholly past
//   kvlen or in the causal future is skipped; a tile whose every score is
//   kept takes a path without mask tests. The blocks of the longest causal
//   sweeps are launched first.
// - Tiers: up to 64 and up to 128 take this design. Above 128 (no
//   architecture of the repo) a warp owning every column would hold 128
//   accumulators besides S, so those keep the f32 design's code.
//
// The f32 design. Bound on the H100: operations. At the ViT's shape (256 images, 6 heads,
// S = 196, D = 64, f32) the forward does 4 S^2 D flops per (image, head)
// for 2 (S D) reads, about 100 flops per byte; the backward pair 14 S^2 D.
// At f32 accuracy on the tensor cores (3xTF32, below: three TF32 operations
// per f32 operation) the forward's bounds by operations and by bytes are
// about equal there.
//
// All three kernels of this design are built for Hopper's tensor cores:
// - Products: mma.sync m16n8k8 TF32 in 3xTF32. Each f32 operand is split as
//   big = tf32(x), small = tf32(x - big), both rounded as cvt.rna rounds
//   (to nearest, ties away; done with two integer operations, which are
//   cheaper than cvt.rna's own sequence on sm_90a), and c += a b is taken as
//   a.small b.big + a.big b.small + a.big b.big with f32 accumulation (the
//   scheme of CUTLASS's OpMultiplyAddFastF32): about f32 accuracy, where one
//   TF32 product keeps three decimal digits and would break the 1e-4
//   tolerance of dQ. bf16 inputs are exact in tf32 (their small part is 0,
//   so those terms are skipped); P, dS and the forward's scaled Q (q scale
//   is not exact in tf32 even for bf16 q) are f32 and always split. Sums
//   that run over a whole sweep leave the tensor core's accumulator after
//   every tile (the forward's O) or fragment (dK, dV) and are added in f32,
//   see flush. wgmma is not used: for tf32 it takes both operands K-major
//   only, and P V, dS K and dS^T Q read V, K and Q along the sequence, which
//   would need transposed copies in shared memory.
// - Blocks of 8 warps (4 above D = 64), each warp a 16-row strip. Forward
//   and dQ: one block per (b, h, 128 query rows), sweeping K/V in 16-key
//   tiles. dK/dV: one block per (b, hk, 128 key rows), K and V staged once,
//   sweeping the G heads of the group and the live 16-row Q tiles, dK and dV
//   in registers throughout. Above D = 64 two warps share a strip, each
//   owning half of the output columns (both take the strip's scores).
// - The forward's online softmax: a thread holds two rows of its strip
//   (g, g + 8); their running max is taken over the 4 lanes of a quad each
//   tile, their sums per lane and over the quad once at the end. Scores are
//   in base 2 (log2(e) folded into Q's scale, exp2f; lse converted back).
//   Each tile's P V is taken in a zeroed accumulator and joins O as
//   O corr + t in f32. Q is scaled and split once per block and read, like
//   K, through ldmatrix. Holding Q's fragments in registers instead (64 a
//   thread at D = 64) left room for one block an SM, not two, and ran
//   slower on the card.
// - The swept tiles are fed by cp.async, double-buffered: the next tile's
//   copies are in flight while the current one is multiplied (16-byte
//   copies when every row is 16-byte aligned, else 4-byte; bf16 is
//   converted to f32 on the way, through registers). Ragged edges are
//   zero-filled by the copy. Every warp reads the swept tile as its B
//   operand, so each thread splits the elements it copied, once, into a big
//   and a small tile, instead of every warp splitting every fragment it
//   loads; the rows a warp owns (its A operand) are split as they are read
//   in the backward, once per block in the forward.
// - Dead work is cut at fragment granularity: a warp whose 16 rows lie past
//   Sq (or whose keys lie past kvlen) does no product, and an 8-wide
//   fragment wholly past kvlen, past Sq or in the causal future is skipped.
//   At S = 196 a second block of 128 rows has live warps of 16, 16, 16, 16
//   and 4 rows, and three idle ones.
//   A tile whose every score is kept takes a path without per-element mask
//   tests; a tile with dead fragments, one with per-fragment tests. A
//   masked score's p is set to 0 explicitly: exp(NEG_INF - m) is 1 on a
//   row that has no kept score yet.
// - Shared memory: K is read both as K^T (the B operand of Q K^T, along D)
//   and as K (the B operand of dS K, along keys), Q and dO likewise, V as V
//   (P V). The depth of P V, dS K (and P^T dO, dS^T Q) is permuted: depth tg
//   is row 2 tg, depth tg + 4 row 2 tg + 1, so the accumulator layout of S
//   (columns 2 tg, 2 tg + 1) is already P's or dS's A fragment (no shuffle,
//   no shared-memory round trip). Rows are DMAX + 4 floats apart: a K^T read
//   (8 rows, 4 columns) hits banks 4 g + tg, a permuted K read (rows
//   2 tg + e, 8 columns) banks 8 tg + g, both 32 distinct, and every
//   address is a lane base plus a constant.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask floor

// Mirrored field for field by kernel.py's ctypes Structure; every field is
// 8 bytes wide so the two layouts cannot drift apart through padding.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;
  void* dq;
  void* dk;
  void* dv;
  float* lse;          // (B, NQ, Sq) contiguous
  const float* delta;  // (B, NQ, Sq) contiguous
  const int* kvlen;    // (B,)
  long long st[8][3];  // element strides (batch, head, seq) of q k v dout o dq dk dv
  long long B, NQ, NKV, Sq, Sk, D, causal;
  double scale;
};

enum { Q = 0, K, V, DOUT, O, DQ, DK, DV };

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ bool keep_score(int qi, int kj, int kvlen, bool causal) {
  return kj < kvlen && (!causal || qi >= kj);
}

// ------------------------------------------------------- tensor-core building blocks

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite value (to nearest,
// ties away from zero): half a tf32 ulp added to the magnitude bits, the 13
// low mantissa bits cleared. Two integer operations, where cvt.rna compiles
// to a longer sequence on sm_90a.
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// N fragment registers of one mma operand. With SPLIT, x = big + small up
// to 2^-22 |x| (3xTF32); without it (bf16 inputs, exact in tf32) small is 0
// and never read.
template <int N, bool SPLIT>
struct Frag {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    if (SPLIT) {
      big[i] = to_tf32(x);
      small[i] = to_tf32(x - __uint_as_float(big[i]));
    } else {
      big[i] = __float_as_uint(x);
    }
  }
  // from a tile split once by split_rows: the big part at x[0], the small
  // at x[soff] (bf16: the value, exact in tf32, at x[0])
  __device__ __forceinline__ void set_pre(int i, const float* x, int soff) {
    big[i] = __float_as_uint(x[0]);
    if (SPLIT) small[i] = __float_as_uint(x[soff]);
  }
};

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the small cross terms first, then big * big, as
// CUTLASS's OpMultiplyAddFastF32 orders them; a term whose small part is 0
// is skipped.
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float c[4], const Frag<4, SA>& a, const Frag<2, SB>& b) {
  if (SA) mma_tf32(c, a.small, b.big);
  if (SB) mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// A partial sum t, taken in a zeroed accumulator, joins a sweep-long sum in
// f32 with round-to-nearest adds. The tensor core's accumulation does not
// round to nearest: kept in its accumulator over a whole sweep (G Sq = 1,332
// queries at chip_smoke.py's causal GQA shape), dV was 0.365 of the 1e-4
// tolerance from its plain version on the card, 0.081 with this flush after
// every fragment. dQ's sweep is Sk keys; it stays at 0.044 without one, so
// dQ keeps its sum in the tensor core. The forward's O is rescaled every
// tile anyway, so it joins each tile's P V as O corr + t (one FMA).
__device__ __forceinline__ void flush(float acc[4], const float t[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// Fragment reads from a staged tile of rows LD = DMAX + 4 floats apart
// (see the header note: free of bank conflicts for all three patterns).
// A: rows m0..m0+15, columns k0..k0+7.
template <int LD, bool S>
__device__ __forceinline__ void load_a(Frag<4, S>& f, const float* t, int m0, int k0, int g, int tg) {
  const float* r = t + (m0 + g) * LD + k0 + tg;
  f.set(0, r[0]);
  f.set(1, r[8 * LD]);
  f.set(2, r[4]);
  f.set(3, r[8 * LD + 4]);
}

// B fragments, from a swept tile split by split_rows: its big parts, then
// its small parts SOFF floats on.
// B of X^T: X's rows n0..n0+7 are the columns, its columns k0..k0+7 the
// depth (Q K^T, dO V^T and their transposes).
template <int LD, int SOFF, bool S>
__device__ __forceinline__ void load_bt(Frag<2, S>& f, const float* t, int n0, int k0, int g, int tg) {
  const float* r = t + (n0 + g) * LD + k0 + tg;
  f.set_pre(0, r, SOFF);
  f.set_pre(1, r + 4, SOFF);
}

// B of X along its rows k0..k0+7, columns n0..n0+7, the depth permuted to
// match a_from_acc: depth tg is row k0 + 2 tg, depth tg + 4 row k0 + 2 tg + 1
// (P V, dS K, P^T dO, dS^T Q).
template <int LD, int SOFF, bool S>
__device__ __forceinline__ void load_b(Frag<2, S>& f, const float* t, int k0, int n0, int g, int tg) {
  const float* r = t + (k0 + 2 * tg) * LD + n0 + g;
  f.set_pre(0, r, SOFF);
  f.set_pre(1, r + LD, SOFF);
}

// An accumulator fragment (rows g, g + 8; columns 2 tg, 2 tg + 1) taken as
// an A fragment under load_b's permuted depth: no shuffle, no shared memory.
__device__ __forceinline__ void a_from_acc(Frag<4, true>& f, const float c[4]) {
  f.set(0, c[0]);
  f.set(1, c[2]);
  f.set(2, c[1]);
  f.set(3, c[3]);
}

// ldmatrix on 32-bit elements (as pairs of b16): four (two) 8 x 8 matrices,
// lane l giving the address of row l % 8 of matrix l / 8 (16-byte aligned),
// and thread t receiving row t / 4, column t % 4 of matrix i in x[i]: the
// layout of an mma.sync tf32 fragment. One instruction in place of four
// (two) 32-bit loads; rows LD = DMAX + 4 floats apart are 16 bytes apart in
// the banks, so the eight rows of a matrix do not conflict.
__device__ __forceinline__ void ldmatrix_x4(uint32_t x[4], const float* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t x[2], const float* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];" : "=r"(x[0]), "=r"(x[1]) : "r"(a));
}

// load_a and load_bt through ldmatrix, from tiles split once by split_rows
// (big parts, small parts SOFF floats on): the forward's Q and K.
template <int LD, int SOFF>
__device__ __forceinline__ void ldm_a(Frag<4, true>& f, const float* t, int m0, int k0, int lane) {
  // matrices: rows m0 and m0 + 8, columns k0 and k0 + 4
  const float* r = t + (m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + k0 + (lane >> 4) * 4;
  ldmatrix_x4(f.big, r);
  ldmatrix_x4(f.small, r + SOFF);
}
template <int LD, int SOFF, bool S>
__device__ __forceinline__ void ldm_bt(Frag<2, S>& f, const float* t, int n0, int k0, int lane) {
  // matrices: columns k0 and k0 + 4 of the big parts, then of the small
  const int j = lane >> 3;
  const float* r = t + (n0 + (lane & 7)) * LD + k0 + (j & 1) * 4;
  if constexpr (S) {
    uint32_t x[4];
    ldmatrix_x4(x, r + (j >> 1) * SOFF);
    f.big[0] = x[0];
    f.big[1] = x[1];
    f.small[0] = x[2];
    f.small[1] = x[3];
  } else {
    ldmatrix_x2(f.big, r);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [row0, row0 + R) of a (nrows, D) slab with row stride ss into an f32
// tile of rows LD floats apart, columns [0, DK8); rows at or past nrows and
// columns at or past D become 0. f32 goes through cp.async (16-byte chunks
// when vec, else 4-byte words; a zero source size fills zeros); bf16 is
// converted on the way, through registers. NTH threads share the copy.
template <typename T, int LD, int NTH>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ss, int row0, int R,
                                           int nrows, int D, int DK8, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int cpr = DK8 >> 2;
      for (int e = threadIdx.x; e < R * cpr; e += NTH) {
        const int r = e / cpr, c = 4 * (e - r * cpr), row = row0 + r;
        const bool ok = row < nrows && c < D;
        cp_async16(dst + r * LD + c, ok ? src + row * ss + c : src, ok);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < R * DK8; e += NTH) {
    const int r = e / DK8, c = e - r * DK8, row = row0 + r;
    const bool ok = row < nrows && c < D;
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(dst + r * LD + c, ok ? src + row * ss + c : src, ok);
    } else {
      dst[r * LD + c] = ok ? Cvt<T>::load(src[row * ss + c]) : 0.f;
    }
  }
}

// Splits, in place, the f32 elements this thread copied into a tile with
// stage_rows (the same assignment of elements to threads, so its own
// cp.async copies are complete after cp.async.wait_group and no barrier is
// needed first): the big part stays, the small part goes SOFF floats on.
// Each element is multiplied by mul first, rounded once (the forward's scale
// on Q). 16-byte chunks go through 16-byte loads and stores, which keeps the
// chunk-per-lane pattern free of bank conflicts.
template <int LD, int NTH>
__device__ __forceinline__ void split_rows(float* t, int R, int DK8, int soff, bool vec, float mul = 1.f) {
  auto split = [&](float x, float& big, float& small) {
    const float v = __fmul_rn(x, mul);
    big = __uint_as_float(to_tf32(v));
    small = __uint_as_float(to_tf32(v - big));
  };
  if (vec) {
    const int cpr = DK8 >> 2;
    for (int e = threadIdx.x; e < R * cpr; e += NTH) {
      const int r = e / cpr, c = 4 * (e - r * cpr);
      float4* x = reinterpret_cast<float4*>(t + r * LD + c);
      const float4 v = *x;
      float4 bg, sm;
      split(v.x, bg.x, sm.x);
      split(v.y, bg.y, sm.y);
      split(v.z, bg.z, sm.z);
      split(v.w, bg.w, sm.w);
      *x = bg;
      x[soff >> 2] = sm;
    }
  } else {
    for (int e = threadIdx.x; e < R * DK8; e += NTH) {
      float* x = t + (e / DK8) * LD + e % DK8;
      split(*x, x[0], x[soff]);
    }
  }
}

// What a thread needs of its two rows (query rows in the forward and dQ,
// key rows in dK/dV) and of the mask, for one tile's products.
struct Lane {
  int g, tg, m0, n0d, DK8, Sq, kvlen;
  bool causal;
  float scale;
};

// ------------------------------------------------------------------ forward
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// One K/V tile for the warp: S = (scale log2(e) Q) K^T over the live key
// fragments (all of them when FULL), the online softmax of the thread's two
// rows in base 2 (the keep test only when MASKED), then O = O corr + P V,
// P V taken in a zeroed accumulator per output fragment. S keeps big·big
// and the two small cross terms in separate accumulators, two dependency
// chains instead of one, and adds them at the end.
template <bool SPLIT, int DMAX, int DSPLIT, int BK, int QSOFF, bool FULL, bool MASKED>
__device__ __forceinline__ void fwd_tile(float (&acc)[DMAX / DSPLIT / 8][4], float m[2], float l[2], const Lane& L,
                                         const float* Qs, const float* Kt, const float* Vt, int k0, int nlive,
                                         int r0) {
  constexpr int LD = DMAX + 4, NKF = BK / 8, NDF = DMAX / DSPLIT / 8, SOFF = BK * LD;
  const int lane = 4 * L.g + L.tg;
  float s[NKF][4] = {}, sc[NKF][4] = {};
#pragma unroll
  for (int ks = 0; ks < DMAX / 8; ++ks) {
    if (8 * ks >= L.DK8) break;
    Frag<4, true> qa;
    ldm_a<LD, QSOFF>(qa, Qs, L.m0, 8 * ks, lane);
#pragma unroll
    for (int n = 0; n < NKF; ++n) {
      if (FULL || n < nlive) {
        Frag<2, SPLIT> kb;
        ldm_bt<LD, SOFF>(kb, Kt, 8 * n, 8 * ks, lane);
        mma_tf32(sc[n], qa.small, kb.big);
        if (SPLIT) mma_tf32(sc[n], qa.big, kb.small);
        mma_tf32(s[n], qa.big, kb.big);
      }
    }
  }
  // element e of fragment n: row r0 + 8 (e / 2), key k0 + 8 n + 2 tg + e % 2
  auto keep = [&](int n, int e) {
    return !MASKED || ((FULL || n < nlive) &&
                       keep_score(r0 + 8 * (e >> 1), k0 + 8 * n + 2 * L.tg + (e & 1), L.kvlen, L.causal));
  };
  float mt[2] = {NEG_INF, NEG_INF}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NKF; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] += sc[n][e];
      if (keep(n, e)) mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's max over the quad's four lanes
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r]);
    corr[r] = exp2f(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int n = 0; n < NKF; ++n) {  // P in place of S
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = keep(n, e) ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
      s[n][e] = pv;
      rs[e >> 1] += pv;
    }
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
  Frag<4, true> pa[NKF];
#pragma unroll
  for (int n = 0; n < NKF; ++n)
    if (FULL || n < nlive) a_from_acc(pa[n], s[n]);
#pragma unroll
  for (int j = 0; j < NDF; ++j) {  // O = O corr + P V over the tile's keys
    if (L.n0d + 8 * j < L.DK8) {
      float t[4] = {};
#pragma unroll
      for (int n = 0; n < NKF; ++n) {
        if (FULL || n < nlive) {
          Frag<2, SPLIT> vb;
          load_b<LD, SOFF>(vb, Vt, 8 * n, L.n0d + 8 * j, L.g, L.tg);
          mma3(t, pa[n], vb);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], corr[e >> 1], t[e]);
    }
  }
}

// grid (ceil(Sq / BM), NQ, B), BM = 16 NWARP / DSPLIT query rows. Warp w owns
// rows 16 (w / DSPLIT) .. + 15 of the tile and output columns
// (w % DSPLIT) DMAX / DSPLIT .. + DMAX / DSPLIT - 1. Shared: Qs (BM rows,
// scaled and split once: big parts, then small parts), two K and two V
// buffers (BK rows each, split likewise).
template <typename T, int DMAX, int NWARP, int MINB, int DSPLIT, int BK>
__global__ void __launch_bounds__(32 * NWARP, MINB) flash_fwd_kernel(const Params p, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NTH = 32 * NWARP, LD = DMAX + 4, BM = 16 * NWARP / DSPLIT, NKF = BK / 8;
  constexpr int NDF = DMAX / DSPLIT / 8, QSOFF = BM * LD, KV = 2 * BK * LD;  // KV: one split K or V buffer
  extern __shared__ float4 smem_v[];
  float* Qs = reinterpret_cast<float*>(smem_v);
  float* Ks = Qs + 2 * QSOFF;
  float* Vs = Ks + 2 * KV;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int hk = h / (int)(p.NQ / p.NKV);
  Lane L;
  L.g = (threadIdx.x & 31) >> 2;
  L.tg = threadIdx.x & 3;
  L.m0 = (warp / DSPLIT) * 16;
  L.n0d = (warp % DSPLIT) * (DMAX / DSPLIT);
  L.DK8 = (D + 7) & ~7;
  L.Sq = Sq;
  L.kvlen = min(max(p.kvlen[b], 0), Sk);
  L.causal = p.causal != 0;
  L.scale = (float)p.scale;
  const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  T* o = static_cast<T*>(p.o) + b * p.st[O][0] + h * p.st[O][1];

  const int rw = q0 + L.m0, r0 = rw + L.g, r1 = r0 + 8;  // the warp's first row, the thread's two
  const bool live = rw < Sq;  // a warp wholly past Sq does no product
  int klim = L.kvlen;         // keys the warp's rows can see
  if (L.causal) klim = min(klim, min(rw + 16, Sq));
  int kend = L.kvlen;  // keys any row of the block can see
  if (L.causal) kend = min(kend, min(q0 + BM, Sq));
  const int nk = (kend + BK - 1) / BK;

  if (nk > 0) {
    stage_rows<T, LD, NTH>(Qs, q, p.st[Q][2], q0, BM, Sq, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(Ks, k, p.st[K][2], 0, BK, Sk, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(Vs, v, p.st[V][2], 0, BK, Sk, D, L.DK8, vec);
  }
  cp_async_commit();

  float acc[NDF][4] = {}, m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // the next tile's copies run while this one is used
      const int nxt = (kt + 1) * BK;
      stage_rows<T, LD, NTH>(Ks + (cur ^ 1) * KV, k, p.st[K][2], nxt, BK, Sk, D, L.DK8, vec);
      stage_rows<T, LD, NTH>(Vs + (cur ^ 1) * KV, v, p.st[V][2], nxt, BK, Sk, D, L.DK8, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (kt == 0) split_rows<LD, NTH>(Qs, BM, L.DK8, QSOFF, vec, L.scale * LOG2E);  // S in base 2
    if (SPLIT) {  // once for all warps, not once per warp and fragment
      split_rows<LD, NTH>(Ks + cur * KV, BK, L.DK8, BK * LD, vec);
      split_rows<LD, NTH>(Vs + cur * KV, BK, L.DK8, BK * LD, vec);
    }
    __syncthreads();
    const int k0 = kt * BK;
    const int nlive = min(max((klim - k0 + 7) >> 3, 0), NKF);  // key fragments with a live key
    if (live && nlive > 0) {
      const float* Kt = Ks + cur * KV;
      const float* Vt = Vs + cur * KV;
      // every score of the tile kept: no key at or past kvlen, no key in the
      // causal future of the warp's first row
      const bool clear = k0 + BK <= L.kvlen && (!L.causal || k0 + BK - 1 <= rw);
      if (nlive < NKF)
        fwd_tile<SPLIT, DMAX, DSPLIT, BK, QSOFF, false, true>(acc, m, l, L, Qs, Kt, Vt, k0, nlive, r0);
      else if (!clear)
        fwd_tile<SPLIT, DMAX, DSPLIT, BK, QSOFF, true, true>(acc, m, l, L, Qs, Kt, Vt, k0, nlive, r0);
      else
        fwd_tile<SPLIT, DMAX, DSPLIT, BK, QSOFF, true, false>(acc, m, l, L, Qs, Kt, Vt, k0, nlive, r0);
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  cp_async_wait<0>();
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's sum over the quad's four lanes
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NDF; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), d = L.n0d + 8 * j + 2 * L.tg + (e & 1);
      if (row < Sq && d < D) o[row * p.st[O][2] + d] = Cvt<T>::store(acc[j][e] / lc[e >> 1]);
    }
  }
  if (L.tg == 0 && L.n0d == 0) {  // one lane of each quad, one warp of each strip
    const long long row_base = ((long long)b * p.NQ + h) * Sq;
    const int rows[2] = {r0, r1};
#pragma unroll
    for (int r = 0; r < 2; ++r)  // lse = m + log(l) in base e; a row with no key keeps NEG_INF
      if (rows[r] < Sq) p.lse[row_base + rows[r]] = (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(lc[r]);
  }
}

// ----------------------------------------------------------------------- dQ
// One K/V tile's products for the warp: S = Q K^T and dP = dO V^T over
// the live key fragments (all of them when FULL), P and dS in registers
// (the keep test only when MASKED), then dQ += dS K.
template <bool SPLIT, int DMAX, int DSPLIT, int BK, bool FULL, bool MASKED>
__device__ __forceinline__ void dq_tile(float (&acc)[DMAX / DSPLIT / 8][4], const Lane& L, const float* Qs,
                                        const float* DOs, const float* Kt, const float* Vt, int k0,
                                        int nlive, int r0, const float lse[2], const float dl[2]) {
  constexpr int LD = DMAX + 4, NKF = BK / 8, NDF = DMAX / DSPLIT / 8, SOFF = BK * LD;
  float s[NKF][4] = {}, dp[NKF][4] = {};
#pragma unroll
  for (int ks = 0; ks < DMAX / 8; ++ks) {
    if (8 * ks >= L.DK8) break;
    Frag<4, SPLIT> qa, ga;
    load_a<LD>(qa, Qs, L.m0, 8 * ks, L.g, L.tg);
    load_a<LD>(ga, DOs, L.m0, 8 * ks, L.g, L.tg);
#pragma unroll
    for (int n = 0; n < NKF; ++n) {
      if (FULL || n < nlive) {
        Frag<2, SPLIT> kb, vb;
        load_bt<LD, SOFF>(kb, Kt, 8 * n, 8 * ks, L.g, L.tg);
        load_bt<LD, SOFF>(vb, Vt, 8 * n, 8 * ks, L.g, L.tg);
        mma3(s[n], qa, kb);
        mma3(dp[n], ga, vb);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NKF; ++n) {  // P, then dS = P (dP - delta), in place of S
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv = expf(s[n][e] * L.scale - lse[e >> 1]);
      if (MASKED) {
        const int row = r0 + 8 * (e >> 1), key = k0 + 8 * n + 2 * L.tg + (e & 1);
        if (!(row < L.Sq && keep_score(row, key, L.kvlen, L.causal))) pv = 0.f;
      }
      s[n][e] = pv * (dp[n][e] - dl[e >> 1]);
    }
  }
#pragma unroll
  for (int n = 0; n < NKF; ++n) {  // dQ += dS K over the tile's keys
    if (FULL || n < nlive) {
      Frag<4, true> da;
      a_from_acc(da, s[n]);
#pragma unroll
      for (int j = 0; j < NDF; ++j) {
        if (L.n0d + 8 * j < L.DK8) {
          Frag<2, SPLIT> kb;
          load_b<LD, SOFF>(kb, Kt, 8 * n, L.n0d + 8 * j, L.g, L.tg);
          mma3(acc[j], da, kb);
        }
      }
    }
  }
}

// grid (ceil(Sq / BM), NQ, B), BM = 16 NWARP / DSPLIT query rows. Warp w owns
// rows 16 (w / DSPLIT) .. + 15 of the tile and output columns
// (w % DSPLIT) DMAX / DSPLIT .. + DMAX / DSPLIT - 1. Shared: Qs, DOs (BM rows),
// two K and two V buffers (BK rows each, split: big parts, then small parts).
template <typename T, int DMAX, int NWARP, int MINB, int DSPLIT, int BK>
__global__ void __launch_bounds__(32 * NWARP, MINB) flash_dq_kernel(const Params p, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NTH = 32 * NWARP, LD = DMAX + 4, BM = 16 * NWARP / DSPLIT, NKF = BK / 8;
  constexpr int NDF = DMAX / DSPLIT / 8;
  extern __shared__ float4 smem_v[];
  float* Qs = reinterpret_cast<float*>(smem_v);
  float* DOs = Qs + BM * LD;
  constexpr int KV = 2 * BK * LD;  // one split K or V buffer
  float* Ks = DOs + BM * LD;
  float* Vs = Ks + 2 * KV;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int hk = h / (int)(p.NQ / p.NKV);
  Lane L;
  L.g = (threadIdx.x & 31) >> 2;
  L.tg = threadIdx.x & 3;
  L.m0 = (warp / DSPLIT) * 16;
  L.n0d = (warp % DSPLIT) * (DMAX / DSPLIT);
  L.DK8 = (D + 7) & ~7;
  L.Sq = Sq;
  L.kvlen = min(max(p.kvlen[b], 0), Sk);
  L.causal = p.causal != 0;
  L.scale = (float)p.scale;
  const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
  const T* dout = static_cast<const T*>(p.dout) + b * p.st[DOUT][0] + h * p.st[DOUT][1];
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  T* dq = static_cast<T*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];
  const long long row_base = ((long long)b * p.NQ + h) * Sq;

  const int rw = q0 + L.m0, r0 = rw + L.g, r1 = r0 + 8;  // the warp's first row, the thread's two
  const float lse[2] = {r0 < Sq ? p.lse[row_base + r0] : 0.f, r1 < Sq ? p.lse[row_base + r1] : 0.f};
  const float dl[2] = {r0 < Sq ? p.delta[row_base + r0] : 0.f, r1 < Sq ? p.delta[row_base + r1] : 0.f};
  const bool live = rw < Sq;  // a warp wholly past Sq does no product
  int klim = L.kvlen;         // keys the warp's rows can see
  if (L.causal) klim = min(klim, min(rw + 16, Sq));
  int kend = L.kvlen;  // keys any row of the block can see
  if (L.causal) kend = min(kend, min(q0 + BM, Sq));
  const int nk = (kend + BK - 1) / BK;

  if (nk > 0) {
    stage_rows<T, LD, NTH>(Qs, q, p.st[Q][2], q0, BM, Sq, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(DOs, dout, p.st[DOUT][2], q0, BM, Sq, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(Ks, k, p.st[K][2], 0, BK, Sk, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(Vs, v, p.st[V][2], 0, BK, Sk, D, L.DK8, vec);
  }
  cp_async_commit();

  float acc[NDF][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // the next tile's copies run while this one is used
      const int nxt = (kt + 1) * BK;
      stage_rows<T, LD, NTH>(Ks + (cur ^ 1) * KV, k, p.st[K][2], nxt, BK, Sk, D, L.DK8, vec);
      stage_rows<T, LD, NTH>(Vs + (cur ^ 1) * KV, v, p.st[V][2], nxt, BK, Sk, D, L.DK8, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (SPLIT) {  // once for all warps, not once per warp and fragment
      split_rows<LD, NTH>(Ks + cur * KV, BK, L.DK8, BK * LD, vec);
      split_rows<LD, NTH>(Vs + cur * KV, BK, L.DK8, BK * LD, vec);
    }
    __syncthreads();
    const int k0 = kt * BK;
    const int nlive = min(max((klim - k0 + 7) >> 3, 0), NKF);  // key fragments with a live key
    if (live && nlive > 0) {
      const float* Kt = Ks + cur * KV;
      const float* Vt = Vs + cur * KV;
      // every score of the tile kept: no key at or past kvlen, no row past
      // Sq, no key in the causal future of the warp's first row
      const bool clear = k0 + BK <= L.kvlen && rw + 16 <= Sq && (!L.causal || k0 + BK - 1 <= rw);
      if (nlive < NKF)
        dq_tile<SPLIT, DMAX, DSPLIT, BK, false, true>(acc, L, Qs, DOs, Kt, Vt, k0, nlive, r0, lse, dl);
      else if (!clear)
        dq_tile<SPLIT, DMAX, DSPLIT, BK, true, true>(acc, L, Qs, DOs, Kt, Vt, k0, nlive, r0, lse, dl);
      else
        dq_tile<SPLIT, DMAX, DSPLIT, BK, true, false>(acc, L, Qs, DOs, Kt, Vt, k0, nlive, r0, lse, dl);
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < NDF; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), d = L.n0d + 8 * j + 2 * L.tg + (e & 1);
      if (row < Sq && d < D) dq[row * p.st[DQ][2] + d] = Cvt<T>::store(acc[j][e] * L.scale);
    }
  }
}

// -------------------------------------------------------------------- dK/dV
// One (head, Q tile) step's products for the warp: S^T = K Q^T and
// dP^T = V dO^T over the query fragments [nlo, nhi) (all when FULL), P^T
// and dS^T in registers (the keep test only when MASKED), then dV += P^T dO
// and dK += dS^T Q.
template <bool SPLIT, int DMAX, int DSPLIT, int BQ, bool FULL, bool MASKED>
__device__ __forceinline__ void dkv_tile(float (&dka)[DMAX / DSPLIT / 8][4], float (&dva)[DMAX / DSPLIT / 8][4],
                                         const Lane& L, const float* Ks, const float* Vs, const float* Qt,
                                         const float* Gt, const float* ls, const float* dls, int q0, int nlo,
                                         int nhi, int j_0) {
  constexpr int LD = DMAX + 4, NQF = BQ / 8, NDF = DMAX / DSPLIT / 8, SOFF = BQ * LD;
  float s[NQF][4] = {}, dp[NQF][4] = {};
#pragma unroll
  for (int ks = 0; ks < DMAX / 8; ++ks) {
    if (8 * ks >= L.DK8) break;
    Frag<4, SPLIT> ka, va;
    load_a<LD>(ka, Ks, L.m0, 8 * ks, L.g, L.tg);
    load_a<LD>(va, Vs, L.m0, 8 * ks, L.g, L.tg);
#pragma unroll
    for (int n = 0; n < NQF; ++n) {
      if (FULL || (n >= nlo && n < nhi)) {
        Frag<2, SPLIT> qb, gb;
        load_bt<LD, SOFF>(qb, Qt, 8 * n, 8 * ks, L.g, L.tg);
        load_bt<LD, SOFF>(gb, Gt, 8 * n, 8 * ks, L.g, L.tg);
        mma3(s[n], ka, qb);
        mma3(dp[n], va, gb);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NQF; ++n) {  // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * n + 2 * L.tg + (e & 1);
      float pv = expf(s[n][e] * L.scale - ls[i]);
      if (MASKED) {
        const int qi = q0 + i, key = j_0 + 8 * (e >> 1);
        if (!(qi < L.Sq && keep_score(qi, key, L.kvlen, L.causal))) pv = 0.f;
      }
      s[n][e] = pv;
      dp[n][e] = pv * (dp[n][e] - dls[i]);
    }
  }
#pragma unroll
  for (int n = 0; n < NQF; ++n) {  // dV += P^T dO, dK += dS^T Q over the tile's queries
    if (FULL || (n >= nlo && n < nhi)) {
      Frag<4, true> pa, da;
      a_from_acc(pa, s[n]);
      a_from_acc(da, dp[n]);
#pragma unroll
      for (int j = 0; j < NDF; ++j) {
        if (L.n0d + 8 * j < L.DK8) {
          Frag<2, SPLIT> gb, qb;
          load_b<LD, SOFF>(gb, Gt, 8 * n, L.n0d + 8 * j, L.g, L.tg);
          load_b<LD, SOFF>(qb, Qt, 8 * n, L.n0d + 8 * j, L.g, L.tg);
          float tv[4] = {}, tk[4] = {};
          mma3(tv, pa, gb);
          mma3(tk, da, qb);
          flush(dva[j], tv);
          flush(dka[j], tk);
        }
      }
    }
  }
}

// grid (ceil(Sk / BN), NKV, B), BN = 16 NWARP / DSPLIT key rows. The block
// owns one K/V tile and sweeps the G query heads of its group and every live
// Q tile of BQ rows, as the Pallas grid's two innermost sequential axes do;
// dK and dV stay in registers for the whole sweep. Warp w owns key rows
// 16 (w / DSPLIT) .. + 15 and output columns as in dQ. Shared: Ks, Vs (BN
// rows), two Q, two dO buffers (BQ rows each, split: big parts, then small
// parts), two lse and two delta rows.
template <typename T, int DMAX, int NWARP, int MINB, int DSPLIT, int BQ>
__global__ void __launch_bounds__(32 * NWARP, MINB) flash_dkv_kernel(const Params p, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int NTH = 32 * NWARP, LD = DMAX + 4, BN = 16 * NWARP / DSPLIT, NQF = BQ / 8;
  constexpr int NDF = DMAX / DSPLIT / 8;
  extern __shared__ float4 smem_v[];
  float* Ks = reinterpret_cast<float*>(smem_v);
  float* Vs = Ks + BN * LD;
  constexpr int QB = 2 * BQ * LD;  // one split Q or dO buffer
  float* Qs = Vs + BN * LD;
  float* DOs = Qs + 2 * QB;
  float* lse_s = DOs + 2 * QB;
  float* dl_s = lse_s + 2 * BQ;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BN;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int G = (int)(p.NQ / p.NKV);
  Lane L;
  L.g = (threadIdx.x & 31) >> 2;
  L.tg = threadIdx.x & 3;
  L.m0 = (warp / DSPLIT) * 16;
  L.n0d = (warp % DSPLIT) * (DMAX / DSPLIT);
  L.DK8 = (D + 7) & ~7;
  L.Sq = Sq;
  L.kvlen = min(max(p.kvlen[b], 0), Sk);
  L.causal = p.causal != 0;
  L.scale = (float)p.scale;
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  T* dk = static_cast<T*>(p.dk) + b * p.st[DK][0] + hk * p.st[DK][1];
  T* dv = static_cast<T*>(p.dv) + b * p.st[DV][0] + hk * p.st[DV][1];

  const int j0 = k0 + L.m0, j_0 = j0 + L.g, j_1 = j_0 + 8;  // the warp's first key, the thread's two
  const bool live = j0 < L.kvlen;  // keys at or past kvlen are masked for every query
  const int nq = (Sq + BQ - 1) / BQ;
  // a tile past kvlen has no valid key; causal Q tiles wholly before k0 are dead
  const int qt0 = k0 >= L.kvlen ? nq : (L.causal ? k0 / BQ : 0);
  const int per = nq - qt0, total = G * per;  // (head, Q tile) steps, head outermost

  auto stage_q = [&](int it, int buf) {
    const int h = hk * G + it / per, qr = (qt0 + it % per) * BQ;
    const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
    const T* dout = static_cast<const T*>(p.dout) + b * p.st[DOUT][0] + h * p.st[DOUT][1];
    stage_rows<T, LD, NTH>(Qs + buf * QB, q, p.st[Q][2], qr, BQ, Sq, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(DOs + buf * QB, dout, p.st[DOUT][2], qr, BQ, Sq, D, L.DK8, vec);
    const long long rb = ((long long)b * p.NQ + h) * Sq;
    for (int i = threadIdx.x; i < BQ; i += NTH) {
      const bool ok = qr + i < Sq;
      cp_async4(lse_s + buf * BQ + i, p.lse + (ok ? rb + qr + i : 0), ok);
      cp_async4(dl_s + buf * BQ + i, p.delta + (ok ? rb + qr + i : 0), ok);
    }
  };
  if (total > 0) {
    stage_rows<T, LD, NTH>(Ks, k, p.st[K][2], k0, BN, Sk, D, L.DK8, vec);
    stage_rows<T, LD, NTH>(Vs, v, p.st[V][2], k0, BN, Sk, D, L.DK8, vec);
    stage_q(0, 0);
  }
  cp_async_commit();

  float dka[NDF][4] = {}, dva[NDF][4] = {};
  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    if (it + 1 < total) {
      stage_q(it + 1, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (SPLIT) {  // once for all warps, not once per warp and fragment
      split_rows<LD, NTH>(Qs + cur * QB, BQ, L.DK8, BQ * LD, vec);
      split_rows<LD, NTH>(DOs + cur * QB, BQ, L.DK8, BQ * LD, vec);
    }
    __syncthreads();
    const int q0 = (qt0 + it % per) * BQ;
    // live query fragments: inside Sq and, causal, not wholly before the warp's first key
    const int nlo = L.causal ? max(j0 - q0, 0) >> 3 : 0;
    const int nhi = min((Sq - q0 + 7) >> 3, NQF);
    if (live && nlo < nhi) {
      const float* Qt = Qs + cur * QB;
      const float* Gt = DOs + cur * QB;
      const float* ls = lse_s + cur * BQ;
      const float* dls = dl_s + cur * BQ;
      // every score of the step kept: no query past Sq, no key at or past
      // kvlen, no query in the causal past of the warp's last key
      const bool clear = q0 + BQ <= Sq && j0 + 16 <= L.kvlen && (!L.causal || q0 >= j0 + 15);
      if (nlo > 0 || nhi < NQF)
        dkv_tile<SPLIT, DMAX, DSPLIT, BQ, false, true>(dka, dva, L, Ks, Vs, Qt, Gt, ls, dls, q0, nlo, nhi, j_0);
      else if (!clear)
        dkv_tile<SPLIT, DMAX, DSPLIT, BQ, true, true>(dka, dva, L, Ks, Vs, Qt, Gt, ls, dls, q0, nlo, nhi, j_0);
      else
        dkv_tile<SPLIT, DMAX, DSPLIT, BQ, true, false>(dka, dva, L, Ks, Vs, Qt, Gt, ls, dls, q0, nlo, nhi, j_0);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < NDF; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = e < 2 ? j_0 : j_1, d = L.n0d + 8 * j + 2 * L.tg + (e & 1);
      if (kj < Sk && d < D) {
        dk[kj * p.st[DK][2] + d] = Cvt<T>::store(dka[j][e] * L.scale);
        dv[kj * p.st[DV][2] + d] = Cvt<T>::store(dva[j][e]);
      }
    }
  }
}

// ----------------------------------------------- bf16 forward and dQ (D <= 128)
// The bf16 design of the header note: tiles stay bf16 in shared memory, rows
// LDH = DMAX + 8 elements apart (16 bytes of padding, so the eight rows of an
// ldmatrix matrix, read plain or with .trans, fall in eight distinct 16-byte
// bank groups); every product is mma.sync m16n8k16 bf16 with f32
// accumulation; each warp owns a 16-row strip and all its output columns.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix_x4 and cp_async16 on bf16 tiles (copies, so the f32 design's
// code stays as it was): four 8 x 8 b16 matrices, lane l giving the address
// of row l % 8 of matrix l / 8, thread t receiving row t / 4, elements
// 2 (t % 4) and 2 (t % 4) + 1 of matrix i in x[i], the layout of an
// mma.sync bf16 fragment; .trans hands each thread a column pair instead
// (an operand read along the sequence).
__device__ __forceinline__ void ldsm4(uint32_t x[4], const bf16* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4_t(uint32_t x[4], const bf16* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
}

__device__ __forceinline__ void cp_async16_h(bf16* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// An f32 pair (a the lower column) as two bf16 pairs, hi = bf16(x) and
// lo = bf16(x - hi): hi + lo keeps about 16 bits of x.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Rows [row0, row0 + R) of a (nrows, D) bf16 slab with row stride ss into a
// tile of rows LDH elements apart, columns [0, DK); rows at or past nrows and
// columns at or past D become 0. 16-byte cp.async chunks of 8 elements when
// vec (a zero source size fills zeros), else element by element through
// registers (rows that are not 16-byte aligned).
template <int LDH, int NTH>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, long long ss, int row0, int R,
                                           int nrows, int D, int DK, bool vec) {
  if (vec) {
    const int cpr = DK >> 3;
    for (int e = threadIdx.x; e < R * cpr; e += NTH) {
      const int r = e / cpr, c = 8 * (e - r * cpr), row = row0 + r;
      const bool ok = row < nrows && c < D;
      cp_async16_h(dst + r * LDH + c, ok ? src + row * ss + c : src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < R * DK; e += NTH) {
      const int r = e / DK, c = e - r * DK, row = row0 + r;
      dst[r * LDH + c] = row < nrows && c < D ? src[row * ss + c] : zero;
    }
  }
}

// 2^x as ex2.approx.ftz.f32 (a result below 2^-126 flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What a warp of the bf16 kernels needs of its rows and of the mask.
struct Strip {
  int lane, m0, DK, Sq, kvlen;  // m0: the warp's first row in the block; DK: D rounded up to 16
  bool causal;
};

// Writes the warp's 16 x D output strip, acc[j][e] * mul[e / 2] (row
// rw + g + 8 (e / 2), column 8 j + 2 tg + e % 2), as bf16. With vec (every
// output row 16-byte aligned, D a multiple of 8) through the warp's own
// rows of st (m0 .. m0 + 15, which only this warp reads) and 16-byte
// stores, a row's chunks on neighbouring lanes; else element by element.
template <int DMAX>
__device__ __forceinline__ void store_strip(bf16* out, long long so, bf16* st, const float (&acc)[DMAX / 8][4],
                                            const float mul[2], const Strip& W, int rw, int D, bool vec) {
  constexpr int LDH = DMAX + 8;
  const int g = W.lane >> 2, tg = W.lane & 3;
  if (vec) {
    bf16* t = st + W.m0 * LDH;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      if (8 * j < D) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<__nv_bfloat162*>(t + (g + 8 * hf) * LDH + 8 * j + 2 * tg) =
              __floats2bfloat162_rn(acc[j][2 * hf] * mul[hf], acc[j][2 * hf + 1] * mul[hf]);
      }
    }
    __syncwarp();
    const int cpr = D >> 3;
    for (int e = W.lane; e < 16 * cpr; e += 32) {
      const int r = e / cpr, c = 8 * (e - r * cpr);
      if (rw + r < W.Sq)
        *reinterpret_cast<uint4*>(out + (rw + r) * so + c) = *reinterpret_cast<const uint4*>(t + r * LDH + c);
    }
  } else {
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rw + g + 8 * (e >> 1), d = 8 * j + 2 * tg + (e & 1);
        if (row < W.Sq && d < D) out[row * so + d] = __float2bfloat16(acc[j][e] * mul[e >> 1]);
      }
    }
  }
}

// s = A B^T over the live 16-key steps of a tile for the warp's 16 rows:
// A's rows m0 .. m0 + 15 (Q, or dO), B the tile's keys (K, or V). KU: the
// depth loop's unroll (dQ, with two products live, fits its registers only
// at 2; the forward unrolls it whole).
template <int DMAX, int BK, bool DALL, bool FULL, int KU = DMAX / 16>
__device__ __forceinline__ void scores_bf16(float (&s)[BK / 8][4], const Strip& W, const bf16* As, const bf16* Bt,
                                            int nlive) {
  constexpr int LDH = DMAX + 8, NKS = BK / 16;
  const int lane = W.lane;
  // this lane's ldmatrix rows: A (rows l % 16, column half l / 16), B^T
  // (keys l % 8 + 8 (l / 16), column half (l / 8) % 2)
  const bf16* arow = As + (W.m0 + (lane & 15)) * LDH + (lane >> 4) * 8;
  const bf16* brow = Bt + ((lane & 7) + ((lane >> 4) << 3)) * LDH + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll(KU)
  for (int ks = 0; ks < DMAX / 16; ++ks) {
    if (!DALL && 16 * ks >= W.DK) break;
    uint32_t a[4];
    ldsm4(a, arow + 16 * ks);
#pragma unroll
    for (int j = 0; j < NKS; ++j) {
      if (FULL || j < nlive) {
        uint32_t b[4];
        ldsm4(b, brow + 16 * j * LDH + 16 * ks);
        mma_bf16(s[2 * j], a, b[0], b[1]);
        mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc += X Y over the live 16-key steps, X (P or dS, f32, the accumulators
// of scores_bf16 over keys 16 j .. + 15 as they stand: an A fragment with
// no shuffle) split into hi and lo bf16 parts, two products (lo first), and
// Y the tile's rows (V or K) read along the keys through ldmatrix .trans.
template <int DMAX, int BK, bool DALL, bool FULL>
__device__ __forceinline__ void pv_bf16(float (&acc)[DMAX / 8][4], const float (&x)[BK / 8][4], const Strip& W,
                                        const bf16* Yt, int nlive) {
  constexpr int LDH = DMAX + 8, NKS = BK / 16;
  const bf16* yrow = Yt + (W.lane & 15) * LDH + (W.lane >> 4) * 8;  // keys l % 16, column half l / 16
#pragma unroll
  for (int j = 0; j < NKS; ++j) {
    if (FULL || j < nlive) {
      uint32_t hi[4], lo[4];
      split_bf16(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
      split_bf16(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
      split_bf16(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
      split_bf16(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dj = 0; dj < DMAX / 16; ++dj) {
        if (!DALL && 16 * dj >= W.DK) break;
        uint32_t yb[4];
        ldsm4_t(yb, yrow + 16 * j * LDH + 16 * dj);
        mma_bf16(acc[2 * dj], lo, yb[0], yb[1]);
        mma_bf16(acc[2 * dj + 1], lo, yb[2], yb[3]);
        mma_bf16(acc[2 * dj], hi, yb[0], yb[1]);
        mma_bf16(acc[2 * dj + 1], hi, yb[2], yb[3]);
      }
    }
  }
}

// One K/V tile for the warp, bf16: S = Q K^T, the online softmax of the
// thread's two rows in base 2 (scale log2(e) applied to S in f32; the keep
// test only when MASKED), then O = O corr + P V.
template <int DMAX, int BK, bool DALL, bool FULL, bool MASKED>
__device__ __forceinline__ void fwd_tile_bf16(float (&acc)[DMAX / 8][4], float m[2], float l[2], const Strip& W,
                                              const bf16* Qs, const bf16* Kt, const bf16* Vt, int k0, int nlive,
                                              int r0, float sl2) {
  constexpr int NKF = BK / 8;
  const int tg = W.lane & 3;
  float s[NKF][4];
  scores_bf16<DMAX, BK, DALL, FULL>(s, W, Qs, Kt, nlive);
  // element e of fragment n: row r0 + 8 (e / 2), key k0 + 8 n + 2 tg + e % 2
  auto keep = [&](int n, int e) {
    return !MASKED || ((FULL || (n >> 1) < nlive) &&
                       keep_score(r0 + 8 * (e >> 1), k0 + 8 * n + 2 * tg + (e & 1), W.kvlen, W.causal));
  };
  float mt[2] = {NEG_INF, NEG_INF}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NKF; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (keep(n, e)) mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's max over the quad's four lanes, then in base 2
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r] == NEG_INF ? NEG_INF : mt[r] * sl2);  // sl2 > 0 keeps the max
    corr[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int n = 0; n < NKF; ++n) {  // P in place of S
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = keep(n, e) ? ex2(fmaf(s[n][e], sl2, -m[e >> 1])) : 0.f;
      s[n][e] = pv;
      rs[e >> 1] += pv;
    }
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }
  pv_bf16<DMAX, BK, DALL, FULL>(acc, s, W, Vt, nlive);
}

// grid (ceil(Sq / BM), NQ, B), BM = 16 NWARP query rows, the blocks of the
// longest causal sweeps first; warp w owns rows 16 w .. + 15 and every
// output column. Shared: Qs (BM rows), two K and two V buffers (BK rows).
// flags: 1 q, k, v rows 16-byte aligned (cp.async), 2 o rows likewise.
template <int DMAX, int NWARP, int MINB, int BK, bool DALL>
__global__ void __launch_bounds__(32 * NWARP, MINB) flash_fwd_bf16_kernel(const Params p, int flags) {
  constexpr int NTH = 32 * NWARP, LDH = DMAX + 8, BM = 16 * NWARP, NKS = BK / 16, TK = BK * LDH;
  extern __shared__ float4 smem_v[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_v);
  bf16* Ks = Qs + BM * LDH;
  bf16* Vs = Ks + 2 * TK;
  const bool vec = flags & 1;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int hk = h / (int)(p.NQ / p.NKV);
  Strip W;
  W.lane = threadIdx.x & 31;
  W.m0 = 16 * warp;
  W.DK = (D + 15) & ~15;
  W.Sq = Sq;
  W.kvlen = min(max(p.kvlen[b], 0), Sk);
  W.causal = p.causal != 0;
  const float sl2 = (float)p.scale * LOG2E;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  bf16* o = static_cast<bf16*>(p.o) + b * p.st[O][0] + h * p.st[O][1];

  const int rw = q0 + W.m0, r0 = rw + (W.lane >> 2);  // the warp's first row, the thread's first
  const bool live = rw < Sq;  // a warp wholly past Sq does no product
  int klim = W.kvlen;         // keys the warp's rows can see
  if (W.causal) klim = min(klim, min(rw + 16, Sq));
  int kend = W.kvlen;  // keys any row of the block can see
  if (W.causal) kend = min(kend, min(q0 + BM, Sq));
  const int nk = (kend + BK - 1) / BK;

  if (nk > 0) {
    stage_bf16<LDH, NTH>(Qs, q, p.st[Q][2], q0, BM, Sq, D, W.DK, vec);
    stage_bf16<LDH, NTH>(Ks, k, p.st[K][2], 0, BK, Sk, D, W.DK, vec);
    stage_bf16<LDH, NTH>(Vs, v, p.st[V][2], 0, BK, Sk, D, W.DK, vec);
  }
  cp_async_commit();

  float acc[DMAX / 8][4] = {}, m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // the next tile's copies run while this one is used
      const int nxt = (kt + 1) * BK;
      stage_bf16<LDH, NTH>(Ks + (cur ^ 1) * TK, k, p.st[K][2], nxt, BK, Sk, D, W.DK, vec);
      stage_bf16<LDH, NTH>(Vs + (cur ^ 1) * TK, v, p.st[V][2], nxt, BK, Sk, D, W.DK, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * BK;
    const int nlive = min(max((klim - k0 + 15) >> 4, 0), NKS);  // 16-key steps with a live key
    if (live && nlive > 0) {
      const bf16* Kt = Ks + cur * TK;
      const bf16* Vt = Vs + cur * TK;
      // every score of the tile kept: no key at or past kvlen, no key in the
      // causal future of the warp's first row
      const bool clear = k0 + BK <= W.kvlen && (!W.causal || k0 + BK - 1 <= rw);
      if (nlive < NKS)
        fwd_tile_bf16<DMAX, BK, DALL, false, true>(acc, m, l, W, Qs, Kt, Vt, k0, nlive, r0, sl2);
      else if (!clear)
        fwd_tile_bf16<DMAX, BK, DALL, true, true>(acc, m, l, W, Qs, Kt, Vt, k0, nlive, r0, sl2);
      else
        fwd_tile_bf16<DMAX, BK, DALL, true, false>(acc, m, l, W, Qs, Kt, Vt, k0, nlive, r0, sl2);
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  cp_async_wait<0>();
  float lc[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the row's sum over the quad's four lanes
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lc[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lc[r];
  }
  if (live) store_strip<DMAX>(o, p.st[O][2], Qs, acc, inv, W, rw, D, flags & 2);
  if ((W.lane & 3) == 0) {  // one lane of each quad
    const long long row_base = ((long long)b * p.NQ + h) * Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // lse = m + log(l) in base e; a row with no key keeps NEG_INF
      const int row = r0 + 8 * r;
      if (row < Sq) p.lse[row_base + row] = (m[r] == NEG_INF ? NEG_INF : m[r] * LN2) + logf(lc[r]);
    }
  }
}

// One K/V tile's products for the warp, bf16: S = Q K^T, then dP = dO V^T
// (one product after the other: half the fragments live at once), P and dS
// in registers (the keep test only when MASKED), then dQ += dS K.
template <int DMAX, int BK, bool DALL, bool FULL, bool MASKED>
__device__ __forceinline__ void dq_tile_bf16(float (&acc)[DMAX / 8][4], const Strip& W, const bf16* Qs,
                                             const bf16* DOs, const bf16* Kt, const bf16* Vt, int k0, int nlive,
                                             int r0, float sl2, const float* lse2, const float* dl) {
  constexpr int NKF = BK / 8;
  const int tg = W.lane & 3;
  float s[NKF][4], dp[NKF][4];
  scores_bf16<DMAX, BK, DALL, FULL, 2>(s, W, Qs, Kt, nlive);
  scores_bf16<DMAX, BK, DALL, FULL, 2>(dp, W, DOs, Vt, nlive);
  const int rt = W.m0 + (W.lane >> 2);  // the thread's first row, in the block
  const float ls[2] = {lse2[rt], lse2[rt + 8]}, ds[2] = {dl[rt], dl[rt + 8]};
#pragma unroll
  for (int n = 0; n < NKF; ++n) {  // P, then dS = P (dP - delta), in place of S
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pv = ex2(fmaf(s[n][e], sl2, -ls[e >> 1]));
      if (MASKED) {
        const int row = r0 + 8 * (e >> 1), key = k0 + 8 * n + 2 * tg + (e & 1);
        if (!(row < W.Sq && keep_score(row, key, W.kvlen, W.causal))) pv = 0.f;
      }
      s[n][e] = pv * (dp[n][e] - ds[e >> 1]);
    }
  }
  pv_bf16<DMAX, BK, DALL, FULL>(acc, s, W, Kt, nlive);
}

// grid (ceil(Sq / BM), NQ, B), BM = 16 NWARP query rows, the blocks of the
// longest causal sweeps first; warp w owns rows 16 w .. + 15 and every
// output column. Shared: Qs, DOs (BM rows), two K and two V buffers (BK
// rows), the block's rows of lse (in base 2) and delta, read each tile
// rather than held in registers. flags: 1 q, k, v, dO rows 16-byte
// aligned, 2 dq rows likewise.
template <int DMAX, int NWARP, int MINB, int BK, bool DALL>
__global__ void __launch_bounds__(32 * NWARP, MINB) flash_dq_bf16_kernel(const Params p, int flags) {
  constexpr int NTH = 32 * NWARP, LDH = DMAX + 8, BM = 16 * NWARP, NKS = BK / 16, TK = BK * LDH;
  extern __shared__ float4 smem_v[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_v);
  bf16* DOs = Qs + BM * LDH;
  bf16* Ks = DOs + BM * LDH;
  bf16* Vs = Ks + 2 * TK;
  float* lse2 = reinterpret_cast<float*>(Vs + 2 * TK);
  float* dl = lse2 + BM;
  const bool vec = flags & 1;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int hk = h / (int)(p.NQ / p.NKV);
  Strip W;
  W.lane = threadIdx.x & 31;
  W.m0 = 16 * warp;
  W.DK = (D + 15) & ~15;
  W.Sq = Sq;
  W.kvlen = min(max(p.kvlen[b], 0), Sk);
  W.causal = p.causal != 0;
  const float scale = (float)p.scale, sl2 = scale * LOG2E;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.st[DOUT][0] + h * p.st[DOUT][1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  bf16* dq = static_cast<bf16*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];
  const long long row_base = ((long long)b * p.NQ + h) * Sq;

  const int rw = q0 + W.m0, r0 = rw + (W.lane >> 2);  // the warp's first row, the thread's first
  // lse in base 2 (P = exp2(s scale log2(e) - lse log2(e))) and delta of the block's rows
  for (int i = threadIdx.x; i < BM; i += NTH) {
    const bool ok = q0 + i < Sq;
    lse2[i] = ok ? p.lse[row_base + q0 + i] * LOG2E : 0.f;
    dl[i] = ok ? p.delta[row_base + q0 + i] : 0.f;
  }
  const bool live = rw < Sq;  // a warp wholly past Sq does no product
  int klim = W.kvlen;         // keys the warp's rows can see
  if (W.causal) klim = min(klim, min(rw + 16, Sq));
  int kend = W.kvlen;  // keys any row of the block can see
  if (W.causal) kend = min(kend, min(q0 + BM, Sq));
  const int nk = (kend + BK - 1) / BK;

  if (nk > 0) {
    stage_bf16<LDH, NTH>(Qs, q, p.st[Q][2], q0, BM, Sq, D, W.DK, vec);
    stage_bf16<LDH, NTH>(DOs, dout, p.st[DOUT][2], q0, BM, Sq, D, W.DK, vec);
    stage_bf16<LDH, NTH>(Ks, k, p.st[K][2], 0, BK, Sk, D, W.DK, vec);
    stage_bf16<LDH, NTH>(Vs, v, p.st[V][2], 0, BK, Sk, D, W.DK, vec);
  }
  cp_async_commit();

  float acc[DMAX / 8][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // the next tile's copies run while this one is used
      const int nxt = (kt + 1) * BK;
      stage_bf16<LDH, NTH>(Ks + (cur ^ 1) * TK, k, p.st[K][2], nxt, BK, Sk, D, W.DK, vec);
      stage_bf16<LDH, NTH>(Vs + (cur ^ 1) * TK, v, p.st[V][2], nxt, BK, Sk, D, W.DK, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * BK;
    const int nlive = min(max((klim - k0 + 15) >> 4, 0), NKS);  // 16-key steps with a live key
    if (live && nlive > 0) {
      const bf16* Kt = Ks + cur * TK;
      const bf16* Vt = Vs + cur * TK;
      // every score of the tile kept: no key at or past kvlen, no row past
      // Sq, no key in the causal future of the warp's first row
      const bool clear = k0 + BK <= W.kvlen && rw + 16 <= Sq && (!W.causal || k0 + BK - 1 <= rw);
      if (nlive < NKS)
        dq_tile_bf16<DMAX, BK, DALL, false, true>(acc, W, Qs, DOs, Kt, Vt, k0, nlive, r0, sl2, lse2, dl);
      else if (!clear)
        dq_tile_bf16<DMAX, BK, DALL, true, true>(acc, W, Qs, DOs, Kt, Vt, k0, nlive, r0, sl2, lse2, dl);
      else
        dq_tile_bf16<DMAX, BK, DALL, true, false>(acc, W, Qs, DOs, Kt, Vt, k0, nlive, r0, sl2, lse2, dl);
    }
    __syncthreads();  // the buffer is refilled next iteration
  }
  cp_async_wait<0>();
  const float mul[2] = {scale, scale};
  if (live) store_strip<DMAX>(dq, p.st[DQ][2], Qs, acc, mul, W, rw, D, flags & 2);
}

template <typename KernelFn, typename... Args>
cudaError_t launch(KernelFn kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Whether every row of q, k, v and dO starts 16-byte aligned and holds whole
// 16-byte chunks, so f32 tiles can be copied 16 bytes at a time.
bool rows_aligned16(const Params& p) {
  if (p.D % 4) return false;
  const void* ptrs[4] = {p.q, p.k, p.v, p.dout};
  const int which[4] = {Q, K, V, DOUT};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[which[i]][j] % 4) return false;
  }
  return true;
}

// NW warps a block, MINB blocks an SM asked of the register allocator,
// DSPLIT warps to a 16-row strip, and the swept tiles (K/V for the forward
// and dQ, Q/dO for dK/dV) BT rows.
template <typename T, int DMAX, int NW, int MINB, int DSPLIT, int BT>
cudaError_t run_fwd(const Params& p, cudaStream_t stream) {
  constexpr int rows = 16 * NW / DSPLIT;  // query rows a block owns
  constexpr size_t smem = sizeof(float) * (DMAX + 4) * (2 * rows + 8 * BT);  // split Q, two split buffers of two
  const int vec = std::is_same<T, float>::value && rows_aligned16(p);
  return launch(flash_fwd_kernel<T, DMAX, NW, MINB, DSPLIT, BT>,
                dim3((unsigned)((p.Sq + rows - 1) / rows), (unsigned)p.NQ, (unsigned)p.B), 32 * NW, smem,
                stream, p, vec);
}

// WHICH: 1 dQ, 2 dK/dV.
template <int WHICH, typename T, int DMAX, int NW, int MINB, int DSPLIT, int BT>
cudaError_t run_bwd(const Params& p, cudaStream_t stream) {
  constexpr size_t row = sizeof(float) * (DMAX + 4);
  const int vec = std::is_same<T, float>::value && rows_aligned16(p);
  constexpr int rows = 16 * NW / DSPLIT;  // rows a block owns
  constexpr size_t smem = row * (2 * rows + 8 * BT);  // two owned tiles, two split buffers of two
  if constexpr (WHICH == 1)
    return launch(flash_dq_kernel<T, DMAX, NW, MINB, DSPLIT, BT>,
                  dim3((unsigned)((p.Sq + rows - 1) / rows), (unsigned)p.NQ, (unsigned)p.B), 32 * NW,
                  smem, stream, p, vec);
  else
    return launch(flash_dkv_kernel<T, DMAX, NW, MINB, DSPLIT, BT>,
                  dim3((unsigned)((p.Sk + rows - 1) / rows), (unsigned)p.NKV, (unsigned)p.B), 32 * NW,
                  smem + sizeof(float) * 4 * BT, stream, p, vec);
}

// Whether the rows of the operands in `which` start 16-byte aligned and hold
// whole 16-byte chunks of 8 bf16 elements.
bool bf16_rows16(const Params& p, std::initializer_list<int> which) {
  if (p.D % 8) return false;
  const void* ptrs[8] = {p.q, p.k, p.v, p.dout, p.o, p.dq, p.dk, p.dv};
  for (int i : which) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (p.st[i][j] % 8) return false;
  }
  return true;
}

// The bf16 forward (WHICH 0) or dQ (1): NW warps of 16 rows, MINB blocks
// an SM asked of the register allocator, K/V swept in tiles of BK keys;
// the kernel without column tests when D rounds up to DMAX.
template <int WHICH, int DMAX, int NW, int MINB, int BK>
cudaError_t run_bf16(const Params& p, cudaStream_t stream) {
  constexpr int rows = 16 * NW;  // query rows a block owns
  // Q (and dO), two K and two V buffers (and dQ's rows of lse and delta)
  constexpr size_t smem = sizeof(bf16) * (DMAX + 8) * ((WHICH == 0 ? 1 : 2) * rows + 4 * BK) +
                          (WHICH == 0 ? 0 : 2 * sizeof(float) * rows);
  const dim3 grid((unsigned)((p.Sq + rows - 1) / rows), (unsigned)p.NQ, (unsigned)p.B);
  const bool dall = (p.D + 15) / 16 * 16 == DMAX;
  if constexpr (WHICH == 0) {
    const int flags = (int)bf16_rows16(p, {Q, K, V}) | (int)bf16_rows16(p, {O}) << 1;
    return dall ? launch(flash_fwd_bf16_kernel<DMAX, NW, MINB, BK, true>, grid, 32 * NW, smem, stream, p, flags)
                : launch(flash_fwd_bf16_kernel<DMAX, NW, MINB, BK, false>, grid, 32 * NW, smem, stream, p, flags);
  } else {
    const int flags = (int)bf16_rows16(p, {Q, K, V, DOUT}) | (int)bf16_rows16(p, {DQ}) << 1;
    return dall ? launch(flash_dq_bf16_kernel<DMAX, NW, MINB, BK, true>, grid, 32 * NW, smem, stream, p, flags)
                : launch(flash_dq_bf16_kernel<DMAX, NW, MINB, BK, false>, grid, 32 * NW, smem, stream, p, flags);
  }
}

// WHICH: 0 forward, 1 dQ, 2 dK/dV. The bf16 forward and dQ up to D = 128
// take the bf16 design: 4 warps of 16 rows (64 query rows a block), 32-key
// tiles; up to 64, 27 and 37 KB of shared memory at four and three blocks
// an SM; up to 128, 51 and 69 KB at three blocks an SM (168 registers a
// thread). On an H100 80GB HBM3, three blocks of 32-key tiles ran the
// forward at the LM engine's shape in 0.52 ms, two of 64-key tiles in
// 0.75; two 16-row m-tiles a warp (each K/V fragment feeding two products)
// spilled past 255 registers. Above 128 they keep the f32 design's code,
// with bf16 staged as f32: a warp owning all 256 output columns would hold
// 128 accumulators besides S. Everything else, three head-dim tiers of the
// f32 design (rows a block owns, swept tile, shared memory, the same for
// all three kernels): up to 64, 8 warps at two blocks an SM (128 rows, 16,
// 102 KB); up to 128, 4 warps (32 rows, 16, 99 KB); up to 256, 4 warps (32
// rows, 16, 195 KB). Above 64 two warps share a 16-row strip, each with
// half the output columns, so the accumulators fit in registers.
template <typename T, int WHICH>
cudaError_t run_d(const Params& p, cudaStream_t stream) {
  if (p.D < 1 || p.D > 256) return cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value && WHICH < 2) {
    if (p.D <= 64) return run_bf16<WHICH, 64, 4, WHICH == 0 ? 4 : 3, 32>(p, stream);
    if (p.D <= 128) return run_bf16<WHICH, 128, 4, 3, 32>(p, stream);
    if constexpr (WHICH == 0)
      return run_fwd<T, 256, 4, 1, 2, 16>(p, stream);
    else
      return run_bwd<WHICH, T, 256, 4, 1, 2, 16>(p, stream);
  } else if constexpr (WHICH == 0) {
    if (p.D <= 64) return run_fwd<T, 64, 8, 2, 1, 16>(p, stream);
    if (p.D <= 128) return run_fwd<T, 128, 4, 1, 2, 16>(p, stream);
    return run_fwd<T, 256, 4, 1, 2, 16>(p, stream);
  } else {
    if (p.D <= 64) return run_bwd<WHICH, T, 64, 8, 2, 1, 16>(p, stream);
    if (p.D <= 128) return run_bwd<WHICH, T, 128, 4, 1, 2, 16>(p, stream);
    return run_bwd<WHICH, T, 256, 4, 1, 2, 16>(p, stream);
  }
}

}  // namespace

// The library is one translation unit, or FLASH_PARTS of them built side by
// side from this file (common.load_cuda, -DKERNEL_PART=i) and linked: part
// 3 d + w holds kernel w (0 forward, 1 dQ, 2 dK/dV) at dtype d (0 float32,
// 1 bfloat16), each with its three head-dim tiers, and the last part the
// entry points. Each part's compile is a sixth of the whole one.
#define FLASH_PARTS 7
#define FLASH_PART(i, T, WHICH)                                                                    \
  extern "C" int flash_part##i(const void* params, void* stream) {                                 \
    return run_d<T, WHICH>(*static_cast<const Params*>(params), static_cast<cudaStream_t>(stream)); \
  }
#ifdef KERNEL_PART
#define IN_PART(i) (KERNEL_PART == (i))
#else
#define IN_PART(i) 1
#endif

#if IN_PART(0)
FLASH_PART(0, float, 0)
#endif
#if IN_PART(1)
FLASH_PART(1, float, 1)
#endif
#if IN_PART(2)
FLASH_PART(2, float, 2)
#endif
#if IN_PART(3)
FLASH_PART(3, __nv_bfloat16, 0)
#endif
#if IN_PART(4)
FLASH_PART(4, __nv_bfloat16, 1)
#endif
#if IN_PART(5)
FLASH_PART(5, __nv_bfloat16, 2)
#endif

#if IN_PART(FLASH_PARTS - 1)
extern "C" {

int flash_part0(const void*, void*);
int flash_part1(const void*, void*);
int flash_part2(const void*, void*);
int flash_part3(const void*, void*);
int flash_part4(const void*, void*);
int flash_part5(const void*, void*);

// which: 0 forward, 1 dQ, 2 dK/dV; dtype: 0 float32, 1 bfloat16. Returns the
// launch's cudaError_t.
int flash_launch(int which, const void* params, int dtype, void* stream) {
  static int (*const parts[6])(const void*, void*) = {flash_part0, flash_part1, flash_part2,
                                                      flash_part3, flash_part4, flash_part5};
  if (which < 0 || which > 2 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  return parts[3 * dtype + which](params, stream);
}

const char* flash_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_params_size() { return (int)sizeof(Params); }

int flash_parts() { return FLASH_PARTS; }

}  // extern "C"
#endif
