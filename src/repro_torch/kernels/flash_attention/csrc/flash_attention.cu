// Flash attention for sm_90a: the forward, dQ and dK/dV kernels, in plain
// CUDA C++ with f32 accumulation, bound to Python through ctypes
// (src/repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_fwd_pallas     (_flash_fwd_kernel)     -> flash_fwd_kernel
//   flash_attention_bwd_dq_pallas  (_flash_bwd_dq_kernel)  -> flash_dq_kernel
//   flash_attention_bwd_dkv_pallas (_flash_bwd_dkv_kernel) -> flash_dkv_kernel
//
// What they compute is the Pallas kernels' contract: GQA (query head h reads
// kv head h / G), an optional causal mask, a per-row valid key length kvlen,
// masked scores floored at NEG_INF, P recomputed in the backward from the
// forward's f32 logsumexp as keep ? exp(s - lse) : 0, dS = P (dP - delta)
// with delta = rowsum(dO O) computed outside, and the scale applied where the
// Pallas kernels apply it (on Q before Q K^T in the forward, on Q K^T and on
// the final dQ/dK sums in the backward). Rows with no valid key give O = 0
// and zero gradients.
//
// Bound on the H100: operations. At the ViT's shape (256 images, 6 heads,
// S = 196, D = 64, f32) the forward does 4 S^2 D flops per (image, head)
// for 2 (S D) reads, about 100 flops per byte. Design, simple before fast:
// one block of 256 threads (a 16 x 16 grid) per (batch, head, 64-row tile);
// tiles are staged in shared memory as f32 with an odd row stride, so column
// reads are free of bank conflicts; every thread owns a 4 x 4 piece of each
// score tile and a 4 x (DMAX/16) piece of each accumulator, in registers.
// The K/V (forward, dQ) or Q/dO (dK/dV) sweep is a loop inside the block,
// in a fixed order, and nothing is summed across blocks: no atomics, so the
// gradients are the same bits on every run. Tiles in the causal future or
// past kvlen are skipped; ragged tile edges are masked loads, not copies.
// Tensor cores, TMA and wgmma are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;            // threads per block: tx = tid % 16, ty = tid / 16
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

// Rows [row0, row0 + BT) of a (rows, D) slab with row stride ss, as f32 times
// mul, into dst (BT rows of LD floats); rows at or past nrows become 0.
template <typename T, int BT, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long ss, int row0,
                                          int nrows, int D, float mul) {
  for (int e = threadIdx.x; e < BT * D; e += NT) {
    const int r = e / D, d = e - r * D, row = row0 + r;
    dst[r * LD + d] = row < nrows ? Cvt<T>::load(src[row * ss + d]) * mul : 0.f;
  }
}

// Reductions over the 16 lanes that share ty (one row of a score tile).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool keep_score(int qi, int kj, int kvlen, bool causal) {
  return kj < kvlen && (!causal || qi >= kj);
}

// ------------------------------------------------------------------ forward
// grid (ceil(Sq / BT), NQ, B). Shared: Qs, Ks, Vs (BT x LD), Ps (BT x LP).
template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int TM = BT / 16, TD = DMAX / 16, LD = DMAX + 1, LP = BT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ps = Vs + BT * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int hk = h / (int)(p.NQ / p.NKV);
  const int kvlen = min(max(p.kvlen[b], 0), Sk);
  const bool causal = p.causal != 0;
  const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  T* o = static_cast<T*>(p.o) + b * p.st[O][0] + h * p.st[O][1];

  for (int e = threadIdx.x; e < 3 * BT * LD + BT * LP; e += NT) smem[e] = 0.f;
  __syncthreads();
  load_rows<T, BT, LD>(Qs, q, p.st[Q][2], q0, Sq, D, (float)p.scale);

  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;
  }
  int nk = (kvlen + BT - 1) / BT;
  if (causal) nk = min(nk, (int)blockIdx.x + 1);  // tiles wholly in the future are dead
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, BT, LD>(Ks, k, p.st[K][2], k0, Sk, D, 1.f);
    load_rows<T, BT, LD>(Vs, v, p.st[V][2], k0, Sk, D, 1.f);
    __syncthreads();
    float s[TM][TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], c[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = Qs[(ty * TM + r) * LD + d];
#pragma unroll
      for (int j = 0; j < TM; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TM; ++j) s[r][j] = fmaf(a[r], c[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int qi = q0 + ty * TM + r;
      bool keep[TM];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        keep[j] = keep_score(qi, k0 + tx + 16 * j, kvlen, causal);
        if (keep[j]) mt = fmaxf(mt, s[r][j]);
      }
      const float mn = fmaxf(m[r], max16(mt));
      const float corr = expf(m[r] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float pv = keep[j] ? expf(s[r][j] - mn) : 0.f;
        Ps[(ty * TM + r) * LP + tx + 16 * j] = pv;
        rs += pv;
      }
      l[r] = l[r] * corr + sum16(rs);
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[r][c] *= corr;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BT; ++j) {
      float a[TM], c[TD];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = Ps[(ty * TM + r) * LP + j];
#pragma unroll
      for (int cc = 0; cc < TD; ++cc) c[cc] = Vs[j * LD + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int cc = 0; cc < TD; ++cc) acc[r][cc] = fmaf(a[r], c[cc], acc[r][cc]);
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int qi = q0 + ty * TM + r;
    if (qi >= Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < TD; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) o[qi * p.st[O][2] + d] = Cvt<T>::store(acc[r][cc] / lc);
    }
    if (tx == 0) p.lse[((long long)b * p.NQ + h) * Sq + qi] = m[r] + logf(lc);
  }
}

// ----------------------------------------------------------------------- dQ
// grid (ceil(Sq / BT), NQ, B). Shared: Qs, DOs, Ks, Vs (BT x LD), Ps (BT x LP),
// lse and delta of the tile's rows.
template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(NT) flash_dq_kernel(const Params p) {
  constexpr int TM = BT / 16, TD = DMAX / 16, LD = DMAX + 1, LP = BT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DOs = Qs + BT * LD;
  float* Ks = DOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ps = Vs + BT * LD;
  float* lse_s = Ps + BT * LP;
  float* delta_s = lse_s + BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BT;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int hk = h / (int)(p.NQ / p.NKV);
  const int kvlen = min(max(p.kvlen[b], 0), Sk);
  const bool causal = p.causal != 0;
  const float scale = (float)p.scale;
  const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
  const T* dout = static_cast<const T*>(p.dout) + b * p.st[DOUT][0] + h * p.st[DOUT][1];
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  T* dq = static_cast<T*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][1];
  const long long row_base = ((long long)b * p.NQ + h) * Sq;

  for (int e = threadIdx.x; e < 4 * BT * LD + BT * LP; e += NT) smem[e] = 0.f;
  __syncthreads();
  load_rows<T, BT, LD>(Qs, q, p.st[Q][2], q0, Sq, D, 1.f);
  load_rows<T, BT, LD>(DOs, dout, p.st[DOUT][2], q0, Sq, D, 1.f);
  if (threadIdx.x < BT) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < Sq ? p.lse[row_base + qi] : 0.f;
    delta_s[threadIdx.x] = qi < Sq ? p.delta[row_base + qi] : 0.f;
  }

  float acc[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;
  int nk = (kvlen + BT - 1) / BT;
  if (causal) nk = min(nk, (int)blockIdx.x + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_rows<T, BT, LD>(Ks, k, p.st[K][2], k0, Sk, D, 1.f);
    load_rows<T, BT, LD>(Vs, v, p.st[V][2], k0, Sk, D, 1.f);
    __syncthreads();
    float s[TM][TM], dp[TM][TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], g[TM], kc[TM], vc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        a[r] = Qs[(ty * TM + r) * LD + d];
        g[r] = DOs[(ty * TM + r) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + d];
        vc[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          s[r][j] = fmaf(a[r], kc[j], s[r][j]);
          dp[r][j] = fmaf(g[r], vc[j], dp[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = ty * TM + r, qi = q0 + i;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const bool keep = qi < Sq && keep_score(qi, k0 + tx + 16 * j, kvlen, causal);
        const float pv = keep ? expf(s[r][j] * scale - lse_s[i]) : 0.f;
        Ps[i * LP + tx + 16 * j] = pv * (dp[r][j] - delta_s[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BT; ++j) {
      float a[TM], c[TD];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = Ps[(ty * TM + r) * LP + j];
#pragma unroll
      for (int cc = 0; cc < TD; ++cc) c[cc] = Ks[j * LD + tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int cc = 0; cc < TD; ++cc) acc[r][cc] = fmaf(a[r], c[cc], acc[r][cc]);
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int qi = q0 + ty * TM + r;
    if (qi >= Sq) continue;
#pragma unroll
    for (int cc = 0; cc < TD; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) dq[qi * p.st[DQ][2] + d] = Cvt<T>::store(acc[r][cc] * scale);
    }
  }
}

// -------------------------------------------------------------------- dK/dV
// grid (ceil(Sk / BT), NKV, B). The block owns one K/V tile and sweeps the G
// query heads of its group and every live Q tile, as the Pallas grid's two
// innermost sequential axes do. Shared: Ks, Vs, Qs, DOs (BT x LD), Ps
// (BT x LP, P^T and then dS^T), lse and delta of the Q tile's rows. The
// thread's tile rows are K rows here: j = ty * TM + r, Q columns i = tx + 16 c.
template <typename T, int BT, int DMAX>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(const Params p) {
  constexpr int TM = BT / 16, TD = DMAX / 16, LD = DMAX + 1, LP = BT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* DOs = Qs + BT * LD;
  float* Ps = DOs + BT * LD;
  float* lse_s = Ps + BT * LP;
  float* delta_s = lse_s + BT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, hk = blockIdx.y, k0 = blockIdx.x * BT;
  const int D = (int)p.D, Sq = (int)p.Sq, Sk = (int)p.Sk;
  const int G = (int)(p.NQ / p.NKV);
  const int kvlen = min(max(p.kvlen[b], 0), Sk);
  const bool causal = p.causal != 0;
  const float scale = (float)p.scale;
  const T* k = static_cast<const T*>(p.k) + b * p.st[K][0] + hk * p.st[K][1];
  const T* v = static_cast<const T*>(p.v) + b * p.st[V][0] + hk * p.st[V][1];
  T* dk = static_cast<T*>(p.dk) + b * p.st[DK][0] + hk * p.st[DK][1];
  T* dv = static_cast<T*>(p.dv) + b * p.st[DV][0] + hk * p.st[DV][1];

  for (int e = threadIdx.x; e < 4 * BT * LD + BT * LP; e += NT) smem[e] = 0.f;
  __syncthreads();
  load_rows<T, BT, LD>(Ks, k, p.st[K][2], k0, Sk, D, 1.f);
  load_rows<T, BT, LD>(Vs, v, p.st[V][2], k0, Sk, D, 1.f);

  float dka[TM][TD], dva[TM][TD];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) dka[r][c] = dva[r][c] = 0.f;
  const int nq = (Sq + BT - 1) / BT;
  // a tile past kvlen has no valid key; causal Q tiles wholly before k0 are dead
  const int qt0 = k0 >= kvlen ? nq : (causal ? (int)blockIdx.x : 0);
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][1];
    const T* dout = static_cast<const T*>(p.dout) + b * p.st[DOUT][0] + h * p.st[DOUT][1];
    const long long row_base = ((long long)b * p.NQ + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();
      load_rows<T, BT, LD>(Qs, q, p.st[Q][2], q0, Sq, D, 1.f);
      load_rows<T, BT, LD>(DOs, dout, p.st[DOUT][2], q0, Sq, D, 1.f);
      if (threadIdx.x < BT) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? p.lse[row_base + qi] : 0.f;
        delta_s[threadIdx.x] = qi < Sq ? p.delta[row_base + qi] : 0.f;
      }
      __syncthreads();
      float s[TM][TM], dp[TM][TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TM; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[TM], vr[TM], qc[TM], gc[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          kr[r] = Ks[(ty * TM + r) * LD + d];
          vr[r] = Vs[(ty * TM + r) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < TM; ++c) {
          qc[c] = Qs[(tx + 16 * c) * LD + d];
          gc[c] = DOs[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TM; ++c) {
            s[r][c] = fmaf(qc[c], kr[r], s[r][c]);
            dp[r][c] = fmaf(gc[c], vr[r], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int j = ty * TM + r, kj = k0 + j;
#pragma unroll
        for (int c = 0; c < TM; ++c) {
          const int i = tx + 16 * c, qi = q0 + i;
          const bool keep = qi < Sq && keep_score(qi, kj, kvlen, causal);
          const float pv = keep ? expf(s[r][c] * scale - lse_s[i]) : 0.f;
          Ps[j * LP + i] = pv;
          dp[r][c] = pv * (dp[r][c] - delta_s[i]);  // now dS^T
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < BT; ++i) {  // dV += P^T dO
        float a[TM], c[TD];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = Ps[(ty * TM + r) * LP + i];
#pragma unroll
        for (int cc = 0; cc < TD; ++cc) c[cc] = DOs[i * LD + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int cc = 0; cc < TD; ++cc) dva[r][cc] = fmaf(a[r], c[cc], dva[r][cc]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TM; ++c) Ps[(ty * TM + r) * LP + tx + 16 * c] = dp[r][c];
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < BT; ++i) {  // dK += dS^T Q
        float a[TM], c[TD];
#pragma unroll
        for (int r = 0; r < TM; ++r) a[r] = Ps[(ty * TM + r) * LP + i];
#pragma unroll
        for (int cc = 0; cc < TD; ++cc) c[cc] = Qs[i * LD + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int cc = 0; cc < TD; ++cc) dka[r][cc] = fmaf(a[r], c[cc], dka[r][cc]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int kj = k0 + ty * TM + r;
    if (kj >= Sk) continue;
#pragma unroll
    for (int cc = 0; cc < TD; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        dk[kj * p.st[DK][2] + d] = Cvt<T>::store(dka[r][cc] * scale);
        dv[kj * p.st[DV][2] + d] = Cvt<T>::store(dva[r][cc]);
      }
    }
  }
}

template <typename KernelFn>
cudaError_t launch(KernelFn kern, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// which: 0 forward, 1 dQ, 2 dK/dV.
template <typename T, int BT, int DMAX>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  constexpr size_t tile = sizeof(float) * BT * (DMAX + 1), ps = sizeof(float) * BT * (BT + 1);
  const unsigned nqt = (unsigned)((p.Sq + BT - 1) / BT), nkt = (unsigned)((p.Sk + BT - 1) / BT);
  switch (which) {
    case 0:
      return launch(flash_fwd_kernel<T, BT, DMAX>, dim3(nqt, (unsigned)p.NQ, (unsigned)p.B),
                    3 * tile + ps, stream, p);
    case 1:
      return launch(flash_dq_kernel<T, BT, DMAX>, dim3(nqt, (unsigned)p.NQ, (unsigned)p.B),
                    4 * tile + ps + 2 * sizeof(float) * BT, stream, p);
    case 2:
      return launch(flash_dkv_kernel<T, BT, DMAX>, dim3(nkt, (unsigned)p.NKV, (unsigned)p.B),
                    4 * tile + ps + 2 * sizeof(float) * BT, stream, p);
  }
  return cudaErrorInvalidValue;
}

// Head dims up to 64 and 128 take 64-row tiles; up to 256, 32-row tiles, so
// the dQ and dK/dV kernels' four staged tiles fit in a block's shared memory.
template <typename T>
cudaError_t run_d(int which, const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return run<T, 64, 64>(which, p, stream);
  if (p.D <= 128) return run<T, 64, 128>(which, p, stream);
  if (p.D <= 256) return run<T, 32, 256>(which, p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
int flash_launch(int which, const void* params, int dtype, void* stream) {
  const Params& p = *static_cast<const Params*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_d<float>(which, p, s);
  if (dtype == 1) return run_d<__nv_bfloat16>(which, p, s);
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_params_size() { return (int)sizeof(Params); }

}  // extern "C"
