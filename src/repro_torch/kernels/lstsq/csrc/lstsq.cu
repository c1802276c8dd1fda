// Batched unpivoted Gauss-Jordan solve for sm_90a: the LIME weighted
// least-squares kernels, bound to Python through ctypes
// (src/repro_torch/kernels/lstsq/kernel.py).
//
// Replaces src/repro/kernels/lstsq/kernel.py:
//   wls_solve_pallas (_gauss_jordan_kernel) -> gauss_jordan_warp_kernel,
//   gauss_jordan_regs_kernel and gauss_jordan_kernel, one per system size
//
// What they compute is the Pallas kernel's contract: for each batch row, the
// prepared system (A + ridge I, masked rows pinned to identity with a zero
// right-hand side; kernels/lstsq/ref.py prepare_normal_eqs) is swept pivot by
// pivot without pivoting: inv = 1 / A[k][k], row_k = A[k] * inv,
// b_k = b[k] * inv, A <- A - colz (x) row_k and b <- b - colz * b_k, where
// colz is column k of A with the pivot row zeroed, and the pivot row is then
// overwritten by row_k (b_k). After N sweeps b holds the solution. Every
// operation is an explicitly rounded intrinsic (__frcp_rn, __fmul_rn,
// __fsub_rn and their f64 twins), so nvcc contracts nothing into an FMA and
// each kernel's result equals the plain version's, which rounds each PyTorch
// operation on its own, bit for bit. The right-hand side is swept as column N
// of the augmented [A | b], with the same operations as the other columns.
//
// Bound on the H100: latency. At the LIME slice's shape (16 systems of
// 17 x 17, f32) the solve reads 20 KB and does about 0.2 MFLOP, a bound of a
// few nanoseconds; the N pivots are a chain of dependent steps, so what
// counts is the latency of one pivot. The variant follows the size
// (kernel.py solve_plan):
//   - gauss_jordan_warp_kernel, N + 1 <= 32 (LIME's 17): one warp per
//     system, several systems a block. Lane j holds column j of [A | b] in
//     registers for the whole sweep; the pivot column reaches every lane by
//     __shfl_sync, each lane scales its own element of the pivot row. No
//     barrier, no shared memory, no division. The rows rotate through fixed
//     register slots (8 to 32, the fewest that hold N) so that the pivot row
//     is always the first: the loop over the rows is unrolled and the loop
//     over the pivots is not, so no register array is indexed at run time
//     and the code stays small (unrolled over both, the code grew with
//     N^2 and ran slower than the shared-memory kernel).
//   - gauss_jordan_regs_kernel, N <= 68 (the CNN zoo's 65): one block per
//     system of ceil(N/R)^2 threads (R = 4), each holding R rows x R columns
//     of A (cyclically spread), and the R entries of b on those rows, in
//     registers for the whole sweep. The next pivot's row and column go
//     through double-buffered shared memory, so one barrier a pivot
//     suffices.
//   - gauss_jordan_kernel, larger N: the whole system in shared memory, 256
//     threads striding over it, two barriers a pivot.
// kernel.py works out each launch's plan (variant, threads and systems a
// block, shared-memory bytes) and passes it whole; the constants below are
// the kernels' compile-time maxima, which its plans stay within.
#include <cuda_runtime.h>

namespace {

constexpr int WARP_LANES = 32;  // the warp variant: lanes, so N + 1 <= 32
constexpr int WARP_MAX_SYSTEMS = 8;  // the warp variant: systems (warps) a block at most
// the register variant: R x R elements a thread, side x side threads a
// block at most, so N <= 68
constexpr int REGS_R = 4, REGS_MAX_SIDE = 17;
// the shared-memory variant's block; its loops stride by it as a constant,
// which ran faster than a stride read from blockDim.x
constexpr int SHARED_THREADS = 256;

enum Variant { WARP = 0, REGS = 1, SHARED = 2 };  // kernel.py's VARIANTS

template <typename T>
struct Op;
template <>
struct Op<float> {
  static __device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};
template <>
struct Op<double> {
  static __device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

// grid (ceil(B / systems)), block (32 * systems). Warp w of a block solves
// system blockIdx.x * systems + w. Lane j holds column j of [A | b] in NS
// register slots (N <= NS, a multiple of 8), one row a slot, the pivot row
// always in slot 0: row i starts in slot i, the slots past N are zero rows,
// and after each pivot the slots shift down by one and the scaled pivot row
// goes to slot NS - 1. So at pivot k, slots 0 .. N-1-k hold rows k .. N-1
// and slots NS-k .. NS-1 rows 0 .. k-1; after the sweep row i sits in slot
// NS - N + i. The zero rows between are swept as well: with no branch
// between them the shuffles go out back to back (a branch a slot
// serialised them). They never feed a real row and are never stored.
template <typename T, int NS>
__global__ void __launch_bounds__(WARP_LANES* WARP_MAX_SYSTEMS)
    gauss_jordan_warp_kernel(const T* __restrict__ A, const T* __restrict__ rhs, T* __restrict__ out,
                             int N, long long B) {
  const int lane = threadIdx.x % WARP_LANES;
  const long long sys = (long long)blockIdx.x * (blockDim.x / WARP_LANES) + threadIdx.x / WARP_LANES;
  if (sys >= B) return;  // the whole warp leaves together
  const T* a = A + sys * N * N;
  const T* b = rhs + sys * N;
  T col[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    col[s] = T(0);
    if (s < N) col[s] = lane < N ? a[s * N + lane] : (lane == N ? b[s] : T(0));
  }
  for (int k = 0; k < N; ++k) {
    // the shuffles first (colz = A[row][k], from lane k): they do not wait
    // on the reciprocal, whose slow-path branch would keep them behind it
    T cz[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) cz[s] = __shfl_sync(0xffffffffu, col[s], k);
    const T inv = Op<T>::rcp(cz[0]);
    const T rk = Op<T>::mul(col[0], inv);  // this lane's element of row_k (b_k on lane N)
#pragma unroll
    for (int s = 1; s < NS; ++s) col[s] = Op<T>::sub(col[s], Op<T>::mul(cz[s], rk));
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) col[s] = col[s + 1];
    col[NS - 1] = rk;
  }
  if (lane == N) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s >= NS - N) out[sys * N + s - (NS - N)] = col[s];
  }
}

// grid (B), block (side x side) with side = ceil(N / R), span = side R >= N.
// Thread (ty, tx) holds v[r][c] = A[ty + side r][tx + side c] and bv[r] =
// b[ty + side r] (stored from tx = 0); rows and columns past N are padding.
// Shared: rowb[2][span + 1] (the pivot row, b_k last) and colb[2][span]
// (the pivot column) of two pivots. The buffers span the padding too, so
// the pivot loop reads and writes them without bounds checks; padding never
// feeds a real element. Only the threads that hold the next pivot's row or
// column store it, R values each: a store predicated off still takes an
// issue slot of the memory pipe, so R x R of them a pivot cost more than the
// elimination itself.
template <typename T>
__global__ void __launch_bounds__(REGS_MAX_SIDE* REGS_MAX_SIDE)
    gauss_jordan_regs_kernel(const T* __restrict__ A, const T* __restrict__ rhs, T* __restrict__ out,
                             int N) {
  constexpr int R = REGS_R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int side = (N + R - 1) / R, span = side * R;
  T* rowb = reinterpret_cast<T*>(smem_raw);
  T* colb = rowb + 2 * (span + 1);
  const int tx = threadIdx.x % side, ty = threadIdx.x / side;
  const long long sys = blockIdx.x;
  const T* a = A + sys * N * N;
  const T* b = rhs + sys * N;
  int ri[R], cj[R];
#pragma unroll
  for (int r = 0; r < R; ++r) ri[r] = ty + side * r;
#pragma unroll
  for (int c = 0; c < R; ++c) cj[c] = tx + side * c;
  T v[R][R], bv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bv[r] = ri[r] < N ? b[ri[r]] : T(0);
#pragma unroll
    for (int c = 0; c < R; ++c) v[r][c] = ri[r] < N && cj[c] < N ? a[ri[r] * N + cj[c]] : T(0);
  }
  if (ty == 0) {  // row 0 and b_0
#pragma unroll
    for (int c = 0; c < R; ++c) rowb[cj[c]] = v[0][c];
    if (tx == 0) rowb[span] = bv[0];
  }
  if (tx == 0) {  // column 0
#pragma unroll
    for (int r = 0; r < R; ++r) colb[ri[r]] = v[r][0];
  }
  __syncthreads();
  int own = 1 % side, blk = 1 / side;  // k + 1 = own + side blk
  for (int k = 0; k < N; ++k) {
    const T* rowk = rowb + (k & 1) * (span + 1);
    const T* colk = colb + (k & 1) * span;
    T* rown = rowb + ((k + 1) & 1) * (span + 1);
    T* coln = colb + ((k + 1) & 1) * span;
    T rk[R], cz[R];  // the loads first, ahead of the reciprocal's slow-path branch
#pragma unroll
    for (int c = 0; c < R; ++c) rk[c] = rowk[cj[c]];
#pragma unroll
    for (int r = 0; r < R; ++r) cz[r] = colk[ri[r]];
    const T bk0 = rowk[span];
    const T inv = Op<T>::rcp(colk[k]);
    const T bk = Op<T>::mul(bk0, inv);
#pragma unroll
    for (int c = 0; c < R; ++c) rk[c] = Op<T>::mul(rk[c], inv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool on_row = ri[r] == k;
      bv[r] = on_row ? bk : Op<T>::sub(bv[r], Op<T>::mul(cz[r], bk));
#pragma unroll
      for (int c = 0; c < R; ++c)
        v[r][c] = on_row ? rk[c] : Op<T>::sub(v[r][c], Op<T>::mul(cz[r], rk[c]));
    }
    // the next pivot's row and column, into the buffer no thread reads now:
    // row and column k + 1 = own + side blk are held at index blk by the
    // threads with ty = own and tx = own, which pick them out by selects
    if (ty == own) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        T x = v[0][c];
#pragma unroll
        for (int r = 1; r < R; ++r) x = r == blk ? v[r][c] : x;
        rown[cj[c]] = x;
      }
      if (tx == 0) {
        T x = bv[0];
#pragma unroll
        for (int r = 1; r < R; ++r) x = r == blk ? bv[r] : x;
        rown[span] = x;
      }
    }
    if (tx == own) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T x = v[r][0];
#pragma unroll
        for (int c = 1; c < R; ++c) x = c == blk ? v[r][c] : x;
        coln[ri[r]] = x;
      }
    }
    if (++own == side) own = 0, ++blk;
    __syncthreads();
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (ri[r] < N) out[sys * N + ri[r]] = bv[r];
  }
}

// grid (B), block (SHARED_THREADS). Shared: As (N x N), bs (N), rowk (N),
// colz (N), bk (1).
template <typename T>
__global__ void __launch_bounds__(SHARED_THREADS) gauss_jordan_kernel(const T* __restrict__ A,
                                                                      const T* __restrict__ rhs,
                                                                      T* __restrict__ out, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* bs = As + N * N;
  T* rowk = bs + N;
  T* colz = rowk + N;
  T* bk = colz + N;
  const long long row = blockIdx.x;
  const T* a = A + row * N * N;
  for (int e = threadIdx.x; e < N * N; e += SHARED_THREADS) As[e] = a[e];
  for (int i = threadIdx.x; i < N; i += SHARED_THREADS) bs[i] = rhs[row * N + i];
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    const T inv = Op<T>::rcp(As[k * N + k]);
    for (int j = threadIdx.x; j < N; j += SHARED_THREADS) {
      rowk[j] = Op<T>::mul(As[k * N + j], inv);
      colz[j] = j == k ? T(0) : As[j * N + k];
    }
    if (threadIdx.x == 0) bk[0] = Op<T>::mul(bs[k], inv);
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += SHARED_THREADS) {
      const int i = e / N, j = e - i * N;
      As[e] = i == k ? rowk[j] : Op<T>::sub(As[e], Op<T>::mul(colz[i], rowk[j]));
    }
    for (int i = threadIdx.x; i < N; i += SHARED_THREADS)
      bs[i] = i == k ? bk[0] : Op<T>::sub(bs[i], Op<T>::mul(colz[i], bk[0]));
    __syncthreads();
  }
  for (int i = threadIdx.x; i < N; i += SHARED_THREADS) out[row * N + i] = bs[i];
}

// The launch of one plan of kernel.py (variant_plan).
template <typename T>
cudaError_t run(const T* A, const T* rhs, T* out, long long B, int N, int variant, int threads,
                int systems, long long smem, cudaStream_t stream) {
  if (N <= 0 || B <= 0 || B > 0x7fffffffLL || systems < 1 || smem < 0) return cudaErrorInvalidValue;
  if (variant == WARP) {
    const unsigned grid = (unsigned)((B + systems - 1) / systems);
    if (N <= 8)
      gauss_jordan_warp_kernel<T, 8><<<grid, threads, 0, stream>>>(A, rhs, out, N, B);
    else if (N <= 16)
      gauss_jordan_warp_kernel<T, 16><<<grid, threads, 0, stream>>>(A, rhs, out, N, B);
    else if (N <= 24)
      gauss_jordan_warp_kernel<T, 24><<<grid, threads, 0, stream>>>(A, rhs, out, N, B);
    else if (N < WARP_LANES)
      gauss_jordan_warp_kernel<T, 32><<<grid, threads, 0, stream>>>(A, rhs, out, N, B);
    else
      return cudaErrorInvalidValue;
  } else if (variant == REGS) {
    gauss_jordan_regs_kernel<T><<<(unsigned)B, threads, (size_t)smem, stream>>>(A, rhs, out, N);
  } else if (variant == SHARED) {
    const cudaError_t e = cudaFuncSetAttribute(
        gauss_jordan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    gauss_jordan_kernel<T><<<(unsigned)B, threads, (size_t)smem, stream>>>(A, rhs, out, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A (B, N, N), rhs (B, N) and out (B, N), contiguous, on the current device.
// dtype: 0 float32, 1 float64. variant, threads and systems (a block) and
// smem (bytes a block) are a plan of kernel.py. Returns the launch's
// cudaError_t.
int wls_launch(const void* A, const void* rhs, void* out, long long B, int N, int dtype,
               int variant, int threads, int systems, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run(static_cast<const float*>(A), static_cast<const float*>(rhs), static_cast<float*>(out),
               B, N, variant, threads, systems, smem, s);
  if (dtype == 1)
    return run(static_cast<const double*>(A), static_cast<const double*>(rhs),
               static_cast<double*>(out), B, N, variant, threads, systems, smem, s);
  return cudaErrorInvalidValue;
}

const char* wls_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
