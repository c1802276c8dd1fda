// Batched unpivoted Gauss-Jordan solve for sm_90a: the LIME weighted
// least-squares kernel, bound to Python through ctypes
// (src/repro_torch/kernels/lstsq/kernel.py).
//
// Replaces src/repro/kernels/lstsq/kernel.py:
//   wls_solve_pallas (_gauss_jordan_kernel) -> gauss_jordan_kernel
//
// What it computes is the Pallas kernel's contract: for each batch row, the
// prepared system (A + ridge I, masked rows pinned to identity with a zero
// right-hand side; kernels/lstsq/ref.py prepare_normal_eqs) is swept pivot by
// pivot without pivoting: inv = 1 / A[k][k], row_k = A[k] * inv,
// b_k = b[k] * inv, A <- A - colz (x) row_k and b <- b - colz * b_k, where
// colz is column k of A with the pivot row zeroed, and the pivot row is then
// overwritten by row_k (b_k). After N sweeps b holds the solution.
//
// Bound on the H100: launch latency. At the LIME slice's shape (16 systems of
// 17 x 17, f32) the kernel reads 20 KB and does about 0.2 MFLOP: a bound of a
// few nanoseconds, far below the microseconds a launch takes. Design, simple
// before fast: one block of 256 threads per batch row; the row's system and
// right-hand side stay in shared memory for the whole sweep, threads striding
// over the N x N elements. Each pivot step is two phases split by
// __syncthreads(): the pivot row (times 1/piv), the pivot column (zero on the
// pivot row) and b_k are copied into shared buffers, then every element is
// updated from those buffers, so no thread reads an element another thread is
// writing. The TPU pulled the pivot row and column out with masked sums over
// iota masks; here they are direct shared-memory reads, which are exact, so
// the arithmetic is the same. Every operation is an explicitly rounded
// intrinsic (__frcp_rn, __fmul_rn, __fsub_rn and their f64 twins), so nvcc
// contracts nothing into an FMA and the result equals the plain version's,
// which rounds each PyTorch operation on its own, bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block

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

// grid (B). Shared: As (N x N), bs (N), rowk (N), colz (N), bk (1).
template <typename T>
__global__ void __launch_bounds__(NT) gauss_jordan_kernel(const T* __restrict__ A,
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
  for (int e = threadIdx.x; e < N * N; e += NT) As[e] = a[e];
  for (int i = threadIdx.x; i < N; i += NT) bs[i] = rhs[row * N + i];
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    const T inv = Op<T>::rcp(As[k * N + k]);
    for (int j = threadIdx.x; j < N; j += NT) {
      rowk[j] = Op<T>::mul(As[k * N + j], inv);
      colz[j] = j == k ? T(0) : As[j * N + k];
    }
    if (threadIdx.x == 0) bk[0] = Op<T>::mul(bs[k], inv);
    __syncthreads();
    for (int e = threadIdx.x; e < N * N; e += NT) {
      const int i = e / N, j = e - i * N;
      As[e] = i == k ? rowk[j] : Op<T>::sub(As[e], Op<T>::mul(colz[i], rowk[j]));
    }
    for (int i = threadIdx.x; i < N; i += NT)
      bs[i] = i == k ? bk[0] : Op<T>::sub(bs[i], Op<T>::mul(colz[i], bk[0]));
    __syncthreads();
  }
  for (int i = threadIdx.x; i < N; i += NT) out[row * N + i] = bs[i];
}

template <typename T>
size_t smem_bytes(int N) {
  return sizeof(T) * ((size_t)N * N + 3 * (size_t)N + 1);
}

template <typename T>
int run(const void* A, const void* rhs, void* out, long long B, int N, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<T>(N);
  if (N <= 0 || B <= 0 || B > 0x7fffffffLL || smem > (size_t)limit) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(gauss_jordan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  gauss_jordan_kernel<T><<<(unsigned)B, NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(rhs), static_cast<T*>(out), N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A (B, N, N), rhs (B, N) and out (B, N), contiguous, on the current device.
// dtype: 0 float32, 1 float64. Returns the launch's cudaError_t.
int wls_launch(const void* A, const void* rhs, void* out, long long B, int N, int dtype,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(A, rhs, out, B, N, s);
  if (dtype == 1) return run<double>(A, rhs, out, B, N, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory the kernel needs for an N x N system.
long long wls_smem_bytes(int N, int dtype) {
  return (long long)(dtype == 1 ? smem_bytes<double>(N) : smem_bytes<float>(N));
}

const char* wls_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
