// Pairwise stationary kernel matrix  K[i, j] = var * g(|x_i - y_j|^2).
//
// Replaces the Pallas kernel stheno_tpu/experimental/pallas/kernelmatrix.py
// (pairwise_kernelmatrix, _km_kernel, _epilogue).  The lengthscale is folded
// into x and y by the caller; `var` is a one-element device tensor, so the
// launch never waits on the host.
//
// Bound on an H100: the N*M output write.  At N = M = 16384 in f32 that is
// 1 GiB, about 0.32 ms at 3.35 TB/s; the N*D + M*D input reads and the few
// flops and one exp per element are far below it.  Design: every output
// element is computed in registers and written once.  A block covers a
// 32 x 128 tile with 256 threads; a warp writes 32 consecutive floats of one
// row per store, so every store is one fully coalesced 128-byte line.
//
// Arithmetic follows the library's plain path, not the Pallas kernel's:
// the squared distance is the direct sum of (x_d - y_d)^2 (exact for D = 1,
// as stheno_tpu/ops/pairwise.py:56-62), the Matern distance is
// sqrt(max(sq, eps^2)) masked to 0 where sq == 0, and same-input calls
// write the diagonal as exactly var * g(0) = var.  Ragged N and M are masked.
//
// Batched launch: a grid dimension over a batch of C independent matrices,
// out[b] = var[b] * g(|x[b]_i - y[b]_j|^2), with per-batch element strides
// for x, y and var (0 for an operand shared by the batch, which the caller
// passes as an expanded view, never a copy).  It is what jax.vmap does to
// the pallas_call (a grid dimension for the batch), and what
// torch.func.vmap of the port's log-density asks for: one launch for all
// chains or particles.  Its bound is the C*N*M write.  The unbatched entry
// points are the batched kernel with C = 1 and zero strides, so their
// arithmetic, and their output, is unchanged.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int kTileM = 32;
constexpr int kTileN = 128;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

enum Kind { kSE = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float exp_(float v) { return expf(v); }
  static __device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
  static __device__ __forceinline__ float eps2() { return FLT_EPSILON * FLT_EPSILON; }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double exp_(double v) { return exp(v); }
  static __device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
  static __device__ __forceinline__ double eps2() { return DBL_EPSILON * DBL_EPSILON; }
};

template <typename T, int KIND>
__device__ __forceinline__ T epilogue(T sq) {
  if (KIND == kSE) return Num<T>::exp_(T(-0.5) * sq);
  const T e2 = Num<T>::eps2();
  const T d = sq > T(0) ? Num<T>::sqrt_(sq > e2 ? sq : e2) : T(0);
  if (KIND == kMatern12) return Num<T>::exp_(-d);
  if (KIND == kMatern32) {
    const T d3 = T(1.7320508075688772) * d;
    return (T(1) + d3) * Num<T>::exp_(-d3);
  }
  const T d5 = T(2.23606797749979) * d;
  return (T(1) + d5 + d5 * d5 / T(3)) * Num<T>::exp_(-d5);
}

// D1: the input dimension is 1 (the flagship path); otherwise `d` is read
// at run time and the squared distance is summed over it in registers.
template <typename T, int KIND, bool D1>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
km_kernel(const T* __restrict__ x, const T* __restrict__ y,
          const T* __restrict__ var, T* __restrict__ out,
          int n, int m, int d, int same,
          long long sx, long long sy, long long sv) {
  constexpr int kCols = kTileN / kThreadsX;
  const int j0 = blockIdx.x * kTileN + threadIdx.x;
  const int i0 = blockIdx.y * kTileM + threadIdx.y;
  const long long b = blockIdx.z;
  x += b * sx;
  y += b * sy;
  out += b * static_cast<long long>(n) * m;
  const T v = var[b * sv];

  T yv[kCols];
  if (D1) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c * kThreadsX;
      yv[c] = j < m ? y[j] : T(0);
    }
  }

  for (int r = 0; r < kTileM; r += kThreadsY) {
    const int i = i0 + r;
    if (i >= n) break;
    const T xi = D1 ? x[i] : T(0);
    T* orow = out + static_cast<size_t>(i) * m;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c * kThreadsX;
      if (j >= m) continue;
      T sq;
      if (D1) {
        const T diff = xi - yv[c];
        sq = diff * diff;
      } else {
        sq = T(0);
        const T* xr = x + static_cast<size_t>(i) * d;
        const T* yr = y + static_cast<size_t>(j) * d;
        for (int k = 0; k < d; ++k) {
          const T diff = xr[k] - yr[k];
          sq += diff * diff;
        }
      }
      orow[j] = (same && i == j) ? v : v * epilogue<T, KIND>(sq);
    }
  }
}

struct Batch {
  int count;
  long long sx, sy, sv;  // element strides between batch entries
};

template <typename T, int KIND>
void launch_kind(const T* x, const T* y, const T* var, T* out, int n, int m,
                 int d, int same, Batch bt, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((m + kTileN - 1) / kTileN, (n + kTileM - 1) / kTileM, bt.count);
  if (d == 1)
    km_kernel<T, KIND, true><<<grid, block, 0, stream>>>(x, y, var, out, n, m, d, same,
                                                         bt.sx, bt.sy, bt.sv);
  else
    km_kernel<T, KIND, false><<<grid, block, 0, stream>>>(x, y, var, out, n, m, d, same,
                                                          bt.sx, bt.sy, bt.sv);
}

template <typename T>
int launch(const T* x, const T* y, const T* var, T* out, int n, int m, int d,
           int kind, int same, Batch bt, cudaStream_t stream) {
  if (n <= 0 || m <= 0 || bt.count <= 0) return static_cast<int>(cudaSuccess);
  if ((n + kTileM - 1) / kTileM > 65535 || bt.count > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (kind) {
    case kSE: launch_kind<T, kSE>(x, y, var, out, n, m, d, same, bt, stream); break;
    case kMatern12: launch_kind<T, kMatern12>(x, y, var, out, n, m, d, same, bt, stream); break;
    case kMatern32: launch_kind<T, kMatern32>(x, y, var, out, n, m, d, same, bt, stream); break;
    case kMatern52: launch_kind<T, kMatern52>(x, y, var, out, n, m, d, same, bt, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (n, d), y: (m, d), out: (n, m), all row-major and contiguous; var: one
// element.  Same-input calls pass y == x and same = 1.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int stheno_kernelmatrix_f32(const float* x, const float* y, const float* var,
                                       float* out, int n, int m, int d, int kind,
                                       int same, cudaStream_t stream) {
  return launch<float>(x, y, var, out, n, m, d, kind, same, Batch{1, 0, 0, 0}, stream);
}

extern "C" int stheno_kernelmatrix_f64(const double* x, const double* y, const double* var,
                                       double* out, int n, int m, int d, int kind,
                                       int same, cudaStream_t stream) {
  return launch<double>(x, y, var, out, n, m, d, kind, same, Batch{1, 0, 0, 0}, stream);
}

// The batched launch: x holds `batch` (n, d) matrices `sx` elements apart,
// y `batch` (m, d) matrices `sy` apart (y == x and sy == sx for same-input
// calls), var `batch` values `sv` apart; out is (batch, n, m), contiguous.
// Each (n, d) or (m, d) matrix is row-major and contiguous.
extern "C" int stheno_kernelmatrix_batched_f32(const float* x, const float* y,
                                               const float* var, float* out, int batch,
                                               int n, int m, int d, int kind, int same,
                                               long long sx, long long sy, long long sv,
                                               cudaStream_t stream) {
  return launch<float>(x, y, var, out, n, m, d, kind, same, Batch{batch, sx, sy, sv}, stream);
}

extern "C" int stheno_kernelmatrix_batched_f64(const double* x, const double* y,
                                               const double* var, double* out, int batch,
                                               int n, int m, int d, int kind, int same,
                                               long long sx, long long sy, long long sv,
                                               cudaStream_t stream) {
  return launch<double>(x, y, var, out, n, m, d, kind, same, Batch{batch, sx, sy, sv}, stream);
}

extern "C" const char* stheno_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
