// Pairwise stationary kernel matrix  K[i, j] = var * g(|x_i - y_j|^2),
// and its reverse rule.
//
// Replaces the Pallas kernel stheno_tpu/experimental/pallas/kernelmatrix.py
// (pairwise_kernelmatrix, _km_kernel, _epilogue).  The lengthscale is folded
// into x and y by the caller; `var` is a device tensor, so the launch never
// waits on the host.
//
// Arithmetic follows the library's plain path, not the Pallas kernel's:
// the squared distance is the direct sum of (x_d - y_d)^2 (exact for D = 1,
// as stheno_tpu/ops/pairwise.py:56-62), the Matern distance is
// sqrt(max(sq, eps^2)) masked to 0 where sq == 0, and same-input calls
// write the diagonal as exactly var * g(0) = var.  Ragged N and M are masked.
//
// ---- The forward, km_kernel ------------------------------------------------
//
// Bound on an H100: the N*M output write.  At 3.35 TB/s in f32 that is
// 0.3205 ms at 16384^2 (any D), 0.1803 ms at 12288^2 and 0.0359 ms for the
// batched (64, 676, 676); the N*D + M*D coordinate reads are below 1 % of
// it.  The work per element is 3D + 7 flops (the differences, their
// squares and sum, the epilogue with one exp): at 67 TFLOP/s against
// 3.35 TB/s a 4-byte write buys about 80 flops, so at every D <= 16 the
// write binds.
//
// Design: D is a template parameter for every D from 1 to 16 (one generic
// instance takes D > 16, staging the coordinates through shared memory 16 at
// a time).  A CTA of 32 x 8 threads owns a 32 x 32V tile (V = 16 bytes /
// sizeof(T): 32 x 128 in f32, 32 x 64 in f64).  It stages its 32 rows of x
// (one contiguous run, kept row-major) and its 32V rows of y (transposed to
// [coordinate][column]) in shared memory once, with coalesced loads; a warp
// holds one row of the tile at a time, so each thread reads its row's
// coordinates by broadcast and its V columns' as one 16-byte vector a
// coordinate, and keeps the 4 x V squared distances in registers.  No element
// reads a coordinate from global memory.  Each thread writes a row segment of
// V adjacent elements as one 16-byte store, a warp 512 contiguous bytes of a
// row.  Where a row's start is not 16-byte aligned (M % V != 0) or at the
// ragged edge, the same kernel writes the segment element by element; the
// exact diagonal is a branch taken only by the tiles that meet it.  Against
// 64 x 64 tiles (tried on an H100), the 512-byte rows keep the wide
// 2048 x 131072 launch at its write bound; the batched (64, 676^2) launch,
// 6 x 22 tiles an entry, 85 % of them live, is bound by the arithmetic
// (about 2D + 20 instructions an element) as much as by the write.
//
// No tensor cores: the MXU route of the Pallas kernel forms the cross term as
// a matmul, |x|^2 - 2 x.y + |y|^2; on the card that is TF32 on the tensor
// cores (or fp32 without them) and, in any precision, the cancellation that
// the direct differences avoid; a product only D deep would leave the tensor
// cores idle, and the flops are not what binds at D <= 16.
//
// Batched launch: a grid dimension over a batch of C independent matrices,
// out[b] = var[b] * g(|x[b]_i - y[b]_j|^2), with per-batch element strides
// for x, y and var (0 for an operand shared by the batch, which the caller
// passes as an expanded view, never a copy).  It is what jax.vmap does to
// the pallas_call, and what torch.func.vmap of the port's log-density asks
// for: one launch for all chains or particles.  The unbatched entry points
// are the batched kernel with C = 1 and zero strides.
//
// ---- The reverse rule, km_vjp_kernel ---------------------------------------
//
// For a cotangent Kb of K = var * g(sq), with W = 2 var * Kb * g'(sq) (g' = 0
// where the Matern distance is clamped, sq <= eps^2):
//   var_bar = sum Kb * g,   x_bar_i = sum_j W_ij (x_i - y_j),
//   y_bar_j = -sum_i W_ij (x_i - y_j),
// and on same-input calls x_bar = x_bar + y_bar.
//
// Bound: the read of Kb, N*M elements (0.3205 ms at 16384^2 in f32), or about
// 6D + 15 flops an element where that takes longer (at D = 9, 69 flops: the
// read still binds by a hair at 67 TFLOP/s).
//
// Design: one read of Kb.  A CTA of 32 x 8 threads owns a strip of 32V
// columns (128 in f32, 64 in f64) and walks a run of 32-row tiles.  Each
// thread keeps its V columns' coordinates and their column sums in registers
// for the whole run; for each tile the CTA stages the 32 rows of x in shared
// memory, each thread reads its 4 x V elements of Kb with 16-byte loads
// where Kb's layout allows (scalar, strided loads otherwise: Kb is taken
// with its own row and column strides, 0 included, never copied), recomputes
// sq, g and g' in registers, and adds up W * (x_i - y_j).  A warp holds
// whole row segments, so a row's sum over the strip is a butterfly of warp
// shuffles; the 8 warps' column sums and variance partials meet in shared
// memory at the end of the run.  No floating-point atomics: every CTA writes
// its row sums (per strip), column sums (per run) and variance partial into a
// workspace that the caller allocates, and the caller adds the partials up
// in a fixed order, so two calls give the same bits.  The wrapper sizes the
// runs so that a launch has at least about 2048 CTAs where the shape allows,
// which keeps the workspace at (M / 32V) * N * D + runs * M * D values, a
// small fraction of Kb.  For D > 16 a rows-only kernel (coordinates staged 16
// at a time) runs twice, on (x, y, Kb) and on (y, x, Kb^T).

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

enum Kind { kSE = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

// coordinates one shared-memory stage holds; D <= kChunk is one stage
constexpr int kChunk = 16;

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

// elements of T in one 16-byte vector
template <typename T> constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  // a butterfly: every lane ends with the same bits, in a fixed order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// g(sq) as `epilogue` computes it, and dg/dsq, 0 where the Matern distance
// is clamped (sq <= eps^2), as cuda/kernelmatrix.py:_epilogue_grad; one exp
template <typename T, int KIND>
__device__ __forceinline__ void epilogue_grad(T sq, T& g, T& dg) {
  if (KIND == kSE) {
    g = Num<T>::exp_(T(-0.5) * sq);
    dg = T(-0.5) * g;
    return;
  }
  const T e2 = Num<T>::eps2();
  const bool live = sq > e2;
  const T d = sq > T(0) ? Num<T>::sqrt_(sq > e2 ? sq : e2) : T(0);
  if (KIND == kMatern12) {
    g = Num<T>::exp_(-d);
    dg = live ? T(-0.5) * g / d : T(0);
  } else if (KIND == kMatern32) {
    const T d3 = T(1.7320508075688772) * d;
    const T e = Num<T>::exp_(-d3);
    g = (T(1) + d3) * e;
    dg = live ? T(-1.5) * e : T(0);
  } else {
    const T d5 = T(2.23606797749979) * d;
    const T e = Num<T>::exp_(-d5);
    g = (T(1) + d5 + d5 * d5 / T(3)) * e;
    dg = live ? -(T(5) / T(6)) * (T(1) + d5) * e : T(0);
  }
}

// Stage points [p0, p0 + rows) of a row-major (count, d) matrix, coordinates
// [k0, k0 + DC), into s[k * ld + point], zero past count or d.  Consecutive
// threads read consecutive elements of a point's row.
template <typename T, int DC>
__device__ __forceinline__ void stage(T* s, int ld, const T* __restrict__ a, int p0, int rows,
                                      int count, int d, int k0, int tid, int nthreads) {
  for (int t = tid; t < rows * DC; t += nthreads) {
    const int row = t / DC;
    const int k = t - row * DC;
    const int p = p0 + row;
    const int kk = k0 + k;
    s[k * ld + row] = (p < count && kk < d) ? a[static_cast<long long>(p) * d + kk] : T(0);
  }
}

// ---- forward ----------------------------------------------------------------

constexpr int kFwdThreadsX = 32;  // a warp on one row
constexpr int kFwdThreadsY = 8;
constexpr int kFwdRows = 4;  // rows a thread, kFwdThreadsY apart
constexpr int kFwdTileM = kFwdThreadsY * kFwdRows;
template <typename T> constexpr int kFwdTileN = kFwdThreadsX * kVec<T>;

// DC coordinates a stage; GEN: d > kChunk, staged kChunk at a time.
// vec: out is 16-byte aligned and M % V == 0, so every row segment is.
template <typename T, int KIND, int DC, bool GEN>
__global__ void __launch_bounds__(kFwdThreadsX * kFwdThreadsY)
km_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ var,
          T* __restrict__ out, int n, int m, int d, int same, int vec,
          long long sx, long long sy, long long sv) {
  constexpr int V = kVec<T>;
  constexpr int TM = kFwdTileM;
  constexpr int TN = kFwdTileN<T>;
  constexpr int LDY = TN + V;  // 16-byte reads of y: keep the alignment
  constexpr int NT = kFwdThreadsX * kFwdThreadsY;
  __shared__ T xs[TM * DC];  // row-major, as in memory: a warp reads one row by broadcast
  __shared__ __align__(16) T ys[DC * LDY];  // [coordinate][column]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kFwdThreadsX + tx;
  const int j0 = blockIdx.x * TN;
  const int i0 = blockIdx.y * TM;
  const long long b = blockIdx.z;
  x += b * sx;
  y += b * sy;
  out += b * static_cast<long long>(n) * m;
  const T v = var[b * sv];
  const int dd = GEN ? d : DC;

  T sq[kFwdRows][V];
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
    for (int c = 0; c < V; ++c) sq[r][c] = T(0);

  const int chunks = GEN ? (d + DC - 1) / DC : 1;
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch > 0) __syncthreads();
    if (GEN) {
      for (int e = tid; e < TM * DC; e += NT) {
        const int p = i0 + e / DC;
        const int k = ch * DC + e % DC;
        xs[e] = p < n && k < d ? x[static_cast<long long>(p) * d + k] : T(0);
      }
    } else {  // the tile's rows are one contiguous run of x
      const long long first = static_cast<long long>(i0) * DC;
      const long long end = static_cast<long long>(n) * DC;
      for (int e = tid; e < TM * DC; e += NT) xs[e] = first + e < end ? x[first + e] : T(0);
    }
    stage<T, DC>(ys, LDY, y, j0, TN, m, dd, ch * DC, tid, NT);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      T yv[V];
      load_vec(ys + k * LDY + tx * V, yv);
#pragma unroll
      for (int r = 0; r < kFwdRows; ++r) {
        const T xv = xs[(ty + r * kFwdThreadsY) * DC + k];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const T diff = xv - yv[c];
          sq[r][c] += diff * diff;
        }
      }
    }
  }

  const int j = j0 + tx * V;
  const bool diag = same && i0 < j0 + TN && j0 < i0 + TM;  // the tile meets the diagonal
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
    const int i = i0 + ty + r * kFwdThreadsY;
    if (i < n && j < m) {
      T val[V];
#pragma unroll
      for (int c = 0; c < V; ++c) val[c] = v * epilogue<T, KIND>(sq[r][c]);
      if (diag) {  // the same for the whole CTA
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (i == j + c) val[c] = v;
      }
      T* orow = out + static_cast<long long>(i) * m;
      if (vec) {
        store_vec(orow + j, val);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (j + c < m) orow[j + c] = val[c];
      }
    }
  }
}

// ---- reverse ----------------------------------------------------------------

constexpr int kVjpThreadsX = 32;  // one warp a row segment
constexpr int kVjpThreadsY = 8;
constexpr int kVjpRows = 4;  // rows a thread a tile, kVjpThreadsY apart
constexpr int kVjpTileM = kVjpThreadsY * kVjpRows;
constexpr int kVjpThreads = kVjpThreadsX * kVjpThreadsY;
template <typename T> constexpr int kVjpTileN = kVjpThreadsX * kVec<T>;
// CTAs a launch should reach before a CTA walks more than one row tile
constexpr long long kVjpTargetCtas = 2048;

struct Strides {
  long long sx, sy, sv;  // batch strides of x, y, var
  long long sb, sr, sc;  // Kb's batch, row and column strides
};

// This thread's Kb values of a row tile: 16-byte loads where `vec` (column
// stride 1, row and batch strides multiples of V, aligned base) and the
// segment is whole, strided scalar loads otherwise; 0 outside the matrix.
template <typename T>
__device__ __forceinline__ void load_kb(const T* __restrict__ kb, int i, int j, int n, int m,
                                        long long sr, long long sc, int vec, T (&out)[kVec<T>]) {
  constexpr int V = kVec<T>;
  if (i < n && vec && j + V <= m) {
    load_vec(kb + static_cast<long long>(i) * sr + j, out);
    return;
  }
#pragma unroll
  for (int c = 0; c < V; ++c)
    out[c] = (i < n && j + c < m) ? kb[static_cast<long long>(i) * sr + static_cast<long long>(j + c) * sc]
                                  : T(0);
}

// Compile-time D (1..16): rows and columns in one read of Kb.
// px: [C][strips][n][D] row sums, py: [C][runs][m][D] column sums,
// pv: [C][runs][strips] variance partials.
template <typename T, int KIND, int D>
__global__ void __launch_bounds__(kVjpThreads)
km_vjp_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ var,
              const T* __restrict__ kb, T* __restrict__ px, T* __restrict__ py,
              T* __restrict__ pv, int n, int m, int same, int tiles, int vec, Strides st) {
  constexpr int V = kVec<T>;
  constexpr int TM = kVjpTileM;
  constexpr int TN = kVjpTileN<T>;
  constexpr int LDX = TM + 1;
  __shared__ T xs[D * LDX];
  __shared__ T red[kVjpThreadsY * TN];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kVjpThreadsX + tx;
  const int strips = gridDim.x;
  const int runs = gridDim.y;
  const int s = blockIdx.x;
  const int run = blockIdx.y;
  const long long b = blockIdx.z;
  x += b * st.sx;
  y += b * st.sy;
  kb += b * st.sb;
  const T two_v = T(2) * var[b * st.sv];
  const int j = s * TN + tx * V;

  T yv[V][D], cy[V][D];
#pragma unroll
  for (int c = 0; c < V; ++c)
#pragma unroll
    for (int k = 0; k < D; ++k) {
      yv[c][k] = j + c < m ? y[static_cast<long long>(j + c) * D + k] : T(0);
      cy[c][k] = T(0);
    }
  T gsum = T(0);

  // the run's row tiles [first, last); the plan starts every run inside the
  // matrix.  The next tile's Kb and x are loaded while this one is computed.
  constexpr int kStage = (TM * D + kVjpThreads - 1) / kVjpThreads;
  const int first = run * tiles;
  const int last = min(first + tiles, (n + TM - 1) / TM);
  T kv[kVjpRows][V];
#pragma unroll
  for (int r = 0; r < kVjpRows; ++r)
    load_kb(kb, first * TM + ty + r * kVjpThreadsY, j, n, m, st.sr, st.sc, vec, kv[r]);
  stage<T, D>(xs, LDX, x, first * TM, TM, n, D, 0, tid, kVjpThreads);
  __syncthreads();
  for (int t = first; t < last; ++t) {
    const int i0 = t * TM;
    const bool more = t + 1 < last;  // the same for the whole CTA
    T kn[kVjpRows][V], xn[kStage];
    if (more) {
#pragma unroll
      for (int r = 0; r < kVjpRows; ++r)
        load_kb(kb, i0 + TM + ty + r * kVjpThreadsY, j, n, m, st.sr, st.sc, vec, kn[r]);
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int e = tid + q * kVjpThreads;
        xn[q] = e < TM * D && i0 + TM + e / D < n ? x[static_cast<long long>(i0 + TM) * D + e] : T(0);
      }
    }
#pragma unroll
    for (int r = 0; r < kVjpRows; ++r) {
      const int i = i0 + ty + r * kVjpThreadsY;
      T xr[D], racc[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        xr[k] = xs[k * LDX + ty + r * kVjpThreadsY];
        racc[k] = T(0);
      }
#pragma unroll
      for (int c = 0; c < V; ++c) {
        T diff[D];
        T sq = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = xr[k] - yv[c][k];
          sq += diff[k] * diff[k];
        }
        if (same && i == j + c) sq = T(0);
        T g, dg;
        epilogue_grad<T, KIND>(sq, g, dg);
        gsum += kv[r][c] * g;
        const T w = two_v * kv[r][c] * dg;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          racc[k] += w * diff[k];
          cy[c][k] -= w * diff[k];
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) racc[k] = warp_sum(racc[k]);
      if (tx == 0 && i < n) {
        T* prow = px + ((b * strips + s) * n + i) * D;
#pragma unroll
        for (int k = 0; k < D; ++k) prow[k] = racc[k];
      }
    }
    if (more) {
      __syncthreads();  // this tile's reads of xs are done
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int e = tid + q * kVjpThreads;
        if (e < TM * D) xs[(e % D) * LDX + e / D] = xn[q];
      }
#pragma unroll
      for (int r = 0; r < kVjpRows; ++r)
#pragma unroll
        for (int c = 0; c < V; ++c) kv[r][c] = kn[r][c];
      __syncthreads();
    }
  }

  // the run's column sums: the 8 warps' partials, added in warp order
#pragma unroll
  for (int k = 0; k < D; ++k) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < V; ++c) red[ty * TN + tx * V + c] = cy[c][k];
    __syncthreads();
    if (tid < TN) {
      T a = T(0);
#pragma unroll
      for (int w = 0; w < kVjpThreadsY; ++w) a += red[w * TN + tid];
      const int jj = s * TN + tid;
      if (jj < m) py[((b * runs + run) * m + jj) * D + k] = a;
    }
  }
  gsum = warp_sum(gsum);
  __syncthreads();
  if (tx == 0) red[ty] = gsum;
  __syncthreads();
  if (tid == 0) {
    T a = T(0);
#pragma unroll
    for (int w = 0; w < kVjpThreadsY; ++w) a += red[w];
    pv[(b * runs + run) * strips + s] = a;
  }
}

// D > 16: the row sums only, one row tile a CTA, the coordinates staged
// kChunk at a time (twice: for sq, then for the sums).  px: [C][strips][n][d];
// pv (may be null): [C][row tiles][strips].
template <typename T, int KIND>
__global__ void __launch_bounds__(kVjpThreads)
km_vjp_rows_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ var,
                   const T* __restrict__ kb, T* __restrict__ px, T* __restrict__ pv, int n, int m,
                   int d, int same, int vec, Strides st) {
  constexpr int V = kVec<T>;
  constexpr int TM = kVjpTileM;
  constexpr int TN = kVjpTileN<T>;
  constexpr int DC = kChunk;
  constexpr int LDX = TM + 1;
  constexpr int LDY = TN + V;
  __shared__ __align__(16) T xs[DC * LDX];
  __shared__ __align__(16) T ys[DC * LDY];
  __shared__ T red[kVjpThreadsY];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kVjpThreadsX + tx;
  const int strips = gridDim.x;
  const int s = blockIdx.x;
  const int i0 = blockIdx.y * TM;
  const long long b = blockIdx.z;
  x += b * st.sx;
  y += b * st.sy;
  kb += b * st.sb;
  const T two_v = T(2) * var[b * st.sv];
  const int j = s * TN + tx * V;
  const int chunks = (d + DC - 1) / DC;

  T kv[kVjpRows][V], w[kVjpRows][V];
#pragma unroll
  for (int r = 0; r < kVjpRows; ++r) {
    load_kb(kb, i0 + ty + r * kVjpThreadsY, j, n, m, st.sr, st.sc, vec, kv[r]);
#pragma unroll
    for (int c = 0; c < V; ++c) w[r][c] = T(0);  // the squared distances, first
  }
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    stage<T, DC>(xs, LDX, x, i0, TM, n, d, ch * DC, tid, kVjpThreads);
    stage<T, DC>(ys, LDY, y, s * TN, TN, m, d, ch * DC, tid, kVjpThreads);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      T yk[V];
      load_vec(ys + k * LDY + tx * V, yk);
#pragma unroll
      for (int r = 0; r < kVjpRows; ++r) {
        const T xk = xs[k * LDX + ty + r * kVjpThreadsY];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const T diff = xk - yk[c];
          w[r][c] += diff * diff;
        }
      }
    }
  }
  T gsum = T(0);
#pragma unroll
  for (int r = 0; r < kVjpRows; ++r) {
    const int i = i0 + ty + r * kVjpThreadsY;
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const T sq = (same && i == j + c) ? T(0) : w[r][c];
      T g, dg;
      epilogue_grad<T, KIND>(sq, g, dg);
      gsum += kv[r][c] * g;
      w[r][c] = two_v * kv[r][c] * dg;
    }
  }
  for (int ch = 0; ch < chunks; ++ch) {
    __syncthreads();
    stage<T, DC>(xs, LDX, x, i0, TM, n, d, ch * DC, tid, kVjpThreads);
    stage<T, DC>(ys, LDY, y, s * TN, TN, m, d, ch * DC, tid, kVjpThreads);
    __syncthreads();
    for (int k = 0; k < DC; ++k) {
      T yk[V];
      load_vec(ys + k * LDY + tx * V, yk);
#pragma unroll
      for (int r = 0; r < kVjpRows; ++r) {
        const int i = i0 + ty + r * kVjpThreadsY;
        const T xk = xs[k * LDX + ty + r * kVjpThreadsY];
        T a = T(0);
#pragma unroll
        for (int c = 0; c < V; ++c) a += w[r][c] * (xk - yk[c]);
        a = warp_sum(a);
        const int kk = ch * DC + k;
        if (tx == 0 && i < n && kk < d) px[((b * strips + s) * n + i) * d + kk] = a;
      }
    }
  }
  if (pv != nullptr) {
    gsum = warp_sum(gsum);
    if (tx == 0) red[ty] = gsum;
    __syncthreads();
    if (tid == 0) {
      T a = T(0);
#pragma unroll
      for (int q = 0; q < kVjpThreadsY; ++q) a += red[q];
      pv[(b * gridDim.y + blockIdx.y) * strips + s] = a;
    }
  }
}

// ---- host side --------------------------------------------------------------

template <typename T>
struct Problem {
  const T* x;
  const T* y;
  const T* var;
  T* out;  // forward
  int batch, n, m, d, same;
  long long sx, sy, sv;
};

template <typename T, int KIND, int D>
void launch_fwd(const Problem<T>& p, cudaStream_t stream) {
  if constexpr (D <= kChunk) {
    if (p.d != D) return launch_fwd<T, KIND, D + 1>(p, stream);
  }
  constexpr bool gen = D > kChunk;
  constexpr int dc = gen ? kChunk : D;
  constexpr int tn = kFwdTileN<T>;
  const int vec = (p.m % kVec<T> == 0) && (reinterpret_cast<uintptr_t>(p.out) % 16 == 0);
  const dim3 block(kFwdThreadsX, kFwdThreadsY);
  const dim3 grid((p.m + tn - 1) / tn, (p.n + kFwdTileM - 1) / kFwdTileM, p.batch);
  km_kernel<T, KIND, dc, gen><<<grid, block, 0, stream>>>(p.x, p.y, p.var, p.out, p.n, p.m, p.d,
                                                          p.same, vec, p.sx, p.sy, p.sv);
}

template <typename T>
int launch(const Problem<T>& p, int kind, cudaStream_t stream) {
  if (p.n <= 0 || p.m <= 0 || p.batch <= 0) return static_cast<int>(cudaSuccess);
  if ((p.n + kFwdTileM - 1) / kFwdTileM > 65535 || p.batch > 65535 || p.d <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (kind) {
    case kSE: launch_fwd<T, kSE, 1>(p, stream); break;
    case kMatern12: launch_fwd<T, kMatern12, 1>(p, stream); break;
    case kMatern32: launch_fwd<T, kMatern32, 1>(p, stream); break;
    case kMatern52: launch_fwd<T, kMatern52, 1>(p, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// How the reverse rule cuts a (batch, n, m, d) problem: the number of row-sum
// groups (x's partials), column-sum groups (y's), variance partials, and the
// row tiles a CTA walks.
struct VjpPlan {
  long long gx, gy, gv;
  int tiles;
};

template <typename T>
VjpPlan vjp_plan(int batch, int n, int m, int d) {
  constexpr int tn = kVjpTileN<T>;
  if (n <= 0 || m <= 0 || batch <= 0) return {0, 0, 0, 1};
  const long long strips = (m + tn - 1) / tn;
  const long long row_tiles = (n + kVjpTileM - 1) / kVjpTileM;
  if (d > kChunk) {  // rows-only, twice: on (x, y, Kb) and on (y, x, Kb^T)
    return {strips, (n + tn - 1) / tn, row_tiles * strips, 1};
  }
  const long long ctas = strips * batch;
  long long runs = ctas >= kVjpTargetCtas ? 1 : (kVjpTargetCtas + ctas - 1) / ctas;
  if (runs > row_tiles) runs = row_tiles;
  const long long tiles = (row_tiles + runs - 1) / runs;
  runs = (row_tiles + tiles - 1) / tiles;
  return {strips, runs, runs * strips, static_cast<int>(tiles)};
}

template <typename T>
int kb_vec(const T* kb, int batch, long long sb, long long sr, long long sc) {
  constexpr int V = kVec<T>;
  return sc == 1 && sr % V == 0 && (batch == 1 || sb % V == 0) &&
         reinterpret_cast<uintptr_t>(kb) % 16 == 0;
}

template <typename T, int KIND, int D>
void launch_vjp_d(const Problem<T>& p, const T* kb, T* px, T* py, T* pv, Strides st,
                  cudaStream_t stream) {
  if constexpr (D <= kChunk) {
    if (p.d != D) return launch_vjp_d<T, KIND, D + 1>(p, kb, px, py, pv, st, stream);
    const VjpPlan plan = vjp_plan<T>(p.batch, p.n, p.m, p.d);
    const dim3 block(kVjpThreadsX, kVjpThreadsY);
    const dim3 grid(static_cast<unsigned>(plan.gx), static_cast<unsigned>(plan.gy), p.batch);
    km_vjp_kernel<T, KIND, D><<<grid, block, 0, stream>>>(
        p.x, p.y, p.var, kb, px, py, pv, p.n, p.m, p.same, plan.tiles,
        kb_vec(kb, p.batch, st.sb, st.sr, st.sc), st);
  } else {
    constexpr int tn = kVjpTileN<T>;
    const dim3 block(kVjpThreadsX, kVjpThreadsY);
    const dim3 grid1((p.m + tn - 1) / tn, (p.n + kVjpTileM - 1) / kVjpTileM, p.batch);
    km_vjp_rows_kernel<T, KIND><<<grid1, block, 0, stream>>>(
        p.x, p.y, p.var, kb, px, pv, p.n, p.m, p.d, p.same,
        kb_vec(kb, p.batch, st.sb, st.sr, st.sc), st);
    // the transposed problem's row sums are y's: sum_i W_ij (y_j - x_i)
    const Strides tr{st.sy, st.sx, st.sv, st.sb, st.sc, st.sr};
    const dim3 grid2((p.n + tn - 1) / tn, (p.m + kVjpTileM - 1) / kVjpTileM, p.batch);
    km_vjp_rows_kernel<T, KIND><<<grid2, block, 0, stream>>>(
        p.y, p.x, p.var, kb, py, nullptr, p.m, p.n, p.d, p.same,
        kb_vec(kb, p.batch, tr.sb, tr.sr, tr.sc), tr);
  }
}

template <typename T>
int launch_vjp(const Problem<T>& p, int kind, const T* kb, T* px, T* py, T* pv, Strides st,
               cudaStream_t stream) {
  if (p.n <= 0 || p.m <= 0 || p.batch <= 0) return static_cast<int>(cudaSuccess);
  const VjpPlan plan = vjp_plan<T>(p.batch, p.n, p.m, p.d);
  const long long row_tiles = (static_cast<long long>(p.n > p.m ? p.n : p.m) + kVjpTileM - 1) / kVjpTileM;
  if (p.batch > 65535 || p.d <= 0 || (p.d <= kChunk ? plan.gy : row_tiles) > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  switch (kind) {
    case kSE: launch_vjp_d<T, kSE, 1>(p, kb, px, py, pv, st, stream); break;
    case kMatern12: launch_vjp_d<T, kMatern12, 1>(p, kb, px, py, pv, st, stream); break;
    case kMatern32: launch_vjp_d<T, kMatern32, 1>(p, kb, px, py, pv, st, stream); break;
    case kMatern52: launch_vjp_d<T, kMatern52, 1>(p, kb, px, py, pv, st, stream); break;
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
  return launch<float>({x, y, var, out, 1, n, m, d, same, 0, 0, 0}, kind, stream);
}

extern "C" int stheno_kernelmatrix_f64(const double* x, const double* y, const double* var,
                                       double* out, int n, int m, int d, int kind,
                                       int same, cudaStream_t stream) {
  return launch<double>({x, y, var, out, 1, n, m, d, same, 0, 0, 0}, kind, stream);
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
  return launch<float>({x, y, var, out, batch, n, m, d, same, sx, sy, sv}, kind, stream);
}

extern "C" int stheno_kernelmatrix_batched_f64(const double* x, const double* y,
                                               const double* var, double* out, int batch,
                                               int n, int m, int d, int kind, int same,
                                               long long sx, long long sy, long long sv,
                                               cudaStream_t stream) {
  return launch<double>({x, y, var, out, batch, n, m, d, same, sx, sy, sv}, kind, stream);
}

// The reverse rule's workspace for a (batch, n, m, d) problem of elements of
// `itemsize` bytes: out[0] row-sum groups (px is [batch][out[0]][n][d]),
// out[1] column-sum groups (py is [batch][out[1]][m][d]), out[2] variance
// partials (pv is [batch][out[2]]).  The caller adds each over its group
// axis, in order, and on same-input calls adds the column sums to the row
// sums.
extern "C" int stheno_kernelmatrix_vjp_plan(int batch, int n, int m, int d, int itemsize,
                                            long long* out) {
  if (itemsize != 4 && itemsize != 8) return static_cast<int>(cudaErrorInvalidValue);
  const VjpPlan p = itemsize == 4 ? vjp_plan<float>(batch, n, m, d) : vjp_plan<double>(batch, n, m, d);
  out[0] = p.gx;
  out[1] = p.gy;
  out[2] = p.gv;
  return static_cast<int>(cudaSuccess);
}

// The reverse rule: x, y, var as for the batched forward (batch 1 and zero
// strides for one matrix); kb the cotangent (batch, n, m) with element
// strides sb, sr, sc (any of them 0); px, py, pv the workspace of
// stheno_kernelmatrix_vjp_plan.  Returns the CUDA error code of the launch.
extern "C" int stheno_kernelmatrix_vjp_f32(const float* x, const float* y, const float* var,
                                           const float* kb, float* px, float* py, float* pv,
                                           int batch, int n, int m, int d, int kind, int same,
                                           long long sx, long long sy, long long sv,
                                           long long sb, long long sr, long long sc,
                                           cudaStream_t stream) {
  return launch_vjp<float>({x, y, var, nullptr, batch, n, m, d, same, sx, sy, sv}, kind, kb,
                           px, py, pv, Strides{sx, sy, sv, sb, sr, sc}, stream);
}

extern "C" int stheno_kernelmatrix_vjp_f64(const double* x, const double* y, const double* var,
                                           const double* kb, double* px, double* py, double* pv,
                                           int batch, int n, int m, int d, int kind, int same,
                                           long long sx, long long sy, long long sv,
                                           long long sb, long long sr, long long sc,
                                           cudaStream_t stream) {
  return launch_vjp<double>({x, y, var, nullptr, batch, n, m, d, same, sx, sy, sv}, kind, kb,
                            px, py, pv, Strides{sx, sy, sv, sb, sr, sc}, stream);
}

extern "C" const char* stheno_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
