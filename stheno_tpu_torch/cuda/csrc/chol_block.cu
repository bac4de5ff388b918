// Base-case dense kernels of the blocked Cholesky: the Cholesky factor of a
// batch of small PSD blocks, and the inverse of a batch of small lower-
// triangular blocks, in f32.  One CTA owns one block of the batch.
//
// Replace the Pallas kernels stheno_tpu/experimental/pallas/chol_block.py
// (chol_block / _chol_kernel, tri_inv_block / _tri_inv_kernel).
//
// Bound on an H100: neither kernel is bound by the card's bytes or flops.
// A 256 x 256 f32 block reads its 128.5 KiB lower triangle and writes 256 KiB
// (about 0.12 us at 3.35 TB/s card-wide) and does n^3/3 flops (5.6 MFLOP,
// well under a microsecond at the card's 67 TFLOP/s), but each block runs on
// one SM.  At one SM's fp32 rate (1/132 of the card's) the Cholesky's flops
// take 11 us; on top of that come its chain of dependent diagonal steps.
//
// Cholesky design: tiled and right-looking, with the block's lower tiles in
// shared memory for the whole factorisation (36 tiles, 144 KiB, at n = 256).
// The block is cut into T x T tiles (T = 32, rows of 32 floats whose 16-byte
// quads are permuted by row, see quad_at, so that float4 reads along a row
// or down a column of quads hit every bank once) and padded to whole tiles
// with the identity; the padding is never written out.  For each tile
// column k:
//   1. one warp factors the diagonal tile (k, k) in registers (lane r holds
//      row r; a warp barrier per column, no CTA barrier) and keeps the rsqrt
//      of each pivot and the factor transposed;
//   2. the panel tiles (i, k), i > k, are solved against it, one thread per
//      row by substitution (multiplying by the kept rsqrt), and each is also
//      stored transposed in a panel buffer;
//   3. the trailing tiles (i, j), k < j <= i, take C -= P_i P_j^T, one warp
//      per tile: each lane holds an 8 x 4 register micro-tile and reads its
//      operands from the transposed panel as three float4 per 32 FMAs.
// With a lookahead, step 3 overlaps step 1 of the next column: warp 0
// updates the next diagonal tile first and factors it while the other warps
// update the rest and write the finished tile column out.  So a 256-block
// takes 18 CTA barriers (the column sweep took 512).  Right-looking rather
// than left-looking: the step's panel is the one operand all its trailing
// tiles share, so it is transposed once per step; a left-looking order would
// keep every earlier panel transposed, which does not fit beside the tiles.
// The tiles and the panel buffer fit one CTA up to n = 288.
// Arithmetic is fp32 FMAs on the CUDA cores: tensor cores would take f32 only
// as TF32, which the factorisation must not use.  Every sum runs in a fixed
// order with no atomics, so repeats are bit-identical.
//
// The triangular inverse keeps M's packed triangle in shared memory and
// gives each thread one column; it needs no barrier at all.
//
// The Pallas sweeps extract rows and columns with mask reductions only
// because TPU lanes cannot be indexed dynamically; here each thread indexes
// its own elements directly.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kT = 32;              // chol_block_kernel: tile edge
constexpr int kTile = kT * kT;      // floats of a stored tile
constexpr int kQuads = kT / 4;      // quads of rows in a tile
constexpr int kCholThreads = 256;   // chol_block_kernel
constexpr int kTriThreads = 256;    // tri_inv_kernel: one thread per column, round robin
constexpr int kTriRows = 4;         // rows of M per pass of tri_inv_kernel

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Shared floats of chol_block_kernel for an n x n block: the lower tiles;
// the transposed panel (every tile of one column below the diagonal); the
// diagonal tile's factor transposed; the factor's broadcast buffers (two of
// kT); the rsqrt of the diagonal tile's pivots.
__host__ __device__ __forceinline__ int chol_smem_floats(int n) {
  const int nt = (n + kT - 1) / kT;
  return tri(nt) * kTile + (nt - 1) * kT * kT + kT * kT + 2 * kT + kT;
}

// Offset of quad q (entries 4q .. 4q+3) of row r in a stored tile.  A tile is
// stored by rows of kT floats with each row's eight quads permuted by r % 8,
// so that eight lanes that read one quad each of eight consecutive rows, or
// eight quads of one row, hit each bank once.
__device__ __forceinline__ int quad_at(int r, int q) { return r * kT + 4 * (q ^ (r & 7)); }

// Row and column (in tiles) of the t-th stored tile: tiles are stored row by
// row, tile (i, j) at tri(i) + j.
__device__ __forceinline__ void tile_of(int t, int& i, int& j) {
  i = 0;
  while (tri(i + 1) <= t) ++i;
  j = t - tri(i);
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void unpack(const float4 v, float* w) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, const float* w) {
  *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
}

// rsqrt of a pivot, NaN for a non-positive one (as rsqrt gives in the
// reference; it never raises).  One MUFU op: the pivots of a PSD block are
// far from the denormal range, where the flush to zero would matter.
__device__ __forceinline__ float pivot_rsqrt(float piv) {
  float s;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(piv));
  return piv > 0.0f ? s : __int_as_float(0x7fc00000);
}

// Quad q of rows of tile (ti, tj) from A: lane l takes row 4q + l / 8 of the
// tile and its columns 4(l % 8) .. + 3, so a warp reads 128 contiguous bytes
// of four rows and its float4 stores hit every bank once.  Reads tril(A)
// only: a float4 that straddles the diagonal is read whole and its upper
// part never used.  Pads with the identity.
__device__ __forceinline__ void load_quad(float* tiles, const float* Ab, int n, bool vec, int ti,
                                          int tj, int q, int lane) {
  const int rr = 4 * q + lane / 8, cq = 4 * (lane % 8);
  const int r = ti * kT + rr, c = tj * kT + cq;
  float* dst = tiles + (tri(ti) + tj) * kTile + quad_at(rr, cq / 4);
  const float* src = Ab + static_cast<size_t>(r) * n + c;
  if (vec && r < n && c < n) {
    if (c <= r) copy_async16(dst, src);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (r < n && c + e < n && c + e <= r) copy_async4(dst + e, src + e);
    else dst[e] = r == c + e && r >= n ? 1.0f : 0.0f;
  }
}

// Quad q of rows of tile (ti, tj) of L to device memory, as load_quad maps
// lanes: zeros above the diagonal, nothing past n.
__device__ __forceinline__ void store_quad(const float* tiles, float* Lb, int n, bool vec, int ti,
                                           int tj, int q, int lane) {
  const int rr = 4 * q + lane / 8, cq = 4 * (lane % 8);
  const int r = ti * kT + rr, c = tj * kT + cq;
  if (r >= n || c >= n) return;
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (tj <= ti) {
    unpack(ld4(tiles + (tri(ti) + tj) * kTile + quad_at(rr, cq / 4)), w);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = c + e <= r ? w[e] : 0.0f;
  }
  float* dst = Lb + static_cast<size_t>(r) * n + c;
  if (vec) {
    st4(dst, w);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n) dst[e] = w[e];
  }
}

// Factor the diagonal tile d in place, one warp, lane r holding row r:
//   L[j:, j] = S[j:, j] * s_j with s_j = rsqrt(S[j, j]);  S[r, c] -= L[r, j] L[c, j].
// Step j's column goes out through a shared buffer (one store, a warp
// barrier, eight float4 broadcasts) rather than 31 - j shuffles, and every
// lane carries the running diagonal dg with the same FMAs lane c applies to
// S[c, c], so the next pivot needs no shuffle.  Writes the factor back
// (zeros above the diagonal), transposed into lt (lt[j * kT + c] = L[c, j]),
// and s_j = 1 / L[j, j] into rdiag.
__device__ __forceinline__ void factor_diag_tile(float* d, float* lt, float* col, float* rdiag,
                                                 int lane) {
  float a[kT], dg[kT];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    unpack(ld4(d + quad_at(lane, q)), a + 4 * q);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[4 * q + e] = 4 * q + e <= lane ? a[4 * q + e] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) dg[c] = d[quad_at(c, c / 4) + c % 4];
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    const float piv = dg[j];
    const float s = pivot_rsqrt(piv);
    const float lj = lane > j ? a[j] * s : (lane == j ? piv * s : 0.0f);
    a[j] = lj;
    float* cb = col + (j % 2) * kT;  // two buffers: a lane still reading step j - 1's
    cb[lane] = lj;                   // is behind this step's barrier
    __syncwarp();
#pragma unroll
    for (int q = (j + 1) / 4; q < kQuads; ++q) {
      float w[4];
      unpack(ld4(cb + 4 * q), w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e;
        if (c > j) {  // lanes r < c update S[r, c] above the diagonal, never read
          a[c] = fmaf(-lj, w[e], a[c]);
          dg[c] = fmaf(-w[e], w[e], dg[c]);
        }
      }
    }
    if (lane == 0) rdiag[j] = s;
  }
#pragma unroll
  for (int c = 0; c < kT; ++c) a[c] = c <= lane ? a[c] : 0.0f;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) st4(d + quad_at(lane, q), a + 4 * q);
#pragma unroll
  for (int c = 0; c < kT; ++c) lt[c * kT + lane] = a[c];
}

// C -= Pa Pb^T for one tile C from two transposed panel tiles, by one warp:
// lane (y, x) = (lane / 8, lane % 8) owns rows 8y .. 8y+7 and columns
// 4x .. 4x+3 in registers and reads three float4 per 32 FMAs.
__device__ __forceinline__ void update_tile(float* C, const float* pa, const float* pb, int lane) {
  const int r0 = 8 * (lane / 8), c0 = 4 * (lane % 8);
  pa += r0;
  pb += c0;
  float acc[8][4] = {};
#pragma unroll 4
  for (int p = 0; p < kT; ++p) {
    float av[8], bv[4];
    unpack(ld4(pa + p * kT), av);
    unpack(ld4(pa + p * kT + 4), av + 4);
    unpack(ld4(pb + p * kT), bv);
#pragma unroll
    for (int y = 0; y < 8; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[y][x] = fmaf(av[y], bv[x], acc[y][x]);
  }
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    float* cp = C + quad_at(r0 + y, c0 / 4);
    float w[4];
    unpack(ld4(cp), w);
#pragma unroll
    for (int x = 0; x < 4; ++x) w[x] -= acc[y][x];
    st4(cp, w);
  }
}

__global__ void __launch_bounds__(kCholThreads)
chol_block_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (n + kT - 1) / kT;
  float* tiles = smem;                        // tri(nt) tiles; tile (i, j) at tri(i) + j
  float* panel = tiles + tri(nt) * kTile;     // tile t: P[p * kT + r] = L[k+1+t, k][r, p]
  float* lt = panel + (nt - 1) * kT * kT;     // the diagonal tile's factor, transposed
  float* col = lt + kT * kT;                  // the diagonal factor's broadcasts
  float* rdiag = col + 2 * kT;                // s_j of the diagonal tile
  const float* Ab = A + static_cast<size_t>(blockIdx.x) * n * n;
  float* Lb = L + static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // rows are 16-byte aligned in device memory
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(L) % 16 == 0;
  auto tile = [&](int i, int j) { return tiles + (tri(i) + j) * kTile; };

  // tril(A) by asynchronous copies, tile column 0 first: the first diagonal
  // factor and panel run while the rest is in flight.  Warp w takes quad w
  // of every tile row, so the warps share the rows' lengths evenly.
  for (int g = warp; g < nt * kQuads; g += nwarps)
    load_quad(tiles, Ab, n, vec, g / kQuads, 0, g % kQuads, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int g = warp; g < nt * kQuads; g += nwarps)
    for (int j = 1; j <= g / kQuads; ++j) load_quad(tiles, Ab, n, vec, g / kQuads, j, g % kQuads, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  // the tiles above the diagonal are zeros in L: the other warps write them
  // while warp 0 factors the first diagonal tile
  if (warp == 0) {
    factor_diag_tile(tile(0, 0), lt, col, rdiag, lane);
  } else {
    for (int g = warp - 1; g < nt * kQuads; g += nwarps - 1)
      for (int j = g / kQuads + 1; j < nt; ++j) store_quad(tiles, Lb, n, vec, g / kQuads, j, g % kQuads, lane);
  }
  __syncthreads();

  // Right-looking over tile columns, with a lookahead: while warps 1.. apply
  // column k's trailing update, warp 0 updates the next diagonal tile first
  // and factors it, so the chain of diagonal factors runs beside the bulk of
  // the flops.  Two CTA barriers per column.
  for (int k = 0; k < nt; ++k) {
    const int m = nt - 1 - k;
    // panel: row r of tile (k+1+t, k) solves x L_kk^T = a by substitution,
    // x_j = a_j s_j, then a_c -= x_j L[c, j] for c > j (column j of L_kk
    // read from lt by float4 broadcasts); stored back and transposed
    for (int q = tid; q < m * kT; q += blockDim.x) {
      const int t = q / kT, r = q % kT;
      float* x = tile(k + 1 + t, k);
      float a[kT];
#pragma unroll
      for (int v = 0; v < kQuads; ++v) unpack(ld4(x + quad_at(r, v)), a + 4 * v);
#pragma unroll
      for (int j = 0; j < kT; ++j) {
        a[j] *= rdiag[j];
#pragma unroll
        for (int v = (j + 1) / 4; v < kQuads; ++v) {
          float w[4];
          unpack(ld4(lt + j * kT + 4 * v), w);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * v + e > j) a[4 * v + e] = fmaf(-a[j], w[e], a[4 * v + e]);
        }
      }
#pragma unroll
      for (int v = 0; v < kQuads; ++v) st4(x + quad_at(r, v), a + 4 * v);
      float* pt = panel + t * kT * kT + r;
#pragma unroll
      for (int c = 0; c < kT; ++c) pt[c * kT] = a[c];
    }
    if (k == 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // trailing tiles (k+1+ti, k+1+tj), tj <= ti: C -= P_ti P_tj^T.  Tile 0
    // is the next diagonal tile, warp 0's; the other warps first write tile
    // column k, which is final, beside it.
    if (warp == 0) {
      if (m > 0) {
        update_tile(tile(k + 1, k + 1), panel, panel, lane);
        __syncwarp();
        factor_diag_tile(tile(k + 1, k + 1), lt, col, rdiag, lane);
      }
    } else {
      for (int u = warp - 1; u < (m + 1) * kQuads; u += nwarps - 1)
        store_quad(tiles, Lb, n, vec, k + u / kQuads, k, u % kQuads, lane);
      for (int t = warp; t < tri(m); t += nwarps - 1) {
        int ti, tj;
        tile_of(t, ti, tj);
        update_tile(tile(k + 1 + ti, k + 1 + tj), panel + ti * kT * kT, panel + tj * kT * kT, lane);
      }
    }
    __syncthreads();
  }
}

// Column sweep for M = L^{-1}.  Column c of M solves L m = e_c on its own:
//   M[i, c] = (delta_ic - sum_{c <= k < i} L[i, k] M[k, c]) / L[i, i],  i >= c,
// so one thread owns each column and no barrier separates the rows.  Warp w
// owns columns [32w, 32w + 32), and further groups of 32 round robin.  M's
// lower triangle is packed by rows in S; a thread touches only its own
// column, so a warp reads 32 consecutive words of one row (no bank
// conflicts) and never waits on another warp.
//
// The first warp's columns are the longest chain, and one warp alone hides
// little latency, so each pass takes kTriRows rows: one read of M[k, c]
// feeds all of them, the sums over k < i run together, and the few terms
// with i <= k < i + kTriRows are added once those rows are known.  The
// rows' chunks of L are staged 32 entries at a time in the warp's own
// buffer (one coalesced load per row, the next chunk already in flight)
// and read back by broadcast.
__global__ void __launch_bounds__(kTriThreads)
tri_inv_kernel(const float* __restrict__ Lin, float* __restrict__ M, int n) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kTriRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* buf = smem + warp * 32 * R;  // this warp's chunks of L
  float* S = smem + nwarps * 32 * R;  // packed lower triangle of M, tri(n) entries
  const float* Lb = Lin + static_cast<size_t>(blockIdx.x) * n * n;
  float* Mb = M + static_cast<size_t>(blockIdx.x) * n * n;

  for (int c0 = warp * 32; c0 < n; c0 += nwarps * 32) {
    const int c = c0 + lane;  // may pass n on a ragged edge: then it writes nothing
    for (int i = c0; i < n; i += R) {
      const float* lr[R];  // rows i .. i + R - 1 of L (the last row repeats past n)
      float acc[R], next[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lr[r] = Lb + static_cast<size_t>(i + r < n ? i + r : n - 1) * n;
        acc[r] = 0.0f;
        next[r] = c0 + lane < i ? lr[r][c0 + lane] : 0.0f;
      }
      for (int kb = c0; kb < i; kb += 32) {
        __syncwarp();
#pragma unroll
        for (int r = 0; r < R; ++r) buf[r * 32 + lane] = next[r];
        __syncwarp();
        const int kn = kb + 32 + lane;
#pragma unroll
        for (int r = 0; r < R; ++r) next[r] = kn < i ? lr[r][kn] : 0.0f;
        // every k of the chunk lies in [c, i) unless it holds the diagonal
        // or the end of the rows
        const bool full = kb > c0 && kb + 32 <= i;
        int off = tri(kb) + c;  // entry (kb, c); row k + 1 starts k + 1 later
#pragma unroll
        for (int t0 = 0; t0 < 32; t0 += 8) {
          float m[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int k = kb + t0 + u;
            m[u] = (full || (k >= c && k < i)) ? S[off] : 0.0f;
            off += k + 1;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += buf[r * 32 + t0 + u] * m[u];
        }
      }
      float mr[R];  // M[i + r, c], zero above the diagonal
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = i + r;
        mr[r] = 0.0f;
        if (row < n && row >= c) {
          float s = acc[r];
#pragma unroll
          for (int q = 0; q < r; ++q) s += lr[r][i + q] * mr[q];
          mr[r] = ((row == c ? 1.0f : 0.0f) - s) / lr[r][row];
          S[tri(row) + c] = mr[r];
        }
      }
    }
  }
  __syncthreads();

  for (int i = warp; i < n; i += nwarps) {
    float* mrow = Mb + static_cast<size_t>(i) * n;
    for (int j = lane; j < n; j += 32) mrow[j] = j <= i ? S[tri(i) + j] : 0.0f;
  }
}

}  // namespace

// Dynamic shared memory in bytes of each kernel for an n x n block.
// cuda/chol_block.py mirrors both sizes to decide on the CPU which n fit;
// the gpu tests hold its copy against these.
extern "C" int stheno_chol_block_smem_bytes(int n) {
  return chol_smem_floats(n) * static_cast<int>(sizeof(float));
}

extern "C" int stheno_tri_inv_block_smem_bytes(int n) {
  const int warps = (n + 31) / 32 < kTriThreads / 32 ? (n + 31) / 32 : kTriThreads / 32;
  return (warps * 32 * kTriRows + tri(n)) * static_cast<int>(sizeof(float));
}

// A, L, M: (batch, n, n) f32, row-major and contiguous.  The caller checks
// that the kernel's shared memory fits.  Each returns the CUDA error code of
// the launch (0 on success).
extern "C" int stheno_chol_block_f32(const float* A, float* L, int batch, int n,
                                     cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int smem = stheno_chol_block_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(chol_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_block_kernel<<<batch, kCholThreads, smem, stream>>>(A, L, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stheno_tri_inv_block_f32(const float* L, float* M, int batch, int n,
                                        cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const int warps = (n + 31) / 32 < kTriThreads / 32 ? (n + 31) / 32 : kTriThreads / 32;
  const int smem = stheno_tri_inv_block_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(tri_inv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tri_inv_kernel<<<batch, warps * 32, smem, stream>>>(L, M, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stheno_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
