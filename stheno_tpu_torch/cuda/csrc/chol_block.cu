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
// Triangular inverse M = L^{-1} (tri_inv_kernel), bound the same way: n^3/3
// FMAs' worth of flops, 11 us at one SM's fp32 rate for n = 256.  Tiled like
// the Cholesky, in the same tile store and loader, with M written over L in
// place:
//   1. every diagonal tile is inverted at once, one warp each, in registers
//      (lane c holds column c of M_ii, rows of L_ii read by broadcast; no
//      CTA barrier): M_ii depends on L_ii alone;
//   2. right-looking over tile columns k: once tile row k of M is final,
//      every tile below it takes S_ij -= L_ik M_kj (i > k, j <= k; the
//      j = k term starts S_ik over L_ik's slot, which the step no longer
//      reads), one warp per tile in 8 x 4 register micro-tiles with L's tile
//      column k transposed into a panel buffer; then tile row k + 1 of M is
//      M_{k+1,j} = M_{k+1,k+1} S_{k+1,j}, in place, from a transposed copy
//      of M_{k+1,k+1}, while the other warps transpose column k + 1 of L.
// A 256-block takes 112 tile products of 32^3 FMAs and 16 CTA barriers; the
// step's products are independent tiles, so the 16 warps share them without
// reducing across warps, and a phase whose products number at most half
// the warps gives each warp half a tile (4 x 4 micro-tiles), which halves
// its chain.  The zeros above the diagonal are written while L loads.
// Right-looking rather than a tile-row (left-looking) sweep: its batches of
// independent tiles are wider, and the panel is again one operand all of a
// step's tiles share.  The tiles, the panel and the transposed diagonal
// inverse fit one CTA up to n = 288.
// Pivots are divided by in IEEE fp32, so a zero pivot gives inf or NaN.
//
// The Pallas sweeps extract rows and columns with mask reductions only
// because TPU lanes cannot be indexed dynamically; here each thread indexes
// its own elements directly.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kT = 32;              // tile edge of both kernels
constexpr int kTile = kT * kT;      // floats of a stored tile
constexpr int kQuads = kT / 4;      // quads of rows in a tile
constexpr int kCholThreads = 256;   // chol_block_kernel
constexpr int kTriThreads = 512;    // tri_inv_kernel

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// Shared floats of chol_block_kernel for an n x n block: the lower tiles;
// the transposed panel (every tile of one column below the diagonal); the
// diagonal tile's factor transposed; the factor's broadcast buffers (two of
// kT); the rsqrt of the diagonal tile's pivots.
__host__ __device__ __forceinline__ int chol_smem_floats(int n) {
  const int nt = (n + kT - 1) / kT;
  return tri(nt) * kTile + (nt - 1) * kT * kT + kT * kT + 2 * kT + kT;
}

// Shared floats of tri_inv_kernel: the lower tiles, the transposed panel
// (nt - 1 tiles) and the next diagonal tile's inverse transposed.
__host__ __device__ __forceinline__ int tri_inv_smem_floats(int n) {
  const int nt = (n + kT - 1) / kT;
  return (tri(nt) + nt) * kTile;
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

// Invert the diagonal tile d in place, one warp, lane c holding column c of
// M = D^{-1} in registers:
//   M[i, c] = (delta_ic - sum_{c <= k < i} D[i, k] M[k, c]) / D[i, i],  i >= c,
// with M[k, c] = 0 for k < c, so the sum runs over k < i.  Row i of D is read
// by float4 broadcasts, only its entries k < i and the pivot (the loader
// copies a quad that straddles the diagonal whole).  Four partial sums, one
// per entry of a quad, in a fixed order.  Writes M back, zeros above the
// diagonal; lanes write 32 entries of one row, each bank once.
__device__ __forceinline__ void invert_diag_tile(float* d, int lane) {
  float m[kT];
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; 4 * q < i; ++q) {
      float w[4];
      unpack(ld4(d + quad_at(i, q)), w);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < i) part[e] = fmaf(w[e], m[4 * q + e], part[e]);
    }
    const float s = (part[0] + part[1]) + (part[2] + part[3]);
    const float piv = d[quad_at(i, i / 4) + i % 4];
    m[i] = lane <= i ? ((lane == i ? 1.0f : 0.0f) - s) / piv : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kT; ++i) d[quad_at(i, lane / 4) + lane % 4] = m[i];
}

// at[p * kT + r] = A[r, p] for a stored tile A, by one warp: lane r reads row
// r (float4s, each bank once) and writes column r (consecutive words).
__device__ __forceinline__ void transpose_tile(float* at, const float* A, int lane) {
  float a[kT];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) unpack(ld4(A + quad_at(lane, q)), a + 4 * q);
#pragma unroll
  for (int p = 0; p < kT; ++p) at[p * kT + lane] = a[p];
}

// acc = rows h .. h + 4R - 1 of A B for one 32 x 32 tile product by one warp,
// A from a transposed tile (at[p * kT + r] = A[r, p]) and B from a stored
// tile: lane (y, x) = (lane / 8, lane % 8) owns rows h + Ry .. h + Ry + R - 1
// and quad x of columns, and reads R / 4 + 1 float4 per 4R FMAs (broadcasts
// of A's column, one quad of B's row).  R = 8 is the whole tile, R = 4 half.
template <int R>
__device__ __forceinline__ void tile_product(float (&acc)[R][4], const float* at, const float* B,
                                             int lane, int h) {
  const int x = lane % 8;
  at += h + R * (lane / 8);
#pragma unroll
  for (int y = 0; y < R; ++y)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[y][c] = 0.0f;
#pragma unroll
  for (int p = 0; p < kT; ++p) {
    float av[R], bv[4];
#pragma unroll
    for (int v = 0; v < R / 4; ++v) unpack(ld4(at + p * kT + 4 * v), av + 4 * v);
    unpack(ld4(B + quad_at(p, x)), bv);
#pragma unroll
    for (int y = 0; y < R; ++y)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[y][c] = fmaf(av[y], bv[c], acc[y][c]);
  }
}

// How a lane's micro-tile of a product goes into the stored tile C.
enum class Put { kSet, kSetNeg, kSub };

template <Put kMode, int R>
__device__ __forceinline__ void put_tile(float* C, const float (&acc)[R][4], int lane, int h) {
  const int r0 = h + R * (lane / 8), x = lane % 8;
#pragma unroll
  for (int y = 0; y < R; ++y) {
    float* cp = C + quad_at(r0 + y, x);
    float w[4];
    if (kMode == Put::kSub) unpack(ld4(cp), w);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = kMode == Put::kSet ? acc[y][c] : (kMode == Put::kSetNeg ? -acc[y][c] : w[c] - acc[y][c]);
    st4(cp, w);
  }
}

// C = A B (kSet, C may be B), C = -A B or C -= A B for one tile, by one warp
// (half < 0) or rows 16 half .. 16 half + 15 by one of two warps.  In place,
// the tile's one warp, or both of its warps by named barrier 1 + pair, read
// all of B before any writes.
template <Put kMode>
__device__ __forceinline__ void product_job(float* C, const float* at, const float* B, int lane,
                                            int half, int pair) {
  if (half < 0) {
    float acc[8][4];
    tile_product<8>(acc, at, B, lane, 0);
    if (kMode == Put::kSet) __syncwarp();
    put_tile<kMode, 8>(C, acc, lane, 0);
  } else {
    float acc[4][4];
    tile_product<4>(acc, at, B, lane, 16 * half);
    if (kMode == Put::kSet) asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
    put_tile<kMode, 4>(C, acc, lane, 16 * half);
  }
}

// M = L^{-1} of one block per CTA, tiled and right-looking (see the note at
// the head of the file).  Tile (i, j) of the store holds L_ij, then S_ij =
// -sum_{k < step} L_ik M_kj, then M_ij.  A phase whose products number at
// most half the warps splits each into two halves, so that its chain is
// shorter; it then runs in one round, so job t is warp t's.
__global__ void __launch_bounds__(kTriThreads)
tri_inv_kernel(const float* __restrict__ Lin, float* __restrict__ M, int n) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (n + kT - 1) / kT;
  float* tiles = smem;                      // tri(nt) tiles; tile (i, j) at tri(i) + j
  float* panel = tiles + tri(nt) * kTile;   // tile i - 1: L_ik transposed, for the step's k
  float* dt = panel + (nt - 1) * kTile;     // M_{k+1,k+1} transposed
  const float* Lb = Lin + static_cast<size_t>(blockIdx.x) * n * n;
  float* Mb = M + static_cast<size_t>(blockIdx.x) * n * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(Lin) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(M) % 16 == 0;
  auto tile = [&](int i, int j) { return tiles + (tri(i) + j) * kTile; };

  for (int g = warp; g < nt * kQuads; g += nwarps)
    for (int j = 0; j <= g / kQuads; ++j) load_quad(tiles, Lb, n, vec, g / kQuads, j, g % kQuads, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the tiles above the diagonal are zeros in M: written while L arrives
  for (int g = warp; g < nt * kQuads; g += nwarps)
    for (int j = g / kQuads + 1; j < nt; ++j) store_quad(tiles, Mb, n, vec, g / kQuads, j, g % kQuads, lane);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // every diagonal tile inverted at once, and tile column 0 of L transposed
  for (int t = warp; t < 2 * nt - 1; t += nwarps) {
    if (t < nt) invert_diag_tile(tile(t, t), lane);
    else transpose_tile(panel + (t - nt) * kTile, tile(t - nt + 1, 0), lane);
  }
  __syncthreads();

  for (int k = 0; k + 1 < nt; ++k) {
    // S_ij -= L_ik M_kj for i > k, j <= k, one tile (or half) a job; the
    // last job transposes M_{k+1,k+1}, which is final, for the next phase
    const int products = (nt - 1 - k) * (k + 1);
    int split = 2 * products + 1 <= nwarps ? 2 : 1;
    int jobs = split * products;
    for (int t = warp; t <= jobs; t += nwarps) {
      if (t == jobs) {
        transpose_tile(dt, tile(k + 1, k + 1), lane);
        continue;
      }
      const int u = t / split, half = split == 2 ? t % 2 : -1;
      const int i = k + 1 + u / (k + 1), j = u % (k + 1);
      if (j == k) product_job<Put::kSetNeg>(tile(i, j), panel + (i - 1) * kTile, tile(k, j), lane, half, 0);
      else product_job<Put::kSub>(tile(i, j), panel + (i - 1) * kTile, tile(k, j), lane, half, 0);
    }
    __syncthreads();
    // tile row k + 1 of M: M_{k+1,j} = M_{k+1,k+1} S_{k+1,j} in place, j <=
    // k; the other warps transpose tile column k + 1 of L for the next step
    split = 2 * (k + 1) + nt - 2 - k <= nwarps ? 2 : 1;
    jobs = split * (k + 1);
    for (int t = warp; t < jobs + nt - 2 - k; t += nwarps) {
      if (t < jobs) {
        const int j = t / split;
        product_job<Put::kSet>(tile(k + 1, j), dt, tile(k + 1, j), lane, split == 2 ? t % 2 : -1, j);
      } else {
        const int i = k + 2 + t - jobs;
        transpose_tile(panel + (i - 1) * kTile, tile(i, k + 1), lane);
      }
    }
    __syncthreads();
  }

  // the lower tiles (writing each tile row out as soon as it is final, in
  // the phases, measured slower on an H100)
  for (int g = warp; g < nt * kQuads; g += nwarps)
    for (int i = g / kQuads; i < nt; ++i) store_quad(tiles, Mb, n, vec, i, g / kQuads, g % kQuads, lane);
}

}  // namespace

// Dynamic shared memory in bytes of each kernel for an n x n block.
// cuda/chol_block.py mirrors both sizes to decide on the CPU which n fit;
// the gpu tests hold its copy against these.
extern "C" int stheno_chol_block_smem_bytes(int n) {
  return chol_smem_floats(n) * static_cast<int>(sizeof(float));
}

extern "C" int stheno_tri_inv_block_smem_bytes(int n) {
  return tri_inv_smem_floats(n) * static_cast<int>(sizeof(float));
}

namespace {

// A kernel's dynamic shared-memory limit as set so far on each device.  A
// launch raises it only when it needs more than that, so a run sets it once
// per block size it grows to, not on every launch, and a launch never asks
// for more than its own block needs.  Raises are serialised, so the limit
// set on a device is always the largest recorded for it; a failed launch
// forgets the record (after a context reset the limit is gone), so the next
// launch sets it again.
struct SmemLimit {
  static constexpr int kDevices = 64;
  std::atomic<int> bytes[kDevices] = {};
  std::mutex raising;
};

SmemLimit chol_smem_limit, tri_inv_smem_limit;

template <typename Kernel>
cudaError_t raise_smem_limit(SmemLimit& limit, Kernel kernel, int dev, int bytes) {
  if (dev < SmemLimit::kDevices && limit.bytes[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  std::lock_guard<std::mutex> lock(limit.raising);
  if (dev < SmemLimit::kDevices && limit.bytes[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < SmemLimit::kDevices)
    limit.bytes[dev].store(bytes, std::memory_order_release);
  return err;
}

void forget_smem_limit(SmemLimit& limit, int dev) {
  if (dev >= SmemLimit::kDevices) return;
  std::lock_guard<std::mutex> lock(limit.raising);
  limit.bytes[dev].store(0, std::memory_order_release);
}

// Launch kernel(in, out, n) with one CTA per block of the batch, on the
// current device.
template <typename Kernel>
int launch_blocks(SmemLimit& limit, Kernel kernel, int threads, int smem, const float* in,
                  float* out, int batch, int n, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = raise_smem_limit(limit, kernel, dev, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, threads, smem, stream>>>(in, out, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) forget_smem_limit(limit, dev);
  return static_cast<int>(err);
}

}  // namespace

// A, L, M: (batch, n, n) f32, row-major and contiguous, on the current
// device.  The caller checks that the block fits in shared memory (n <= 288).
// Each returns the CUDA error code of the launch (0 on success).
extern "C" int stheno_chol_block_f32(const float* A, float* L, int batch, int n,
                                     cudaStream_t stream) {
  return launch_blocks(chol_smem_limit, chol_block_kernel, kCholThreads,
                       stheno_chol_block_smem_bytes(n), A, L, batch, n, stream);
}

extern "C" int stheno_tri_inv_block_f32(const float* L, float* M, int batch, int n,
                                        cudaStream_t stream) {
  return launch_blocks(tri_inv_smem_limit, tri_inv_kernel, kTriThreads,
                       stheno_tri_inv_block_smem_bytes(n), L, M, batch, n, stream);
}

extern "C" const char* stheno_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
