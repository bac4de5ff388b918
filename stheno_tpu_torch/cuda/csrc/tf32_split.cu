// The TF32 split of an f32 tensor: hi = rna_tf32(x), lo = x - hi, one read
// and two writes, elementwise.  It feeds 3xTF32 products, the card's meaning
// of the 'high' GEMM precision (stheno_tpu_torch/ops/blocked_cholesky.py:_mm):
// (hi_a @ lo_b + lo_a @ hi_b) + hi_a @ hi_b on the tensor cores with TF32 on.
//
// Replaces no TPU kernel: the JAX package has no pl.pallas_call for it.  On
// the TPU, XLA makes bf16_3x's split itself inside each HIGH-precision dot
// (stheno_tpu/ops/blocked_cholesky.py:_mm).  Done in plain PyTorch the split
// is four or five passes over each operand (bit casts, a mask, a round, a
// subtraction); this kernel is one.
//
// Bound on an H100: bytes.  Each element is read once (4 bytes) and written
// twice (8 bytes), about a dozen instructions of arithmetic: 12 bytes an
// element over 3.35 TB/s.  The design does only what the bound asks for:
// 16-byte loads and stores (float4) where the row length, the row stride and
// the pointers allow it, scalar ones elsewhere, and a grid-stride loop so
// that a few thousand CTAs cover any size.
//
// hi comes from the PTX instruction cvt.rna.tf32.f32 (round to nearest, ties
// away from zero, to 10 explicit mantissa bits; the low 13 bits of the result
// are zero).  For every finite x whose rounding stays finite, lo = x - hi is
// exact in f32 (|lo| <= 2^-11 |x|, within 11 bits of x's last bit).  A value
// that is not finite (inf, NaN) is copied to hi as it is, with lo = 0.
// The plain version (stheno_tpu_torch/cuda/tf32_split.py:tf32_split_plain)
// rounds the same way with integer operations on the bits.
//
// The input is a matrix of `rows` rows of `cols` floats whose rows start
// `ld` floats apart (a contiguous tensor of any shape is one row); hi and lo
// are written contiguous, rows x cols.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ float rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split1(float x, float& h, float& l) {
  if (isfinite(x)) {
    h = rna_tf32(x);
    l = x - h;
  } else {
    h = x;
    l = 0.0f;
  }
}

// 16-byte path: cols4 = cols / 4, ld4 = ld / 4 (both exact)
__global__ void tf32_split_vec4_kernel(const float4* __restrict__ x, float4* __restrict__ hi,
                                       float4* __restrict__ lo, long long rows, long long cols4,
                                       long long ld4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float4* xr = x + r * ld4;
    float4* hr = hi + r * cols4;
    float4* lr = lo + r * cols4;
    for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < cols4;
         c += stride) {
      const float4 v = xr[c];
      float4 h, l;
      split1(v.x, h.x, l.x);
      split1(v.y, h.y, l.y);
      split1(v.z, h.z, l.z);
      split1(v.w, h.w, l.w);
      hr[c] = h;
      lr[c] = l;
    }
  }
}

__global__ void tf32_split_scalar_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                         float* __restrict__ lo, long long rows, long long cols,
                                         long long ld) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* xr = x + r * ld;
    float* hr = hi + r * cols;
    float* lr = lo + r * cols;
    for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; c < cols;
         c += stride) {
      float h, l;
      split1(xr[c], h, l);
      hr[c] = h;
      lr[c] = l;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int stheno_tf32_split_f32(const float* x, float* hi, float* lo, long long rows,
                                     long long cols, long long ld, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const bool vec = cols % 4 == 0 && ld % 4 == 0 && aligned16(x) && aligned16(hi) && aligned16(lo);
  const long long width = vec ? cols / 4 : cols;
  long long gx = (width + kThreads - 1) / kThreads;
  if (gx > kMaxBlocks) gx = kMaxBlocks;
  long long gy = kMaxBlocks / gx;
  if (gy < 1) gy = 1;
  if (gy > rows) gy = rows;
  if (gy > 65535) gy = 65535;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    tf32_split_vec4_kernel<<<grid, kThreads, 0, s>>>(reinterpret_cast<const float4*>(x),
                                                     reinterpret_cast<float4*>(hi),
                                                     reinterpret_cast<float4*>(lo), rows, cols / 4,
                                                     ld / 4);
  } else {
    tf32_split_scalar_kernel<<<grid, kThreads, 0, s>>>(x, hi, lo, rows, cols, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stheno_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
