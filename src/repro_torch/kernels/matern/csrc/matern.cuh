// The Matérn-5/2 entry and the staging helpers that posterior.cu (K1, K2)
// and gram.cu (K3, K4) share, so that one definition rounds every k(x, x')
// of the port: a = x ⊙ 1/ℓ and b = x' ⊙ 1/ℓ by __dmul_rn; |a|², |b|² and
// a·b as fma chains in k order (carried from piece to piece where D is
// staged in pieces); then matern().  K3's entry at (x_i, x_j) is the same
// sequence of roundings as K1's k*.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr double kSqrt5 = 2.2360679774997896;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 bytes global → shared, asynchronous; zeros where !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// 16 bytes global → shared, asynchronous, past L1; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// d² = max(|a|² + |b|² − 2 a·b, 0)
__device__ __forceinline__ double sq_dist(double asq, double bsq, double ab) {
  const double d2 = __dsub_rn(__dadd_rn(asq, bsq), __dmul_rn(2.0, ab));
  return d2 > 0.0 ? d2 : 0.0;
}

// Matérn-5/2 from |a|², |b|² and a·b
__device__ __forceinline__ double matern(double asq, double bsq, double ab, double amp) {
  const double d2 = sq_dist(asq, bsq, ab);
  const double rr = __dsqrt_rn(__dadd_rn(d2, 1e-36));
  const double poly = __fma_rn(5.0 / 3.0, d2, __fma_rn(kSqrt5, rr, 1.0));
  return __dmul_rn(__dmul_rn(amp, poly), exp(__dmul_rn(-kSqrt5, rr)));
}

// Row stride of coordinates in shared memory: odd, so that a warp reading
// one coordinate of consecutive rows spreads over the banks.
__host__ __device__ __forceinline__ int coord_stride(int d) { return d | 1; }

// columns [0, cols) of rows [0, rows) of src (row-major, leading dimension
// ld) into dst (row stride ds), asynchronously; rows [valid, rows) are zeros
// (element idx = r·cols + k of a thread advances by blockDim.x without a
// division)
__device__ __forceinline__ void stage_rows(double* dst, int ds, const double* src, int ld,
                                           int rows, int valid, int cols) {
  const int dr = blockDim.x / cols, dk = blockDim.x - dr * cols;
  for (int r = threadIdx.x / cols, k = threadIdx.x - r * cols; r < rows;) {
    const bool ok = r < valid;
    cp_async8(smem_u32(dst + r * ds + k), ok ? src + (size_t)r * ld + k : src, ok);
    r += dr;
    k += dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
}

// dst[r, k] = src[r, k] · ils[k] by __dmul_rn for columns [0, cols) of rows
// [0, rows) (row strides ds and ss; dst may be src)
__device__ __forceinline__ void scale_into(double* dst, int ds, const double* src, int ss,
                                           int rows, int cols, const double* ils) {
  const int dr = blockDim.x / cols, dk = blockDim.x - dr * cols;
  for (int r = threadIdx.x / cols, k = threadIdx.x - r * cols; r < rows;) {
    dst[r * ds + k] = __dmul_rn(src[r * ss + k], ils[k]);
    r += dr;
    k += dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
}

// columns [0, cols) of rows [0, rows) of x (row stride ds) times ils, in
// place, by __dmul_rn
__device__ __forceinline__ void scale_cols(double* x, int ds, int rows, int cols,
                                           const double* ils) {
  scale_into(x, ds, x, ds, rows, cols, ils);
}

}  // namespace
