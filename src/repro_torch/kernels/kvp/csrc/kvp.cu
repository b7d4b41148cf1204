// GP posterior mean for Hopper (sm_90a), float64: K5 kvp_fwd.
//
// Replaces the TPU kernel src/repro/kernels/kvp/kernel.py::kvp (pallas_call
// at :70, body _kvp_kernel at :27):
//
//   mean_i = Σ_j k(xq_i, xt_j) α_j,   k = σ_f² (1 + √5 r + 5 d²/3) exp(−√5 r),
//   a = xq·(1/ℓ), b = xt·(1/ℓ), d² = max(|a|² + |b|² − 2 a·b, 0),
//   r = √(d² + 1e-36)
//
// for q queries against n training points in D dimensions.  The cross gram
// never leaves the chip: only the (q,) means are written.
//
// What bounds it on an H100.  It reads xq, xt and α once (8·(q·D + n·D + n)
// bytes) and does ~2·q·n·D operations for a·b plus ~15·q·n for the Matérn
// terms, in f64.  At the BO path's shapes (q ≤ 10, n ≈ 544, D = 20) that is
// ~90 KB and ~0.3 MFLOP, far below launch latency; at q = 1000, n = 2048 it
// is ~0.1 GFLOP, ~2.5 µs of the card's f64 rate.
//
// Design.
//  * f64 throughout, like K1 and K3: the TPU kernel computes in f32, whose
//    cancellation in the expanded d² and in the posterior epilogue fails its
//    own tests (ROADMAP C1); the BO runs in f64.
//  * A block owns kRows query rows, their scaled coordinates and |a|² in
//    shared memory; each thread walks training points j = tid, tid + 256, ...
//    and updates all kRows partial sums with one read of xt_j and α_j.
//  * Row independence and reproducibility: a row's sum runs sequentially over
//    its thread's j, then through a fixed warp-shuffle tree and a fixed
//    cross-warp order, all set by n alone.  It does not depend on q or on the
//    row's place in the block, and there are no atomics.  The arithmetic is
//    written with explicit rounding intrinsics, so that no copy of the
//    unrolled row loop can be contracted into FMAs differently.
//  * Training sets padded with _FAR pseudo-points give d² ~ 1e15 there,
//    where exp underflows to 0 and the polynomial stays finite.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // query rows per block
constexpr double kSqrt5 = 2.2360679774997896;

__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                        // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, scratch[w]);
  return s;
}

// grid ceil(q / kRows); dynamic shared memory kvp_smem_bytes(d)
__global__ void __launch_bounds__(kThreads)
kvp_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
           const double* __restrict__ alpha, const double* __restrict__ inv_ls,
           const double* __restrict__ amplitude, double* __restrict__ out,
           int q, int n, int d) {
  extern __shared__ double smem[];
  double* a = smem;                       // [kRows][d]
  double* asq = a + kRows * d;            // [kRows]
  double* ils = asq + kRows;              // [d]
  double* scratch = ils + d;              // [kWarps]
  const int r0 = blockIdx.x * kRows;

  for (int k = threadIdx.x; k < d; k += kThreads) ils[k] = inv_ls[k];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * d; idx += kThreads) {
    const int r = idx / d, k = idx % d;
    a[idx] = r0 + r < q ? __dmul_rn(xq[(size_t)(r0 + r) * d + k], ils[k]) : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    double s = 0.0;
    for (int k = 0; k < d; ++k) s = fma(a[threadIdx.x * d + k], a[threadIdx.x * d + k], s);
    asq[threadIdx.x] = s;
  }
  __syncthreads();

  const double amp = *amplitude;
  double part[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) part[r] = 0.0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const double* xj = xt + (size_t)j * d;
    double bsq = 0.0, ab[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ab[r] = 0.0;
    for (int k = 0; k < d; ++k) {
      const double b = __dmul_rn(xj[k], ils[k]);
      bsq = fma(b, b, bsq);
#pragma unroll
      for (int r = 0; r < kRows; ++r) ab[r] = fma(a[r * d + k], b, ab[r]);
    }
    const double aj = alpha[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      double d2 = __dsub_rn(__dadd_rn(asq[r], bsq), __dmul_rn(2.0, ab[r]));
      d2 = d2 > 0.0 ? d2 : 0.0;
      const double rr = sqrt(__dadd_rn(d2, 1e-36));
      const double poly = __dadd_rn(__dadd_rn(1.0, __dmul_rn(kSqrt5, rr)),
                                    __dmul_rn(5.0 / 3.0, d2));
      const double kv = __dmul_rn(__dmul_rn(amp, poly), exp(-__dmul_rn(kSqrt5, rr)));
      part[r] = fma(kv, aj, part[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const double s = block_sum(part[r], scratch);
    if (threadIdx.x == 0 && r0 + r < q) out[r0 + r] = s;
  }
}

}  // namespace

extern "C" size_t kvp_smem_bytes(int d) {
  return sizeof(double) * ((size_t)kRows * d + kRows + d + kWarps);
}

// Returns the launch's cudaError_t.
extern "C" int kvp_fwd(const void* xq, const void* xt, const void* alpha,
                       const void* inv_ls, const void* amplitude, void* out,
                       int q, int n, int d, void* stream) {
  if (q < 1 || n < 0 || d < 1) return cudaErrorInvalidValue;
  const size_t smem = kvp_smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kvp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kvp_kernel<<<(q + kRows - 1) / kRows, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(xq), static_cast<const double*>(xt),
      static_cast<const double*>(alpha), static_cast<const double*>(inv_ls),
      static_cast<const double*>(amplitude), static_cast<double*>(out), q, n, d);
  return cudaGetLastError();
}
