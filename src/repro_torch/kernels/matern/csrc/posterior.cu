// Fused Matérn-5/2 GP posterior for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel src/repro/kernels/matern/kernel.py::matern52_posterior
// (pallas_call at :165, body _posterior_kernel at :100), and adds the
// backward in xq that the TPU path took from its jnp oracle.
//
// K1  matern52_posterior_fwd   (q, D) queries against (n, D) training points:
//       k*   = σ_f² (1 + √5 r + 5 d²/3) exp(−√5 r),  r = √(d² + 1e-36)
//       mean = k* α,   t = k* K⁻¹ (residual for K2),
//       var  = max(σ_f² − Σ_j t_ij k_ij, 1e-16)
// K2  matern52_posterior_bwd_xq   ∂(ḡm·mean + ḡv·var)/∂xq, (q, D):
//       c_ij = −(5/3) σ_f² (1 + √5 r) exp(−√5 r) (ḡm_i α_j − 2 ḡv_i [var_i > 1e-16] t_ij)
//       ∂/∂xq_i = inv_ls ⊙ ((Σ_j c_ij) a_i − Σ_j c_ij b_j),  a = xq·inv_ls, b = xt·inv_ls
//
// What bounds them on an H100.  K1 must read K⁻¹ (8·n² bytes) and do
// 2·q·n² f64 operations.  At the BO main path's shape (n ≈ 512, q ≤ 10) that
// is 2 MiB and ~5 MFLOP, under a microsecond of device time, so launch
// latency bounds a round.  When scoring a large pool (q = 1000, n = 2048) the
// f64 operations bound it: the product k* K⁻¹ is 8.4 GFLOP, ~125 µs at the
// card's 67 TFLOP/s f64 tensor-core rate (this kernel runs it on the CUDA
// cores, whose f64 peak is half that).  K2 is O(q·n·D) and is bound by
// reading t (8·q·n bytes) and launch latency.
//
// Design.
//  * f64 throughout.  The TPU kernel computes in f32 (no f64 there), and the
//    f32 cancellation in σ_f² − k*K⁻¹k*ᵀ grows with ‖K⁻¹‖; the BO runs in f64.
//  * K⁻¹ (32 MiB at n = 2048) cannot sit in shared memory (227 KB a block),
//    so it streams from device memory / L2.  A block owns a tile of TQ query
//    rows whose k* rows live in shared memory; each K⁻¹ element loaded serves
//    all TQ rows.  Threads own consecutive columns j and loop over l, so a
//    warp reads one row of K⁻¹ contiguously (coalesced).
//  * No padding copies: the ragged q edge is masked in the kernel; n needs
//    none.  Training sets padded with _FAR pseudo-points have d² ~ 1e15 there,
//    where exp underflows to 0 and the polynomial stays finite (no inf·0).
//  * Batch-width independence: every sum of a query row runs in an order
//    fixed by n and D only (sequential over l, then per-thread column
//    partials, then a fixed warp-shuffle tree and a fixed cross-warp order).
//    It does not depend on q, on the row's place in the tile or the grid, or
//    on repeated padding rows.  No atomics.  So a row's value and gradient
//    are bitwise the same in any batch, which lets D-BE reproduce SEQ
//    per restart bitwise on the card.
//  * At q ≤ 10 only q blocks are busy (≤ 10 of 132 SMs); spreading n over
//    blocks with a fixed-order second pass is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 4;          // K⁻¹ columns in flight per thread
constexpr double kSqrt5 = 2.2360679774997896;
constexpr double kVarFloor = 1e-16;

// Matérn-5/2 factors of one (query, train) pair; returns d².
__device__ __forceinline__ double sq_dist(const double* a, double asq,
                                          const double* xt_row,
                                          const double* inv_ls, int d) {
  double bsq = 0.0, ab = 0.0;
  for (int k = 0; k < d; ++k) {
    double b = xt_row[k] * inv_ls[k];
    bsq = fma(b, b, bsq);
    ab = fma(a[k], b, ab);
  }
  double d2 = (asq + bsq) - 2.0 * ab;
  return d2 > 0.0 ? d2 : 0.0;
}

// Fixed-order block sum of one value per thread; result valid in all threads.
__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                         // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

template <int TQ>
__global__ void __launch_bounds__(kThreads)
posterior_fwd_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
                     const double* __restrict__ alpha, const double* __restrict__ kinv,
                     const double* __restrict__ inv_ls, const double* __restrict__ amp_ptr,
                     double* __restrict__ mean, double* __restrict__ var,
                     double* __restrict__ t_out, int q, int n, int d) {
  extern __shared__ double smem[];
  double* ks = smem;                       // (TQ, n) k* rows
  double* a = ks + (size_t)TQ * n;         // (TQ, d) scaled queries
  double* asq = a + (size_t)TQ * d;        // (TQ,)
  double* scratch = asq + TQ;              // (kWarps,)

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TQ;
  const double amp = *amp_ptr;

  for (int idx = tid; idx < TQ * d; idx += kThreads) {
    int r = idx / d, k = idx - r * d;
    int row = min(row0 + r, q - 1);        // ragged tile: repeat a valid row
    a[idx] = xq[(size_t)row * d + k] * inv_ls[k];
  }
  __syncthreads();
  if (tid < TQ) {
    double s = 0.0;
    for (int k = 0; k < d; ++k) s = fma(a[tid * d + k], a[tid * d + k], s);
    asq[tid] = s;
  }
  __syncthreads();

  // k* rows into shared memory, with the mean's per-thread partials
  double pm[TQ];
#pragma unroll
  for (int r = 0; r < TQ; ++r) pm[r] = 0.0;
  for (int j = tid; j < n; j += kThreads) {
    const double* xr = xt + (size_t)j * d;
    const double al = alpha[j];
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      double d2 = sq_dist(a + r * d, asq[r], xr, inv_ls, d);
      double rr = sqrt(d2 + 1e-36);
      double k = amp * (1.0 + kSqrt5 * rr + (5.0 / 3.0) * d2) * exp(-kSqrt5 * rr);
      ks[(size_t)r * n + j] = k;
      pm[r] = fma(k, al, pm[r]);
    }
  }
  __syncthreads();

  // t = k* K⁻¹ over column groups; the variance's per-thread partials
  double pv[TQ];
#pragma unroll
  for (int r = 0; r < TQ; ++r) pv[r] = 0.0;
  for (int jb = 0; jb < n; jb += kThreads * kColsPerThread) {
    double acc[TQ][kColsPerThread];
#pragma unroll
    for (int r = 0; r < TQ; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0;
    int col[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) col[c] = jb + c * kThreads + tid;
#pragma unroll 4
    for (int l = 0; l < n; ++l) {   // unrolled: loads of 4 rows in flight
      const double* krow = kinv + (size_t)l * n;
      double kv[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) kv[c] = col[c] < n ? __ldg(krow + col[c]) : 0.0;
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        const double kl = ks[(size_t)r * n + l];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fma(kl, kv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      if (col[c] >= n) continue;
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        pv[r] = fma(acc[r][c], ks[(size_t)r * n + col[c]], pv[r]);
        if (row0 + r < q) t_out[(size_t)(row0 + r) * n + col[c]] = acc[r][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    double m = block_sum(pm[r], scratch);
    double quad = block_sum(pv[r], scratch);
    if (tid == 0 && row0 + r < q) {
      mean[row0 + r] = m;
      double v = amp - quad;
      var[row0 + r] = v > kVarFloor ? v : kVarFloor;
    }
  }
}

// One block per query row.
__global__ void __launch_bounds__(kThreads)
posterior_bwd_xq_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
                        const double* __restrict__ alpha, const double* __restrict__ t,
                        const double* __restrict__ var, const double* __restrict__ inv_ls,
                        const double* __restrict__ amp_ptr, const double* __restrict__ gm,
                        const double* __restrict__ gv, double* __restrict__ dxq,
                        int n, int d) {
  extern __shared__ double smem[];
  double* cs = smem;                       // (n,) c_ij of this row
  double* a = cs + n;                      // (d,)
  double* scratch = a + d;                 // (kWarps,) + 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x;
  const double amp = *amp_ptr;
  const double gmi = gm[i];
  const double gvi = var[i] > kVarFloor ? gv[i] : 0.0;

  for (int k = tid; k < d; k += kThreads) a[k] = xq[(size_t)i * d + k] * inv_ls[k];
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int k = 0; k < d; ++k) s = fma(a[k], a[k], s);
    scratch[kWarps] = s;
  }
  __syncthreads();
  const double asq = scratch[kWarps];

  double pc = 0.0;
  for (int j = tid; j < n; j += kThreads) {
    double d2 = sq_dist(a, asq, xt + (size_t)j * d, inv_ls, d);
    double rr = sqrt(d2 + 1e-36);
    double w = gmi * alpha[j] - 2.0 * gvi * t[(size_t)i * n + j];
    double c = -(5.0 / 3.0) * amp * (1.0 + kSqrt5 * rr) * exp(-kSqrt5 * rr) * w;
    cs[j] = c;
    pc += c;
  }
  const double csum = block_sum(pc, scratch);   // syncs, so cs is complete

  // Σ_j c_ij b_jd: warp w owns dims w, w + kWarps, ...; lanes stride over j
  for (int k = warp; k < d; k += kWarps) {
    const double il = inv_ls[k];
    double s = 0.0;
    for (int j = lane; j < n; j += 32) s = fma(cs[j], xt[(size_t)j * d + k] * il, s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dxq[(size_t)i * d + k] = il * (csum * a[k] - s);
  }
}

template <int TQ>
cudaError_t launch_fwd(const double* xq, const double* xt, const double* alpha,
                       const double* kinv, const double* inv_ls, const double* amp,
                       double* mean, double* var, double* t, int q, int n, int d,
                       cudaStream_t stream) {
  size_t smem = sizeof(double) * ((size_t)TQ * n + (size_t)TQ * d + TQ + kWarps);
  cudaError_t err = cudaFuncSetAttribute(posterior_fwd_kernel<TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int blocks = (q + TQ - 1) / TQ;
  posterior_fwd_kernel<TQ><<<blocks, kThreads, smem, stream>>>(
      xq, xt, alpha, kinv, inv_ls, amp, mean, var, t, q, n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `rows` (query rows per block) is one
// of 1, 2, 4, 8.
int matern52_posterior_fwd(const double* xq, const double* xt, const double* alpha,
                           const double* kinv, const double* inv_ls, const double* amp,
                           double* mean, double* var, double* t, int q, int n, int d,
                           int rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case 1: return launch_fwd<1>(xq, xt, alpha, kinv, inv_ls, amp, mean, var, t, q, n, d, s);
    case 2: return launch_fwd<2>(xq, xt, alpha, kinv, inv_ls, amp, mean, var, t, q, n, d, s);
    case 4: return launch_fwd<4>(xq, xt, alpha, kinv, inv_ls, amp, mean, var, t, q, n, d, s);
    case 8: return launch_fwd<8>(xq, xt, alpha, kinv, inv_ls, amp, mean, var, t, q, n, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int matern52_posterior_bwd_xq(const double* xq, const double* xt, const double* alpha,
                              const double* t, const double* var, const double* inv_ls,
                              const double* amp, const double* gm, const double* gv,
                              double* dxq, int q, int n, int d, void* stream) {
  size_t smem = sizeof(double) * ((size_t)n + d + kWarps + 1);
  cudaError_t err = cudaFuncSetAttribute(posterior_bwd_xq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  posterior_bwd_xq_kernel<<<q, kThreads, smem, (cudaStream_t)stream>>>(
      xq, xt, alpha, t, var, inv_ls, amp, gm, gv, dxq, n, d);
  return (int)cudaGetLastError();
}

}  // extern "C"
