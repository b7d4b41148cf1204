// Matérn-5/2 gram matrix and its gradient in θ for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel src/repro/kernels/matern/kernel.py::matern52_gram
// (pallas_call at :73, body _matern_kernel at :28), with a leading batch of
// θ rows, and adds the gradient in θ that the GP's MAP fit needs (JAX's fit
// differentiates its jnp gram with autograd; the TPU kernel has none).
//
// K3  matern52_gram_fwd   x1 (n1, D), x2 (n2, D), 1/ℓ (R, D), σ_f² (R,):
//       out[r, i, j] = σ_f²[r] (1 + √5 ρ + 5 d²/3) exp(−√5 ρ),  ρ = √(d² + 1e-36)
//       d² = max(|a_i|² + |b_j|² − 2 a_i·b_j, 0),  a = x1 ⊙ 1/ℓ[r],  b = x2 ⊙ 1/ℓ[r]
// K4  matern52_gram_bwd_theta   given Ḡ (R, n1, n2):
//       ∂/∂(1/ℓ[r, d]) = −(5/3) σ_f²[r] (1/ℓ[r, d]) Σ_ij Ḡ_rij (1 + √5 ρ) e^{−√5 ρ} (x1_id − x2_jd)²
//       ∂/∂σ_f²[r]     = Σ_ij Ḡ_rij k_rij / σ_f²[r]
//
// What bounds them on an H100.  K3 writes 8·R·n1·n2 bytes and does 2D
// product operations and ~14 others an entry: at the MAP fit's shape (R = 2,
// n = 544, D = 20) 4.9 MB, 1.47 µs at 3.35 TB/s, against ~0.6 µs of f64
// operations, so bytes bound it (also at n = 2048, D = 40).  K4 reads Ḡ (the
// same bytes); its least work writes Σ_ij c_ij (x1_id − x2_jd)² as
// Σ_i x1_id² rowsum_i(C) + Σ_j x2_jd² colsum_j(C) − 2 Σ_i x1_id (C·x2)_id, one
// more product (2D operations an entry) and ~17 others, ~1.0 µs at the fit's
// shape, so bytes bound it too (1.47 µs).  It takes the differences directly
// instead (~5D + 17 an entry; see the last point below).  Either bound is far
// below a launch's latency at the fit's shape, where the grid is 17×17×2
// tiles.
//
// Design.
//  * f64 throughout: JAX's fit builds its gram in f64 (x64); an f32 gram breaks
//    the fit's Cholesky.
//  * One block computes a 32×32 output tile of one θ row r (grid x over n2
//    tiles, y over n1 tiles, z over r).  The tile's rows of x1 and x2, scaled by
//    1/ℓ[r], and their squared norms sit in shared memory with D whole; the
//    shared row stride is odd so a warp's column reads hit distinct banks.
//    Lanes own consecutive columns j, so the output row is written coalesced.
//    The ragged edges are masked, never padded.
//  * d² is the expanded, clamped form of JAX's gram and of K1's sq_dist
//    (posterior.cu), with the same sequential fma order over D, so K3 at
//    x1 = x2 gives d² = 0 exactly on the diagonal.
//  * _FAR pseudo-rows (x ≈ 1e6 + i): d² ~ 1e16 there, and cancellation can put
//    any value ≥ 0 between two of them after the clamp.  Every value stays
//    finite: exp underflows to 0 against a finite polynomial, never inf·0.
//    The masked LML multiplies those entries by 0 and their Ḡ is 0.
//  * K4 sums over (i, j) with a fixed order and no atomics: each block reduces
//    its tile (fixed warp-shuffle tree, then warps in order) into one partial
//    per (r, tile, d); a second kernel, one block per (d, r), adds a sum's
//    partials in an order fixed by the number of tiles.  The fit's gradient
//    is then bitwise the same run to run.
//  * The difference (x1_id − x2_jd) is taken from the unscaled coordinates, so
//    ∂/∂(1/ℓ) has no cancellation of its own.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                  // output tile is kTile × kTile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kTile / kWarps;   // warp w owns rows w, w + 8, ...
constexpr double kSqrt5 = 2.2360679774997896;

__host__ __device__ __forceinline__ int row_stride(int d) { return d | 1; }

// Scaled rows of one tile into shared memory, with their squared norms.
__device__ __forceinline__ void load_scaled(const double* __restrict__ x, int n, int d,
                                            int row0, const double* il, double* dst,
                                            double* sq, const int ld) {
  for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {
    int r = idx / d, k = idx - r * d;
    int row = row0 + r;
    dst[r * ld + k] = row < n ? x[(size_t)row * d + k] * il[k] : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    double s = 0.0;
    for (int k = 0; k < d; ++k) s = fma(dst[threadIdx.x * ld + k], dst[threadIdx.x * ld + k], s);
    sq[threadIdx.x] = s;
  }
}

__device__ __forceinline__ double tile_sq_dist(const double* a, double asq, const double* b,
                                               double bsq, int d) {
  double ab = 0.0;
  for (int k = 0; k < d; ++k) ab = fma(a[k], b[k], ab);
  double d2 = (asq + bsq) - 2.0 * ab;
  return d2 > 0.0 ? d2 : 0.0;
}

// Shared layout of both kernels: a, b (kTile × ld each), asq, bsq (kTile
// each), il (d).
struct Tile {
  double *a, *b, *asq, *bsq, *il;
  __device__ Tile(double* smem, int d) {
    const int ld = row_stride(d);
    a = smem;
    b = a + kTile * ld;
    asq = b + kTile * ld;
    bsq = asq + kTile;
    il = bsq + kTile;
  }
};

__device__ __forceinline__ void load_tile(const Tile& t, const double* __restrict__ x1,
                                          const double* __restrict__ x2,
                                          const double* __restrict__ inv_ls, int n1, int n2,
                                          int d, int r, int row0, int col0) {
  for (int k = threadIdx.x; k < d; k += kThreads) t.il[k] = inv_ls[(size_t)r * d + k];
  __syncthreads();
  const int ld = row_stride(d);
  load_scaled(x1, n1, d, row0, t.il, t.a, t.asq, ld);
  load_scaled(x2, n2, d, col0, t.il, t.b, t.bsq, ld);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
gram_fwd_kernel(const double* __restrict__ x1, const double* __restrict__ x2,
                const double* __restrict__ inv_ls, const double* __restrict__ amp,
                double* __restrict__ out, int n1, int n2, int d) {
  extern __shared__ double smem[];
  const Tile t(smem, d);
  const int r = blockIdx.z, row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  load_tile(t, x1, x2, inv_ls, n1, n2, d, r, row0, col0);

  const int ld = row_stride(d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = col0 + lane;
  if (col >= n2) return;
  const double s = amp[r];
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    const int i = warp + p * kWarps, row = row0 + i;
    if (row >= n1) break;
    double d2 = tile_sq_dist(t.a + i * ld, t.asq[i], t.b + lane * ld, t.bsq[lane], d);
    double rr = sqrt(d2 + 1e-36);
    out[((size_t)r * n1 + row) * n2 + col] =
        s * (1.0 + kSqrt5 * rr + (5.0 / 3.0) * d2) * exp(-kSqrt5 * rr);
  }
}

// Pass 1 of K4: one partial per (r, block, d) and (r, block, D) for σ_f².
__global__ void __launch_bounds__(kThreads)
gram_bwd_partial_kernel(const double* __restrict__ x1, const double* __restrict__ x2,
                        const double* __restrict__ inv_ls, const double* __restrict__ g,
                        double* __restrict__ partial, int n1, int n2, int d) {
  extern __shared__ double smem[];
  const Tile t(smem, d);
  const int ld = row_stride(d);
  double* wsum = t.il + d;                 // (kWarps, d + 1) per-warp sums
  const int r = blockIdx.z, row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  load_tile(t, x1, x2, inv_ls, n1, n2, d, r, row0, col0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = col0 + lane;
  double c[kRowsPerThread];                // Ḡ (1 + √5ρ) e^{−√5ρ} of each owned entry
  double ksum = 0.0;                       // Σ Ḡ k / σ_f² over owned entries
#pragma unroll
  for (int p = 0; p < kRowsPerThread; ++p) {
    const int i = warp + p * kWarps, row = row0 + i;
    c[p] = 0.0;
    if (row < n1 && col < n2) {
      const double gv = g[((size_t)r * n1 + row) * n2 + col];
      double d2 = tile_sq_dist(t.a + i * ld, t.asq[i], t.b + lane * ld, t.bsq[lane], d);
      double rr = sqrt(d2 + 1e-36);
      double e = exp(-kSqrt5 * rr);
      c[p] = gv * (1.0 + kSqrt5 * rr) * e;
      ksum = fma(gv, (1.0 + kSqrt5 * rr + (5.0 / 3.0) * d2) * e, ksum);
    }
  }
  const int rowc = min(col, n2 - 1);
  for (int k = 0; k <= d; ++k) {
    double s = 0.0;
    if (k < d) {
      const double xb = x2[(size_t)rowc * d + k];
#pragma unroll
      for (int p = 0; p < kRowsPerThread; ++p) {
        const int row = min(row0 + warp + p * kWarps, n1 - 1);
        const double diff = x1[(size_t)row * d + k] - xb;
        s = fma(c[p], diff * diff, s);
      }
    } else {
      s = ksum;
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) wsum[warp * (d + 1) + k] = s;
  }
  __syncthreads();
  const size_t blk = ((size_t)r * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int k = threadIdx.x; k <= d; k += kThreads) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += wsum[w * (d + 1) + k];
    partial[blk * (d + 1) + k] = s;
  }
}

// Pass 2 of K4: one block per (d, r) adds that sum's per-tile partials in a
// fixed order: thread t takes tiles t, t + kThreads, ... in turn, then a
// fixed shuffle tree and the warps in order.  The order depends on the
// number of tiles only.
__global__ void __launch_bounds__(kThreads)
gram_bwd_reduce_kernel(const double* __restrict__ partial, const double* __restrict__ inv_ls,
                       const double* __restrict__ amp, double* __restrict__ d_inv_ls,
                       double* __restrict__ d_amp, int n_blocks, int d) {
  __shared__ double wsum[kWarps];
  const int k = blockIdx.x, r = blockIdx.y;
  const double* p = partial + (size_t)r * n_blocks * (d + 1) + k;
  double s = 0.0;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) s += p[(size_t)b * (d + 1)];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t += wsum[w];
    if (k < d)
      d_inv_ls[(size_t)r * d + k] = -(5.0 / 3.0) * amp[r] * inv_ls[(size_t)r * d + k] * t;
    else
      d_amp[r] = t;
  }
}

size_t tile_smem_bytes(int d) {
  return sizeof(double) * (2 * (size_t)kTile * row_stride(d) + 2 * kTile + d);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory K3 / K4's first pass need at dimension d.
size_t matern52_gram_smem_bytes(int d, int backward) {
  return tile_smem_bytes(d) + (backward ? sizeof(double) * kWarps * (d + 1) : 0);
}

// K4's scratch: doubles of per-block partials for (r, n1, n2, d).
size_t matern52_gram_bwd_scratch(int r, int n1, int n2, int d) {
  size_t blocks = (size_t)((n2 + kTile - 1) / kTile) * ((n1 + kTile - 1) / kTile);
  return (size_t)r * blocks * (d + 1);
}

// Each returns a cudaError_t (0 on success).
int matern52_gram_fwd(const double* x1, const double* x2, const double* inv_ls,
                      const double* amp, double* out, int r, int n1, int n2, int d,
                      void* stream) {
  size_t smem = matern52_gram_smem_bytes(d, 0);
  cudaError_t err = cudaFuncSetAttribute(gram_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile, r);
  gram_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x1, x2, inv_ls, amp, out,
                                                                  n1, n2, d);
  return (int)cudaGetLastError();
}

int matern52_gram_bwd_theta(const double* x1, const double* x2, const double* inv_ls,
                            const double* amp, const double* g, double* partial,
                            double* d_inv_ls, double* d_amp, int r, int n1, int n2, int d,
                            void* stream) {
  size_t smem = matern52_gram_smem_bytes(d, 1);
  cudaError_t err = cudaFuncSetAttribute(gram_bwd_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile, r);
  cudaStream_t s = (cudaStream_t)stream;
  gram_bwd_partial_kernel<<<grid, kThreads, smem, s>>>(x1, x2, inv_ls, g, partial, n1, n2, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_bwd_reduce_kernel<<<dim3(d + 1, r), kThreads, 0, s>>>(partial, inv_ls, amp, d_inv_ls,
                                                             d_amp, (int)(grid.x * grid.y), d);
  return (int)cudaGetLastError();
}

}  // extern "C"
