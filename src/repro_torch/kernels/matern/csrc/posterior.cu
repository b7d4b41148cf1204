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
// 2·q·n² f64 operations.  At the BO main path's shape (n ≈ 544, q ≤ 10) that
// is 2.4 MB and ~6 MFLOP, under a microsecond of device time, so latency
// bounds a round: the time to get K⁻¹ onto the SMs and the length of the
// dependent chains.  When scoring a large pool (q = 1000, n = 2048) the f64
// operations bound it: the product k* K⁻¹ is 8.4 GFLOP, ~125 µs at the
// card's 67 TFLOP/s f64 tensor-core rate, ~247 µs at the CUDA cores' 34
// TFLOP/s, where this kernel runs it.  K2 reads t (8·q·n bytes) and does
// O(q·n·D) f64 operations: at the MSO's shape well under a microsecond of
// either, so latency bounds it (two launches, a few dependent chains); at
// q = 1000, n = 2048 reading t (16 MB, ~5 µs) does.
//
// K1's summation order, fixed by n alone (kChunk = C = 64, kTile = W = 64):
//   t_ij  = (((c_0 + c_1) + c_2) + …),  c_s = Σ_{l in chunk s} k*_il K⁻¹_lj
//           an fma chain from 0 in l order over the C rows of chunk s
//           (the last chunk's rows past n count as zeros);
//   mean_i, quad_i = Σ_j k*_ij α_j, Σ_j t_ij k*_ij: in each column tile of W
//           a fixed tree (column j + 32 onto j, then a warp-shuffle tree),
//           then the tiles' sums in tile order.
// Any grid computes exactly these operations, so a row is bitwise the same
// alone, in a batch, or next to repeated padding rows, in either regime:
//  * split (small q, the MSO's rounds): posterior_fwd_split_kernel, one
//    block per (column tile, chunk, tile of kSplitRows queries), reads one
//    C×W tile of K⁻¹ once (cp.async, under the k* it needs) and writes its
//    c_s for every query row to scratch (S, q, n), S = ceil(n / C); the
//    blocks of column tile 0 also write their k* (q, n) for the merge.  At
//    q = 10, n = 544 that is 9 × 9 = 81 blocks, K⁻¹ spread over the SMs.
//  * walk (large q: where the walk's blocks fill the SMs or the split
//    partials would pass 32 MB): posterior_fwd_walk_kernel, one block per
//    (kWalkCols columns, kWalkRows queries), walks every chunk in stages
//    of kStageRows rows of K⁻¹ (a 2-slot cp.async ring in shared memory;
//    the stage's xt rows one stage ahead).  Each of 512 threads owns 4
//    rows × 4 columns in registers (a K⁻¹ element read from shared memory
//    serves 4 rows, a k* value 4 columns), computes c_s from 0 and adds it
//    to its running t at the chunk's end.  One barrier a stage: a thread
//    computes its share of the next stage's k* and then this stage's
//    product, so that warps in the one overlap warps in the other.  No
//    scratch.
//  * merge, split regime: posterior_fwd_merge_kernel, one block per query
//    row, a warp per column tile: adds the S partials in chunk order
//    (their loads in flight together), writes t, takes the row's k* from
//    scratch, and sums mean and quad as above.  Walk regime:
//    posterior_fwd_merge_walk_kernel, 8 query rows a block, a warp per
//    column tile: stages the tile's training rows (the next tile's under
//    this one's sums), scales them once for the 8 rows, recomputes k*,
//    and sums the same way.
// k*, the chunk chains and the merge's adds are written with explicit
// fma / __dmul_rn / __dadd_rn, so that the three kernels round alike
// whatever nvcc would contract.  Every input row a block needs is staged
// in shared memory by cp.async first: a chain over D never waits on
// device memory.
//
// Design, besides.
//  * f64 throughout.  The TPU kernel computes in f32 (no f64 there), and the
//    f32 cancellation in σ_f² − k*K⁻¹k*ᵀ grows with ‖K⁻¹‖; the BO runs in f64.
//  * No padding copies: the ragged q edge and the ragged n edge are masked
//    in the kernels (K⁻¹ tiles are zero-filled past n, k* is 0 there).
//    Training sets padded with _FAR pseudo-points have d² ~ 1e15 there,
//    where exp underflows to 0 and the polynomial stays finite (no inf·0).
//  * No atomics.  FP64 tensor cores (mma.sync m8n8k4) for the walk's
//    product are later work.

#include "matern.cuh"

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr double kVarFloor = 1e-16;

// K1's geometry; kernel.py mirrors these (CHUNK, TILE, SPLIT_ROWS,
// WALK_ROWS, WALK_COLS, STAGE_ROWS) in its plan() and shared-memory sizes.
constexpr int kChunk = 64;                 // C: rows of K⁻¹ a chunk
constexpr int kTile = 64;                  // W: columns of a split block and a mean/var tile
constexpr int kSplitRows = 16;             // query rows of a split block
constexpr int kWalkRows = 32;              // query rows of a walk block
constexpr int kWalkCols = 256;             // columns of a walk block
constexpr int kStageRows = 32;             // K⁻¹ rows of a walk ring stage
constexpr int kWalkThreads = 512;          // threads of a walk block
constexpr int kMergeWarps = 16;            // most warps of a merge block
constexpr int kPartBatch = 16;             // partials a merge lane loads at once
constexpr int kMergeRows = 8;              // query rows of a walk-regime merge block
constexpr int kMergeWalkWarps = 16;        // most warps of a walk-regime merge block
constexpr int kPiece = 64;                 // coordinates a K1 split or K2 block stages at a time
constexpr int kBwdMergeWarps = 8;          // warps of a K2 merge block
constexpr size_t kMaxSmem = 232448;        // dynamic shared memory a block may use

// ---------------------------------------------------------------- K1 math
// Every k* below is the same sequence of roundings: a = xq ⊙ inv_ls and
// b = xt ⊙ inv_ls by __dmul_rn, |a|², |b|² and a·b as fma chains in k
// order, then matern() (matern.cuh, which gram.cu's K3 and K4 share, with
// the cp.async and staging helpers).  Where the scaled rows are staged in shared memory
// or scaled on the fly, and whether D is staged whole or in pieces of
// kPiece coordinates (the chains carried from piece to piece), changes
// nothing.

// count contiguous doubles of src into dst, asynchronously; zeros from
// index valid on
__device__ __forceinline__ void stage_flat(double* dst, const double* src, int count,
                                           int valid) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const bool ok = e < valid;
    cp_async8(smem_u32(dst + e), ok ? src + e : src, ok);
  }
}

// A kRows × kCols tile of a row-major matrix (leading dimension ld) at src
// into dst (dense), asynchronously; zeros at rows ≥ vr or columns ≥ vc.
// 16-byte copies when src and ld keep every row 16-byte aligned (then vc
// is even too), else 8-byte ones.  base: any valid address of the matrix.
template <int kRows, int kCols>
__device__ __forceinline__ void stage_tile(double* dst, const double* src, int ld, int vr,
                                           int vc, const double* base) {
  if ((ld & 1) == 0 && ((uintptr_t)src & 15) == 0 && ((uintptr_t)base & 15) == 0) {
    constexpr int kPairs = kCols / 2;
    const int c = 2 * (threadIdx.x % kPairs);
    const bool col_ok = c < vc;
    for (int r = threadIdx.x / kPairs; r < kRows; r += blockDim.x / kPairs) {
      const bool ok = r < vr && col_ok;
      cp_async16(smem_u32(dst + r * kCols + c), ok ? src + (size_t)r * ld + c : base, ok);
    }
  } else {
    const int c = threadIdx.x % kCols;
    const bool col_ok = c < vc;
    for (int r = threadIdx.x / kCols; r < kRows; r += blockDim.x / kCols) {
      const bool ok = r < vr && col_ok;
      cp_async8(smem_u32(dst + r * kCols + c), ok ? src + (size_t)r * ld + c : base, ok);
    }
  }
}

// M values k*(a_i, x_l[m]) from raw training rows x_l[m] (scaled on the fly)
// and the scaled query row a (|a|² = asq)
template <int M>
__device__ __forceinline__ void kstar_rows(const double* a, double asq,
                                           const double* const* x, const double* ils,
                                           int d, double amp, double* out) {
  double bsq[M], ab[M];
#pragma unroll
  for (int m = 0; m < M; ++m) bsq[m] = ab[m] = 0.0;
  for (int k = 0; k < d; ++k) {
    const double ak = a[k], il = ils[k];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const double b = __dmul_rn(x[m][k], il);
      bsq[m] = __fma_rn(b, b, bsq[m]);
      ab[m] = __fma_rn(ak, b, ab[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) out[m] = matern(asq, bsq[m], ab[m], amp);
}

// scale rows [0, rows) of x (stride ds) in place by ils; then |row|² of
// each into sq (threads < rows, an fma chain each)
__device__ __forceinline__ void scale_rows(double* x, int ds, int rows, const double* ils,
                                           int d, double* sq) {
  scale_cols(x, ds, rows, d, ils);
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    const double* row = x + threadIdx.x * ds;
    double s = 0.0;
    for (int k = 0; k < d; ++k) s = __fma_rn(row[k], row[k], s);
    sq[threadIdx.x] = s;
  }
}

// ------------------------------------------------------ K1 split regime
// grid (ceil(n / kTile), S, studies · ceil(q / kSplitRows)), kThreads
// threads.  part[(s, i, j)] = c_s[i, j]; blocks of column tile 0 also write
// their chunk's k*_il to kst[(i, l)] for the merge.  A study's inputs,
// outputs and scratch lie one after another (its scratch (S + 1)·q·n
// doubles, part then kst), so each block reads and writes what a solo call
// on its study would.  The query and chunk rows
// are staged kPiece coordinates at a time (one piece up to D = kPiece),
// the K⁻¹ tile under the first piece's chains.
__global__ void __launch_bounds__(kThreads)
posterior_fwd_split_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
                           const double* __restrict__ kinv, const double* __restrict__ inv_ls,
                           const double* __restrict__ amp_ptr, double* __restrict__ part,
                           double* __restrict__ kst, int q, int n, int d) {
  extern __shared__ double smem[];
  const int pw = d < kPiece ? d : kPiece, ps = coord_stride(pw);
  double* kv = smem;                                  // [kChunk][kTile] K⁻¹ tile
  double* ks = kv + kChunk * kTile;                   // [kChunk][kSplitRows] k*
  double* ils = ks + kChunk * kSplitRows;             // [pw] the piece's 1/ℓ
  double* a = ils + pw;                               // [kSplitRows][ps] queries, a piece
  double* x = a + kSplitRows * ps;                    // [kChunk][pw] chunk rows (raw), a piece

  const int tid = threadIdx.x;
  const int qtiles = (q + kSplitRows - 1) / kSplitRows, st = blockIdx.z / qtiles;
  const int j0 = blockIdx.x * kTile, s = blockIdx.y, l0 = s * kChunk;
  const int i0 = (blockIdx.z - st * qtiles) * kSplitRows;
  xq += (size_t)st * q * d;
  xt += (size_t)st * n * d;
  kinv += (size_t)st * n * n;
  inv_ls += (size_t)st * d;
  part += (size_t)st * (gridDim.y + 1) * q * n;
  kst += (size_t)st * (gridDim.y + 1) * q * n;
  const double amp = amp_ptr[st];

  // k*: thread owns query i and chunk rows l, l + 16, l + 32, l + 48
  constexpr int kM = kChunk * kSplitRows / kThreads;
  const int i = tid % kSplitRows, l = tid / kSplitRows;
  double asq = 0.0, bsq[kM], ab[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) bsq[m] = ab[m] = 0.0;
  for (int k0 = 0; k0 < d; k0 += kPiece) {
    const int kw = d - k0 < kPiece ? d - k0 : kPiece;
    if (k0 > 0) __syncthreads();                      // the last piece is read
    // a group: the piece's rows k* needs; then, under the first piece,
    // a group of the K⁻¹ tile (zeros past n)
    stage_rows(a, ps, xq + (size_t)i0 * d + k0, d, kSplitRows, q - i0, kw);
    stage_rows(x, pw, xt + (size_t)l0 * d + k0, d, kChunk, n - l0, kw);
    for (int k = tid; k < kw; k += kThreads) cp_async8(smem_u32(ils + k), inv_ls + k0 + k, true);
    cp_async_commit();
    if (k0 == 0) {
      stage_tile<kChunk, kTile>(kv, kinv + (size_t)l0 * n + j0, n, n - l0, n - j0, kinv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scale_cols(a, ps, kSplitRows, kw, ils);
    __syncthreads();
    for (int k = 0; k < kw; ++k) {
      const double ak = a[i * ps + k], il = ils[k];
      asq = __fma_rn(ak, ak, asq);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const double b = __dmul_rn(x[(l + m * (kThreads / kSplitRows)) * pw + k], il);
        bsq[m] = __fma_rn(b, b, bsq[m]);
        ab[m] = __fma_rn(ak, b, ab[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int r = l + m * (kThreads / kSplitRows);
    const bool ok = l0 + r < n && i0 + i < q;
    const double kk = matern(asq, bsq[m], ab[m], amp);
    ks[r * kSplitRows + i] = ok ? kk : 0.0;
    if (ok && blockIdx.x == 0) kst[(size_t)(i0 + i) * n + l0 + r] = kk;
  }
  cp_async_wait<0>();
  __syncthreads();

  // c_s: thread owns column c and rows g, g + 4, g + 8, g + 12
  constexpr int kGroups = kThreads / kTile;
  constexpr int kPer = kSplitRows / kGroups;
  const int c = tid % kTile, g = tid / kTile;
  double acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.0;
#pragma unroll 16
  for (int l = 0; l < kChunk; ++l) {
    const double kl = kv[l * kTile + c];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      acc[r] = __fma_rn(ks[l * kSplitRows + g + kGroups * r], kl, acc[r]);
  }
  if (j0 + c < n) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int row = i0 + g + kGroups * r;
      if (row < q) part[((size_t)s * q + row) * n + j0 + c] = acc[r];
    }
  }
}

// ------------------------------------------------------- K1 walk regime
// grid (ceil(n / kWalkCols), ceil(q / kWalkRows), studies), kWalkThreads
// threads; writes t.  A chunk is kChunk / kStageRows stages; the last chunk's
// stages past n are zeros, as the split regime's rows past n.  One
// barrier a stage: after it a thread computes its k* of the next stage
// and then this stage's product, so that warps in the one overlap warps
// in the other.  K⁻¹ rows run through a 2-slot ring, the (small) training
// rows through a 3-slot ring one stage ahead, k* through 2 slots.
__global__ void __launch_bounds__(kWalkThreads, 1)
posterior_fwd_walk_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
                          const double* __restrict__ kinv, const double* __restrict__ inv_ls,
                          const double* __restrict__ amp_ptr, double* __restrict__ t,
                          int q, int n, int d) {
  extern __shared__ double smem[];
  const int ds = coord_stride(d);
  constexpr int kTileSize = kStageRows * kWalkCols;
  double* kring = smem;                               // [2][kStageRows][kWalkCols]
  double* xring = kring + 2 * kTileSize;              // [3][kStageRows][d] raw xt rows
  double* ks = xring + 3 * kStageRows * d;            // [2][kStageRows][kWalkRows]
  double* ils = ks + 2 * kStageRows * kWalkRows;      // [d]
  double* a = ils + d;                                // [kWalkRows][ds]
  double* asq = a + kWalkRows * ds;                   // [kWalkRows]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWalkWarps = kWalkThreads / 32;
  const int j0 = blockIdx.x * kWalkCols, i0 = blockIdx.y * kWalkRows, st = blockIdx.z;
  constexpr int kPerChunk = kChunk / kStageRows;
  const int nstages = (n + kChunk - 1) / kChunk * kPerChunk;
  xq += (size_t)st * q * d;
  xt += (size_t)st * n * d;
  kinv += (size_t)st * n * n;
  inv_ls += (size_t)st * d;
  t += (size_t)st * q * n;
  const double amp = amp_ptr[st];
  // rows 2ty + {0, 1, 16, 17}, columns 2cx + {0, 1, 128, 129}: two 16-byte
  // loads of k* and two of K⁻¹ a step; a warp's are 8 and 4 distinct
  const int ty = lane >> 2, cx = warp * 4 + (lane & 3);

  auto issue_k = [&](int st) {               // stage st's K⁻¹ rows
    if (st >= nstages) return;
    double* dst = kring + (st & 1) * kTileSize;
    const int l0 = st * kStageRows;
    if (l0 < n)
      stage_tile<kStageRows, kWalkCols>(dst, kinv + (size_t)l0 * n + j0, n, n - l0, n - j0,
                                        kinv);
    else                                     // a stage past n: zeros
      for (int e = tid; e < kTileSize; e += kWalkThreads) dst[e] = 0.0;
  };
  auto issue_x = [&](int st) {               // stage st's training rows
    if (st >= nstages) return;
    const int l0 = st * kStageRows;
    stage_flat(xring + (st % 3) * kStageRows * d, l0 < n ? xt + (size_t)l0 * d : xt,
               kStageRows * d, (n - l0) * d);
  };
  auto kstar_stage = [&](int st) {           // k* of stage st: query lane, rows warp + 16m
    constexpr int kM = kStageRows * kWalkRows / kWalkThreads;
    const double* rows[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m)
      rows[m] = xring + (st % 3) * kStageRows * d + (warp + m * kWalkWarps) * d;
    double kk[kM];
    kstar_rows<kM>(a + lane * ds, asq[lane], rows, ils, d, amp, kk);
    double* out = ks + (st & 1) * kStageRows * kWalkRows;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int r = warp + m * kWalkWarps;
      out[r * kWalkRows + lane] = st * kStageRows + r < n ? kk[m] : 0.0;
    }
  };

  stage_rows(a, ds, xq + (size_t)i0 * d, d, kWalkRows, q - i0, d);
  for (int k = tid; k < d; k += kWalkThreads) cp_async8(smem_u32(ils + k), inv_ls + k, true);
  issue_k(0);
  issue_x(0);
  issue_x(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  scale_rows(a, ds, kWalkRows, ils, d, asq);
  __syncthreads();
  kstar_stage(0);

  double run[4][4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) run[r][c] = acc[r][c] = 0.0;
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<0>();              // K⁻¹ rows of st, training rows of st + 1 (own)
    __syncthreads();                 // ... everyone's; k* of st is written; the
    issue_k(st + 1);                 // slots the copies below refill are read
    issue_x(st + 2);
    cp_async_commit();
    if (st + 1 < nstages) kstar_stage(st + 1);

    const double* kv = kring + (st & 1) * kTileSize;
    const double* kst_ = ks + (st & 1) * kStageRows * kWalkRows;
#pragma unroll 2
    for (int l = 0; l < kStageRows; ++l) {
      const double2 r01 = *reinterpret_cast<const double2*>(kst_ + l * kWalkRows + 2 * ty);
      const double2 r23 = *reinterpret_cast<const double2*>(kst_ + l * kWalkRows + 16 + 2 * ty);
      const double2 c01 = *reinterpret_cast<const double2*>(kv + l * kWalkCols + 2 * cx);
      const double2 c23 = *reinterpret_cast<const double2*>(kv + l * kWalkCols + 128 + 2 * cx);
      const double kr[4] = {r01.x, r01.y, r23.x, r23.y};
      const double kc[4] = {c01.x, c01.y, c23.x, c23.y};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __fma_rn(kr[r], kc[c], acc[r][c]);
    }
    if (st % kPerChunk == kPerChunk - 1) {   // chunk st / kPerChunk is complete
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          run[r][c] = st < kPerChunk ? acc[r][c] : __dadd_rn(run[r][c], acc[r][c]);
          acc[r][c] = 0.0;
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i0 + 2 * ty + (r & 1) + 16 * (r >> 1);
    if (row >= q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = j0 + 2 * cx + (c & 1) + 128 * (c >> 1);
      if (col < n) t[(size_t)row * n + col] = run[r][c];
    }
  }
}

// ------------------------------------------------------------- K1 merge
// A column tile's sums: tile_sum (matern.cuh), which K5 shares.

// The tiles' sums in tile order: mean_i, and var_i = max(σ_f² − quad_i, floor).
__device__ __forceinline__ void finish_row(const double* msum, const double* vsum,
                                           int ntiles, double amp, double* mean,
                                           double* var) {
  double m = msum[0], quad = vsum[0];
  for (int tile = 1; tile < ntiles; ++tile) {
    m = __dadd_rn(m, msum[tile]);
    quad = __dadd_rn(quad, vsum[tile]);
  }
  *mean = m;
  const double v = __dsub_rn(amp, quad);
  *var = v > kVarFloor ? v : kVarFloor;
}

// Split regime: grid (q, studies), 32 · min(kMergeWarps, ceil(n / kTile)) threads;
// one row, a warp per column tile (columns j and j + 32 in a lane):
// t_ij = ((p_0 + p_1) + …) over the nparts partials part[(s, i, j)], k*
// from kst, then mean and var.
__global__ void __launch_bounds__(kMergeWarps * 32)
posterior_fwd_merge_kernel(const double* __restrict__ alpha,
                           const double* __restrict__ amp_ptr,
                           const double* __restrict__ part, int nparts,
                           const double* __restrict__ kst, double* __restrict__ mean,
                           double* __restrict__ var, double* __restrict__ t, int q, int n) {
  extern __shared__ double smem[];
  const int ntiles = (n + kTile - 1) / kTile;
  double* msum = smem;                                // [ntiles]
  double* vsum = msum + ntiles;                       // [ntiles]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int i = blockIdx.x, st = blockIdx.y;
  const size_t plane = (size_t)q * n;
  alpha += (size_t)st * n;
  part += (size_t)st * (nparts + 1) * plane;
  kst += (size_t)st * (nparts + 1) * plane;
  mean += (size_t)st * q;
  var += (size_t)st * q;
  t += (size_t)st * plane;

  for (int tile = warp; tile < ntiles; tile += nwarps) {
    int j[2];
    bool ok[2];
    double tv[2], pm[2], pv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      j[h] = tile * kTile + lane + 32 * h;
      ok[h] = j[h] < n;
      tv[h] = 0.0;
    }
    double kk[2], al[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      kk[h] = ok[h] ? kst[(size_t)i * n + j[h]] : 0.0;
      al[h] = ok[h] ? alpha[j[h]] : 0.0;
    }
    // the partials kPartBatch at a time, their loads in flight together
    for (int s0 = 0; s0 < nparts; s0 += kPartBatch) {
      double p[2][kPartBatch];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u)
          p[h][u] = ok[h] && s0 + u < nparts
                        ? part[(size_t)(s0 + u) * plane + (size_t)i * n + j[h]] : 0.0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < kPartBatch; ++u)
          if (s0 + u < nparts) tv[h] = s0 + u == 0 ? p[h][u] : __dadd_rn(tv[h], p[h][u]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ok[h]) t[(size_t)i * n + j[h]] = tv[h];
      pm[h] = ok[h] ? __dmul_rn(kk[h], al[h]) : 0.0;
      pv[h] = ok[h] ? __dmul_rn(tv[h], kk[h]) : 0.0;
    }
    const double m = tile_sum(pm[0], pm[1]), v = tile_sum(pv[0], pv[1]);
    if (lane == 0) {
      msum[tile] = m;
      vsum[tile] = v;
    }
  }
  __syncthreads();
  if (tid == 0) finish_row(msum, vsum, ntiles, amp_ptr[st], mean + i, var + i);
}

// Walk regime: grid (ceil(q / kMergeRows), studies), 32 · warps threads; t is
// final.  A block takes kMergeRows query rows, a warp a column tile at a
// time: it stages the tile's training rows in its own slice of shared
// memory (the next tile's under this one's sums), scales them once for
// the block's rows, recomputes their k* and sums mean and quad as the
// split merge.
__global__ void __launch_bounds__(kMergeWalkWarps * 32)
posterior_fwd_merge_walk_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
                                const double* __restrict__ alpha,
                                const double* __restrict__ inv_ls,
                                const double* __restrict__ amp_ptr,
                                const double* __restrict__ t, double* __restrict__ mean,
                                double* __restrict__ var, int q, int n, int d) {
  extern __shared__ double smem[];
  const int ds = coord_stride(d);
  const int ntiles = (n + kTile - 1) / kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  double* ils = smem;                                 // [d]
  double* a = ils + d;                                // [kMergeRows][ds]
  double* asq = a + kMergeRows * ds;                  // [kMergeRows]
  double* msum = asq + kMergeRows;                    // [kMergeRows][ntiles]
  double* vsum = msum + kMergeRows * ntiles;          // [kMergeRows][ntiles]
  double* b = vsum + kMergeRows * ntiles + warp * kTile * ds;   // [kTile][ds], this warp's

  const int i0 = blockIdx.x * kMergeRows, st = blockIdx.y;
  xq += (size_t)st * q * d;
  xt += (size_t)st * n * d;
  alpha += (size_t)st * n;
  inv_ls += (size_t)st * d;
  t += (size_t)st * q * n;
  mean += (size_t)st * q;
  var += (size_t)st * q;
  const double amp = amp_ptr[st];
  stage_rows(a, ds, xq + (size_t)i0 * d, d, kMergeRows, q - i0, d);
  for (int k = tid; k < d; k += blockDim.x) cp_async8(smem_u32(ils + k), inv_ls + k, true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  scale_rows(a, ds, kMergeRows, ils, d, asq);
  __syncthreads();

  // a tile's training rows (kTile · d contiguous doubles of xt) into this
  // warp's slice, asynchronously; element e = lane + 32m goes to row r,
  // column k, advanced without a division
  const int dr = 32 / d, dk = 32 % d;
  auto stage = [&](int tile) {
    const double* src = xt + (size_t)tile * kTile * d;
    const int valid = (n - tile * kTile) * d;
    int r = lane / d, k = lane % d;
    for (int e = lane; e < kTile * d; e += 32) {
      cp_async8(smem_u32(b + r * ds + k), e < valid ? src + e : xt, e < valid);
      r += dr;
      k += dk;
      if (k >= d) {
        k -= d;
        ++r;
      }
    }
    cp_async_commit();
  };
  if (warp < ntiles) stage(warp);
  for (int tile = warp; tile < ntiles; tile += nwarps) {
    const int j0 = tile * kTile;
    bool ok[2];
    double tv[kMergeRows][2], al[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + lane + 32 * h;
      ok[h] = j < n;
      al[h] = ok[h] ? alpha[j] : 0.0;
#pragma unroll
      for (int r = 0; r < kMergeRows; ++r)
        tv[r][h] = ok[h] && i0 + r < q ? t[(size_t)(i0 + r) * n + j] : 0.0;
    }
    cp_async_wait<0>();
    __syncwarp();
    // a lane scales its own two rows, then reads only them
    double bsq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double* row = b + (lane + 32 * h) * ds;
      double s2 = 0.0;
      for (int k = 0; k < d; ++k) {
        const double v = __dmul_rn(row[k], ils[k]);
        row[k] = v;
        s2 = __fma_rn(v, v, s2);
      }
      bsq[h] = s2;
    }
    double ab[kMergeRows][2];
#pragma unroll
    for (int r = 0; r < kMergeRows; ++r) ab[r][0] = ab[r][1] = 0.0;
    for (int k = 0; k < d; ++k) {
      const double b0 = b[lane * ds + k], b1 = b[(lane + 32) * ds + k];
#pragma unroll
      for (int r = 0; r < kMergeRows; ++r) {
        const double ak = a[r * ds + k];
        ab[r][0] = __fma_rn(ak, b0, ab[r][0]);
        ab[r][1] = __fma_rn(ak, b1, ab[r][1]);
      }
    }
    __syncwarp();                            // b is read: stage the next tile
    if (tile + nwarps < ntiles) stage(tile + nwarps);
#pragma unroll
    for (int r = 0; r < kMergeRows; ++r) {
      double pm[2], pv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const double kk = matern(asq[r], bsq[h], ab[r][h], amp);
        pm[h] = ok[h] ? __dmul_rn(kk, al[h]) : 0.0;
        pv[h] = ok[h] ? __dmul_rn(tv[r][h], kk) : 0.0;
      }
      const double m = tile_sum(pm[0], pm[1]), v = tile_sum(pv[0], pv[1]);
      if (lane == 0) {
        msum[r * ntiles + tile] = m;
        vsum[r * ntiles + tile] = v;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < kMergeRows && i0 + tid < q)
    finish_row(msum + tid * ntiles, vsum + tid * ntiles, ntiles, amp, mean + i0 + tid,
               var + i0 + tid);
}

// the split kernel's shared memory: its widest piece is min(d, kPiece)
size_t split_smem(int d) {
  const int pw = d < kPiece ? d : kPiece;
  return sizeof(double) * ((size_t)kChunk * kTile + kChunk * kSplitRows + pw +
                           (size_t)kSplitRows * coord_stride(pw) + (size_t)kChunk * pw);
}

size_t walk_smem(int d) {
  const int ds = coord_stride(d);
  return sizeof(double) * (2 * (size_t)kStageRows * kWalkCols + 3 * (size_t)kStageRows * d +
                           2 * kStageRows * kWalkRows + d + (size_t)kWalkRows * ds + kWalkRows);
}

size_t merge_smem(int n) {
  return sizeof(double) * 2 * (size_t)((n + kTile - 1) / kTile);
}

// the walk merge's shared memory with `warps` warps
size_t merge_walk_smem(int n, int d, int warps) {
  const int ds = coord_stride(d);
  return sizeof(double) * ((size_t)d + (size_t)kMergeRows * (ds + 1) +
                           2 * (size_t)kMergeRows * ((n + kTile - 1) / kTile) +
                           (size_t)warps * kTile * ds);
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------- K2
// K2's summation order, fixed by n alone (column tiles of kTile = 64
// training points, as K1's mean/var tiles):
//   c_ij     by one sequence of roundings (bwd_weight);
//   in tile T, csum_iT = Σ_{j in T} c_ij and s_ikT = Σ_{j in T} c_ij b_jk
//            (each product rounded) by tile_sum's tree: column j + 32
//            onto j, then pairs 16, 8, 4, 2, 1 apart (tree64);
//   csum_i, s_ik = ((T_0 + T_1) + …) over the tiles in tile order;
//   dxq_ik   = il_k (csum_i a_ik − s_ik).
// So which blocks compute a row never changes its bits:
//  * posterior_bwd_split_kernel<R>: one block per (column tile, R query
//    rows), R = 1 at q ≤ 16 (the MSO's rounds: 9 × 10 = 90 blocks at
//    q = 10, n = 544), 16 above (a tile's training rows staged once per 16
//    queries).  It stages the tile's training rows and its query rows by
//    cp.async, D in pieces of kPiece coordinates scaled by 1/ℓ once, with
//    its t, α, ḡ and var in registers under the copies; carries the |a|²,
//    |b|², a·b chains from piece to piece, computes its c_ij, then one
//    thread a (row, coordinate) evaluates a tree over the tile's 64
//    columns from shared memory, rows fastest across a warp (the tree's
//    loads, not its adds, bound it); it writes D + 1 partials a row (the
//    s_ik, then csum_i) to scratch (tiles, q, D + 1).
//  * posterior_bwd_merge_kernel: a warp per (query row, 32 coordinates)
//    adds the tiles' partials in tile order (their loads in flight
//    together), a lane per coordinate, and writes dxq.
// Probed on the card and dropped, each slower: one block a row walking its
// tiles and merging itself (one launch, but the tiles run in series),
// blocks of 4 tiles, 32 rows a block, two rows a tree thread.

// tile_sum's tree over 64 leaves leaf(0..63), evaluated by one thread:
// tree64<S>(leaf, l) sums the leaves ≡ l (mod S), (leaves ≡ l mod 2S) +
// (leaves ≡ l + S mod 2S), down to leaf(l) + leaf(l + 32) at S = 32; so
// tree64<1>(leaf, 0) adds the pairs lane 0 of tile_sum adds.
template <int S, typename Leaf>
__device__ __forceinline__ double tree64(const Leaf& leaf, int l) {
  if constexpr (S == 32)
    return __dadd_rn(leaf(l), leaf(l + 32));
  else
    return __dadd_rn(tree64<2 * S>(leaf, l), tree64<2 * S>(leaf, l + S));
}

// c_ij from |a_i|², |b_j|², a_i·b_j; coef = −(5/3) σ_f², gv2 = 2 ḡv_i [var_i > floor]
__device__ __forceinline__ double bwd_weight(double asq, double bsq, double ab, double coef,
                                             double gmi, double gv2, double al, double tij) {
  const double rr = __dsqrt_rn(__dadd_rn(sq_dist(asq, bsq, ab), 1e-36));
  const double w = __dsub_rn(__dmul_rn(gmi, al), __dmul_rn(gv2, tij));
  const double f = __dmul_rn(__dmul_rn(coef, __fma_rn(kSqrt5, rr, 1.0)),
                             exp(__dmul_rn(-kSqrt5, rr)));
  return __dmul_rn(f, w);
}

// grid (ceil(n / kTile), ceil(q / R), studies), kThreads threads: R query
// rows from i0 × the column tile from j0 of one study.  Writes part[(T, i, k)] = s_ikT for k < D
// and csum_iT at k = D.  A thread owns the pairs (rows row0 + kRowStep·m,
// column col); what c needs besides the chains (t, α, ḡm, ḡv, var, σ_f²)
// is loaded into registers under the staging.  At R = 1 one block an SM is
// asked for (more registers: the tree's loads in flight); at R = 16 three.
template <int R>
__global__ void __launch_bounds__(kThreads, R == 1 ? 1 : 3)
posterior_bwd_split_kernel(const double* __restrict__ xq, const double* __restrict__ xt,
                           const double* __restrict__ alpha, const double* __restrict__ t,
                           const double* __restrict__ var, const double* __restrict__ inv_ls,
                           const double* __restrict__ amp_ptr, const double* __restrict__ gm,
                           const double* __restrict__ gv, double* __restrict__ part,
                           int q, int n, int d) {
  constexpr int kRowStep = kThreads / kTile;
  static_assert(R <= kRowStep || R % kRowStep == 0, "the pairs must tile the threads");
  constexpr int kPer = R <= kRowStep ? 1 : R / kRowStep;
  constexpr int kCs = kTile + 1;                      // odd: rows of c over the banks
  extern __shared__ double smem[];
  const int pw = d < kPiece ? d : kPiece, ps = coord_stride(pw);
  double* xs = smem;                                  // [kTile][ps] training rows, a piece
  double* as = xs + kTile * ps;                       // [R][ps] query rows, a piece
  double* ils = as + R * ps;                          // [pw] the piece's 1/ℓ
  double* cs = ils + pw;                              // [R][kCs] c

  const int tid = threadIdx.x, tile = blockIdx.x, j0 = tile * kTile, i0 = blockIdx.y * R;
  const int st = blockIdx.z;
  const int npieces = (d + kPiece - 1) / kPiece;
  xq += (size_t)st * q * d;
  xt += (size_t)st * n * d;
  alpha += (size_t)st * n;
  t += (size_t)st * q * n;
  var += (size_t)st * q;
  inv_ls += (size_t)st * d;
  gm += (size_t)st * q;
  gv += (size_t)st * q;
  part += (size_t)st * gridDim.x * q * (d + 1);
  const int col = tid % kTile, row0 = tid / kTile;
  const bool active = row0 < R, col_ok = j0 + col < n;

  const double coef = __dmul_rn(-5.0 / 3.0, amp_ptr[st]);
  const double al = col_ok ? alpha[j0 + col] : 0.0;
  double tv[kPer], gmv[kPer], gv2[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int i = i0 + row0 + kRowStep * m;
    const bool row_ok = active && i < q;
    tv[m] = row_ok && col_ok ? t[(size_t)i * n + j0 + col] : 0.0;
    gmv[m] = row_ok ? gm[i] : 0.0;
    gv2[m] = row_ok && var[i] > kVarFloor ? __dmul_rn(2.0, gv[i]) : 0.0;
  }

  // piece p's rows and 1/ℓ, scaled in place (xs and as are one array);
  // the caller has made sure the last piece is read
  auto load_piece = [&](int p) {
    const int k0 = p * kPiece, kw = d - k0 < kPiece ? d - k0 : kPiece;
    stage_rows(xs, ps, xt + (size_t)j0 * d + k0, d, kTile, n - j0, kw);
    stage_rows(as, ps, xq + (size_t)i0 * d + k0, d, R, q - i0, kw);
    for (int k = tid; k < kw; k += kThreads) cp_async8(smem_u32(ils + k), inv_ls + k0 + k, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scale_cols(xs, ps, kTile + R, kw, ils);
    __syncthreads();
    return kw;
  };

  // |a_i|², |b_j|², a_i·b_j: fma chains in k order, carried over the pieces
  double bsq = 0.0, asq[kPer], ab[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) asq[m] = ab[m] = 0.0;
  for (int p = 0; p < npieces; ++p) {
    if (p > 0) __syncthreads();
    const int kw = load_piece(p);
    if (active) {
      for (int k = 0; k < kw; ++k) {
        const double b = xs[col * ps + k];
        bsq = __fma_rn(b, b, bsq);
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const double ak = as[(row0 + kRowStep * m) * ps + k];
          asq[m] = __fma_rn(ak, ak, asq[m]);
          ab[m] = __fma_rn(ak, b, ab[m]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int r = row0 + kRowStep * m;
      cs[r * kCs + col] = i0 + r < q && col_ok
          ? bwd_weight(asq[m], bsq, ab[m], coef, gmv[m], gv2[m], al, tv[m]) : 0.0;
    }
  }
  __syncthreads();

  // the tile's sums, one thread a (row, coordinate), rows fastest (a warp
  // reads R rows of c and 32 / R values of b a leaf); the pieces from the
  // last (still staged) to the first; csum with the first
  const size_t w = (size_t)d + 1;
  double* out = part + ((size_t)tile * q + i0) * w;
  for (int p = npieces - 1; p >= 0; --p) {
    const int k0 = p * kPiece;
    int kw = d - k0 < kPiece ? d - k0 : kPiece;
    if (p < npieces - 1) {
      __syncthreads();
      kw = load_piece(p);
    }
    const int items = R * kw + (p == 0 ? R : 0);
    for (int e = tid; e < items; e += kThreads) {
      if (e < R * kw) {                      // s_ikT
        const int r = e % R, k = e / R;
        const double* c = cs + r * kCs;
        const double* b = xs + k;
        const double v = tree64<1>([&](int jj) { return __dmul_rn(c[jj], b[jj * ps]); }, 0);
        if (i0 + r < q) out[r * w + k0 + k] = v;
      } else {                               // csum_iT
        const int r = e - R * kw;
        const double* c = cs + r * kCs;
        const double v = tree64<1>([&](int jj) { return c[jj]; }, 0);
        if (i0 + r < q) out[r * w + d] = v;
      }
    }
  }
}

// grid (ceil(q · ceil(d / 32) / kBwdMergeWarps), studies), a warp per (query row,
// 32 coordinates), a lane per coordinate k: csum_i and s_ik over the
// ntiles partials in tile order (both columns' loads kPartBatch at a time,
// in flight together), then dxq_ik = il_k (csum_i a_ik − s_ik).
__global__ void __launch_bounds__(kBwdMergeWarps * 32)
posterior_bwd_merge_kernel(const double* __restrict__ xq, const double* __restrict__ inv_ls,
                           const double* __restrict__ part, int ntiles,
                           double* __restrict__ dxq, int q, int d) {
  const int kchunks = (d + 31) / 32;
  const int task = blockIdx.x * kBwdMergeWarps + (threadIdx.x >> 5);
  const int i = task / kchunks, k = (task - i * kchunks) * 32 + (threadIdx.x & 31);
  if (i >= q || k >= d) return;
  const size_t w = (size_t)d + 1, plane = (size_t)q * w, st = blockIdx.y;
  xq += st * q * d;
  inv_ls += st * d;
  part += st * ntiles * plane;
  dxq += st * q * d;
  const double* row = part + (size_t)i * w;
  const double il = inv_ls[k], x = xq[(size_t)i * d + k];
  double csum = 0.0, s = 0.0;
  for (int t0 = 0; t0 < ntiles; t0 += kPartBatch) {
    double pc[kPartBatch], pk[kPartBatch];
#pragma unroll
    for (int u = 0; u < kPartBatch; ++u) {
      const bool ok = t0 + u < ntiles;
      pc[u] = ok ? row[(size_t)(t0 + u) * plane + d] : 0.0;
      pk[u] = ok ? row[(size_t)(t0 + u) * plane + k] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kPartBatch; ++u) {
      if (t0 + u >= ntiles) break;
      csum = t0 + u == 0 ? pc[u] : __dadd_rn(csum, pc[u]);
      s = t0 + u == 0 ? pk[u] : __dadd_rn(s, pk[u]);
    }
  }
  dxq[(size_t)i * d + k] = __dmul_rn(il, __dsub_rn(__dmul_rn(csum, __dmul_rn(x, il)), s));
}

size_t bwd_split_smem(int d, int rows) {
  const int pw = d < kPiece ? d : kPiece;
  return sizeof(double) *
         ((size_t)(kTile + rows) * coord_stride(pw) + pw + (size_t)rows * (kTile + 1));
}

template <int R>
cudaError_t launch_bwd(const double* xq, const double* xt, const double* alpha,
                       const double* t, const double* var, const double* inv_ls,
                       const double* amp, const double* gm, const double* gv, double* part,
                       double* dxq, int q, int n, int d, int studies, cudaStream_t s) {
  const int ntiles = (n + kTile - 1) / kTile;
  const dim3 grid(ntiles, (q + R - 1) / R, studies);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const size_t smem = bwd_split_smem(d, R);
  cudaError_t err = allow_smem((const void*)posterior_bwd_split_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  posterior_bwd_split_kernel<R><<<grid, kThreads, smem, s>>>(xq, xt, alpha, t, var, inv_ls,
                                                               amp, gm, gv, part, q, n, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long tasks = (long long)q * ((d + 31) / 32);
  const dim3 mgrid((unsigned)((tasks + kBwdMergeWarps - 1) / kBwdMergeWarps), studies);
  posterior_bwd_merge_kernel<<<mgrid, kBwdMergeWarps * 32, 0, s>>>(xq, inv_ls, part, ntiles,
                                                                   dxq, q, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Every input and output leads with
// the study axis (studies ≥ 1 problems of one shape, one after another);
// each study's results are bitwise those of a solo call on it.  regime 0 =
// split: scratch holds studies · (ceil(n / 64) + 1) · q · n doubles (a
// study's chunk partials, then its k*); 1 = walk: scratch unused (may be
// null).
// The wrapper's plan() (kernel.py) picks the regime; either gives the same
// bits.  Two launches: the split or walk kernel, then the merge.
int matern52_posterior_fwd(const double* xq, const double* xt, const double* alpha,
                           const double* kinv, const double* inv_ls, const double* amp,
                           double* mean, double* var, double* t, double* scratch,
                           int q, int n, int d, int studies, int regime, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q < 1 || n < 1 || d < 1 || studies < 1 || studies > 65535)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (n + kChunk - 1) / kChunk;
  cudaError_t err;
  if (regime == 0) {
    const long long zs = (long long)studies * ((q + kSplitRows - 1) / kSplitRows);
    if (zs > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + kTile - 1) / kTile, nchunks, (unsigned)zs);
    if (scratch == nullptr || grid.y > 65535 || grid.z > 65535)
      return (int)cudaErrorInvalidValue;
    const size_t smem = split_smem(d);
    if ((err = allow_smem((const void*)posterior_fwd_split_kernel, smem)) != cudaSuccess)
      return (int)err;
    posterior_fwd_split_kernel<<<grid, kThreads, smem, s>>>(
        xq, xt, kinv, inv_ls, amp, scratch, scratch + (size_t)nchunks * q * n, q, n, d);
  } else if (regime == 1) {
    const dim3 grid((n + kWalkCols - 1) / kWalkCols, (q + kWalkRows - 1) / kWalkRows, studies);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = walk_smem(d);
    if ((err = allow_smem((const void*)posterior_fwd_walk_kernel, smem)) != cudaSuccess)
      return (int)err;
    posterior_fwd_walk_kernel<<<grid, kWalkThreads, smem, s>>>(xq, xt, kinv, inv_ls, amp, t,
                                                           q, n, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (regime == 0) {
    const int ntiles = (n + kTile - 1) / kTile;
    const int threads = 32 * (ntiles < kMergeWarps ? ntiles : kMergeWarps);
    const size_t msmem = merge_smem(n);
    if ((err = allow_smem((const void*)posterior_fwd_merge_kernel, msmem)) != cudaSuccess)
      return (int)err;
    posterior_fwd_merge_kernel<<<dim3(q, studies), threads, msmem, s>>>(
        alpha, amp, scratch, nchunks, scratch + (size_t)nchunks * q * n, mean, var, t, q, n);
  } else {
    int warps = kMergeWalkWarps;             // as many as the tiles' slices fit
    while (warps > 1 && merge_walk_smem(n, d, warps) > kMaxSmem) --warps;
    const size_t msmem = merge_walk_smem(n, d, warps);
    if (msmem > kMaxSmem) return (int)cudaErrorInvalidValue;
    if ((err = allow_smem((const void*)posterior_fwd_merge_walk_kernel, msmem)) != cudaSuccess)
      return (int)err;
    posterior_fwd_merge_walk_kernel<<<dim3((q + kMergeRows - 1) / kMergeRows, studies),
                                      32 * warps, msmem, s>>>(xq, xt, alpha, inv_ls, amp, t,
                                                              mean, var, q, n, d);
  }
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 on success).  Inputs and outputs lead with the
// study axis, as in matern52_posterior_fwd.  scratch holds studies ·
// ceil(n / 64) · q · (d + 1) doubles (each study's tiles' partials); rows (1 or 16) is the split
// kernel's query rows a block, which the wrapper's bwd_plan() (kernel.py)
// picks; either gives the same bits.  Two launches: split, then merge.
int matern52_posterior_bwd_xq(const double* xq, const double* xt, const double* alpha,
                              const double* t, const double* var, const double* inv_ls,
                              const double* amp, const double* gm, const double* gv,
                              double* dxq, double* scratch, int q, int n, int d, int studies,
                              int rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q < 1 || n < 1 || d < 1 || studies < 1 || studies > 65535 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (rows == 1)
    return (int)launch_bwd<1>(xq, xt, alpha, t, var, inv_ls, amp, gm, gv, scratch, dxq, q, n, d,
                              studies, s);
  if (rows == 16)
    return (int)launch_bwd<16>(xq, xt, alpha, t, var, inv_ls, amp, gm, gv, scratch, dxq, q, n,
                               d, studies, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
