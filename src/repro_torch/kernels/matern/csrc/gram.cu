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
// operations, so bytes bound it (also at n = 2048).  K4 reads Ḡ (the same
// bytes) and is bound by them too.  Both are far below a launch's latency
// at the fit's shape, so what counts there is the length of a block's
// dependent steps and how many blocks share the SMs.
//
// Design.
//  * f64 throughout: JAX's fit builds its gram in f64 (x64); an f32 gram breaks
//    the fit's Cholesky.
//  * A block computes one kT × kT = 32 × 32 tile (I, J) of one θ row r: grid
//    (tiles, R).  With a study axis, x1 (S, n1, D) and x2 (S, n2, D) hold S
//    studies' points and the R = S · rps θ rows come rps to a study: row r
//    reads study r / rps's points, and nothing else changes, so a study's
//    rows are bitwise those of a solo call on its points.  The plan (kernel.py::gram_plan) gives the tiles: every
//    tile, row-major, or, when x1 and x2 are the same points (every call of
//    the fit), the tiles I ≤ J of the upper triangle, row-major: 153 a θ
//    row at n = 544 (306 blocks at R = 2, over the 132 SMs), where 289 were.
//  * Each block stages its 32 + 32 rows by cp.async, D in pieces of kPiece
//    coordinates, scales them by 1/ℓ with every thread, and carries the
//    |a|², |b|² chains (threads 0–63, a row each) and its a·b chains (warp w
//    owns rows w, w + 8, w + 16, w + 24, lane = column) from piece to piece
//    in k order: any D, the same bits as D staged whole.  The entry is
//    matern.cuh's, so K3's k(x_i, x_j) is the same sequence of roundings as
//    K1's k*.  Both chains are symmetric in (i, j) (fma of a product that
//    commutes, an add that commutes), so an entry has the same bits
//    whichever tile computes it: K3's diagonal is σ_f² exactly (d² = 0),
//    its symmetric path gives the cross path's bits, and the n1 = 1 column
//    gives row i of the full gram.
//  * K3 symmetric: an off-diagonal tile writes its entries at (i, j)
//    coalesced and, through a transposed copy in shared memory, at (j, i),
//    coalesced too.  A diagonal tile computes and writes all its entries.
//  * K4 weights each pair once: gs = Ḡ_ij, plus Ḡ_ji where the tile stands
//    for both orders (i < j in a diagonal tile, every pair off it; Ḡ is
//    never taken as symmetric), both read coalesced (the (J, I) tile by
//    cp.async, then transposed through shared memory).  A pair's terms are
//    c = gs (1 + √5ρ) e^{−√5ρ} (0 on the diagonal, where every difference is
//    0) for 1/ℓ and gs k/σ_f² for σ_f²; both go to shared memory.
//  * K4's sums, in an order fixed by (n1, n2) and the path alone, never by
//    R, D or the grid; no atomics on values:
//      in a tile, a coordinate's 32 row slices s_i = Σ_j c_ij (x1_ik − x2_jk)²
//      (an fma chain over j in order; differences of the unscaled rows,
//      restaged a piece at a time in reverse, so the last staged piece is
//      summed first), then tree32 over the slices (pairs 16, 8, 4, 2, 1
//      apart); the σ_f² sum the same way over Σ_j gs k/σ_f²;
//      over a θ row's tiles (partials laid out (R, D + 1, tiles)): lane l
//      of a warp adds tiles l, l + 32, … in order, then the lanes by the
//      same tree.
//    A reduction thread owns one row slice of kGroup = 4 coordinates: a
//    step loads c_ij once (lanes along rows, odd stride) and x2_j's four
//    coordinates (16-byte broadcast loads) for 12 f64 operations.
//  * The merge over tiles is a second kernel, a warp a (θ row, coordinate),
//    its lanes' loads in flight together and coalesced.  Probed against a
//    merge in the last block of a θ row to finish (one launch, a ticket per
//    θ row), it took less device time at both timed shapes (gram_ab.py as
//    at commit 7e90bdc, which built both).
//  * K4 asks for 4 blocks an SM (__launch_bounds__, 64 registers a thread):
//    probed faster at n = 2048 than 3 blocks at 76 registers, and no slower
//    at the fit's shape.
//  * _FAR pseudo-rows (x ≈ 1e6 + i): d² ~ 1e16 there, and cancellation can put
//    any value ≥ 0 between two of them after the clamp.  Every value stays
//    finite: exp underflows to 0 against a finite polynomial, never inf·0.
//    The masked LML multiplies those entries by 0 and their Ḡ is 0.
//  * a·bᵀ stays on the CUDA cores: the FP64 tensor cores (mma.sync m8n8k4)
//    would change the order of d²'s sum, and the diagonal would no longer
//    be σ_f² exactly.

#include "matern.cuh"

namespace {

constexpr int kT = 32;                     // tile edge
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kT / kWarps;         // tile rows a thread owns (one column)
constexpr int kTS = kT + 1;                // row stride of a tile in shared memory (odd)
constexpr int kPiece = 64;                 // coordinates staged at a time
constexpr int kGroup = 4;                  // coordinates of a K4 row slice
constexpr int kBatch = 8;                  // partials a merge lane loads at once

// row stride of the raw (unscaled) rows: a multiple of kGroup, so that a
// slice's coordinates load as two 16-byte words
__host__ __device__ __forceinline__ int raw_stride(int pw) { return (pw + 3) & ~3; }

// doubles of a block's shared memory, pw = min(D, kPiece):
//   xr [2kT][raw_stride]  raw rows of the piece (x1's tile rows, then x2's)
//   xs [2kT][coord_stride] the same, scaled by 1/ℓ
//   ils [pw], sq [2kT]     the piece's 1/ℓ, the rows' |·|²
//   t0 [kT][kTS]           K3: the transposed tile; K4: Ḡ (I, J), then c
//   t1 [kT][kTS]           K4: Ḡ (J, I), then gs k/σ_f²
//   sl [raw_stride + 1][kTS] K4: row slices (the σ_f² sum's in the last row)
__host__ __device__ __forceinline__ size_t smem_doubles(int pw, bool bwd) {
  return (size_t)2 * kT * (raw_stride(pw) + coord_stride(pw)) + pw + 2 * kT + kT * kTS +
         (bwd ? (size_t)kT * kTS + (size_t)(raw_stride(pw) + 1) * kTS : 0);
}

struct Layout {
  double *xr, *xs, *ils, *sq, *t0, *t1, *sl;
  __device__ Layout(double* smem, int pw) {
    xr = smem;
    xs = xr + 2 * kT * raw_stride(pw);
    ils = xs + 2 * kT * coord_stride(pw);
    sq = ils + pw;
    t0 = sq + 2 * kT;
    t1 = t0 + kT * kTS;
    sl = t1 + kT * kTS;
  }
};

struct GramArgs {
  const double* x1;
  const double* x2;
  const double* inv_ls;
  const double* amp;
  const double* g;                         // K4: Ḡ (R, n1, n2)
  double* out;                             // K3: (R, n1, n2)
  double* part;                            // K4: partials (R, D + 1, tiles)
  double* d_inv;                           // K4: (R, D)
  double* d_amp;                           // K4: (R,)
  int n1, n2, d, tiles, tn2, sym, rps;     // rps: θ rows a study
};

// tile t of a θ row → (I, J): row-major over the tiles, tn2 to a row, or
// over the upper triangle I ≤ J (sym: tn2 to the first row)
__host__ __device__ __forceinline__ void tile_coords(int t, int tn2, int sym, int* I, int* J) {
  if (!sym) {
    *I = t / tn2;
    *J = t - *I * tn2;
    return;
  }
  int i = 0, row = tn2;
  while (t >= row) {
    t -= row;
    ++i;
    --row;
  }
  *I = i;
  *J = i + t;
}

__host__ __device__ __forceinline__ int tile_count(int n1, int n2, int sym) {
  const int tn1 = (n1 + kT - 1) / kT, tn2 = (n2 + kT - 1) / kT;
  return sym ? tn1 * (tn1 + 1) / 2 : tn1 * tn2;
}

// tree over 32 leaves: tree32<S>(leaf, l) sums the leaves ≡ l (mod S), the
// pairs 16 apart first; tree32<1>(leaf, 0) adds what lane 0 of a
// __shfl_down tree (offsets 16, 8, 4, 2, 1) adds
template <int S, typename Leaf>
__device__ __forceinline__ double tree32(const Leaf& leaf, int l) {
  if constexpr (S == 16)
    return __dadd_rn(leaf(l), leaf(l + 16));
  else
    return __dadd_rn(tree32<2 * S>(leaf, l), tree32<2 * S>(leaf, l + S));
}

// the kT × kT tile of a row-major matrix (leading dimension ld) at src into
// dst (row stride kTS), asynchronously, lanes along a row; zeros at rows ≥
// vr or columns ≥ vc.  base: any valid address of the matrix.
__device__ __forceinline__ void stage_g_tile(double* dst, const double* src, int ld, int vr,
                                             int vc, const double* base) {
  const int c = threadIdx.x & (kT - 1);
  for (int rr = threadIdx.x / kT; rr < kT; rr += kThreads / kT) {
    const bool ok = rr < vr && c < vc;
    cp_async8(smem_u32(dst + rr * kTS + c), ok ? src + (size_t)rr * ld + c : base, ok);
  }
}

// K4's sum of coordinate k (k = D: σ_f²) over a θ row's tiles, by one warp,
// and its gradient entry: lane l adds tiles l, l + 32, … in order (kBatch
// loads in flight), then the lanes by the tree pairs 16, 8, 4, 2, 1 apart
__device__ __forceinline__ void merge_coord(const GramArgs& a, int r, int k, int lane) {
  const double* p = a.part + ((size_t)r * (a.d + 1) + k) * a.tiles;
  double s = 0.0;
  for (int t0 = lane; t0 < a.tiles; t0 += 32 * kBatch) {
    double v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = t0 + 32 * u;
      v[u] = t < a.tiles ? p[t] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (t0 + 32 * u < a.tiles) s = __dadd_rn(s, v[u]);
  }
  for (int off = 16; off > 0; off >>= 1) s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (lane == 0) {
    if (k < a.d) {
      const double il = a.inv_ls[(size_t)r * a.d + k];
      a.d_inv[(size_t)r * a.d + k] = __dmul_rn(__dmul_rn(__dmul_rn(-5.0 / 3.0, a.amp[r]), il), s);
    } else {
      a.d_amp[r] = s;
    }
  }
}

template <bool kBwd>
__device__ __forceinline__ void gram_block(const GramArgs& a) {
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, r = blockIdx.y, d = a.d;
  int I, J;
  tile_coords(t, a.tn2, a.sym, &I, &J);
  const int i0 = I * kT, j0 = J * kT;
  const bool mirror = a.sym && I != J;     // the tile stands for (I, J) and (J, I)
  const bool diag = a.sym && I == J;
  const int pw = d < kPiece ? d : kPiece, pr = raw_stride(pw), ps = coord_stride(pw);
  const int npieces = (d + kPiece - 1) / kPiece;
  const Layout L(smem, pw);
  const double* ils_r = a.inv_ls + (size_t)r * d;
  const double* gr = kBwd ? a.g + (size_t)r * a.n1 * a.n2 : nullptr;
  const int st = r / a.rps;                // the study whose points row r reads
  const double* x1 = a.x1 + (size_t)st * a.n1 * d;
  const double* x2 = a.x2 + (size_t)st * a.n2 * d;

  auto stage_raw = [&](int k0, int kw) {
    stage_rows(L.xr, pr, x1 + (size_t)i0 * d + k0, d, kT, a.n1 - i0, kw);
    stage_rows(L.xr + kT * pr, pr, x2 + (size_t)j0 * d + k0, d, kT, a.n2 - j0, kw);
  };

  // |a_i|², |b_j|² (threads < 2kT, a row each) and a_i·b_j: fma chains in k
  // order, carried over the pieces; Ḡ's tiles arrive under the first
  double ab[kRows], nrm = 0.0;
#pragma unroll
  for (int m = 0; m < kRows; ++m) ab[m] = 0.0;
  for (int p = 0; p < npieces; ++p) {
    const int k0 = p * kPiece, kw = d - k0 < kPiece ? d - k0 : kPiece;
    if (p > 0) __syncthreads();            // the last piece is read
    stage_raw(k0, kw);
    for (int k = tid; k < kw; k += kThreads) cp_async8(smem_u32(L.ils + k), ils_r + k0 + k, true);
    cp_async_commit();
    if (kBwd && p == 0) {
      stage_g_tile(L.t0, gr + (size_t)i0 * a.n2 + j0, a.n2, a.n1 - i0, a.n2 - j0, gr);
      if (mirror)
        stage_g_tile(L.t1, gr + (size_t)j0 * a.n2 + i0, a.n2, a.n1 - j0, a.n2 - i0, gr);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scale_into(L.xs, ps, L.xr, pr, 2 * kT, kw, L.ils);
    __syncthreads();
    if (tid < 2 * kT) {
      const double* row = L.xs + tid * ps;
      for (int k = 0; k < kw; ++k) nrm = __fma_rn(row[k], row[k], nrm);
    }
    const double* b = L.xs + (kT + lane) * ps;
    const double* arow = L.xs + warp * ps;
    for (int k = 0; k < kw; ++k) {
      const double bk = b[k];
#pragma unroll
      for (int m = 0; m < kRows; ++m) ab[m] = __fma_rn(arow[m * kWarps * ps + k], bk, ab[m]);
    }
  }
  if (tid < 2 * kT) L.sq[tid] = nrm;
  if (kBwd) cp_async_wait<0>();
  __syncthreads();

  if constexpr (!kBwd) {
    // ---------------------------------------------------------- K3
    const double amp = a.amp[r];
    double* o = a.out + (size_t)r * a.n1 * a.n2;
    const double bsq = L.sq[kT + lane];
    const int col = j0 + lane;
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = warp + m * kWarps;
      if (i0 + i >= a.n1) break;           // a warp's rows past n1 (the n1 = 1 column)
      const double v = matern(L.sq[i], bsq, ab[m], amp);
      if (col < a.n2) o[(size_t)(i0 + i) * a.n2 + col] = v;
      if (mirror) L.t0[i * kTS + lane] = v;
    }
    if (mirror) {                          // (j, i): the tile transposed
      __syncthreads();
      const int col2 = i0 + lane;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        const int jj = warp + m * kWarps;
        if (j0 + jj < a.n1 && col2 < a.n2)
          o[(size_t)(j0 + jj) * a.n2 + col2] = L.t0[lane * kTS + jj];
      }
    }
  } else {
    // ---------------------------------------------------------- K4
    // gs: Ḡ_ij, plus Ḡ_ji where the tile stands for both orders
    double gs[kRows];
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = warp + m * kWarps;
      double v = L.t0[i * kTS + lane];
      if (mirror)
        v = __dadd_rn(v, L.t1[lane * kTS + i]);
      else if (diag)
        v = i < lane ? __dadd_rn(v, L.t0[lane * kTS + i]) : (i == lane ? v : 0.0);
      gs[m] = v;
    }
    __syncthreads();                       // t0, t1 now take the pairs' terms
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const int i = warp + m * kWarps;
      const double d2 = sq_dist(L.sq[i], L.sq[kT + lane], ab[m]);
      const double rr = __dsqrt_rn(__dadd_rn(d2, 1e-36));
      const double e = exp(__dmul_rn(-kSqrt5, rr));
      const double q1 = __fma_rn(kSqrt5, rr, 1.0);
      L.t0[i * kTS + lane] = diag && i == lane ? 0.0 : __dmul_rn(gs[m], __dmul_rn(q1, e));
      L.t1[i * kTS + lane] = __dmul_rn(gs[m], __dmul_rn(__fma_rn(5.0 / 3.0, d2, q1), e));
    }
    __syncthreads();

    // the tile's partials, the pieces from the last (still staged) to the
    // first; the σ_f² sum with the first
    double* part = a.part + (size_t)r * (d + 1) * a.tiles + t;
    for (int p = npieces - 1; p >= 0; --p) {
      const int k0 = p * kPiece, kw = d - k0 < kPiece ? d - k0 : kPiece;
      if (p < npieces - 1) {
        __syncthreads();                   // the slices of the last piece are read
        stage_raw(k0, kw);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int groups = (kw + kGroup - 1) / kGroup;
      const int items = (groups + (p == 0 ? 1 : 0)) * kT;
      for (int e = tid; e < items; e += kThreads) {
        const int gi = e / kT, i = e - gi * kT;
        if (gi < groups) {                 // row i's slice of coordinates kb … kb + 3
          const int kb = gi * kGroup;
          const double2 xa = *reinterpret_cast<const double2*>(L.xr + i * pr + kb);
          const double2 xb = *reinterpret_cast<const double2*>(L.xr + i * pr + kb + 2);
          const double* c = L.t0 + i * kTS;
          const double* y = L.xr + kT * pr + kb;
          double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll 4
          for (int j = 0; j < kT; ++j) {
            const double cij = c[j];
            const double2 ya = *reinterpret_cast<const double2*>(y + j * pr);
            const double2 yb = *reinterpret_cast<const double2*>(y + j * pr + 2);
            double df = __dsub_rn(xa.x, ya.x);
            s0 = __fma_rn(cij, __dmul_rn(df, df), s0);
            df = __dsub_rn(xa.y, ya.y);
            s1 = __fma_rn(cij, __dmul_rn(df, df), s1);
            df = __dsub_rn(xb.x, yb.x);
            s2 = __fma_rn(cij, __dmul_rn(df, df), s2);
            df = __dsub_rn(xb.y, yb.y);
            s3 = __fma_rn(cij, __dmul_rn(df, df), s3);
          }
          double* sl = L.sl + kb * kTS + i;  // past kw: unused rows
          sl[0] = s0;
          sl[kTS] = s1;
          sl[2 * kTS] = s2;
          sl[3 * kTS] = s3;
        } else {                           // row i's σ_f² slice
          const double* kt = L.t1 + i * kTS;
          double s = 0.0;
          for (int j = 0; j < kT; ++j) s = __dadd_rn(s, kt[j]);
          L.sl[pr * kTS + i] = s;
        }
      }
      __syncthreads();
      for (int k = tid; k < kw + (p == 0 ? 1 : 0); k += kThreads) {
        const double* sl = L.sl + (k < kw ? k : pr) * kTS;
        part[(size_t)(k < kw ? k0 + k : d) * a.tiles] =
            tree32<1>([&](int l) { return sl[l]; }, 0);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) gram_fwd_kernel(const GramArgs a) {
  gram_block<false>(a);
}

__global__ void __launch_bounds__(kThreads, 4) gram_bwd_kernel(const GramArgs a) {
  gram_block<true>(a);
}

// grid (ceil((D + 1) / kWarps), R), a warp a coordinate
__global__ void __launch_bounds__(kThreads) gram_bwd_merge_kernel(const GramArgs a) {
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k <= a.d) merge_coord(a, blockIdx.y, k, threadIdx.x & 31);
}

// GramArgs from the C entries' arguments; false if they do not hold
// together (the plan's tile count included)
bool make_args(GramArgs* a, int r, int n1, int n2, int d, int tiles, int sym, int studies) {
  if (r < 1 || r > 65535 || n1 < 1 || n2 < 1 || d < 1 || (sym && n1 != n2)) return false;
  if (studies < 1 || r % studies != 0) return false;
  a->rps = r / studies;
  if (tiles != tile_count(n1, n2, sym)) return false;
  a->n1 = n1;
  a->n2 = n2;
  a->d = d;
  a->tiles = tiles;
  a->tn2 = (n2 + kT - 1) / kT;
  a->sym = sym ? 1 : 0;
  return true;
}

cudaError_t launch_tiles(const void* kernel, const GramArgs& a, int r, bool bwd,
                         cudaStream_t s) {
  const int pw = a.d < kPiece ? a.d : kPiece;
  const size_t smem = sizeof(double) * smem_doubles(pw, bwd);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<GramArgs*>(&a)};
  return cudaLaunchKernel(kernel, dim3(a.tiles, r), dim3(kThreads), args, smem, s);
}

}  // namespace

extern "C" {

// Each returns a cudaError_t (0 on success).  tiles is gram_plan's tile
// count for (n1, n2, symmetric); symmetric = 1 only where x1 and x2 are the
// same points (n1 = n2), and then only the tiles I ≤ J run.  x1 and x2 hold
// `studies` studies' points one after another; the r θ rows (and out, g,
// d_inv_ls, d_amp) come r / studies to a study.

int matern52_gram_fwd(const double* x1, const double* x2, const double* inv_ls,
                      const double* amp, double* out, int r, int n1, int n2, int d, int tiles,
                      int symmetric, int studies, void* stream) {
  GramArgs a{};
  if (!make_args(&a, r, n1, n2, d, tiles, symmetric, studies))
    return (int)cudaErrorInvalidValue;
  a.x1 = x1;
  a.x2 = x2;
  a.inv_ls = inv_ls;
  a.amp = amp;
  a.out = out;
  return (int)launch_tiles((const void*)gram_fwd_kernel, a, r, false, (cudaStream_t)stream);
}

// part holds r·(d + 1)·tiles doubles.  Two launches: the tiles' partials,
// then their merge.
int matern52_gram_bwd_theta(const double* x1, const double* x2, const double* inv_ls,
                            const double* amp, const double* g, double* part, double* d_inv_ls,
                            double* d_amp, int r, int n1, int n2, int d, int tiles,
                            int symmetric, int studies, void* stream) {
  GramArgs a{};
  if (!make_args(&a, r, n1, n2, d, tiles, symmetric, studies) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  a.x1 = x1;
  a.x2 = x2;
  a.inv_ls = inv_ls;
  a.amp = amp;
  a.g = g;
  a.part = part;
  a.d_inv = d_inv_ls;
  a.d_amp = d_amp;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_tiles((const void*)gram_bwd_kernel, a, r, true, s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  return (int)cudaLaunchKernel((const void*)gram_bwd_merge_kernel,
                               dim3((d + 1 + kWarps - 1) / kWarps, r), dim3(kThreads), args,
                               0, s);
}

}  // extern "C"
