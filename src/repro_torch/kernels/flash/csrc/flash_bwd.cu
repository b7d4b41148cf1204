// Flash attention backward for Hopper (sm_90a): K7 flash_attention_bwd.
//
// Replaces no TPU kernel.  The JAX package trains through attention_xla
// (src/repro/models/layers.py:147) and XLA's autodiff; the Pallas kernel
// K6 replaces (src/repro/kernels/flash/kernel.py::flash_attention) has no
// backward.  The port runs every attention of the LM and of whisper on K6
// (flash.cu), so its training step needs this op's gradient; a backward
// through the plain version would put it on the main path and keep
// B·NH·Sq·Sk float32 probabilities per layer for autograd.
//
// Inputs, as K6's: q (B, Sq, NH, hd), k/v (B, Sk, KH, hd) in float32 or
// bfloat16, q_pos (B, Sq) and kv_pos (B, Sk) int32 with K6's masking rule
// (key j seen by query i when kv_pos >= 0, kv_pos <= q_pos if causal,
// kv_pos > q_pos - w with a window w), K6's output o and its lse (B, NH,
// Sq) float32 (flash.cu writes it when asked; +inf for a row that sees no
// key), and the output's gradient dO (B, Sq, NH, hd).  Outputs dQ (B, Sq,
// NH, hd) and dK, dV (B, Sk, KH, hd) in the input type, dK and dV summed
// over each KV head's G = NH / KH query heads.  With P = exp(S·scale - lse)
// on the visible entries (0 elsewhere), D_i = Σ_d dO_id·O_id and
// dS = P∘(dO·Vᵀ - D):
//   dV = Pᵀ·dO,  dK = scale·dSᵀ·Q,  dQ = scale·dS·K.
// A row with no visible key has P = 0 and so exactly 0 gradient.
//
// Two paths; the wrapper's bwd_plan() (kernel.py) picks one from (dtype,
// Sq, NH, KH, hd, Sk) alone and passes it in: MMA for bf16 at hd 64 and
// 128 (the LM's training, whisper), FMA for everything else (float32, hd
// 32, recurrentgemma's hd 256).  Each is three launches, with no atomics
// and every sum in a fixed order, so the result is bitwise the same from
// run to run (a resumed training run needs that).  The two paths need not
// agree bit for bit; each is held to the plain version.
//  * flash_bwd_dot_kernel (both paths): D, one warp a row, float32.
//
// FMA path:
//  * flash_bwd_dkdv_kernel: a block per (batch row, KV head, tile of BT
//    keys) holds its K and V tile in shared memory and walks, in order,
//    the query tiles some of whose rows see a key of it (a block-wide vote
//    over the positions) and, for each, the G query heads in order:
//    recompute S and dO·Vᵀ for the BT × BT tile, P and dS, then
//    dV += Pᵀ·dO and dK += dSᵀ·Q in float32 registers.
//  * flash_bwd_dq_kernel: a block per (batch row, query head, tile of BT
//    queries) walks the visible key tiles in order: S, dO·Vᵀ, dS, then
//    dQ += dS·K.
// BT = 64 keys and queries (32 at hd 256, so the accumulators fit the
// registers).  256 threads: thread (tx, ty) = (tid % 16, tid / 16) owns
// entries (tx + 16r, ty + 16c) of a tile's S and dP, and accumulator
// entries (tx + 16c, ty + 16e) of dK/dV (keys × dims) or dQ (queries ×
// dims).  Q, dO, K and V sit in shared memory transposed ([hd][BT + 1],
// float32) and P, dS as [BT][BT + 1]: the padding puts the addresses a
// warp reads at one time on different banks.  Every product is float32
// FMAs from shared memory, so the CUDA cores bound it (~2 ms at the
// training shape).
//
// MMA path (wgmma, one warpgroup a block, 64-row tiles in the 128-byte
// swizzle that wgmma reads, filled by cp.async; the helpers are K6's, in
// wgmma.cuh).  At the training shape (B=4, S=512, NH=24, KH=8, hd=128,
// causal) the op needs ~16 GFLOP on ~67 MB: 16 µs on the tensor cores, 20
// µs of bytes.  This design recomputes S and dP in both passes and runs
// dV, dK and dQ twice (hi and lo, below), ~10 product units where the op
// needs 5, so its own floor is ~33 µs.
//  * flash_bwd_dkdv_mma_kernel: a block owns (batch row, KV head, 64
//    keys); its K and V tiles stay in shared memory and are wgmma's A
//    operand from there (registers hold the accumulators).  It votes which
//    query tiles may see a key of it (tiles that every pair sees take no
//    mask) and walks them in order, and in each the G query heads in
//    order; Q, dO, lse, D and the positions of the next item stream in by
//    cp.async through a two-stage ring while this one is computed.  An
//    item: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys on M; Q and dO K-major B),
//    Pᵀ = 2^(Sᵀ·c − lse·log2 e) with c = scale·log2 e where seen (0
//    elsewhere), dSᵀ = Pᵀ∘(dPᵀ − D), then dV += Pᵀ·dO and dK += dSᵀ·Q with
//    Pᵀ and dSᵀ as register A fragments and dO and Q as MN-major B (the
//    same tiles).  Blocks start with the low key tiles, which causal
//    queries see most.
//  * flash_bwd_dq_mma_kernel: a block owns (batch row, query head, 64
//    queries), its Q and dO tiles in shared memory as A operands; it walks
//    the visible key tiles (K6's vote) in order, K, V and their positions
//    through the ring: S = Q·Kᵀ, dP = dO·Vᵀ, dS, dQ += dS·K (K MN-major).
//    Blocks start with the last query tiles.
//  * Precision: P and dS are float32 and the inputs bf16.  A product of
//    bf16 inputs accumulates exactly in float32; P and dS rounded once to
//    bf16 would err by 2⁻⁹ an entry, ~10× K7's limit (1e-4 of a gradient's
//    largest entry plus one bf16 rounding), so each is split into bf16 hi
//    + lo (K6's treatment of P) and both go through the product.
//  * Padded rows: Q and dO rows past Sq are zero-filled and their lse is
//    +inf, keys past Sk carry position -1, so either gives P = dS = 0; a
//    tile no pair sees is never visited, so a key no query sees gets an
//    exact 0.  dK is scaled at the store.
//  * Registers and shared memory (nvcc 12.9 -Xptxas -v, sm_90a; no spills):
//    dK/dV kernel 254 registers at hd 128, 206 at hd 64; dQ kernel 168 and
//    152.  Shared memory MmaTile::bytes(tiles): 101,636 + 8·tiles bytes at
//    hd 128 (99.3 KB at S = 512), 52,484 + 8·tiles at hd 64, so two blocks
//    share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// grid ceil(B·Sq·NH / 8), kThreads threads: D[(b·NH + h)·Sq + i]
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dsum, int rows, int sq, int nh, int hd) {
  const int r = (int)((blockIdx.x * (size_t)kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;                 // uniform across the warp
  const T* orow = o + (size_t)r * hd;
  const T* grow = dout + (size_t)r * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(Cvt<T>::in(orow[d]), Cvt<T>::in(grow[d]), s);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = r % nh, i = (r / nh) % sq, b = r / (nh * sq);
    dsum[((size_t)b * nh + h) * sq + i] = s;
  }
}

template <int HD>
struct Tile {
  static constexpr int kBT = HD == 256 ? 32 : 64;  // keys / queries a tile
  static constexpr int kLd = kBT + 1;              // padded row of a [HD][BT] array
  static constexpr int kMT = kBT / 16;             // S entries a thread: kMT × kMT
  static constexpr int kHE = HD / 16;              // accumulator dims a thread
  // floats: qT, doT, kT, vT [HD][kLd]; P, dS [kBT][kLd]; lse, D; then the
  // int positions qp, kp [kBT]
  static constexpr int kArr = HD * kLd;
  static constexpr int kSq = kBT * kLd;
  static constexpr size_t kBytes =
      4 * ((size_t)4 * kArr + 2 * kSq + 2 * kBT) + 4 * 2 * kBT;
};

// rows [r0, r0 + BT) of x (rows of `stride` elements, the head's hd at
// `col`) into xT[d][r] as float32; rows past n are 0
template <typename T, int HD>
__device__ __forceinline__ void load_t(float* xT, const T* x, size_t row0_off,
                                       size_t stride, int n) {
  using Tl = Tile<HD>;
  for (int idx = threadIdx.x; idx < Tl::kBT * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    xT[d * Tl::kLd + r] = r < n ? Cvt<T>::in(x[row0_off + (size_t)r * stride + d]) : 0.f;
  }
}

// S = Q·Kᵀ and dP = dO·Vᵀ for the thread's entries (i = tx + 16r, j = ty +
// 16c), then P and dS into shared memory (P only where ps != nullptr)
template <int HD>
__device__ __forceinline__ void scores(const float* qT, const float* doT,
                                       const float* kT, const float* vT,
                                       const float* lse_s, const float* d_s,
                                       const int* qp_s, const int* kp_s, int nq,
                                       int nk, int causal, int window, float scale,
                                       float* ps, float* dss) {
  using Tl = Tile<HD>;
  constexpr int MT = Tl::kMT, LD = Tl::kLd;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[MT][MT], dp[MT][MT];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < MT; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[MT], gv[MT], kv[MT], vv[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      qv[r] = qT[d * LD + tx + 16 * r];
      gv[r] = doT[d * LD + tx + 16 * r];
      kv[r] = kT[d * LD + ty + 16 * r];
      vv[r] = vT[d * LD + ty + 16 * r];
    }
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < MT; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(gv[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    const int i = tx + 16 * r;
#pragma unroll
    for (int c = 0; c < MT; ++c) {
      const int j = ty + 16 * c;
      const bool ok = i < nq && j < nk && visible(kp_s[j], qp_s[i], causal, window);
      const float p = ok ? expf(__fsub_rn(__fmul_rn(s[r][c], scale), lse_s[i])) : 0.f;
      if (ps != nullptr) ps[i * LD + j] = p;
      dss[i * LD + j] = __fmul_rn(p, __fsub_rn(dp[r][c], d_s[i]));
    }
  }
}

// Whether any (query of qp_s[0..nq), key of kp_s[0..nk)) pair is visible;
// every thread of the block gets the answer
template <int HD>
__device__ __forceinline__ bool any_visible(const int* qp_s, const int* kp_s, int nq,
                                            int nk, int causal, int window) {
  using Tl = Tile<HD>;
  int any = 0;
  for (int e = threadIdx.x; e < Tl::kBT * Tl::kBT && !any; e += kThreads) {
    const int i = e / Tl::kBT, j = e % Tl::kBT;
    any = i < nq && j < nk && visible(kp_s[j], qp_s[i], causal, window);
  }
  return __syncthreads_or(any) != 0;
}

// acc[c][e] (entry row tx + 16c, dim ty + 16e), times `mul`, into rows
// [0, n) of y (row r at y + r·stride), through shared memory `buf`
// ([kBT][HD + 1] floats) so the global writes are coalesced
template <typename T, int HD>
__device__ __forceinline__ void store_rows(float* buf, const float (&acc)[Tile<HD>::kMT][Tile<HD>::kHE],
                                           float mul, T* y, size_t stride, int n) {
  using Tl = Tile<HD>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int c = 0; c < Tl::kMT; ++c)
#pragma unroll
    for (int e = 0; e < Tl::kHE; ++e)
      buf[(tx + 16 * c) * (HD + 1) + ty + 16 * e] = __fmul_rn(acc[c][e], mul);
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    y[(size_t)r * stride + d] = Cvt<T>::out(buf[r * (HD + 1) + d]);
  }
  __syncthreads();
}

// grid (ceil(Sk / BT), B·KH), kThreads threads
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int nh,
                      int kh, int causal, int window, float scale) {
  using Tl = Tile<HD>;
  constexpr int BT = Tl::kBT, MT = Tl::kMT, HE = Tl::kHE, LD = Tl::kLd;
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;
  float* doT = qT + Tl::kArr;
  float* kT = doT + Tl::kArr;
  float* vT = kT + Tl::kArr;
  float* ps = vT + Tl::kArr;
  float* dss = ps + Tl::kSq;
  float* lse_s = dss + Tl::kSq;
  float* d_s = lse_s + BT;
  int* qp_s = reinterpret_cast<int*>(d_s + BT);
  int* kp_s = qp_s + BT;

  const int g = nh / kh;
  const int key0 = blockIdx.x * BT, nk = min(BT, sk - key0);
  const int bk = blockIdx.y, b = bk / kh, kvh = bk % kh;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kstride = (size_t)kh * HD, qstride = (size_t)nh * HD;

  load_t<T, HD>(kT, k, ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD, kstride, nk);
  load_t<T, HD>(vT, v, ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD, kstride, nk);
  if (threadIdx.x < BT) kp_s[threadIdx.x] = threadIdx.x < nk ? kv_pos[(size_t)b * sk + key0 + threadIdx.x] : -1;

  float acc_k[MT][HE], acc_v[MT][HE];
#pragma unroll
  for (int c = 0; c < MT; ++c)
#pragma unroll
    for (int e = 0; e < HE; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BT) {
    const int nq = min(BT, sq - q0);
    __syncthreads();                     // the last tile's qp_s is read
    if (threadIdx.x < BT) qp_s[threadIdx.x] = threadIdx.x < nq ? q_pos[(size_t)b * sq + q0 + threadIdx.x] : 0;
    __syncthreads();
    if (!any_visible<HD>(qp_s, kp_s, nq, nk, causal, window)) continue;
    for (int gh = 0; gh < g; ++gh) {
      const int h = kvh * g + gh;
      const size_t off = ((size_t)b * sq + q0) * qstride + (size_t)h * HD;
      load_t<T, HD>(qT, q, off, qstride, nq);
      load_t<T, HD>(doT, dout, off, qstride, nq);
      if (threadIdx.x < BT) {
        const size_t row = ((size_t)b * nh + h) * sq + q0 + threadIdx.x;
        lse_s[threadIdx.x] = threadIdx.x < nq ? lse[row] : 0.f;
        d_s[threadIdx.x] = threadIdx.x < nq ? dsum[row] : 0.f;
      }
      __syncthreads();
      scores<HD>(qT, doT, kT, vT, lse_s, d_s, qp_s, kp_s, nq, nk, causal, window,
                 scale, ps, dss);
      __syncthreads();
      // dV += Pᵀ·dO, dK += dSᵀ·Q over the tile's queries in order
#pragma unroll 2
      for (int i = 0; i < BT; ++i) {
        float pv[MT], dsv[MT], gv[HE], qv[HE];
#pragma unroll
        for (int c = 0; c < MT; ++c) {
          pv[c] = ps[i * LD + tx + 16 * c];
          dsv[c] = dss[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int e = 0; e < HE; ++e) {
          gv[e] = doT[(ty + 16 * e) * LD + i];
          qv[e] = qT[(ty + 16 * e) * LD + i];
        }
#pragma unroll
        for (int c = 0; c < MT; ++c)
#pragma unroll
          for (int e = 0; e < HE; ++e) {
            acc_v[c][e] = fmaf(pv[c], gv[e], acc_v[c][e]);
            acc_k[c][e] = fmaf(dsv[c], qv[e], acc_k[c][e]);
          }
      }
      __syncthreads();                   // qT, doT, P, dS are read
    }
  }
  __syncthreads();
  // the Q/dO/K/V arrays (4·HD·(BT + 1) floats) hold [BT][HD + 1] twice
  const size_t out0 = ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD;
  store_rows<T, HD>(sm, acc_k, scale, dk + out0, kstride, nk);
  store_rows<T, HD>(sm, acc_v, 1.f, dv + out0, kstride, nk);
}

// grid (ceil(Sq / BT), B·NH), kThreads threads
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                    T* __restrict__ dq, int sq, int sk, int nh, int kh, int causal,
                    int window, float scale) {
  using Tl = Tile<HD>;
  constexpr int BT = Tl::kBT, MT = Tl::kMT, HE = Tl::kHE, LD = Tl::kLd;
  extern __shared__ __align__(16) float sm[];
  float* qT = sm;
  float* doT = qT + Tl::kArr;
  float* kT = doT + Tl::kArr;
  float* vT = kT + Tl::kArr;
  float* dss = vT + Tl::kArr + Tl::kSq;  // P's place is unused here
  float* lse_s = dss + Tl::kSq;
  float* d_s = lse_s + BT;
  int* qp_s = reinterpret_cast<int*>(d_s + BT);
  int* kp_s = qp_s + BT;

  const int g = nh / kh;
  const int q0 = blockIdx.x * BT, nq = min(BT, sq - q0);
  const int bh = blockIdx.y, b = bh / nh, h = bh % nh, kvh = h / g;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kstride = (size_t)kh * HD, qstride = (size_t)nh * HD;
  const size_t off = ((size_t)b * sq + q0) * qstride + (size_t)h * HD;

  load_t<T, HD>(qT, q, off, qstride, nq);
  load_t<T, HD>(doT, dout, off, qstride, nq);
  if (threadIdx.x < BT) {
    const size_t row = ((size_t)b * nh + h) * sq + q0 + threadIdx.x;
    const bool live = threadIdx.x < nq;
    lse_s[threadIdx.x] = live ? lse[row] : 0.f;
    d_s[threadIdx.x] = live ? dsum[row] : 0.f;
    qp_s[threadIdx.x] = live ? q_pos[(size_t)b * sq + q0 + threadIdx.x] : 0;
  }

  float acc[MT][HE];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int e = 0; e < HE; ++e) acc[r][e] = 0.f;

  for (int key0 = 0; key0 < sk; key0 += BT) {
    const int nk = min(BT, sk - key0);
    __syncthreads();                     // the last tile's kp_s is read
    if (threadIdx.x < BT) kp_s[threadIdx.x] = threadIdx.x < nk ? kv_pos[(size_t)b * sk + key0 + threadIdx.x] : -1;
    __syncthreads();
    if (!any_visible<HD>(qp_s, kp_s, nq, nk, causal, window)) continue;
    load_t<T, HD>(kT, k, ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD, kstride, nk);
    load_t<T, HD>(vT, v, ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD, kstride, nk);
    __syncthreads();
    scores<HD>(qT, doT, kT, vT, lse_s, d_s, qp_s, kp_s, nq, nk, causal, window,
               scale, nullptr, dss);
    __syncthreads();
    // dQ += dS·K over the tile's keys in order
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float dsv[MT], kv[HE];
#pragma unroll
      for (int r = 0; r < MT; ++r) dsv[r] = dss[(tx + 16 * r) * LD + j];
#pragma unroll
      for (int e = 0; e < HE; ++e) kv[e] = kT[(ty + 16 * e) * LD + j];
#pragma unroll
      for (int r = 0; r < MT; ++r)
#pragma unroll
        for (int e = 0; e < HE; ++e) acc[r][e] = fmaf(dsv[r], kv[e], acc[r][e]);
    }
  }
  __syncthreads();
  store_rows<T, HD>(sm, acc, scale, dq + off, qstride, nq);
}

// -------------------------------------------------------------- MMA path
constexpr int kMmaThreads = 128;           // one warpgroup
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaTile = 64;               // keys or queries a tile: a wgmma M or N
constexpr int kMmaStages = 2;
constexpr int kMmaBlocksPerSM = 2;         // ~100 KB of shared memory a block at hd 128
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct MmaTile {
  // a tile of 64 rows (keys or queries) × HD dims in bf16: HD / 64 column
  // blocks of [64 rows][64 dims], each row 128 bytes with its 16-byte
  // chunks swizzled (chunk c of row r at c ^ (r % 8)), the layout of
  // wgmma's 128-byte swizzle.  wgmma reads one tile K-major (dims on K) or
  // MN-major (rows on K), so Q, dO, K and V each need one copy.
  static constexpr int kBlockBytes = kMmaTile * 128;
  static constexpr int kTileBytes = (HD / 64) * kBlockBytes;
  static constexpr int kPairBytes = 2 * kTileBytes;
  static constexpr int kSteps = HD / 16;   // k16 steps of a product over hd
  static constexpr int kHalves = HD / 64;  // n64 products of an output over hd
  // A row set: 64 rows' lse, D (floats) and positions (ints), 3·64 words.
  static constexpr int kSetWords = 3 * kMmaTile;
  // alignment slack, the block's own pair of tiles, a ring of kMmaStages
  // pairs; a row set for each stage and one of the block's own; the tile
  // flags and list, their count
  static size_t bytes(int ntiles) {
    return kSwizzleBytes + (size_t)(1 + kMmaStages) * kPairBytes +
           4 * ((size_t)(kMmaStages + 1) * kSetWords + 2 * ntiles + 1);
  }
};

// Rows [0, 64) of a bf16 array (row r at src + r·stride, HD dims) into the
// swizzled tile at shared address dst by cp.async; rows >= n are zero.
// A thread copies chunk ch of rows r0, r0 + kStep, ...: kStep is a multiple
// of 8, so its swizzled column is fixed.
template <int HD>
__device__ __forceinline__ void tile_async(uint32_t dst, const __nv_bfloat16* src,
                                           size_t stride, int n) {
  constexpr int kChunks = HD / 8, kStep = kMmaThreads / kChunks;
  const int ch = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
  const uint32_t d0 = dst + (ch >> 3) * MmaTile<HD>::kBlockBytes + r0 * 128 +
                      (((ch & 7) ^ (r0 & 7)) << 4);
#pragma unroll
  for (int it = 0; it < kMmaTile / kStep; ++it) {
    const int r = r0 + it * kStep;
    const bool valid = r < n;
    cp_async16(d0 + it * kStep * 128, src + (valid ? (size_t)r * stride + ch * 8 : 0),
               valid);
  }
}

// A row set of 64 queries (row r's lse at lse[r], D at dsum[r], position
// at pos[r]) at f by cp.async; rows >= n get lse +inf, D 0 and position 0,
// so their P and dS are 0 whatever the mask says
__device__ __forceinline__ void rows_async(float* f, const float* lse, const float* dsum,
                                           const int* pos, int n) {
  const int r = threadIdx.x;
  if (r >= kMmaTile) return;
  int* p = reinterpret_cast<int*>(f + 2 * kMmaTile);
  if (r < n) {
    cp_async4(smem_u32(f + r), lse + r, true);
    cp_async4(smem_u32(f + kMmaTile + r), dsum + r, true);
    cp_async4(smem_u32(p + r), pos + r, true);
  } else {
    f[r] = __int_as_float(0x7f800000);
    f[kMmaTile + r] = 0.f;
    p[r] = 0;
  }
}

// The positions of 64 keys (pos[r]) into p by cp.async; keys >= n get -1
__device__ __forceinline__ void keys_async(int* p, const int* pos, int n) {
  const int r = threadIdx.x;
  if (r >= kMmaTile) return;
  if (r < n) cp_async4(smem_u32(p + r), pos + r, true);
  else p[r] = -1;
}

// (x, y) as bf16 pairs hi and lo with x = hi.x + lo.x to ~2⁻¹⁷ relative,
// each packed as one A-fragment register (x in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A 64 × 64 product over hd from two K-major tiles in shared memory: step
// kk reads dims 16kk.. of every row of both
template <int HD>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < MmaTile<HD>::kSteps; ++kk) {
    const uint32_t o = (kk >> 2) * MmaTile<HD>::kBlockBytes + (kk & 3) * 32;
    wgmma_64x64x16_ss(d, wgmma_desc(a + o, 16, kSwizzleBytes),
                      wgmma_desc(b + o, 16, kSwizzleBytes), kk > 0);
  }
}

// The MN-major descriptor of rows 16kk.. and dims 64h.. of a tile
template <int HD>
__device__ __forceinline__ uint64_t mn_desc(uint32_t tile, int h, int kk) {
  return wgmma_desc(tile + h * MmaTile<HD>::kBlockBytes + kk * 16 * 128,
                    MmaTile<HD>::kBlockBytes, kSwizzleBytes);
}

// grid (B·KH, ceil(Sk / 64)), kMmaThreads threads, bf16.  The key tile is
// blockIdx.y, so the low tiles, which causal queries see most, start first.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSM)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int sq, int sk, int nh, int kh, int causal, int window,
                          float scale) {
  using Tl = MmaTile<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is on shared-memory address bits, so align the tiles there
  unsigned char* own = smem_raw + ((kSwizzleBytes - smem_u32(smem_raw) % kSwizzleBytes)
                                   % kSwizzleBytes);             // K | V
  unsigned char* ring = own + Tl::kPairBytes;                    // [stage] Q | dO
  float* sets = reinterpret_cast<float*>(ring + kMmaStages * Tl::kPairBytes);
  int* kps = reinterpret_cast<int*>(sets + kMmaStages * Tl::kSetWords);  // [64]
  const int ntiles = (sq + kMmaTile - 1) / kMmaTile;
  int* flags = reinterpret_cast<int*>(sets + (kMmaStages + 1) * Tl::kSetWords);
  int* list = flags + ntiles;
  int* nvis_s = list + ntiles;

  const int g = nh / kh;
  const int bk = blockIdx.x, b = bk / kh, kvh = bk % kh;
  const int key0 = blockIdx.y * kMmaTile, nk = min(kMmaTile, sk - key0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const float c = __fmul_rn(scale, kLog2e);
  const size_t kstride = (size_t)kh * HD, qstride = (size_t)nh * HD;

  // the block's K and V tiles: one commit group, waited for with item 0's
  const size_t koff = ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD;
  tile_async<HD>(smem_u32(own), k + koff, kstride, nk);
  tile_async<HD>(smem_u32(own + Tl::kTileBytes), v + koff, kstride, nk);
  cp_async_commit();
  if (tid < kMmaTile) kps[tid] = tid < nk ? kv_pos[(size_t)b * sk + key0 + tid] : -1;
  __syncthreads();

  // the live keys' position range [klo, khi] and whether all 64 are live,
  // found by every warp alone
  int klo = 0x7fffffff, khi = -0x7fffffff - 1;
  bool full = true;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int kp = kps[32 * u + lane];
    if (kp >= 0) {
      klo = min(klo, kp);
      khi = max(khi, kp);
    }
    full = full && kp >= 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    klo = min(klo, __shfl_xor_sync(kFull, klo, off));
    khi = max(khi, __shfl_xor_sync(kFull, khi, off));
  }
  full = __all_sync(kFull, full);
  // flags[t]: 0 no pair of query tile t and this key tile is visible, 1
  // some may be, 3 every pair is (no mask needed).  A query may see a key
  // of [klo, khi] only if it sees klo under the causal test and khi under
  // the window's; it sees every key if it sees khi and klo so.
  for (int t = warp; t < ntiles; t += kMmaWarps) {
    bool any = false, all = full;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = t * kMmaTile + 32 * u + lane;
      const bool live = row < sq;
      const int qp = live ? q_pos[(size_t)b * sq + row] : 0;
      any = any || (live && klo <= khi && visible(klo, qp, causal, kNoWindow) &&
                    visible(khi, qp, 0, window));
      all = all && live && visible(khi, qp, causal, kNoWindow) &&
            visible(klo, qp, 0, window);
    }
    any = __any_sync(kFull, any);
    all = __all_sync(kFull, all);
    if (lane == 0) flags[t] = any ? (all ? 3 : 1) : 0;
  }
  __syncthreads();
  compact(flags, ntiles, list, nvis_s);
  __syncthreads();
  // item i: visible query tile list[i / G], group head i % G
  const int nitems = *nvis_s * g;

  // this thread's two keys: accumulator rows gid and gid + 8 of its warp's 16
  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = kps[warp * 16 + gid + 8 * i];

  // item i's Q and dO tiles and row set into stage i % kMmaStages; always
  // one commit group
  auto issue = [&](int i) {
    if (i < nitems) {
      const int q0 = list[i / g] * kMmaTile, h = kvh * g + i % g;
      const int nq = min(kMmaTile, sq - q0), stage = i % kMmaStages;
      const size_t off = ((size_t)b * sq + q0) * qstride + (size_t)h * HD;
      const uint32_t dst = smem_u32(ring + stage * Tl::kPairBytes);
      tile_async<HD>(dst, q + off, qstride, nq);
      tile_async<HD>(dst + Tl::kTileBytes, dout + off, qstride, nq);
      const size_t row = ((size_t)b * nh + h) * sq + q0;
      rows_async(sets + stage * Tl::kSetWords, lse + row, dsum + row,
                 q_pos + (size_t)b * sq + q0, nq);
    }
    cp_async_commit();
  };

  float acc_k[Tl::kHalves][32], acc_v[Tl::kHalves][32];
#pragma unroll
  for (int h = 0; h < Tl::kHalves; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc_k[h][e] = acc_v[h][e] = 0.f;

  issue(0);
  const uint32_t kb = smem_u32(own), vb = kb + Tl::kTileBytes;
  for (int i = 0; i < nitems; ++i) {
    cp_async_wait<0>();                  // item i has landed (this thread's part)
    fence_async_smem();
    __syncthreads();                     // ... everyone's; stage i - 1 is free
    issue(i + 1);
    const int t = list[i / g], q0 = t * kMmaTile, stage = i % kMmaStages;
    const bool every = flags[t] == 3;
    const uint32_t qb = smem_u32(ring + stage * Tl::kPairBytes), gb = qb + Tl::kTileBytes;
    const float* lse_s = sets + stage * Tl::kSetWords;
    const float* d_s = lse_s + kMmaTile;
    const int* qp_s = reinterpret_cast<const int*>(d_s + kMmaTile);

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys on M, queries on N)
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
    product_ss<HD>(s, kb, qb);
    product_ss<HD>(dp, vb, gb);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // s[4j + 2i + c]: key gid + 8i of the warp's 16, query 8j + 2tq + c of
    // the tile.  Pᵀ = 2^(Sᵀ·c − lse·log2 e) = exp(Sᵀ·scale − lse) where
    // seen, dSᵀ = Pᵀ∘(dPᵀ − D)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int col = 8 * j + 2 * tq + cc;
        const float nl = -__fmul_rn(lse_s[col], kLog2e), dd = d_s[col];
        const int qp = qp_s[col];
        const bool live = q0 + col < sq;
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * j + 2 * ii + cc;
          const bool ok = every || (live && visible(kpos[ii], qp, causal, window));
          const float p = ok ? exp2_approx(__fmaf_rn(s[e], c, nl)) : 0.f;
          s[e] = p;
          dp[e] = __fmul_rn(p, __fsub_rn(dp[e], dd));
        }
      }

    // Pᵀ and dSᵀ as A fragments, each split hi + lo in bf16: step kk
    // (queries 16kk..) takes accumulator columns j = 2kk and 2kk + 1
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        split_bf16(s[e], s[e + 1], ph[kk][r], pl[kk][r]);
        split_bf16(dp[e], dp[e + 1], sh[kk][r], sl[kk][r]);
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q: B the dO or Q tile, MN-major; step kk
    // reads queries 16kk..16kk+15
#pragma unroll
    for (int h = 0; h < Tl::kHalves; ++h) {
      pin(acc_v[h]);
      pin(acc_k[h]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < Tl::kHalves; ++h) {
        const uint64_t gd = mn_desc<HD>(gb, h, kk), qd = mn_desc<HD>(qb, h, kk);
        wgmma_64x64x16<1>(acc_v[h], ph[kk], gd, 1);
        wgmma_64x64x16<1>(acc_v[h], pl[kk], gd, 1);
        wgmma_64x64x16<1>(acc_k[h], sh[kk], qd, 1);
        wgmma_64x64x16<1>(acc_k[h], sl[kk], qd, 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < Tl::kHalves; ++h) {
      pin(acc_v[h]);
      pin(acc_k[h]);
    }
  }
  cp_async_wait<0>();

  // acc[h][4j + 2i + c]: key gid + 8i of the warp's 16, dim 64h + 8j + 2tq + c
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    const int key = key0 + warp * 16 + gid + 8 * ii;
    if (key >= sk) continue;
    const size_t off = ((size_t)b * sk + key) * kstride + (size_t)kvh * HD;
#pragma unroll
    for (int h = 0; h < Tl::kHalves; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * ii, d = 64 * h + 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + d) = __floats2bfloat162_rn(
            __fmul_rn(acc_k[h][e], scale), __fmul_rn(acc_k[h][e + 1], scale));
        *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
            __floats2bfloat162_rn(acc_v[h][e], acc_v[h][e + 1]);
      }
  }
}

// grid (B·NH, ceil(Sq / 64)), kMmaThreads threads, bf16.  The query tile
// is gridDim.y - 1 - blockIdx.y, so the last tiles, whose causal rows see
// the most keys, start first.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSM)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                        __nv_bfloat16* __restrict__ dq, int sq, int sk, int nh, int kh,
                        int causal, int window, float scale) {
  using Tl = MmaTile<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* own = smem_raw + ((kSwizzleBytes - smem_u32(smem_raw) % kSwizzleBytes)
                                   % kSwizzleBytes);             // Q | dO
  unsigned char* ring = own + Tl::kPairBytes;                    // [stage] K | V
  float* sets = reinterpret_cast<float*>(ring + kMmaStages * Tl::kPairBytes);
  float* own_set = sets + kMmaStages * Tl::kSetWords;            // lse | D | position
  int* qps = reinterpret_cast<int*>(own_set + 2 * kMmaTile);
  const int ntiles = (sk + kMmaTile - 1) / kMmaTile;
  int* flags = reinterpret_cast<int*>(sets + (kMmaStages + 1) * Tl::kSetWords);
  int* list = flags + ntiles;
  int* nvis_s = list + ntiles;

  const int g = nh / kh;
  const int bh = blockIdx.x, b = bh / nh, h = bh % nh, kvh = h / g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaTile, nq = min(kMmaTile, sq - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const float c = __fmul_rn(scale, kLog2e);
  const size_t kstride = (size_t)kh * HD, qstride = (size_t)nh * HD;
  const size_t off = ((size_t)b * sq + q0) * qstride + (size_t)h * HD;

  // the block's Q and dO tiles: one commit group, waited for with key tile 0's
  tile_async<HD>(smem_u32(own), q + off, qstride, nq);
  tile_async<HD>(smem_u32(own + Tl::kTileBytes), dout + off, qstride, nq);
  cp_async_commit();
  if (tid < kMmaTile) {
    const bool live = tid < nq;
    const size_t row = ((size_t)b * nh + h) * sq + q0 + tid;
    own_set[tid] = live ? lse[row] : __int_as_float(0x7f800000);
    own_set[kMmaTile + tid] = live ? dsum[row] : 0.f;
    qps[tid] = live ? q_pos[(size_t)b * sq + q0 + tid] : 0;
  }
  __syncthreads();

  // the live rows' position range [lo, hi], found by every warp alone
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = 32 * u + lane;
    if (r < nq) {
      lo = min(lo, qps[r]);
      hi = max(hi, qps[r]);
    }
  }
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off2));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off2));
  }
  // flags[t]: 0 no row sees a key of key tile t, 1 some row may, 3 every
  // live row sees every key of it; a warp votes on 4 tiles a pass, their
  // positions loaded together (K6's vote)
  for (int t0 = 4 * warp; t0 < ntiles; t0 += 4 * kMmaWarps) {
    int kp[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int key = (t0 + u) * kMmaTile + 32 * w + lane;
        kp[u][w] = key < sk ? kv_pos[(size_t)b * sk + key] : -1;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bool any = false, all = true;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        any = any || maybe_visible(kp[u][w], lo, hi, causal, window);
        all = all && visible(kp[u][w], lo, causal, kNoWindow) &&
              visible(kp[u][w], hi, 0, window);
      }
      any = __any_sync(kFull, any);
      all = __all_sync(kFull, all);
      if (lane == 0 && t0 + u < ntiles) flags[t0 + u] = any ? (all ? 3 : 1) : 0;
    }
  }
  __syncthreads();
  compact(flags, ntiles, list, nvis_s);
  __syncthreads();
  const int nvis = *nvis_s;

  // this thread's two rows: accumulator rows gid and gid + 8 of its warp's
  // 16 (a dead row has lse +inf, so P = 0 there)
  bool live[2];
  int qp[2];
  float nl[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    live[i] = r < nq;
    qp[i] = qps[r];
    nl[i] = -__fmul_rn(own_set[r], kLog2e);
    dd[i] = own_set[kMmaTile + r];
  }

  // visible key tile i's K and V tiles and positions into stage i %
  // kMmaStages; always one commit group
  auto issue = [&](int i) {
    if (i < nvis) {
      const int key0 = list[i] * kMmaTile, nk = min(kMmaTile, sk - key0);
      const int stage = i % kMmaStages;
      const size_t koff = ((size_t)b * sk + key0) * kstride + (size_t)kvh * HD;
      const uint32_t dst = smem_u32(ring + stage * Tl::kPairBytes);
      tile_async<HD>(dst, k + koff, kstride, nk);
      tile_async<HD>(dst + Tl::kTileBytes, v + koff, kstride, nk);
      keys_async(reinterpret_cast<int*>(sets + stage * Tl::kSetWords),
                 kv_pos + (size_t)b * sk + key0, nk);
    }
    cp_async_commit();
  };

  float acc[Tl::kHalves][32];
#pragma unroll
  for (int h2 = 0; h2 < Tl::kHalves; ++h2)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[h2][e] = 0.f;

  issue(0);
  const uint32_t qb = smem_u32(own), gb = qb + Tl::kTileBytes;
  for (int i = 0; i < nvis; ++i) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    issue(i + 1);
    const int stage = i % kMmaStages;
    const bool every = flags[list[i]] == 3;
    const uint32_t kb = smem_u32(ring + stage * Tl::kPairBytes), vb = kb + Tl::kTileBytes;
    const int* kp_s = reinterpret_cast<const int*>(sets + stage * Tl::kSetWords);

    // S = Q·Kᵀ and dP = dO·Vᵀ (queries on M, keys on N)
    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    wgmma_fence();
    product_ss<HD>(s, qb, kb);
    product_ss<HD>(dp, gb, vb);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // s[4j + 2i + c]: row gid + 8i of the warp's 16, key 8j + 2tq + c of
    // the tile; dS = P∘(dP − D) into dp
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int kpos = kp_s[8 * j + 2 * tq + cc];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int e = 4 * j + 2 * ii + cc;
          const bool ok = every || (live[ii] && visible(kpos, qp[ii], causal, window));
          const float p = ok ? exp2_approx(__fmaf_rn(s[e], c, nl[ii])) : 0.f;
          dp[e] = __fmul_rn(p, __fsub_rn(dp[e], dd[ii]));
        }
      }

    // dS as A fragments split hi + lo; dQ += dS·K: B the K tile, MN-major
    uint32_t sh[4][4], sl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        split_bf16(dp[e], dp[e + 1], sh[kk][r], sl[kk][r]);
      }
#pragma unroll
    for (int h2 = 0; h2 < Tl::kHalves; ++h2) pin(acc[h2]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < Tl::kHalves; ++h2) {
        const uint64_t kd = mn_desc<HD>(kb, h2, kk);
        wgmma_64x64x16<1>(acc[h2], sh[kk], kd, 1);
        wgmma_64x64x16<1>(acc[h2], sl[kk], kd, 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h2 = 0; h2 < Tl::kHalves; ++h2) pin(acc[h2]);
  }
  cp_async_wait<0>();

  // dQ = scale·acc: acc[h][4j + 2i + c] is row gid + 8i of the warp's 16,
  // dim 64h + 8j + 2tq + c
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    if (!live[ii]) continue;
    __nv_bfloat16* row = dq + off + (size_t)(warp * 16 + gid + 8 * ii) * qstride;
#pragma unroll
    for (int h2 = 0; h2 < Tl::kHalves; ++h2)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * ii;
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * h2 + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(__fmul_rn(acc[h2][e], scale),
                                  __fmul_rn(acc[h2][e + 1], scale));
      }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int *q_pos, *kv_pos;
  void *dq, *dk, *dv;
  float* dsum;
  int b, sq, sk, nh, kh, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// D = rowsum(dO∘O), both paths' first launch
template <typename T>
cudaError_t launch_dot(const Args& a, int hd) {
  const int rows = a.b * a.sq * a.nh;
  flash_bwd_dot_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                            a.stream>>>(static_cast<const T*>(a.o),
                                        static_cast<const T*>(a.dout), a.dsum, rows,
                                        a.sq, a.nh, hd);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  using Tl = Tile<HD>;
  cudaError_t err = launch_dot<T>(a, HD);
  if (err != cudaSuccess) return err;
  const size_t smem = Tl::kBytes;
  if (a.sk > 0) {
    const dim3 grid((a.sk + Tl::kBT - 1) / Tl::kBT, a.b * a.kh);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    err = allow_smem(flash_bwd_dkdv_kernel<T, HD>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.dsum,
        a.q_pos, a.kv_pos, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
        a.nh, a.kh, a.causal, a.window, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.sq + Tl::kBT - 1) / Tl::kBT, a.b * a.nh);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  err = allow_smem(flash_bwd_dq_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.dsum,
      a.q_pos, a.kv_pos, static_cast<T*>(a.dq), a.sq, a.sk, a.nh, a.kh, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const Args& a, int hd) {
  switch (hd) {
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int HD>
cudaError_t launch_mma(const Args& a) {
  using Tl = MmaTile<HD>;
  using bf16 = __nv_bfloat16;
  cudaError_t err = launch_dot<bf16>(a, HD);
  if (err != cudaSuccess) return err;
  const int qtiles = (a.sq + kMmaTile - 1) / kMmaTile;
  const int ktiles = (a.sk + kMmaTile - 1) / kMmaTile;
  if (a.sk > 0) {
    const dim3 grid(a.b * a.kh, ktiles);
    const size_t smem = Tl::bytes(qtiles);
    if (grid.y > 65535 || smem > 232448) return cudaErrorInvalidValue;
    err = allow_smem(flash_bwd_dkdv_mma_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_mma_kernel<HD><<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
        a.dsum, a.q_pos, a.kv_pos, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.sq, a.sk, a.nh, a.kh, a.causal, a.window, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.b * a.nh, qtiles);
  const size_t smem = Tl::bytes(ktiles);
  if (grid.y > 65535 || smem > 232448) return cudaErrorInvalidValue;
  err = allow_smem(flash_bwd_dq_mma_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<HD><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.dsum,
      a.q_pos, a.kv_pos, static_cast<bf16*>(a.dq), a.sq, a.sk, a.nh, a.kh, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike);
// lse (B, NH, Sq) float32 from flash_attention_fwd; scratch holds B·NH·Sq
// floats (D); has_window as in flash_attention_fwd.  path (kernel.py's
// bwd_plan): 0 = FMA (float32 at hd 32, 64, 128 or 256; bf16 at hd 32
// or 256), 1 = MMA (bf16 at hd 64 or 128; q, k, v and dout 16-byte
// aligned); any other (path, dtype, hd) is cudaErrorInvalidValue.  Three
// launches on `stream`; returns their cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   const void* q_pos, const void* kv_pos, void* dq,
                                   void* dk, void* dv, void* scratch, int b, int sq,
                                   int sk, int nh, int kh, int hd, int dtype,
                                   int causal, int has_window, int window,
                                   float scale, int path, void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kh < 1 || nh % kh != 0 || scratch == nullptr)
    return cudaErrorInvalidValue;
  if (has_window && window == kNoWindow) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
               dq, dk, dv, static_cast<float*>(scratch), b, sq, sk, nh, kh, causal,
               has_window ? window : kNoWindow, scale,
               static_cast<cudaStream_t>(stream)};
  if (path == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (hd == 64) return launch_mma<64>(a);
    if (hd == 128) return launch_mma<128>(a);
    return cudaErrorInvalidValue;
  }
  if (path != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_type<float>(a, hd);
  if (dtype != 1) return cudaErrorInvalidValue;
  // bf16 at hd 64 and 128 is the MMA path's alone: one path for each input
  if (hd == 32) return launch<__nv_bfloat16, 32>(a);
  if (hd == 256) return launch<__nv_bfloat16, 256>(a);
  return cudaErrorInvalidValue;
}
