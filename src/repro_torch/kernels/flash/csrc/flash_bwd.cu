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
// Three launches, no atomics, every sum in a fixed order (so the result is
// bitwise the same from run to run, which a resumed training run needs):
//  * flash_bwd_dot_kernel: D, one warp a row, float32.
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
// warp reads at one time on different banks.
//
// What bounds it: at the training shape (B=4, S=512, NH=24, KH=8, hd=128,
// bf16, causal) the op needs ~16 GFLOP and ~67 MB (16 µs on the tensor
// cores, 20 µs of bytes).  This first version runs every product as
// float32 FMAs from shared memory (~2 operand loads an FMA pair) and
// recomputes S and dO·Vᵀ in both passes, so the CUDA cores bound it at
// about a millisecond; mma.sync / wgmma with TMA is later work (ROADMAP
// queue B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoWindow = -2147483647 - 1;  // INT_MIN: no window given

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

// K6's rule; `window` is kNoWindow when none is given
__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window != kNoWindow) ok = ok && (long long)kp > (long long)qp - window;
  return ok;
}

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

template <typename T, int HD>
cudaError_t launch(const Args& a) {
  using Tl = Tile<HD>;
  const int rows = a.b * a.sq * a.nh;
  flash_bwd_dot_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                            a.stream>>>(static_cast<const T*>(a.o),
                                        static_cast<const T*>(a.dout), a.dsum, rows,
                                        a.sq, a.nh, HD);
  cudaError_t err = cudaGetLastError();
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike);
// lse (B, NH, Sq) float32 from flash_attention_fwd; scratch holds B·NH·Sq
// floats (D); has_window as in flash_attention_fwd.  Three launches on
// `stream`; returns their cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   const void* q_pos, const void* kv_pos, void* dq,
                                   void* dk, void* dv, void* scratch, int b, int sq,
                                   int sk, int nh, int kh, int hd, int dtype,
                                   int causal, int has_window, int window,
                                   float scale, void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kh < 1 || nh % kh != 0 || scratch == nullptr)
    return cudaErrorInvalidValue;
  if (has_window && window == kNoWindow) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
               dq, dk, dv, static_cast<float*>(scratch), b, sq, sk, nh, kh, causal,
               has_window ? window : kNoWindow, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_type<float>(a, hd);
  if (dtype == 1) return launch_type<__nv_bfloat16>(a, hd);
  return cudaErrorInvalidValue;
}
