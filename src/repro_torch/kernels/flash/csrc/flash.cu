// Flash attention forward for Hopper (sm_90a): K6 flash_attention_fwd.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::flash_attention
// (pallas_call at :109, body _flash_kernel at :28; flash_attention_bhsd at
// :129 vmaps it over batch and heads).  One kernel serves the single-head
// entry points and the LM serving path:
//
//   q (B, Sq, NH, hd), k/v (B, Sk, KH, hd) in float32 or bfloat16,
//   q_pos (B, Sq) and kv_pos (B, Sk) int32, out (B, Sq, NH, hd) in q's type.
//   Query head h reads KV head h / G, G = NH / KH (GQA by index: the cache
//   is read once per KV head and never repeated).
//   Key j is seen by query i of batch row b when kv_pos[b,j] >= 0, and
//   kv_pos[b,j] <= q_pos[b,i] if causal, and kv_pos[b,j] > q_pos[b,i] - w
//   if w > 0.  The single-head wrappers pass the Pallas kernel's
//   suffix-aligned positions (q_pos = Sk - Sq + i, kv_pos = j); the serving
//   path passes its cache's slot positions (-1 = empty slot, reset slot or
//   trash slot).  A query with no visible key gets 0.
//
// Online softmax over key tiles, as the Pallas kernel: with s the scaled
// scores of a tile (masked ones at -1e30), m' = max(m, max s),
// p = mask ? exp(s - m') : 0 (the mask keeps a tile whose keys are all masked
// from counting while m is still -1e30), l = exp(m - m') l + Σ p,
// acc = exp(m - m') acc + p·V, and out = acc / (l == 0 ? 1 : l).  Scores,
// p and both accumulators are float32.
//
// What bounds it on an H100.  Decode (Sq = 1) reads every visible key and
// value once: 2·B·Sk·KH·hd·2 bytes in bf16 (16.8 MB at B=8, Sk=512, KH=8,
// hd=128: 5 µs at 3.35 TB/s), against 4·B·NH·Sk·hd operations (0.1 µs of
// tensor-core time), so bytes bound it.  A causal prefill at S=2048, 24
// heads, hd=128 does 4·S²·hd·H/2 operations (26 GFLOP, 26 µs at 989
// TFLOP/s bf16) on 25 MB, so operations bound it.
//
// Design (simple first; the fast version is later work).
//  * A block owns one (batch row, KV head) and kRows = 16 consecutive
//    (query, group head) rows, so its key tiles serve all G heads of its KV
//    head.  Each warp owns rows warp, warp + 4, warp + 8, warp + 12; each
//    lane owns one key of a 32-key tile for the scores and hd/32 output
//    dimensions for P·V.  A decode step has Sq·G rows (3 for llama3.2-3b),
//    so most of a decode block's row slots are idle: they cost registers
//    and a skipped loop turn, not loads.
//  * A tile's K and V are staged in shared memory as float32 with 16-byte
//    loads.  A tile in which no key is visible to any row of the block (empty
//    cache slots, keys past a causal diagonal) is skipped before it is
//    loaded: it would leave m, l and acc exactly as they are.
//  * The products run on the CUDA cores in float32 (no wgmma yet), so a long
//    prefill is far from its bound; decode is latency-bound by one tile load
//    after another with no double buffering.
//  * Row independence: every sum of a row (the dot over hd, the warp trees
//    over the tile, the tile order) is fixed by hd and Sk alone.  Nothing
//    depends on B, on the other rows of the block or on which tiles the
//    block skipped, and there are no atomics.  The softmax update is
//    written with explicit rounding intrinsics (__fmul_rn, __fadd_rn, ...)
//    so that the compiler cannot contract it into FMAs differently for a
//    block's four unrolled row slots.  So a batch row decodes bitwise the
//    same alone and in a batch, which the serving engine's
//    staggered-admission and slot-isolation invariants need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;               // keys per tile: one per lane
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows a block
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;         // elements per 16-byte load
  __device__ static float to_f32(float x) { return x; }
  __device__ static float from_f32(float x) { return x; }
  __device__ static void unpack(uint4 raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f32(float x) { return __float2bfloat16(x); }
  __device__ static void unpack(uint4 raw, float* out) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {        // little-endian: low half first
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// grid (ceil(Sq·G / kRows), KH, B), kThreads threads
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ out, int sq,
                 int sk, int nh, int kh, int causal, int window, float scale) {
  constexpr int kPer = HD / 32;          // output dimensions per lane
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kChunks = HD / kVec;     // 16-byte loads per key row
  __shared__ float qs[kRows][HD];
  __shared__ float ks[kTileK][HD + 1];   // +1: lane j reads row j, no conflicts
  __shared__ float vs[kTileK][HD];
  __shared__ int kps[kTileK];

  const int g = nh / kh;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;   // rows are f = query * G + group head
  const int nrows = sq * g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < kRows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, f = row0 + r;
    float val = 0.f;
    if (f < nrows)
      val = Elem<T>::to_f32(
          q[(((size_t)b * sq + f / g) * nh + kvh * g + f % g) * HD + d]);
    qs[r][d] = val;
  }

  bool live[kRowsPerWarp];
  int qp[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPer];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int f = row0 + warp + kWarps * r;
    live[r] = f < nrows;
    qp[r] = live[r] ? q_pos[(size_t)b * sq + f / g] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[r][t] = 0.f;
  }

  for (int t0 = 0; t0 < sk; t0 += kTileK) {
    __syncthreads();                     // the last tile's reads are done
    if (threadIdx.x < kTileK) {
      const int j = t0 + threadIdx.x;
      kps[threadIdx.x] = j < sk ? kv_pos[(size_t)b * sk + j] : -1;
    }
    __syncthreads();
    const int kp = kps[lane];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) any = any || (live[r] && visible(kp, qp[r], causal, window));
    if (!__syncthreads_or(any)) continue;

    for (int c = threadIdx.x; c < kTileK * kChunks; c += kThreads) {
      const int j = c / kChunks, part = c % kChunks;
      float kf[kVec], vf[kVec];
      if (t0 + j < sk) {
        const size_t off = (((size_t)b * sk + t0 + j) * kh + kvh) * HD + part * kVec;
        Elem<T>::unpack(*reinterpret_cast<const uint4*>(k + off), kf);
        Elem<T>::unpack(*reinterpret_cast<const uint4*>(v + off), vf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ks[j][part * kVec + e] = kf[e];
        vs[j][part * kVec + e] = vf[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (!live[r]) continue;            // uniform across the warp
      const int row = warp + kWarps * r;
      const bool ok = visible(kp, qp[r], causal, window);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qs[row][d], ks[lane][d], s);
      s = ok ? __fmul_rn(s, scale) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = ok ? expf(__fsub_rn(s, m_new)) : 0.f;
      const float corr = expf(__fsub_rn(m[r], m_new));
      l[r] = __fadd_rn(__fmul_rn(corr, l[r]), warp_sum(p));
      float pv[kPer];
#pragma unroll
      for (int t = 0; t < kPer; ++t) pv[t] = 0.f;
#pragma unroll 8
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int t = 0; t < kPer; ++t) pv[t] = fmaf(pj, vs[j][lane + 32 * t], pv[t]);
      }
#pragma unroll
      for (int t = 0; t < kPer; ++t) acc[r][t] = __fadd_rn(__fmul_rn(corr, acc[r][t]), pv[t]);
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    const int f = row0 + warp + kWarps * r;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* o = out + (((size_t)b * sq + f / g) * nh + kvh * g + f % g) * HD;
#pragma unroll
    for (int t = 0; t < kPer; ++t)
      o[lane + 32 * t] = Elem<T>::from_f32(__fdiv_rn(acc[r][t], denom));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int b,
                   int sq, int sk, int nh, int kh, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int nrows = sq * (nh / kh);
  const dim3 grid((nrows + kRows - 1) / kRows, kh, b);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), sq, sk,
      nh, kh, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* out, int b,
                        int sq, int sk, int nh, int kh, int hd, int causal,
                        int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, q_pos, kv_pos, out, b, sq, sk, nh, kh,
                           causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_pos, kv_pos, out, b, sq, sk, nh, kh,
                           causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_pos, kv_pos, out, b, sq, sk, nh, kh,
                            causal, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* kv_pos,
                                   void* out, int b, int sq, int sk, int nh,
                                   int kh, int hd, int dtype, int causal,
                                   int window, float scale, void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kh < 1 || nh % kh != 0) return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_type<float>(q, k, v, qp, kp, out, b, sq, sk, nh, kh, hd,
                              causal, window, scale, s);
  if (dtype == 1)
    return launch_type<__nv_bfloat16>(q, k, v, qp, kp, out, b, sq, sk, nh, kh,
                                      hd, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
