// The split decode attention of a head-dim-sharded cache, for Hopper
// (sm_90a): K8 flash_decode_scores and K9 flash_decode_pv.
//
// Replaces no TPU kernel.  Where a model's kv_heads do not divide the
// "model" axis of a mesh (recurrentgemma-9b's one kv head), the reference
// shards the decode cache by head dim (src/repro/models/layers.py:221-231)
// and leaves the attention to XLA under GSPMD, which partial-sums the
// scores over the sharded head dim (attention_xla, layers.py:147; no
// pl.pallas_call is involved).  The port runs that partial sum as two
// kernels around an all-reduce over "model" (models/layers.py):
//
//   K8: q (B, 1, NH, d) and this rank's cache k (B, L, KH, d), float32 or
//       bf16, d = hd / model → s (B, NH, L) float32, s[b,h,j] = Σ_c q[b,h,c]
//       k[b,j,h/G,c] over this rank's d channels (G = NH / KH: query head
//       h reads KV head h / G).  No scale and no mask: both are applied
//       once, after the ranks' partial scores are summed.
//   K9: the summed s, this rank's v (B, L, KH, d), q_pos (B, 1), kv_pos
//       (B, L) int32 → out (B, 1, NH, d) in v's type: the softmax of
//       scale·s (scale = hd^-1/2 with the whole hd) over the keys K6's mask
//       leaves visible (kv_pos >= 0; kv_pos <= q_pos if causal; kv_pos >
//       q_pos - w if a window w is given), times this rank's V.  A row that
//       sees no key gets 0, as in K6.
//
// What bounds them.  recurrentgemma-9b's decode on a model axis of 2: B=8,
// NH=16, KH=1, d=128, L=2048 (the window's ring), bf16.  K8 reads 4.19 MB of
// k and writes 1.05 MB of s for 2·B·NH·L·d = 67 MFLOP; K9 reads the 1.05 MB
// of s and 4.19 MB of v for about as many: both are bytes, ~1.6 µs each at
// 3.35 TB/s.  So each reads its cache once, KV head by KV head (the G query
// heads of a KV head share a block), and spreads it over many blocks:
//
//  * flash_decode_scores_kernel: a block owns (64 keys, KV head, batch
//    row): it stages its G query rows and its 64 key rows in shared memory
//    as float32 (rows padded by one float, so the lanes' reads of 32
//    consecutive key rows hit 32 banks) and each thread computes (head,
//    key) dot products in channel order.  256 blocks at the shape above.
//  * flash_decode_pv_split_kernel: a block owns (kSplit = 64 keys, KV head,
//    batch row) and all G heads: it stages its scores (masked ones at
//    -inf), takes each head's max m and p = exp(scale·s - m) (a warp a
//    head), stages its V rows as float32 and writes every head's partial
//    (m, l = Σ p, acc = P·V) to a wrapper-allocated scratch (B, KH,
//    splits, G, d + 2); m = -inf and l = acc = 0 for a split that the head
//    does not see.
//  * flash_decode_pv_merge_kernel: a block per (head, batch row) combines
//    the splits in split order: M = max m_s, L = Σ exp(m_s - M) l_s, out =
//    Σ exp(m_s - M) acc_s / L (0 where no split saw a key).  No atomics:
//    the bits do not depend on the launch order.
//
// Both C entries return the first CUDA error (a refused launch) or 0; the
// wrappers (kernel.py) check shapes, types and contiguity, allocate the
// outputs and the scratch, and raise on an error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kScoreKeys = 64;      // keys of a K8 block
constexpr int kScoreThreads = 256;
constexpr int kSplit = 64;          // keys of a K9 split block
constexpr int kSplitThreads = 256;
constexpr int kMergeThreads = 128;
constexpr int kMaxStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void flash_decode_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                           float* __restrict__ s, int len, int nh, int kh,
                                           int d) {
  extern __shared__ float smem[];
  const int g = nh / kh;
  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * kScoreKeys;
  const int keys = min(kScoreKeys, len - j0);
  const int ld = d + 1;
  float* qs = smem;              // [g][d]
  float* ks = smem + g * d;      // [kScoreKeys][d + 1]
  const T* qb = q + ((size_t)b * nh + (size_t)kvh * g) * d;
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) qs[i] = to_f(qb[i]);
  for (int i = threadIdx.x; i < keys * d; i += blockDim.x) {
    const int j = i / d, c = i - j * d;
    ks[j * ld + c] = to_f(k[(((size_t)b * len + j0 + j) * kh + kvh) * d + c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * keys; i += blockDim.x) {
    const int h = i / keys, j = i - h * keys;
    const float* qr = qs + h * d;
    const float* kr = ks + j * ld;
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
    s[((size_t)b * nh + (size_t)kvh * g + h) * len + j0 + j] = acc;
  }
}

__device__ __forceinline__ bool visible(int ik, int iq, int causal, int has_window,
                                        int window) {
  bool m = ik >= 0;
  if (causal) m = m && ik <= iq;
  if (has_window) m = m && (long long)ik > (long long)iq - (long long)window;
  return m;
}

template <typename T>
__global__ void flash_decode_pv_split_kernel(const float* __restrict__ s,
                                             const T* __restrict__ v,
                                             const int* __restrict__ q_pos,
                                             const int* __restrict__ kv_pos,
                                             float* __restrict__ scratch, int len, int nh,
                                             int kh, int d, int causal, int has_window,
                                             int window, float scale) {
  extern __shared__ float smem[];
  const int g = nh / kh, splits = gridDim.x;
  const int b = blockIdx.z, kvh = blockIdx.y, split = blockIdx.x;
  const int j0 = split * kSplit, keys = min(kSplit, len - j0);
  float* ps = smem;                    // [g][kSplit]: scores, then p
  float* vs = ps + g * kSplit;         // [kSplit][d]
  float* ms = vs + kSplit * d;         // [g]
  float* ls = ms + g;                  // [g]
  const int iq = q_pos[b];
  const int* kp = kv_pos + (size_t)b * len + j0;
  for (int i = threadIdx.x; i < g * kSplit; i += blockDim.x) {
    const int h = i / kSplit, j = i - h * kSplit;
    float x = -INFINITY;
    if (j < keys && visible(kp[j], iq, causal, has_window, window))
      x = s[((size_t)b * nh + (size_t)kvh * g + h) * len + j0 + j] * scale;
    ps[i] = x;
  }
  for (int i = threadIdx.x; i < keys * d; i += blockDim.x) {
    const int j = i / d, c = i - j * d;
    vs[i] = to_f(v[(((size_t)b * len + j0 + j) * kh + kvh) * d + c]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = warp; h < g; h += blockDim.x / 32) {
    float* row = ps + h * kSplit;
    float m = -INFINITY;
    for (int j = lane; j < kSplit; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < kSplit; j += 32) {
      const float p = row[j] == -INFINITY ? 0.f : expf(row[j] - m);
      row[j] = p;
      l += p;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      ms[h] = m;
      ls[h] = l;
    }
  }
  __syncthreads();
  const int stride = d + 2;
  float* out = scratch + (((size_t)b * kh + kvh) * splits + split) * g * stride;
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    const int h = i / d, c = i - h * d;
    const float* p = ps + h * kSplit;
    float acc = 0.f;
    for (int j = 0; j < keys; ++j) acc = fmaf(p[j], vs[j * d + c], acc);
    out[h * stride + 2 + c] = acc;
  }
  for (int h = threadIdx.x; h < g; h += blockDim.x) {
    out[h * stride] = ms[h];
    out[h * stride + 1] = ls[h];
  }
}

template <typename T>
__global__ void flash_decode_pv_merge_kernel(const float* __restrict__ scratch,
                                             T* __restrict__ out, int nh, int kh, int d,
                                             int splits) {
  const int g = nh / kh;
  const int b = blockIdx.y, h = blockIdx.x, kvh = h / g, hg = h - kvh * g;
  const int stride = d + 2;
  const float* part = scratch + (((size_t)b * kh + kvh) * splits) * g * stride + hg * stride;
  const size_t step = (size_t)g * stride;
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, part[sp * step]);
  float l = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float m = part[sp * step];
    if (m != -INFINITY) l += expf(m - mx) * part[sp * step + 1];
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float m = part[sp * step];
      if (m != -INFINITY) acc += expf(m - mx) * part[sp * step + 2 + c];
    }
    out[((size_t)b * nh + h) * d + c] = from_f<T>(l > 0.f ? acc / l : 0.f);
  }
}

template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (bytes > (size_t)kMaxStaticSmem)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_scores(const void* q, const void* k, float* s, int b, int len, int nh,
                          int kh, int d, cudaStream_t stream) {
  const size_t smem = ((size_t)(nh / kh) * d + (size_t)kScoreKeys * (d + 1)) * sizeof(float);
  cudaError_t err = fit_smem(flash_decode_scores_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((len + kScoreKeys - 1) / kScoreKeys, kh, b);
  flash_decode_scores_kernel<T><<<grid, kScoreThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), s, len, nh, kh, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pv(const float* s, const void* v, const int* q_pos, const int* kv_pos,
                      void* out, float* scratch, int b, int len, int nh, int kh, int d,
                      int causal, int has_window, int window, float scale,
                      cudaStream_t stream) {
  const int g = nh / kh, splits = (len + kSplit - 1) / kSplit;
  const size_t smem = ((size_t)g * kSplit + (size_t)kSplit * d + 2 * (size_t)g) * sizeof(float);
  cudaError_t err = fit_smem(flash_decode_pv_split_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_pv_split_kernel<T><<<dim3(splits, kh, b), kSplitThreads, smem, stream>>>(
      s, static_cast<const T*>(v), q_pos, kv_pos, scratch, len, nh, kh, d, causal,
      has_window, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_pv_merge_kernel<T><<<dim3(nh, b), kMergeThreads, 0, stream>>>(
      scratch, static_cast<T*>(out), nh, kh, d, splits);
  return cudaGetLastError();
}

}  // namespace

// K8: s (B, NH, L) float32 = q (B, 1, NH, d) · k (B, L, KH, d)ᵀ per KV head.
extern "C" int flash_decode_scores(const void* q, const void* k, void* s, int b, int len,
                                   int nh, int kh, int d, int dtype, void* stream) {
  if (b < 1 || len < 1 || kh < 1 || nh % kh != 0 || d < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  if (dtype == 0) return launch_scores<float>(q, k, sf, b, len, nh, kh, d, st);
  if (dtype == 1) return launch_scores<__nv_bfloat16>(q, k, sf, b, len, nh, kh, d, st);
  return cudaErrorInvalidValue;
}

// K9: out (B, 1, NH, d) in v's type from the summed scores s (B, NH, L)
// float32, v (B, L, KH, d), q_pos (B, 1) and kv_pos (B, L); scratch holds
// B · KH · ceil(L / 64) · G · (d + 2) floats.
extern "C" int flash_decode_pv(const void* s, const void* v, const void* q_pos,
                               const void* kv_pos, void* out, void* scratch, int b, int len,
                               int nh, int kh, int d, int dtype, int causal, int has_window,
                               int window, float scale, void* stream) {
  if (b < 1 || len < 1 || kh < 1 || nh % kh != 0 || d < 1 || scratch == nullptr)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sf = static_cast<const float*>(s);
  const auto qp = static_cast<const int*>(q_pos);
  const auto kp = static_cast<const int*>(kv_pos);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_pv<float>(sf, v, qp, kp, out, sc, b, len, nh, kh, d, causal, has_window,
                            window, scale, st);
  if (dtype == 1)
    return launch_pv<__nv_bfloat16>(sf, v, qp, kp, out, sc, b, len, nh, kh, d, causal,
                                    has_window, window, scale, st);
  return cudaErrorInvalidValue;
}
