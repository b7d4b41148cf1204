// Flash attention forward for Hopper (sm_90a): K6 flash_attention_fwd.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::flash_attention
// (pallas_call at :109, body _flash_kernel at :28; flash_attention_bhsd at
// :129 vmaps it over batch and heads).  One C entry serves the single-head
// entry points and the LM (forward and serving decode):
//
//   q (B, Sq, NH, hd), k/v (B, Sk, KH, hd) in float32 or bfloat16,
//   q_pos (B, Sq) and kv_pos (B, Sk) int32, out (B, Sq, NH, hd) in q's type.
//   Query head h reads KV head h / G, G = NH / KH (GQA by index: the cache
//   is read once per KV head and never repeated).  The rows of one (batch
//   row, KV head) are f = query · G + group head.
//   Key j is seen by query i of batch row b when kv_pos[b,j] >= 0, and
//   kv_pos[b,j] <= q_pos[b,i] if causal, and kv_pos[b,j] > q_pos[b,i] - w
//   if a window w is given (any w: w <= 0 with causal hides every key, as
//   in the Pallas kernel).  The single-head wrappers pass the Pallas kernel's
//   suffix-aligned positions; the serving path passes its cache's slot
//   positions (-1 = empty, reset or trash slot).  A query with no visible
//   key gets 0.
//
// Online softmax, as the Pallas kernel: with s the scaled scores of a key
// tile (masked ones at -1e30), m' = max(m, max s), p = mask ? exp(s - m') : 0
// (the mask keeps a tile whose keys are all masked from counting while m is
// still -1e30), l = exp(m - m') l + Σ p, acc = exp(m - m') acc + p·V, and
// out = acc / (l == 0 ? 1 : l).  Scores, p and both accumulators are f32.
// A tile that a row does not see leaves its m, l and acc bit for bit as
// they were (m' = m, p = 0, exp(0) = 1), so a block may skip any tile that
// no row of it sees before the tile is copied.
//
// Two paths; the wrapper's plan() (kernel.py) picks one from (dtype, Sq,
// NH, KH, hd, Sk) alone, never from B or the positions, and passes it in.
//
// Split path (decode; every float32 call; hd 32, 64, 128 or 256: at hd =
// 256, recurrentgemma-9b's local attention, a block's stage ring takes 133
// KB in float32 and 68 KB in bf16 of the 227 KB it may use). A decode step
// reads every visible key and value once, 2·B·Sk·KH·hd·2 bytes in bf16 (16.8
// MB at B=8, Sk=512, KH=8, hd=128: 5 µs at 3.35 TB/s) for 4·B·NH·Sk·hd
// operations, so bytes bound it, and at a few hundred keys the latency of a
// block's chain of loads. So the cache is spread over many blocks, each with
// its loads in flight together:
//  * flash_fwd_split_kernel: a block owns one (batch row, KV head, split of
//    split_len consecutive cache slots) and up to kRows = 16 of its rows
//    (a decode step has G = 3), so the grid is nsplit × row chunks × B·KH
//    (plan() aims at 8 splits for up to 16 rows: 512 blocks at B=8,
//    Sk=512; past 16 rows the row chunks fill the grid and the cache is
//    one split, so the scratch stays about the output's size).  It reads
//    the split's positions once, kSpan at a time, votes which 32-key tiles
//    some row sees, and streams only those through a ring of kStages
//    shared-memory stages filled by 16-byte cp.async copies in the input
//    type (bf16 stays bf16): the next tile is in flight while this one is
//    computed.  Rows are padded by 16 bytes so the lanes' 16-byte reads of
//    different key rows hit different banks.  Each warp owns rows warp +
//    4r; each lane owns one key for the score (a dot over hd in order) and
//    hd/32 consecutive output dimensions for P·V.  Every (row, split)
//    writes its float32 partial (m, l, acc[hd]) to scratch, m = -1e30 and
//    l = acc = 0 if no tile of it was visible.
//  * flash_fwd_merge_kernel: one warp per row combines the splits in split
//    order: M = max m_s, L = Σ exp(m_s - M) l_s, out = Σ exp(m_s - M) acc_s
//    / (L == 0 ? 1 : L).  No atomics anywhere; a row with no visible key in
//    any split gets exactly 0.
//
// MMA path (bf16 with Sq·G >= 64 and hd in {64, 128}: prefill, long
// chunks).  A causal prefill at S=2048, 24 heads, hd=128 does 4·S²·hd·H/2
// operations (26 GFLOP, 26 µs at 989 TFLOP/s bf16) on 25 MB, so the tensor
// cores bound it, and the softmax's instructions between the products:
//  * flash_fwd_mma_kernel: one warpgroup (128 threads) owns 64 consecutive
//    rows of one (batch row, KV head), each row with its own q_pos (a query
//    may straddle two blocks), and walks the 64-key tiles that the vote
//    over its positions keeps, through a ring of kMmaStages stages filled
//    by cp.async in the 128-byte swizzle that wgmma reads (no bank
//    conflicts, no ldmatrix).  Q stays in registers as wgmma A fragments.
//    S = Q·Kᵀ is wgmma m64n64k16 with K as the K-major B operand; O += P·V
//    is wgmma m64n64k16 per 64 output dimensions with V as the transposed
//    (MN-major) B operand and P from registers.
//  * The online softmax runs on the accumulator layout: a thread holds two
//    rows, a row's max and sum reduce over the four lanes that share it.  m
//    is kept in unscaled score units and p = 2^(s·c - m·c), c = scale·log2 e,
//    one FFMA and one ex2.approx (relative error ~2⁻²²) an entry.  A tile
//    that every row sees whole (the vote marks it) takes no mask, and O is
//    rescaled only when some row's max moved.
//  * P keeps float32 precision, as in the Pallas kernel and the plain
//    version: it is split into bf16 hi + lo and both go through P·V, which
//    keeps ~16 bits of p (a bf16 p alone would err by 2⁻⁸·|p v| a term).
//    Q·Kᵀ on bf16 inputs accumulates exact products in float32.
//  * Registers are capped so that kMmaBlocksPerSM = 3 blocks share an SM
//    (the softmax of one hides the products and copies of another), and
//    blocks start with the last row block, whose causal rows see the most
//    tiles, so the short blocks fill in at the end.
//
// Row independence: every sum of a row (the dot over hd, the warp trees,
// the tile and split order, the MMA's row) is fixed by (Sq, G, hd, Sk) and
// the plan alone; nothing depends on B or on which tiles a block skipped,
// and there are no atomics.  The softmax updates use explicit rounding
// intrinsics (__fmul_rn, __fadd_rn, ...) so the compiler cannot contract
// them into FMAs differently for a warp's unrolled row slots.  So a batch
// row computes bitwise the same alone and in a batch, which the serving
// engine's staggered-admission and chunked-prefill invariants need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // 4 warps; the MMA path's warpgroup
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoWindow = -2147483647 - 1;  // INT_MIN: no window given

// split path
constexpr int kTileK = 32;               // keys per tile: one per lane
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows a block
constexpr int kStages = 2;
constexpr int kSpan = 1024;             // keys whose positions a block
                                         // stages in shared memory at once

// MMA path
constexpr int kMmaRows = 64;             // one wgmma M
constexpr int kMmaKeys = 64;             // keys per tile (one wgmma N)
constexpr int kMmaStages = 2;
constexpr int kMmaBlocksPerSM = 3;       // caps registers at 168 a thread
constexpr int kSwizzleBytes = 1024;      // one 128-byte-swizzle atom: 8 rows

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;         // elements per 16 bytes
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

// `window` is kNoWindow when none is given
__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window != kNoWindow) ok = ok && (long long)kp > (long long)qp - window;
  return ok;
}

// Whether some row with a position in [lo, hi] may see key position kp: a
// superset of the rows' own tests, used only to skip tiles.
__device__ __forceinline__ bool maybe_visible(int kp, int lo, int hi,
                                              int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= hi;
  if (window != kNoWindow) ok = ok && (long long)kp > (long long)lo - window;
  return ok;
}

// 2^x in one MUFU instruction (relative error ~2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronous; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The block's position range [lo, hi] over its live rows (qps[r] for r <
// nlive), reduced over all threads; needs qlim[2 * kWarps] of scratch.
__device__ __forceinline__ void block_range(const int* qps, int nlive,
                                            int* qlim, int& lo, int& hi) {
  lo = 0x7fffffff;
  hi = -0x7fffffff - 1;
  for (int r = threadIdx.x; r < nlive; r += kThreads) {
    lo = min(lo, qps[r]);
    hi = max(hi, qps[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    qlim[2 * warp] = lo;
    qlim[2 * warp + 1] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, qlim[2 * w]);
    hi = max(hi, qlim[2 * w + 1]);
  }
}

// Warp 0 writes the indices of the set flags[0..n) to list in order and
// their count to *count.
__device__ __forceinline__ void compact(const int* flags, int n, int* list,
                                        int* count) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int total = 0;
  for (int c = 0; c < n; c += 32) {
    const bool on = c + lane < n && flags[c + lane];
    const unsigned bal = __ballot_sync(kFull, on);
    if (on) list[total + __popc(bal & ((1u << lane) - 1u))] = c + lane;
    total += __popc(bal);
  }
  if (lane == 0) *count = total;
}

// ------------------------------------------------------------ split path
template <typename T, int HD>
struct SplitSmem {
  static constexpr int kRowBytes = HD * (int)sizeof(T) + 16;  // padded row
  static constexpr int kTileBytes = kTileK * kRowBytes;
  static constexpr int kQBytes = kRows * HD * 4;
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;
  static size_t bytes(int split_len) {
    // q rows, K/V ring, a span's positions, tile flags and list, the
    // rows' positions and the block range
    const int span = split_len < kSpan ? split_len : kSpan;
    return kQBytes + kRingBytes + 4 * (span + 2 * (span / kTileK)
                                       + kRows + 2 * kWarps + 1);
  }
};

// grid (nsplit, ceil(Sq·G / kRows), B·KH), kThreads threads; partials
// ml[(bk, f, split)] = (m, l), acc[(bk, f, split)][HD]
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int sq, int sk, int nh,
                       int kh, int causal, int window, float scale,
                       int split_len) {
  using S = SplitSmem<T, HD>;
  constexpr int kPer = HD / 32;          // output dimensions per lane
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kChunks = HD / kVec;     // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                  // [kRows][HD]
  unsigned char* ring = smem + S::kQBytes;                     // [stage][K|V]
  int* kps = reinterpret_cast<int*>(ring + S::kRingBytes);     // [span]
  const int span = min(split_len, kSpan);
  int* flags = kps + span;
  int* list = flags + span / kTileK;
  int* qps = list + span / kTileK;                             // [kRows]
  int* qlim = qps + kRows;
  int* nvis_s = qlim + 2 * kWarps;

  const int g = nh / kh;
  const int nsplit = gridDim.x, split = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int bk = blockIdx.z, b = bk / kh, kvh = bk % kh;
  const int nrows = sq * g;
  const int nlive = min(kRows, nrows - row0);
  const int key0 = split * split_len;
  const int nkeys = max(0, min(split_len, sk - key0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < nlive * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, f = row0 + r;
    qs[idx] = Elem<T>::to_f32(
        q[(((size_t)b * sq + f / g) * nh + kvh * g + f % g) * HD + d]);
  }
  if (threadIdx.x < nlive)
    qps[threadIdx.x] = q_pos[(size_t)b * sq + (row0 + threadIdx.x) / g];
  __syncthreads();
  int lo, hi;
  block_range(qps, nlive, qlim, lo, hi);

  bool live[kRowsPerWarp];
  int qp[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPer];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp + kWarps * r;
    live[r] = row < nlive;
    qp[r] = live[r] ? qps[row] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[r][t] = 0.f;
  }

  // a thread copies chunk `part` of key rows j0, j0 + kStep, ... of a tile
  constexpr int kStep = kThreads / kChunks;
  const int part = threadIdx.x % kChunks, j0 = threadIdx.x / kChunks;
  const size_t key_stride = (size_t)kh * HD;
  const size_t src0 = ((size_t)b * sk + key0) * key_stride + (size_t)kvh * HD + part * kVec;
  const uint32_t dst0 = smem_u32(ring) + j0 * S::kRowBytes + part * 16;

  // The split's keys in order, kSpan at a time (one span unless split_len
  // > kSpan): the span's positions, the vote, then its visible tiles.
  for (int c0 = 0; c0 < nkeys; c0 += kSpan) {
    const int ckeys = min(kSpan, nkeys - c0);
    const int ntiles = (ckeys + kTileK - 1) / kTileK;
    __syncthreads();                     // the last span's smem is read
    for (int j = threadIdx.x; j < ntiles * kTileK; j += kThreads)
      kps[j] = j < ckeys ? kv_pos[(size_t)b * sk + key0 + c0 + j] : -1;
    __syncthreads();
    for (int t = warp; t < ntiles; t += kWarps) {
      const bool any = __any_sync(
          kFull, maybe_visible(kps[t * kTileK + lane], lo, hi, causal, window));
      if (lane == 0) flags[t] = any;
    }
    __syncthreads();
    compact(flags, ntiles, list, nvis_s);
    __syncthreads();
    const int nvis = *nvis_s;

    // tile i of the list into stage i % kStages; always one commit group
    auto issue = [&](int i) {
      if (i < nvis) {
        const int t0 = c0 + list[i] * kTileK;
        const uint32_t dst = dst0 + (i % kStages) * 2 * S::kTileBytes;
#pragma unroll
        for (int it = 0; it < kTileK / kStep; ++it) {
          const int j = j0 + it * kStep;
          const bool valid = t0 + j < nkeys;
          const size_t off = valid ? src0 + (size_t)(t0 + j) * key_stride : 0;
          const uint32_t d = dst + it * kStep * S::kRowBytes;
          cp_async16(d, k + off, valid);
          cp_async16(d + S::kTileBytes, v + off, valid);
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue(i);
    for (int i = 0; i < nvis; ++i) {
      cp_async_wait<kStages - 2>();      // tile i has landed (this thread's part)
      __syncthreads();                   // ... everyone's; stage i-1 is free
      issue(i + kStages - 1);
      const unsigned char* st = ring + (i % kStages) * 2 * S::kTileBytes;
      const T* kt = reinterpret_cast<const T*>(st + lane * S::kRowBytes);
      const int kp = kps[list[i] * kTileK + lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (!live[r]) continue;          // uniform across the warp
        const float* qrow = qs + (warp + kWarps * r) * HD;
        const bool ok = visible(kp, qp[r], causal, window);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          float kf[kVec];
          Elem<T>::unpack(*reinterpret_cast<const uint4*>(kt + c * kVec), kf);
#pragma unroll
          for (int e = 0; e < kVec; ++e) s = fmaf(qrow[c * kVec + e], kf[e], s);
        }
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
          const T* vrow = reinterpret_cast<const T*>(st + S::kTileBytes + j * S::kRowBytes);
#pragma unroll
          for (int t = 0; t < kPer; ++t)
            pv[t] = fmaf(pj, Elem<T>::to_f32(vrow[lane * kPer + t]), pv[t]);
        }
#pragma unroll
        for (int t = 0; t < kPer; ++t) acc[r][t] = __fadd_rn(__fmul_rn(corr, acc[r][t]), pv[t]);
        m[r] = m_new;
      }
    }
    cp_async_wait<0>();                  // nothing in flight past the span
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!live[r]) continue;
    const size_t idx = ((size_t)bk * nrows + row0 + warp + kWarps * r) * nsplit + split;
    if (lane == 0) {
      part_ml[2 * idx] = m[r];
      part_ml[2 * idx + 1] = l[r];
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) part_acc[idx * HD + lane * kPer + t] = acc[r][t];
  }
}

// grid (ceil(Sq·G / kWarps), B·KH), kThreads threads, kWarps · nsplit
// floats of dynamic shared memory: one warp a row.  The lanes find M and
// the weights exp(m_s - M) in parallel; the sums then run over the splits
// in split order, their loads independent of the chain.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_merge_kernel(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc, T* __restrict__ out,
                       int sq, int nh, int kh, int nsplit) {
  constexpr int kPer = HD / 32;
  extern __shared__ float weights[];
  const int g = nh / kh, nrows = sq * g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= nrows) return;
  const int bk = blockIdx.y, b = bk / kh, kvh = bk % kh;
  const size_t base = ((size_t)bk * nrows + f) * nsplit;
  float* w = weights + warp * nsplit;
  float mx = kNegInf;
  for (int s = lane; s < nsplit; s += 32) mx = fmaxf(mx, part_ml[2 * (base + s)]);
  mx = warp_max(mx);
  for (int s = lane; s < nsplit; s += 32) w[s] = expf(__fsub_rn(part_ml[2 * (base + s)], mx));
  __syncwarp();
  float sum = 0.f, acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    sum = __fadd_rn(sum, __fmul_rn(w[s], part_ml[2 * (base + s) + 1]));
    const float* a = part_acc + (base + s) * HD + lane * kPer;
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[t] = __fadd_rn(acc[t], __fmul_rn(w[s], a[t]));
  }
  const float denom = sum == 0.f ? 1.f : sum;
  T* o = out + (((size_t)b * sq + f / g) * nh + kvh * g + f % g) * HD + lane * kPer;
#pragma unroll
  for (int t = 0; t < kPer; ++t) o[t] = Elem<T>::from_f32(__fdiv_rn(acc[t], denom));
}

// -------------------------------------------------------------- MMA path
// wgmma operand descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (128B swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across an
// asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64×64 f32) = A (64×16 bf16, registers) · B (16×64 bf16, shared
// memory) [+ D]; B K-major (TransB 0) or MN-major (TransB 1)
template <int TransB>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate),
        "n"(TransB)
      : "memory");
}

template <int HD>
struct MmaSmem {
  // a K or V tile: HD / 64 column blocks of [64 keys][64 dims] bf16, each
  // row 128 bytes with its 16-byte chunks swizzled (chunk c of row j at
  // c ^ (j % 8)), the layout of wgmma's 128-byte swizzle
  static constexpr int kBlockBytes = kMmaKeys * 128;
  static constexpr int kTileBytes = (HD / 64) * kBlockBytes;
  static constexpr int kRingBytes = kMmaStages * 2 * kTileBytes;
  static size_t bytes(int ntiles) {
    // alignment slack, K/V ring, the ring's positions, tile flags and
    // list, the rows' positions and the block range
    return kSwizzleBytes + kRingBytes +
           4 * (kMmaStages * kMmaKeys + 2 * ntiles + kMmaRows + 2 * kWarps + 1);
  }
};

// grid (B·KH, ceil(Sq·G / 64)), 128 threads (one warpgroup), bf16
template <int HD>
__global__ void __launch_bounds__(kThreads, kMmaBlocksPerSM)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                     __nv_bfloat16* __restrict__ out, int sq, int sk, int nh,
                     int kh, int causal, int window, float scale) {
  using S = MmaSmem<HD>;
  constexpr int kHalves = HD / 64;
  constexpr int kSteps = HD / 16;        // k16 steps of Q·Kᵀ
  constexpr int kChunks = HD / 8;        // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is on shared-memory address bits, so align the ring there
  unsigned char* ring = smem_raw + ((kSwizzleBytes - smem_u32(smem_raw) % kSwizzleBytes)
                                    % kSwizzleBytes);
  int* kps = reinterpret_cast<int*>(ring + S::kRingBytes);   // [stage][64]
  const int ntiles = (sk + kMmaKeys - 1) / kMmaKeys;
  int* flags = kps + kMmaStages * kMmaKeys;
  int* list = flags + ntiles;
  int* qps = list + ntiles;                                   // [64]
  int* qlim = qps + kMmaRows;
  int* nvis_s = qlim + 2 * kWarps;

  const int g = nh / kh, nrows = sq * g;
  const float scale_log2 = __fmul_rn(scale, 1.4426950408889634f);
  // blocks start in grid order, x fastest: every (batch row, KV head) of
  // the last row block first, whose causal rows see the most tiles
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;
  const int bk = blockIdx.x, b = bk / kh, kvh = bk % kh;
  const int nlive = min(kMmaRows, nrows - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;

  if (tid < nlive) qps[tid] = q_pos[(size_t)b * sq + (row0 + tid) / g];
  __syncthreads();
  int lo, hi;
  block_range(qps, nlive, qlim, lo, hi);
  // flags[t]: 0 no row sees a key of tile t, 1 some row may, 3 every
  // live row sees every key of it (no mask needed)
  // a warp votes on 4 tiles a pass, their positions loaded together
  for (int t0 = 4 * warp; t0 < ntiles; t0 += 4 * kWarps) {
    int kp[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = (t0 + u) * kMmaKeys + 32 * h + lane;
        kp[u][h] = key < sk ? kv_pos[(size_t)b * sk + key] : -1;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bool any = false, all = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        any = any || maybe_visible(kp[u][h], lo, hi, causal, window);
        all = all && visible(kp[u][h], lo, causal, kNoWindow) &&
              visible(kp[u][h], hi, 0, window);
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

  // this thread's two rows (accumulator rows gid and gid + 8 of its warp)
  const int rr[2] = {warp * 16 + gid, warp * 16 + gid + 8};
  bool live[2];
  int qp[2];
  const __nv_bfloat16* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = row0 + rr[i];
    live[i] = rr[i] < nlive;
    qp[i] = live[i] ? qps[rr[i]] : 0;
    qrow[i] = q + (((size_t)b * sq + f / g) * nh + kvh * g + f % g) * HD;
  }
  // Q as wgmma A fragments: step kk holds (row, dims 16kk + 2tq + {0,1}),
  // (row + 8, same), (row, + 8), (row + 8, + 8)
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e & 1, d = 16 * kk + 2 * tq + 8 * (e >> 1);
      qf[kk][e] = live[i] ? *reinterpret_cast<const uint32_t*>(qrow[i] + d) : 0u;
    }

  float o[kHalves][32];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[h][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // a thread copies chunk ch of key rows j0, j0 + kStep, ... of a tile;
  // (j0 + n·kStep) % 8 = j0 % 8, so its swizzled column is fixed
  constexpr int kStep = kThreads / kChunks;
  const int ch = tid % kChunks, j0 = tid / kChunks;
  const size_t key_stride = (size_t)kh * HD;
  const size_t src0 = (size_t)b * sk * key_stride + (size_t)kvh * HD + ch * 8;
  const uint32_t dst0 = smem_u32(ring) + (ch >> 3) * S::kBlockBytes + j0 * 128 +
                        (((ch & 7) ^ (j0 & 7)) << 4);
  auto issue = [&](int i) {
    if (i < nvis) {
      const int key0 = list[i] * kMmaKeys, stage = i % kMmaStages;
      const uint32_t dst = dst0 + stage * 2 * S::kTileBytes;
#pragma unroll
      for (int it = 0; it < kMmaKeys / kStep; ++it) {
        const int key = key0 + j0 + it * kStep;
        const bool valid = key < sk;
        const size_t off = valid ? src0 + (size_t)key * key_stride : 0;
        cp_async16(dst + it * kStep * 128, k + off, valid);
        cp_async16(dst + it * kStep * 128 + S::kTileBytes, v + off, valid);
      }
      if (tid < kMmaKeys) {
        const bool valid = key0 + tid < sk;
        cp_async4(smem_u32(kps + stage * kMmaKeys + tid),
                  kv_pos + (valid ? (size_t)b * sk + key0 + tid : 0), valid);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) issue(i);
  for (int i = 0; i < nvis; ++i) {
    cp_async_wait<kMmaStages - 2>();
    fence_async_smem();
    __syncthreads();
    issue(i + kMmaStages - 1);
    const int stage = i % kMmaStages, key0 = list[i] * kMmaKeys;
    const uint32_t kb = smem_u32(ring + stage * 2 * S::kTileBytes);
    const uint32_t vb = kb + S::kTileBytes;
    const int* kp = kps + stage * kMmaKeys;

    // S = Q·Kᵀ: B = K tile, K-major; step kk reads dims 16kk.. of every key
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_64x64x16<0>(s, qf[kk],
                        wgmma_desc(kb + (kk >> 2) * S::kBlockBytes + (kk & 3) * 32,
                                   16, kSwizzleBytes),
                        kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // s[4j + 2i + c]: row rr[i], key 8j + 2tq + c of the tile.  m is kept
    // in unscaled score units: exp(scale (s - m)) = 2^(s c - m c)
    unsigned ok = kFull;
    if (flags[list[i]] != 3) {           // a tile some row sees in part
      ok = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * tq + c;
          const int kpos = key0 + col < sk ? kp[col] : -1;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 4 * j + 2 * i + c;
            const bool seen = live[i] && visible(kpos, qp[i], causal, window);
            ok |= (unsigned)seen << e;
            s[e] = seen ? s[e] : kNegInf;
          }
        }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float corr[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i]);
      corr[i] = exp2_approx(__fmul_rn(__fsub_rn(m[i], mx[i]), scale_log2));
      mc[i] = -__fmul_rn(mx[i], scale_log2);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      s[e] = (ok >> e) & 1u ? exp2_approx(__fmaf_rn(s[e], scale_log2, mc[i])) : 0.f;
      sum[i] = __fadd_rn(sum[i], s[e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(kFull, sum[i], 1));
      sum[i] = __fadd_rn(sum[i], __shfl_xor_sync(kFull, sum[i], 2));
      l[i] = __fadd_rn(__fmul_rn(corr[i], l[i]), sum[i]);
      m[i] = mx[i];
    }
    if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f))   // x·1 = x
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[h][e] = __fmul_rn(o[h][e], corr[(e >> 1) & 1]);

    // P as A fragments, p = hi + lo in bf16: step kk (keys 16kk..) takes
    // accumulator columns j = 2kk (keys + 0..7) and 2kk + 1 (+ 8..15)
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[e], s[e + 1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__fsub_rn(s[e], hf.x),
                                                        __fsub_rn(s[e + 1], hf.y));
        phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
      }

    // O += P·V: B = V tile, MN-major; step kk reads keys 16kk..16kk+15
#pragma unroll
    for (int h = 0; h < kHalves; ++h) pin(o[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const uint64_t desc = wgmma_desc(vb + h * S::kBlockBytes + kk * 16 * 128,
                                         S::kBlockBytes, kSwizzleBytes);
        wgmma_64x64x16<1>(o[h], phi[kk], desc, 1);
        wgmma_64x64x16<1>(o[h], plo[kk], desc, 1);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) pin(o[h]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    const int f = row0 + rr[i];
    __nv_bfloat16* orow = out + (((size_t)b * sq + f / g) * nh + kvh * g + f % g) * HD;
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 4 * j + 2 * i;
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * h + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(__fdiv_rn(o[h][e], denom),
                                  __fdiv_rn(o[h][e + 1], denom));
      }
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v;
  const int *q_pos, *kv_pos;
  void* out;
  float* scratch;
  int b, sq, sk, nh, kh, causal, window, split_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_split(const Args& a) {
  const int nrows = a.sq * (a.nh / a.kh);
  const int nsplit = a.sk > 0 ? (a.sk + a.split_len - 1) / a.split_len : 1;
  const dim3 grid(nsplit, (nrows + kRows - 1) / kRows, a.b * a.kh);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const size_t smem = SplitSmem<T, HD>::bytes(a.split_len);
  cudaError_t err = allow_smem(flash_fwd_split_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  float* part_ml = a.scratch;
  float* part_acc = a.scratch + 2 * (size_t)a.b * a.kh * nrows * nsplit;
  flash_fwd_split_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.q_pos, a.kv_pos, part_ml, part_acc, a.sq,
      a.sk, a.nh, a.kh, a.causal, a.window, a.scale, a.split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mgrid((nrows + kWarps - 1) / kWarps, a.b * a.kh);
  const size_t msmem = (size_t)kWarps * nsplit * sizeof(float);
  err = allow_smem(flash_fwd_merge_kernel<T, HD>, msmem);
  if (err != cudaSuccess) return err;
  flash_fwd_merge_kernel<T, HD><<<mgrid, kThreads, msmem, a.stream>>>(
      part_ml, part_acc, static_cast<T*>(a.out), a.sq, a.nh, a.kh, nsplit);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const Args& a) {
  const int nrows = a.sq * (a.nh / a.kh);
  const dim3 grid(a.b * a.kh, (nrows + kMmaRows - 1) / kMmaRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = MmaSmem<HD>::bytes((a.sk + kMmaKeys - 1) / kMmaKeys);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.q_pos, a.kv_pos,
      static_cast<__nv_bfloat16*>(a.out), a.sq, a.sk, a.nh, a.kh, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split_type(const Args& a, int hd) {
  switch (hd) {
    case 32: return launch_split<T, 32>(a);
    case 64: return launch_split<T, 64>(a);
    case 128: return launch_split<T, 128>(a);
    case 256: return launch_split<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; has_window 0 means no window, else
// keys at positions <= q_pos - window are hidden (window > INT_MIN; any
// sign, as the Pallas kernel).  path: 0 =
// split (scratch holds B·KH·Sq·G·nsplit·(hd + 2) floats, nsplit =
// ceil(Sk / split_len), at least 1), 1 = MMA (bf16, hd 64 or 128; scratch
// unused).  Returns the launches' cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* kv_pos,
                                   void* out, void* scratch, int b, int sq,
                                   int sk, int nh, int kh, int hd, int dtype,
                                   int causal, int has_window, int window,
                                   float scale, int path, int split_len,
                                   void* stream) {
  if (b < 1 || sq < 1 || sk < 0 || kh < 1 || nh % kh != 0) return cudaErrorInvalidValue;
  if (has_window && window == kNoWindow) return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos),
               out, static_cast<float*>(scratch), b, sq, sk, nh, kh, causal,
               has_window ? window : kNoWindow, split_len, scale,
               static_cast<cudaStream_t>(stream)};
  if (path == 1) {
    if (dtype != 1) return cudaErrorInvalidValue;
    if (hd == 64) return launch_mma<64>(a);
    if (hd == 128) return launch_mma<128>(a);
    return cudaErrorInvalidValue;
  }
  if (path != 0 || split_len < kTileK || split_len % kTileK != 0 ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch_split_type<float>(a, hd);
  if (dtype == 1) return launch_split_type<__nv_bfloat16>(a, hd);
  return cudaErrorInvalidValue;
}
