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
// k and writes 1.05 MB of s for 2·B·NH·L·d = 67 MFLOP: 1.6 µs of bytes at
// 3.35 TB/s against 0.07 µs of bf16 tensor-core work.  K9 reads the scores
// and V of the 10,495 visible (row, slot) pairs, ~1.0 µs.  Both are bytes,
// and small, so what costs is latency: each kernel has to put its whole
// cache slice in flight at once (about one wave of blocks that issue every
// copy before they compute), keep every intermediate on chip, and keep each
// warp's chain of dependent steps short (straight-line loops, no branch
// inside them, so the compiler can overlap later loads with earlier
// products).  kernel.py::decode_plan picks the path from (dtype, NH, KH, d).
//
// MMA path (bf16, d % 16 == 0: every head-dim shard of the port's configs):
//
//  * flash_decode_scores_mma_kernel<D>: a block per (128 keys, KV head,
//    batch row), 8 warps of 16 keys; D = d for the widths the configs take
//    (16–256: loops unrolled, copies indexed without division), 0 for any
//    other d.  The block copies q's G rows into shared memory first (16-byte
//    cp.async, zero rows up to a multiple of 16) and each warp its key rows,
//    one commit group per n-tile of 8 keys; a warp computes and stores an
//    n-tile as soon as its rows land.  Rows are padded by 16 bytes, so the 8
//    rows an ldmatrix reads hit 8 distinct 16-byte bank groups at every d
//    (d/8 + 1 is odd).  mma.sync.m16n8k16 (bf16 in, float32 sums): the G
//    query heads are the M rows (⌈G/16⌉ row tiles), keys are N, channels K;
//    a cache row (key, channels contiguous) is already the .col B operand
//    (ldmatrix, no transpose); q's A fragments come once per warp into
//    registers (ldmatrix.x4).  Scores leave the accumulators as float2
//    stores.  128 blocks at the shape above: one wave on 132 SMs.  bf16
//    products are exact in float32, so only the order of the sums differs
//    from the plain version.
//  * flash_decode_pv_mma_kernel<C>: one launch, a thread block cluster of C
//    blocks per (batch row, KV head) (kernel.py::decode_cluster: 16 at
//    L=2048, 4 at 512, at least 128 keys a block, at most 16 or 8 where the
//    card refuses 16), block r owning keys [r·kpb, (r+1)·kpb), in rounds of
//    128, 8 warps.  A block (1) reads its slots' kv_pos and, if no slot is
//    visible, reads neither scores nor V (the idle row, a ring's empty
//    tail); otherwise it copies (cp.async) the scores and then the V rows of
//    the 16-key tiles that hold a visible slot (the others zero-filled,
//    which reads nothing), scores first; (2) takes each head's max of
//    scale·s over its visible keys; (3) the cluster exchanges the maxima
//    through distributed shared memory and every block takes the row's max
//    M over the ranks in order; (4) P = 2^((scale·s − M)·log2 e) in float32
//    (one MUFU instruction) and its sum l; (5) P·V on mma.sync.m16n8k16 with
//    V's tiles through ldmatrix.trans and P as a bf16 hi + lo pair (one
//    bf16 rounding of P misses K9's limit:
//    tests/test_torch_split_decode_plan.py), the two halves into
//    accumulators of their own, added at the round's end; (6) the (G × d)
//    partial stays in shared memory; (7) each block writes its partial's
//    shares and its l into their owner blocks' shared memory, and after a
//    cluster barrier block r adds its share of the outputs over the blocks
//    in rank order, divides by L (0 where L = 0) and stores.  No scratch,
//    no merge kernel, no atomics: the bits do not depend on the launch
//    order.  __launch_bounds__(256, 2) holds it to 128 registers, so two
//    blocks share an SM and a cluster of 16 fits one GPC (one block an SM
//    left some clusters waiting: slower).
//
// FMA path (float32, or d not a multiple of 16): the first versions, kept.
//
//  * flash_decode_scores_kernel: a block owns (64 keys, KV head, batch
//    row): it stages its G query rows and its 64 key rows in shared memory
//    as float32 (rows padded by one float, so the lanes' reads of 32
//    consecutive key rows hit 32 banks) and each thread computes (head,
//    key) dot products in channel order.
//  * flash_decode_pv_split_kernel: a block owns (kSplit = 64 keys, KV head,
//    batch row) and all G heads: it stages its scores (masked ones at
//    -inf), takes each head's max m and p = exp(scale·s - m) (a warp a
//    head), stages its V rows as float32 and writes every head's partial
//    (m, l = Σ p, acc = P·V) to a wrapper-allocated scratch (B, KH,
//    splits, G, d + 2); m = -inf and l = acc = 0 for a split that the head
//    does not see.
//  * flash_decode_pv_merge_kernel: a block per (head, batch row) combines
//    the splits in split order: M = max m_s, L = Σ exp(m_s - M) l_s, out =
//    Σ exp(m_s - M) acc_s / L (0 where no split saw a key).
//
// Both C entries take the path (0 FMA, 1 MMA) and return the first CUDA
// error (a refused launch) or 0; the wrappers (kernel.py) check shapes,
// types, contiguity and the MMA path's 16-byte alignment, allocate the
// outputs and the FMA path's scratch, and raise on an error.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <math.h>

#include "wgmma.cuh"  // smem_u32, cp_async16/4, cp_async_commit/wait, exp2_approx, kFull

namespace {

constexpr int kScoreKeys = 64;      // keys of a K8 FMA block
constexpr int kScoreThreads = 256;
constexpr int kSplit = 64;          // keys of a K9 FMA split block
constexpr int kSplitThreads = 256;
constexpr int kMergeThreads = 128;
constexpr int kMmaKeys = 128;       // keys of a K8 MMA block
constexpr int kMmaThreads = 256;
constexpr int kWarpKeys = kMmaKeys / (kMmaThreads / 32);  // a K8 warp's keys
constexpr int kStages = kWarpKeys / 8;  // a K8 warp's commit groups: its n-tiles
constexpr int kQSteps = 16;         // k-steps of q's fragments held at once
constexpr int kPvThreads = 256;
constexpr int kPvNt = 2;            // n-tiles a K9 warp holds accumulators for
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPvRound = 128;       // keys a K9 MMA block stages at once (DECODE_ROUND)
constexpr int kPvTile = 16;         // keys of a k-step (DECODE_TILE)
constexpr int kClusterMax = 16;     // most blocks of a K9 cluster (DECODE_CLUSTER)
constexpr int kMaxStaticSmem = 48 * 1024;
static_assert(kStages >= 1 && kStages <= 3, "cp_async_wait_upto takes 0-3 pending groups");
static_assert(kPvThreads >= kPvRound, "a K9 MMA round stages one slot a thread");
static_assert(kPvRound == 4 * 2 * kPvTile, "four warps' ballots cover a round's tiles");
constexpr int kMaxSmem = 232448;
constexpr int kDevices = 64;        // devices fit_smem remembers its attributes for

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

template <typename T>
__global__ void flash_decode_pv_split_kernel(const float* __restrict__ s,
                                             const T* __restrict__ v,
                                             const int* __restrict__ q_pos,
                                             const int* __restrict__ kv_pos,
                                             float* __restrict__ scratch, int len, int nh,
                                             int kh, int d, int causal, int window,
                                             float scale) {
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
    if (j < keys && visible(kp[j], iq, causal, window))
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

// ---------------------------------------------------------------- MMA path
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d (16×8 f32) += a (16×16 bf16, row) · b (16×8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// s[h, j] and s[h, j + 1] of one score row (length len), those that exist
__device__ __forceinline__ void store_pair(float* row, int j, int len, float x0, float x1) {
  if (j + 1 < len && (len & 1) == 0) {
    *reinterpret_cast<float2*>(row + j) = make_float2(x0, x1);
  } else {
    if (j < len) row[j] = x0;
    if (j + 1 < len) row[j + 1] = x1;
  }
}

// K8's MMA kernel for a head-dim slice of D channels (D > 0: unrolled at
// compile time, the widths the configs take; 0: any d % 16 == 0).  Shared
// memory: q's G rows (padded to row tiles of 16, zero-filled) then the
// block's key rows, each row padded by 16 bytes.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_decode_scores_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k, float* __restrict__ s,
                               int len, int nh, int kh, int d_arg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = D > 0 ? D : d_arg;
  const int g = nh / kh, gp = (g + 15) / 16 * 16, ksteps = d / 16, nc = d / 8;
  const int rs = 2 * d + 16;  // padded row, bytes
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int w0 = blockIdx.x * kMmaKeys + warp * kWarpKeys;  // the warp's first key
  const uint32_t qs = smem_u32(smem_raw);
  const uint32_t ks = qs + gp * rs + warp * kWarpKeys * rs;
  const __nv_bfloat16* qb = q + ((size_t)b * nh + (size_t)kvh * g) * d;
  // q's rows first (commit group 0), then the warp's key rows, one group
  // per n-tile of 8 keys
  for (int i = tid; i < gp * nc; i += kMmaThreads) {
    const int r = i / nc, c = i - r * nc;
    cp_async16(qs + r * rs + c * 16, r < g ? qb + (size_t)r * d + c * 8 : qb, r < g);
  }
  cp_async_commit();
  const size_t kstride = (size_t)kh * d;
  const __nv_bfloat16* kb = k + (size_t)b * len * kstride + (size_t)kvh * d;
#pragma unroll
  for (int nt = 0; nt < kStages; ++nt) {
    for (int i = lane; i < 8 * nc; i += 32) {
      const int r = nt * 8 + i / nc, c = i % nc;
      const bool ok = w0 + r < len;
      cp_async16(ks + r * rs + c * 16, ok ? kb + (size_t)(w0 + r) * kstride + c * 8 : kb, ok);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages>();  // q
  __syncthreads();
  if (w0 >= len) return;     // no block-wide barrier below
  float* sb = s + ((size_t)b * nh + (size_t)kvh * g) * len;
  constexpr int kQ = D > 0 ? (D / 16 < kQSteps ? D / 16 : kQSteps) : kQSteps;
  const bool whole = ksteps <= kQ;  // q's fragments fit the registers at once
  uint32_t qa[kQ][4];
  // lanes 8i..8i+7 address matrix i of an A fragment: rows + 8·(i % 2),
  // channels + 8·(i / 2)
  const uint32_t qrow = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 16;
  for (int m0 = 0; m0 < g; m0 += 16) {
    const int h0 = m0 + gid, h1 = h0 + 8;
    if (whole) {
#pragma unroll
      for (int t = 0; t < kQ; ++t)
        if (t < ksteps) ldmatrix_x4(qa[t], qrow + m0 * rs + t * 32);
    }
    // n-tile by n-tile as its rows land, so its scores leave while the
    // next rows are still on their way
#pragma unroll
    for (int nt = 0; nt < kStages; ++nt) {
      if (m0 == 0) {
        cp_async_wait_upto(kStages - 1 - nt);
        __syncwarp();
      }
      float acc[4] = {};
      // lanes 0–7 address the n-tile's rows at channels kk·16, 8–15 at + 8
      const uint32_t row = ks + (nt * 8 + (lane & 7)) * rs + ((lane >> 3) & 1) * 16;
      for (int k0 = 0; k0 < ksteps; k0 += kQ) {
        if (!whole) {
#pragma unroll
          for (int t = 0; t < kQ; ++t)
            if (k0 + t < ksteps) ldmatrix_x4(qa[t], qrow + m0 * rs + (k0 + t) * 32);
        }
#pragma unroll
        for (int t = 0; t < kQ; ++t) {
          if (k0 + t < ksteps) {
            uint32_t bf[2];
            ldmatrix_x2(bf, row + (k0 + t) * 32);
            mma_16816(acc, qa[t], bf[0], bf[1]);
          }
        }
      }
      const int j = w0 + nt * 8 + tig * 2;
      if (h0 < g) store_pair(sb + (size_t)h0 * len, j, len, acc[0], acc[1]);
      if (h1 < g) store_pair(sb + (size_t)h1 * len, j, len, acc[2], acc[3]);
    }
  }
}

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }

// A K9 MMA block's share of the (G × d) outputs: rounded up to 4 floats,
// so a float4 of the partial never straddles two owners.
__host__ __device__ constexpr int pv_share(int g, int d, int csize) {
  return ((g * d + csize - 1) / csize + 3) / 4 * 4;
}

// Byte offsets of a K9 MMA block's shared memory (the same in every block
// of a cluster, which reads the others' maxima and writes its partial and
// sums into theirs).  The partial's rows are d + 8 floats, so the float2
// stores from the accumulators hit 32 distinct banks.
struct PvLayout {
  int bm, ms, visw, bl, part, ss, ph, pl, v, recv, recvl, bytes;
  __host__ __device__ PvLayout(int g, int d, int csize) {
    const int gp = up16(g);
    bm = 0;                                          // [g] block max
    ms = up16(bm + 4 * g);                           // [g] the row's M
    visw = up16(ms + 4 * g);                         // [4] a round's ballots
    bl = visw + 16;                                  // [g] block Σ p
    part = up16(bl + 4 * g);                         // [g][d + 8] block P·V
    ss = up16(part + 4 * g * (d + 8));               // [g][kPvRound] scores
    ph = ss + 4 * g * kPvRound;                      // [gp][kPvRound + 8] bf16
    pl = ph + 2 * gp * (kPvRound + 8);
    v = pl + 2 * gp * (kPvRound + 8);                // [kPvRound][2d + 16 bytes]
    recv = v + kPvRound * (2 * d + 16);              // [csize][share]
    recvl = recv + 4 * csize * pv_share(g, d, csize);  // [csize][g]
    bytes = up16(recvl + 4 * csize * g);
  }
};

// A K9 MMA round's 128-bit visibility (warp w's ballot in visw[w]) into
// every thread's registers.  → the mask of its 16-key tiles that hold a
// visible slot.
__device__ __forceinline__ uint32_t pv_read_vis(uint32_t (&vw)[4], const uint32_t* visw) {
  uint32_t tmask = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    vw[w] = visw[w];
    tmask |= (uint32_t)((vw[w] & 0xffffu) != 0u) << (2 * w);
    tmask |= (uint32_t)((vw[w] >> 16) != 0u) << (2 * w + 1);
  }
  return tmask;
}

// A K9 MMA round's slots [c0, c0 + kPvRound), one a thread of the first
// four warps: their ballots of the visible ones, then (after a barrier)
// pv_read_vis.
__device__ __forceinline__ uint32_t pv_stage_vis(uint32_t (&vw)[4], uint32_t* visw,
                                                 const int* kp, int c0, int j1, int iq,
                                                 int causal, int window) {
  const int tid = threadIdx.x, j = c0 + tid;
  if (tid < kPvRound) {  // whole warps
    const bool seen = j < j1 && visible(kp[j], iq, causal, window);
    const unsigned bal = __ballot_sync(kFull, seen);
    if ((tid & 31) == 0) visw[tid >> 5] = bal;
  }
  __syncthreads();
  return pv_read_vis(vw, visw);
}

// The cp.async of a round's scores (g rows of kPvRound) for the tiles in
// tmask, 16 bytes a copy where the rows allow it.
__device__ __forceinline__ void pv_stage_s(uint32_t ss_u, uint32_t tmask, const float* sb, int g,
                                           int len, int c0, int j1) {
  const int tid = threadIdx.x;
  if ((len & 3) == 0) {
    for (int i = tid; i < g * (kPvRound / 4); i += kPvThreads) {
      const int h = i / (kPvRound / 4), r = 4 * (i % (kPvRound / 4));
      if (!((tmask >> (r / kPvTile)) & 1u)) continue;
      const bool ok = c0 + r < j1;
      cp_async16(ss_u + 4 * (h * kPvRound + r), ok ? sb + (size_t)h * len + c0 + r : sb, ok);
    }
  } else {
    for (int i = tid; i < g * kPvRound; i += kPvThreads) {
      const int h = i / kPvRound, r = i % kPvRound;
      if (!((tmask >> (r / kPvTile)) & 1u)) continue;
      const bool ok = c0 + r < j1;
      cp_async4(ss_u + 4 * i, ok ? sb + (size_t)h * len + c0 + r : sb, ok);
    }
  }
  cp_async_commit();
}

// The cp.async of the round's V rows: those of the tiles in tmask read,
// the others and those past the block's keys zero-filled (a copy of
// source size 0 reads nothing), so the products run over every tile and
// an unseen one adds exact zeros.
__device__ __forceinline__ void pv_stage_v(uint32_t v_u, uint32_t tmask,
                                           const __nv_bfloat16* vb, size_t vstride, int d,
                                           int c0, int j1) {
  const int tid = threadIdx.x, nc = d / 8, rs = 2 * d + 16;
  if (kPvThreads % nc == 0) {  // a thread keeps one 16-byte column
    const int c = tid % nc;
    for (int r = tid / nc; r < kPvRound; r += kPvThreads / nc) {
      const bool ok = c0 + r < j1 && ((tmask >> (r / kPvTile)) & 1u);
      cp_async16(v_u + r * rs + c * 16, ok ? vb + (size_t)(c0 + r) * vstride + c * 8 : vb, ok);
    }
  } else {
    for (int i = tid; i < kPvRound * nc; i += kPvThreads) {
      const int r = i / nc, c = i - r * nc;
      const bool ok = c0 + r < j1 && ((tmask >> (r / kPvTile)) & 1u);
      cp_async16(v_u + r * rs + c * 16, ok ? vb + (size_t)(c0 + r) * vstride + c * 8 : vb, ok);
    }
  }
  cp_async_commit();
}

// K9's MMA kernel, in a cluster of C blocks (the rank loops unrolled).  Two
// blocks an SM (at most 128 registers a thread): a cluster of 16 then fits
// the SMs of one GPC.
template <int C>
__global__ void __launch_bounds__(kPvThreads, 2)
flash_decode_pv_mma_kernel(const float* __restrict__ s, const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                           __nv_bfloat16* __restrict__ out, int len, int nh, int kh, int d,
                           int causal, int window, float scale, int kpb) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int csize = C;
  const int g = nh / kh, gp = up16(g), prs = kPvRound + 8, rs = 2 * d + 16, pd = d + 8;
  const int share = pv_share(g, d, csize);
  const PvLayout lay(g, d, csize);
  float* bm = reinterpret_cast<float*>(smem_raw + lay.bm);
  float* ms = reinterpret_cast<float*>(smem_raw + lay.ms);
  uint32_t* visw = reinterpret_cast<uint32_t*>(smem_raw + lay.visw);
  float* bl = reinterpret_cast<float*>(smem_raw + lay.bl);
  float* part = reinterpret_cast<float*>(smem_raw + lay.part);
  const float* ss = reinterpret_cast<const float*>(smem_raw + lay.ss);
  __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.ph);
  __nv_bfloat16* pl = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.pl);
  float* recv = reinterpret_cast<float*>(smem_raw + lay.recv);
  float* recvl = reinterpret_cast<float*>(smem_raw + lay.recvl);
  const uint32_t ss_u = smem_u32(ss), ph_u = smem_u32(ph), pl_u = smem_u32(pl);
  const uint32_t v_u = smem_u32(smem_raw + lay.v);
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, warps = kPvThreads / 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int iq = q_pos[b];
  const int* kp = kv_pos + (size_t)b * len;
  const float* sb = s + ((size_t)b * nh + (size_t)kvh * g) * len;
  const size_t vstride = (size_t)kh * d;
  const __nv_bfloat16* vb = v + (size_t)b * len * vstride + (size_t)kvh * d;
  const int j0 = rank * kpb, j1 = min(j0 + kpb, len);
  const int rounds = (max(j1 - j0, 0) + kPvRound - 1) / kPvRound;

  // (1) whether any slot of the block is visible, and the first round's
  // ballots
  bool mine = false;
  if (tid < kPvRound) {  // whole warps
    const bool seen = j0 + tid < j1 && visible(kp[j0 + tid], iq, causal, window);
    const unsigned bal = __ballot_sync(kFull, seen);
    if (lane == 0) visw[warp] = bal;
    mine = seen;
  }
  for (int j = j0 + kPvRound + tid; j < j1; j += kPvThreads)
    mine = mine || visible(kp[j], iq, causal, window);
  const bool any = __syncthreads_or(mine);
  for (int i = tid; i < (gp - g) * prs; i += kPvThreads) {
    ph[g * prs + i] = __float2bfloat16(0.f);
    pl[g * prs + i] = __float2bfloat16(0.f);
  }
  for (int h = tid; h < g; h += kPvThreads) {
    bl[h] = 0.f;
    bm[h] = -INFINITY;
  }
  uint32_t vw[4], tmask = 0;

  // (2) each head's max of scale·s over the block's visible keys, round
  // by round; the first round's V is already on its way
  for (int ri = 0; any && ri < rounds; ++ri) {
    const int c0 = j0 + ri * kPvRound;
    if (ri > 0) __syncthreads();  // the last round's scores are read
    tmask = ri == 0 ? pv_read_vis(vw, visw)
                    : pv_stage_vis(vw, visw, kp, c0, j1, iq, causal, window);
    pv_stage_s(ss_u, tmask, sb, g, len, c0, j1);
    if (ri == 0) {
      pv_stage_v(v_u, tmask, vb, vstride, d, c0, j1);
      cp_async_wait<1>();  // the scores; V may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int h0 = warp; h0 < g; h0 += 2 * warps) {  // two heads at once
      const int hs[2] = {h0, h0 + warps};
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = min(hs[e], g - 1);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float x = ss[h * kPvRound + 32 * w + lane] * scale;
          m[e] = (vw[w] >> lane) & 1u ? fmaxf(m[e], x) : m[e];
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        m[0] = fmaxf(m[0], __shfl_xor_sync(kFull, m[0], o));
        m[1] = fmaxf(m[1], __shfl_xor_sync(kFull, m[1], o));
      }
      if (lane == 0) {
        bm[hs[0]] = fmaxf(bm[hs[0]], m[0]);
        if (hs[1] < g) bm[hs[1]] = fmaxf(bm[hs[1]], m[1]);
      }
    }
  }
  // (3) the row's max over the cluster's blocks, in rank order
  cluster.sync();
  for (int h = tid; h < g; h += kPvThreads) {
    float m[C];
#pragma unroll
    for (int r = 0; r < C; ++r) m[r] = cluster.map_shared_rank(bm, r)[h];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, m[r]);
    ms[h] = mx;
  }
  if (rounds == 1) cp_async_wait<0>();  // the first round's V
  __syncthreads();

  const int nt_all = d / 8;
  const int nt_lo = warp * nt_all / warps, nt_hi = (warp + 1) * nt_all / warps;
  const int mi = lane >> 3;
  bool wrote = false;  // whether a round has written the partial yet
  for (int ri = 0; any && ri < rounds; ++ri) {
    const int c0 = j0 + ri * kPvRound;
    if (rounds > 1) {  // the max pass left the last round's slots
      tmask = pv_stage_vis(vw, visw, kp, c0, j1, iq, causal, window);
      pv_stage_s(ss_u, tmask, sb, g, len, c0, j1);
      if (ri > 0) pv_stage_v(v_u, tmask, vb, vstride, d, c0, j1);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (tmask != 0u) {
      // (4) P = exp(scale·s − M) as bf16 hi + lo (2^x in one MUFU
      // instruction), and l; a warp two heads at once
      for (int h0 = warp; h0 < g; h0 += 2 * warps) {
        const int hs[2] = {h0, h0 + warps};
        float x[2][4], lsum[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int w = 0; w < 4; ++w) x[e][w] = ss[min(hs[e], g - 1) * kPvRound + 32 * w + lane];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mh = ms[min(hs[e], g - 1)];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float t = (x[e][w] * scale - mh) * kLog2e;
            const float p = (vw[w] >> lane) & 1u ? exp2_approx(t) : 0.f;
            const __nv_bfloat16 hi = __float2bfloat16(p);
            x[e][w] = p;
            if (hs[e] < g) {
              ph[hs[e] * prs + 32 * w + lane] = hi;
              pl[hs[e] * prs + 32 * w + lane] = __float2bfloat16(p - __bfloat162float(hi));
            }
            lsum[e] += p;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          lsum[0] += __shfl_xor_sync(kFull, lsum[0], o);
          lsum[1] += __shfl_xor_sync(kFull, lsum[1], o);
        }
        if (lane == 0) {
          bl[hs[0]] += lsum[0];
          if (hs[1] < g) bl[hs[1]] += lsum[1];
        }
      }
      __syncthreads();
      // (5)-(6) P·V on the tensor cores, a warp a range of 8-channel
      // n-tiles: every tile of the round in order (an unseen one adds
      // zeros), the hi and lo halves of P into accumulators of their own
      // (two short chains, no branch: the loads of later tiles overlap the
      // products), added once at the end
      for (int m0 = 0; m0 < g; m0 += 16) {
        for (int n0 = nt_lo; n0 < nt_hi; n0 += kPvNt) {
          float ahi_acc[kPvNt][4] = {}, alo_acc[kPvNt][4] = {};
#pragma unroll
          for (int kk = 0; kk < kPvRound / kPvTile; ++kk) {
            uint32_t ahi[4], alo[4];
            const int row = m0 + (lane & 7) + (mi & 1) * 8, col = kk * 16 + (mi >> 1) * 8;
            ldmatrix_x4(ahi, ph_u + (row * prs + col) * 2);
            ldmatrix_x4(alo, pl_u + (row * prs + col) * 2);
            const uint32_t vrow = v_u + (kk * 16 + (lane & 15)) * rs;
#pragma unroll
            for (int t = 0; t < kPvNt; ++t) {
              if (n0 + t < nt_hi) {
                uint32_t bv[2];
                ldmatrix_x2_trans(bv, vrow + (n0 + t) * 16);
                mma_16816(ahi_acc[t], ahi, bv[0], bv[1]);
                mma_16816(alo_acc[t], alo, bv[0], bv[1]);
              }
            }
          }
          const int h0 = m0 + gid, h1 = h0 + 8;
#pragma unroll
          for (int t = 0; t < kPvNt; ++t) {
            if (n0 + t < nt_hi) {
              const int c = (n0 + t) * 8 + tig * 2;
              float acc[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[e] = ahi_acc[t][e] + alo_acc[t][e];
              float2* p0 = reinterpret_cast<float2*>(part + h0 * pd + c);
              float2* p1 = reinterpret_cast<float2*>(part + h1 * pd + c);
              if (wrote) {
                const float2 a0 = h0 < g ? *p0 : make_float2(0.f, 0.f);
                const float2 a1 = h1 < g ? *p1 : make_float2(0.f, 0.f);
                acc[0] += a0.x;
                acc[1] += a0.y;
                acc[2] += a1.x;
                acc[3] += a1.y;
              }
              if (h0 < g) *p0 = make_float2(acc[0], acc[1]);
              if (h1 < g) *p1 = make_float2(acc[2], acc[3]);
            }
          }
        }
      }
      wrote = true;
    }
    __syncthreads();  // the next round overwrites the ballots, scores, P and V
  }
  if (!wrote) {
    for (int i = tid; i < g * pd; i += kPvThreads) part[i] = 0.f;
    __syncthreads();
  }

  // (7) each block writes its partial's shares and its sums into their
  // owners' shared memory; after the barrier, block r adds the blocks'
  // shares of its outputs in rank order and divides by L (0 where no key
  // is visible).  Nothing is read across blocks after the barrier, so a
  // block may leave as soon as it is done.
  for (int o = 4 * tid; o < g * d; o += 4 * kPvThreads) {
    const int dst = o / share, h = o / d;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, dst) + rank * share + o -
                               dst * share) =
        *reinterpret_cast<const float4*>(part + h * pd + o - h * d);
  }
  for (int i = tid; i < csize * g; i += kPvThreads) {
    const int dst = i / g, h = i - dst * g;
    cluster.map_shared_rank(recvl, dst)[rank * g + h] = bl[h];
  }
  cluster.sync();
  const int o0 = rank * share, n = min(share, g * d - o0);
  for (int i = tid; i < n; i += kPvThreads) {
    const int o = o0 + i, h = o / d;
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      acc += recv[r * share + i];
      l += recvl[r * g + h];
    }
    out[((size_t)b * nh + (size_t)kvh * g) * d + o] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (and, with `wide`, a
// cluster over the portable 8).  `granted` is a static of the caller's
// instantiation: the most bytes allowed so far on each device, so the
// attributes are set on a kernel's first launch on a device, and again
// only when a launch needs more, not on every call.
template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes, size_t (&granted)[kDevices], bool wide = false) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && bytes <= granted[dev]) return cudaSuccess;
  if (bytes > (size_t)kMaxStaticSmem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  if (wide) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  if (dev < kDevices) granted[dev] = bytes;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_scores(const void* q, const void* k, float* s, int b, int len, int nh,
                          int kh, int d, cudaStream_t stream) {
  static size_t granted[kDevices];
  const size_t smem = ((size_t)(nh / kh) * d + (size_t)kScoreKeys * (d + 1)) * sizeof(float);
  cudaError_t err = fit_smem(flash_decode_scores_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((len + kScoreKeys - 1) / kScoreKeys, kh, b);
  flash_decode_scores_kernel<T><<<grid, kScoreThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), s, len, nh, kh, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pv(const float* s, const void* v, const int* q_pos, const int* kv_pos,
                      void* out, float* scratch, int b, int len, int nh, int kh, int d,
                      int causal, int window, float scale, cudaStream_t stream) {
  const int g = nh / kh, splits = (len + kSplit - 1) / kSplit;
  static size_t granted[kDevices];
  const size_t smem = ((size_t)g * kSplit + (size_t)kSplit * d + 2 * (size_t)g) * sizeof(float);
  cudaError_t err = fit_smem(flash_decode_pv_split_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  flash_decode_pv_split_kernel<T><<<dim3(splits, kh, b), kSplitThreads, smem, stream>>>(
      s, static_cast<const T*>(v), q_pos, kv_pos, scratch, len, nh, kh, d, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_pv_merge_kernel<T><<<dim3(nh, b), kMergeThreads, 0, stream>>>(
      scratch, static_cast<T*>(out), nh, kh, d, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scores_mma_as(const void* q, const void* k, float* s, int b, int len, int nh,
                                 int kh, int d, cudaStream_t stream) {
  const int gp = (nh / kh + 15) / 16 * 16;
  static size_t granted[kDevices];
  const size_t smem = (size_t)(gp + kMmaKeys) * (2 * d + 16);
  cudaError_t err = fit_smem(flash_decode_scores_mma_kernel<D>, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((len + kMmaKeys - 1) / kMmaKeys, kh, b);
  flash_decode_scores_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), s, len, nh,
      kh, d);
  return cudaGetLastError();
}

cudaError_t launch_scores_mma(const void* q, const void* k, float* s, int b, int len, int nh,
                              int kh, int d, cudaStream_t stream) {
  switch (d) {  // the head-dim slices of the configs, unrolled
    case 16: return launch_scores_mma_as<16>(q, k, s, b, len, nh, kh, d, stream);
    case 32: return launch_scores_mma_as<32>(q, k, s, b, len, nh, kh, d, stream);
    case 64: return launch_scores_mma_as<64>(q, k, s, b, len, nh, kh, d, stream);
    case 128: return launch_scores_mma_as<128>(q, k, s, b, len, nh, kh, d, stream);
    case 256: return launch_scores_mma_as<256>(q, k, s, b, len, nh, kh, d, stream);
    default: return launch_scores_mma_as<0>(q, k, s, b, len, nh, kh, d, stream);
  }
}

cudaLaunchAttribute cluster_attr(int size) {
  cudaLaunchAttribute a = {};
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = size;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// kClusterMax where the card schedules a cluster that large, else 8 (the
// portable size); asked once
int pv_cluster_max() {
  static int answer = 0;
  if (answer != 0) return answer;
  auto kernel = flash_decode_pv_mma_kernel<kClusterMax>;
  const size_t smem = (size_t)PvLayout(16, 128, kClusterMax).bytes;
  static size_t granted[kDevices];
  int size = 8;
  if (fit_smem(kernel, smem, granted, true) == cudaSuccess) {
    cudaLaunchAttribute a = cluster_attr(kClusterMax);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kClusterMax, 1, 1);
    cfg.blockDim = dim3(kPvThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &a;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess && n > 0)
      size = kClusterMax;
  }
  cudaGetLastError();  // a refused size is an answer, not an error
  answer = size;
  return size;
}

template <int C>
cudaError_t launch_pv_mma_as(const float* s, const void* v, const int* q_pos, const int* kv_pos,
                             void* out, int b, int len, int nh, int kh, int d, int causal,
                             int window, float scale, cudaStream_t stream) {
  static size_t granted[kDevices];
  auto kernel = flash_decode_pv_mma_kernel<C>;
  const size_t smem = (size_t)PvLayout(nh / kh, d, C).bytes;
  cudaError_t err = fit_smem(kernel, smem, granted, C > 8);
  if (err != cudaSuccess) return err;
  const int kpb = ((len + C - 1) / C + kPvTile - 1) / kPvTile * kPvTile;
  cudaLaunchAttribute a = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, kh, b);
  cfg.blockDim = dim3(kPvThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &a;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, s, static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos,
                           static_cast<__nv_bfloat16*>(out), len, nh, kh, d, causal, window,
                           scale, kpb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_pv_mma(const float* s, const void* v, const int* q_pos, const int* kv_pos,
                          void* out, int b, int len, int nh, int kh, int d, int causal,
                          int window, float scale, int cluster, cudaStream_t stream) {
#define K9_AS(C) \
  launch_pv_mma_as<C>(s, v, q_pos, kv_pos, out, b, len, nh, kh, d, causal, window, scale, stream)
  switch (cluster) {
    case 1: return K9_AS(1);
    case 2: return K9_AS(2);
    case 4: return K9_AS(4);
    case 8: return K9_AS(8);
    case 16: return K9_AS(16);
    default: return cudaErrorInvalidValue;
  }
#undef K9_AS
}

}  // namespace

// K8: s (B, NH, L) float32 = q (B, 1, NH, d) · k (B, L, KH, d)ᵀ per KV head,
// on path 0 (FMA) or 1 (MMA: bf16, d % 16 == 0).
extern "C" int flash_decode_scores(const void* q, const void* k, void* s, int b, int len,
                                   int nh, int kh, int d, int dtype, int path, void* stream) {
  if (b < 1 || len < 1 || kh < 1 || nh % kh != 0 || d < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  if (path == 1) {
    if (dtype != 1 || d % 16 != 0) return cudaErrorInvalidValue;
    return launch_scores_mma(q, k, sf, b, len, nh, kh, d, st);
  }
  if (path != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_scores<float>(q, k, sf, b, len, nh, kh, d, st);
  if (dtype == 1) return launch_scores<__nv_bfloat16>(q, k, sf, b, len, nh, kh, d, st);
  return cudaErrorInvalidValue;
}

// K9: out (B, 1, NH, d) in v's type from the summed scores s (B, NH, L)
// float32, v (B, L, KH, d), q_pos (B, 1) and kv_pos (B, L), on path 0 (FMA:
// scratch holds B · KH · ceil(L / 64) · G · (d + 2) floats) or 1 (MMA: bf16,
// d % 16 == 0, no scratch, `cluster` blocks a (batch row, KV head): 1, 2,
// 4, 8 or 16, at most flash_decode_pv_cluster_max()).
extern "C" int flash_decode_pv(const void* s, const void* v, const void* q_pos,
                               const void* kv_pos, void* out, void* scratch, int b, int len,
                               int nh, int kh, int d, int dtype, int causal, int has_window,
                               int window, float scale, int path, int cluster, void* stream) {
  if (b < 1 || len < 1 || kh < 1 || nh % kh != 0 || d < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto sf = static_cast<const float*>(s);
  const auto qp = static_cast<const int*>(q_pos);
  const auto kp = static_cast<const int*>(kv_pos);
  const int win = has_window ? window : kNoWindow;
  if (path == 1) {
    if (dtype != 1 || d % 16 != 0) return cudaErrorInvalidValue;
    if (cluster > pv_cluster_max()) return cudaErrorInvalidValue;
    return launch_pv_mma(sf, v, qp, kp, out, b, len, nh, kh, d, causal, win, scale, cluster,
                         st);
  }
  if (path != 0 || scratch == nullptr) return cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_pv<float>(sf, v, qp, kp, out, sc, b, len, nh, kh, d, causal, win, scale, st);
  if (dtype == 1)
    return launch_pv<__nv_bfloat16>(sf, v, qp, kp, out, sc, b, len, nh, kh, d, causal, win,
                                    scale, st);
  return cudaErrorInvalidValue;
}

// The largest cluster K9's MMA path may be given on this card: 16, or 8
// where the card refuses 16.
extern "C" int flash_decode_pv_cluster_max() { return pv_cluster_max(); }
